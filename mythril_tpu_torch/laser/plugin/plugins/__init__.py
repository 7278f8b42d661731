"""Built-in laser plugins (reference: laser/plugin/plugins/__init__.py)."""

from mythril_tpu_torch.laser.plugin.plugins.benchmark import BenchmarkPluginBuilder  # noqa: F401

from mythril_tpu_torch.laser.plugin.plugins.call_depth_limiter import (  # noqa: F401
    CallDepthLimitBuilder,
)
from mythril_tpu_torch.laser.plugin.plugins.coverage.coverage_plugin import (  # noqa: F401
    CoveragePluginBuilder,
)
from mythril_tpu_torch.laser.plugin.plugins.dependency_pruner import (  # noqa: F401
    DependencyPrunerBuilder,
)
from mythril_tpu_torch.laser.plugin.plugins.instruction_profiler import (  # noqa: F401
    InstructionProfilerBuilder,
)
from mythril_tpu_torch.laser.plugin.plugins.mutation_pruner import (  # noqa: F401
    MutationPrunerBuilder,
)
