"""``python3 -m mythril_tpu_torch serve`` — the overload-safe persistent
analysis daemon (own copy of ``mythril_tpu/serve/``).

Everything the single-shot CLI amortizes within one run and throws
away at exit — the built kernels, the resident clause pool, warm-start
models, the cone memo, the solver memo channels — survives here across
requests.  The headline is the failure story, not the
routing:

- bounded two-class admission with load shedding
  (:mod:`.admission`),
- per-request wall-clock deadline budgets that reach the device round
  ladders through the cooperative drain seam
  (``resilience/budget.py``),
- request isolation with flight-dump attachment, per-source circuit
  breakers, and shared-state decontamination (:mod:`.engine`); a lost
  card ends the server instead (the port's divergence: the JAX engine
  degrades to its host CDCL),
- liveness/readiness/metrics surfaces (:mod:`.http`).
"""

from mythril_tpu_torch.serve.admission import AdmissionQueue, CircuitBreaker  # noqa: F401
from mythril_tpu_torch.serve.config import (  # noqa: F401
    ServeConfig,
    ServeConfigError,
)
from mythril_tpu_torch.serve.engine import AnalysisEngine  # noqa: F401
from mythril_tpu_torch.serve.http import AnalysisServer, run_server  # noqa: F401
from mythril_tpu_torch.serve.protocol import (  # noqa: F401
    AnalyzeRequest,
    RequestError,
    parse_analyze_request,
)
