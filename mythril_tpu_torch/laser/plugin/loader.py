"""Registry of laser-plugin builders and the VM instrumentation hook.

One process-wide registry (the executor assembly in
analysis/symbolic.py registers the built-in pruners/trackers here, and
entry-point plugins arrive through mythril_tpu_torch/plugin/loader.py);
``instrument_virtual_machine`` is the single point where a fresh
LaserEVM gets its enabled plugins constructed and attached.  Reference
counterpart: laser/plugin/loader.py.
"""

import logging
from typing import Dict, List, Optional

from mythril_tpu_torch.laser.plugin.builder import PluginBuilder
from mythril_tpu_torch.support.support_utils import Singleton

log = logging.getLogger(__name__)


class LaserPluginLoader(object, metaclass=Singleton):
    def __init__(self) -> None:
        self._builders: Dict[str, PluginBuilder] = {}
        self._construction_args: Dict[str, Dict] = {}

    # -- registry ------------------------------------------------------

    def load(self, builder: PluginBuilder) -> None:
        """Register a builder under its plugin name (first one wins —
        a duplicate name is logged and ignored, matching the
        reference's behavior for conflicting plugin packages)."""
        name = builder.plugin_name
        if name in self._builders:
            log.warning(
                "Laser plugin with name %s was already loaded, "
                "skipping...", name,
            )
            return
        log.info("Loading laser plugin: %s", name)
        self._builders[name] = builder

    def add_args(self, plugin_name: str, **kwargs) -> None:
        """Constructor kwargs applied when the plugin is built (the
        facade passes e.g. the loop bound here)."""
        self._construction_args[plugin_name] = kwargs

    # -- queries -------------------------------------------------------

    def is_enabled(self, plugin_name: str) -> bool:
        builder = self._builders.get(plugin_name)
        return builder.enabled if builder is not None else False

    def enable(self, plugin_name: str) -> None:
        builder = self._builders.get(plugin_name)
        if builder is None:
            raise ValueError(
                f"Plugin with name: {plugin_name} was not loaded"
            )
        builder.enabled = True

    # -- instrumentation ----------------------------------------------

    def instrument_virtual_machine(
        self, symbolic_vm, with_plugins: Optional[List[str]]
    ) -> Dict[str, object]:
        """Construct and attach every enabled plugin to a fresh VM;
        returns the constructed instances by name (the executor
        assembly wires e.g. the coverage plugin into its search
        strategy).  An explicit ``with_plugins`` list overrides the
        builders' own enabled flags (used by graph/statespace modes)."""
        instances: Dict[str, object] = {}
        for name, builder in self._builders.items():
            wanted = (
                name in with_plugins if with_plugins else builder.enabled
            )
            if not wanted:
                continue
            log.info("Instrumenting symbolic vm with plugin: %s", name)
            plugin = builder(**self._construction_args.get(name, {}))
            plugin.initialize(symbolic_vm)
            instances[name] = plugin
        return instances
