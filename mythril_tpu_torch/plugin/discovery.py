"""Entry-point plugin discovery (own copy of
``mythril_tpu/plugin/discovery.py``; reference:
mythril/plugin/discovery.py).

It reads the ``mythril.plugins`` entry-point group, as the JAX package
does, so both packages see the same installed plugins.  The port takes
only those written against its own interface
(``mythril_tpu_torch.plugin.interface.MythrilPlugin``); any other entry
point, a plugin of the JAX package's interface among them, is skipped
with one log line naming it, and is never half-loaded.  So is one that
fails to import (a JAX package's plugin where the JAX package is not
installed).
"""

import logging
from importlib import metadata
from typing import Any, Dict, List, Optional

from mythril_tpu_torch.plugin.interface import MythrilPlugin
from mythril_tpu_torch.support.support_utils import Singleton

log = logging.getLogger(__name__)


class PluginDiscovery(object, metaclass=Singleton):
    """Discovers installed plugins via the setuptools entry-point group
    "mythril.plugins"."""

    _plugins: Dict[str, Any] = {}

    def init_plugins(self) -> None:
        try:
            entry_points = metadata.entry_points()
            if hasattr(entry_points, "select"):
                eps = entry_points.select(group="mythril.plugins")
            else:  # pragma: no cover (py<3.10 API)
                eps = entry_points.get("mythril.plugins", [])
            self._plugins = {}
            for ep in eps:
                try:
                    plugin = ep.load()
                except Exception as e:  # noqa: BLE001 — one bad plugin
                    log.warning("skipping plugin %s (%s): %s", ep.name,
                                ep.value, e)
                    continue
                if isinstance(plugin, type) and issubclass(
                        plugin, MythrilPlugin):
                    self._plugins[ep.name] = plugin
                else:
                    log.warning(
                        "skipping plugin %s (%s): not a "
                        "mythril_tpu_torch.plugin.interface.MythrilPlugin",
                        ep.name, ep.value,
                    )
        except Exception as e:
            log.debug("Plugin discovery failed: %s", e)
            self._plugins = {}

    @property
    def plugins(self) -> Dict[str, Any]:
        if not self._plugins:
            self.init_plugins()
        return self._plugins

    def is_installed(self, plugin_name: str) -> bool:
        return plugin_name in self.plugins

    def build_plugin(self, plugin_name: str, plugin_args: Dict) -> MythrilPlugin:
        if not self.is_installed(plugin_name):
            raise ValueError(f"Plugin with name: `{plugin_name}` is not installed")
        plugin = self.plugins.get(plugin_name)
        if plugin is None or not issubclass(plugin, MythrilPlugin):
            raise ValueError(f"No valid plugin was found for {plugin_name}")
        return plugin(**plugin_args)

    def get_plugins(self, default_enabled: Optional[bool] = None) -> List[str]:
        if default_enabled is None:
            return list(self.plugins.keys())
        return [
            name
            for name, plugin in self.plugins.items()
            if getattr(plugin, "plugin_default_enabled", False) == default_enabled
        ]
