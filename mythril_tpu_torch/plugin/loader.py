"""Mythril-level plugin loader (own copy of
``mythril_tpu/plugin/loader.py``; reference: mythril/plugin/loader.py):
dispatches discovered plugins to the right registry (detection modules
-> ModuleLoader, laser plugins -> LaserPluginLoader).  The CLI builds it
before every command that analyzes or disassembles, as the JAX CLI
does."""

import logging

from mythril_tpu_torch.analysis.module.base import DetectionModule
from mythril_tpu_torch.analysis.module.loader import ModuleLoader
from mythril_tpu_torch.laser.plugin.loader import LaserPluginLoader
from mythril_tpu_torch.plugin.discovery import PluginDiscovery
from mythril_tpu_torch.plugin.interface import MythrilLaserPlugin, MythrilPlugin
from mythril_tpu_torch.support.support_utils import Singleton

log = logging.getLogger(__name__)


class UnsupportedPluginType(Exception):
    pass


class MythrilPluginLoader(object, metaclass=Singleton):
    def __init__(self):
        log.info("Initializing mythril plugin loader")
        self.loaded_plugins = []
        self._load_default_enabled()

    def load(self, plugin: MythrilPlugin) -> None:
        if not isinstance(plugin, MythrilPlugin):
            raise ValueError("Passed plugin is not of type MythrilPlugin")
        log.info("Loading plugin: %s", plugin.name)
        if isinstance(plugin, DetectionModule):
            self._load_detection_module(plugin)
        elif isinstance(plugin, MythrilLaserPlugin):
            self._load_laser_plugin(plugin)
        else:
            raise UnsupportedPluginType("Unsupported plugin type")
        self.loaded_plugins.append(plugin)
        log.info("Finished loading plugin: %s", plugin.name)

    @staticmethod
    def _load_detection_module(plugin) -> None:
        ModuleLoader().register_module(plugin)

    @staticmethod
    def _load_laser_plugin(plugin: MythrilLaserPlugin) -> None:
        LaserPluginLoader().load(plugin)

    def _load_default_enabled(self) -> None:
        log.info("Loading installed analysis modules that are enabled by default")
        for plugin_name in PluginDiscovery().get_plugins(default_enabled=True):
            plugin = PluginDiscovery().build_plugin(plugin_name, {})
            self.load(plugin)
