"""Mythril-level plugin interfaces (own copy of
``mythril_tpu/plugin/interface.py``; reference:
mythril/plugin/interface.py).  The port loads only plugins that
subclass this module's :class:`MythrilPlugin` (``plugin/discovery.py``)."""

from abc import ABC

from mythril_tpu_torch.laser.plugin.builder import PluginBuilder as LaserPluginBuilder


class MythrilPlugin:
    """An installable plugin: detection module, laser plugin, or CLI
    extension, discovered via the 'mythril.plugins' entry-point group."""

    author = "Default Author"
    name = "Plugin Name"
    plugin_license = "All rights reserved."
    plugin_type = "Mythril Plugin"
    plugin_version = "0.0.1 "
    plugin_description = "This is an example plugin description"

    def __init__(self, **kwargs):
        pass

    def __repr__(self) -> str:
        return f"{self.name} - {self.plugin_version} - {self.author}"


class MythrilCLIPlugin(MythrilPlugin):
    """Hooks into the CLI."""


class MythrilLaserPlugin(MythrilPlugin, LaserPluginBuilder, ABC):
    """Laser plugin builders installed as Mythril plugins."""
