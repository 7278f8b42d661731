"""Laser plugin builder (reference: laser/plugin/builder.py)."""

from abc import ABC, abstractmethod

from mythril_tpu_torch.laser.plugin.interface import LaserPlugin


class PluginBuilder(ABC):
    plugin_name = "Default Plugin Name"

    def __init__(self):
        self.enabled = True

    @abstractmethod
    def __call__(self, *args, **kwargs) -> LaserPlugin:
        """Constructs the plugin."""
