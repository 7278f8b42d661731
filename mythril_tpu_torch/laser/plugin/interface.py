"""Laser plugin interface (reference: laser/plugin/interface.py)."""


class LaserPlugin:
    """A plugin introduces hooks into the LaserEVM on initialize and may
    steer execution by raising signals (PluginSkipState /
    PluginSkipWorldState)."""

    def initialize(self, symbolic_vm) -> None:
        raise NotImplementedError
