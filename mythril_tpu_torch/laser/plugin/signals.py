"""Control-flow signals plugins may raise inside hooks (reference:
laser/plugin/signals.py)."""


class PluginSignal(Exception):
    pass


class PluginSkipState(PluginSignal):
    """Skip the state the VM is currently post-processing."""


class PluginSkipWorldState(PluginSignal):
    """Do not commit the current world state to the open-states frontier."""
