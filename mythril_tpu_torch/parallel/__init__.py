"""Cross-process knowledge (own copy of the part of
``mythril_tpu/parallel`` that the knowledge plane needs).

- ``gossip``: the solver channels frozen for another process (the
  knowledge store's records, and the fleet's heartbeats when the fleet
  comes) and applied monotonically on arrival.
"""
