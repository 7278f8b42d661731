"""The autopilot's seams of the symbolic lockstep tier (counterpart of
``mythril_tpu/autopilot/__init__.py``: ``route_segment`` and
``note_segment``).  The port has no autopilot yet, so both act as the
JAX package's do under ``MYTHRIL_TPU_AUTOPILOT=0``: every segment group
runs in lockstep, and nothing is learned from it."""


def route_segment(features: dict) -> bool:
    """Whether a segment group runs in lockstep: always."""
    return True


def note_segment(features: dict, lanes: int, wall_s: float) -> None:
    """Fold one executed segment group into the cost model: nothing to
    fold into."""
