"""The fault plane's seams (counterpart of
``mythril_tpu/resilience/faults.py``).  The port has no fault plane yet,
so no fault is ever armed and every seam reports that none fired, as in
the JAX package when nothing is armed."""


def maybe_abort_merge() -> bool:
    """Veritesting merge seam (``laser/ethereum/veritest.py``): True when
    an armed ``merge_abort`` shot fires.  Never: no shot is armed."""
    return False
