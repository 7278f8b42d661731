"""The resource governor's seam (counterpart of
``mythril_tpu/resilience/governor.py``).  The port has no governor yet,
so no degradation rung ever applies, as in the JAX package under
``MYTHRIL_TPU_GOVERNOR=0``."""


def planes_disabled() -> bool:
    """True once the ``disable_planes`` rung applied: never."""
    return False
