"""The lane ledger's seam (counterpart of
``mythril_tpu/observability/ledger.py``).  The port has no lane ledger
yet, so :func:`get_ledger` gives one that records nothing, as the JAX
package's does under ``MYTHRIL_TPU_LEDGER=0``."""


class _NoLedger:
    enabled = False

    def count_transition(self, state: str, n: int = 1) -> None:
        """Aggregate transition tally: not kept."""


_ledger = _NoLedger()


def get_ledger() -> _NoLedger:
    return _ledger
