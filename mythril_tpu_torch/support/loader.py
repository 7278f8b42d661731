"""DynLoader: lazy on-chain code/storage/balance access (reference:
mythril/support/loader.py).

Own copy of ``mythril_tpu/support/loader.py`` for the port, which has
no RPC client: the loader exists inactive only (``--no-onchain-data``),
and every read raises the ``ValueError`` the call sites already degrade
on (symbolic storage, symbolic balance, unknown code).
"""

from typing import Optional

from mythril_tpu_torch.disassembler.disassembly import Disassembly


class DynLoader:
    def __init__(self, eth=None, active: bool = False):
        if eth is not None or active:
            raise ValueError(
                "on-chain data needs an RPC client, which this build does "
                "not have; run with --no-onchain-data"
            )
        self.eth = None
        self.active = False

    def read_storage(self, contract_address: str, index: int) -> str:
        raise ValueError("Loader is disabled")

    def read_balance(self, address: str) -> int:
        raise ValueError("Loader is disabled")

    def dynld(self, dependency_address: str) -> Optional[Disassembly]:
        raise ValueError("Loader is disabled")
