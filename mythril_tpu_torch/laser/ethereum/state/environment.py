"""Per-call execution environment (reference: laser/ethereum/state/environment.py)."""

from typing import Dict

from mythril_tpu_torch.smt import BitVec, symbol_factory

from mythril_tpu_torch.laser.ethereum.state.calldata import BaseCalldata


class Environment:
    def __init__(
        self,
        active_account,
        sender: BitVec,
        calldata: BaseCalldata,
        gasprice: BitVec,
        callvalue: BitVec,
        origin: BitVec,
        code=None,
        static: bool = False,
    ):
        self.active_account = active_account
        self.address = active_account.address
        self.code = active_account.code if code is None else code
        self.sender = sender
        self.calldata = calldata
        self.gasprice = gasprice
        self.origin = origin
        self.callvalue = callvalue
        self.static = static
        self.active_function_name = "fallback"
        self.block_number = symbol_factory.BitVecSym("block_number", 256)
        self.chainid = symbol_factory.BitVecSym("chain_id", 256)

    def __str__(self) -> str:
        return str(self.as_dict)

    @property
    def as_dict(self) -> Dict:
        return dict(
            address=self.address,
            active_account=self.active_account,
            sender=self.sender,
            calldata=self.calldata,
            gasprice=self.gasprice,
            callvalue=self.callvalue,
            origin=self.origin,
        )
