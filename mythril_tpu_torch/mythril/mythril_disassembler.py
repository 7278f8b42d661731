"""MythrilDisassembler: input loading (reference:
mythril/mythril/mythril_disassembler.py; own copy of the JAX package's,
trimmed to bytecode input: the port has no solc and no RPC client)."""

import logging
from typing import List, Optional, Tuple

from mythril_tpu_torch.exceptions import CriticalError
from mythril_tpu_torch.solidity.evmcontract import EVMContract
from mythril_tpu_torch.support.crypto import keccak256
from mythril_tpu_torch.support.signatures import SignatureDB

log = logging.getLogger(__name__)


class MythrilDisassembler:
    def __init__(self, eth=None, enable_online_lookup: bool = False) -> None:
        self.eth = eth
        self.enable_online_lookup = enable_online_lookup
        self.sigs = SignatureDB(enable_online_lookup=enable_online_lookup)
        self.contracts: List[EVMContract] = []

    def load_from_bytecode(
        self, code: str, bin_runtime: bool = False, address: Optional[str] = None
    ) -> Tuple[str, EVMContract]:
        if address is None:
            address = "0x" + keccak256(code.encode()).hex()[:40]
        code = code.removeprefix("0x").strip()
        try:
            bytes.fromhex(code)
        except ValueError:
            # odd nibble / whitespace repairs go through triage; only
            # genuinely non-hex input raises (BytecodeInputError — the
            # CLI's structured exit 2)
            from mythril_tpu_torch.disassembler.triage import normalize_hex

            code = normalize_hex(code).hex()
        if bin_runtime:
            self.contracts.append(
                EVMContract(
                    code=code,
                    name="MAIN",
                    enable_online_lookup=self.enable_online_lookup,
                )
            )
        else:
            self.contracts.append(
                EVMContract(
                    creation_code=code,
                    name="MAIN",
                    enable_online_lookup=self.enable_online_lookup,
                )
            )
        return address, self.contracts[-1]

    @staticmethod
    def load_from_solidity(solidity_files: List[str]):
        """Solidity input needs solc, which the port does not drive."""
        raise CriticalError(
            "Solidity input needs the solc compiler, which this build does "
            f"not use ({', '.join(solidity_files)}); pass compiled bytecode "
            "with -f BYTECODE_FILE or -c BYTECODE"
        )

    @staticmethod
    def hash_for_function_signature(sig: str) -> str:
        return "0x" + keccak256(sig.encode()).hex()[:8]
