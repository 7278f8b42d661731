"""Raw-bytecode contract container (reference:
mythril/solidity/evmcontract.py)."""

import re

from mythril_tpu_torch.disassembler.disassembly import Disassembly
from mythril_tpu_torch.support.crypto import keccak256


class EVMContract:
    def __init__(
        self,
        code: str = "",
        creation_code: str = "",
        name: str = "Unknown",
        enable_online_lookup: bool = False,
    ):
        code = code or ""
        creation_code = creation_code or ""
        # replace unresolved library placeholders __LibName__... with a
        # dummy address so the bytecode decodes (reference evmcontract.py:32)
        code = re.sub(r"(_{2}.{38})", "aa" * 20, code)
        creation_code = re.sub(r"(_{2}.{38})", "aa" * 20, creation_code)
        self.creation_code = creation_code
        self.name = name
        self.code = code
        self.disassembly = Disassembly(code, enable_online_lookup)
        self.creation_disassembly = Disassembly(
            creation_code, enable_online_lookup
        )

    @property
    def bytecode_hash(self) -> str:
        return "0x" + keccak256(
            bytes.fromhex(self.code.removeprefix("0x"))
        ).hex()

    @property
    def creation_bytecode_hash(self) -> str:
        return "0x" + keccak256(
            bytes.fromhex(self.creation_code.removeprefix("0x"))
        ).hex()

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "code": self.code,
            "creation_code": self.creation_code,
            "disassembly": self.disassembly,
        }

    def get_easm(self) -> str:
        return self.disassembly.get_easm()

    def get_creation_easm(self) -> str:
        return self.creation_disassembly.get_easm()

    def matches_expression(self, expression: str) -> bool:
        """Tiny search DSL: code~, func# tokens combined with and/or
        (reference evmcontract.py:85)."""
        str_eval = ""
        easm_code = None
        tokens = re.split(r"\s+(and|or)\s+", expression, re.IGNORECASE)
        for token in tokens:
            if token in ("and", "or"):
                str_eval += " " + token + " "
                continue
            m = re.match(r"^code#([a-zA-Z0-9\s,\[\]]+)#", token)
            if m:
                if easm_code is None:
                    easm_code = self.get_easm()
                code = m.group(1).replace(",", "\\n")
                str_eval += f'"{code}" in easm_code'
                continue
            m = re.match(r"^func#([a-zA-Z0-9\s_,(\\)\[\]]+)#$", token)
            if m:
                sign_hash = "0x" + keccak256(m.group(1).encode()).hex()[:8]
                str_eval += f"{repr(sign_hash)} in self.disassembly.func_hashes"
        return eval(str_eval.strip())  # noqa: S307 (search DSL, local input)
