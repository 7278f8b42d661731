"""Source bookkeeping for jsonv2 reports (reference:
mythril/support/source_support.py)."""

from typing import List

from mythril_tpu_torch.support.support_utils import get_code_hash


class Source:
    def __init__(self, source_type=None, source_format=None, source_list=None):
        self.source_type = source_type
        self.source_format = source_format
        self.source_list = source_list or []
        self._source_hash: List[str] = []

    def get_source_from_contracts_list(self, contracts) -> None:
        if not contracts:
            return
        first = contracts[0]
        if getattr(first, "solidity_files", None):
            self.source_type = "solidity-file"
            self.source_format = "text"
            for contract in contracts:
                self.source_list.extend(
                    [file.filename for file in contract.solidity_files]
                )
                self._source_hash.append(get_code_hash(contract.disassembly.bytecode))
                if getattr(contract, "creation_disassembly", None):
                    self._source_hash.append(
                        get_code_hash(contract.creation_disassembly.bytecode)
                    )
        else:
            self.source_type = "raw-bytecode"
            self.source_format = "evm-byzantium-bytecode"
            for contract in contracts:
                if getattr(contract, "creation_code", None):
                    self.source_list.append(
                        get_code_hash(contract.creation_code)
                    )
                    self._source_hash.append(
                        get_code_hash(contract.creation_code)
                    )
                if getattr(contract, "code", None):
                    self.source_list.append(get_code_hash(contract.code))
                    self._source_hash.append(get_code_hash(contract.code))

    def get_source_index(self, bytecode_hash: str) -> int:
        try:
            return self._source_hash.index(bytecode_hash)
        except ValueError:
            self._source_hash.append(bytecode_hash)
            return len(self._source_hash) - 1
