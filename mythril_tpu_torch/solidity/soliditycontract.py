"""Solidity source contracts with source mapping (own copy of
``mythril_tpu/solidity/soliditycontract.py``; reference:
mythril/solidity/soliditycontract.py).

Requires a solc binary (see ethereum/util.get_solc_json).  Unlike the
JAX package's copy, the source files are read by their names (the
values of ``solc_indices``), not by its keys: the JAX copy opens the
integer ids as file descriptors, so its sources read stdin (file 0) and
stdout (file 1), and closing them ends a two-file run with
``OSError: Bad file descriptor``.
"""

import logging
from typing import Dict, List, Optional, Set

from mythril_tpu_torch.ethereum.util import get_solc_json
from mythril_tpu_torch.exceptions import NoContractFoundError
from mythril_tpu_torch.solidity.evmcontract import EVMContract
from mythril_tpu_torch.support.signatures import SignatureDB

log = logging.getLogger(__name__)


class SolcSource:
    """One source file as solc saw it."""

    def __init__(self, filename: str):
        self.filename = filename
        with open(filename, "rb") as f:
            self.data = f.read()
        self.code = self.data.decode("utf-8", errors="replace")


class SourceMapping:
    def __init__(self, solidity_file_idx, offset, length, lineno, solc_mapping):
        self.solidity_file_idx = solidity_file_idx
        self.offset = offset
        self.length = length
        self.lineno = lineno
        self.solc_mapping = solc_mapping


class SourceCodeInfo:
    def __init__(self, filename, lineno, code, solc_mapping):
        self.filename = filename
        self.lineno = lineno
        self.code = code
        self.solc_mapping = solc_mapping


def get_contracts_from_file(input_file, **kwargs):
    """Yield a SolidityContract per contract with runtime code in the file."""
    data = get_solc_json(input_file, **{k: v for k, v in kwargs.items() if k in ("solc_binary", "solc_settings_json")})
    for key, contract in sorted(data["contracts"][input_file].items()):
        if contract and contract["evm"]["deployedBytecode"]["object"]:
            yield SolidityContract(
                input_file=input_file, name=key, solc_data=data, **kwargs
            )


class SolidityContract(EVMContract):
    def __init__(
        self,
        input_file: str,
        name: Optional[str] = None,
        solc_settings_json=None,
        solc_binary: str = "solc",
        solc_data: Optional[dict] = None,
    ):
        data = solc_data or get_solc_json(
            input_file,
            solc_binary=solc_binary,
            solc_settings_json=solc_settings_json,
        )

        self.solc_indices = self.get_solc_indices(data)
        self.solc_json = data
        self.input_file = input_file

        has_contract = False
        contract_name, code, creation_code, srcmap, srcmap_runtime = (
            name, "", "", [], [],
        )
        for key, contract in sorted(data["contracts"][input_file].items()):
            if name and key != name:
                continue
            if not contract["evm"]["deployedBytecode"]["object"]:
                continue
            contract_name = key
            code = contract["evm"]["deployedBytecode"]["object"]
            creation_code = contract["evm"]["bytecode"]["object"]
            srcmap_runtime = contract["evm"]["deployedBytecode"][
                "sourceMap"
            ].split(";")
            srcmap = contract["evm"]["bytecode"]["sourceMap"].split(";")
            has_contract = True
            if not name:
                # default: pick the LAST contract in the file (reference
                # behavior when no name given)
                continue
            break
        if not has_contract:
            raise NoContractFoundError

        self.name = contract_name
        self.mappings: List[SourceMapping] = []
        self.constructor_mappings: List[SourceMapping] = []

        self.solidity_files = [
            SolcSource(filename) for filename in self.solc_indices.values()
        ]
        self._get_solc_mappings(srcmap, constructor=True)
        self._get_solc_mappings(srcmap_runtime, constructor=False)

        # register function signatures so reports get readable names
        sig_db = SignatureDB()
        for contract in data["contracts"][input_file].values():
            for sig in (contract.get("evm", {}).get("methodIdentifiers") or {}):
                selector = "0x" + contract["evm"]["methodIdentifiers"][sig]
                sig_db.add(selector, sig)

        super().__init__(code, creation_code, name=contract_name)

    @staticmethod
    def get_solc_indices(data: dict) -> Dict[int, str]:
        """source index -> filename mapping."""
        indices: Dict[int, str] = {}
        for filename, source in data.get("sources", {}).items():
            indices[source.get("id", len(indices))] = filename
        return dict(sorted(indices.items()))

    def _get_solc_mappings(self, srcmap: List[str], constructor: bool = False):
        """Decompress solc's relative source maps (s:l:f entries)."""
        mappings = self.constructor_mappings if constructor else self.mappings
        prev_item = ["0", "0", "0", "", ""]
        index_to_filename = list(self.solc_indices.values())
        for item in srcmap:
            mapping = item.split(":")
            while len(mapping) < 3:
                mapping.append("")
            offset = int(mapping[0]) if mapping[0] else int(prev_item[0])
            length = int(mapping[1]) if mapping[1] else int(prev_item[1])
            idx = int(mapping[2]) if mapping[2] else int(prev_item[2])
            prev_item = [str(offset), str(length), str(idx)]
            if 0 <= idx < len(index_to_filename):
                file_data = self.solidity_files[idx].data
                lineno = file_data[:offset].count(b"\n") + 1
            else:
                lineno = None
            mappings.append(
                SourceMapping(idx, offset, length, lineno, f"{offset}:{length}:{idx}")
            )

    def get_source_info(self, address: int, constructor: bool = False):
        disassembly = (
            self.creation_disassembly if constructor else self.disassembly
        )
        mappings = self.constructor_mappings if constructor else self.mappings
        index = 0
        for i, instr in enumerate(disassembly.instruction_list):
            if instr.address == address:
                index = i
                break
        else:
            return None
        if index >= len(mappings):
            return None
        mapping = mappings[index]
        if mapping.lineno is None or not (
            0 <= mapping.solidity_file_idx < len(self.solidity_files)
        ):
            return None
        solidity_file = self.solidity_files[mapping.solidity_file_idx]
        code = solidity_file.data[
            mapping.offset : mapping.offset + mapping.length
        ].decode("utf-8", errors="replace")
        return SourceCodeInfo(
            solidity_file.filename, mapping.lineno, code, mapping.solc_mapping
        )
