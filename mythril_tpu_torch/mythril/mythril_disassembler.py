"""MythrilDisassembler: input loading (reference:
mythril/mythril/mythril_disassembler.py; own copy of the JAX package's:
bytecode input, Solidity input through solc (``load_from_solidity``),
on-chain loading through the RPC client (``load_from_address``) and
storage reads (``read-storage``))."""

import logging
import os
import re
from typing import List, Optional, Tuple

from mythril_tpu_torch.exceptions import (
    BadAddressError,
    CompilerError,
    CriticalError,
    EmptyCodeError,
    LoaderError,
)
from mythril_tpu_torch.ethereum.util import solc_exists
from mythril_tpu_torch.solidity.evmcontract import EVMContract
from mythril_tpu_torch.support.crypto import keccak256
from mythril_tpu_torch.support.signatures import SignatureDB

log = logging.getLogger(__name__)


class MythrilDisassembler:
    def __init__(
        self,
        eth=None,
        solc_version: Optional[str] = None,
        solc_settings_json: Optional[str] = None,
        enable_online_lookup: bool = False,
    ) -> None:
        self.solc_binary = self._init_solc_binary(solc_version)
        self.solc_settings_json = solc_settings_json
        self.eth = eth
        self.enable_online_lookup = enable_online_lookup
        self.sigs = SignatureDB(enable_online_lookup=enable_online_lookup)
        self.contracts: List[EVMContract] = []

    @staticmethod
    def _init_solc_binary(version: Optional[str]) -> Optional[str]:
        """The solc binary to run: ``solc`` from ``PATH`` without a
        version (None when there is none), else ``solc-VERSION``,
        ``solcVERSION`` or ``solc``, whichever ``PATH`` has first; never
        a download."""
        if not version:
            return solc_exists("solc")
        if version.startswith("v"):
            version = version[1:]
        for candidate in (f"solc-{version}", f"solc{version}", "solc"):
            path = solc_exists(candidate)
            if path:
                return path
        raise CriticalError(
            f"No matching solc binary found for version {version}"
        )

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
    def check_address(address: str) -> str:
        """Validate an on-chain address: shape first, then, when the hex
        is mixed-case, the EIP-55 checksum (a failed checksum is a
        mistyped address, and analyzing whatever lives at the typo would
        be silently wrong).  Raises :class:`BadAddressError`."""
        if not isinstance(address, str) or not re.fullmatch(
            r"0x[a-fA-F0-9]{40}", address
        ):
            raise BadAddressError(
                f"invalid contract address {str(address)[:64]!r} "
                "(expected 0x + 40 hex characters)"
            )
        body = address[2:]
        if body != body.lower() and body != body.upper():
            digest = keccak256(body.lower().encode()).hex()
            checksummed = "".join(
                c.upper() if int(digest[i], 16) >= 8 else c.lower()
                for i, c in enumerate(body.lower())
            )
            if body != checksummed:
                raise BadAddressError(
                    f"address {address} fails its EIP-55 checksum "
                    f"(did you mean 0x{checksummed}?)"
                )
        return address

    def load_from_address(self, address: str) -> Tuple[str, EVMContract]:
        """Pull, triage and load the runtime code at ``address``.

        Anything ``eth_getCode`` returns is accepted: metadata tails
        stripped, invalid opcodes counted (the interpreter treats them as
        terminating boundaries), oversized blobs capped, and an EIP-1167
        minimal proxy resolved through DynLoader to its implementation
        (the contract is then named ``ADDR -> IMPL``).  Loader-level
        failures raise typed :class:`LoaderError` subclasses the CLI maps
        to a one-line structured exit 2."""
        from mythril_tpu_torch.disassembler import triage as triage_mod
        from mythril_tpu_torch.support.loader import DynLoader

        self.check_address(address)
        if self.eth is None:
            raise CriticalError(
                "Please check RPC connection: no client available."
            )
        try:
            code = self.eth.eth_getCode(address)
        except LoaderError:
            raise  # ProviderExhaustedError carries its own code
        except Exception as e:
            raise CriticalError(f"IPC / RPC error: {e}")
        if code in ("0x", "0x0", "", None):
            raise EmptyCodeError(
                f"eth_getCode({address}) returned no code; check the "
                "address and verify your RPC is synced"
            )
        clean, report = triage_mod.triage(code)
        name = address
        if report.proxy_target is not None:
            # a trampoline says nothing about behavior: resolve the
            # delegate chain and analyze the implementation (the report
            # keeps the proxy address in the contract's name)
            resolved = DynLoader(self.eth).fetch_code(report.proxy_target)
            if resolved:
                clean = resolved
                name = f"{address} -> {report.proxy_target}"
        if not clean:
            raise EmptyCodeError(
                f"code at {address} is empty after triage "
                f"({report.as_dict()})"
            )
        contract = EVMContract(
            code="0x" + clean.hex(),
            name=name,
            enable_online_lookup=self.enable_online_lookup,
        )
        contract.triage = report.as_dict()
        self.contracts.append(contract)
        return address, self.contracts[-1]

    def load_from_solidity(self, solidity_files: List[str]):
        """Compile and load .sol files through solc: ``FILE:NAME`` takes
        the named contract, ``FILE`` every contract with runtime code."""
        from mythril_tpu_torch.solidity.soliditycontract import (
            SolidityContract,
            get_contracts_from_file,
        )

        address = "0x" + "0" * 40
        contracts = []
        for file in solidity_files:
            if not os.path.exists(
                    file.rsplit(":", 1)[0] if ":" in file else file):
                raise CriticalError(f"Input file not found: {file}")
            if ":" in file:
                file, contract_name = file.rsplit(":", 1)
            else:
                contract_name = None
            file = file.replace("~", "")  # fix npm path oddities
            try:
                if contract_name is not None:
                    contract = SolidityContract(
                        input_file=file,
                        name=contract_name,
                        solc_settings_json=self.solc_settings_json,
                        solc_binary=self.solc_binary,
                    )
                    self.contracts.append(contract)
                    contracts.append(contract)
                else:
                    for contract in get_contracts_from_file(
                        file,
                        solc_settings_json=self.solc_settings_json,
                        solc_binary=self.solc_binary,
                    ):
                        self.contracts.append(contract)
                        contracts.append(contract)
            except FileNotFoundError:
                raise CriticalError(f"Input file not found: {file}")
            except CompilerError as e:
                raise CriticalError(str(e))
        return address, contracts

    def get_state_variable_from_storage(
        self, address: str, params: Optional[List[str]] = None
    ) -> str:
        """``read-storage``: a slot, ``slot,count``, or
        ``mapping,slot,key...`` (each key's slot is the keccak of the key
        and the mapping's slot)."""
        params = params or []
        position = 0
        length = 1
        mappings: List[int] = []
        out = ""
        try:
            if params[0] == "mapping":
                position = int(params[1])
                for i in range(2, len(params)):
                    key = bytes(params[i], "utf8")
                    key_formatted = key.rjust(64, b"\x00")
                    mappings.append(
                        int.from_bytes(
                            keccak256(
                                key_formatted
                                + position.to_bytes(32, byteorder="big")
                            ),
                            byteorder="big",
                        )
                    )
                length = len(mappings)
            else:
                if len(params) >= 2:
                    length = int(params[1])
                if len(params) >= 1:
                    position = int(params[0])
        except (ValueError, IndexError):
            raise CriticalError(
                "Invalid storage index. Please provide a numeric value."
            )
        try:
            if length == 1:
                slot = mappings[0] if mappings else position
                value = self.eth.eth_getStorageAt(address, slot)
                out = f"{hex(slot)}: {value}"
            else:
                for i in range(length):
                    slot = mappings[i] if mappings else position + i
                    value = self.eth.eth_getStorageAt(address, slot)
                    out += f"{hex(slot)}: {value}\n"
        except AttributeError:
            raise CriticalError("Cannot read storage: no RPC client configured.")
        except Exception as e:
            raise CriticalError(f"RPC error: {e}")
        return out.rstrip()

    @staticmethod
    def hash_for_function_signature(sig: str) -> str:
        return "0x" + keccak256(sig.encode()).hex()[:8]
