"""DynLoader: lazy on-chain code/storage/balance access (own copy of
``mythril_tpu/support/loader.py``; reference: mythril/support/loader.py).

Built active unless the caller passes ``--no-onchain-data``, with the
JAX package's client from ``mythril/mythril_config.py`` (``None`` when no
provider is configured: every read then raises the ``ValueError`` below,
and the world state still takes the active loader's branch).

Wild-corpus hardening: every fetch funnels RPC-layer failures (dead
provider, exhausted pool, garbage response) into the ``ValueError``
vocabulary the call sites already degrade on — mid-analysis, a dying
node means symbolic storage / unknown code, never a crashed analysis.
Fetched code crosses the disassembler triage pass
(:mod:`mythril_tpu_torch.disassembler.triage`) before it is decoded, and an
EIP-1167 minimal proxy is resolved through its delegate chain (up to
``MYTHRIL_TPU_PROXY_DEPTH`` hops) so the analysis sees the
implementation, not 45 bytes of trampoline.
"""

import functools
import logging
from typing import Optional

from mythril_tpu_torch.disassembler.disassembly import Disassembly

log = logging.getLogger(__name__)


class DynLoader:
    def __init__(self, eth, active: bool = True):
        self.eth = eth
        self.active = active

    @functools.lru_cache(2**10)
    def read_storage(self, contract_address: str, index: int) -> str:
        if not self.active:
            raise ValueError("Loader is disabled")
        if not self.eth:
            raise ValueError("Cannot load from the storage when eth is None")
        try:
            return self.eth.eth_getStorageAt(
                contract_address, position=index, block="latest"
            )
        except ValueError:
            raise
        except Exception as exc:  # noqa: BLE001 — degrade, never crash
            raise ValueError(f"storage read failed: {exc}") from exc

    @functools.lru_cache(2**10)
    def read_balance(self, address: str) -> int:
        if not self.active:
            raise ValueError("Loader is disabled")
        if not self.eth:
            raise ValueError("Cannot load from the chain when eth is None")
        try:
            return self.eth.eth_getBalance(address)
        except ValueError:
            raise
        except Exception as exc:  # noqa: BLE001 — degrade, never crash
            raise ValueError(f"balance read failed: {exc}") from exc

    @functools.lru_cache(2**10)
    def dynld(self, dependency_address: str) -> Optional[Disassembly]:
        if not self.active:
            raise ValueError("Loader is disabled")
        if not self.eth:
            raise ValueError("Cannot load from the chain when eth is None")
        log.debug("Dynld at contract %s", dependency_address)
        code = self.fetch_code(dependency_address)
        if code is None:
            return None
        return Disassembly("0x" + code.hex())

    def fetch_code(self, address: str,
                   resolve_proxies: bool = True) -> Optional[bytes]:
        """Triaged runtime code at ``address`` (None when the account
        is empty or the chain is unreachable).  An EIP-1167 trampoline
        is followed to its implementation, bounded by
        ``MYTHRIL_TPU_PROXY_DEPTH`` hops (a proxy-to-proxy loop is an
        adversarial input, not a reason to hang)."""
        from mythril_tpu_torch.disassembler import triage
        from mythril_tpu_torch.support.env import env_int

        hops = env_int(
            "MYTHRIL_TPU_PROXY_DEPTH", 3, floor=0
        ) if resolve_proxies else 0
        target = address
        code = None
        for hop in range(hops + 1):
            try:
                raw = self.eth.eth_getCode(target)
            except Exception as exc:  # noqa: BLE001 — degrade, never crash
                log.warning("dynld: eth_getCode(%s) failed (%s); "
                            "treating code as unknown", target, exc)
                return code  # a resolved trampoline beats nothing
            if raw in ("0x", "0x0", "", None):
                return code
            code, report = triage.triage(raw)
            if report.proxy_target is None:
                return code
            if hop == hops:
                # depth exhausted: analyze the trampoline itself rather
                # than chase an unbounded (possibly cyclic) chain
                log.warning("dynld: proxy chain from %s exceeds %d "
                            "hops; analyzing the trampoline", address,
                            hops)
                return code
            log.info("dynld: %s is an EIP-1167 proxy -> %s",
                     target, report.proxy_target)
            target = report.proxy_target
        return code
