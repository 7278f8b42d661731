"""Deployment extraction (own copy of ``mythril_tpu/watch/extract.py``):
one block in, the list of newly deployed runtimes out.

Per transaction the extractor walks receipt -> contractAddress ->
runtime code (through the pool's digest-keyed code cache, so a resumed
or reorged re-read never re-fetches), then runs the triage pass (``disassembler/triage.py``)
so the *analysis identity* of a deployment is settled here:

- a plain CREATE/CREATE2 keys on the digest of its own runtime;
- an EIP-1167 minimal proxy collapses onto its implementation's
  digest (the implementation's code is what gets analyzed — analyzing
  the 45-byte trampoline itself would find nothing, N times);
- a reverted CREATE (receipt status 0x0) deployed nothing and is
  skipped, as are transfers and empty-code addresses.

Errors deliberately propagate: a ``ClientError`` here means the block
could not be fully read, and the caller must NOT mark it processed —
retrying the whole block is the only path that cannot lose a
deployment.
"""

import logging
from dataclasses import dataclass
from typing import List, Optional

log = logging.getLogger(__name__)

#: receipt status values that mean the deployment succeeded (pre-
#: Byzantium receipts carry no status field at all — None passes)
_OK_STATUS = (None, "0x1", "0x01")


@dataclass
class Deployment:
    """One newly deployed runtime, resolved to its analysis identity."""

    address: str            # the deployed address (proxy's, for clones)
    tx_hash: str
    block: int
    code: str               # the runtime to analyze (impl for proxies)
    digest: str             # persist-plane digest of ``code``
    proxy_target: Optional[str] = None

    def name(self) -> str:
        return f"watch:{self.address}"


def _strip0x(code: str) -> str:
    return code[2:] if code.startswith("0x") else code


def extract_deployments(client, block: dict) -> List[Deployment]:
    """Every successful deployment in ``block`` (a ``full=False``
    block object: transactions are hashes), proxy-resolved and
    digest-keyed.  Raises ``ClientError`` when the node cannot answer
    — never returns a partial list silently."""
    from mythril_tpu_torch.disassembler.triage import triage
    from mythril_tpu_torch.persist.plane import code_digest

    height = int(block["number"], 16)
    out: List[Deployment] = []
    for tx in block.get("transactions") or ():
        tx_hash = tx.get("hash") if isinstance(tx, dict) else tx
        if not tx_hash:
            continue
        receipt = client.eth_getTransactionReceipt(tx_hash)
        if receipt is None:
            continue
        address = receipt.get("contractAddress")
        if not address:
            continue  # not a deployment (transfer / call)
        if receipt.get("status") not in _OK_STATUS:
            log.debug("watch: skipping reverted CREATE %s", tx_hash)
            continue
        code = client.eth_getCode(address)
        if not _strip0x(code).strip("0"):
            continue  # empty runtime (selfdestructed in-block, or EOA)
        proxy_target = None
        try:
            _clean, report = triage(code)
            proxy_target = report.proxy_target
        except Exception:  # noqa: BLE001 — triage never loses a deploy
            log.debug("watch: triage failed for %s", address,
                      exc_info=True)
        final_code = code
        if proxy_target:
            impl_code = client.eth_getCode(proxy_target)
            if _strip0x(impl_code).strip("0"):
                final_code = impl_code
            else:
                # the proxy points at nothing (yet): fall back to the
                # trampoline bytes so the deployment is still counted
                proxy_target = None
        out.append(Deployment(
            address=address, tx_hash=tx_hash, block=height,
            code=final_code, digest=code_digest(final_code),
            proxy_target=proxy_target,
        ))
    return out
