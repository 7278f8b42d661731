"""Concrete exploit-sequence validation on the lockstep interpreter (own
copy of ``mythril_tpu/analysis/concrete_replay.py``).

Every issue carries a solver-concretized transaction sequence.  This
module replays it through the lockstep interpreter (``ops/lockstep.py``)
against the contract's runtime bytecode, on the analysis's device (on
the card one kernel launch a transaction step), with storage carried
across transactions.  A replay that halts at the flagged program counter
on a host-service opcode (SELFDESTRUCT, the CALL family, INVALID, SHA3,
...) is concrete evidence that the exploit path executes.

Statuses (``issue.concrete_replay``; logged, never serialized into a
report):

- ``confirmed``: a transaction halted exactly at ``issue.address``
  needing a host service, or with a VM error there;
- ``executed``: the sequence ran to clean halts without stopping at the
  flagged address;
- ``unsupported``: the replay left the lockstep regime (a creation step,
  the step cap, a host service elsewhere);
- None: nothing to replay.

There is no broad ``except`` around the interpreter: a kernel or device
failure propagates (the JAX package skips the replay on an unhealthy
device and swallows its errors).
"""

import logging
from typing import List, Optional

import numpy as np

log = logging.getLogger(__name__)

MAX_REPLAY_STEPS = 65536


def _hex_int(text, default=0) -> int:
    if text in (None, "", "0x"):
        return default
    return int(text, 16)


def _word_limbs(value: int) -> np.ndarray:
    from mythril_tpu_torch.ops.u256 import from_int

    return from_int(value, (1,), device="cpu").numpy()


def replay_issue(issue, runtime_code: bytes) -> Optional[str]:
    """Replay one issue's concrete transaction sequence; see the module
    docstring for the statuses."""
    from mythril_tpu_torch.ops import lockstep
    from mythril_tpu_torch.support.support_args import args

    sequence = getattr(issue, "transaction_sequence", None)
    if not sequence or not isinstance(sequence, dict):
        return None
    steps = sequence.get("steps") or []
    if not steps or not runtime_code:
        return None

    skeys = svals = None
    for step in steps:
        if not step.get("address"):
            return "unsupported"  # creation step: a different code object
        calldata = bytes.fromhex(step.get("input", "0x")[2:])
        state = lockstep.init_state(
            1,
            np.asarray([list(calldata)], np.uint8).reshape(1, len(calldata)),
            np.asarray([len(calldata)], np.int32),
            callvalue=_word_limbs(_hex_int(step.get("value"))),
            caller=_word_limbs(_hex_int(step.get("origin"))),
            storage_keys=skeys,
            storage_vals=svals,
            device=args.device,
        )
        final, _ = lockstep.run_batch(runtime_code, state, MAX_REPLAY_STEPS)

        halt = int(final.halt[0])
        pc = int(final.pc[0])
        if halt == lockstep.RUNNING:
            return "unsupported"  # step cap exhausted mid-transaction
        if halt == lockstep.NEEDS_HOST:
            return "confirmed" if pc == issue.address else "unsupported"
        if halt == lockstep.ERROR:
            # assert-style findings flag the INVALID/ASSERT_FAIL opcode;
            # a genuine VM error at that pc is the expected outcome
            return "confirmed" if pc == issue.address else "executed"

        # carry storage into the next transaction (revert discards)
        if halt != lockstep.REVERTED:
            sused = final.sused[0].cpu().numpy()
            if sused.any():
                order = np.nonzero(sused)[0]
                skeys = final.skeys[:, order, :].cpu().numpy()
                svals = final.svals[:, order, :].cpu().numpy()
    return "executed"


def replay_issues(issues: List, runtime_code_hex: str) -> None:
    """Annotate each issue with its replay status."""
    from mythril_tpu_torch.ops.device_health import check_device

    check_device()
    try:
        code = bytes.fromhex(runtime_code_hex.removeprefix("0x"))
    except ValueError:
        return
    confirmed = 0
    for issue in issues:
        status = replay_issue(issue, code)
        issue.concrete_replay = status
        if status == "confirmed":
            confirmed += 1
    if issues:
        log.info("Concrete replay: %d/%d issues confirmed",
                 confirmed, len(issues))
