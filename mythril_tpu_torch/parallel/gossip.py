"""Knowledge freeze and monotone apply (own copy of the knowledge half of
``mythril_tpu/parallel/gossip.py``; the frames and epoch stamps come
with the fleet).

The globally valid solver channels of a blast context (the permanent
UNSAT memo, the SAT half of the probe memo, the recent models) cross
processes in the checkpoint plane's journal form
(``resilience/checkpoint.py``: :func:`freeze_channels` with node objects
for node ids, pickled by :func:`dumps`, re-interned on load), and are
applied MONOTONICALLY: an apply only adds memo entries and models, so a
knowledge body can widen what a context knows but never invalidate it.
Literal-level state (CNF pool rows, device nogoods, a model's truth row)
never crosses: literal numbering is an artifact of each process's blast
order.

A body is unpickled by :class:`KnowledgeUnpickler`, which resolves only
the globals the port's own freeze writes.  A body written by the JAX
package (whose reducers name ``mythril_tpu`` functions), by another
format, or anything else is refused with :class:`ForeignKnowledge`
before any of it is built; the knowledge plane counts that as a thaw
error and starts cold.  A tensor in a body (the journal reducers store
one as host numpy with its device type) is rebuilt only on the device
type of the run that reads it: a body written on the card never moves
its tensors to the CPU, nor the reverse.
"""

import io
import pickle

#: the tag of this package's knowledge bodies
KNOWLEDGE_FORMAT = "mythril_tpu_torch.knowledge/1"


class ForeignKnowledge(pickle.UnpicklingError):
    """A knowledge body this package did not write (or not for this
    run's device type)."""


def _run_device_type() -> str:
    """``"cuda"`` or ``"cpu"``: where this run's solver tiers are
    (``args.device``; the card unless the caller asked for the CPU)."""
    from mythril_tpu_torch.support.support_args import args

    return "cpu" if str(args.device or "cuda").startswith("cpu") else "cuda"


class KnowledgeUnpickler(pickle.Unpickler):
    """Unpickler of knowledge bodies: resolves the journal's node and
    tensor reducers of this package and the builtins and numpy scalars
    a frozen channel holds, nothing else; rebuilds a tensor only on
    ``device_type``."""

    _BUILTINS = frozenset(("set", "frozenset", "complex", "bytearray"))
    _NUMPY = frozenset((
        ("numpy", "dtype"), ("numpy", "ndarray"),
        ("numpy.core.multiarray", "scalar"),
        ("numpy.core.multiarray", "_reconstruct"),
        ("numpy._core.multiarray", "scalar"),
        ("numpy._core.multiarray", "_reconstruct"),
    ))

    def __init__(self, file, device_type: str):
        super().__init__(file)
        self.device_type = device_type

    def find_class(self, module, name):
        from mythril_tpu_torch.resilience import checkpoint

        if module == checkpoint.__name__:
            if name == "_reintern_node":
                return checkpoint._reintern_node
            if name == "_tensor_from_host":
                return self._tensor_on_run_device
        elif module == "builtins" and name in self._BUILTINS:
            return super().find_class(module, name)
        elif (module, name) in self._NUMPY:
            return super().find_class(module, name)
        raise ForeignKnowledge(
            f"knowledge body names {module}.{name}: not a body of this "
            f"package")

    def _tensor_on_run_device(self, array, device_type):
        from mythril_tpu_torch.resilience.checkpoint import (
            _tensor_from_host,
        )

        if device_type != self.device_type:
            raise ForeignKnowledge(
                f"knowledge body holds a {device_type} tensor; this run "
                f"is on {self.device_type}")
        return _tensor_from_host(array, device_type)


def freeze_knowledge(ctx) -> bytes:
    """Snapshot the globally valid channels of ``ctx`` in journal form
    (node-object keys, re-interned on load)."""
    from mythril_tpu_torch.resilience.checkpoint import (
        dumps, freeze_channels,
    )

    return dumps({"format": KNOWLEDGE_FORMAT,
                  "channels": freeze_channels(ctx)})


def thaw_knowledge(body: bytes) -> dict:
    """The frozen channels of a body this package wrote; raises
    :class:`ForeignKnowledge` (an ``UnpicklingError``) for any other."""
    payload = KnowledgeUnpickler(io.BytesIO(body),
                                 _run_device_type()).load()
    if not isinstance(payload, dict) or payload.get(
            "format") != KNOWLEDGE_FORMAT:
        raise ForeignKnowledge("knowledge body without this package's "
                               "format tag")
    return payload["channels"]


def apply_knowledge(ctx, body: bytes) -> dict:
    """Monotonically merge a frozen channel snapshot into ``ctx``: UNSAT
    memo entries and SAT probe memos are added if absent, models extend
    the recent set (newest-first insertion, the existing cap kept).
    Never removes or overwrites, so findings do not depend on what was
    applied.  Returns counts for telemetry."""
    from mythril_tpu_torch.resilience.checkpoint import _thaw_env

    channels = thaw_knowledge(body)
    added_unsat = added_probe = added_models = 0
    for nodes in channels.get("unsat_sets", ()):
        key = tuple(sorted(n.id for n in nodes))
        if key not in ctx.unsat_memo:
            ctx.note_unsat(nodes)
            added_unsat += 1
    for nodes, frozen in channels.get("probe_sat", ()):
        key = tuple(sorted(n.id for n in nodes))
        if key not in ctx.probe_memo:
            ctx.probe_memo[key] = _thaw_env(frozen)
            added_probe += 1
    for frozen in channels.get("models", ()):
        env = _thaw_env(frozen)
        before = len(ctx.recent_models)
        ctx._remember_model(env)
        if len(ctx.recent_models) >= before:
            added_models += 1
    return {
        "unsat": added_unsat,
        "probe_sat": added_probe,
        "models": added_models,
    }
