"""Analysis-flag singleton (own copy of
``mythril_tpu/support/support_args.py``, with the flags LASER, the
analyzer and the solver funnel of the port read), and the slice pins.

The CLI and the analyzer write these once per analysis; LASER and the
funnel read them from anywhere.
"""

from mythril_tpu_torch.support.support_utils import Singleton

#: The configuration of the JAX package that this port implements (the
#: "slice pins").  The port now has every plane of ``myth analyze``, the
#: fleet's among them (``--workers``, ``MYTHRIL_TPU_FLEET``), so no
#: environment knob or analysis flag of the JAX package is pinned any
#: more; the two tables stay, empty, for the parity tests that apply
#: them to both packages.
#:
#: Environment knobs of the JAX package:
SLICE_PINS_ENV = {}
#: ... plus, on a CPU, the Pallas tier in interpret mode (what the port's
#: CPU tier is held against; it also keeps the JAX gather tiers on, which
#: a CPU-only JAX host skips by default):
SLICE_PINS_CPU_ENV = {"MYTHRIL_TPU_PALLAS": "force"}
#: Analysis flags of the JAX package:
SLICE_PINS_ARGS = {}

#: The force-dispatched configuration of the funnel's rungs (JAX's
#: ``--device-force-dispatch --no-async-dispatch`` with
#: ``device_coalesce`` off): every frontier the size gates allow reaches
#: a device tier at once.  The parity tests of the tiers and the chip
#: check's kernel audits run it; the defaults below are JAX's.
FORCE_DISPATCH_ARGS = {
    "device_force_dispatch": True,
    "device_coalesce": False,
    "async_dispatch": False,
}


class Args(object, metaclass=Singleton):
    def __init__(self):
        self.solver_timeout = 10000          # ms per query
        self.exact_gas_tracking = False      # concolic conformance runs only
        self.sparse_pruning = False
        self.parallel_solving = False        # --parallel-solving; read by nothing, as in JAX
        self.unconstrained_storage = False
        self.call_depth_limit = 3
        self.iprof = False
        self.batched_solving = True          # batch frontier feasibility checks
        self.word_probing = True             # host word-level model probing
        self.cone_decisions = True           # CDCL decisions restricted to query cone
        self.batch_width = 16                # VM states stepped per scheduler round
        # below this many undecided lanes the native CDCL wins outright;
        # the funnel's structural floor is derived from it
        # (ops/batched_sat.effective_min_lanes)
        self.device_min_lanes = 8
        # the funnel's dispatch rungs, at the JAX package's defaults: the
        # profit gate skips a dispatch whose residue the CDCL is
        # projected to clear in less than device_min_save_s (unless
        # device_force_dispatch), and prefetches it asynchronously
        # instead (async_dispatch); the coalescer merges underfilled
        # batches across rounds (device_coalesce)
        self.device_force_dispatch = False
        self.device_min_save_s = 0.5
        self.async_dispatch = True
        self.device_coalesce = True
        # the dispatcher pre-split (laser/ethereum/lockstep_dispatch.py)
        # and the lockstep replay of exploit sequences
        # (analysis/concrete_replay.py), on by default as in the JAX
        # package
        self.lockstep_dispatch = True
        self.concrete_replay = True
        # where the solver tiers and the lockstep interpreter run: None =
        # the card (an error without one), "cpu" only when asked for
        self.device = None
        # the observability plane's artifact paths (--trace-out,
        # --metrics-out, --lane-ledger-out; observability.configure_from_cli)
        self.trace_out = None
        self.metrics_out = None
        self.lane_ledger_out = None
        # the checkpoint plane (resilience/checkpoint.py): the journal
        # directory (None = off) and the one a run resumes from
        self.checkpoint_dir = None
        self.resume_from = None
        # record a DRAT-style proof stream on the CDCL and certify every
        # UNSAT verdict before the report ships (smt/drat.py; the blast
        # context reads it when it is created)
        self.proof_log = False
        # the fleet (parallel/fleet.py): --workers N shards the frontier
        # across N worker processes; None defers to
        # MYTHRIL_TPU_FLEET_WORKERS, 0 is the single-process path
        self.fleet_workers = None


args = Args()
