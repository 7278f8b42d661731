"""Contract-corpus analysis orchestration (own copy of
``mythril_tpu/mythril/mythril_analyzer.py``).

Builds a symbolic executor per contract, harvests detection issues
(salvaging partial results on interrupt or crash) and assembles the
final :class:`Report`.  The port runs the JAX package's analyzer under
the JAX defaults, without corpus sharding over devices; the statespace
and graph outputs (:meth:`MythrilAnalyzer.dump_statespace`,
:meth:`MythrilAnalyzer.graph_html`) and the coverage search strategy
(``enable_coverage_strategy``) are the JAX package's, and
``parallel_solving`` is recorded on the args bus and read by nothing, as
in the JAX package; ``fleet_workers`` shards an analysis's frontier across
worker processes (``parallel/fleet.py``) as in the JAX package.  As in
the JAX package, a resource governor is installed for each contract and
cleared after it (``resilience/governor.py``; its budgets are unlimited unless
the ``MYTHRIL_TPU_GOVERNOR_*`` knobs set them), and ``checkpoint_dir`` /
``resume_from`` journal the analysis and resume it
(``resilience/checkpoint.py``).  As in the JAX package, the executor's
loader (``support/loader.DynLoader``) is built over the disassembler's
RPC client and is active unless ``use_onchain_data`` is False (the CLI's
``--no-onchain-data``).  A lost card
(``ops/device_health.DeviceLost``) ends the analysis with that error.
As in the JAX package, the dispatcher pre-split (``lockstep_dispatch``)
and the lockstep replay of each issue's exploit sequence
(``_confirm_by_replay``, on by default) run.  The funnel's
dispatch rungs take the JAX package's arguments (``device_force_dispatch``,
``async_dispatch``), and ``proof_log`` records and certifies the
solver's proof stream as in the JAX package (``analysis/security.py``);
the port's one new knob is ``device``: the solver
tiers and the lockstep interpreter run on the card unless
``device="cpu"`` is passed.

Reference counterpart: mythril/mythril/mythril_analyzer.py (the
per-contract loop + statistics toggles).
"""

import logging
import traceback
from dataclasses import dataclass
from typing import List, Optional

from mythril_tpu_torch.analysis.report import Issue, Report
from mythril_tpu_torch.analysis.security import (
    fire_lasers,
    retrieve_callback_issues,
)
from mythril_tpu_torch.analysis.symbolic import SymExecWrapper
from mythril_tpu_torch.exceptions import DetectorNotFoundError
from mythril_tpu_torch.observability import ledger
from mythril_tpu_torch.observability import spans as obs
from mythril_tpu_torch.observability.ledger import set_origin
from mythril_tpu_torch.ops.async_dispatch import get_async_dispatcher
from mythril_tpu_torch.ops.device_health import DeviceLost
from mythril_tpu_torch.smt import SolverStatistics
from mythril_tpu_torch.solidity.evmcontract import EVMContract
from mythril_tpu_torch.support.loader import DynLoader
from mythril_tpu_torch.support.source_support import Source
from mythril_tpu_torch.support.start_time import StartTime
from mythril_tpu_torch.support.support_args import args

log = logging.getLogger(__name__)


def reset_analysis_state() -> None:
    """Forget everything an earlier analysis in this process left
    behind (a fresh CLI process starts this way): the blast context with
    its term interner, model cache and the autopilot (cost model, tuner,
    counters), the detection modules' issues and caches, the
    transaction-id counter, the keccak function manager, the funnel's
    and prune's counters, the dispatcher pre-split's plans, the async
    prefetch (its worker joined, its batch and statistics dropped), and
    the lane ledger (records, aggregates, origin)."""
    from mythril_tpu_torch.laser.batch import prune_stats
    from mythril_tpu_torch.laser.ethereum import lockstep_dispatch
    from mythril_tpu_torch.laser.ethereum.keccak_function_manager import (
        keccak_function_manager,
    )
    from mythril_tpu_torch.laser.ethereum.transaction import (
        reset_transaction_ids,
    )
    from mythril_tpu_torch.analysis.module.loader import ModuleLoader
    from mythril_tpu_torch.ops.async_dispatch import reset_async_dispatch
    from mythril_tpu_torch.ops.batched_sat import dispatch_stats
    from mythril_tpu_torch.smt.solver import reset_blast_context

    reset_async_dispatch()
    reset_blast_context()
    for module in ModuleLoader().get_detection_modules():
        module.reset_module()
        module.cache.clear()
    reset_transaction_ids()
    keccak_function_manager.reset()
    dispatch_stats.reset()
    prune_stats.reset()
    lockstep_dispatch._plan_cache.clear()
    SolverStatistics().reset()
    ledger.reset_for_tests()


@dataclass
class _Campaign:
    """Settings for one analysis campaign, resolved once at analyzer
    construction."""

    strategy: str = "dfs"
    address: Optional[str] = None
    max_depth: Optional[int] = None
    execution_timeout: Optional[int] = None
    loop_bound: Optional[int] = None
    create_timeout: Optional[int] = None
    disable_dependency_pruning: bool = False
    custom_modules_directory: str = ""
    use_onchain_data: bool = True
    enable_coverage_strategy: bool = False


class MythrilAnalyzer:
    def __init__(
        self,
        disassembler,
        strategy: str = "dfs",
        address: Optional[str] = None,
        max_depth: Optional[int] = None,
        execution_timeout: Optional[int] = None,
        loop_bound: Optional[int] = None,
        create_timeout: Optional[int] = None,
        enable_iprof: bool = False,
        disable_dependency_pruning: bool = False,
        use_onchain_data: bool = True,
        solver_timeout: Optional[int] = None,
        custom_modules_directory: str = "",
        sparse_pruning: bool = False,
        unconstrained_storage: bool = False,
        parallel_solving: bool = False,
        call_depth_limit: int = 3,
        enable_coverage_strategy: bool = False,
        batched_solving: bool = True,
        device_force_dispatch: bool = False,
        async_dispatch: bool = True,
        lockstep_dispatch: bool = True,
        proof_log: bool = False,
        device: Optional[str] = None,
        checkpoint_dir: Optional[str] = None,
        resume_from: Optional[str] = None,
        fleet_workers: Optional[int] = None,
    ):
        self.eth = disassembler.eth
        self.contracts: List[EVMContract] = disassembler.contracts or []
        self.campaign = _Campaign(
            strategy=strategy,
            address=address,
            max_depth=max_depth,
            execution_timeout=execution_timeout,
            loop_bound=loop_bound,
            create_timeout=create_timeout,
            disable_dependency_pruning=disable_dependency_pruning,
            custom_modules_directory=custom_modules_directory,
            use_onchain_data=use_onchain_data,
            enable_coverage_strategy=enable_coverage_strategy,
        )
        # the laser stack reads these through the global args bus
        args.sparse_pruning = sparse_pruning
        args.solver_timeout = solver_timeout or args.solver_timeout
        args.parallel_solving = parallel_solving
        args.unconstrained_storage = unconstrained_storage
        args.call_depth_limit = call_depth_limit
        args.iprof = enable_iprof
        args.batched_solving = batched_solving
        args.device_force_dispatch = device_force_dispatch
        args.async_dispatch = async_dispatch
        args.lockstep_dispatch = lockstep_dispatch
        # the blast context reads it when it is created: a context made
        # before this analyzer records no proof stream
        # (reset_blast_context() after setting it)
        args.proof_log = proof_log
        args.device = device
        # the checkpoint plane reads these at the first transaction
        # boundary; --resume journals into the directory it resumes from
        args.checkpoint_dir = checkpoint_dir or resume_from
        args.resume_from = resume_from
        # the fleet: N worker processes take the frontier at the first
        # wide enough transaction boundary (parallel/fleet.py); None
        # defers to MYTHRIL_TPU_FLEET_WORKERS, 0 is one process
        args.fleet_workers = fleet_workers
        #: the last contract's executor (its LaserEVM carries the run's
        #: state count and whether a deadline cut it)
        self.last_sym: Optional[SymExecWrapper] = None

    def _symbolize(self, contract, **overrides) -> SymExecWrapper:
        cfg = self.campaign
        settings = dict(
            dynloader=DynLoader(self.eth, active=cfg.use_onchain_data),
            max_depth=cfg.max_depth,
            execution_timeout=cfg.execution_timeout,
            create_timeout=cfg.create_timeout,
            disable_dependency_pruning=cfg.disable_dependency_pruning,
            custom_modules_directory=cfg.custom_modules_directory,
        )
        settings.update(overrides)
        # None uniformly means "use the executor's default"
        settings = {
            key: value for key, value in settings.items()
            if value is not None
        }
        return SymExecWrapper(
            contract or self.contracts[0],
            cfg.address,
            cfg.strategy,
            **settings,
        )

    def dump_statespace(self, contract: EVMContract = None) -> dict:
        """The statespace of a run without detection modules, as the
        JSON-ready dict of ``analysis/traceexplore.py``."""
        from mythril_tpu_torch.analysis.traceexplore import (
            get_serializable_statespace,
        )

        sym = self._symbolize(contract, run_analysis_modules=False)
        # a prefetch still in flight is waited for, and its failure
        # raised, as after an analysis
        get_async_dispatcher().finish()
        return get_serializable_statespace(sym)

    def graph_html(
        self,
        contract: EVMContract = None,
        enable_physics: bool = False,
        phrackify: bool = False,
        transaction_count: Optional[int] = None,
    ) -> str:
        """The call graph of a run without detection modules, as the HTML
        page of ``analysis/callgraph.py``."""
        from mythril_tpu_torch.analysis.callgraph import generate_graph

        sym = self._symbolize(
            contract,
            run_analysis_modules=False,
            transaction_count=transaction_count,
        )
        get_async_dispatcher().finish()
        return generate_graph(sym, physics=enable_physics, phrackify=phrackify)

    def _analyze_contract(self, contract, modules, transaction_count):
        """Symbolically execute one contract and return (issues,
        execution_info, traceback-or-None).  Interrupts and crashes
        salvage whatever the callback modules had already found."""
        from mythril_tpu_torch.resilience.governor import (
            clear_governor, install_governor,
        )

        StartTime()  # per-contract wall-clock epoch for report timestamps
        failure = None
        execution_info = None
        # the resource governor, armed per contract: a state explosion
        # degrades to a partial verdict, and the next contract starts
        # clean
        install_governor(label=getattr(contract, "name", "") or "contract")
        try:
            sym = self._symbolize(
                contract,
                loop_bound=self.campaign.loop_bound,
                transaction_count=transaction_count,
                modules=modules,
                compulsory_statespace=False,
                enable_coverage_strategy=(
                    self.campaign.enable_coverage_strategy
                ),
            )
            self.last_sym = sym
            issues = fire_lasers(sym, modules)
            execution_info = sym.execution_info
            # a prefetch still in flight: waited for, and its failure
            # raised here (no later funnel call would harvest it)
            get_async_dispatcher().finish()
        except (DetectorNotFoundError, DeviceLost):
            raise
        except KeyboardInterrupt:
            log.critical("Keyboard Interrupt")
            issues = retrieve_callback_issues(modules)
        except Exception:
            failure = traceback.format_exc()
            log.critical(
                "Exception occurred, aborting analysis:\n" + failure
            )
            issues = retrieve_callback_issues(modules)
        finally:
            # restores the batch width; the governor's meta block
            # survives the clear, so the report still carries it
            clear_governor()
        return issues, execution_info, failure

    @staticmethod
    def _confirm_by_replay(issues: List[Issue], contract) -> None:
        """Replay each issue's exploit sequence on the lockstep interpreter
        for an independent confirmation (an annotation only: findings and
        report formats are unaffected).  A kernel or device failure
        propagates."""
        if not issues or not getattr(args, "concrete_replay", True):
            return
        from mythril_tpu_torch.analysis.concrete_replay import replay_issues

        replay_issues(issues, contract.code)

    def fire_lasers(
        self,
        modules: Optional[List[str]] = None,
        transaction_count: Optional[int] = None,
    ) -> Report:
        SolverStatistics().enabled = True
        all_issues: List[Issue] = []
        exceptions: List[str] = []
        execution_info = None
        for index, contract in enumerate(self.contracts):
            # lane-ledger origin: every lane record produced while this
            # contract executes carries its name
            set_origin(
                contract=getattr(contract, "name", "") or "contract",
                tx_index=None,
            )
            with obs.span("analyzer.contract", cat="analyzer",
                          contract=getattr(contract, "name", "") or "",
                          index=index):
                issues, info, failure = self._analyze_contract(
                    contract, modules, transaction_count
                )
            if info is not None:
                execution_info = info
            if failure:
                exceptions.append(failure)
            for issue in issues:
                issue.add_code_info(contract)
            self._confirm_by_replay(issues, contract)
            all_issues.extend(issues)
            log.info("Solver statistics: \n%s", SolverStatistics())

        # resolve source mappings for the final report
        Source().get_source_from_contracts_list(self.contracts)
        report = Report(
            contracts=self.contracts,
            exceptions=exceptions,
            execution_info=execution_info,
        )
        for issue in all_issues:
            report.append_issue(issue)
        return report
