"""SymExecWrapper: assembles the analysis pipeline around the batched
VM — scheduler policy, actor world state, pruning plugins, detection
hooks — then runs it and harvests the statespace.

Own copy of ``mythril_tpu/analysis/symbolic.py``;
``enable_coverage_strategy`` wraps the search strategy in the coverage
strategy (``laser/plugin/plugins/coverage/coverage_strategy.py``), as in
the JAX package.  The persistent knowledge plane's seam
(``persist/plane.py``) warms the blast context before ``sym_exec`` and
stages what it learned after; it is inert unless a store directory is
configured.

Capability parity target: reference mythril/analysis/symbolic.py
(same constructor surface and post-pass Call extraction for
POST-entry-point modules).  The assembly itself is decomposed into
policy tables + builder steps rather than one monolithic constructor
body, so alternative schedulers/plugins slot in without touching the
pipeline order.
"""

import logging
from typing import List, Optional, Union

from mythril_tpu_torch.analysis.module import (
    EntryPoint,
    ModuleLoader,
    get_detection_module_hooks,
)
from mythril_tpu_torch.analysis.ops import Call, VarType, get_variable
from mythril_tpu_torch.laser.ethereum import svm
from mythril_tpu_torch.laser.ethereum.natives import PRECOMPILE_COUNT
from mythril_tpu_torch.laser.ethereum.state.account import Account
from mythril_tpu_torch.laser.ethereum.state.world_state import WorldState
from mythril_tpu_torch.laser.ethereum.strategy.basic import (
    BreadthFirstSearchStrategy,
    DepthFirstSearchStrategy,
    ReturnRandomNaivelyStrategy,
    ReturnWeightedRandomStrategy,
)
from mythril_tpu_torch.laser.ethereum.strategy.extensions.bounded_loops import (
    BoundedLoopsStrategy,
)
from mythril_tpu_torch.laser.ethereum.transaction.symbolic import ACTORS
from mythril_tpu_torch.laser.plugin.loader import LaserPluginLoader
from mythril_tpu_torch.laser.plugin.plugins import (
    CallDepthLimitBuilder,
    CoveragePluginBuilder,
    DependencyPrunerBuilder,
    InstructionProfilerBuilder,
    MutationPrunerBuilder,
)
from mythril_tpu_torch.smt import BitVec, symbol_factory
from mythril_tpu_torch.support.support_args import args

log = logging.getLogger(__name__)

# scheduler policies: how the batched worklist draws its wavefront
STRATEGIES = {
    "dfs": DepthFirstSearchStrategy,
    "bfs": BreadthFirstSearchStrategy,
    "naive-random": ReturnRandomNaivelyStrategy,
    "weighted-random": ReturnWeightedRandomStrategy,
}

_CALL_OPS = ("CALL", "CALLCODE", "DELEGATECALL", "STATICCALL")


def _as_address(value: Union[int, str, BitVec]) -> BitVec:
    if isinstance(value, str):
        value = int(value, 16)
    if isinstance(value, int):
        value = symbol_factory.BitVecVal(value, 256)
    return value


class SymExecWrapper:
    def __init__(
        self,
        contract,
        address: Union[int, str, BitVec],
        strategy: str,
        dynloader=None,
        max_depth: int = 22,
        execution_timeout: Optional[int] = None,
        loop_bound: int = 3,
        create_timeout: Optional[int] = None,
        transaction_count: int = 2,
        modules: Optional[List[str]] = None,
        compulsory_statespace: bool = True,
        disable_dependency_pruning: bool = False,
        run_analysis_modules: bool = True,
        enable_coverage_strategy: bool = False,
        custom_modules_directory: str = "",
    ):
        address = _as_address(address)
        if strategy not in STRATEGIES:
            raise ValueError("Invalid strategy argument supplied")

        is_creation = bool(getattr(contract, "creation_code", None))
        requires_statespace = compulsory_statespace or bool(
            ModuleLoader().get_detection_modules(EntryPoint.POST, modules)
        )

        self.accounts = self._actor_accounts(include_creator=is_creation)
        self.laser = svm.LaserEVM(
            dynamic_loader=dynloader,
            max_depth=max_depth,
            execution_timeout=execution_timeout,
            strategy=STRATEGIES[strategy],
            create_timeout=create_timeout,
            transaction_count=transaction_count,
            requires_statespace=requires_statespace,
        )
        if loop_bound is not None:
            self.laser.extend_strategy(BoundedLoopsStrategy, loop_bound)
        plugins = self._instrument(disable_dependency_pruning)
        if enable_coverage_strategy and "coverage" in plugins:
            from mythril_tpu_torch.laser.plugin.plugins.coverage.coverage_strategy import (
                CoverageStrategy,
            )

            self.laser.extend_strategy(
                CoverageStrategy, plugins["coverage"]
            )
        if run_analysis_modules:
            self._attach_detection_hooks(modules)

        world_state = WorldState()
        for account in self.accounts.values():
            world_state.put_account(account)

        # persistent knowledge plane: every entry path builds a
        # SymExecWrapper, so the warm/absorb seam lives here
        persist_digest = self._persist_digest(contract, is_creation)
        self._persist_warm_start(persist_digest)

        if is_creation:
            self.laser.sym_exec(
                creation_code=contract.creation_code,
                contract_name=contract.name,
                world_state=world_state,
            )
        else:
            world_state.put_account(
                self._target_account(contract, address, dynloader, world_state)
            )
            self.laser.sym_exec(
                world_state=world_state, target_address=address.value
            )

        self._persist_absorb(persist_digest)

        if requires_statespace:
            self.nodes = self.laser.nodes
            self.edges = self.laser.edges
            self.calls = self._harvest_calls()

    # -- persistence seam -----------------------------------------------

    @staticmethod
    def _persist_digest(contract, is_creation: bool) -> Optional[str]:
        from mythril_tpu_torch.persist.plane import (
            code_digest, get_knowledge_plane,
        )

        if not get_knowledge_plane().active:
            return None
        code = (contract.creation_code if is_creation
                else getattr(contract, "code", None))
        return code_digest(code if isinstance(code, str) else None)

    @staticmethod
    def _persist_warm_start(digest: Optional[str]) -> None:
        if digest is None:
            return
        from mythril_tpu_torch.persist.plane import get_knowledge_plane
        from mythril_tpu_torch.smt.solver import get_blast_context

        get_knowledge_plane().warm_start(digest, get_blast_context())

    @staticmethod
    def _persist_absorb(digest: Optional[str]) -> None:
        if digest is None:
            return
        from mythril_tpu_torch.persist.plane import get_knowledge_plane
        from mythril_tpu_torch.smt.solver import get_blast_context

        get_knowledge_plane().absorb(digest, get_blast_context())

    # -- assembly steps -------------------------------------------------

    @staticmethod
    def _actor_accounts(include_creator: bool):
        accounts = {}
        actors = [ACTORS.attacker] + ([ACTORS.creator] if include_creator else [])
        for actor in actors:
            accounts[hex(actor.value)] = Account(
                hex(actor.value), "", dynamic_loader=None, contract_name=None
            )
        return accounts

    def _instrument(self, disable_dependency_pruning: bool) -> dict:
        loader = LaserPluginLoader()
        loader.load(CoveragePluginBuilder())
        loader.load(MutationPrunerBuilder())
        loader.load(CallDepthLimitBuilder())
        if args.iprof:
            loader.load(InstructionProfilerBuilder())
        loader.add_args("call-depth-limit", call_depth_limit=args.call_depth_limit)
        if not disable_dependency_pruning:
            loader.load(DependencyPrunerBuilder())
        return loader.instrument_virtual_machine(self.laser, None)

    def _attach_detection_hooks(self, modules: Optional[List[str]]) -> None:
        callback_modules = ModuleLoader().get_detection_modules(
            EntryPoint.CALLBACK, modules
        )
        for phase in ("pre", "post"):
            self.laser.register_hooks(
                hook_type=phase,
                hook_dict=get_detection_module_hooks(
                    callback_modules, hook_type=phase
                ),
            )

    @staticmethod
    def _target_account(contract, address, dynloader, world_state) -> Account:
        account = Account(
            address,
            contract.disassembly,
            dynamic_loader=dynloader,
            contract_name=contract.name,
            balances=world_state.balances,
            concrete_storage=bool(dynloader is not None and dynloader.active),
        )
        if dynloader is not None:
            try:
                account.set_balance(
                    dynloader.read_balance("{0:#0{1}x}".format(address.value, 42))
                )
            except Exception:  # noqa: BLE001 — balance stays symbolic
                pass
        return account

    # -- statespace post-pass -------------------------------------------

    def _harvest_calls(self) -> List[Call]:
        """Extract inter-contract call sites recorded in the statespace
        (the input POST-entry-point modules iterate over)."""
        calls: List[Call] = []
        for node in self.nodes.values():
            for index, state in enumerate(node.states):
                op = state.get_current_instruction()["opcode"]
                if op not in _CALL_OPS:
                    continue
                stack = state.mstate.stack
                gas = get_variable(stack[-1])
                to = get_variable(stack[-2])
                if op in ("DELEGATECALL", "STATICCALL"):
                    calls.append(Call(node, state, index, op, to, gas))
                    continue
                # CALL/CALLCODE carry value + memory input window
                if (
                    to.type == VarType.CONCRETE
                    and 0 < to.val <= PRECOMPILE_COUNT
                ):
                    continue  # precompile invocations are not call sites
                value = get_variable(stack[-3])
                mem_start = get_variable(stack[-4])
                mem_size = get_variable(stack[-5])
                data = None
                if (
                    mem_start.type == VarType.CONCRETE
                    and mem_size.type == VarType.CONCRETE
                ):
                    data = state.mstate.memory[
                        mem_start.val : mem_start.val + mem_size.val
                    ]
                if data is not None:
                    calls.append(
                        Call(node, state, index, op, to, gas, value, data)
                    )
                else:
                    calls.append(Call(node, state, index, op, to, gas, value))
        return calls

    @property
    def execution_info(self):
        return self.laser.execution_info
