"""LaserEVM: the symbolic-execution virtual machine (reference:
laser/ethereum/svm.py; own copy of ``mythril_tpu/laser/ethereum/svm.py``,
the fleet seam at each transaction boundary included).  The veritesting
tier (``veritest.py``) merges and retires lanes of the work list between
scheduler rounds, as in the JAX package.  The transaction loop is the
checkpoint spine (``resilience/checkpoint.py``: a journal at every
transaction boundary, a resume re-entering at the journal's
transaction), and both loops poll the drain flag and the resource
governor (``resilience/governor.py``).

Architecture matches the reference's control contract — worklist +
strategy, per-opcode pre/post hooks, laser-level hooks, transaction
signals — with one structural difference: successor feasibility pruning
goes through laser.batch.prune_infeasible, which checks a whole step's
frontier in one batched pass (the dense tier on the card + CDCL tail)
instead of one Z3 call per state.
"""

import logging
from collections import defaultdict
from copy import copy
from datetime import datetime, timedelta
from typing import Callable, Dict, List, Optional, Tuple, Union

from mythril_tpu_torch.laser.batch import prune_infeasible
from mythril_tpu_torch.laser.ethereum.cfg import Edge, JumpType, Node, NodeFlags
from mythril_tpu_torch.laser.ethereum.evm_exceptions import StackUnderflowException, VmException
from mythril_tpu_torch.laser.ethereum.instructions import Instruction
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.ethereum.state.world_state import WorldState
from mythril_tpu_torch.laser.ethereum.strategy import BasicSearchStrategy
from mythril_tpu_torch.laser.ethereum.time_handler import time_handler
from mythril_tpu_torch.laser.ethereum.transaction.transaction_models import (
    ContractCreationTransaction,
    TransactionEndSignal,
    TransactionStartSignal,
)
from mythril_tpu_torch.laser.plugin.signals import PluginSkipState, PluginSkipWorldState
from mythril_tpu_torch.observability import spans as obs
from mythril_tpu_torch.observability.ledger import set_origin
from mythril_tpu_torch.support.opcodes import get_required_stack_elements
from mythril_tpu_torch.support.support_args import args

log = logging.getLogger(__name__)


class SVMError(Exception):
    pass


class LaserEVM:
    """The symbolic virtual machine."""

    def __init__(
        self,
        dynamic_loader=None,
        max_depth: int = float("inf"),
        execution_timeout: Optional[int] = 60,
        create_timeout: Optional[int] = 10,
        strategy=None,
        transaction_count: int = 2,
        requires_statespace: bool = True,
    ):
        self.open_states: List[WorldState] = []
        self.total_states = 0
        self.dynamic_loader = dynamic_loader

        self.work_list: List[GlobalState] = []
        self.strategy = (
            strategy(self.work_list, max_depth)
            if isinstance(strategy, type)
            else strategy
        )
        if self.strategy is None:
            from mythril_tpu_torch.laser.ethereum.strategy.basic import (
                BreadthFirstSearchStrategy,
            )

            self.strategy = BreadthFirstSearchStrategy(self.work_list, max_depth)
        self.max_depth = max_depth
        self.transaction_count = transaction_count

        self.execution_timeout = execution_timeout or 0
        self.create_timeout = create_timeout or 0
        self.time: datetime = None

        self.requires_statespace = requires_statespace
        self.nodes: Dict[int, Node] = {}
        self.edges: List[Edge] = []

        self.executed_transactions = False
        # transaction index a drain (signal, expired request budget or
        # the governor's last rung) stopped at; None when the run
        # completed
        self.aborted_at_tx: Optional[int] = None
        # True once a round hit the execution or create deadline: the
        # explored prefix then depends on speed
        self.timed_out = False

        # hook registries
        self._add_world_state_hooks: List[Callable] = []
        self._execute_state_hooks: List[Callable] = []
        self._start_exec_trans_hooks: List[Callable] = []
        self._stop_exec_trans_hooks: List[Callable] = []
        self._start_sym_exec_hooks: List[Callable] = []
        self._stop_sym_exec_hooks: List[Callable] = []
        self._start_exec_hooks: List[Callable] = []
        self._stop_exec_hooks: List[Callable] = []
        self._transaction_end_hooks: List[Callable] = []

        self.pre_hooks: Dict[str, List[Callable]] = defaultdict(list)
        self.post_hooks: Dict[str, List[Callable]] = defaultdict(list)
        self.instr_pre_hook: Dict[str, List[Callable]] = defaultdict(list)
        self.instr_post_hook: Dict[str, List[Callable]] = defaultdict(list)

        self.hook_type_map = {
            "start_execute_transactions": self._start_exec_trans_hooks,
            "stop_execute_transactions": self._stop_exec_trans_hooks,
            "add_world_state": self._add_world_state_hooks,
            "execute_state": self._execute_state_hooks,
            "start_sym_exec": self._start_sym_exec_hooks,
            "stop_sym_exec": self._stop_sym_exec_hooks,
            "start_sym_trans": self._start_exec_hooks,
            "stop_sym_trans": self._stop_exec_hooks,
            "transaction_end": self._transaction_end_hooks,
        }

        # statistics comparable to the reference's telemetry
        self.iteration_states: List[int] = []
        # populated by plugins (profilers etc.), surfaced in reports
        self.execution_info: List = []

    # ------------------------------------------------------------------
    # top-level entry
    # ------------------------------------------------------------------

    def sym_exec(
        self,
        world_state: WorldState = None,
        target_address: int = None,
        creation_code: str = None,
        contract_name: str = None,
    ) -> None:
        """Symbolically execute either a pre-configured world state
        (message-call mode) or a contract creation."""
        pre_configuration_mode = target_address is not None
        scaling_mode = creation_code is not None
        assert pre_configuration_mode != scaling_mode

        self._execute_hooks(self._start_sym_exec_hooks)
        time_handler.start_execution(self.execution_timeout)
        self.time = datetime.now()

        from mythril_tpu_torch.laser.ethereum.transaction import (
            execute_contract_creation,
        )

        if pre_configuration_mode:
            self.open_states = [world_state]
            log.info("Starting message call transaction to %s", target_address)
            self.executed_transactions = True
            self._execute_transactions(target_address)
        else:
            log.info("Starting contract creation transaction")
            created_account = execute_contract_creation(
                self, creation_code, contract_name, world_state=world_state
            )
            log.info(
                "Finished contract creation, found %d open states",
                len(self.open_states),
            )
            if len(self.open_states) == 0:
                log.warning(
                    "No contract was created during the execution of contract "
                    "creation. Increase the resources for creation execution "
                    "(--max-depth or --create-timeout)"
                )
            self.executed_transactions = True
            self._execute_transactions(created_account.address.value)

        log.info("Finished symbolic execution")
        if self.requires_statespace:
            log.info(
                "%d nodes, %d edges, %d total states",
                len(self.nodes),
                len(self.edges),
                self.total_states,
            )
        self._execute_hooks(self._stop_sym_exec_hooks)

    def _execute_transactions(self, address: int) -> None:
        """Run ``transaction_count`` message calls against every open
        world state (reference svm.py:189).

        The checkpoint spine: a boundary snapshot (pruned frontier and
        findings so far) is journaled before every transaction, a
        resumed analysis re-enters at the journal's transaction, and a
        drain stops the loop at the next boundary with a final
        checkpoint.  The governor is polled at every transaction start,
        where its ``cap_tx_depth`` rung lands."""
        from mythril_tpu_torch.laser.ethereum.transaction import (
            execute_message_call,
        )
        from mythril_tpu_torch.resilience import governor
        from mythril_tpu_torch.resilience.checkpoint import (
            drain_requested, get_checkpoint_plane,
        )

        plane = get_checkpoint_plane()
        start_index = plane.restore_transactions(self, address)
        self._execute_hooks(self._start_exec_trans_hooks)
        for i in range(start_index, self.transaction_count):
            if len(self.open_states) == 0:
                break
            governor.poll(self)
            if governor.tx_depth_capped() and i > start_index:
                # the last transaction finished whole; none more starts
                self.aborted_at_tx = i
                obs.instant("svm.governor_tx_cap", cat="svm", tx=i)
                plane.partial = True
                break
            if drain_requested():
                # this transaction's start boundary is what a resume
                # continues from
                self.aborted_at_tx = i
                obs.instant("svm.drain_boundary", cat="svm", tx=i)
                break
            # the fleet seam (parallel/fleet.py): in a fleet worker the
            # gossip and fault boundary; in the coordinating process a
            # wide enough frontier is sharded into leases here and the
            # workers run the remaining transactions (True: they, and
            # any in-process finish, completed them).  With the fleet
            # off (--workers 0, MYTHRIL_TPU_FLEET=0) seam_enabled() is
            # False: the single-process path
            from mythril_tpu_torch.parallel import fleet

            if fleet.seam_enabled() and fleet.svm_boundary(self, address,
                                                           i):
                break
            # Frontier pruning across transactions: the reference issues
            # one solver call per open state (svm.py:201-204); here the
            # whole frontier goes through one batched pass.  The ledger's
            # origin carries the transaction index (the autopilot's
            # features read it as ``tx``)
            set_origin(tx_index=i)
            with obs.span("svm.transaction", cat="svm", tx=i,
                          open_states=len(self.open_states)):
                old_states = self.open_states
                self.open_states = [
                    pseudo.world_state
                    for pseudo in prune_infeasible(
                        [_WorldStateView(ws) for ws in old_states]
                    )
                ]
                self.iteration_states.append(len(self.open_states))
                plane.transaction_boundary(self, address, i)
                log.info(
                    "Starting message call transaction, iteration: %d, "
                    "%d initial states",
                    i,
                    len(self.open_states),
                )
                self._execute_hooks(self._start_exec_hooks)
                execute_message_call(self, address)
                self._execute_hooks(self._stop_exec_hooks)
        else:
            if not drain_requested():
                # every transaction done: journal the final frontier, so
                # a kill during detection or reporting resumes to a no-op
                plane.transaction_boundary(self, address,
                                           self.transaction_count)
        if drain_requested():
            # a drain inside a transaction leaves the journal at that
            # transaction's start boundary, so --resume re-executes it
            plane.finalize(partial=True)
        self._execute_hooks(self._stop_exec_trans_hooks)

    # ------------------------------------------------------------------
    # the hot loop
    # ------------------------------------------------------------------

    def exec(self, create: bool = False, track_gas: bool = False):
        """Wavefront worklist loop.

        Unlike the reference's pop-one-state loop (reference
        svm.py:221-265, one ``is_possible`` solver call per successor),
        each round draws up to ``args.batch_width`` states from the
        strategy, executes them, and feasibility-checks the *union* of
        their successors in a single ``prune_infeasible`` pass — wide
        enough for the dense tier to engage mid-transaction.
        """
        final_states: List[GlobalState] = []
        if self.time is None:
            self.time = datetime.now()
        batch_width = max(1, getattr(args, "batch_width", 1))
        # veritesting tier: one merge/subsumption driver per exec, None
        # when the tier declines (statespace consumers, gas tracking,
        # CREATE, or the MYTHRIL_TPU_VERITEST=0 kill switch pinning the
        # fork-only path)
        from mythril_tpu_torch.laser.ethereum import veritest

        vt_engine = veritest.engine_for(self, create, track_gas)
        from mythril_tpu_torch.resilience import governor
        from mythril_tpu_torch.resilience.checkpoint import (
            drain_requested, get_checkpoint_plane,
        )

        plane = get_checkpoint_plane()
        while True:
            if drain_requested():
                # stop drawing work: the boundary checkpoint survives and
                # the caller emits the partial report
                break
            # the round boundary, where no dispatch is in flight: the
            # journal's cadence (and demotion-triggered writes), and the
            # governor's poll
            plane.tick()
            governor.poll(self)
            batch = self.strategy.pop_batch(batch_width)
            if not batch:
                break

            # (executed state, op_code, successor states) per lane
            rounds: List[Tuple[GlobalState, Optional[str], List[GlobalState]]] = []
            with obs.span("svm.round", cat="svm", batch=len(batch)):
                timed_out = self._exec_round(
                    batch, rounds, create, track_gas, final_states
                )
            if timed_out is not None:
                self.timed_out = True
                return final_states + [timed_out] if track_gas else None
            if vt_engine is not None and self.work_list:
                # between rounds, with no dispatch in flight: merge
                # re-converged sibling lanes and retire subsumed ones in
                # place (the strategy holds this same list object)
                vt_engine.round_tick(self.work_list)
        return final_states if track_gas else None

    def _exec_round(self, batch, rounds, create, track_gas,
                    final_states):
        """One scheduler round: execute the drawn batch, prune the
        union of successors, record survivors.  Returns the state that
        hit the wall-clock deadline (the caller unwinds), or None."""
        from mythril_tpu_torch.laser.ethereum import symbolic_lockstep

        # lockstep tier: sibling states grouped by (bytecode, pc) run
        # straight-line segments batched; whatever it declines (or the
        # whole batch, behind MYTHRIL_TPU_SYM_LOCKSTEP=0) falls through
        # to the per-state loop below.  Successors from both paths meet
        # in the same rounds list, so the single prune_infeasible pass
        # hands the whole frontier's fork masks to batch_check_states
        # in one dispatch.
        batch, timed_out = symbolic_lockstep.run_lockstep(
            self, batch, rounds, create, track_gas
        )
        for lane, global_state in enumerate(batch):
            deadline = (
                self.create_timeout
                if create
                else self.execution_timeout
            )
            if (
                deadline
                and self.time + timedelta(seconds=deadline)
                <= datetime.now()
            ):
                log.debug("Hit %s timeout, returning.",
                          "create" if create else "execution")
                # already-executed lanes still get their successors
                # pruned and recorded below; unexecuted lanes return
                # to the work list
                self.work_list += batch[lane + 1 :]
                timed_out = global_state
                break

            try:
                new_states, op_code = self.execute_state(global_state)
            except NotImplementedError:
                log.debug("Encountered unimplemented instruction")
                continue
            rounds.append((global_state, op_code, new_states))

        all_new = [s for _, _, succ in rounds for s in succ]
        if not args.sparse_pruning and all_new:
            kept = {id(s) for s in prune_infeasible(all_new)}
        else:
            kept = {id(s) for s in all_new}

        for global_state, op_code, new_states in rounds:
            surviving = [s for s in new_states if id(s) in kept]
            self.manage_cfg(op_code, surviving)
            if surviving:
                self.work_list += surviving
            elif track_gas:
                final_states.append(global_state)
            self.total_states += len(surviving)
        return timed_out

    def execute_state(
        self, global_state: GlobalState
    ) -> Tuple[List[GlobalState], Optional[str]]:
        instructions = global_state.environment.code.instruction_list
        try:
            op_code = instructions[global_state.mstate.pc].op_code
        except IndexError:
            self._add_world_state(global_state)
            return [], None
        if len(global_state.mstate.stack) < get_required_stack_elements(op_code):
            error_msg = (
                f"Stack Underflow Exception due to insufficient stack elements "
                f"for the address {instructions[global_state.mstate.pc].address}"
            )
            new_global_states = self.handle_vm_exception(
                global_state, op_code, error_msg
            )
            self._execute_post_hook(op_code, new_global_states)
            return new_global_states, op_code

        try:
            self._execute_pre_hook(op_code, global_state)
        except PluginSkipState:
            self._add_world_state(global_state)
            return [], None
        except PluginSkipWorldState:
            return [], None

        for hook in self._execute_state_hooks:
            hook(global_state)

        try:
            new_global_states = Instruction(
                op_code,
                self.dynamic_loader,
                pre_hooks=self.instr_pre_hook[op_code],
                post_hooks=self.instr_post_hook[op_code],
            ).evaluate(global_state)

        except VmException as e:
            for hook in self._transaction_end_hooks:
                hook(
                    global_state,
                    global_state.current_transaction,
                    None,
                    False,
                )
            new_global_states = self.handle_vm_exception(
                global_state, op_code, str(e)
            )

        except TransactionStartSignal as start_signal:
            new_global_state = start_signal.transaction.initial_global_state()
            new_global_state.transaction_stack = copy(
                global_state.transaction_stack
            ) + [(start_signal.transaction, global_state)]
            new_global_state.node = global_state.node
            new_global_state.world_state.constraints = (
                start_signal.global_state.world_state.constraints
            )
            log.debug("Starting new transaction %s", start_signal.transaction)
            return [new_global_state], op_code

        except TransactionEndSignal as end_signal:
            (
                transaction,
                return_global_state,
            ) = end_signal.global_state.transaction_stack[-1]

            for hook in self._transaction_end_hooks:
                hook(
                    end_signal.global_state,
                    transaction,
                    return_global_state,
                    end_signal.revert,
                )

            log.debug("Ending transaction %s.", transaction)
            if return_global_state is None:
                if (
                    not isinstance(transaction, ContractCreationTransaction)
                    or transaction.return_data
                ) and not end_signal.revert:
                    from mythril_tpu_torch.analysis.potential_issues import (
                        check_potential_issues,
                    )

                    check_potential_issues(global_state)
                    end_signal.global_state.world_state.node = global_state.node
                    self._add_world_state(end_signal.global_state)
                new_global_states = []
            else:
                self._execute_post_hook(op_code, [end_signal.global_state])
                new_annotations = [
                    a
                    for a in global_state.annotations
                    if a.persist_over_calls
                ]
                return_global_state.add_annotations(new_annotations)
                new_global_states = self._end_message_call(
                    copy(return_global_state),
                    global_state,
                    revert_changes=end_signal.revert,
                    return_data=transaction.return_data,
                )

        self._execute_post_hook(op_code, new_global_states)
        return new_global_states, op_code

    def _end_message_call(
        self,
        return_global_state: GlobalState,
        global_state: GlobalState,
        revert_changes: bool = False,
        return_data=None,
    ) -> List[GlobalState]:
        return_global_state.world_state.constraints += (
            global_state.world_state.constraints
        )
        op_code = return_global_state.environment.code.instruction_list[
            return_global_state.mstate.pc
        ].op_code

        return_global_state.last_return_data = return_data
        if not revert_changes:
            return_global_state.world_state = copy(global_state.world_state)
            return_global_state.environment.active_account = global_state.accounts[
                return_global_state.environment.active_account.address.value
            ]
            if isinstance(
                global_state.current_transaction, ContractCreationTransaction
            ):
                return_global_state.mstate.min_gas_used += (
                    global_state.mstate.min_gas_used
                )
                return_global_state.mstate.max_gas_used += (
                    global_state.mstate.max_gas_used
                )

        try:
            new_global_states = Instruction(
                op_code,
                self.dynamic_loader,
                pre_hooks=self.instr_pre_hook[op_code],
                post_hooks=self.instr_post_hook[op_code],
            ).evaluate(return_global_state, post=True)
        except VmException:
            new_global_states = []

        for state in new_global_states:
            state.node = global_state.node
        return new_global_states

    def _add_world_state(self, global_state: GlobalState) -> None:
        for hook in self._add_world_state_hooks:
            try:
                hook(global_state)
            except PluginSkipWorldState:
                return
        self.open_states.append(global_state.world_state)

    def handle_vm_exception(
        self, global_state: GlobalState, op_code: str, error_msg: str
    ) -> List[GlobalState]:
        _, return_global_state = global_state.transaction_stack.pop()
        if return_global_state is None:
            log.debug("VmException, ending path: `%s`", error_msg)
            return []
        self._execute_post_hook(op_code, [global_state])
        return self._end_message_call(
            return_global_state, global_state, revert_changes=True, return_data=None
        )

    # ------------------------------------------------------------------
    # CFG recording
    # ------------------------------------------------------------------

    def manage_cfg(self, opcode: Optional[str], new_states: List[GlobalState]) -> None:
        # Node objects are created unconditionally (function-name tagging
        # rides on them); requires_statespace only gates nodes/edges
        # *storage* (reference svm.py:465).
        if opcode is None:
            return
        if opcode == "JUMP":
            assert len(new_states) <= 1
            for state in new_states:
                self._new_node_state(state)
        elif opcode == "JUMPI":
            for state in new_states:
                self._new_node_state(state, JumpType.CONDITIONAL, state.world_state.constraints[-1] if state.world_state.constraints else None)
        elif opcode in ("SLOAD", "SSTORE") and len(new_states) > 1:
            for state in new_states:
                self._new_node_state(state, JumpType.CONDITIONAL, state.world_state.constraints[-1] if state.world_state.constraints else None)
        elif opcode in ("RETURN", "STOP"):
            for state in new_states:
                self._new_node_state(state, JumpType.RETURN)
        if self.requires_statespace:
            for state in new_states:
                if state.node is not None:
                    state.node.states.append(state)

    def _new_node_state(
        self, state: GlobalState, edge_type=JumpType.UNCONDITIONAL, condition=None
    ) -> None:
        try:
            address = state.environment.code.instruction_list[
                state.mstate.pc
            ].address
        except IndexError:
            return
        new_node = Node(state.environment.active_account.contract_name)
        old_node = state.node
        state.node = new_node
        new_node.constraints = state.world_state.constraints
        if self.requires_statespace:
            self.nodes[new_node.uid] = new_node
            if old_node is not None:
                self.edges.append(
                    Edge(
                        old_node.uid,
                        new_node.uid,
                        edge_type=edge_type,
                        condition=condition,
                    )
                )

        if edge_type == JumpType.RETURN:
            new_node.flags |= NodeFlags.CALL_RETURN

        environment = state.environment
        disassembly = environment.code
        if address in disassembly.address_to_function_name:
            environment.active_function_name = disassembly.address_to_function_name[
                address
            ]
            new_node.flags |= NodeFlags.FUNC_ENTRY
        new_node.function_name = environment.active_function_name
        new_node.start_addr = address

    # ------------------------------------------------------------------
    # hook registration
    # ------------------------------------------------------------------

    def register_hooks(self, hook_type: str, hook_dict: Dict[str, List[Callable]]):
        if hook_type == "pre":
            entrypoint = self.pre_hooks
        elif hook_type == "post":
            entrypoint = self.post_hooks
        else:
            raise ValueError(f"Invalid hook type {hook_type}")
        for op_code, funcs in hook_dict.items():
            entrypoint[op_code].extend(funcs)

    def register_laser_hooks(self, hook_type: str, hook: Callable):
        if hook_type not in self.hook_type_map:
            raise ValueError(f"Invalid hook type {hook_type}")
        self.hook_type_map[hook_type].append(hook)

    def register_instr_hooks(
        self, hook_type: str, op_code: str, hook: Callable
    ):
        registry = (
            self.instr_pre_hook if hook_type == "pre" else self.instr_post_hook
        )
        if not op_code:
            from mythril_tpu_torch.support.opcodes import OPCODES

            for info in OPCODES.values():
                registry[info.name].append(hook(info.name))
        else:
            registry[op_code].append(hook)

    def instr_hook(self, hook_type: str, op_code: Optional[str]) -> Callable:
        def hook_decorator(func: Callable):
            self.register_instr_hooks(hook_type, op_code, func)
            return func

        return hook_decorator

    def laser_hook(self, hook_type: str) -> Callable:
        def hook_decorator(func: Callable):
            self.register_laser_hooks(hook_type, func)
            return func

        return hook_decorator

    def _execute_pre_hook(self, op_code: str, global_state: GlobalState) -> None:
        if op_code in self.pre_hooks:
            for hook in self.pre_hooks[op_code]:
                hook(global_state)

    def _execute_post_hook(
        self, op_code: str, global_states: List[GlobalState]
    ) -> None:
        if op_code not in self.post_hooks:
            return
        for hook in self.post_hooks[op_code]:
            for global_state in global_states:
                try:
                    hook(global_state)
                except PluginSkipState:
                    global_states.remove(global_state)

    def _execute_hooks(self, hooks: List[Callable]) -> None:
        for hook in hooks:
            hook()

    def extend_strategy(self, extension, *args) -> None:
        """Wrap the current strategy with a decorator strategy (e.g.
        BoundedLoopsStrategy)."""
        self.strategy = extension(self.strategy, args)

    # decorator-style opcode hooks (reference svm.py:671-709)
    def pre_hook(self, op_code: str) -> Callable:
        def hook_decorator(func: Callable):
            self.pre_hooks[op_code].append(func)
            return func

        return hook_decorator

    def post_hook(self, op_code: str) -> Callable:
        def hook_decorator(func: Callable):
            self.post_hooks[op_code].append(func)
            return func

        return hook_decorator


class _WorldStateView:
    """Adapter so WorldStates ride through prune_infeasible (which reads
    state.world_state.constraints)."""

    __slots__ = ("world_state",)

    def __init__(self, world_state: WorldState):
        self.world_state = world_state
