"""Independent DRAT-style proof checker (wrong-UNSAT defense; own copy
of ``mythril_tpu/smt/drat.py``).

The reference trusts z3's verdicts unconditionally
(reference: mythril/laser/smt/solver/solver.py:47-57); this build's
decision procedure is its own CDCL (native/csrc/cdcl.cpp), so UNSAT
verdicts need an independent certificate — a buggy UNSAT silently
erases findings (SURVEY §4).  The solver records an event stream when
proof logging is on (``SatSolver.enable_proof``); this module replays
it with its OWN unit propagator, sharing no code or data structures
with the solver:

* ``LEARN`` events must have the RUP property (assigning the clause's
  negation and unit-propagating over the live clause set must yield a
  conflict) — a corrupted learned clause fails here;
* ``ASSUMPTION_CONFLICT`` events (an UNSAT-under-assumptions verdict)
  must conflict under unit propagation of the assumption cube;
* ``DB_CONFLICT`` events (the database itself became UNSAT) must
  conflict under propagation from nothing.

The checker is deliberately simple (full occurrence lists, no
heuristics): correctness over speed.  It is meant for CI-tier
instances — torture-test CNFs and small real analyses — not for
production pools.
"""

from typing import Dict, List, Optional, Tuple

import numpy as np

ORIG, LEARN, DELETE, ASSUMPTION_CONFLICT, DB_CONFLICT = 3, 1, 2, 4, 5


class ProofError(AssertionError):
    """A proof event failed its check — the UNSAT verdict is suspect."""


def parse_events(stream: np.ndarray) -> List[Tuple[int, Tuple[int, ...]]]:
    events = []
    i = 0
    n = len(stream)
    while i < n:
        marker = int(stream[i])
        i += 1
        lits = []
        while i < n and stream[i] != 0:
            lits.append(int(stream[i]))
            i += 1
        i += 1  # skip the 0 terminator
        events.append((marker, tuple(lits)))
    return events


class _Propagator:
    """Unit propagation over a growable clause set using full
    occurrence lists (a clause is re-examined whenever ANY of its
    literals is falsified).  Deliberately not two-watch: static watches
    without relocation are incomplete, and relocation logic is exactly
    the kind of cleverness an independent checker must not share with
    the solver it is checking."""

    def __init__(self):
        self.clauses: List[Optional[Tuple[int, ...]]] = []
        self.watches: Dict[int, List[int]] = {}
        self.units: List[int] = []  # top-level unit literals
        self.empty_clause = False
        # live count per clause key for deletion handling
        self._by_key: Dict[Tuple[int, ...], List[int]] = {}

    def add(self, lits: Tuple[int, ...]) -> None:
        if len(lits) == 0:
            self.empty_clause = True
            return
        if len(lits) == 1:
            self.units.append(lits[0])
            return
        index = len(self.clauses)
        self.clauses.append(lits)
        self._by_key.setdefault(tuple(sorted(lits)), []).append(index)
        for lit in lits:
            self.watches.setdefault(-lit, []).append(index)

    def delete(self, lits: Tuple[int, ...]) -> None:
        key = tuple(sorted(lits))
        stack = self._by_key.get(key)
        if not stack:
            return  # deleting a clause we never saw: ignore (harmless)
        index = stack.pop()
        self.clauses[index] = None  # watches skip dead entries lazily

    def propagate(self, seed: Tuple[int, ...]) -> bool:
        """True iff unit propagation from ``seed`` (plus the stored
        top-level units) reaches a conflict."""
        if self.empty_clause:
            return True
        assign: Dict[int, bool] = {}
        queue: List[int] = []

        def enqueue(lit: int) -> bool:
            var, val = abs(lit), lit > 0
            if var in assign:
                return assign[var] == val
            assign[var] = val
            queue.append(lit)
            return True

        for lit in self.units:
            if not enqueue(lit):
                return True
        for lit in seed:
            if not enqueue(lit):
                return True
        head = 0
        while head < len(queue):
            # enqueueing q makes literal -q false; clauses containing
            # -q are stored under key q (add() keys each clause by the
            # negation of its literals)
            enqueued = queue[head]
            head += 1
            for index in self.watches.get(enqueued, []):
                clause = self.clauses[index] if index < len(
                    self.clauses
                ) else None
                if clause is None:
                    continue
                unassigned = None
                satisfied = False
                count = 0
                for lit in clause:
                    var = abs(lit)
                    if var in assign:
                        if assign[var] == (lit > 0):
                            satisfied = True
                            break
                    else:
                        unassigned = lit
                        count += 1
                        if count > 1:
                            break
                if satisfied or count > 1:
                    continue
                if count == 0:
                    return True  # conflict
                if not enqueue(unassigned):
                    return True
        return False


class IncrementalChecker:
    """Replays a solver's GROWING proof stream across repeated
    certification calls without re-checking the prefix: the propagator
    and cumulative counters persist, and :meth:`feed` verifies only the
    events appended since the previous call (fire_lasers certifies once
    per contract against one shared solver — full replays would be
    O(contracts x stream))."""

    def __init__(self):
        self._prop = _Propagator()
        self._ints_done = 0  # int32 slots already parsed + replayed
        self._stats = {
            "orig": 0, "learned": 0, "deleted": 0, "unsat_verdicts": 0,
        }

    def feed(self, stream: np.ndarray) -> Dict[str, int]:
        # the stream is append-only: parse and replay only the suffix
        # (the fetch itself is one memcpy; re-PARSING the whole stream
        # per call was the O(contracts x stream) cost)
        events = parse_events(stream[self._ints_done:])
        _replay(self._prop, events, self._stats, start=0)
        self._ints_done = len(stream)
        return dict(self._stats)


def check_proof(stream: np.ndarray) -> Dict[str, int]:
    """Replay a complete proof stream; raises :class:`ProofError` on
    the first event that fails.  Returns counters for reporting."""
    prop = _Propagator()
    stats = {"orig": 0, "learned": 0, "deleted": 0, "unsat_verdicts": 0}
    _replay(prop, parse_events(stream), stats, start=0)
    return stats


def _replay(prop, events, stats, start: int) -> None:
    for position, (marker, lits) in enumerate(events[start:], start):
        if marker == ORIG:
            prop.add(lits)
            stats["orig"] += 1
        elif marker == LEARN:
            # RUP: the negation of the clause must propagate to conflict
            if not prop.propagate(tuple(-lit for lit in lits)):
                raise ProofError(
                    f"event {position}: learned clause {lits} is not RUP"
                )
            prop.add(lits)
            stats["learned"] += 1
        elif marker == DELETE:
            prop.delete(lits)
            stats["deleted"] += 1
        elif marker == ASSUMPTION_CONFLICT:
            if not prop.propagate(lits):
                raise ProofError(
                    f"event {position}: UNSAT verdict under assumptions "
                    f"{lits} is not certified by propagation"
                )
            stats["unsat_verdicts"] += 1
        elif marker == DB_CONFLICT:
            if not prop.propagate(()):
                raise ProofError(
                    f"event {position}: DB-UNSAT verdict is not certified"
                )
            stats["unsat_verdicts"] += 1
        else:
            raise ProofError(f"event {position}: unknown marker {marker}")
