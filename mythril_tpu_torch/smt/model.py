"""Model objects returned by the solvers (reference: laser/smt/model.py;
own copy of ``mythril_tpu/smt/model.py`` for the PyTorch port).

A model wraps the :class:`EvalEnv` extracted from a SAT assignment.
``eval`` evaluates any term DAG node under it; with
``model_completion=True`` unassigned symbols default to 0 (matching the
z3 behavior the reference relies on when concretizing transactions).
"""

from typing import List, Optional, Union

from mythril_tpu_torch.smt import terms as T


class ModelValue:
    """Mimics the small slice of z3's value API callers use."""

    __slots__ = ("_value",)

    def __init__(self, value: Union[int, bool]):
        self._value = value

    def as_long(self) -> int:
        return int(self._value)

    def __int__(self) -> int:
        return int(self._value)

    def __bool__(self) -> bool:
        return bool(self._value)

    def __eq__(self, other) -> bool:
        if isinstance(other, ModelValue):
            return self._value == other._value
        return self._value == other

    def __repr__(self) -> str:
        return f"ModelValue({self._value})"


class Model:
    def __init__(self, envs: Optional[List[T.EvalEnv]] = None):
        self.envs = envs or [T.EvalEnv()]
        self._merged_cache: Optional[T.EvalEnv] = None

    @property
    def env(self) -> T.EvalEnv:
        return self.envs[0]

    def _merged(self) -> T.EvalEnv:
        if len(self.envs) == 1:
            return self.envs[0]
        # envs are fixed at construction and tables are copied below,
        # so the merge is computed once (concretization evaluates many
        # expressions against one model)
        if self._merged_cache is not None:
            return self._merged_cache
        merged = T.EvalEnv()
        for env in self.envs:
            merged.variables.update(env.variables)
            for k, v in env.arrays.items():
                if k in merged.arrays:
                    merged.arrays[k].update(v)
                elif isinstance(v, T.DefaultTable):
                    # copy preserving the per-table unwritten-cell
                    # default (bucket-restricted probe envs rely on
                    # it); never alias the source env's table — the
                    # update branch above mutates in place
                    merged.arrays[k] = T.DefaultTable(v, v.default)
                else:
                    merged.arrays[k] = dict(v)
            merged.ufs.update(env.ufs)
        self._merged_cache = merged
        return merged

    def eval(self, expression, model_completion: bool = False) -> ModelValue:
        node = expression.raw if hasattr(expression, "raw") else expression
        return ModelValue(T.evaluate(node, self._merged()))
