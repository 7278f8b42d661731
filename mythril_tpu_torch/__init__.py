"""PyTorch/CUDA port of ``mythril_tpu`` for one NVIDIA H100.

The JAX package ``mythril_tpu`` stays in the repository as the
reference; this package grows beside it slice by slice.  It imports
``torch`` and nothing of ``mythril_tpu``: every module it needs is its
own copy, under the same module path as its JAX counterpart.

It carries ``myth analyze`` over bytecode: LASER (``laser``), the
detection modules and the report (``analysis``), the analyzer and a
trimmed CLI (``mythril``, ``interfaces``).  Each round's frontier goes
through ``laser/batch.py:prune_infeasible`` to the solver plane's dense
tier: term-level path constraints are bit-blasted (``smt``), the
defining cones of a frontier are swept on the card by a hand-written
sm_90a CUDA kernel (``ops/dense_prop.py`` + ``ops/dense_sweep.py``), and
whatever the device leaves undecided goes to the native CDCL tail.

Entry points: ``python3 -m mythril_tpu_torch analyze`` and
``mythril.MythrilAnalyzer``, ``ops.batched_sat.batch_check_states``,
``ops.dense_prop.DenseSatBackend.check_assumption_sets``.  All run on
``cuda`` unless the caller asks for the CPU (``--device cpu``,
``device="cpu"``).
"""

from mythril_tpu_torch.__version__ import __version__  # noqa: F401
