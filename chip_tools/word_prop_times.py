#!/usr/bin/env python3
"""Device times of the word tier's fixpoint kernel (``word_prop``) against
its plain version, on the word tier's own inputs: seeded random term
DAGs (``frontiers.word_dag_lanes``) and the programs of the chip check's
two main-path frontiers (the ``scale_mul`` tree and the guard chain, 64
lanes each, lowered as the word tier lowers them).

Run on the card from the repository root::

    python3 chip_tools/word_prop_times.py [--skip-plain]

Builds ``ops/csrc/word_prop.cu`` (printing ``-Xptxas -v``), holds every
launch bit for bit against ``word_fixpoint_plain`` (on the host; with
``--skip-plain`` only the random DAGs are held), then prints the card
line and one JSON line a case: nodes, lanes, device ms (CUDA events
around 10 bare launches), plain ms (eager torch on the card, one run),
bound ms.  Exits non-zero without a card or when a launch differs.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    import chip_smoke as cs

    parser = argparse.ArgumentParser()
    parser.add_argument("--skip-plain", action="store_true",
                        help="hold only the random DAGs against the plain "
                             "version (the frontiers' take seconds)")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("word_prop_times: no CUDA device", file=sys.stderr)
        return 2
    from mythril_tpu_torch import frontiers
    from mythril_tpu_torch.ops import word_fixpoint as WF
    from mythril_tpu_torch.smt.word_tier import WORD_ROUNDS

    card = cs.card_line()
    started = time.perf_counter()
    WF.load_library()
    print(f"build word_prop.cu {time.perf_counter() - started:.1f} s",
          flush=True)
    if WF.build_info is not None:
        print(WF.build_info[1], flush=True)

    def frontier(build):
        lanes, _ = build()
        return [[c.raw for c in lane] for lane in lanes]

    cases = [(f"random DAG seed {seed}, {lanes} lanes, widths {widths}",
              frontiers.word_dag_lanes(seed, lanes, widths), True)
             for seed, lanes, widths in cs.WORD_DAGS]
    cases += [
        ("scale_mul d6 g16", frontier(
            lambda: frontiers.scale_mul_frontier(6, 16)), not opts.skip_plain),
        ("guard chain 64x32", frontier(
            lambda: frontiers.guard_chain_frontier(64, 32)),
         not opts.skip_plain),
    ]
    rows = []
    for label, lanes, hold in cases:
        table_host, want0_host, rounds = cs.word_inputs(lanes, WORD_ROUNDS)
        table, want0 = table_host.to("cuda"), want0_host.to("cuda")
        got = WF.word_fixpoint(table, want0, rounds)
        torch.cuda.synchronize()
        plain_ms = None
        if hold:
            t0 = time.perf_counter()
            want = WF.word_fixpoint_plain(table, want0, rounds)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            for name, g, w in zip(("planes", "tri", "conflict"), got, want):
                if not torch.equal(g, w):
                    print(f"{label}: {name} differs from the plain version",
                          file=sys.stderr)
                    return 1
        ms = cs.word_kernel_ms(table, want0, rounds)
        bound_ms, bound_by = cs.word_bound(table, want0.shape[1], rounds)
        rows.append({"case": label, "nodes": table.n_bv + table.n_bool,
                     "lanes": want0.shape[1],
                     "conflicts": int(got[2].sum()), "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "held": hold})
        print(json.dumps(rows[-1]), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
