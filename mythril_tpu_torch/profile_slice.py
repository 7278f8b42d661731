#!/usr/bin/env python3
"""Where the port's main path spends its time on the card.

Runs one EVM-shaped frontier through
``mythril_tpu_torch.ops.batched_sat.batch_check_states`` on ``cuda``,
force-dispatched (``support_args.FORCE_DISPATCH_ARGS``: the profit gate
would leave it to the CDCL), once to build and warm, then once under
``torch.profiler``, and prints:

- the wall time and the device busy time of the profiled run, and the
  device's idle share (1 - busy / wall);
- the host ranges of the funnel and the solver tiers (``funnel.*``,
  ``dense.*``, ``resident.*``, ``frontier.*``) by CPU time;
- the device kernels by total device time.

Usage (from the repository root, on a machine with one NVIDIA GPU)::

    python3 -m mythril_tpu_torch.profile_slice [--frontier scale_mul|guard_chain]

Fails when no CUDA device is present.
"""

import argparse
import subprocess
import sys
import time


#: the record_function ranges of ops/batched_sat.py and ops/dense_prop.py
RANGES = ("funnel.", "dense.", "resident.", "frontier.")


def _frontier(name):
    from mythril_tpu_torch import frontiers

    if name == "scale_mul":
        return frontiers.scale_mul_frontier(6, 16)
    return frontiers.guard_chain_frontier(64, 32)


def _run(name):
    import torch

    from mythril_tpu_torch.ops import batched_sat as bs
    from mythril_tpu_torch.smt.solver import reset_blast_context
    from mythril_tpu_torch.support.support_args import (
        FORCE_DISPATCH_ARGS, args,
    )

    for key, value in FORCE_DISPATCH_ARGS.items():
        setattr(args, key, value)
    reset_blast_context()
    lanes, expected = _frontier(name)
    bs.dispatch_stats.reset()
    started = time.perf_counter()
    verdicts = bs.batch_check_states(lanes)
    torch.cuda.synchronize()
    wall = time.perf_counter() - started
    if verdicts != expected:
        raise SystemExit(f"{name}: wrong verdicts {verdicts}")
    return wall


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    parser = argparse.ArgumentParser()
    parser.add_argument("--frontier", choices=("scale_mul", "guard_chain"),
                        default="scale_mul")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_slice: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(f"card: {card}")
    _run(opts.frontier)  # build + warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = _run(opts.frontier)
    from mythril_tpu_torch.ops import batched_sat as bs

    stats = bs.dispatch_stats
    events = prof.key_averages()
    # device-side events only (CPU ops report their kernels' time too),
    # without the funnel's own ranges, which the profiler mirrors onto
    # the device timeline as annotations
    kernels = [
        e for e in events
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
        and not e.key.startswith(RANGES)
    ]
    device_us = sum(e.self_device_time_total for e in kernels)
    print(f"{opts.frontier}: wall {wall * 1e3:.1f} ms, device busy "
          f"{device_us / 1e3:.1f} ms, idle share "
          f"{1 - device_us / 1e3 / (wall * 1e3):.3f}; {stats.rounds} rounds,"
          f" {stats.device_sweeps} full sweeps, {stats.frontier_steps} "
          f"gather steps, {stats.resident_dispatches} resident solves")
    ranges = [e for e in events
              if e.key.startswith(RANGES) and e.device_type == DeviceType.CPU]
    for e in sorted(ranges, key=lambda e: -e.cpu_time_total):
        print(f"  host range {e.key:14s} {e.cpu_time_total / 1e3:9.1f} ms "
              f"x{e.count}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  device {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:5d}  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
