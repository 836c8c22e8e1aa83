"""The comparison's control: the plain reference computed in bfloat16, the
precision below the configurations' float32, put in the program's place
and judged by the same comparison as a run.

    python3 -m hanabi_bench.control --workload <cell> --seeds <n> [<n> ...]

It produces what a run's timed path hands over (the pools after the
warm-up, then two spans of the mix's calls: their per-frame checksums,
last images, pools and alive counts) and prints, a line a seed, the
readings and whether the comparison passes them (it must not). Run on the
chip at the cell's own size; the benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from hanabi_bench import inputs as bench_inputs
from hanabi_bench import spec, verify

__all__ = ["control_record", "main"]


def _state(ref) -> dict:
    return {m: {k: v.clone() for k, v in s.items()} for m, s in ref.pool.items()}


def control_record(cell: spec.Cell, seed: int, device, ft=torch.bfloat16) -> verify.Record:
    """The record of two calls of the cell's mix produced by the
    configuration's reference (:func:`verify.reference`) in ``ft``."""
    traffic = cell.traffic
    ref = verify.reference(cell, seed, device, ft)
    warm = bench_inputs.warm_frames(cell.config, traffic)
    ref.advance(warm)
    record = verify.Record(warm, _state(ref))
    k = traffic.get("frames_per_call") or traffic["span_frames"]
    for i in range(2):
        first, start = ref.frame, _state(ref)
        images = ref.advance(k, render_at=set(range(k)) if ref.render else ())
        sums = (torch.tensor([float(images[j].sum()) for j in range(k)], dtype=torch.float64)
                if images else None)
        span = verify.Span(first, k, None if i == 0 else start, sums,
                           images.get(k - 1), _state(ref), verify.alive_total(ref.pool))
        record.spans.append(span)
    return record


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--device", default="cuda:0")
    args = parser.parse_args(argv)
    cell = spec.load().cell(args.workload)
    for seed in args.seeds:
        readings = verify.compare(control_record(cell, seed, args.device), cell, seed,
                                  args.device)
        print(json.dumps({"workload": args.workload, "seed": seed, "readings": readings,
                          "passes": verify.judge(readings, cell.limits)}), flush=True)
        if args.device.startswith("cuda"):
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    np.seterr(all="ignore")
    sys.exit(main())
