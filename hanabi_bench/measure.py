"""Run a cell several times, each run its own process, and report the
spread of every metric and the worst reading of every number compared.

    python3 -m hanabi_bench.measure --workload <cell> --seeds <n> ... [--sets 2]
        [--seconds <s>] [--trace 0|1] [--out <file.jsonl>]

Each set runs every seed once, in order; the sets repeat the same seeds.
A spread is the distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) over the median. The runs' result
lines, with the end of their standard error, go to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

from hanabi_bench import spec

__all__ = ["spread", "main"]


def spread(values) -> float:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else float("inf")


def _run(workload, seed, seconds, trace) -> dict:
    cmd = [sys.executable, "-m", "hanabi_bench.run", "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t = time.perf_counter()
    p = subprocess.run(cmd, cwd=spec.ROOT, capture_output=True, text=True)
    wall = time.perf_counter() - t
    lines = p.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    return {"seed": seed, "trace": trace, "rc": p.returncode, "wall_s": wall, "result": result,
            "stderr_tail": p.stderr[-3000:]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--sets", type=int, default=1)
    parser.add_argument("--seconds", type=float, default=None)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    seconds = args.seconds or spec.load().data["run_seconds"]
    runs = []
    out = open(args.out, "a") if args.out else None
    for s in range(args.sets):
        for seed in args.seeds:
            r = _run(args.workload, seed, seconds, args.trace)
            r["set"] = s
            runs.append(r)
            res = r["result"] or {}
            print(json.dumps({"set": s, "seed": seed, "rc": r["rc"], "wall_s": round(r["wall_s"], 1),
                              "correct": res.get("correct"), "metrics": {
                                  k: v["value"] for k, v in res.get("metrics", {}).items()},
                              "checks": {k: v["value"] for k, v in res.get("checks", {}).items()}}),
                  flush=True)
            if r["rc"] != 0 or not res:
                print(r["stderr_tail"][-1500:], flush=True)
            for line in r["stderr_tail"].splitlines():
                if line.startswith(("call_s", "present_interval_s")):
                    print("  " + line, flush=True)
            if out:
                out.write(json.dumps(r) + "\n")
                out.flush()
    ok = [r["result"] for r in runs if r["result"]]
    names = sorted({k for res in ok for k in res["metrics"]})
    for s in range(args.sets):
        for name in names:
            vals = [r["result"]["metrics"][name]["value"] for r in runs
                    if r["set"] == s and r["result"] and name in r["result"]["metrics"]]
            if len(vals) >= 2:
                print(f"set {s} {name}: median {statistics.median(vals)!r} "
                      f"spread {spread(vals)!r} n {len(vals)}", flush=True)
    worst = {}
    for res in ok:
        for k, v in res.get("checks", {}).items():
            if v["value"] is not None:
                worst[k] = max(worst.get(k, 0.0), v["value"])
    print(f"worst readings {json.dumps(worst)}; correct {sum(bool(r['correct']) for r in ok)} "
          f"of {len(runs)}", flush=True)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
