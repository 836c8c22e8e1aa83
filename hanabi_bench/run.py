"""Run one benchmark cell once and print its result as the last line.

    python3 -m hanabi_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this folder and
the program, ``bevy_hanabi_tpu_torch``, on a machine with an NVIDIA GPU.
The run builds (or loads) the program's CUDA library, warms the cell's
pools up, measures for ``--seconds`` (``--trace 0``: the end-to-end
metrics) or profiles a fixed stretch (``--trace 1``: the per-layer
metrics), compares what the timed path produced with the configuration's
plain reference, and prints one JSON line: ``correct``, ``attempted`` and
``failed`` frames, ``metrics``, ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``, each number compared beside its limit
(also the last lines of standard error). It exits non-zero, printing no
result, without a GPU, or if JAX or the JAX package got imported.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed path inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": ROOT / ".bench_cache" / "torch_extensions",
          "TRITON_CACHE_DIR": ROOT / ".bench_cache" / "triton"}
FORBIDDEN = ("jax", "jaxlib", "flax", "bevy_hanabi_tpu")

__all__ = ["main", "run", "end_to_end", "forbidden_modules"]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def _p95(values):
    import numpy as np

    return float(np.percentile(np.asarray(values, np.float64), 95)) if len(values) else None


def end_to_end(window) -> dict:
    """Every end-to-end metric this harness takes, by name."""
    intervals = [1e3 * (b - a) for a, b in zip(window.presents, window.presents[1:])]
    return {
        "frames_per_s": window.frames / window.seconds if window.seconds > 0 else None,
        "frame_ms_p95": _p95(intervals),
        "device_mem_gib": window.memory_window / 2**30 if window.memory_window else None,
        "setup_s": window.setup_s,
    }


def run(bench, workload: str, seed: int, seconds: float, trace: bool, device,
        t_start: float = T_START) -> dict:
    """One run of a cell on ``device``: the result's fields, and
    ``readings`` and ``limits`` of the comparison."""
    import torch

    from hanabi_bench import loops, spec, verify
    from hanabi_bench import trace as bench_trace

    cell = bench.cell(workload)
    window = loops.run_window(cell, seed, seconds, trace, device, t_start)
    units = {m.name: m.unit for m in bench.end_to_end + bench.per_layer}
    metrics, breakdown = {}, None
    if trace:
        if window.summary is not None:
            for m in cell.per_layer:
                value = spec.load_module("metrics", m.name).read(window.summary, cell)
                if value is not None:
                    metrics[m.name] = {"value": value, "unit": units[m.name]}
            breakdown = bench_trace.breakdown(window.summary)
    else:
        e2e = end_to_end(window)
        for m in cell.end_to_end:
            if e2e.get(m.name) is not None:
                metrics[m.name] = {"value": e2e[m.name], "unit": units[m.name]}
    readings = {}
    if window.record is not None and window.error is None and window.frames:
        readings = verify.compare(window.record, cell, seed, device)
    dev = torch.device(device)
    out = {
        "correct": window.failed == 0 and window.frames > 0 and verify.judge(readings, cell.limits),
        "attempted": window.frames + window.failed,
        "failed": window.failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
            "count": 1,
            "memory_peak_bytes": window.memory_peak,
        },
        "readings": readings,
        "limits": cell.limits,
        "error": window.error,
        "frames": window.frames,
        "calls": window.calls,
        "presents": window.presents,
    }
    if trace and window.summary is not None:
        out["device"]["busy_s"] = window.summary.busy_s()
        out["device"]["window_s"] = window.summary.window_s
        out["breakdown"] = breakdown
    return out


def result_line(out: dict) -> str:
    """The contract's line: ``checks`` last, each number with its limit."""
    line = {k: out[k] for k in ("correct", "attempted", "failed", "metrics", "device")}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = {k: {"value": out["readings"].get(k), "limit": v}
                      for k, v in out["limits"].items()}
    return json.dumps(line)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for var, path in CACHES.items():
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)

    import torch

    from hanabi_bench import spec

    bench = spec.load()
    chips = bench.cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = run(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0")
    found = forbidden_modules()
    if found:
        print(f"the run imported JAX or the JAX package: {found}", file=sys.stderr)
        return 3
    print(f"frames {out['frames']} failed {out['failed']} error {out['error']}", file=sys.stderr)
    intervals = [b - a for a, b in zip(out["presents"], out["presents"][1:])]
    for what, xs in (("call_s", out["calls"]), ("present_interval_s", intervals)):
        if xs:
            xs = sorted(xs)
            pct = " ".join(f"p{q} {xs[min(len(xs) - 1, len(xs) * q // 100)]:.6f}"
                           for q in (0, 50, 90, 95, 97, 99, 100))
            print(f"{what} n {len(xs)} {pct}", file=sys.stderr)
    for k, v in out["limits"].items():
        print(f"check {k} {out['readings'].get(k)} limit {v}", file=sys.stderr)
    print(result_line(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
