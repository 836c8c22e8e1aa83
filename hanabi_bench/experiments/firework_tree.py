"""The test tree (``tests/data/tree/firework_tree.json``) at the size of
the JAX package's ``bench_firework_events``, 65,536 rockets and 262,144
trails, drawn at 512 x 512: a measurement, not a cell of ``BENCHMARK.json``.

    python3 -m hanabi_bench.experiments.firework_tree --mix chunk --seeds <n> ... \\
        [--seconds 51] [--trace 0|1]

Each run goes through the harness as a cell's run does (``loops``, then
the comparison with the tree's plain reference) on ``--device`` (by
default ``cuda:0``), 120 frames
a call (``--mix chunk``: ``update_render_chunk``; ``sim``:
``update_chunk``; ``scene``: a frame a call), and prints one JSON line:
the end-to-end readings, the comparison's readings and limits, whether
they pass, the process's and the window's device memory, and the run's
wall seconds (set-up, window and comparison); with ``--trace 1`` the
device's busy and window seconds, the breakdown, the program's spans per
frame and its counters.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from hanabi_bench import run  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--mix", default="chunk", choices=("chunk", "sim", "scene"))
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=51.0)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--scale", type=int, default=128)
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--device", default="cuda:0")
    args = parser.parse_args(argv)
    for var, path in run.CACHES.items():
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    import torch

    from hanabi_bench import loops, verify
    from hanabi_bench import trace as bench_trace
    from hanabi_bench.tests._tiny import TreeBench

    dev = args.device
    if dev.startswith("cuda") and not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    bench = TreeBench(frames=120, scale=args.scale, width=args.width)
    cell = bench.cell(f"firework_tree.{args.mix}")
    t_start = T_START
    for seed in args.seeds:
        window = loops.run_window(cell, seed, args.seconds, bool(args.trace), dev, t_start)
        readings = {}
        if window.error is None and window.frames:
            readings = verify.compare(window.record, cell, seed, dev)
        out = {"mix": args.mix, "seed": seed, "frames": window.frames, "failed": window.failed,
               "error": window.error, "window_s": window.seconds,
               "end_to_end": run.end_to_end(window), "readings": readings,
               "limits": cell.limits, "correct": window.failed == 0 and window.frames > 0
               and verify.judge(readings, cell.limits),
               "memory_peak_bytes": window.memory_peak,
               "memory_window_bytes": window.memory_window,
               "wall_s": time.perf_counter() - t_start,
               "device": torch.cuda.get_device_name(dev) if dev.startswith("cuda") else dev}
        if window.summary is not None:
            s = window.summary
            out["busy_s"], out["traced_window_s"] = s.busy_s(), s.window_s
            out["breakdown"] = bench_trace.breakdown(s)
            out["program_spans_ms_per_frame"] = {
                k: {f: v * (1e-6 if f in ("self_host", "idle", "device") else 1.0) / s.frames
                    for f, v in row.items()} for k, row in s.program_spans.items()}
            out["counters"] = s.counters
        print(json.dumps(out), flush=True)
        del window
        if dev.startswith("cuda"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        t_start = time.perf_counter()
    found = run.forbidden_modules()
    if found:
        print(f"the run imported JAX or the JAX package: {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
