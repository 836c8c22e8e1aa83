"""The program's own spans in a traced stretch: idle time, device time,
syncs, launches and host self time put down to the ``hanabi:`` span that
was innermost on the host at the time (``"none"`` outside every one).

    python3 -m hanabi_bench.spans --workload <cell> --seed <n>

runs the cell's traced stretch as ``python3 -m hanabi_bench.run --trace 1``
does and prints the table a frame, then one JSON line. Each quantity goes
to the innermost span open on the host:

- host self ns: the time a span was innermost (its duration less the part
  its child spans cover);
- idle ns: each interval of the window that no device operation covers,
  divided exactly among the spans innermost over it;
- device ns: each device operation, to the span innermost at the start of
  the runtime call that launched it (the two share CUPTI's correlation id);
- syncs and launches: the runtime calls of ``metrics/_common.py``'s
  ``SYNCS`` and ``LAUNCHES``, by the span innermost at their start.

Each sums over the spans and ``"none"`` to the window's total. The
attribution reads a :func:`record` of the profiler's events, a plain dict
that :func:`attribute` reduces and that can be stored as JSON.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
from collections import defaultdict
from typing import Dict, List, Tuple

from hanabi_bench import trace
from hanabi_bench.metrics import _common

__all__ = ["record", "attribute", "per_frame", "segments", "traced_run", "main"]

PREFIX = "hanabi:"
NONE = "none"
CALL_SPANS = ("bench:call", "bench:update+render")  # the benchmark's calls into the program
FIELDS = ("self_host", "idle", "device", "syncs", "launches")


def record(prof, frames: int) -> dict:
    """The profiler's events over the ``bench:window`` span as a plain
    dict: the program's spans, the benchmark's calls, the CUDA runtime and
    driver calls with their correlation ids, and the device operations
    (clipped to the window) with the ids of the calls that launched them."""
    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == trace.WINDOW_SPAN]
    if not win:
        raise RuntimeError("the trace holds no bench:window span")
    w0 = win[0].start_ns()
    w1 = w0 + win[0].duration_ns()
    out = {"frames": frames, "window": [w0, w1], "spans": [], "calls": [], "runtime": [],
           "device": []}
    for e in events:
        a = e.start_ns()
        b = a + e.duration_ns()
        if b <= w0 or a >= w1:
            continue
        name = e.name()
        if e.device_type().name != "CPU":
            if not e.is_user_annotation():
                out["device"].append([name, max(a, w0), min(b, w1), e.correlation_id()])
        elif name.startswith(PREFIX):
            out["spans"].append([name, a, b])
        elif name in CALL_SPANS:
            out["calls"].append([name, a, b])
        elif name.startswith("cu"):  # a CUDA runtime or driver call
            out["runtime"].append([name, a, b, e.correlation_id()])
    return out


def segments(spans, w0: int, w1: int) -> List[Tuple[int, int, str]]:
    """``[w0, w1)`` cut into ``(start, end, name)`` pieces, ``name`` the
    innermost span open over the piece (the latest started), ``"none"``
    where no span is open."""
    out: List[Tuple[int, int, str]] = []
    stack: List[Tuple[str, int, int]] = []
    t = w0

    def advance(to: int) -> None:
        nonlocal t
        while t < to:
            while stack and stack[-1][2] <= t:
                stack.pop()
            end = min(to, stack[-1][2]) if stack else to
            out.append((t, end, stack[-1][0] if stack else NONE))
            t = end

    for name, a, b in sorted(spans, key=lambda s: (s[1], -s[2])):
        if b <= w0 or a >= w1:
            continue
        advance(max(a, w0))
        stack.append((name, a, b))
    advance(w1)
    return out


def _idle(device, w0: int, w1: int) -> List[Tuple[int, int]]:
    """The intervals of ``[w0, w1)`` that no device operation covers."""
    gaps, cur = [], w0
    for _, a, b, _ in sorted(device, key=lambda o: o[1]):
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if w1 > cur:
        gaps.append((cur, w1))
    return gaps


def _overlap(pieces, intervals) -> Dict[str, int]:
    """ns of ``intervals`` (sorted, disjoint) under each piece's name."""
    out: Dict[str, int] = defaultdict(int)
    j = 0
    for a, b, name in pieces:
        while j < len(intervals) and intervals[j][1] <= a:
            j += 1
        k = j
        while k < len(intervals) and intervals[k][0] < b:
            out[name] += min(b, intervals[k][1]) - max(a, intervals[k][0])
            k += 1
    return out


def _union(intervals) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _intersect(xs, ys) -> List[Tuple[int, int]]:
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def attribute(rec: dict) -> dict:
    """The quantities of the module's docstring by span name (``"none"``
    included), in ns and counts over the window; ``totals`` the window's;
    ``call_idle_ns`` / ``call_idle_none_ns`` the idle time while the host
    was inside the benchmark's calls, all of it and the part under no
    program span; ``unlinked`` the device operations with no runtime call
    in the window (put down to ``"none"``)."""
    w0, w1 = rec["window"]
    pieces = segments(rec["spans"], w0, w1)
    starts = [p[0] for p in pieces]

    def at(t: int) -> str:
        i = bisect.bisect_right(starts, t) - 1
        return pieces[i][2] if 0 <= i and t < pieces[i][1] else NONE

    by: Dict[str, Dict[str, float]] = defaultdict(lambda: dict.fromkeys(FIELDS, 0))
    for a, b, name in pieces:
        by[name]["self_host"] += b - a
    idle = _idle(rec["device"], w0, w1)
    for name, ns in _overlap(pieces, idle).items():
        by[name]["idle"] += ns
    launched = {}
    for name, a, _, corr in rec["runtime"]:
        launched[corr] = at(a)
        if name in _common.SYNCS:
            by[at(a)]["syncs"] += 1
        if name in _common.LAUNCHES:
            by[at(a)]["launches"] += 1
    unlinked = 0
    for _, a, b, corr in rec["device"]:
        span = launched.get(corr)
        if span is None:
            unlinked += 1
            span = NONE
        by[span]["device"] += b - a
    call_idle = _intersect(_union((a, b) for _, a, b in rec["calls"]), idle)
    totals = {
        "self_host": w1 - w0,
        "idle": sum(b - a for a, b in idle),
        "device": sum(b - a for _, a, b, _ in rec["device"]),
        "syncs": sum(1 for r in rec["runtime"] if r[0] in _common.SYNCS),
        "launches": sum(1 for r in rec["runtime"] if r[0] in _common.LAUNCHES),
    }
    return {"frames": rec["frames"], "by_span": {k: dict(v) for k, v in by.items()},
            "totals": totals, "call_idle_ns": sum(b - a for a, b in call_idle),
            "call_idle_none_ns": _overlap(pieces, call_idle).get(NONE, 0), "unlinked": unlinked}


def per_frame(att: dict) -> Dict[str, Dict[str, float]]:
    """:func:`attribute`'s sums a frame: ms for the times, counts for the calls."""
    f = att["frames"] or 1
    scale = {"self_host": 1e-6, "idle": 1e-6, "device": 1e-6, "syncs": 1.0, "launches": 1.0}
    return {name: {k: v * scale[k] / f for k, v in row.items()}
            for name, row in sorted(att["by_span"].items())}


def traced_run(bench, workload: str, seed: int, device) -> Tuple[dict, dict]:
    """One ``--trace 1`` run of ``workload`` through ``run.run``: its result
    and the :func:`record` of its traced stretch. The harness keeps no
    handle on its profiler, so its ``trace.summarize`` is wrapped for the
    run to record the events it summarizes."""
    from hanabi_bench import run

    recorded = {}
    summarize = trace.summarize

    def summarize_and_record(prof, frames):
        recorded["rec"] = record(prof, frames)
        return summarize(prof, frames)

    trace.summarize = summarize_and_record
    try:
        out = run.run(bench, workload, seed, 0.0, True, device)
    finally:
        trace.summarize = summarize
    return out, recorded.get("rec")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    args = parser.parse_args(argv)
    import torch

    from hanabi_bench import spec

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    out, rec = traced_run(spec.load(), args.workload, args.seed, "cuda:0")
    if rec is None:
        print(f"no traced stretch: {out['error']}", file=sys.stderr)
        return 1
    att = attribute(rec)
    rows = per_frame(att)
    print(f"{'span':16} " + " ".join(f"{k:>10}" for k in FIELDS), file=sys.stderr)
    for name, row in rows.items():
        print(f"{name:16} " + " ".join(f"{row[k]:10.4f}" for k in FIELDS), file=sys.stderr)
    print(json.dumps({"workload": args.workload, "seed": args.seed, "correct": out["correct"],
                      "metrics": out["metrics"], "device": out["device"], "per_frame": rows,
                      "totals": att["totals"],
                      "call_idle_ns": att["call_idle_ns"],
                      "call_idle_none_ns": att["call_idle_none_ns"],
                      "unlinked": att["unlinked"], "frames": att["frames"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
