"""The traced stretch: ``torch.profiler`` over the window, reduced to a
:class:`Summary` that the per-layer metric readers read.

The benchmark marks its own spans with ``record_function`` (``bench:``
names) around its calls into the program; the summary holds the
profiler's device operations with their intervals and the host's calls by
name, the benchmark's spans, the program's own spans (``hanabi:`` names)
with what :mod:`~hanabi_bench.spans` puts down to each, and the program's
counters, which the loop reads once the window has closed. A summary read
back from JSON (:meth:`Summary.load`) lets the readers be tested on a
recorded one; one recorded before the program's spans and counters were
kept reads them as empty.
"""

from __future__ import annotations

import contextlib
import json
import re
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

__all__ = ["Summary", "profiled", "summarize", "span", "busy_ns", "short_name"]

WINDOW_SPAN = "bench:window"


@dataclass
class Summary:
    frames: int
    window: Tuple[int, int]  # ns, the traced stretch
    device_ops: List[Tuple[str, int, int]]  # (name, start ns, end ns), clipped to the window
    host_calls: Dict[str, int]  # host calls and ops by name, within the window
    spans: Dict[str, List[int]] = field(default_factory=dict)  # bench spans: durations, ns
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)  # by the host's label, s
    # the program's spans ("none": under none): spans.FIELDS, ns and counts over the window
    program_spans: Dict[str, Dict[str, int]] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)  # the program's, at the window's close

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    @staticmethod
    def load(path) -> "Summary":
        with open(path) as f:
            d = json.load(f)
        d["window"] = tuple(d["window"])
        d["device_ops"] = [tuple(o) for o in d["device_ops"]]
        d["idle_gaps"] = [tuple(g) for g in d["idle_gaps"]]
        return Summary(**d)

    def device_s(self, patterns) -> Tuple[float, int]:
        """Seconds of device operations whose names match any of
        ``patterns`` (regular expressions), and how many there were."""
        rx = [re.compile(p) for p in patterns]
        total, count = 0, 0
        for name, a, b in self.device_ops:
            if any(r.search(name) for r in rx):
                total += b - a
                count += 1
        return total * 1e-9, count

    def busy_s(self) -> float:
        return busy_ns([(a, b) for _, a, b in self.device_ops]) * 1e-9


def busy_ns(intervals) -> int:
    """The length of the union of ``(start, end)`` intervals."""
    total, cur_a, cur_b = 0, None, None
    for a, b in sorted(intervals):
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its return type and arguments."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)", "anon")
    return name.split("(")[0][:width] or "(unnamed)"


def span(name: str):
    """A benchmark span: a profiler range while tracing, nothing otherwise."""
    from torch.profiler import record_function

    return record_function(name)


@contextlib.contextmanager
def profiled(enabled: bool, device_type: str):
    """``torch.profiler`` over the block where ``enabled``; yields the
    profiler or None."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof


def _label_gaps(gaps, host) -> List[Tuple[str, float]]:
    """Idle seconds by what the host was in during each gap: the innermost
    host event covering the gap's middle (the latest-starting one that
    covers it), over the longest gaps, largest totals first."""
    host = sorted(host, key=lambda e: (e[1], -e[2]))
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:4000]
    totals: Dict[str, int] = defaultdict(int)
    stack, i = [], 0  # the host events open at the sweep's time, outermost first
    for a, b in sorted(longest, key=lambda g: g[0] + g[1]):
        mid = (a + b) // 2
        while i < len(host) and host[i][1] <= mid:
            while stack and stack[-1][2] <= host[i][1]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][2] <= mid:
            stack.pop()
        totals[stack[-1][0] if stack else "host:untraced"] += b - a
    return sorted(((k, v * 1e-9) for k, v in totals.items()), key=lambda kv: -kv[1])[:10]


def summarize(prof, frames: int) -> Summary:
    """The profiler's events over the ``bench:window`` span, and the
    program's spans attributed by :func:`~hanabi_bench.spans.attribute`."""
    from hanabi_bench import spans as program_spans

    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == WINDOW_SPAN]
    if not win:
        raise RuntimeError("the trace holds no bench:window span")
    w0, w1 = win[0].start_ns(), win[0].start_ns() + win[0].duration_ns()
    device, host = [], []
    host_calls: Counter = Counter()
    spans: Dict[str, List[int]] = defaultdict(list)
    for e in events:
        a = e.start_ns()
        b = a + e.duration_ns()
        if b <= w0 or a >= w1:
            continue
        name = e.name()
        if e.is_user_annotation() and e.device_type().name != "CPU":
            continue  # a benchmark or program range mirrored on the device's timeline
        if e.device_type().name == "CPU":
            if name == WINDOW_SPAN:
                continue
            host_calls[name] += 1
            host.append((name, a, b))
            if name.startswith("bench:"):
                spans[name].append(b - a)
        else:
            device.append((name, max(a, w0), min(b, w1)))
    device.sort(key=lambda o: o[1])
    gaps, cur = [], w0
    for _, a, b in device:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if w1 > cur:
        gaps.append((cur, w1))
    by_span = program_spans.attribute(program_spans.record(prof, frames))["by_span"]
    return Summary(frames, (w0, w1), device, dict(host_calls), dict(spans),
                   _label_gaps(gaps, host), by_span)


def breakdown(summary: Summary) -> dict:
    """The device operations that took most time and the longest idle gaps
    by the host's label, ten of each, in seconds."""
    by_op: Dict[str, int] = defaultdict(int)
    for name, a, b in summary.device_ops:
        by_op[short_name(name)] += b - a
    ops = sorted(((k, v * 1e-9) for k, v in by_op.items()), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [list(o) for o in ops],
            "idle_gaps": [[k, v] for k, v in summary.idle_gaps[:10]]}

