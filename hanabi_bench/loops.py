"""The general generator: it drives the program as a traffic mix's
parameters say, through set-up and the measured window, and keeps what the
comparison needs. Every loop is closed: each call waits for its own
readback (``chunk``) or present (``scene``).

- ``chunk``: ``frames_per_call`` frames a call; after each call one
  readback of its per-frame checksums and the alive count (summed over
  the members of a tree). Before each call the pools are copied on the
  device, so the last call's starting pools are at hand for the
  comparison. Frames per second are all the window's frames over the
  time from its start to its last readback.
- ``scene``: one ``update`` and ``render`` a frame with at most
  ``in_flight`` frames enqueued; before frame ``n + in_flight`` is
  enqueued the loop waits on frame ``n``'s completion event, and that wait
  is frame ``n``'s present. Each frame's image sum is kept on the device;
  every ``span_frames`` frames the pools are copied on the device.

Set-up warms the pools to steady state through the window's own call, a
lifetime of frames from empty pools, so every shape the window uses is
built before it. The state is the program's, by member (its pools, and
the event buffers a tree's members pass on). A traced run's summary gets
the program's ``counters()``, where it has them, once the window has
closed.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from hanabi_bench import inputs as bench_inputs
from hanabi_bench import program as bench_program
from hanabi_bench import trace as bench_trace
from hanabi_bench.verify import Record, Span

__all__ = ["Window", "run_window"]


@dataclass
class Window:
    frames: int = 0
    failed: int = 0
    seconds: float = 0.0  # from the window's start to its last readback or present
    setup_s: float = 0.0
    presents: List[float] = field(default_factory=list)
    calls: List[float] = field(default_factory=list)  # seconds of each call of a chunk window
    memory_window: int = 0  # bytes, the window's peak
    memory_peak: int = 0  # bytes, the process's peak up to the window's end
    record: Optional[Record] = None
    summary: Optional[bench_trace.Summary] = None
    error: Optional[str] = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _copy(state):
    return {m: {k: v.clone() for k, v in s.items()} for m, s in state.items()}


def _copy_into(snap, state) -> None:
    for m, s in state.items():
        for key, v in s.items():
            snap[m][key].copy_(v)


def _alive(state) -> torch.Tensor:
    """The lanes alive over every member, a device scalar."""
    total = None
    for s in state.values():
        n = s["alive"].sum()
        total = n if total is None else total + n
    return total


def run_window(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Window:
    """Build, warm and measure one cell; ``trace`` profiles a fixed stretch
    of ``trace_frames`` frames in place of ``seconds``."""
    device = torch.device(device)
    config, traffic = cell.config, cell.traffic
    prog = bench_program.build(config, traffic, seed, device)
    warm = bench_inputs.warm_frames(config, traffic)
    loop = _chunk_loop if traffic["loop"] == "chunk" else _scene_loop
    return loop(prog, traffic, warm, seconds, trace, device, t_start)


def _start(prog, warm: int, device, t_start: float, out: Window):
    """After the warm-up: the starting pools on the host, the set-up's
    peak memory, and a fresh peak for the window."""
    start = {m: {k: v.cpu() for k, v in s.items()} for m, s in prog.state().items()}
    _sync(device)
    if device.type == "cuda":
        out.memory_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    out.record = Record(warm, start)
    t0 = time.perf_counter()
    out.setup_s = t0 - t_start
    return t0


def _finish(prog, device, out: Window, prof, frames: int) -> None:
    """After the window: its peak memory, and a traced run's summary with
    the program's counters, read now and never inside the window."""
    _sync(device)
    if device.type == "cuda":
        out.memory_window = torch.cuda.max_memory_allocated(device)
        out.memory_peak = max(out.memory_peak, out.memory_window)
    if prof is not None:
        out.summary = bench_trace.summarize(prof, frames)
        if hasattr(prog, "counters"):
            out.summary.counters = prog.counters()


def _chunk_loop(prog, traffic, warm, seconds, trace, device, t_start) -> Window:
    k = traffic["frames_per_call"]
    out = Window()
    f = 0
    while f < warm:
        prog.call(prog.inputs(f, k))
        f += k
    t0 = _start(prog, warm, device, t_start, out)
    snap = _copy(prog.state())
    target = traffic["trace_frames"] if trace else None
    first_span = last = None
    t_last = t0
    with bench_trace.profiled(trace, device.type) as prof:
        with bench_trace.span(bench_trace.WINDOW_SPAN):
            while True:
                first = f
                try:
                    with bench_trace.span("bench:snapshot"):
                        _copy_into(snap, prog.state())
                    with bench_trace.span("bench:inputs"):
                        stacked = prog.inputs(f, k)
                    with bench_trace.span("bench:call"):
                        sums, img = prog.call(stacked)
                    with bench_trace.span("bench:readback"):
                        alive = _alive(prog.state()).view(1).double()
                        back = (alive if sums is None else torch.cat([sums.double(), alive])).cpu()
                except (RuntimeError, ValueError) as exc:  # a call that raises fails its frames
                    out.failed += k
                    out.error = f"{type(exc).__name__}: {exc}"
                    break
                out.calls.append(time.perf_counter() - t_last)
                t_last = time.perf_counter()
                f += k
                out.frames += k
                last = (first, back, img)
                if first_span is None:
                    first_span = Span(first, k, None, back[:-1] if sums is not None else None,
                                      img, None, int(back[-1]))
                if (out.frames >= target) if trace else (t_last - t0 >= seconds):
                    break
        out.seconds = t_last - t0
    _finish(prog, device, out, prof, out.frames)
    if last is None:
        return out
    first, back, img = last
    end = prog.state()
    if first == first_span.first:
        first_span.end = end
        out.record.spans = [first_span]
    else:
        out.record.spans = [first_span,
                            Span(first, k, snap, back[:-1] if img is not None else None, img,
                                 end, None)]
    return out


def _scene_loop(prog, traffic, warm, seconds, trace, device, t_start) -> Window:
    in_flight = traffic["in_flight"]
    span_frames = traffic["span_frames"]
    out = Window()
    for _ in range(warm):
        prog.frame()
    t0 = _start(prog, warm, device, t_start, out)
    snap = _copy(prog.state())
    snap_at = warm
    target = traffic["trace_frames"] if trace else None
    pending = collections.deque()
    sums = []
    img = None
    f = warm

    def present():
        ev = pending.popleft()
        with bench_trace.span("bench:present"):
            if ev is not None:
                ev.synchronize()
        out.presents.append(time.perf_counter())

    with bench_trace.profiled(trace, device.type) as prof:
        with bench_trace.span(bench_trace.WINDOW_SPAN):
            while True:
                try:
                    if (f - warm) % span_frames == 0:
                        with bench_trace.span("bench:snapshot"):
                            _copy_into(snap, prog.state())
                        snap_at = f
                    with bench_trace.span("bench:update+render"):
                        img = prog.frame()
                    sums.append(img.sum())
                    ev = None
                    if device.type == "cuda":
                        ev = torch.cuda.Event()
                        ev.record()
                    pending.append(ev)
                    if len(pending) >= in_flight:
                        present()
                except (RuntimeError, ValueError) as exc:
                    out.failed += 1
                    out.error = f"{type(exc).__name__}: {exc}"
                    break
                f += 1
                out.frames += 1
                if (out.frames >= target) if trace else (time.perf_counter() - t0 >= seconds):
                    break
            while pending:
                present()
        out.seconds = (out.presents[-1] - t0) if out.presents else 0.0
    _finish(prog, device, out, prof, out.frames)
    if not out.frames:
        return out
    checks = torch.stack(sums).double().cpu()
    end = prog.state()
    first = Span(warm, min(span_frames, out.frames), None,
                 checks[: min(span_frames, out.frames)], None, None, None)
    if snap_at == warm:
        first = Span(warm, out.frames, None, checks, img, end, None)
        out.record.spans = [first]
    else:
        out.record.spans = [first, Span(snap_at, f - snap_at, snap, checks[snap_at - warm:], img,
                                        end, None)]
    return out
