"""What several per-layer metrics read alike from a trace summary."""

from __future__ import annotations

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
            "cuLaunchKernel", "cuLaunchKernelEx")
# the host calls that block until the device has caught up: stream, device
# and event synchronisation, and the synchronous copy
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")


def per_frame(summary, names):
    if not summary.frames or not summary.host_calls:
        return None
    return sum(summary.host_calls.get(n, 0) for n in names) / summary.frames


def device_ms_per_frame(summary, patterns):
    seconds, count = summary.device_s(patterns)
    if not count or not summary.frames:
        return None
    return 1e3 * seconds / summary.frames


def idle_pct(summary):
    if summary.window_s <= 0 or not summary.device_ops:
        return None
    return 100.0 * (1.0 - summary.busy_s() / summary.window_s)
