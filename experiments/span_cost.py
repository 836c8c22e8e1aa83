"""What a ``profile_span`` costs the host, off and on, on a CUDA machine.

    python3 experiments/span_cost.py

Prints one JSON line of microseconds a call, each the best of seven runs
of a loop of ``with`` blocks around nothing: the profiler-enabled check
alone; an NVTX push and pop; ``profile_span`` and ``record_function``
with no profiler session; and ``profile_span`` inside a ``torch.profiler``
session tracing the CPU and the card (its on cost).
"""

from __future__ import annotations

import json
import sys
import timeit
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
from torch.autograd import _profiler_enabled  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from bevy_hanabi_tpu_torch.utils.profiling import profile_span  # noqa: E402

N = 200_000


def best_us(fn, number=N) -> float:
    return min(timeit.repeat(fn, number=number, repeat=7)) / number * 1e6


def main() -> None:
    dev = torch.device("cuda")
    torch.zeros(1, device=dev)

    def nvtx():
        torch.cuda.nvtx.range_push("hanabi:step")
        torch.cuda.nvtx.range_pop()

    def span():
        with profile_span("hanabi:step"):
            pass

    def rf():
        with record_function("hanabi:step"):
            pass

    out = {
        "device": torch.cuda.get_device_name(dev),
        "torch": torch.__version__,
        "flag_us": best_us(_profiler_enabled),
        "nvtx_push_pop_us": best_us(nvtx),
        "off_span_us": best_us(span),
        "off_record_function_us": best_us(rf, N // 10),
        "empty_loop_us": best_us(lambda: None),
    }
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out["on_span_us"] = best_us(span, 20_000)
        out["on_empty_loop_us"] = best_us(lambda: None, 20_000)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
