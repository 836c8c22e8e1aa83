#!/usr/bin/env python3
"""Device time of variants of the PyTorch port's ``event_compact`` kernel.

    python3 experiments/torch_event_compact_variants.py [LABEL=PATH.cu[:FLAG,FLAG...] ...]

Needs one CUDA device and nvcc. Builds, each with the port's nvcc flags and
``common.cu``, one library per variant, all nvcc processes started
together, and prints each build's registers a thread and spills:

* ``port``: ``bevy_hanabi_tpu_torch/csrc/event_compact.cu`` (one
  cooperative launch, the payload staged in shared memory);
* ``first``: ``experiments/event_compact_variants/first.cu``, the first
  version (three launches);
* ``coop1``: ``coop1.cu`` there, the first one-launch version (each lane's
  slot, count and payload words stored at its own destination);
* ``segmented1``: ``segmented1.cu`` there, the source before the
  segmented kernel's redesign (one CTA a segment; its one-array kernel is
  the port's);
* ``probe1`` .. ``probe4``: ``probe.cu`` there, the design's floors at the
  firework's grid: an empty kernel launched as usual, an empty cooperative
  launch, a cooperative launch with one ``grid.sync()``, and that with a
  load before and a scratch read after the barrier;
* every extra source named on the command line (an ``event_compact.cu``
  with the same C entry point, built with the extra nvcc flags after the
  colon).

Then it holds every build but the probes against ``event_compact_plain``
(every output equal) and times it with ``chip_smoke.cuda_ms``, all builds in turn,
twice, on lanes made from a seed: the firework's rocket pool (n = 65 536,
2 048 active lanes, count 4, W = 3 words of position), the same with
W = 13 and with every lane active, and n = 1 500 000 and 4 194 304 with
a fifth of the lanes active.

Then ``event_compact_segmented`` of ``port`` and ``segmented1`` (and of
every extra source, taken to have the port's C entry point, with its
scratch), held against ``event_compact_segmented_plain`` and timed the same
way at [I, N, W] = 64 x 1024 x 8, 256 x 4096 x 8, 4 x 65 536 x 8 (the
instanced firework's active share, ~1%), 3000 x 700 x 8, 4096 x 1024 x 8
and 1 x 4M x 3 (a fifth active).
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
CSRC = ROOT / "bevy_hanabi_tpu_torch" / "csrc"
VARIANTS = ROOT / "experiments" / "event_compact_variants"


def variants(argv):
    """(label, source, extra nvcc flags) of every build."""
    out = [("port", CSRC / "event_compact.cu", []), ("first", VARIANTS / "first.cu", []),
           ("coop1", VARIANTS / "coop1.cu", []), ("segmented1", VARIANTS / "segmented1.cu", [])]
    out += [(f"probe{k}", VARIANTS / "probe.cu", [f"-DHANABI_PROBE={k}"]) for k in range(1, 5)]
    for arg in argv:
        label, spec = arg.split("=", 1)
        path, _, flags = spec.partition(":")
        out.append((label, Path(path), [f for f in flags.split(",") if f]))
    return out


def build_all(builds):
    """The loaded libraries by label (``cuda_build.build_variants``). A
    variant that does not compile is reported and left out; the port's own
    source must compile."""
    from bevy_hanabi_tpu_torch import cuda_build

    libs = {}
    for label, (lib, log) in cuda_build.build_variants(builds, "event_compact").items():
        if lib is None:
            if label == "port":
                raise SystemExit(f"{label}: nvcc failed\n{log}")
            print(f"{label}: nvcc failed, left out\n{log}")
            continue
        regs = sorted({line.split("Used")[1].strip()
                       for line in log.splitlines() if "Used" in line and "registers" in line})
        spills = sorted({line.strip() for line in log.splitlines() if "spill stores" in line})
        print(f"{label}: {regs}; {spills}")
        libs[label] = lib
    return libs


def lanes(n, W, active, seed, dev):
    """(mask, count, payload) of n lanes, ``active`` of them active."""
    import numpy as np
    import torch

    r = np.random.default_rng(seed)
    mask = np.zeros(n, bool)
    mask[r.choice(n, active, replace=False)] = True
    count = np.full(n, 4, np.int64)
    payload = r.integers(-(2**31), 2**31, (n, W)).astype(np.int32)
    return tuple(torch.from_numpy(a).to(dev) for a in (mask, count, payload))


def launcher(lib, mask, count, payload):
    """``event_compact`` through ``lib``'s C entry point, as the port's wrapper calls it."""
    import torch

    from bevy_hanabi_tpu_torch import cuda_build

    n, W = payload.shape
    dev = mask.device

    def run():
        slot = torch.empty((n,), dtype=torch.int64, device=dev)
        counts = torch.empty((n,), dtype=torch.int64, device=dev)
        num = torch.empty((), dtype=torch.int32, device=dev)
        words = torch.empty((n, W), dtype=torch.int32, device=dev)
        scratch = torch.empty((max(1, -(-n // 512)),), dtype=torch.int32, device=dev)
        code = lib.hanabi_event_compact(
            mask.data_ptr(), count.data_ptr(), payload.data_ptr(), slot.data_ptr(),
            counts.data_ptr(), words.data_ptr(), num.data_ptr(), scratch.data_ptr(), n, W,
            cuda_build.current_stream())
        if code != 0:
            raise RuntimeError(f"launch failed: {code}")
        return slot, counts, num, words

    return run


def segmented_lanes(i, n, W, share, seed, dev):
    """(mask, count, payload) of [I, N] lanes, each active with ``share``."""
    import numpy as np
    import torch

    r = np.random.default_rng(seed)
    mask = r.random((i, n)) < share
    count = r.integers(1, 5, (i, n))
    payload = r.integers(-(2**31), 2**31, (i, n, W)).astype(np.int32)
    return tuple(torch.from_numpy(a).to(dev) for a in (mask, count, payload))


def segmented_launcher(lib, mask, count, payload):
    """``event_compact_segmented`` through ``lib``'s C entry point with the
    port's arguments (its scratch an int2 a 512-lane chunk)."""
    import torch

    from bevy_hanabi_tpu_torch import cuda_build

    i, n, W = payload.shape
    dev = mask.device

    def run():
        slot = torch.empty((i, n), dtype=torch.int64, device=dev)
        counts = torch.empty((i, n), dtype=torch.int64, device=dev)
        num = torch.empty((i,), dtype=torch.int32, device=dev)
        words = torch.empty((i, n, W), dtype=torch.int32, device=dev)
        pairs = torch.empty((max(1, i * max(1, -(-n // 512))), 2), dtype=torch.int32, device=dev)
        code = lib.hanabi_event_compact_segmented(
            mask.data_ptr(), count.data_ptr(), payload.data_ptr(), slot.data_ptr(),
            counts.data_ptr(), words.data_ptr(), num.data_ptr(), pairs.data_ptr(), i, n, W,
            cuda_build.current_stream())
        if code != 0:
            raise RuntimeError(f"launch failed: {code}")
        return slot, counts, num, words

    return run


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from bevy_hanabi_tpu_torch.runtime import events

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    libs = build_all(variants(argv))
    dev = torch.device("cuda", 0)
    cases = {
        "firework (n=65536, W=3, 2048 active)": (65536, 3, 2048),
        "n=65536, W=13, 2048 active": (65536, 13, 2048),
        "n=65536, W=3, all active": (65536, 3, 65536),
        "n=1500000, W=3, a fifth active": (1_500_000, 3, 300_000),
        "n=4194304, W=3, a fifth active": (4_194_304, 3, 838_861),
    }
    for name, (n, W, active) in cases.items():
        inputs = lanes(n, W, active, n + W, dev)
        want = events.event_compact_plain(*inputs)
        for label, lib in libs.items():
            if label.startswith("probe"):
                continue
            got = launcher(lib, *inputs)()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                print(f"{label} on {name}: differs from event_compact_plain")
                return 1
        print(f"{name}: every build equal to the plain version")
        timed = {label: lib for label, lib in libs.items() if n == 65536 or not label.startswith("probe")}
        times = {label: [] for label in timed}
        for _ in range(2):
            for label, lib in timed.items():
                times[label].append(cs.cuda_ms(launcher(lib, *inputs), 200))
        for label, t in times.items():
            print(f"  {name} {label}: ms {t}")
    segmented = {
        "64 x 1024 x 8": (64, 1024, 8, 0.0095),
        "256 x 4096 x 8": (256, 4096, 8, 0.0095),
        "4 x 65536 x 8": (4, 65536, 8, 0.0095),
        "3000 x 700 x 8": (3000, 700, 8, 0.2),
        "4096 x 1024 x 8": (4096, 1024, 8, 0.2),
        "1 x 4194304 x 3": (1, 4_194_304, 3, 0.2),
    }
    timed = {label: lib for label, lib in libs.items()
             if label not in ("first", "coop1") and not label.startswith("probe")}
    for name, (i, n, W, share) in segmented.items():
        inputs = segmented_lanes(i, n, W, share, i + n + W, dev)
        want = events.event_compact_segmented_plain(*inputs)
        runs = {label: (cs.segmented1_launcher if label == "segmented1" else segmented_launcher)(
            lib, *inputs) for label, lib in timed.items()}
        for label, run in runs.items():
            if not all(torch.equal(a, b) for a, b in zip(run(), want)):
                print(f"{label} on segmented {name}: differs from event_compact_segmented_plain")
                return 1
        print(f"segmented {name}: every build equal to the plain version")
        times = {label: [] for label in runs}
        for _ in range(2):
            for label, run in runs.items():
                times[label].append(cs.cuda_ms(run, 200))
        for label, t in times.items():
            print(f"  segmented {name} {label}: ms {t}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
