#!/usr/bin/env python3
"""Device time of variants of the PyTorch port's ``ribbon_segments`` kernel.

    python3 experiments/torch_ribbon_segments_variants.py [LABEL=PATH.cu[:FLAG,FLAG...] ...]

Needs one CUDA device and nvcc. Builds, each with the port's nvcc flags and
``common.cu``, one library per variant, all nvcc processes started
together, and prints each build's registers a thread and spills:

* ``port``: ``bevy_hanabi_tpu_torch/csrc/ribbon.cu`` (a warp a tile of 128
  rows in order, one gather chain a row, predecessors by shuffle, 16-byte
  loads of perm2, the key and colour, the outputs staged in shared memory
  and written as 16-byte stores, evict-first hints on the streamed rows);
* ``first``: ``experiments/ribbon_segments_variants/first.cu``, the first
  version (one thread a row, scalar loads and stores);
* ``first,stcs``: ``probe.cu`` there with ``HANABI_PROBE=2``, the first
  version with its stores evict-first;
* ``copy``: ``probe.cu`` with ``HANABI_PROBE=1``, a streaming copy of the
  bytes the call moves (a floor; its results are not compared);
* ``tiled.cu`` there, the port's kernel with knobs (all off, it is the
  port's): ``g16`` (the position and
  axis_y rows read as 16-byte vectors), ``evl`` (every gathered load with
  an L2 evict-last policy), ``pf64`` / ``pf128`` / ``pf256`` (every gathered
  load fetching 64, 128 or 256 bytes into L2), ``minb8`` (8 CTAs an SM, at
  most 64 registers a thread), and the combinations ``g16,evl`` and
  ``pf128,minb8``; and the probe ``l2res`` (every source row folded into
  65 536 rows: the same gathers from tables that stay in L2; not compared);
* ``bucketed`` and ``bucketed,persistent``: ``bucketed.cu`` there, a CTA a
  tile of 1024 rows ordered by perm2 bucket (a counting sort in shared
  memory) so that a warp instruction gathers the same-age rows of
  neighbouring ribbons, one CTA a tile or a persistent grid;
* every extra source named on the command line (a source with the same C
  entry point, built with the extra nvcc flags after the colon).

Then it holds every build but the probes against ``ribbon_segments_plain``
(every output bit-equal; a build that differs is reported, left out and
fails the run) and times it with ``chip_smoke.cuda_ms``, all
builds in turn, twice, on the ribbon frame's draw
(``chip_smoke.warm_ribbons``: ``ribbon_bench_effect(1 << 20, 4096)`` past
its 4 s lifetime, sorted by ``ribbon_sort``):

* ``frame``: the call as the ribbon frame makes it;
* ``frame, cutoff``: the same with a mask cutoff column (from a seed);
* ``coalesced``: ``perm1`` None and ``perm2`` the identity, every read in
  order: the floor of each design without the scatter;
* ``frame, 1 wave`` and ``frame, 2 waves``: the frame's first 405 504 and
  811 008 sorted rows (one and two waves of the port's grid: 132 SMs, 6
  CTAs of 512 rows each), to show what the frame's 2.59 waves cost.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
CSRC = ROOT / "bevy_hanabi_tpu_torch" / "csrc"
VARIANTS = ROOT / "experiments" / "ribbon_segments_variants"
PROBES = ("copy", "l2res")  # builds whose results are not segments


def variants(argv):
    """(label, source, extra nvcc flags) of every build."""
    out = [("port", CSRC / "ribbon.cu", []), ("first", VARIANTS / "first.cu", []),
           ("first,stcs", VARIANTS / "probe.cu", ["-DHANABI_PROBE=2"]),
           ("copy", VARIANTS / "probe.cu", ["-DHANABI_PROBE=1"]),
           ("bucketed", VARIANTS / "bucketed.cu", []),
           ("bucketed,persistent", VARIANTS / "bucketed.cu", ["-DHANABI_PERSISTENT=1"])]
    knobs = {"g16": ["-DHANABI_GATHER16=1"], "evl": ["-DHANABI_EVICT_LAST=1"],
             "pf64": ["-DHANABI_PREFETCH=64"], "pf128": ["-DHANABI_PREFETCH=128"],
             "pf256": ["-DHANABI_PREFETCH=256"], "minb8": ["-DHANABI_MIN_BLOCKS=8"],
             "l2res": ["-DHANABI_WINDOW=65536"]}
    for combo in ("g16", "evl", "g16,evl", "pf64", "pf128", "pf256", "minb8", "pf128,minb8",
                  "l2res"):
        flags = [f for knob in combo.split(",") for f in knobs[knob]]
        out.append((combo, VARIANTS / "tiled.cu", flags))
    for arg in argv:
        label, spec = arg.split("=", 1)
        path, _, flags = spec.partition(":")
        out.append((label, Path(path), [f for f in flags.split(",") if f]))
    return out


def build_all(builds):
    """The loaded libraries by label. A variant that does not compile is
    reported and left out; the port's own source must compile."""
    from bevy_hanabi_tpu_torch import cuda_build

    libs = {}
    for label, (lib, log) in cuda_build.build_variants(builds, "ribbon_segments").items():
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


def cases(dev):
    """(name, ribbon_segments arguments) of every timed call."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from bevy_hanabi_tpu_torch import RasterConfig
    from bevy_hanabi_tpu_torch.render.extract import extract_draw_data
    from bevy_hanabi_tpu_torch.render.ribbon import ribbon_sort

    cam = cs.ribbon_camera()
    fx, pool, _, _ = cs.warm_ribbons(RasterConfig(width=512, height=512, tile_slots=1))
    draw = extract_draw_data(fx.asset, pool, cam)
    order = ribbon_sort(draw)
    n = draw.alive.shape[0]
    cutoff = torch.from_numpy(np.random.default_rng(0).random(n, dtype=np.float32)).to(dev)
    # fresh tensors: 16-byte aligned, as the vector loads of g16 need
    geometry = tuple(t.contiguous().clone() for t in (draw.position, draw.axis_y, draw.color))
    tail = (order.key, cam.position)
    print(f"ribbon frame: {n} rows, {int(pool.alive_count())} alive")
    wave = torch.cuda.get_device_properties(dev).multi_processor_count * 6 * 512
    out = {
        "frame": (*geometry, None, order.perm1, order.perm2, *tail),
        "frame, cutoff": (*geometry, cutoff, order.perm1, order.perm2, *tail),
        "coalesced": (*geometry, None, None, torch.arange(n, device=dev), *tail),
    }
    for k in (1, 2):
        rows = k * wave
        out[f"frame, {k} wave{'s' if k > 1 else ''}"] = (
            *geometry, None, order.perm1, order.perm2[:rows], order.key[:rows], cam.position)
    return out


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from bevy_hanabi_tpu_torch.render import ribbon

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    libs = build_all(variants(argv))
    dev = torch.device("cuda", 0)
    failed = False
    for name, args in cases(dev).items():
        want = ribbon.ribbon_segments_plain(*args)
        runs = {label: cs.segments_launcher(lib, *args) for label, lib in libs.items()}
        for label in [label for label in runs if label not in PROBES]:
            got = runs[label]()
            if not all(torch.equal(a, b) for a, b in zip(got, want) if a is not None):
                print(f"{label} on {name}: differs from ribbon_segments_plain, left out")
                del runs[label]
                failed = True
        # the tables (position, axis_y, colour, cutoff, perm1) count the rows gathered
        rows, table_rows = args[5].shape[0], args[0].shape[0]
        moved = cs.nbytes(*args[:5]) * rows // table_rows + cs.nbytes(*args[5:7], *want)
        print(f"{name}: the builds above equal to the plain version; bound "
              f"{cs.bound(moved)['bound_ms']:.4f} ms ({moved} bytes)")
        times = {label: [] for label in runs}
        for _ in range(2):
            for label, run in runs.items():
                times[label].append(cs.cuda_ms(run, 100))
        for label, t in times.items():
            print(f"  {name} {label}: ms {t}")
    return int(failed)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
