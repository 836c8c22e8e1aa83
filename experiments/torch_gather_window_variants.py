#!/usr/bin/env python3
"""Device time of variants of the PyTorch port's ``gather_window`` kernel.

    python3 experiments/torch_gather_window_variants.py [LABEL ...]

Needs one CUDA device and nvcc. Builds the variants named (all by default),
each with the port's nvcc flags and ``common.cu``, one library per variant,
all nvcc processes started together, and prints each build's registers a
thread and spills:

* ``port``: ``bevy_hanabi_tpu_torch/csrc/gather_rows.cu`` as the port builds
  it (4 consecutive floats a lane stored from registers in one 16-byte
  store, 1, 2 or 4 groups a thread chosen at launch, the longest runs a CTA
  at that batch, slot and column by the hardware's division, F = 10 fixed
  at compile time);
* ``port1``, ``port2``, ``port4``, ``port,generic``, ``port,widths``,
  ``port,div32`` and ``port,share``: copies of that source edited as
  :data:`PORT_EDITS` says (written under ``build/variants/``): the batch
  fixed at 1, 2 or 4 groups a thread; no width fixed at compile time; F =
  10, 11, 13, 17 and 26 fixed; 32-bit divisions in the staging pass; each
  CTA an equal share of one wave of resident CTAs instead of the longest
  runs;
* ``direct``: ``experiments/gather_window_variants/direct.cu``, the same
  sweep with slot and column divided by a multiply-high with the host's
  reciprocal; ``lane8`` the same source with one float a lane,
  lane-contiguous loads and 4-byte stores, 8 floats a thread;
* ``staged``: ``staged.cu`` there, lane-contiguous loads of 4, 8 or 16
  floats a thread written to shared memory, stored after a barrier in
  16-byte stores;
* ``first``: ``first.cu`` there, the kernel the port's replaced (one thread a slot, the
  tile's floats staged in 48 KB; it refuses M * F > 12 288, and is left out
  of those windows).

Then it holds every build against ``gather_window_plain`` (window and
``has`` bit for bit) and times it with ``chip_smoke.cuda_ms``, all builds in
turn, twice, on real windows built by ``chip_smoke.py``'s own functions:

* ``headline``: the headline's (1M ``gradient_effect`` particles stepped
  past their 5 s lifetime, 512x512, M = 64, 10-float rows), and
  ``headline,13`` the same draw's 13-float rows (the mask / scene width),
  also at M = 128 (the mixed scene's third timing);
* ``hifi``, ``slots2`` and ``exact``: the same draw at the companions'
  binnings (2M / 2M / 4M entry ids read as ``entry mod N``);
* ``mesh`` and ``mesh,lit``: the textured mesh frame (16 384 icospheres of
  80 triangles, 512x512, M = 64; 17 and 26-float rows), ``mesh,M=128`` and
  ``mesh,lit,M=512`` (past the first kernel's cap);
* ``flipbook``: ``example_circle``'s last frame (11-float rows).
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
CSRC = ROOT / "bevy_hanabi_tpu_torch" / "csrc"
VARIANTS = ROOT / "experiments" / "gather_window_variants"

_WIDTHS = (10, 11, 13, 17, 26)
# edits of the port's source: label -> [(text that occurs once in it, its replacement)]
_BATCH_RULE = ("  int batch = 1;\n  while (batch < kMaxBatch && (n_slots - 1) / window_chunk(F, batch)"
               " + 1 > resident) batch *= 2;\n")
PORT_EDITS = {
    # the batch fixed at 1, 2 or 4 groups a thread
    **{f"port{k}": [(_BATCH_RULE, f"  int batch = {k};\n")] for k in (1, 2, 4)},
    "port,generic": [("empty\n  const int F = kF > 0 ? kF : F_rt;\n",
                      "empty\n  const int F = F_rt;\n")],
    "port,widths": [
        (f"    if (F == 10) HANABI_WINDOW({k}, 10);\n",
         "".join(f"    {'if' if i == 0 else 'else if'} (F == {f}) HANABI_WINDOW({k}, {f});\n"
                 for i, f in enumerate(_WIDTHS)))
        for k in (1, 2, 4)
    ],
    # 32-bit divisions in the staging pass where the values fit (the CTA's
    # first tile, entry mod N)
    "port,div32": [
        ("  const long long t0 = g0 / M;\n",
         "  const long long t0 = g0 <= 0xffffffffll ? (unsigned)g0 / (unsigned)M : g0 / M;\n"),
        ("    const long long r = e % n_rows;\n",
         "    const long long r = e >= 0 && e <= 0xffffffffll ? (long long)((unsigned)e % (unsigned)n_rows)\n"
         "                                                   : e % n_rows;\n"),
    ],
    # each CTA an equal share of one wave of resident CTAs
    "port,share": [(
        "  const int chunk = window_chunk(F, batch);\n",
        "  const int chunk = std::min<long long>(window_chunk(F, batch),\n"
        "                                        ((n_slots + resident - 1) / resident + 3) & ~3ll);\n",
    )],
}


def edited(label: str) -> Path:
    """The port's ``gather_rows.cu`` with ``PORT_EDITS[label]`` made,
    written under ``build/variants/``."""
    from bevy_hanabi_tpu_torch import cuda_build

    src = (CSRC / "gather_rows.cu").read_text()
    for old, new in PORT_EDITS[label]:
        if src.count(old) != 1:
            raise SystemExit(f"{label}: {old!r} does not occur once in gather_rows.cu")
        src = src.replace(old, new)
    out = cuda_build.BUILD_DIR / "variants" / f"gather_window_{label.replace(',', '_')}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(src)
    return out


def variants(labels=()):
    """(label, source, extra nvcc flags) of every build named in
    ``labels`` (all when empty)."""
    port, direct = CSRC / "gather_rows.cu", VARIANTS / "direct.cu"
    out = [
        ("port", port, []),
        *((label, edited(label), []) for label in PORT_EDITS),
        ("direct", direct, []),
        ("lane8", direct, ["-DHANABI_WINDOW_VEC=1", "-DHANABI_WINDOW_BATCH=8"]),
        ("staged", VARIANTS / "staged.cu", []),
        ("first", VARIANTS / "first.cu", []),
    ]
    return [v for v in out if not labels or v[0] in labels]


def build_all(builds):
    """The loaded libraries by label; every build must compile."""
    from bevy_hanabi_tpu_torch import cuda_build

    libs = {}
    for label, (lib, log) in cuda_build.build_variants(builds, "gather_window").items():
        if lib is None:
            raise SystemExit(f"{label}: nvcc failed\n{log}")
        lines = [line.strip() for line in log.splitlines()
                 if "gather_window" in line or "Used" in line or "spill" in line]
        print(f"{label}:\n  " + "\n  ".join(lines))
        libs[label] = lib
    return libs


def launcher(label, lib, args):
    """``gather_window`` through a build's C entry point, as the port's
    wrapper calls it (``first`` through ``chip_smoke.first_window_launcher``;
    None where it refuses the window)."""
    import torch

    import chip_smoke as cs
    from bevy_hanabi_tpu_torch import cuda_build

    if label == "first":
        return cs.first_window_launcher(lib, *args)
    rows, pidx, starts, ends, m, from_start = args
    nt, width = starts.shape[0], rows.shape[1]

    def run():
        window = torch.empty((nt, m, width), dtype=torch.float32, device=rows.device)
        has = torch.empty((nt, m), dtype=torch.bool, device=rows.device)
        code = lib.hanabi_gather_window(
            rows.data_ptr(), pidx.data_ptr(), starts.data_ptr(), ends.data_ptr(),
            window.data_ptr(), has.data_ptr(), nt, pidx.shape[0], rows.shape[0], m, width,
            int(from_start), int(pidx.dtype == torch.int64), cuda_build.current_stream())
        cuda_build.check(code, f"gather_window ({label})")
        return window, has

    return run


def window_args(draw, cam, config, row, m=None, appearance=None):
    """``gather_window``'s arguments for a draw's ordered BLEND pass, as
    ``rasterize`` builds them."""
    import chip_smoke as cs
    from bevy_hanabi_tpu_torch.render import raster

    kw = {} if appearance is None else {"appearance": appearance}
    tile, depth, rows, rng = raster.project_bin(
        *cs.project_args(draw, cam, config), row=row, tile_slots=config.tile_slots,
        tile_span=config.tile_span, **kw)
    pidx, starts, ends = raster.sort_tiles(tile, depth, config.num_tiles, None, rng)
    return rows, pidx, starts, ends, m or config.max_entries_per_tile, False


def windows(dev):
    """The windows of the module docstring, by name."""
    import torch

    import chip_smoke as cs
    from bevy_hanabi_tpu_torch import RasterConfig
    from bevy_hanabi_tpu_torch.render import raster
    from bevy_hanabi_tpu_torch.render.extract import extract_draw_data
    from bevy_hanabi_tpu_torch.render.mesh import expand_mesh_draw

    out = {}
    draw, cam, cfg = cs.headline_frame(dev)
    out["headline"] = window_args(draw, cam, cfg, raster.ROW_QUAD)
    out["headline,13"] = window_args(draw, cam, cfg, raster.ROW)
    out["headline,13,M=128"] = out["headline,13"][:4] + (128, False)
    for name, binning in cs.COMPANIONS.items():
        out[name] = window_args(draw, cam, RasterConfig(512, 512, **binning), raster.ROW_QUAD)
    del draw
    for lit in (False, True):
        fx, pool, _, _, cam, cfg, texs = cs.warm_mesh(lit)
        draw = extract_draw_data(fx.asset, pool, cam, textures=texs)
        draw = expand_mesh_draw(draw, fx.asset.mesh)
        _, columns = raster.draw_appearance(draw, raster.ROW_QUAD)
        tag = "mesh,lit" if lit else "mesh"
        out[tag] = window_args(draw, cam, cfg, raster.ROW_QUAD, appearance=columns)
        m = cs.MESH_M_WIDE if lit else cs.MIXED_M_WIDE
        out[f"{tag},M={m}"] = out[tag][:4] + (m, False)
    fx, pool, _, _, cam, textures = cs.example_run("example_circle", "cuda")
    texs = [raster.texture_tensor(t, "cuda") for t in textures]
    draw = extract_draw_data(fx.asset, pool, cam, textures=texs)
    _, columns = raster.draw_appearance(draw, raster.ROW_QUAD)
    out["flipbook"] = window_args(draw, cam, RasterConfig(512, 512), raster.ROW_QUAD,
                                  appearance=columns)
    torch.cuda.synchronize()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from bevy_hanabi_tpu_torch.ops import gather

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    libs = build_all(variants(sys.argv[1:]))
    for name, args in windows(torch.device("cuda", 0)).items():
        rows, pidx, _, _, m, _ = args
        want_w, want_has = gather.gather_window_plain(*args)
        runs = {label: launcher(label, lib, args) for label, lib in libs.items()}
        runs = {label: run for label, run in runs.items() if run is not None}
        for label, run in runs.items():
            window, has = run()
            torch.cuda.synchronize()
            if not (torch.equal(has, want_has)
                    and torch.equal(window.view(torch.int32), want_w.view(torch.int32))):
                print(f"{label} on {name}: differs from gather_window_plain")
                return 1
        print(f"{name}: nt={want_has.shape[0]} M={m} F={rows.shape[1]}, "
              f"{int(want_has.sum())} filled, {pidx.shape[0]} {pidx.dtype} ids; every build "
              f"equal to the plain version")
        times = {label: [] for label in runs}
        for _ in range(2):
            for label, run in runs.items():
                times[label].append(cs.cuda_ms(run, 200))
        for label, t in times.items():
            print(f"  {name} {label}: ms {t}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
