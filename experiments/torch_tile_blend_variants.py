#!/usr/bin/env python3
"""Device time of variants of the PyTorch port's ``tile_blend`` kernel.

    python3 experiments/torch_tile_blend_variants.py [LABEL=PATH.cu[:FLAG,FLAG...] ...]

Needs one CUDA device and nvcc. Builds, each with the port's nvcc flags and
``common.cu``, one library per variant, all nvcc processes started
together, and prints each build's registers a thread and spills:

* ``port``: ``bevy_hanabi_tpu_torch/csrc/tile_blend.cu`` as the port builds
  it, and ``port,maxrreg40`` / ``port,maxrreg32`` with ``-maxrregcount``;
* ``port,compact``, ``port,inline`` and ``port,nocap``: copies of that
  source edited as :data:`PORT_EDITS` says (written under
  ``build/variants/``), the appearance kernel shading compacted pairs for
  every draw (the port: only for a draw with the squircle), for none, and
  with its per-lane path's 64-register cap lifted (tiles of up to 16x16
  only);
* ``first``: ``experiments/tile_blend_variants/first.cu``, the first
  version (every entry through the full test);
* ``redesign1``: ``redesign1.cu`` there, the first redesign (a pre-test
  before the two divisions, ballot culling per 8x4 warp block);
* ``pix1``, ``pix2``, ``pix4``: ``pix.cu`` there, the first redesign with
  every global load before the first barrier and 1, 2 or 4 pixels a thread;
* ``appear1``: ``appear1.cu`` there, the first appearance kernel (every
  covered pair shaded on its own lane, the quad bound for triangles,
  fmodf wraps);
* every extra source named on the command line (a ``tile_blend.cu`` with
  the same C entry points, built with the extra nvcc flags after the colon).

Then it holds every build against ``tile_blend_plain`` (max abs err 0,
depth planes equal; the squircle within 0.2% of the pixels) and times it
with ``chip_smoke.cuda_ms``, all builds in turn, twice, on real windows
built by ``chip_smoke.py``'s own functions. Quad windows, on every build:

* ``blend``: the headline's (1M ``gradient_effect`` particles stepped past
  their 5 s lifetime, 512x512, M = 64), as ``chip_smoke.py`` phase 3;
* ``blend, no entries``: the same with every ``has`` flag false, the
  launch's floor;
* ``scene`` and ``scene128``: the painter pass of the full mixed scene
  (917 504 lanes, warmed to steady state) at M = 64 and M = 128.

Appearance windows, on the builds with an appearance entry point (the
port's, ``appear1`` and the extra ones), as ``chip_smoke.py`` phase 15:

* ``mesh`` and ``mesh,lit``: the textured mesh frame (16 384 icospheres of
  80 triangles, the circle texture, 512x512, M = 64), unlit and lit, and
  ``mesh128`` the unlit one at M = 128;
* ``textured quads``: the textured billboard's last BLEND frame (256x256);
* ``flipbook`` and ``round``: ``example_circle``'s and ``example_2d``'s
  last frames (512x512).

Designs measured here and dropped are listed in ``PERF.md`` (Findings).
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
CSRC = ROOT / "bevy_hanabi_tpu_torch" / "csrc"
VARIANTS = ROOT / "experiments" / "tile_blend_variants"


# designs measured and dropped, as edits of the port's source: label ->
# [(text that occurs once in tile_blend.cu, its replacement)]
_COMPACT = "const bool compact = !kAA && ap.o_round >= 0 && threads <= 256;"
PORT_EDITS = {
    "port,compact": [(_COMPACT, "const bool compact = !kAA && threads <= 256;")],
    "port,inline": [(_COMPACT, "const bool compact = false;")],
    "port,nocap": [("__launch_bounds__(kCompact ? 256 : 1024, 1)", "__launch_bounds__(256, 1)")],
}


def edited_port(label: str) -> Path:
    """The port's ``tile_blend.cu`` with ``PORT_EDITS[label]`` applied,
    written under ``build/variants/``."""
    from bevy_hanabi_tpu_torch import cuda_build

    src = (CSRC / "tile_blend.cu").read_text()
    for old, new in PORT_EDITS[label]:
        if src.count(old) != 1:
            raise SystemExit(f"{label}: {old!r} does not occur once in tile_blend.cu")
        src = src.replace(old, new)
    path = cuda_build.BUILD_DIR / "variants" / f"tile_blend_{label.replace(',', '_')}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    return path


def variants(argv):
    """(label, source, extra nvcc flags) of every build."""
    port = CSRC / "tile_blend.cu"
    out = [("port", port, [])]
    out += [(f"port,maxrreg{r}", port, ["-maxrregcount", str(r)]) for r in (40, 32)]
    out += [(label, edited_port(label), []) for label in PORT_EDITS]
    out += [("first", VARIANTS / "first.cu", []), ("redesign1", VARIANTS / "redesign1.cu", [])]
    out += [(f"pix{k}", VARIANTS / "pix.cu", [f"-DHANABI_TILE_BLEND_PIX={k}"]) for k in (1, 2, 4)]
    out += [("appear1", VARIANTS / "appear1.cu", [])]
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
    for label, (lib, log) in cuda_build.build_variants(builds, "tile_blend").items():
        if lib is None:
            if label == "port":
                raise SystemExit(f"{label}: nvcc failed\n{log}")
            print(f"{label}: nvcc failed, left out\n{log}")
            continue
        regs = sorted({line.split("Used")[1].split(",")[0].strip()
                       for line in log.splitlines() if "Used" in line and "registers" in line})
        spills = sorted({line.strip() for line in log.splitlines() if "spill stores" in line})
        print(f"{label}: registers {regs}; {spills}")
        libs[label] = lib
    return libs


def pass_window(projected, nt: int, m: int):
    """A pass's ``tile_blend`` window from ``project_bin``'s outputs, as
    ``rasterize`` builds it on the ordered path, through the plain gather."""
    from bevy_hanabi_tpu_torch.ops import gather
    from bevy_hanabi_tpu_torch.render import raster

    tile, depth, rows, rng = projected
    return gather.gather_window_plain(rows, *raster.sort_tiles(tile, depth, nt, None, rng), m)


def headline_window(dev):
    import chip_smoke as cs
    from bevy_hanabi_tpu_torch.render import raster

    draw, cam, cfg = cs.headline_frame(dev)
    projected = raster.project_bin(*cs.project_args(draw, cam, cfg), row=raster.ROW_QUAD)
    window, has = pass_window(projected, cfg.num_tiles, cfg.max_entries_per_tile)
    return dict(window=window, has=has, T=cfg.tile_size, ntx=cfg.tiles_x, nty=cfg.tiles_y,
                background=cfg.background, mode="blend", kw={})


def painter_windows(dev):
    import chip_smoke as cs
    from bevy_hanabi_tpu_torch import RasterConfig
    from bevy_hanabi_tpu_torch.render import raster

    cam, cfg = cs.mixed_camera(), RasterConfig(512, 512, tile_slots=1)
    scene = cs.mixed_scene("cuda", 65536, 1 << 19, 65536, 262144)
    cs.warm_mixed(scene, cam, cfg)
    painter, extra = cs.painter_draw(scene, cs.scene_draws(scene, cam))
    projected = raster.project_bin(*cs.project_args(painter, cam, cfg), extra=extra, row=raster.ROW)
    fb0 = cs.painter_target(cfg, dev)
    out = {}
    for m, name in ((64, "scene"), (128, "scene128")):
        window, has = pass_window(projected, cfg.num_tiles, m)
        out[name] = dict(window=window, has=has, T=cfg.tile_size, ntx=cfg.tiles_x, nty=cfg.tiles_y,
                         background=cfg.background, mode="scene",
                         kw=dict(framebuffer=fb0, depth_test=True, write_depth=True))
    return out


def appearance_windows():
    """The appearance windows (module docstring), each with its draw's
    :class:`~bevy_hanabi_tpu_torch.render.raster.Appearance` and textures."""
    import chip_smoke as cs
    from bevy_hanabi_tpu_torch import RasterConfig
    from bevy_hanabi_tpu_torch.render import raster

    def entry(asset, pool, cam, cfg, texs, m=None):
        window, has, ap = cs.appearance_window(asset, pool, cam, cfg, texs, m)
        return dict(window=window, has=has, T=cfg.tile_size, ntx=cfg.tiles_x, nty=cfg.tiles_y,
                    background=cfg.background, mode="blend",
                    kw=dict(appearance=ap, textures=texs))

    out = {}
    for lit in (False, True):
        fx, pool, _, _, cam, cfg, texs = cs.warm_mesh(lit)
        out["mesh,lit" if lit else "mesh"] = entry(fx.asset, pool, cam, cfg, texs)
        if not lit:
            out["mesh128"] = entry(fx.asset, pool, cam, cfg, texs, cs.MIXED_M_WIDE)
    fx, pool, _, cam, cfg, textures = cs.textured_quad_run("billboard", "BLEND", "cuda")
    out["textured quads"] = entry(fx.asset, pool, cam, cfg,
                                  [raster.texture_tensor(t, "cuda") for t in textures])
    for name, label in (("example_circle", "flipbook"), ("example_2d", "round")):
        fx, pool, _, _, cam, textures = cs.example_run(name, "cuda")
        out[label] = entry(fx.asset, pool, cam, RasterConfig(width=512, height=512),
                           [raster.texture_tensor(t, "cuda") for t in textures])
    return out


def launcher(lib, w):
    """``tile_blend`` through ``lib``'s C entry point, as the port's wrapper
    calls it (``hanabi_tile_blend`` for the builds without appearance)."""
    import numpy as np
    import torch

    from bevy_hanabi_tpu_torch import cuda_build
    from bevy_hanabi_tpu_torch.render import raster

    if hasattr(lib, "hanabi_tile_blend_appearance"):
        return lambda: raster.tile_blend_launch(lib, w["window"], w["has"], w["T"], w["ntx"],
                                                w["background"], w["mode"], **w["kw"])
    window, has, T, ntx = w["window"], w["has"], w["T"], w["ntx"]
    nt, M = window.shape[:2]
    kw = w["kw"]
    bg = np.asarray(w["background"], np.float32)
    fb_in = kw.get("framebuffer")
    write = kw.get("write_depth", False)

    def run():
        fb = torch.empty((nt, T, T, 4), dtype=torch.float32, device=window.device)
        depth = (torch.empty((nt, T, T), dtype=torch.float32, device=window.device)
                 if write else None)
        code = lib.hanabi_tile_blend(
            window.data_ptr(), has.data_ptr(), None if fb_in is None else fb_in.data_ptr(), None,
            fb.data_ptr(), None if depth is None else depth.data_ptr(), nt, M, T, ntx,
            bg.ctypes.data_as(ctypes.c_void_p), raster.BLEND_MODES.index(w["mode"]),
            int(kw.get("depth_test", False)), int(write), cuda_build.current_stream())
        if code != 0:
            raise RuntimeError(f"launch failed: {code}")
        return (fb, depth) if write else fb

    return run


def matches(got, want, w) -> bool:
    """Equal to the plain version (the squircle: at most 0.2% of the pixels
    differ, as chip_smoke.py allows)."""
    import torch

    if isinstance(got, tuple):
        return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    ap = w["kw"].get("appearance")
    if ap is not None and ap.offset("roundness") >= 0:
        differ = int(((got - want).abs() > 0).any(-1).sum())
        return differ <= 0.002 * want[..., 0].numel()
    return torch.equal(got, want)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from bevy_hanabi_tpu_torch.render import raster

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    libs = build_all(variants(argv))
    dev = torch.device("cuda", 0)
    blend = headline_window(dev)
    # the floor: the same launch with no entry in any tile (loads, the
    # per-entry pass, the stores, no culling and no blend)
    windows = {"blend": blend, "blend, no entries": dict(blend, has=torch.zeros_like(blend["has"])),
               **painter_windows(dev), **appearance_windows()}
    for name, w in windows.items():
        appear = "appearance" in w["kw"]
        builds = {label: lib for label, lib in libs.items()
                  if not appear or hasattr(lib, "hanabi_tile_blend_appearance")}
        want = raster.tile_blend_plain(w["window"], w["has"], w["T"], w["ntx"], w["nty"],
                                       w["background"], w["mode"], **w["kw"])
        for label, lib in builds.items():
            if not matches(launcher(lib, w)(), want, w):
                print(f"{label} on {name}: differs from tile_blend_plain")
                return 1
        print(f"{name}: nt={w['window'].shape[0]} M={w['window'].shape[1]} "
              f"F={w['window'].shape[2]}, {int(w['has'].sum())} entries; every build equal to "
              f"the plain version")
        times = {label: [] for label in builds}
        for _ in range(2):
            for label, lib in builds.items():
                times[label].append(cs.cuda_ms(launcher(lib, w), 200))
        for label, t in times.items():
            print(f"  {name} {label}: ms {t}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
