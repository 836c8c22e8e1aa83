#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``bevy_hanabi_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``bevy_hanabi_tpu_torch/csrc`` and runs
the benchmark-headline frame through the port's public entry points. It
never imports JAX. Phases, each of which fails the run on any error:

1. a CUDA device must be present; print its name and power limit;
2. build the kernel library (nvcc, plain C interface, ctypes);
3. compare each kernel with its plain PyTorch version on the card, on a
   real 1M-particle headline frame, and time both;
4. an 8192-particle gradient frame at 128x128 through the kernels on the
   card against the plain versions on the CPU (checksums within 0.5%);
5. the headline: ``gradient_effect(1 << 20)`` warmed past its 5 s
   lifetime, then timed ``step_render_chunk`` chunks of K = 120 frames at
   512x512, ``tile_slots=1``; every kernel's launch counter must move, and
   the last frame is rendered again on the CPU through the plain versions
   (checksums within 0.5%).

Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
when no CUDA device is available or any phase fails.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

K = 120  # frames per chunk, as the JAX package's benchmark
DT = 1.0 / 60.0
CAPACITY = 1 << 20
CHECKSUM_REL = 0.005  # bench.py:155-161: f32 blend arithmetic, 5x margin
PROJECT_MISMATCH_MAX = 1e-4  # share of particles whose tile or depth may differ
ROWS_ATOL = 1e-3  # pixels; both versions round op for op, so expect 0
BLEND_ATOL = 1e-5


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def checksum_close(a: float, b: float) -> bool:
    return abs(a - b) <= CHECKSUM_REL * max(abs(b), 1.0)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` launches (CUDA events).

    The device first sleeps long enough for the host to enqueue all
    ``reps`` calls, so the events time the device and not the host's
    launch overhead (which dominates kernels of a few microseconds)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0, 2.0 * reps * host_s + 1e-3) * 2e9))  # cycles, ~2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def headline_camera():
    from bevy_hanabi_tpu_torch.render.camera import CameraParams, look_at, perspective

    return CameraParams(
        view=look_at([0.0, 0.0, 26.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
        proj=perspective(math.radians(60.0), 1.0, 0.1, 200.0),
        viewport=(512, 512),
    )


def chunk_inputs(fx, spawner, frame: int, k: int = K):
    from bevy_hanabi_tpu_torch import SimParams, StepInputs

    inputs, sims = [], []
    for j in range(k):
        inputs.append(StepInputs.make(spawner.tick(DT), frame + j))
        sims.append(SimParams(time=(frame + j) * DT, delta_time=DT))
    return fx.stack_frames(inputs, sims)


def compare_kernels(dev):
    """Phase 3: each kernel against its plain version on a real frame."""
    import numpy as np
    import torch

    from bevy_hanabi_tpu_torch import CompiledEffect, EffectSpawner, RasterConfig
    from bevy_hanabi_tpu_torch.models import gradient_effect
    from bevy_hanabi_tpu_torch.render import raster
    from bevy_hanabi_tpu_torch.render.extract import extract_draw_data

    asset = gradient_effect(CAPACITY)
    fx = CompiledEffect(asset, device=dev)
    pool = fx.create_pool()
    spawner = EffectSpawner(asset.spawner, rng=np.random.default_rng(1))
    frame = 0
    for _ in range(int(5.5 / DT) // K + 1):  # past the 5 s lifetime: steady churn
        pool = fx.step_chunk(pool, *chunk_inputs(fx, spawner, frame))
        frame += K
    cam = headline_camera()
    cfg = RasterConfig(512, 512, tile_slots=1)
    T, ntx, nty, nt = cfg.tile_size, cfg.tiles_x, cfg.tiles_y, cfg.num_tiles
    M = cfg.max_entries_per_tile
    draw = extract_draw_data(asset, pool, cam)
    color = draw.color.contiguous()
    pb_args = (draw.position, draw.axis_x, draw.axis_y, draw.alive, color,
               cam.view, cam.proj, cam.viewport, T, ntx, nty)
    results = {}

    tile_k, depth_k, rows_k = raster.project_bin(*pb_args)
    tile_p, depth_p, rows_p = raster.project_bin_plain(*pb_args)
    torch.cuda.synchronize()
    bad = int(((tile_k != tile_p) | (depth_k != depth_p)).sum())
    rows_err = float((rows_k - rows_p).abs().nan_to_num(0.0).max())
    n = draw.alive.shape[0]
    valid = int((tile_p < nt).sum())
    print(f"project_bin: {n} particles, {valid} binned on screen, "
          f"{bad} tile/depth mismatches, rows max abs err {rows_err:g}")
    if bad > PROJECT_MISMATCH_MAX * n:
        fail(f"project_bin: {bad} of {n} tiles/depths differ from the plain version")
    if not torch.equal(rows_k.isnan(), rows_p.isnan()) or not rows_err <= ROWS_ATOL:
        fail(f"project_bin: rows differ from the plain version (max abs err {rows_err:g})")
    results["project_bin"] = {
        "max_abs_err": rows_err,
        "ms": cuda_ms(lambda: raster.project_bin(*pb_args), 50),
        "plain_ms": cuda_ms(lambda: raster.project_bin_plain(*pb_args), 10),
    }

    pidx_sorted, starts, ends = raster.sort_tiles(tile_p, depth_p, nt)
    pidx, has = raster.window_index(pidx_sorted, starts, ends, M)
    idx = pidx.reshape(-1)
    win_k = raster.gather_rows(rows_p, idx)
    win_p = raster.gather_rows_plain(rows_p, idx)
    torch.cuda.synchronize()
    if not torch.equal(win_k, win_p):
        fail("gather_rows: differs from table.index_select(0, idx)")
    print(f"gather_rows: [{n}, {raster.ROW}] x {idx.shape[0]} rows, bit-exact")
    results["gather_rows"] = {
        "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: raster.gather_rows(rows_p, idx), 100),
        "plain_ms": cuda_ms(lambda: raster.gather_rows_plain(rows_p, idx), 100),
    }

    window = win_p.reshape(nt, M, raster.ROW)
    fb_k = raster.tile_blend(window, has, T, ntx, nty, cfg.background)
    fb_p = raster.tile_blend_plain(window, has, T, ntx, nty, cfg.background)
    torch.cuda.synchronize()
    blend_err = float((fb_k - fb_p).abs().max())
    print(f"tile_blend: nt={nt} M={M} ({int(has.sum())} entries), max abs err {blend_err:g}")
    if not (blend_err <= BLEND_ATOL):
        fail(f"tile_blend: max abs err {blend_err:g} > {BLEND_ATOL:g}")
    results["tile_blend"] = {
        "max_abs_err": blend_err,
        "ms": cuda_ms(lambda: raster.tile_blend(window, has, T, ntx, nty, cfg.background), 50),
        "plain_ms": cuda_ms(
            lambda: raster.tile_blend_plain(window, has, T, ntx, nty, cfg.background), 5
        ),
    }
    for name, r in results.items():
        print(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")
    return results


def small_frame(device):
    """The 8192-particle gradient frame at 128x128 on ``device``: three
    frames of spawns [4096, 1024, 2048] at dt = 2 s (the third reaps)."""
    from bevy_hanabi_tpu_torch import CompiledEffect, RasterConfig, SimParams, StepInputs
    from bevy_hanabi_tpu_torch.models import gradient_effect
    from bevy_hanabi_tpu_torch.render.camera import CameraParams, look_at, perspective

    fx = CompiledEffect(gradient_effect(8192), device=device)
    ins = [StepInputs.make(s, 7 + 31 * i) for i, s in enumerate([4096, 1024, 2048])]
    sims = [SimParams(time=2.0 * i, delta_time=2.0) for i in range(3)]
    cam = CameraParams(look_at((0, 0, 6), (0, 0, 0)), perspective(0.9, 1.0, 0.1, 100.0), (128, 128))
    pool, img, sums = fx.step_render_chunk(
        fx.create_pool(), *fx.stack_frames(ins, sims), cam, RasterConfig(128, 128, tile_slots=1)
    )
    return pool, img, sums


def main() -> int:
    import torch

    # Phase 1: the card.
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import numpy as np

    from bevy_hanabi_tpu_torch import (
        CompiledEffect,
        EffectSpawner,
        ParticlePool,
        RasterConfig,
        cuda_build,
    )
    from bevy_hanabi_tpu_torch.models import gradient_effect
    from bevy_hanabi_tpu_torch.render import raster
    from bevy_hanabi_tpu_torch.render.extract import extract_draw_data

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")

    # Phase 2: build the kernels from the checkout's sources.
    t0 = time.perf_counter()
    lib_path = cuda_build.build()
    cuda_build.library()
    print(f"built {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    print(lib_path.with_suffix(".log").read_text().strip())

    # Phase 3: kernels against their plain versions at the main path's shapes.
    results = compare_kernels(dev)

    # Phase 4: the small frame through the kernels against the CPU's plain path.
    pool_g, img_g, sums_g = small_frame(dev)
    pool_c, img_c, sums_c = small_frame("cpu")
    sums_g, sums_c = sums_g.cpu().numpy(), sums_c.numpy()
    if not torch.isfinite(img_g).all():
        fail("small frame: non-finite pixels on the card")
    for k, (a, b) in enumerate(zip(sums_g, sums_c)):
        if not checksum_close(float(a), float(b)):
            fail(f"small frame {k}: checksum {a} on the card vs {b} on the CPU")
    if not np.array_equal(pool_g.to_numpy()[1], pool_c.to_numpy()[1]):
        fail("small frame: alive masks differ between the card and the CPU")
    if not np.array_equal(pool_g.to_numpy()[2], pool_c.to_numpy()[2]):
        fail("small frame: PCG seeds differ between the card and the CPU")
    print(f"small frame: checksums card {sums_g.tolist()} cpu {sums_c.tolist()}")

    # Phase 5: the headline.
    asset = gradient_effect(CAPACITY)
    fx = CompiledEffect(asset, device=dev)
    pool = fx.create_pool()
    spawner = EffectSpawner(asset.spawner, rng=np.random.default_rng(0))
    cam = headline_camera()
    config = RasterConfig(width=512, height=512, tile_slots=1)
    frame = 0
    t0 = time.perf_counter()
    for _ in range((int(5.0 / DT) + K) // K + 1):
        pool, img, sums = fx.step_render_chunk(pool, *chunk_inputs(fx, spawner, frame), cam, config)
        frame += K
    alive_before = int(pool.alive_count())
    print(f"warm-up: {frame} frames in {time.perf_counter() - t0:.2f} s, alive {alive_before}")
    for kernel in raster.KERNELS.values():
        kernel.wrapper.launches = 0
    times = []
    for _ in range(3):
        ins, sims = chunk_inputs(fx, spawner, frame)
        frame += K
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pool, img, sums = fx.step_render_chunk(pool, ins, sims, cam, config)
        alive_after = int(pool.alive_count())  # readback: waits for the chunk
        times.append(time.perf_counter() - t0)
    best = min(times)
    print(f"headline chunk times (s): {times}")
    launches = {name: k.wrapper.launches for name, k in raster.KERNELS.items()}
    alive_mean = 0.5 * (alive_before + alive_after)
    print(f"headline: {K} frames in {best:.4f} s: {K / best:.2f} frames/s, "
          f"{alive_mean * K / best:.4e} particle-frames/s, alive {alive_after}, "
          f"checksum {float(sums.sum()):.6e}")
    print(f"launches in the timed chunks: {launches}")
    for name, count in launches.items():
        if count == 0:
            fail(f"the headline never launched {name}")
    if not torch.isfinite(img).all() or not float(sums.sum()) > 0.0:
        fail("headline image is not finite or its checksum is not positive")
    if tuple(img.shape) != (512, 512, 4):
        fail(f"headline image has shape {tuple(img.shape)}")

    # The last pool rendered again by the kernels and by the CPU's plain path.
    img_k = raster.rasterize(extract_draw_data(asset, pool, cam), cam, config)
    cpu_pool = ParticlePool.from_numpy(*pool.to_numpy(), device="cpu")
    img_p = raster.rasterize(extract_draw_data(asset, cpu_pool, cam), cam, config)
    s_k, s_p = float(img_k.sum()), float(img_p.sum())
    print(f"headline frame re-rendered: card {s_k:.6e} vs cpu plain {s_p:.6e}")
    if not checksum_close(s_k, s_p):
        fail(f"headline frame checksum {s_k} on the card vs {s_p} on the CPU")

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": kernel.source,
            "replaces": kernel.replaces,
            "launches": launches[name],
            **results[name],
        }
        for name, kernel in raster.KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
