#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``bevy_hanabi_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``bevy_hanabi_tpu_torch/csrc`` and runs
the port's two main paths through its public entry points: the
benchmark-headline frame and the firework event tree. It never imports JAX.
Phases, each of which fails the run on any error:

1. a CUDA device must be present; print its name and power limit;
2. build the kernel library (nvcc, one process per source, ctypes);
3. compare each raster kernel with its plain PyTorch version on the card,
   on a real 1M-particle headline frame, and time both;
4. an 8192-particle gradient frame at 128x128 through the kernels on the
   card against the plain versions on the CPU (checksums within 0.5%);
5. the headline: ``gradient_effect(1 << 20)`` warmed past its 5 s
   lifetime, then timed ``step_render_chunk`` chunks of K = 120 frames at
   512x512, ``tile_slots=1``; every raster kernel's launch counter must
   move, and the last frame is rendered again on the CPU through the plain
   versions (checksums within 0.5%);
6. the 2k -> 8k firework tree, ``HanabiScene(seed=17)``, stepped by
   ``update(1/60)`` on the card and on the CPU: rocket and trail alive
   counts equal, alive masks and PCG seeds bit-equal, positions and
   velocities of the alive lanes within rtol 1e-2 / atol 1e-3, after 30
   frames (the JAX package's gate, bench.py:253-293, where no rocket has
   died yet) and after 90 (events flowing);
7. the 64k -> 256k firework tree, ``HanabiScene(seed=5)``:
   a. after a warm-up chunk, ``event_compact`` against its plain version
      on the rocket pool (n = 65536, the ~2k alive rockets of a burst
      active, payload = position), bit-exact, and both timed;
   d. three timed ``update_chunk(240, 1/60)`` runs, each ending in an
      alive-count readback, then 65 more frames and ``scene.render`` of
      one 512x512 frame (``tile_slots=1``, the headline camera) with rockets
      and trails on screen; every kernel's launch counter must move over
      the chunks and the frame; the frame is rendered again on the CPU
      through the plain versions (checksums within 0.5%);
   b. on that frame's 327,680 entries, ``project_bin`` and the window
      gather against their plain versions (as in phase 3), and
      ``tile_blend`` in ADD mode against its plain version, max abs err
      <= 1e-5; then the trail step's payload gather (``gather_rows`` of the
      rocket buffer's [65536, 3] positions at the 262144 trail lanes' event
      indices, with dying rockets' events pending) bit-exact; all timed.

8. ``torch.profiler`` over 30 more firework frames: launches, copies and
   synchronisations a frame, device time by op and by kernel.

Prints a ``{"kernels": [...]}`` line with a row per kernel and path: the
headline's (``tile_blend`` in BLEND) and the firework's (``[firework]``,
``tile_blend[add]``, ``event_compact``), then as its last line ``{"ok": true,
"device": {...}}``. Exits non-zero, printing no result, when no CUDA device
is available or any phase fails.
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
POS_RTOL, POS_ATOL = 1e-2, 1e-3  # bench.py:121-130, 189: positions, transcendental ULPs
HEADLINE_KERNELS = ("gather_rows", "project_bin", "tile_blend")  # tile_blend in BLEND
FIREWORK_KERNELS = ("gather_rows", "project_bin", "tile_blend[add]", "event_compact")
FW_K = 240  # frames per firework chunk, as bench.py::bench_firework_events
FW_INTO_BURST = 10  # frames into a 2 s burst period at which the timed chunks start
FW_RENDER_AT = 75  # frames into a burst period at which the frame is rendered


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


def compare_project_bin(pb_args, nt: int, label: str):
    """``project_bin`` against its plain version on ``pb_args``: at most a
    ``PROJECT_MISMATCH_MAX`` share of tiles/depths may differ, rows within
    ``ROWS_ATOL``. Returns the result row and the plain outputs."""
    import torch

    from bevy_hanabi_tpu_torch.render import raster

    tile_k, depth_k, rows_k = raster.project_bin(*pb_args)
    tile_p, depth_p, rows_p = raster.project_bin_plain(*pb_args)
    torch.cuda.synchronize()
    bad = int(((tile_k != tile_p) | (depth_k != depth_p)).sum())
    rows_err = float((rows_k - rows_p).abs().nan_to_num(0.0).max())
    n = tile_p.shape[0]
    valid = int((tile_p < nt).sum())
    print(f"{label}: {n} particles, {valid} binned on screen, "
          f"{bad} tile/depth mismatches, rows max abs err {rows_err:g}")
    if bad > PROJECT_MISMATCH_MAX * n:
        fail(f"{label}: {bad} of {n} tiles/depths differ from the plain version")
    if not torch.equal(rows_k.isnan(), rows_p.isnan()) or not rows_err <= ROWS_ATOL:
        fail(f"{label}: rows differ from the plain version (max abs err {rows_err:g})")
    row = {
        "max_abs_err": rows_err,
        "ms": cuda_ms(lambda: raster.project_bin(*pb_args), 50),
        "plain_ms": cuda_ms(lambda: raster.project_bin_plain(*pb_args), 10),
    }
    return row, (tile_p, depth_p, rows_p)


def compare_gather(table, idx, label: str) -> None:
    """``gather_rows`` against ``table.index_select(0, idx)``, bit for bit."""
    import torch

    from bevy_hanabi_tpu_torch.ops import gather

    got = gather.gather_rows(table, idx)
    want = gather.gather_rows_plain(table, idx)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"{label}: differs from table.index_select(0, idx)")
    print(f"{label}: [{table.shape[0]}, {table.shape[1]}] x {idx.shape[0]} rows, bit-exact")


def compare_kernels(dev):
    """Phase 3: each kernel against its plain version on a real frame."""
    import numpy as np
    import torch

    from bevy_hanabi_tpu_torch import CompiledEffect, EffectSpawner, RasterConfig
    from bevy_hanabi_tpu_torch.models import gradient_effect
    from bevy_hanabi_tpu_torch.ops import gather
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

    results["project_bin"], (tile_p, depth_p, rows_p) = compare_project_bin(pb_args, nt, "project_bin")
    n = draw.alive.shape[0]

    pidx_sorted, starts, ends = raster.sort_tiles(tile_p, depth_p, nt)
    pidx, has = raster.window_index(pidx_sorted, starts, ends, M)
    idx = pidx.reshape(-1)
    compare_gather(rows_p, idx, "gather_rows (raster window)")
    results["gather_rows"] = {
        "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: gather.gather_rows(rows_p, idx), 100),
        "plain_ms": cuda_ms(lambda: gather.gather_rows_plain(rows_p, idx), 100),
    }

    window = gather.gather_rows_plain(rows_p, idx).reshape(nt, M, raster.ROW)
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


def reset_launches(kernels) -> None:
    for kernel in kernels.values():
        kernel.wrapper.launches = 0
    kernels["tile_blend"].wrapper.launches_add = 0


def read_launches(kernels) -> dict:
    """Launches by kernel, ``tile_blend`` split into BLEND and ADD."""
    counts = {name: k.wrapper.launches for name, k in kernels.items()}
    counts["tile_blend[add]"] = kernels["tile_blend"].wrapper.launches_add
    counts["tile_blend"] -= counts["tile_blend[add]"]
    return counts


def require_launches(launches: dict, names, path: str) -> None:
    for name in names:
        if launches[name] == 0:
            fail(f"{path} never launched {name}")


def firework_scene(device, seed, rockets, trails):
    from bevy_hanabi_tpu_torch import HanabiScene
    from bevy_hanabi_tpu_torch.models import firework_effect, firework_trail_effect

    scene = HanabiScene(seed=seed, device=device)
    scene.add(firework_effect(rockets), "rocket")
    scene.add(firework_trail_effect(trails), "trail", parent="rocket")
    return scene


def firework_gate():
    """Phase 6: the 2k -> 8k tree on the card against the CPU."""
    import numpy as np

    card = firework_scene("cuda", 17, 2048, 8192)
    cpu = firework_scene("cpu", 17, 2048, 8192)
    frame = 0
    for checkpoint in (30, 90):
        while frame < checkpoint:
            card.update(DT)
            cpu.update(DT)
            frame += 1
        counts_g = (card["rocket"].alive_count(), card["trail"].alive_count())
        counts_c = (cpu["rocket"].alive_count(), cpu["trail"].alive_count())
        print(f"firework 2k->8k after {frame} frames: alive (rocket, trail) card {counts_g} "
              f"cpu {counts_c}")
        if counts_g != counts_c:
            fail(f"firework 2k->8k: alive counts differ after {frame} frames")
        for name in ("rocket", "trail"):
            attrs_g, alive_g, seed_g, _ = card[name].pool.to_numpy()
            attrs_c, alive_c, seed_c, _ = cpu[name].pool.to_numpy()
            if not np.array_equal(alive_g, alive_c):
                fail(f"firework 2k->8k: {name} alive masks differ after {frame} frames")
            if not np.array_equal(seed_g, seed_c):
                fail(f"firework 2k->8k: {name} PCG seeds differ after {frame} frames")
            # a trail inherits its rocket's position through the payload gather
            for attr in ("position", "velocity"):
                a, b = attrs_g[attr][alive_c], attrs_c[attr][alive_c]
                err = float(np.abs(a - b).max(initial=0.0))
                if not np.allclose(a, b, rtol=POS_RTOL, atol=POS_ATOL):
                    fail(f"firework 2k->8k: {name} {attr} differs after {frame} frames "
                         f"(max abs err {err:g})")
                print(f"  {name} {attr}: {a.shape[0]} alive lanes, max abs err {err:g}")
    if counts_g[1] == 0:
        fail("firework 2k->8k: no trail spawned in 90 frames: no event flowed")


def compare_event_compact(scene):
    """Phase 7a: event_compact against its plain version on the rocket pool
    (n = 65536; the alive rockets are the active lanes, count 4, payload =
    position)."""
    import torch

    from bevy_hanabi_tpu_torch.runtime import events

    pool = scene["rocket"].pool
    n = pool.capacity
    mask = pool.alive.contiguous()
    count = torch.full((n,), 4, dtype=torch.int64, device=mask.device)
    payload = pool.attrs["position"].contiguous().view(torch.int32)
    got = events.event_compact(mask, count, payload)
    want = events.event_compact_plain(mask, count, payload)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        fail("event_compact: differs from the stable-sort plain version")
    active = int(got[2])
    print(f"event_compact: n={n}, {active} active lanes, W={payload.shape[1]}, bit-exact")
    if active == 0:
        fail("event_compact: the comparison had no active lane")
    return {
        "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: events.event_compact(mask, count, payload), 100),
        "plain_ms": cuda_ms(lambda: events.event_compact_plain(mask, count, payload), 20),
    }


def compare_payload_gather(scene):
    """Phase 7b: the trail step's payload gather on the card against its
    plain version: the rocket buffer's position table [65536, 3] at the
    event index (rank // 4) of every one of the 262144 trail lanes, as the
    next ``update`` would gather it, while rockets are dying."""
    import torch

    from bevy_hanabi_tpu_torch.ops import gather
    from bevy_hanabi_tpu_torch.ops.compaction import exclusive_rank
    from bevy_hanabi_tpu_torch.runtime import events

    trail = scene["trail"]
    buf = scene["rocket"].last_events[trail.child_channel]
    table = buf.payload["position"].contiguous()
    rank = exclusive_rank(~trail.pool.alive)
    idx = events.event_index(buf, rank, trail.fx.parent_const_count).to(torch.int32)
    pending = int(buf.num_events)
    print(f"payload gather: {pending} events pending")
    if pending == 0:
        fail("payload gather: no event pending, so no trail would inherit a position")
    compare_gather(table, idx, "gather_rows (event payload)")
    return {
        "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: gather.gather_rows(table, idx), 100),
        "plain_ms": cuda_ms(lambda: gather.gather_rows_plain(table, idx), 100),
    }


def compare_tile_blend_add(scene, cam, config):
    """Phase 7b: ``project_bin``, the window gather and the ADD
    ``tile_blend`` against their plain versions on the scene's real 512x512
    frame (its one transparent batch pass, 327,680 entries)."""
    import dataclasses

    import torch

    from bevy_hanabi_tpu_torch.ops import gather
    from bevy_hanabi_tpu_torch.render import raster
    from bevy_hanabi_tpu_torch.render.extract import ParticleDrawData, extract_draw_data

    sim = scene.clock.sim_params()
    draws = [extract_draw_data(e.asset, e.pool, cam, sim=sim, transform=e.transform)
             for e in scene.effects()]
    draw = ParticleDrawData(*(torch.cat([getattr(d, f.name) for d in draws])
                              for f in dataclasses.fields(ParticleDrawData)))
    T, ntx, nty, nt = config.tile_size, config.tiles_x, config.tiles_y, config.num_tiles
    M = config.max_entries_per_tile
    pb_args = (draw.position, draw.axis_x, draw.axis_y, draw.alive, draw.color.contiguous(),
               cam.view, cam.proj, cam.viewport, T, ntx, nty)
    pb_row, (tile, depth, rows) = compare_project_bin(pb_args, nt, "project_bin (firework)")
    mode = raster.fast_mode(config, "add", tile.shape[0])
    pidx_sorted, starts, ends = raster.sort_tiles(tile, depth, nt, mode)
    pidx, has = raster.window_index(pidx_sorted, starts, ends, M, from_start=True)
    compare_gather(rows, pidx.reshape(-1), "gather_rows (firework window)")
    window = gather.gather_rows_plain(rows, pidx.reshape(-1)).reshape(nt, M, raster.ROW)
    args = (window, has, T, ntx, nty, config.background, "add")
    fb_k = raster.tile_blend(*args)
    fb_p = raster.tile_blend_plain(*args)
    torch.cuda.synchronize()
    err = float((fb_k - fb_p).abs().max())
    entries = int(has.sum())
    print(f"tile_blend add: {tile.shape[0]} entries, variant {mode!r}, "
          f"{entries} window entries, max abs err {err:g}")
    if not (err <= BLEND_ATOL) or entries == 0:
        fail(f"tile_blend add: max abs err {err:g} > {BLEND_ATOL:g} or an empty window")
    return {
        "project_bin[firework]": pb_row,
        "tile_blend[add]": {
            "max_abs_err": err,
            "ms": cuda_ms(lambda: raster.tile_blend(*args), 50),
            "plain_ms": cuda_ms(lambda: raster.tile_blend_plain(*args), 5),
        },
    }


def firework_tree(kernels, cam):
    """Phase 7: the 64k -> 256k tree through update_chunk and render."""
    import copy

    import torch

    from bevy_hanabi_tpu_torch import ParticlePool, RasterConfig

    config = RasterConfig(512, 512, tile_slots=1)
    scene = firework_scene("cuda", 5, 65536, 262144)
    # The spawner bursts 2048 rockets every 2 s (120 frames): warm up to 10
    # frames into a burst period, when every rocket of the burst is alive.
    t0 = time.perf_counter()
    scene.update_chunk(FW_K + FW_INTO_BURST, DT)
    print(f"firework 64k->256k warm-up: {FW_K + FW_INTO_BURST} frames in "
          f"{time.perf_counter() - t0:.2f} s, alive rockets {scene['rocket'].alive_count()} "
          f"trails {scene['trail'].alive_count()}")
    results = {"event_compact": compare_event_compact(scene)}

    reset_launches(kernels)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scene.update_chunk(FW_K, DT)
        alive = scene["trail"].alive_count()  # readback: waits for the chunk
        times.append(time.perf_counter() - t0)
    best = min(times)
    print(f"firework chunk times (s): {times}")
    print(f"firework 64k->256k: {FW_K} frames in {best:.4f} s: {FW_K / best:.2f} steps/s, "
          f"alive rockets {scene['rocket'].alive_count()} trails {alive}")
    # Render 75 frames into the burst period, when rockets are dying and
    # trails spawning, so the frame holds both.
    scene.update_chunk(FW_RENDER_AT - FW_INTO_BURST, DT)
    print(f"rendered frame: alive rockets {scene['rocket'].alive_count()} "
          f"trails {scene['trail'].alive_count()}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = scene.render(cam, config)
    checksum = float(img.sum())  # readback: waits for the frame
    render_s = time.perf_counter() - t0
    launches = read_launches(kernels)
    print(f"launches in the timed chunks and the frame: {launches}")
    require_launches(launches, FIREWORK_KERNELS, "the firework tree")
    if not torch.isfinite(img).all() or not checksum > 0.0 or tuple(img.shape) != (512, 512, 4):
        fail("firework frame is not finite, not positive or not 512x512x4")
    render_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        float(scene.render(cam, config).sum())
        render_ms.append(1e3 * (time.perf_counter() - t1))
    print(f"firework frame 512x512 ({scene['rocket'].pool.capacity + scene['trail'].pool.capacity}"
          f" entries): first {1e3 * render_s:.3f} ms, then {render_ms} ms, checksum {checksum:.6e}")
    results.update(compare_tile_blend_add(scene, cam, config))
    results["gather_rows[firework]"] = compare_payload_gather(scene)
    for name, r in results.items():
        print(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")

    cpu = firework_scene("cpu", 5, 65536, 262144)
    cpu.clock = copy.deepcopy(scene.clock)
    for name in ("rocket", "trail"):
        cpu[name].pool = ParticlePool.from_numpy(*scene[name].pool.to_numpy(), device="cpu")
    s_p = float(cpu.render(cam, config).sum())
    print(f"firework frame re-rendered: card {checksum:.6e} vs cpu plain {s_p:.6e}")
    if not checksum_close(checksum, s_p):
        fail(f"firework frame checksum {checksum} on the card vs {s_p} on the CPU")
    return scene, results, launches


def profile_firework(scene, frames: int = 30) -> None:
    """Phase 8: launches, copies, synchronisations and device time by op
    and by kernel over ``frames`` firework frames (``torch.profiler``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        scene.update_chunk(frames, DT)
        scene["trail"].alive_count()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    device_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    copies = sum(e.count for e in events if e.key == "cudaMemcpyAsync")
    syncs = sum(e.count for e in events if e.key == "cudaStreamSynchronize")
    print(f"profile: {frames} frames, wall {1e3 * wall:.2f} ms (profiled), device busy "
          f"{device_us / 1e3:.3f} ms; per frame {launches / frames:.1f} launches, "
          f"{copies / frames:.1f} cudaMemcpyAsync, {syncs / frames:.1f} cudaStreamSynchronize")
    ops = sorted((e for e in events if e.key.startswith("aten::")),
                 key=lambda e: -e.device_time_total)
    print("profile: aten ops by device time (ms a frame, calls a frame, host ms a frame)")
    for e in ops[:10]:
        print(f"  {e.key:32s} {e.device_time_total / 1e3 / frames:8.4f} "
              f"{e.count / frames:6.1f} {e.cpu_time_total / 1e3 / frames:8.4f}")
    print("profile: kernels by device time (ms a frame)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3 / frames:8.4f}  {e.key[:110]}")


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
    from bevy_hanabi_tpu_torch.ops import gather
    from bevy_hanabi_tpu_torch.render import raster
    from bevy_hanabi_tpu_torch.render.extract import extract_draw_data
    from bevy_hanabi_tpu_torch.runtime import events

    kernels = {**gather.KERNELS, **raster.KERNELS, **events.KERNELS}
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
    reset_launches(kernels)
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
    launches = read_launches(kernels)
    alive_mean = 0.5 * (alive_before + alive_after)
    print(f"headline: {K} frames in {best:.4f} s: {K / best:.2f} frames/s, "
          f"{alive_mean * K / best:.4e} particle-frames/s, alive {alive_after}, "
          f"checksum {float(sums.sum()):.6e}")
    print(f"launches in the timed chunks: {launches}")
    require_launches(launches, HEADLINE_KERNELS, "the headline")
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

    # Phase 6: the 2k -> 8k firework tree, card against CPU.
    firework_gate()

    # Phase 7: the 64k -> 256k firework tree.
    fw_scene, fw_results, fw_launches = firework_tree(kernels, cam)
    profile_firework(fw_scene)

    results.update(fw_results)
    # name, kernel, launches: each row holds one path's launches and its
    # comparison at that path's shapes (the headline's, then the firework's)
    rows = [(name, name, launches[name]) for name in HEADLINE_KERNELS] + [
        (f"{name}[firework]" if name in HEADLINE_KERNELS else name,
         name.split("[")[0], fw_launches[name])
        for name in FIREWORK_KERNELS
    ]
    kernel_rows = [
        {
            "name": name,
            "route": "cuda",
            "source": kernels[kernel].source,
            "replaces": kernels[kernel].replaces,
            "launches": count,
            **results[name],
        }
        for name, kernel, count in rows
    ]
    print(json.dumps({"kernels": kernel_rows}))
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
