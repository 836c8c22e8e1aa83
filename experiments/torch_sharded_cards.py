#!/usr/bin/env python3
"""The port's sharded paths on a mesh over several cards, against the same
work on one card.

    python3 experiments/torch_sharded_cards.py      # needs two or more CUDA devices

``chip_smoke.py`` phase 23 runs every shard of its (dp=4, sp=2) mesh on
``cuda:0``; here the eight shards lie on every card of the machine, each
card holding ``8 / cards`` of them, so the dead-lane counts, the event
buffers, the slice route and the psum's partial images cross between cards
for real (PyTorch copies between devices). For each path the output is on
``cuda:0`` and is held against the unsharded twin there, as phase 23 holds
it: the sharded group's pools bit-equal to ``InstancedEffect``'s; the 1M-lane
slice frame (BLEND) and psum frame (ADD) at 512², ``tile_slots=1``, equal on
the tiles that fit M (the slice frame: and border no slice), the slice
frame's checksum within 0.5% at the exact binning; the 64k -> 256k firework
tree with ``add(mesh=)`` bit-equal to the unsharded tree; the dryrun's mixed
scene equal to the same scene with a plain group. Prints the time of each
path (steps/s, ms a frame) beside the same path with every shard on
``cuda:0`` and the unsharded path, each card's name and power limit, and
exits non-zero on any failure.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    cards = torch.cuda.device_count()
    if cards < 2:
        print("torch_sharded_cards: needs two or more CUDA devices", file=sys.stderr)
        return 1
    from bevy_hanabi_tpu_torch import cuda_build
    from bevy_hanabi_tpu_torch.parallel import make_mesh

    print(subprocess.run(["nvidia-smi", "--query-gpu=index,name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip())
    t0 = time.perf_counter()
    cuda_build.build()
    cuda_build.library()
    print(f"built in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    spread = [torch.device("cuda", i % cards) for i in range(cs.SHARD_DEVICES)]
    layouts = {
        f"{cards} cards": lambda d: make_mesh(spread, dp=4, sp=2),
        "cuda:0": lambda d: make_mesh([d] * cs.SHARD_DEVICES, dp=4, sp=2),
    }
    for label, mesh_of in layouts.items():
        print(f"== the (dp=4, sp=2) mesh over {label}: "
              f"{[str(d) for d in mesh_of(dev).flat_devices()]}")
        cs.shard_mesh = mesh_of
        t0 = time.perf_counter()
        cs.sharded_step(dev)
        sharded_frames(dev)
        cs.sharded_trees(dev)
        cs.sharded_scene(dev)
        print(f"== {label}: {time.perf_counter() - t0:.1f} s")
    print("torch_sharded_cards: ok")
    return 0


def sharded_frames(dev) -> None:
    """The 1M-lane slice and psum frames, held against the unsharded frame
    on ``dev`` (phase 23b's holds), and timed."""
    import copy

    import torch

    from bevy_hanabi_tpu_torch import AlphaMode, EffectRenderer, RasterConfig
    from bevy_hanabi_tpu_torch.parallel import ShardedEffect, ShardedRenderer
    from bevy_hanabi_tpu_torch.render.extract import extract_draw_data

    fx, pools, asset = cs.shard_render_setup(dev)
    cam = cs.headline_camera()
    flat = fx.assemble(pools).flatten()
    for binning in (1, 0):
        config = RasterConfig(512, 512, tile_slots=binning)
        counts = cs.tile_counts(extract_draw_data(asset, flat, cam), cam, config)
        fits = counts <= config.max_entries_per_tile
        rows = config.tiles_y // cs.SHARD_DEVICES
        ty = torch.arange(config.num_tiles, device=dev) // config.tiles_x
        edge = ((ty % rows == 0) & (ty > 0)) | ((ty % rows == rows - 1) & (ty < config.tiles_y - 1))
        for mode, alpha in (("slice", "blend"), ("psum", "add")):
            if binning == 0 and mode == "psum":
                continue
            a = asset if alpha == "blend" else copy.deepcopy(asset).with_alpha_mode(AlphaMode.ADD)
            r = ShardedRenderer(ShardedEffect(a, fx.num_instances, fx.mesh, device=dev), config)
            img = r.render(pools, cam)
            ms = cs.host_ms(lambda: r.render(pools, cam))
            ref = EffectRenderer(a, config).render(flat, cam)
            label = f"{mode} ({alpha}, tile_slots={binning})"
            exact = fits & ~edge if mode == "slice" and binning == 1 else fits
            atol = 1e-4 * max(1.0, float(ref.abs().max())) if mode == "psum" else 0.0
            s_a, s_b = cs.hold_sharded_image(label, img, ref, counts, config, exact, atol)
            print(f"{label}: {ms:.3f} ms a frame")
            if binning == 0 and not cs.checksum_close(s_a, s_b):
                cs.fail(f"{label}: checksum {s_a} against the unsharded {s_b}")


if __name__ == "__main__":
    sys.exit(main())
