"""Which step each benchmark cell's frames take: the share of frames the
generated step kernel stepped (``fused_step_share``) in every cell of
``BENCHMARK.json``, through the benchmark's own program
(``hanabi_bench/program.py``), over the cell's warm-up and 240 more frames.
On a machine with a CUDA device, from the repository's root:

    python3 experiments/torch_step_engagement.py [--seed N]
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch

    from hanabi_bench import inputs, program, spec

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=1_234_567_891)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_step_engagement: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    bench = spec.load()
    out = {}
    for name in bench.workloads:
        cell = bench.cell(name)
        prog = program.build(cell.config, cell.traffic, args.seed, dev)
        frames = inputs.warm_frames(cell.config, cell.traffic) + 240
        if cell.traffic["loop"] == "scene":
            for _ in range(frames):
                prog.frame()
            torch.cuda.synchronize()
            share = prog.scene.stats()["fused_step_share"][prog.name]
        else:
            k = cell.traffic["frames_per_call"]
            for f in range(0, frames, k):
                prog.call(prog.inputs(f, k))
            torch.cuda.synchronize()
            fx = getattr(prog.fx, "effect", prog.fx)  # a group's compiled effect
            share = fx.fused_step_share
        out[name] = share
        print(f"{name}: fused_step_share {share}")
    print(json.dumps({"fused_step_share": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
