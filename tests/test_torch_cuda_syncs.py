"""Where the port blocks its host on the card: the synchronizing calls of
a frame, by the port's function that makes them.

Each case warms one benchmark configuration's path
(``hanabi_bench/configs/``), then runs it under
``torch.cuda.set_sync_debug_mode("warn")``: a ``step_render_chunk`` (or
``step_chunk``) call of one frame and one of two, whose difference is a
frame's syncs and the rest a call's, or one ``HanabiScene`` frame
(``update`` and ``render``). Each warning goes to the innermost frame of
``bevy_hanabi_tpu_torch`` on the Python stack. ``SITES`` is the census; a
change that removes or adds a sync updates it. Marked ``cuda``; without a
card every case skips. Run with ``-s`` for each site's ``file:line``:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_syncs.py -q -s
"""

import ast
import json
import traceback
import warnings
from collections import Counter
from functools import lru_cache
from pathlib import Path

import pytest
import torch

from hanabi_bench import program, spec

pytestmark = pytest.mark.cuda

PORT = Path(__file__).resolve().parent.parent / "bevy_hanabi_tpu_torch"
SEED = 2_718_281_828

# "file under bevy_hanabi_tpu_torch/::function" -> [syncs a frame, syncs a call].
# Every one but the culling readback is an upload of a host value (pageable,
# so the copy waits on the stream): a constant of a gradient, the camera's
# rotation. The step of either configuration is its generated kernel
# (runtime/fused.py), fed by launch arguments and a pinned upload: none.
_GRADIENT = {
    "gradient.py::const": [8, 0],
    "modifiers/output.py::apply_render": [1, 0],
    "render/extract.py::extract_draw_data": [1, 0],
}
SITES = {
    "gradient_4m.chunk": _GRADIENT,
    "instancing_1024x4096.chunk": {
        "gradient.py::const": [3, 0],
        "render/extract.py::extract_draw_data": [1, 0],
    },
    "instancing_1024x4096.sim": {},
    "gradient_4m.scene": {
        **_GRADIENT,
        "runtime/scene.py::_refresh_aabbs": [1, 0],  # the culling readback
        "runtime/scene.py::render": [1, 0],  # the clear colour's upload
    },
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the census counts the card's syncs")
    return torch.device("cuda")


@lru_cache(maxsize=None)
def _functions(path: Path):
    """``(first line, last line, name)`` of every function in ``path``."""
    tree = ast.parse(path.read_text())
    return [(n.lineno, n.end_lineno, n.name) for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def _site(path: Path, line: int) -> str:
    inner = [f for f in _functions(path) if f[0] <= line <= f[1]]
    return f"{path.relative_to(PORT).as_posix()}::{max(inner)[2] if inner else '<module>'}"


def census(run):
    """``(by site, by file:line)`` of the syncs ``run()`` makes."""
    sites, lines = Counter(), Counter()

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" not in str(message):
            return
        for fr in reversed(traceback.extract_stack()[:-1]):
            p = Path(fr.filename).resolve()
            if PORT in p.parents:
                sites[_site(p, fr.lineno)] += 1
                lines[f"{p.relative_to(PORT).as_posix()}:{fr.lineno}"] += 1
                return
        sites["<outside the port>"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sites, lines


def _config(name):
    bench = spec.load()
    return json.loads((spec.ROOT / bench.configs[name]["file"]).read_text())


def _chunk(config_name, render, dev):
    traffic = {"loop": "chunk", "render": render, "frames_per_call": 1, "frames_per_second": 60}
    prog = program.build(_config(config_name), traffic, SEED, dev)
    f = 0

    def call(k):
        nonlocal f
        stacked = prog.inputs(f, k)  # the benchmark's inputs: host arrays, no sync
        f += k
        return lambda: prog.call(stacked)

    for _ in range(3):
        call(2)()
    one_sites, one_lines = census(call(1))
    two_sites, two_lines = census(call(2))
    frame = two_sites - one_sites
    per_call = Counter({k: 2 * one_sites[k] - two_sites[k] for k in one_sites | two_sites})
    return ({k: [frame[k], per_call[k]] for k in frame | +per_call},
            dict(two_lines - one_lines))


def _scene(config_name, dev):
    traffic = {"loop": "scene", "render": True, "frames_per_second": 60, "in_flight": 2}
    prog = program.build(_config(config_name), traffic, SEED, dev)
    for _ in range(3):
        prog.frame()
    sites, lines = census(prog.frame)
    return {k: [v, 0] for k, v in sites.items()}, dict(lines)


@pytest.mark.parametrize("case", list(SITES))
def test_sync_sites(cuda, case):
    config, kind = case.rsplit(".", 1)
    got, lines = _scene(config, cuda) if kind == "scene" else _chunk(config, kind == "chunk", cuda)
    print(f"\nSYNCS {case} " + json.dumps({"sites": dict(sorted(got.items())),
                                            "frame_lines": dict(sorted(lines.items()))}))
    assert got == SITES[case]
