"""What a run imports: the harness and every reference load neither JAX
nor the JAX package (top-level names compared whole, so the port's name,
which begins with the JAX package's, passes), and no reference imports the
program. Without a GPU the command exits non-zero and prints no result."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from hanabi_bench import run, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "bevy_hanabi_tpu"}


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "bevy_hanabi_tpu_torch_lookalike", sys)
    assert "bevy_hanabi_tpu_torch_lookalike" not in run.forbidden_modules()


def test_harness_and_references_import_no_jax():
    code = (
        "import sys, json\n"
        "import hanabi_bench.run, hanabi_bench.loops, hanabi_bench.control, hanabi_bench.measure\n"
        "from hanabi_bench import spec\n"
        "b = spec.load()\n"
        "[spec.load_module('reference', c) for c in b.configs]\n"
        "[spec.load_module('metrics', m.name) for m in b.per_layer]\n"
        "import bevy_hanabi_tpu_torch\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & FORBIDDEN


def test_references_import_nothing_of_the_program():
    for path in sorted((spec.HERE / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {"bevy_hanabi_tpu_torch"}, (path, n)


def test_no_gpu_no_result():
    out = subprocess.run([sys.executable, "-m", "hanabi_bench.run", "--workload",
                          "gradient_4m.chunk120", "--seed", "1", "--seconds", "1"],
                         cwd=spec.ROOT, capture_output=True, text=True,
                         env={**__import__("os").environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
