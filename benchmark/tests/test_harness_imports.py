"""Nothing the benchmark runs imports jax, the JAX package or the repo's
older benchmark scripts, and the reference imports nothing of the port.
Names are compared whole at the top level: ``renderer_tpu_torch`` is not
``renderer_tpu``."""

import ast
import json
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "renderer_tpu", "bench", "bench_torch", "chip_smoke",
             "chip_ab"}


def modules(sub=""):
    """(dotted name, path) of every module under benchmark/<sub>."""
    out = []
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in sorted(files):
            if f.endswith(".py"):
                path = os.path.join(d, f)
                rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
                out.append((rel[: -len(".__init__")] if rel.endswith(".__init__") else rel, path))
    return out


def imported_tops(path):
    """Top-level names of every import statement in the file."""
    tree = ast.parse(open(path).read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def loaded_after_import(names):
    """Top-level names in sys.modules of a fresh process that imported
    ``names`` (metric files by path, as the harness loads them)."""
    code = (
        "import importlib, importlib.util, json, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"for n, p in {names!r}:\n"
        "    if '.metrics.' in n and not n.endswith('__init__'):\n"
        "        s = importlib.util.spec_from_file_location('m_' + n.replace('.', '_'), p)\n"
        "        s.loader.exec_module(importlib.util.module_from_spec(s))\n"
        "    else:\n"
        "        importlib.import_module(n)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=240, env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("name,path", modules(), ids=lambda v: v if "." in v else None)
def test_no_module_names_a_forbidden_import(name, path):
    tops = imported_tops(path)
    assert not tops & FORBIDDEN, f"{name} imports {sorted(tops & FORBIDDEN)}"
    if ".reference" in name:
        assert "renderer_tpu_torch" not in tops, f"{name} imports the port"


def test_loading_every_module_loads_nothing_forbidden():
    loaded = loaded_after_import(modules())
    assert not loaded & FORBIDDEN, sorted(loaded & FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    loaded = loaded_after_import(modules("reference"))
    assert "renderer_tpu_torch" not in loaded
    assert not loaded & FORBIDDEN
