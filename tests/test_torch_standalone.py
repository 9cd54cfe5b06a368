"""The port stands alone: no module of ``tpu_vpcc_torch`` and nothing in
``chip_smoke.py`` imports the JAX package (``tpu_vpcc``) or jax, and a
decode through the port's ``Decoder`` and CLI, and a stream authored by
its ``build_fixture_stream`` and decoded, load neither."""

from __future__ import annotations

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
VERIFY_STREAM = ROOT / "tests" / "data" / "verify_64x64_2f.bin"
SOURCES = sorted(
    str(p.relative_to(ROOT))
    for p in [ROOT / "chip_smoke.py", *(ROOT / "tpu_vpcc_torch").rglob("*.py")]
)
#: a module name of the JAX package, or of jax itself
_FORBIDDEN = re.compile(r"(tpu_vpcc|jax|jaxlib)(\.[A-Za-z_]\w*)*")
#: the functions that import a module named by a string
_IMPORTERS = ("import_module", "__import__")


def _forbidden_imports(tree: ast.AST):
    """Every import of a forbidden module: import statements of jax or
    the JAX package (also lazy ones inside functions), and calls of
    ``importlib.import_module`` or ``__import__`` that name one."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) \
                in _IMPORTERS:
            names = [a.value for a in node.args[:1]
                     if isinstance(a, ast.Constant)
                     and isinstance(a.value, str)]
        else:
            continue
        for name in names:
            if _FORBIDDEN.fullmatch(name):
                yield node.lineno, name


def test_sources_found():
    assert "chip_smoke.py" in SOURCES
    assert "tpu_vpcc_torch/runtime/pipeline.py" in SOURCES
    assert len(SOURCES) > 40


@pytest.mark.parametrize("path", SOURCES)
def test_no_import_of_the_jax_package(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    found = list(_forbidden_imports(tree))
    assert not found, f"{path} imports {found}"


def test_scan_catches_every_form():
    src = (
        "import tpu_vpcc\n"
        "from tpu_vpcc.v3c import syntax\n"
        "def f():\n"
        "    import jax.numpy as jnp\n"
        "    importlib.import_module('tpu_vpcc.utils.ply')\n"
        "    __import__('jax')\n"
        "from .tpu_vpcc import x\n"
        "import tpu_vpcc_torch.v3c\n"
        "s = 'tpu_vpcc/ops/tiled.py:12'\n"
        "bad = ('jax', 'tpu_vpcc')\n"
    )
    found = sorted(_forbidden_imports(ast.parse(src)))
    assert [name for _, name in found] == [
        "tpu_vpcc", "tpu_vpcc.v3c", "jax.numpy", "tpu_vpcc.utils.ply", "jax"]


def test_decode_loads_neither_jax_nor_the_jax_package(tmp_path):
    """The committed stream through ``Decoder`` and through the CLI on
    the CPU, then the same stream authored anew by the port's
    ``build_fixture_stream`` with the video store in place of libx265 and
    decoded under the store, in a fresh interpreter: afterwards
    ``sys.modules`` holds no jax module and no ``tpu_vpcc`` module."""
    script = f"""
import runpy, sys
import numpy as np
from tpu_vpcc_torch import Decoder, Params
dec = Decoder(Params({str(VERIFY_STREAM)!r}, device="cpu"))
dec.start()
assert [len(f) for f in dec] == [1112, 962]
sys.argv = ["cli", "-i", {str(VERIFY_STREAM)!r}, "-o",
            {str(tmp_path / "out")!r}, "--device", "cpu"]
try:
    runpy.run_module("tpu_vpcc_torch.runtime.cli", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
from tpu_vpcc_torch.tools.video_store import VideoStore, served, served_encode
from tpu_vpcc_torch.utils.fixtures import build_fixture_stream
from tpu_vpcc_torch.utils.synthetic import make_synthetic_frame
store = VideoStore()
rng = np.random.default_rng(123)
frames = [make_synthetic_frame(rng, width=64, height=64,
                               occupancy_resolution=16,
                               occupancy_precision=4, n_patches=3,
                               frame_index=i) for i in range(2)]
with served_encode(store):
    stream = build_fixture_stream(frames)
assert stream == open({str(VERIFY_STREAM)!r}, "rb").read()
with served(store):
    dec = Decoder(Params(stream, device="cpu"))
    dec.start()
    assert [len(f) for f in dec] == [1112, 962]
assert store.encode_hits == 3 and store.hits > 0
bad = sorted(m for m in sys.modules
             if m.startswith("jax") or m.split(".")[0] == "tpu_vpcc")
print("LOADED", bad)
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout[-2000:]
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [
        "0000.ply", "0001.ply"]
