"""Colour conversion of the PyTorch port (tpu_vpcc_torch.ops.color)
against its exact numpy integer form (a copy of tpu_vpcc's) and the
reference f64 chain."""
import numpy as np
import pytest
import torch

from tpu_vpcc.ops import color as ref_color
from tpu_vpcc.ops.color import _G_CHAIN_DEVIATIONS, g8_from_packed
from tpu_vpcc.reconstruction.pointset import convert_yuv10_to_rgb8
from tpu_vpcc_torch.ops.color import (
    convert_yuv10_to_rgb8_lut,
    rgb8_from_rgb16,
    rgb8_from_yuv16,
)


def _port(yuv: np.ndarray) -> np.ndarray:
    out = rgb8_from_yuv16(torch.from_numpy(yuv.astype(np.int32)))
    assert out.dtype == torch.uint8
    return out.numpy()


def test_chain_deviation_inputs():
    """The 45 (y, u, v) triples where the f64 chain's own rounding lands
    on a floor boundary of the g channel."""
    yuv = np.array(sorted(_G_CHAIN_DEVIATIONS), dtype=np.uint16)
    assert yuv.shape == (45, 3)
    got = _port(yuv)
    np.testing.assert_array_equal(got, convert_yuv10_to_rgb8_lut(yuv))
    np.testing.assert_array_equal(got, convert_yuv10_to_rgb8(yuv))


@pytest.mark.parametrize("seed", [0, 1])
def test_random_10bit_domain(seed):
    rng = np.random.default_rng(seed)
    yuv = rng.integers(0, 1024, (200_000, 3), dtype=np.uint16)
    edges = np.array(
        [[y, u, v] for y in (0, 1, 1023) for u in (0, 512, 1023)
         for v in (0, 511, 1023)], dtype=np.uint16,
    )
    yuv = np.concatenate([yuv, edges])
    got = _port(yuv)
    np.testing.assert_array_equal(got, convert_yuv10_to_rgb8_lut(yuv))
    np.testing.assert_array_equal(got[:5000], convert_yuv10_to_rgb8(yuv[:5000]))


def test_batched_shape_and_rgb16():
    rng = np.random.default_rng(2)
    yuv = rng.integers(0, 1024, (2, 300, 3), dtype=np.uint16)
    got = _port(yuv)
    assert got.shape == (2, 300, 3)
    np.testing.assert_array_equal(
        got.reshape(-1, 3), convert_yuv10_to_rgb8_lut(yuv.reshape(-1, 3))
    )
    rgb16 = rng.integers(0, 1 << 16, (50, 3)).astype(np.int32)
    out = rgb8_from_rgb16(torch.from_numpy(rgb16))
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), (rgb16 & 0xFF).astype(np.uint8))


@pytest.mark.parametrize("seed", [4, 5])
def test_lut_form_matches_reference(seed):
    """The port's numpy integer form against tpu_vpcc's and the f64
    chain, on random 10-bit triples and the 45 chain deviations."""
    rng = np.random.default_rng(seed)
    yuv = np.concatenate([
        rng.integers(0, 1024, (100_000, 3), dtype=np.uint16),
        np.array(sorted(_G_CHAIN_DEVIATIONS), dtype=np.uint16),
    ])
    got = convert_yuv10_to_rgb8_lut(yuv)
    assert got.dtype == np.uint8 and got.shape == yuv.shape
    np.testing.assert_array_equal(got, ref_color.convert_yuv10_to_rgb8_lut(yuv))
    np.testing.assert_array_equal(got[-5045:], convert_yuv10_to_rgb8(yuv[-5045:]))


def test_g8_from_packed_on_int32_tensors():
    """The shared helper runs unchanged on torch int32 tensors; torch
    floors like numpy on the negative numerators it meets."""
    rng = np.random.default_rng(3)
    y = rng.integers(0, 1024, 10_000).astype(np.int32)
    packed = rng.integers(0, 1 << 24, 10_000).astype(np.int32)
    want = g8_from_packed(y, packed)
    got = g8_from_packed(torch.from_numpy(y), torch.from_numpy(packed))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (torch.tensor([-7]) // 341).item() == -1


def test_verify_color_exact_quick_on_cpu_stays_jax_free():
    """``python -m tpu_vpcc_torch.tools.verify_color_exact --quick 2
    --device cpu`` in a fresh interpreter: no mismatch in r, g or b, and
    neither jax nor tpu_vpcc loaded."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    script = """
import runpy, sys
sys.argv = ["verify_color_exact", "--quick", "2", "--device", "cpu"]
try:
    runpy.run_module("tpu_vpcc_torch.tools.verify_color_exact",
                     run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "tpu_vpcc"))
print("LOADED", bad)
"""
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=root,
        env=dict(os.environ, PYTHONPATH=str(root)),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "mismatches r=0 g=0 b=0" in proc.stdout, proc.stdout
    assert "channel g: 2097152 triples, 0 mismatches" in proc.stdout
    assert "LOADED []" in proc.stdout


@pytest.mark.parametrize("table, index, channel", [
    (0, 700, "r"), (1, 300, "b"), (2, 1024 + 300, "g"),
], ids=["s_r", "s_b", "packed_g"])
def test_verify_color_exact_finds_a_changed_table_entry(
        monkeypatch, capsys, table, index, channel):
    """The runtime conversion with one entry of one of its tables moved
    by one: the verifier reports mismatches in that channel only and
    exits 1."""
    from tpu_vpcc_torch.ops import color as port_color
    from tpu_vpcc_torch.tools import verify_color_exact

    real = port_color._device_luts

    def changed(device):
        luts = [t.clone() for t in real(device)]
        luts[table][index] += 1
        return tuple(luts)

    monkeypatch.setattr(port_color, "_device_luts", changed)
    assert verify_color_exact.main(["--quick", "2", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "MISMATCHES FOUND" in out
    for name in "rgb":
        line = next(l for l in out.splitlines()
                    if l.startswith(f"channel {name}:"))
        assert line.endswith(" 0 mismatches") == (name != channel), line
