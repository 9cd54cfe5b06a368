#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tpu_vpcc_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and the CUDA toolkit (nvcc). Phases, each of which exits non-zero on
failure:

  1. device and build: the card's name and power limit, the K1 build
     with nvcc's ``-Xptxas -v`` lines, and whether the host video bridge
     (libavcodec) loads;
  2. K1 against its plain PyTorch version on the card: densities 0, 0.3,
     0.7, 1 and all-D1-invalid, F = 1 and 2, pack30 and split operands,
     the flagship slot extent and a small odd tile count. Counts equal,
     prefixes byte-equal;
  3. the flagship main path on the card: two GOFs of two synthetic
     1280^2 frames each through ``Decoder.start_gofs`` with both GOFs in
     flight (group tables, cat staging, gather + words + K1 on the card,
     prefix fetch with yuv10 -> rgb8 on the card, PointSet3), each frame
     byte-equal to the numpy oracle, with the K1 launch counter read
     around that run; then CUDA-event timings and the Decoder's
     throughput with one and two GOFs in flight;
  4. a committed fixture stream through ``Decoder`` on the card, whose
     PLY bytes must equal the port's oracle path. Not run, and said so,
     only when phase 1 found that the host video bridge cannot load.

The last line is ``{"ok": true, "device": {...}}``; before it come one
JSON line of per-kernel results and the ``nvidia-smi`` name and power
limit line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
STREAM = ROOT / "tests" / "data" / "verify_64x64_2f.bin"
K1_SOURCE = "tpu_vpcc_torch/csrc/shift_compact.cu"
K1_REPLACES = "tpu_vpcc/ops/shift_compact.py:127"


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def event_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn()`` in ms."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def prefix_err(outs_a, outs_b, counts) -> int:
    """Max |a - b| over every frame's compacted prefix (0 = byte-equal)."""
    err = 0
    for a, b in zip(outs_a, outs_b):
        for f, n in enumerate(counts):
            d = (a[f, :n].long() - b[f, :n].long()).abs()
            if n:
                err = max(err, int(d.max()))
    return err


def phase_build():
    import torch

    from tpu_vpcc_torch.ops import _build
    from tpu_vpcc_torch.ops import shift_compact as sc

    print(f"device: {torch.cuda.get_device_name(0)}")
    print(f"nvidia-smi: {nvidia_smi_line()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    sc._load()
    print(f"K1 build: {time.perf_counter() - t0:.2f} s")
    for line in _build.build_logs.get("shift_compact", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  {line.strip()}")
    from tpu_vpcc.video import codec

    try:
        codec._load()
    except (subprocess.CalledProcessError, OSError) as e:
        detail = getattr(e, "stderr", "") or str(e)
        reason = " | ".join(detail.strip().splitlines()[-3:])
        print(f"video bridge: cannot load ({type(e).__name__}: {reason})")
        return False
    print("video bridge: loads")
    return True


def _k1_case(F, S, density, pack30, d1_invalid, gen):
    import torch

    from tpu_vpcc_torch.ops import shift_compact as sc

    dev = torch.device("cuda")
    lo, hi = -(2 ** 31), 2 ** 31 - 1
    w0 = torch.randint(lo, hi, (F, S), dtype=torch.int32, device=dev,
                       generator=gen)
    wc = torch.randint(lo, hi, (F, S), dtype=torch.int32, device=dev,
                       generator=gen)
    zs = None if pack30 else torch.randint(
        -(2 ** 15), 2 ** 15 - 1, (F, S), dtype=torch.int16, device=dev,
        generator=gen,
    )
    valid = torch.rand((F, S), device=dev, generator=gen) < density
    if d1_invalid:
        valid[:, S // 2:] = False
    got, n_got = sc.shift_compact_ops(w0, zs, wc, valid)
    ref, n_ref = sc.shift_compact_ops_reference(w0, zs, wc, valid)
    torch.cuda.synchronize()
    check(torch.equal(n_got, n_ref),
          f"K1 counts {n_got.tolist()} != plain {n_ref.tolist()}")
    counts = n_ref.tolist()
    err = prefix_err(got, ref, counts)
    check(err == 0, f"K1 prefix differs from plain (max abs err {err})")
    return counts


def phase_k1(S_flag: int):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1234)
    s_odd = 2 * (2 * 2048 + 768)  # 3 tiles of the kernel, the last partial
    cases = []
    for S in (S_flag, s_odd):
        for F in (1, 2):
            for pack30 in (True, False):
                for density in (0.0, 0.3, 0.7, 1.0):
                    cases.append((F, S, density, pack30, False))
                cases.append((F, S, 0.7, pack30, True))
    for F, S, density, pack30, d1_inv in cases:
        counts = _k1_case(F, S, density, pack30, d1_inv, gen)
        print(f"K1 vs plain: F={F} S={S} density={density} "
              f"{'pack30' if pack30 else 'split'}"
              f"{' all-D1-invalid' if d1_inv else ''}: counts {counts} equal")
    print(f"phase 2: {len(cases)} K1 cases byte-equal to the plain version")


def oracle_frame(sf, frames):
    from tpu_vpcc.reconstruction.oracle import (
        GeneratePointCloudParams,
        generate_point_cloud,
    )

    params = GeneratePointCloudParams(
        occupancy_resolution=sf.occupancy_resolution,
        occupancy_precision=sf.occupancy_precision,
        map_count_minus1=sf.map_count - 1,
    )
    geo = [p for f in frames for p in f.geo_planes]
    attr = [a for f in frames for a in f.attr_planes]
    ps, _, _ = generate_point_cloud(sf.meta, params, sf.occ_plane, geo, [attr])
    ps.convert_yuv16_to_rgb8()
    return ps


def flagship_inputs():
    """Two decoded GOFs of two synthetic 1280^2 flagship frames each
    (frame seeds 0-1 and 2-3), and the slot extent S of the first
    GOF's dispatch."""
    from tpu_vpcc_torch.models.flagship import (
        FlagshipConfig,
        example_frames,
        example_gof,
    )
    from tpu_vpcc_torch.runtime import pipeline as P

    fcfg = FlagshipConfig(batch=2)
    t0 = time.perf_counter()
    frame_sets = [example_frames(fcfg, seed=s) for s in (0, 2)]
    gofs = [example_gof(fcfg, f) for f in frame_sets]
    cfg, _tables, g_bucket = P._gof_tables_and_bucket(gofs[0])
    print(f"flagship: {fcfg.width}x{fcfg.height}, {len(gofs)} GOFs of "
          f"{fcfg.batch} frames synthesised in {time.perf_counter() - t0:.2f} "
          f"s, {g_bucket} groups per frame")
    return frame_sets, gofs, g_bucket * cfg.slots_per_block


def decode_gofs(gofs, depth: int):
    """The public entry: ``Decoder.start_gofs`` on the card with
    ``depth`` GOFs reconstructing at once; the frames, in order."""
    from tpu_vpcc_torch.runtime.pipeline import Decoder, Params

    dec = Decoder(Params(device="cuda", pipeline_gofs=depth))
    dec.start_gofs(gofs)
    return list(dec)


def phase_flagship(frame_sets, gofs):
    import numpy as np
    import torch

    from tpu_vpcc_torch.ops import shift_compact as sc
    from tpu_vpcc_torch.ops.tiled import (
        _gather_tiles,
        _tiles_to_words,
        reconstruct_batch_pretiled_packed,
        to_device,
    )
    from tpu_vpcc_torch.runtime import pipeline as P

    dev = torch.device("cuda")

    # the main path, counted: Decoder with two GOFs in flight (tables,
    # staging, dispatch, fetch, PointSet3 on two reconstruction threads)
    torch.cuda.synchronize()
    sc.reset_launches()
    t0 = time.perf_counter()
    out = decode_gofs(gofs, depth=2)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = sc.launches
    check(launches >= len(gofs),
          f"the main path launched K1 {launches} times for {len(gofs)} GOFs")
    print(f"main path: Decoder.start_gofs, pipeline_gofs=2, {len(gofs)} GOFs, "
          f"{len(out)} frames in {first_s:.3f} s (first run), "
          f"K1 launches {launches}")

    all_frames = [sf for frames in frame_sets for sf in frames]
    check(len(out) == len(all_frames),
          f"{len(out)} frames out for {len(all_frames)} in")
    n_points = []
    for g, frames in enumerate(frame_sets):
        for sf in frames:
            ps = out[g * len(frames) + sf.meta.frame_index]
            t0 = time.perf_counter()
            ref = oracle_frame(sf, frames)
            same = (
                ps.positions.shape == ref.positions.shape
                and np.array_equal(ps.positions, ref.positions)
                and np.array_equal(ps.colors, ref.colors)
            )
            check(same, f"GOF {g} frame {sf.meta.frame_index}: {len(ps)} "
                        f"points differ from the oracle's {len(ref)}")
            n_points.append(len(ps))
            print(f"GOF {g} frame {sf.meta.frame_index}: {len(ps)} points "
                  f"byte-equal to the numpy oracle (oracle "
                  f"{time.perf_counter() - t0:.1f} s)")

    # timings at this shape (not counted: the main-path run is over)
    frames, gof = frame_sets[0], gofs[0]
    cfg, tables, g_bucket = P._gof_tables_and_bucket(gof)
    t0 = time.perf_counter()
    di = P._gof_device_inputs(gof, gof.metas, (cfg, tables), g_bucket)
    stage_s = time.perf_counter() - t0
    fields, cat = to_device(*di.arrays, dev)
    S = g_bucket * di.cfg.slots_per_block
    print(f"dispatch shape: F={len(frames)} groups={g_bucket} S={S} "
          f"pack30={di.cfg.pack30}")

    def words():
        t = _gather_tiles(fields, cat, di.cfg)
        return _tiles_to_words(fields, *t, di.cfg)

    w0, zs, wc, valid = words()
    k1_ops, k1_counts = sc.shift_compact_ops(w0, zs, wc, valid)
    ref_ops, ref_counts = sc.shift_compact_ops_reference(w0, zs, wc, valid)
    torch.cuda.synchronize()
    check(torch.equal(k1_counts, ref_counts), "K1 counts differ at the flagship")
    k1_err = prefix_err(k1_ops, ref_ops, ref_counts.tolist())
    check(k1_err == 0, f"K1 differs from plain at the flagship ({k1_err})")

    runs = {
        "plain": lambda: sc.shift_compact_ops_reference(w0, zs, wc, valid),
        "k1": lambda: sc._shift_compact_cuda(w0, zs, wc, valid),
        "words": words,
        "dispatch": lambda: reconstruct_batch_pretiled_packed(fields, cat, di.cfg),
    }
    ms = {name: [] for name in runs}
    for pair in (("plain", "k1"), ("words", "dispatch")):
        for name in pair + pair[::-1]:  # in turns
            ms[name].append(event_ms(runs[name]))
    ms_words = statistics.median(ms["words"])
    ms_dispatch = statistics.median(ms["dispatch"])
    ops, counts_t = reconstruct_batch_pretiled_packed(fields, cat, di.cfg)
    counts = counts_t.cpu().numpy()
    ms_fetch = event_ms(
        lambda: P._fetch_prefixes_packed(ops, counts, color_mode="yuv10"))

    from tpu_vpcc.utils.stats import GofStats

    list(P._reconstruct_gof_device(gof, dev))  # warm
    reps = 5
    stages = GofStats()
    t0 = time.perf_counter()
    for _ in range(reps):
        list(P._reconstruct_gof_device(gof, dev, stats=stages))
    e2e_s = (time.perf_counter() - t0) / reps
    pts = sum(n_points[:len(frames)])

    # the Decoder's throughput on 8 GOFs, one and two in flight, in turns
    stream = gofs * 4
    dec_s = {1: [], 2: []}
    for depth in (1, 2, 2, 1):
        t0 = time.perf_counter()
        n = len(decode_gofs(stream, depth))
        dec_s[depth].append(time.perf_counter() - t0)
        check(n == len(stream) * len(frames), f"Decoder emitted {n} frames")
    n_dec = len(stream) * len(frames)
    print(f"Decoder.start_gofs (host clock, {len(stream)} GOFs, {n_dec} "
          f"frames, {nvidia_smi_line()}): " + "; ".join(
              f"pipeline_gofs={d}: runs {[round(s, 4) for s in v]} s, "
              f"{n_dec / statistics.median(v):.1f} frames/s"
              for d, v in dec_s.items()))
    k1_ms = statistics.median(ms["k1"])
    plain_ms = statistics.median(ms["plain"])
    print(f"timings (median CUDA events, {nvidia_smi_line()}): "
          f"K1 {k1_ms:.4f} ms vs plain {plain_ms:.4f} ms "
          f"(runs k1 {ms['k1']}, plain {ms['plain']}); gather+words "
          f"{ms_words:.4f} ms (runs {ms['words']}); whole dispatch "
          f"{ms_dispatch:.4f} ms (runs {ms['dispatch']}); "
          f"fetch {ms_fetch:.4f} ms; host staging {stage_s * 1e3:.1f} ms")
    print(f"device stage end to end (host clock, {len(frames)} frames, "
          f"{pts} points): {e2e_s * 1e3:.1f} ms per GOF = "
          f"{len(frames) / e2e_s:.1f} frames/s, {pts / e2e_s / 1e6:.2f} "
          f"Mpoints/s")
    print("device stage split (host clock, ms per GOF): " + ", ".join(
        f"{k} {v * 1e3 / reps:.2f}"
        for k, v in sorted(stages.stage_seconds.items())
    ))
    print(f"peak device memory over the script: "
          f"{torch.cuda.max_memory_allocated() / 2 ** 20:.0f} MiB")
    return {
        "name": "shift_compact",
        "route": "cuda",
        "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        "launches": launches,
        "max_abs_err": k1_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
    }


def phase_stream():
    from tpu_vpcc.utils.ply import format_ply
    from tpu_vpcc_torch.ops import shift_compact as sc
    from tpu_vpcc_torch.runtime.pipeline import Decoder, Params

    def decode(**kw):
        dec = Decoder(Params(STREAM, **kw))
        dec.start()
        return [format_ply(f) for f in dec]

    before = sc.launches
    dev = decode(device="cuda")
    check(sc.launches > before, "the stream decode launched K1 no time")
    ora = decode(use_device=False, device="cpu")
    check(len(dev) == len(ora) and len(dev) > 0,
          f"frame counts differ: {len(dev)} vs {len(ora)}")
    for k, (a, b) in enumerate(zip(dev, ora)):
        check(a == b, f"stream frame {k}: PLY differs from the oracle's")
    print(f"stream phase: {len(dev)} frames of {STREAM.name} decoded on the "
          f"card, PLY bytes equal to the oracle path")


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"FAIL: torch is not importable ({e})", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    if not (ROOT / "tpu_vpcc_torch").is_dir():
        print("FAIL: run chip_smoke.py from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        bridge = phase_build()
        frame_sets, gofs, S_flag = flagship_inputs()
        phase_k1(S_flag)
        k1 = phase_flagship(frame_sets, gofs)
        if bridge:
            phase_stream()
        else:
            print("stream phase: not run: the host video bridge cannot load "
                  "on this machine (phase 1)")
        check("jax" not in sys.modules, "jax was imported")
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [k1]}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
