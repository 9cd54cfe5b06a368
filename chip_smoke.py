#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tpu_vpcc_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and the CUDA toolkit (nvcc). Phases, each of which exits non-zero on
failure:

  1. device and build: the card's name and power limit, the builds of
     the six kernel libraries (K1 and K1F in ``shift_compact.cu``, K2W
     in ``wide_words.cu``, K3 in ``cursor_compact.cu``, the probes P1-P12
     of K4-K6 in ``probes.cu``, K5 in ``pack_planes.cu``, the smoothing
     kernels S1 and S2 in ``grid_smooth.cu``; one nvcc each, started
     together) with
     nvcc's ``-Xptxas -v`` lines, and whether the host video bridge
     (libavcodec) loads (phase 6 does not use it);
  2. K1 against its plain PyTorch version on the card: densities 0, 0.3,
     0.7, 1 and all-D1-invalid, F = 1, 2 and 3, pack30 and split
     operands, at the flagship's extent and those that
     ``shift_compact.edge_extents`` derives from the kernel's tile (one
     tile, one tile plus one pixel, three tiles with the last partial,
     33 tiles, a ragged one).
     Counts equal, prefixes byte-equal, and two calls on one input
     byte-equal;
  2b. K1F against its plain version: densities 0, 0.3, 0.7 and 1, F = 1,
     2 and 3, at the same edge extents in slots. Counts equal, prefixes
     byte-equal, two calls byte-equal;
  2c. K5, the device pack, against its plain version: its ``-Xptxas -v``
     registers and shared memory per instantiation; the first flagship
     GOF's own block-tiled planes and swap mask, the CPU test's grid
     (``ops.pack.CHECK_GRID``: one and two maps, chroma shift 0 and 1,
     five block edges and occupancy precisions, F = 1 and 3, swap
     densities 0, 0.3 and 1, on random samples over the full 10-bit
     range; then ``CHECK_PATHS``, the kernel's other paths: other and
     odd edges, prec = res, two maps' planes with one read, block counts
     no multiple of a CTA's), one block of one frame, 324 words (no
     multiple of a 256-thread CTA), and frames 1-2 of a three-frame input
     (every plane past frame 0, the swap mask on an odd byte); each case
     twice, the whole cat byte-equal; then K5's times (below) at the
     flagship GOF and at the batcher's 12-frame narrow merged input;
  3. the flagship main path on the card: two GOFs of two synthetic
     1280^2 frames each through ``Decoder.start_gofs`` with both GOFs in
     flight (group tables, staging of the block-tiled planes, K5 packing
     the cat, gather + words + K1 on the card, prefix fetch with yuv10 ->
     rgb8 on the card, PointSet3), each frame byte-equal to the numpy
     oracle, with the K1 and K5 launch counters read around that run
     (K5's equal to K1's); then K1's times (below), CUDA-event timings of
     the other stages, the H2D of the planes against the host cat's, and,
     with the device pack and the host pack (``staged_as``) in turns, the host staging, the stage split and the Decoder's
     throughput with one and two GOFs in flight, every frame of the
     host-pack runs byte-equal to the first run's;
  4. K2W against its plain version at the flagship dispatch shape, on
     the first flagship GOF's staged fields and cat: the plain wide
     layout, 45-degree views (random G_PLANE in 0..3), a trailing-layer
     pass (drop_map0), relative D1 and one map. Words and validity
     byte-equal;
  5. the wide flagship through ``Decoder.start_gofs``, both GOFs in
     flight: the first GOF's two 1280^2 frames with geometry and colour
     smoothing, and two frames (seeds 4-5) with a third of their patches
     on 45-degree views. Every frame byte-equal to the numpy oracle
     (``_reconstruct_gof_oracle``), the K2W, K1F, K5 and smoothing
     launch counters read around the run (K5's equal to K2W's; the
     smoothing kernels three a pass, two passes a dispatch of the
     smoothed GOF), and the smoothed frames differ from phase 3's
     unsmoothed decode of the same frames in a position and a colour;
     then, on the smoothing GOF's dispatch's own slot arrays, the
     smoothing kernels' grids and outputs of both passes byte-equal to
     the plain versions' (``kernel_times.smooth_cases``); the times of
     K2W, K1F, and each pass's S1 (the grids' initialisation and
     ``smooth_stats_kernel``) and S2 (``smooth_apply_kernel``) (below),
     CUDA-event timings of the smoothing (the words' unpack, both passes
     on the kernels, the repack), of both passes on the kernels and in
     their plain versions, of the wide dispatch, the fetch and the host
     staging, and the Decoder's frames/s with one and two GOFs in
     flight;
  5b. the gather fallback through ``Decoder.start_gofs``, two GOFs in
     flight: GOF R (two 1280^2 frames, seeds 6-7, with a third of their
     patches turned to rotated orientations), GOF W (phase 3's first
     GOF's frames with 12-bit geometry: samples x4, geo_shift 4) and GOF
     RS (GOF R with geometry and colour smoothing). Every frame
     byte-equal to the numpy oracle, GOF W's also to phase 3's 10-bit
     decode, the rotated patches' own points counted by a dispatch of
     their groups alone, smoothing's effect on GOF RS, K1F's launch
     counter advanced by exactly the gather dispatches, the smoothing
     kernels' by three a pass of GOF RS's dispatches, and K1's, K2W's
     and K5's not at all; the colour conversion on 16-bit samples equal on
     the card and the CPU; then K1F's times at GOF R's dispatch shape
     (below), CUDA-event timings of the slot math of each GOF, the
     dispatch and the fetch, the host stage split, the Decoder's
     frames/s with one and two GOFs in flight and the phase's peak
     device memory;
  6. the streams of the committed video store
     (``tpu_vpcc_torch/tools/video_store.py``, ``tests/data/video_store``):
     the HEVC decode alone is served from the store's frames (this
     machine has no libavcodec); V3C parse, atlas, group tables,
     staging, the kernels, smoothing, the host tails and PLY run as
     they do with the bridge. Each of the 23 entries (every fixture
     family of ``tests/test_torch_e2e.py``, the 1280^2 lossy
     ``flagship_1280_q8``, the stream of ``examples/roundtrip.py`` and
     the graft dry run's streams at 1-4 'data' rows)
     through ``runtime.cli.main`` in this process
     with ``--device cuda`` and its flags: exit 0, every file byte-equal
     to the port's ``--oracle`` CLI on the CPU from the same store and
     to the manifest's SHA-256, and the K1, K2W and K1F launch counters,
     set to 0 before each run, equal to the manifest's, K5's to the
     manifest's K1 and K2W (0 for an entry with quantized patch extents,
     which the host packs). Then the verify
     stream with ``-d`` and ``--keep-intermediate-files`` on the default
     device, and one several-``-i`` run over ``verify``, ``atlas_hash``
     and ``smoothing`` whose per-stream directories equal the
     single-stream outputs. Last, ``flagship_1280_q8`` repeated to four
     GOFs through ``Decoder(Params(stream, device="cuda"))`` with one
     and two GOFs in flight, with the device pack and the host pack, in
     turns: frames equal to the manifest,
     frames/s by host clock and the ``DecodeStats`` stage split (parse,
     the store lookup, tables, staging, dispatch, fetch, PointSet3);
 6b. the port's encode side: with the video store in place of libx265
     (``served_encode``; this machine has no libx265 either), the port's
     ``build_fixture_stream`` rebuilds ``flagship_1280_q8`` (from
     ``video_store.flagship_frames``) and ``roundtrip`` (the scene of
     ``tpu_vpcc_torch.examples.roundtrip``), each byte-equal to its
     committed stream, with the host seconds of each rebuild; then, under
     ``served``, the rebuilt flagship through ``Decoder`` on the card
     with one and with two GOFs in flight and the roundtrip example's
     ``main(..., device="cuda")``: every frame byte-equal to phase 6's
     oracle files and the manifest's SHA-256, K1, K2W, K1F and K5
     launched as the manifest says; the rebuilt flagship repeated to
     four GOFs, frames/s beside the card's name and power limit. The
     native video bridge's loader is never called;
  7. K3, the cursor compaction experiment's kernel, against its plain
     version: the two-frame flagship wide extent (448 chunks) and two odd
     chunk counts at densities 0, 0.3, 0.7 and 1, then the first
     flagship GOF's own wide words. Counts equal, covered windows
     byte-equal; K3's times (below) and K1F's device-only time on those
     words. Then the experiment's entry point
     (``tpu_vpcc_torch.tools.compaction_experiment``) at batch 2, with
     the K3 launch counter read around it: its per-variant ms per frame,
     ``ceiling_ms``, ``floor_ms`` and the decision rule's verdict;
  8. the three probe tools (``tpu_vpcc_torch.tools.hopper_probe*``)
     through their entry points, with the launch counters of P1-P12 read
     around them; then every probe's kernel against its plain version and
     the probe's numpy ``want`` at the probe's own shape (single-call
     times of both), P10 and P11 at ragged widths, single rows and row
     counts off the row tile (``hopper_probe3.EDGE_SHAPES``), P4, P5 and
     P8 at their edge shapes (``kernel_times.edge_cases``: step counts,
     widths and offset orders; byte counts around P5's vector, block
     and wave of blocks, in both directions; segment sizes and counts), each
     run twice and required byte-equal, and every probe at about 64 MiB per
     operand with its times (below). P4's and P8's kernels are held
     against their plain versions over the whole output, uncovered rows
     and segment tails included;
  9. the multi-stream batcher (``parallel.batcher``'s wave loop, fed
     prepared GOFs) on the card: 8 streams of two GOFs (streams 0-5
     phase 3's narrow GOFs, stream 6 phase 5's smoothed and 45-degree
     GOFs, stream 7 phase 5b's GOFs R and W), every frame byte-equal to
     its decode in phase 3, 5 or 5b; a spy on the dispatches shows the
     first wave's 12 narrow frames merged into one input and dispatched
     as 6 chunks of ``DEVICE_BATCH``, and the K1, K2W and K1F launch
     counters advance by exactly the narrow, wide and gather chunks, K5's
     by the narrow and wide ones. Then
     the aggregate frames/s beside ``Decoder.start_gofs`` over the same
     16 GOFs (two in flight), the batcher's stage split, its peak device
     memory, and the 12-frame narrow merged input dispatched at chunks
     of 2, 4, 6 and 12 frames (CUDA events for the dispatch with its
     H2D, host clock for the whole);
 10. the colour proof: ``tools.verify_color_exact`` runs
     ``rgb8_from_yuv16`` against the f64 chain over all 2^30 10-bit
     (y, u, v) triples on the card, 0 mismatches required;
 11. the device mesh (``parallel.mesh``, ``parallel.spatial``): phase 3's
     narrow GOFs, phase 5's smoothed and 45-degree GOFs and phase 5b's
     GOF R through ``Decoder.start_gofs`` with ``Params(mesh=...)`` on
     the layouts (data 1, space 4) and (2, 2) with ``cuda:0`` named four
     times, and, on a machine with four cards, (1, 4), (2, 2) and (4, 1)
     over four distinct cards. Every frame byte-equal to its meshless
     decode; the K1, K2W and K1F launch counters, set to 0 before each
     decode, read shards x chunks on the tiled GOFs, K5's distinct
     devices of each data row x chunks, the smoothing kernels' three a
     pass x shards x the smoothed GOF's chunks, and GOF R takes the
     reference's counted fallback (``mesh_fallback_dispatches``, one
     K1F launch per chunk); smoothing moved the same points as in phase
     5. ``reconstruct_gof_spatial`` and ``reconstruct_batch_data_parallel``
     at GOF R's shape stitch to the unsharded gather. Then the host clock
     of a narrow and a wide dispatch with and without the mesh, the
     times and bytes of ``combine_stats`` on the smoothing GOF's grids,
     the peak memory of each device and the phase's seconds;
 12. the graft entry (``tpu_vpcc_torch.graft_entry``) on the card, the
     native video bridge refused: ``entry("cuda")`` (K5, then the narrow
     dispatch with K1 at 256^2) against ``entry("cpu")``'s plain
     versions, counts equal and compacted prefixes byte-equal, K5 and K1
     launched once each; then ``dryrun_multichip(n, "cuda:0")`` for n =
     1, 2, 3, 4 and 8 and, on a machine with several cards,
     ``dryrun_multichip(device_count, "cuda")``: each dry run's sharded
     steps agree, and the reference's dry-run stream, authored by the
     port's ``build_fixture_stream`` with its HEVC encode and decode
     served from the video store, decodes through the mesh to one frame
     per 'data' row, each with points, byte-equal to the oracle and the
     store entry's digests; K5, K2W, K1F and K1 each launched. One line
     gives each call's seconds and the store's served encodes and
     lookups.

A kernel's times (``tools.kernel_times.measure``): its device-only time
(the work the card ran, from a whole ``torch.profiler`` trace of 20
back-to-back calls), its queued time (the same calls behind a spin
kernel, CUDA events) and single-call CUDA-event window, the plain
version's device-only and single-call times, the device-only time of one
PyTorch call that computes the same function where there is one
(``library_ms``), the bytes the function must move and the bound they
give at 3.35 TB/s, the share of that bound, and the kernel's device-only
time split by record name (each kernel and memset of one call); kernel,
library call and plain version in turns. The run fails where no whole
trace is taken, or a device-only time lies below its bound or above its
queued time.

The last line is ``{"ok": true, "device": {...}}``; before it come one
JSON line of per-kernel results and the ``nvidia-smi`` name and power
limit line.

    python3 chip_smoke.py --mesh-only

runs phase 1's builds, the meshless decodes of the GOFs phase 11 uses
(without their oracle checks and timings, which the full run makes),
phases 11 and 12, then the ``nvidia-smi`` and ``ok`` lines: the run for
a machine with four cards.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
#: the video store's 1280^2 lossy stream, timed in phase 6
STREAM_FLAGSHIP = "flagship_1280_q8"
#: GOFs of the timed stream (its one GOF repeated)
STREAM_GOFS = 4
#: the store's entries that phase 6b rebuilds with the port's encoder
REBUILT = (STREAM_FLAGSHIP, "roundtrip")
#: what each ``DecodeStats`` stage of a stream decode is
STAGE_LABELS = {
    "video_decode": "video_decode (store lookup)",
    "recon_tables": "recon_tables (tables)",
    "recon_stage": "recon_stage (staging)",
    "recon_dispatch": "recon_dispatch (dispatch)",
    "recon_fetch": "recon_fetch (fetch)",
    "recon_emit": "recon_emit (PointSet3)",
}
K1_SOURCE = "tpu_vpcc_torch/csrc/shift_compact.cu"
K1_REPLACES = "tpu_vpcc/ops/shift_compact.py:127"
K1F_REPLACES = "tpu_vpcc/ops/shift_compact.py:528"
K5_SOURCE = "tpu_vpcc_torch/csrc/pack_planes.cu"
#: the XLA pack of the reference's default off the TPU (no Pallas kernel)
K5_REPLACES = "tpu_vpcc/ops/tiled.py:1006"
K2W_SOURCE = "tpu_vpcc_torch/csrc/wide_words.cu"
K2W_REPLACES = "tpu_vpcc/ops/pallas_kernels.py:38"
K3_SOURCE = "tpu_vpcc_torch/csrc/cursor_compact.cu"
K3_REPLACES = "tools/compaction_experiment.py:515"
S_SOURCE = "tpu_vpcc_torch/csrc/grid_smooth.cu"
#: each half of a smoothing pass, geometry and colour: the XLA scatters
#: of the reference's flat smoothing (no Pallas kernel) and its apply
S_REPLACES = {
    "geometry stats": "tpu_vpcc/ops/smoothing.py:177",
    "geometry apply": "tpu_vpcc/ops/smoothing.py:62",
    "colour stats": "tpu_vpcc/ops/smoothing.py:518",
    "colour apply": "tpu_vpcc/ops/smoothing.py:249",
}
PROBES_SOURCE = "tpu_vpcc_torch/csrc/probes.cu"
#: each probe's Pallas kernel
PROBE_REPLACES = {
    "P1": "tools/pallas_probe.py:51",
    "P2": "tools/pallas_probe.py:83",
    "P3": "tools/pallas_probe.py:111",
    "P4": "tools/pallas_probe.py:172",
    "P5": "tools/pallas_probe2.py:56",
    "P6": "tools/pallas_probe2.py:95",
    "P7": "tools/pallas_probe2.py:119",
    "P8": "tools/pallas_probe2.py:166",
    "P9": "tools/pallas_probe3.py:54",
    "P10": "tools/pallas_probe3.py:63",
    "P11": "tools/pallas_probe3.py:79",
    "P12": "tools/pallas_probe3.py:94",
}
#: each probe's C entry point in probes.cu
PROBE_ENTRIES = {
    "P1": "probe_roll", "P2": "probe_flat_shift", "P3": "probe_interleave",
    "P4": "probe_dyn_write", "P5": "probe_reinterpret",
    "P6": "probe_flat_shift", "P7": "probe_roll",
    "P8": "probe_mini_compact", "P9": "probe_interleave",
    "P10": "probe_tile_concat", "P11": "probe_reverse_lanes",
    "P12": "probe_interleave",
}
KERNEL_LIBS = ("shift_compact", "wide_words", "cursor_compact", "probes",
               "pack_planes", "grid_smooth")
#: the two stagings of the tiled paths (see :func:`staged_as`)
STAGINGS = ("device pack", "host pack")


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def smooth_launches(gof, dispatches: int, shards: int = 1) -> int:
    """The launches of the smoothing kernels that ``dispatches`` dispatches
    of ``gof``, each on ``shards`` shards, make: three a pass (the grids'
    initialisation, the statistics, the apply) on each shard, a pass for
    geometry and one for colour smoothing (none on RGB colour)."""
    passes = (gof.geo_smoothing is not None) + (
        gof.attr_smoothing is not None and not gof.attr_is_rgb444)
    check(not (passes and gof.sec_attrs),
          "a smoothed GOF with secondary attributes: its smoothing "
          "launches are not counted here")
    return 3 * passes * dispatches * shards


@contextmanager
def staged_as(name: str, dispatches: bool = True):
    """The tiled paths' staging while open: the "device pack", the port's
    own, or the "host pack", for which every dispatch that ``pipeline``
    and ``batcher`` stage for the device pack is staged again as the
    port stages quantized extents (``ops.tiled.stage_cat_inputs``: the
    cat packed on the host from the same planes). When the block
    ``dispatches``, K5 must have launched under the device pack and not
    once under the host pack."""
    from dataclasses import replace

    from tpu_vpcc_torch.ops import pack
    from tpu_vpcc_torch.ops.tiled import stage_cat_inputs
    from tpu_vpcc_torch.parallel import batcher
    from tpu_vpcc_torch.runtime import pipeline as P

    check(name in STAGINGS, f"no staging {name!r}")
    real = P._gof_device_inputs
    restaged = []

    def host_pack(*args, **kw):
        di = real(*args, **kw)
        if di.staging != "device_pack":
            return di
        fields, *planes, _swap = di.arrays
        arrays, cfg = stage_cat_inputs(fields, *planes, di.cfg)
        restaged.append(di.n_frames)
        return replace(di, cfg=cfg, staging="host_pack", arrays=arrays)

    before = pack.launches
    if name == "host pack":
        P._gof_device_inputs = batcher._gof_device_inputs = host_pack
    try:
        yield
    finally:
        P._gof_device_inputs = batcher._gof_device_inputs = real
    launched = pack.launches - before
    if name == "host pack":
        check(restaged, "host pack: no dispatch was staged by it")
    if dispatches:
        check((launched == 0) == (name == "host pack"),
              f"{name}: K5 launched {launched} times")


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
    from tpu_vpcc_torch.ops import cursor_compact as k3
    from tpu_vpcc_torch.ops import pack, payload, probes
    from tpu_vpcc_torch.ops import shift_compact as sc
    from tpu_vpcc_torch.ops import smoothing as S
    from tpu_vpcc_torch.tools.kernel_times import nvidia_smi_line

    print(f"device: {torch.cuda.get_device_name(0)}")
    print(f"nvidia-smi: {nvidia_smi_line()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(KERNEL_LIBS)) as pool:
        list(pool.map(_build.build, KERNEL_LIBS))
    for mod in (sc, payload, k3, probes, pack, S):
        mod._load()
    print(f"kernel builds ({', '.join(KERNEL_LIBS)}, in parallel): "
          f"{time.perf_counter() - t0:.2f} s")
    for name in KERNEL_LIBS:
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  {name}: {line.strip()}")
    from tpu_vpcc_torch.video import codec

    try:
        codec._load()
    except (subprocess.CalledProcessError, OSError) as e:
        detail = getattr(e, "stderr", "") or str(e)
        reason = " | ".join(detail.strip().splitlines()[-3:])
        print(f"video bridge: cannot load ({type(e).__name__}: {reason}); "
              f"phase 6 serves the HEVC decode from the video store")
        return
    print("video bridge: loads; phase 6 serves the HEVC decode from the "
          "video store all the same")


def _same_twice(run, check_fn, what):
    """Run the kernel twice on one input: counts and prefixes byte-equal
    to the plain version (``check_fn``) and to each other."""
    import torch

    got, n_got = run()
    got2, n_got2 = run()
    ref, n_ref = check_fn()
    torch.cuda.synchronize()
    check(torch.equal(n_got, n_ref),
          f"{what} counts {n_got.tolist()} != plain {n_ref.tolist()}")
    counts = n_ref.tolist()
    err = prefix_err(got, ref, counts)
    check(err == 0, f"{what} prefix differs from plain (max abs err {err})")
    check(torch.equal(n_got2, n_got) and prefix_err(got2, got, counts) == 0,
          f"{what}: two calls on one input differ")
    return err


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
    return _same_twice(
        lambda: sc.shift_compact_ops(w0, zs, wc, valid),
        lambda: sc.shift_compact_ops_reference(w0, zs, wc, valid),
        f"K1 (F={F} S={S} density={density} pack30={pack30} "
        f"all-D1-invalid={d1_invalid})")


def phase_k1(S_flag: int):
    import torch

    from tpu_vpcc_torch.ops import shift_compact as sc

    gen = torch.Generator(device="cuda").manual_seed(1234)
    tile = sc.tile_items()
    n = 0
    for name, half in {"flagship": S_flag // 2,
                       **sc.edge_extents(tile)}.items():
        for F in (1, 2, 3):
            for pack30 in (True, False):
                for density in (0.0, 0.3, 0.7, 1.0):
                    _k1_case(F, 2 * half, density, pack30, False, gen)
                _k1_case(F, 2 * half, 0.7, pack30, True, gen)
                n += 5
        print(f"K1 vs plain, {name} (S={2 * half}, {-(-half // tile)} "
              f"tiles of {tile} pixels): F=1-3, pack30 and split, densities "
              f"0-1 and all-D1-invalid: counts and prefixes equal, two "
              f"calls byte-equal")
    print(f"phase 2: {n} K1 cases byte-equal to the plain version")


def _k1f_case(F, S, density, gen):
    import torch

    from tpu_vpcc_torch.ops import shift_compact as sc

    dev = torch.device("cuda")
    lo, hi = -(2 ** 31), 2 ** 31 - 1
    ops = [
        torch.randint(lo, hi, (F, S), dtype=torch.int32, device=dev,
                      generator=gen)
        for _ in range(3)
    ]
    valid = torch.rand((F, S), device=dev, generator=gen) < density
    return _same_twice(
        lambda: sc.shift_compact_full(ops, valid),
        lambda: sc.shift_compact_full_reference(ops, valid),
        f"K1F (F={F} S={S} density={density})")


def phase_k1f(S_flag: int) -> int:
    """K1F against its plain version; returns the max abs error."""
    import torch

    from tpu_vpcc_torch.ops import shift_compact as sc

    gen = torch.Generator(device="cuda").manual_seed(4321)
    tile = sc.tile_items()
    n, err = 0, 0
    for name, S in {"flagship": S_flag, **sc.edge_extents(tile)}.items():
        for F in (1, 2, 3):
            for density in (0.0, 0.3, 0.7, 1.0):
                err = max(err, _k1f_case(F, S, density, gen))
                n += 1
        print(f"K1F vs plain, {name} (S={S}, {-(-S // tile)} tiles of "
              f"{tile} slots): F=1-3, densities 0-1: counts and prefixes "
              f"equal, two calls byte-equal")
    print(f"phase 2b: {n} K1F cases byte-equal to the plain version")
    return err


def _k5_case(planes, cfg, what) -> int:
    """K5 twice on one input: each whole cat byte-equal to the plain
    version's. Returns the max abs error (0)."""
    import torch

    from tpu_vpcc_torch.ops import pack

    got = pack.pack_cat(*planes, cfg)
    again = pack.pack_cat(*planes, cfg)
    want = pack.pack_cat_plain(*planes, cfg)
    torch.cuda.synchronize()
    err = words_err((got,), (want,))
    check(torch.equal(got, want), f"K5 differs from plain ({what}, max abs "
                                  f"err {err})")
    check(torch.equal(again, got), f"K5: two calls on one input differ "
                                   f"({what})")
    return err


def k5_ptxas_lines(log: str):
    """K5's ``-Xptxas -v`` report, a line per kernel instantiation: its
    block edge (0: the generic one), registers, static shared memory and
    spills (ptxas reports an entry's spills before its registers)."""
    import re

    out, name, spills = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            args = re.findall(r"ILi(\d+)E", m.group(1))
            name, spills = f"pack_tiles_kernel<{', '.join(args)}>", ""
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name and not spills:
            spills = f"spills {m.group(1)} / {m.group(2)} B"
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {m.group(2)} B "
                       f"static shared memory, {spills or 'no spill line'}")
            name = None
    return out


def phase_k5(gof):
    """Phase 2c: K5 against its plain version on the card (see the module
    note), then its times at the first flagship GOF's planes and at the
    batcher's 12-frame narrow merged input. Returns K5's kernels entry
    (the flagship GOF's) without its launches (phase 3 counts them)."""
    import torch

    from tpu_vpcc_torch.ops import _build, pack
    from tpu_vpcc_torch.ops.tiled import planes_to_device
    from tpu_vpcc_torch.parallel import batcher as B
    from tpu_vpcc_torch.runtime import pipeline as P
    from tpu_vpcc_torch.tools.kernel_times import (
        PACK_NO_LIBRARY,
        measured_line,
        nvidia_smi_line,
        pack_bytes,
        pack_config,
        seeded_planes,
        time_pack,
    )

    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    ptxas = k5_ptxas_lines(_build.build_logs.get("pack_planes", ""))
    for line in ptxas or ["no -Xptxas -v report: the library was built by "
                          "an earlier process"]:
        print(f"K5 ptxas: {line}")
    cfg, tables, g_bucket = P._gof_tables_and_bucket(gof)
    di = P._gof_device_inputs(gof, gof.metas, (cfg, tables), g_bucket)
    check(di.staging == "device_pack",
          f"the flagship GOF is staged as {di.staging!r}")
    dev = torch.device("cuda")
    _, *planes = planes_to_device(*di.arrays, dev)
    err = _k5_case(planes, di.cfg, "flagship GOF")
    F, nb = planes[0].shape[:2]
    print(f"K5 vs plain, the first flagship GOF's planes: F={F} nb={nb} "
          f"res={di.cfg.occupancy_resolution}, {int(planes[-1].sum())} "
          f"blocks transposed: whole cats equal, two calls byte-equal")
    gen = torch.Generator(device="cuda").manual_seed(55)
    cases = {f"grid {g}": g for g in pack.CHECK_GRID}
    cases["one block of one frame"] = (2, 1, 16, 4, 1, 1.0, 2, 1)
    cases["324 words, no multiple of a 256-thread CTA"] = (
        1, 1, 6, 3, 1, 0.5, 1, 3)
    for what, (mc, cs, res, prec, F_, density, M, nb_) in cases.items():
        c = pack_config(mc, cs, res, prec, nb_)
        err = max(err, _k5_case(
            seeded_planes(mc, cs, res, prec, F_, density, nb_, gen, M), c,
            what))
    # frames 1-2 of three, nb odd: every plane starts past frame 0, the
    # swap mask on an odd byte
    c = pack_config(2, 1, 16, 4, 7)
    whole = seeded_planes(2, 1, 16, 4, 3, 0.3, 7, gen)
    sliced = [t[1:] for t in whole]
    check(sliced[-1].data_ptr() % 2 == 1, "the sliced swap mask is aligned")
    err = max(err, _k5_case(sliced, c, "frames 1-2 of 3, nb 7"))
    check(torch.equal(pack.pack_cat(*sliced, c),
                      pack.pack_cat_plain(*whole, c)[1:]),
          "K5 on frames 1-2 differs from frames 1-2 of the whole cat")
    print(f"K5 vs plain, the CPU test's grid ({len(pack.CHECK_GRID)} cases: "
          f"maps 1-2, chroma shift 0-1, (res, prec) in (16, 4), (16, 1), "
          f"(8, 2), (16, 16), (32, 4), F 1 and 3, swap densities 0, 0.3, "
          f"1, 5 blocks a frame; then {len(pack.CHECK_PATHS)} cases of the "
          f"kernel's other paths: edges 3-128, odd edges, prec = res, two "
          f"maps' planes with one read, 13 and 37 blocks a frame), one block "
          f"of one frame, 324 words, frames 1-2 of 3 sliced at an odd "
          f"offset: whole cats equal, two calls byte-equal")
    print(f"phase 2c: {len(cases) + 2} K5 cases byte-equal to the plain "
          f"version, each twice ({time.perf_counter() - t0:.1f} s)")
    occ, geo0, _, ay, au, av, swap = planes
    split = {"occupancy": occ, "geometry": geo0, "luma": ay[:, 0],
             "chroma": au[:, 0], "swap mask": swap}
    maps = 2 if di.cfg.map_count > 1 else 1
    reads = {k: t.numel() * t.element_size()
             * (1 if k in ("occupancy", "swap mask") else
                2 * maps if k == "chroma" else maps)
             for k, t in split.items()}
    nbytes = pack_bytes(*planes, di.cfg)
    k5 = time_pack(planes, di.cfg)
    print(measured_line("K5 at the first flagship GOF's planes", k5, smi))
    print(f"  K5 library call: {PACK_NO_LIBRARY}")
    print("K5 bytes: reads " + ", ".join(f"{k} {v:,}" for k, v in
                                         reads.items())
          + f"; writes {nbytes - sum(reads.values()):,}; total {nbytes:,}")
    merged = B._concat_inputs([di] * 6)
    _, *wave = planes_to_device(*merged.arrays, dev)
    _k5_case(wave, di.cfg, "the batcher's 12-frame merged input")
    print(measured_line(
        f"K5 at the batcher's 12-frame narrow merged input (phase 9's first "
        f"wave, packed whole at chunk 12; F={wave[0].shape[0]})",
        time_pack(wave, di.cfg), smi))
    return dict(k5, name="pack_planes", route="cuda", source=K5_SOURCE,
                replaces=K5_REPLACES, max_abs_err=err)


def oracle_frame(sf, frames):
    from tpu_vpcc_torch.reconstruction.oracle import (
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
    """The flagship config, two decoded GOFs of two synthetic 1280^2
    flagship frames each (frame seeds 0-1 and 2-3), and the slot extent
    S of the first GOF's dispatch."""
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
    return fcfg, frame_sets, gofs, g_bucket * cfg.slots_per_block


def frames_45(fcfg):
    """Phase 5's 45-degree frames: seeds 4-5, a third of the patches on
    45-degree views."""
    from tpu_vpcc_torch.models.flagship import example_frames

    return example_frames(fcfg, seed=4, views45=1 / 3)


def frames_rotated(fcfg):
    """Phase 5b's GOF R frames: seeds 6-7, a third of the patches turned
    to rotated orientations."""
    from tpu_vpcc_torch.models.flagship import example_frames

    return example_frames(fcfg, seed=6, rotated=1 / 3)


def mesh_only_inputs(fcfg, frame_sets, gofs):
    """``--mesh-only``: the GOFs of phases 3, 5 and 5b that phase 11
    decodes (the same seeds and options) and their meshless decodes on
    the card, which the full run holds equal to the oracle."""
    from tpu_vpcc_torch.models.flagship import (
        ATTR_SMOOTHING,
        GEO_SMOOTHING,
        example_gof,
    )

    wide_gofs = [example_gof(fcfg, frame_sets[0], geo_smoothing=GEO_SMOOTHING,
                             attr_smoothing=ATTR_SMOOTHING),
                 example_gof(fcfg, frames_45(fcfg))]
    gather_gofs = [example_gof(fcfg, frames_rotated(fcfg))]
    return (wide_gofs, gather_gofs,
            *(decode_gofs(g, depth=2) for g in (gofs, wide_gofs, gather_gofs)))


def decode_gofs(gofs, depth: int):
    """The public entry: ``Decoder.start_gofs`` on the card with
    ``depth`` GOFs reconstructing at once; the frames, in order."""
    from tpu_vpcc_torch.runtime.pipeline import Decoder, Params

    dec = Decoder(Params(device="cuda", pipeline_gofs=depth))
    dec.start_gofs(gofs)
    return list(dec)


def _same_frame_lists(got, want) -> bool:
    import numpy as np

    return len(got) == len(want) and all(
        np.array_equal(a.positions, b.positions)
        and np.array_equal(a.colors, b.colors) for a, b in zip(got, want))


def phase_flagship(frame_sets, gofs):
    import numpy as np
    import torch

    from tpu_vpcc_torch.ops import pack
    from tpu_vpcc_torch.ops import shift_compact as sc
    from tpu_vpcc_torch.ops.tiled import (
        _gather_tiles,
        _tiles_to_words,
        planes_to_device,
        reconstruct_batch_pretiled_packed,
        to_device,
    )
    from tpu_vpcc_torch.runtime import pipeline as P
    from tpu_vpcc_torch.tools.kernel_times import (
        event_ms,
        measure,
        measured_line,
        nvidia_smi_line,
    )

    dev = torch.device("cuda")

    # the main path, counted: Decoder with two GOFs in flight (tables,
    # staging, dispatch, fetch, PointSet3 on two reconstruction threads)
    torch.cuda.synchronize()
    sc.reset_launches()
    pack.reset_launches()
    t0 = time.perf_counter()
    out = decode_gofs(gofs, depth=2)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches, k5_launches = sc.launches, pack.launches
    check(launches >= len(gofs),
          f"the main path launched K1 {launches} times for {len(gofs)} GOFs")
    check(k5_launches == launches,
          f"the main path launched K5 {k5_launches} times for {launches} "
          f"device-packed K1 dispatches")
    print(f"main path: Decoder.start_gofs, pipeline_gofs=2, {len(gofs)} GOFs, "
          f"{len(out)} frames in {first_s:.3f} s (first run), "
          f"K1 launches {launches}, K5 launches {k5_launches}")

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
    staged, stage_s = {}, {}
    for name in STAGINGS:
        with staged_as(name, dispatches=False):
            t0 = time.perf_counter()
            staged[name] = P._gof_device_inputs(gof, gof.metas,
                                                (cfg, tables), g_bucket)
            stage_s[name] = time.perf_counter() - t0
        check(staged[name].staging == name.replace(" ", "_"),
              f"{name}: staged as {staged[name].staging!r}")
    di = staged["device pack"]
    fields, cat = di.on_device(dev)
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

    # K1 must read the validity once and each valid slot's operands, and
    # write those operands and the counts
    per_slot = sum(t.element_size() for t in (w0, zs, wc) if t is not None)
    n_valid = int(ref_counts.sum())
    k1_bytes = valid.numel() + 2 * n_valid * per_slot + 4 * valid.shape[0]
    k1 = measure(lambda: sc._shift_compact_cuda(w0, zs, wc, valid),
                 lambda: sc.shift_compact_ops_reference(w0, zs, wc, valid),
                 nbytes=k1_bytes)
    planes = planes_to_device(*di.arrays, dev)
    runs = {
        "words": words,
        "dispatch": lambda: reconstruct_batch_pretiled_packed(fields, cat, di.cfg),
        "K5 + dispatch": lambda: reconstruct_batch_pretiled_packed(
            planes[0], pack.pack_cat(*planes[1:], di.cfg), di.cfg),
    }
    ms = {name: [] for name in runs}
    for name in ("words", "dispatch", "K5 + dispatch", "K5 + dispatch",
                 "dispatch", "words"):  # in turns
        ms[name].append(event_ms(runs[name]))
    ms_words = statistics.median(ms["words"])
    ms_dispatch = statistics.median(ms["dispatch"])
    ms_k5_dispatch = statistics.median(ms["K5 + dispatch"])
    # the H2D of each staging, host clock, in turns
    h2d = {"device pack": lambda: planes_to_device(*di.arrays, dev),
           "host pack": lambda: to_device(*staged["host pack"].arrays, dev)}
    h2d_bytes = {name: sum(t.numel() * t.element_size() for t in put())
                 for name, put in h2d.items()}
    h2d_ms = {name: [] for name in h2d}
    for name in ("device pack", "host pack", "host pack", "device pack"):
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h2d[name]()
            torch.cuda.synchronize()
            h2d_ms[name].append((time.perf_counter() - t0) * 1e3)
    ops, counts_t = reconstruct_batch_pretiled_packed(fields, cat, di.cfg)
    counts = counts_t.cpu().numpy()
    ms_fetch = event_ms(
        lambda: P._fetch_prefixes_packed(ops, counts, color_mode="yuv10"))

    from tpu_vpcc_torch.utils.stats import GofStats

    list(P._reconstruct_gof_device(gof, dev))  # warm
    reps = 3
    stages = {name: GofStats() for name in STAGINGS}
    e2e = {name: [] for name in STAGINGS}
    for name in ("device pack", "host pack", "host pack", "device pack"):
        with staged_as(name):
            for _ in range(reps):
                t0 = time.perf_counter()
                list(P._reconstruct_gof_device(gof, dev,
                                               stats=stages[name]))
                e2e[name].append(time.perf_counter() - t0)
    pts = sum(n_points[:len(frames)])

    # the Decoder's throughput on 8 GOFs, one and two in flight, with
    # each staging, in turns; every frame equal to the counted run's
    stream = gofs * 4
    dec_s = {(name, d): [] for name in STAGINGS for d in (1, 2)}
    for name, depth in (("device pack", 1), ("device pack", 2),
                        ("host pack", 2), ("host pack", 1),
                        ("host pack", 1), ("host pack", 2),
                        ("device pack", 2), ("device pack", 1)):
        with staged_as(name):
            t0 = time.perf_counter()
            got = decode_gofs(stream, depth)
            dec_s[name, depth].append(time.perf_counter() - t0)
        check(_same_frame_lists(got, out * 4),
              f"Decoder ({name}, pipeline_gofs={depth}) differs from the "
              f"counted run")
    n_dec = len(stream) * len(frames)
    print(f"Decoder.start_gofs (host clock, {len(stream)} GOFs, {n_dec} "
          f"frames, every frame equal to the counted run's, "
          f"{nvidia_smi_line()}): " + "; ".join(
              f"{name}, pipeline_gofs={d}: runs {[round(s, 4) for s in v]} "
              f"s, {n_dec / statistics.median(v):.1f} frames/s"
              for (name, d), v in dec_s.items()))
    smi = nvidia_smi_line()
    print(measured_line(f"K1 at the flagship dispatch shape, "
                        f"{launches / len(gofs):g} launches per two-frame "
                        f"GOF", k1, smi))
    print(f"timings (median CUDA events, {smi}): gather+words "
          f"{ms_words:.4f} ms (runs {ms['words']}); whole dispatch on the "
          f"cat {ms_dispatch:.4f} ms (runs {ms['dispatch']}); K5 and the "
          f"dispatch on the planes {ms_k5_dispatch:.4f} ms (runs "
          f"{ms['K5 + dispatch']}); fetch {ms_fetch:.4f} ms; host staging "
          + ", ".join(f"{n} {v * 1e3:.1f} ms" for n, v in stage_s.items()))
    print(f"H2D of a two-frame GOF (host clock, median of 6, {smi}): "
          + "; ".join(f"{n} {h2d_bytes[n]:,} B in "
                      f"{statistics.median(v):.2f} ms (runs "
                      f"{[round(x, 2) for x in v]})"
                      for n, v in h2d_ms.items()))
    for name in STAGINGS:
        e2e_s = statistics.median(e2e[name])
        n_runs = len(e2e[name])
        print(f"device stage end to end, {name} (host clock, {len(frames)} "
              f"frames, {pts} points, median of {n_runs}): "
              f"{e2e_s * 1e3:.1f} ms per GOF = {len(frames) / e2e_s:.1f} "
              f"frames/s, {pts / e2e_s / 1e6:.2f} Mpoints/s; split (ms per "
              f"GOF): " + ", ".join(
                  f"{k} {v * 1e3 / n_runs:.2f}"
                  for k, v in sorted(stages[name].stage_seconds.items())))
    print(f"peak device memory over the script: "
          f"{torch.cuda.max_memory_allocated() / 2 ** 20:.0f} MiB")
    return dict(k1, name="shift_compact", route="cuda", source=K1_SOURCE,
                replaces=K1_REPLACES, launches=launches,
                max_abs_err=k1_err), out, k5_launches


def words_err(a, b) -> int:
    """Max |a - b| over two tuples of equal-shape tensors."""
    return max(int((x.long() - y.long()).abs().max()) if x.numel() else 0
               for x, y in zip(a, b))


def phase_k2w(gof):
    """K2W against its plain version at the flagship dispatch shape, on
    the first flagship GOF's staged fields and cat; returns the max abs
    error."""
    from dataclasses import replace

    import torch

    from tpu_vpcc_torch.atlas import groups as G
    from tpu_vpcc_torch.ops import payload
    from tpu_vpcc_torch.runtime import pipeline as P

    cfg, tables, g_bucket = P._gof_tables_and_bucket(gof)
    di = P._gof_device_inputs(gof, gof.metas, (cfg, tables), g_bucket)
    fields, cat = di.on_device(torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(45)
    fields45 = fields.clone()
    fields45[:, :, G.G_PLANE] = torch.randint(
        0, 4, fields.shape[:2], dtype=torch.int32, device="cuda",
        generator=gen,
    )
    base = di.cfg
    cases = {
        "wide layout": (fields, base),
        "45-degree views, G_PLANE random in 0..3": (
            fields45, replace(base, additional_planes=True)),
        "45-degree views + drop_map0": (
            fields45, replace(base, additional_planes=True, drop_map0=True)),
        "drop_map0": (fields, replace(base, drop_map0=True)),
        "relative D1": (fields, replace(base, absolute_d1=False)),
        "one map": (fields, replace(base, map_count=1)),
    }
    err = 0
    for name, (f, c) in cases.items():
        got = payload.wide_words(f, cat, c)
        ref = payload.wide_words_reference(f, cat, c)
        torch.cuda.synchronize()
        e = words_err(got, ref)
        check(e == 0 and all(torch.equal(a, b) for a, b in zip(got, ref)),
              f"K2W differs from plain ({name}, max abs err {e})")
        err = max(err, e)
        print(f"K2W vs plain: {name}: F={fields.shape[0]} groups="
              f"{fields.shape[1]} S={got[0].shape[1]}, "
              f"{int(got[3].sum())} valid slots, words and validity equal")
    print(f"phase 4: {len(cases)} K2W cases byte-equal to the plain version")
    return err


def phase_wide(fcfg, frame_sets, narrow_out, k1f_err, k2w_err):
    """The wide flagship main path through ``Decoder.start_gofs``, the
    oracle, smoothing's effect, the smoothing kernels against their
    plain versions at the smoothing GOF's dispatch shape, and the
    timings; returns the kernels' JSON entries of K1F, K2W and the
    smoothing kernels, the two wide GOFs and their decoded frames."""
    import numpy as np
    import torch

    from tpu_vpcc_torch.atlas import groups as G
    from tpu_vpcc_torch.models.flagship import (
        ATTR_SMOOTHING,
        GEO_SMOOTHING,
        example_frames,
        example_gof,
    )
    from tpu_vpcc_torch.ops import pack, payload
    from tpu_vpcc_torch.ops import shift_compact as sc
    from tpu_vpcc_torch.ops import smoothing as S
    from tpu_vpcc_torch.ops.tiled import (
        reconstruct_batch_pretiled,
        smooth_slot_arrays,
        smooth_words,
    )
    from tpu_vpcc_torch.runtime import pipeline as P
    from tpu_vpcc_torch.runtime.host import _reconstruct_gof_oracle
    from tpu_vpcc_torch.tools.kernel_times import (
        event_ms,
        measure,
        measured_line,
        nvidia_smi_line,
        smooth_cases,
        smooth_passes,
    )

    dev = torch.device("cuda")
    smooth = dict(geo_smoothing=GEO_SMOOTHING, attr_smoothing=ATTR_SMOOTHING)
    t0 = time.perf_counter()
    frames45 = frames_45(fcfg)
    n45 = sum(p.axis_of_additional_plane != 0
              for sf in frames45 for p in sf.meta.patches)
    n_all = sum(len(sf.meta.patches) for sf in frames45)
    wide_sets = [frame_sets[0], frames45]
    wide_gofs = [example_gof(fcfg, frame_sets[0], **smooth),
                 example_gof(fcfg, frames45)]
    print(f"wide flagship: GOF 0 = frames of seeds 0-1 with geometry "
          f"smoothing {GEO_SMOOTHING} and colour smoothing "
          f"{ATTR_SMOOTHING}; GOF 1 = frames of seeds 4-5 with {n45} of "
          f"{n_all} patches on 45-degree views (synthesised in "
          f"{time.perf_counter() - t0:.2f} s)")

    # the wide main path, counted
    torch.cuda.synchronize()
    sc.reset_launches()
    payload.reset_launches()
    pack.reset_launches()
    S.reset_launches()
    t0 = time.perf_counter()
    out = decode_gofs(wide_gofs, depth=2)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    k2w_launches, k1f_launches = payload.launches, sc.full_launches
    s_launches = S.launches
    check(k2w_launches > 0 and k1f_launches > 0,
          f"the wide main path launched K2W {k2w_launches} and K1F "
          f"{k1f_launches} times")
    check(pack.launches == k2w_launches,
          f"the wide main path launched K5 {pack.launches} times for "
          f"{k2w_launches} device-packed K2W dispatches")
    # one dispatch per DEVICE_BATCH frames; only GOF 0 smooths
    sm_dispatches = -(-len(wide_gofs[0].metas) // P.DEVICE_BATCH)
    s_want = sum(smooth_launches(g, -(-len(g.metas) // P.DEVICE_BATCH))
                 for g in wide_gofs)
    check(s_launches == s_want and s_want == 6 * sm_dispatches,
          f"the wide main path launched the smoothing kernels "
          f"{s_launches} times, want {s_want} (3 a pass, 2 passes, "
          f"{sm_dispatches} smoothed dispatches)")
    print(f"wide main path: Decoder.start_gofs, pipeline_gofs=2, "
          f"{len(wide_gofs)} GOFs, {len(out)} frames in {first_s:.3f} s "
          f"(first run), K2W launches {k2w_launches}, K1F launches "
          f"{k1f_launches}, K5 launches {pack.launches}, K1 launches "
          f"{sc.launches}, smoothing launches {s_launches} (3 a pass x 2 "
          f"passes x {sm_dispatches} smoothed dispatches)")
    n_frames = sum(len(f) for f in wide_sets)
    check(len(out) == n_frames, f"{len(out)} frames out for {n_frames} in")
    n_points = []
    for g, frames in enumerate(wide_sets):
        t0 = time.perf_counter()
        oracle_gof = example_gof(fcfg, frames, tiled=False,
                                 **(smooth if g == 0 else {}))
        refs = list(_reconstruct_gof_oracle(oracle_gof))
        ora_s = time.perf_counter() - t0
        for k, ref in enumerate(refs):
            ps = out[g * len(frames) + k]
            same = (
                ps.positions.shape == ref.positions.shape
                and np.array_equal(ps.positions, ref.positions)
                and np.array_equal(ps.colors, ref.colors)
            )
            check(same, f"wide GOF {g} frame {k}: {len(ps)} points differ "
                        f"from the oracle's {len(ref)}")
            n_points.append(len(ps))
            print(f"wide GOF {g} frame {k}: {len(ps)} points byte-equal to "
                  f"the numpy oracle (oracle GOF {ora_s:.1f} s)")
    moved_pos = moved_col = 0
    for k in range(len(frame_sets[0])):
        a, b = out[k], narrow_out[k]
        check(a.positions.shape == b.positions.shape,
              "smoothing changed a point count")
        moved_pos += int((a.positions != b.positions).any(axis=1).sum())
        moved_col += int((a.colors != b.colors).any(axis=1).sum())
    check(moved_pos > 0 and moved_col > 0,
          f"smoothing moved {moved_pos} positions and {moved_col} colours")
    print(f"smoothing ran: against phase 3's unsmoothed decode of the same "
          f"two frames, {moved_pos} positions and {moved_col} colours differ")

    # timings at the smoothing GOF's dispatch shape (not counted)
    gof = wide_gofs[0]
    cfg, tables, g_bucket = P._gof_tables_and_bucket(gof)
    t0 = time.perf_counter()
    di = P._gof_device_inputs(gof, gof.metas, (cfg, tables), g_bucket)
    stage_s = time.perf_counter() - t0
    fields, cat = di.on_device(dev)
    w0, w1, w2, valid = payload.wide_words(fields, cat, di.cfg)
    F = valid.shape[0]
    # the smoothing kernels against their plain versions on this
    # dispatch's own slot arrays, both passes, grids and outputs
    s_cols, s_args = smooth_slot_arrays(fields, w0, w1, w2, valid)
    s_err, s_moved, s_runs = smooth_cases(s_cols, s_args, F, di.cfg)
    check(s_err == 0, f"the smoothing kernels differ from their plain "
                      f"versions at the wide flagship (by up to {s_err})")
    check(all(s_moved), f"the smoothing kernels moved {s_moved[0]} "
                        f"coordinates and {s_moved[1]} colour components")
    print(f"smoothing kernels at the smoothing GOF's dispatch shape: both "
          f"passes' grids and outputs byte-equal to the plain versions; "
          f"moved {s_moved[0]} coordinates and {s_moved[1]} colour "
          f"components")
    sw = smooth_words(fields, w0, w1, w2, valid, di.cfg)
    got, n_got = sc.shift_compact_full(sw, valid)
    ref, n_ref = sc.shift_compact_full_reference(sw, valid)
    torch.cuda.synchronize()
    check(torch.equal(n_got, n_ref), "K1F counts differ at the wide flagship")
    e = prefix_err(got, ref, n_ref.tolist())
    check(e == 0, f"K1F differs from plain at the wide flagship ({e})")
    k1f_err = max(k1f_err, e)
    S = valid.shape[1]
    print(f"wide dispatch shape: F={valid.shape[0]} groups={g_bucket} S={S}, "
          f"{int(valid.sum())} valid slots")
    # K2W reads the fields and each live group's cat row once and writes
    # three words and the validity of every slot; K1F must read the
    # validity once and each valid slot's three words, and write those
    # words and the counts
    n_live = int((fields[:, :, G.G_VALID] > 0).sum())
    k2w_bytes = fields.numel() * 4 + n_live * cat.shape[2] * 4 \
        + valid.numel() * 13
    k1f_bytes = valid.numel() + 2 * int(n_ref.sum()) * 12 + 4 * F
    k2w = measure(lambda: payload._wide_words_cuda(fields, cat, di.cfg),
                  lambda: payload.wide_words_reference(fields, cat, di.cfg),
                  nbytes=k2w_bytes)
    k1f = measure(lambda: sc._shift_compact_full_cuda(sw, valid),
                  lambda: sc.shift_compact_full_reference(sw, valid),
                  nbytes=k1f_bytes)
    s_meas = {name: measure(kernel, plain, nbytes=nbytes)
              for name, (kernel, plain, nbytes) in s_runs.items()}
    runs = {
        # the words' unpack, both passes on the kernels and the repack
        "smoothing": lambda: smooth_words(fields, w0, w1, w2, valid, di.cfg),
        "smoothing passes, kernels": lambda: smooth_passes(
            s_cols, s_args, F, di.cfg),
        "smoothing passes, plain": lambda: smooth_passes(
            s_cols, s_args, F, di.cfg, plain=True),
        "dispatch": lambda: reconstruct_batch_pretiled(fields, cat, di.cfg),
    }
    ms = {name: [] for name in runs}
    for name in [*runs, *reversed(runs)]:
        ms[name].append(event_ms(runs[name], reps=10))
    med = {name: statistics.median(v) for name, v in ms.items()}
    ops, counts_t = reconstruct_batch_pretiled(fields, cat, di.cfg)
    counts = counts_t.cpu().numpy()
    ms_fetch = event_ms(lambda: P._fetch_prefixes_packed(
        ops, counts, color_mode="yuv10", layout="wide"), reps=10)
    smi = nvidia_smi_line()
    per_gof = {name: n / len(wide_gofs) for name, n in
               (("K2W", k2w_launches), ("K1F", k1f_launches))}
    for name, m in (("K2W", k2w), ("K1F", k1f)):
        print(measured_line(f"{name} at the smoothing GOF's dispatch shape, "
                            f"{per_gof[name]:g} launches per two-frame GOF",
                            m, smi))
    for name, m in s_meas.items():
        print(measured_line(f"smoothing {name} at the smoothing GOF's "
                            f"dispatch shape, once a smoothed dispatch",
                            m, smi))
    print(f"wide timings (median CUDA events, {smi}): " + "; ".join(
        f"{name} {med[name]:.4f} ms (runs {ms[name]})" for name in runs)
        + f"; fetch {ms_fetch:.4f} ms; host staging {stage_s * 1e3:.1f} ms")

    from tpu_vpcc_torch.utils.stats import GofStats

    reps = 3
    stages = GofStats()
    for _ in range(reps):
        list(P._reconstruct_gof_device(gof, dev, stats=stages))
    print("wide device stage split (host clock, ms per GOF, smoothing GOF): "
          + ", ".join(f"{k} {v * 1e3 / reps:.2f}"
                      for k, v in sorted(stages.stage_seconds.items())))

    stream = wide_gofs * 2
    dec_s = {1: [], 2: []}
    for depth in (1, 2, 2, 1):
        t0 = time.perf_counter()
        n = len(decode_gofs(stream, depth))
        dec_s[depth].append(time.perf_counter() - t0)
        check(n == 2 * n_frames, f"Decoder emitted {n} frames")
    print(f"wide Decoder.start_gofs (host clock, {len(stream)} GOFs, "
          f"{2 * n_frames} frames, {smi}): " + "; ".join(
              f"pipeline_gofs={d}: runs {[round(x, 4) for x in v]} s, "
              f"{2 * n_frames / statistics.median(v):.1f} frames/s"
              for d, v in dec_s.items()))
    print(f"peak device memory over the script: "
          f"{torch.cuda.max_memory_allocated() / 2 ** 20:.0f} MiB")
    return [
        dict(k1f, name="shift_compact_full", route="cuda", source=K1_SOURCE,
             replaces=K1F_REPLACES, launches=k1f_launches,
             max_abs_err=k1f_err),
        dict(k2w, name="wide_words", route="cuda", source=K2W_SOURCE,
             replaces=K2W_REPLACES, launches=k2w_launches,
             max_abs_err=k2w_err),
    ] + [
        # S1: the grids' initialisation and smooth_stats_kernel (two
        # launches a pass); S2: smooth_apply_kernel (one)
        dict(m, name=f"smooth_{half}", smoothing_pass=kind, route="cuda",
             source=S_SOURCE, replaces=S_REPLACES[name],
             launches=(2 if half == "stats" else 1) * sm_dispatches,
             max_abs_err=s_err)
        for name, m in s_meas.items() for kind, half in [name.split()]
    ], wide_gofs, out


def phase_gather(fcfg, frame_sets, narrow_out):
    """The gather fallback on the card through ``Decoder.start_gofs``
    (GOFs R, W and RS, see the module note), the oracle, and the
    timings; returns the kernels entry of K1F on the gather path, GOFs
    R, W and RS and their decoded frames."""
    import numpy as np
    import torch

    from tpu_vpcc_torch.atlas import groups as G
    from tpu_vpcc_torch.models.flagship import (
        ATTR_SMOOTHING,
        GEO_SMOOTHING,
        ROTATED,
        example_frames,
        example_gof,
    )
    from tpu_vpcc_torch.ops import pack, payload
    from tpu_vpcc_torch.ops import shift_compact as sc
    from tpu_vpcc_torch.ops import smoothing as S
    from tpu_vpcc_torch.ops.color import rgb8_from_yuv16
    from tpu_vpcc_torch.ops.reconstruct import gather_words, reconstruct_batch
    from tpu_vpcc_torch.ops.tiled import gather_inputs_to_device
    from tpu_vpcc_torch.runtime import pipeline as P
    from tpu_vpcc_torch.runtime.host import _reconstruct_gof_oracle
    from tpu_vpcc_torch.tools.kernel_times import (
        _trace,
        event_ms,
        measure,
        measured_line,
        nvidia_smi_line,
        queued_ms,
        short_name,
    )
    from tpu_vpcc_torch.utils.stats import GofStats

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    smooth = dict(geo_smoothing=GEO_SMOOTHING, attr_smoothing=ATTR_SMOOTHING)
    t0 = time.perf_counter()
    frames_r = frames_rotated(fcfg)
    specs = {  # GOF: (frames, example_gof options)
        "R": (frames_r, {}),
        "W": (frame_sets[0], {"geometry_bits": 12}),
        "RS": (frames_r, smooth),
    }
    gofs = [example_gof(fcfg, fr, **kw) for fr, kw in specs.values()]
    rotated = [{i for i, p in enumerate(sf.meta.patches)
                if p.patch_orientation in ROTATED} for sf in frames_r]
    print(f"gather GOFs: R = frames of seeds 6-7 with "
          f"{[len(r) for r in rotated]} of "
          f"{[len(sf.meta.patches) for sf in frames_r]} patches turned to "
          f"rotated orientations; W = phase 3's GOF 0 frames with 12-bit "
          f"geometry (samples x4, geo_shift 4, not 10-bit packable); RS = "
          f"GOF R with geometry smoothing {GEO_SMOOTHING} and colour "
          f"smoothing {ATTR_SMOOTHING} (synthesised in "
          f"{time.perf_counter() - t0:.2f} s)")
    check(all(rotated), "a frame of GOF R has no rotated patch")

    staged, dispatches, s_want = {}, 0, 0
    for name, g in zip(specs, gofs):
        cfg, tables, g_bucket = P._gof_tables_and_bucket(g)
        t0 = time.perf_counter()
        staged[name] = P._gof_device_inputs(g, g.metas, (cfg, tables),
                                            g_bucket)
        stage_s = time.perf_counter() - t0
        check(not staged[name].use_tiled,
              f"GOF {name} would take a tiled path")
        # one dispatch per chunk, trailing-layer pass and secondary twin
        n_disp = (-(-len(g.metas) // P.DEVICE_BATCH)
                  * (1 + max(0, g.map_count - 2))
                  * (1 + len(g.sec_attrs)))
        dispatches += n_disp
        s_want += smooth_launches(g, n_disp)
        print(f"GOF {name}: gather fallback (tiled_ok "
              f"{[t.tiled_ok for t in tables]}, packed10_ok "
              f"{g.packed10_ok}, geo_shift {g.geo_shift}), {g_bucket} "
              f"groups per frame, host staging {stage_s * 1e3:.1f} ms")

    # the gather main path, counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sc.reset_launches()
    payload.reset_launches()
    pack.reset_launches()
    S.reset_launches()
    t0 = time.perf_counter()
    out = decode_gofs(gofs, depth=2)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {"K1F": sc.full_launches, "K1": sc.launches,
                "K2W": payload.launches, "K5": pack.launches,
                "smoothing": S.launches}
    peak_run = torch.cuda.max_memory_allocated()
    check(s_want > 0, "no gather GOF smooths")
    check(launches == {"K1F": dispatches, "K1": 0, "K2W": 0, "K5": 0,
                       "smoothing": s_want},
          f"the gather main path launched {launches} for {dispatches} "
          f"gather dispatches (smoothing: {s_want}, three a pass of GOF "
          f"RS's dispatches)")
    print(f"gather main path: Decoder.start_gofs, pipeline_gofs=2, "
          f"{len(gofs)} GOFs, {len(out)} frames in {first_s:.3f} s (first "
          f"run), {dispatches} gather dispatches, launches {launches}")

    n_frames = sum(len(fr) for fr, _ in specs.values())
    check(len(out) == n_frames, f"{len(out)} frames out for {n_frames} in")
    k = 0
    for name, (frames, kw) in specs.items():
        t0 = time.perf_counter()
        refs = list(_reconstruct_gof_oracle(
            example_gof(fcfg, frames, tiled=False, **kw)))
        ora_s = time.perf_counter() - t0
        for f, ref in enumerate(refs):
            ps = out[k]
            same = (
                ps.positions.shape == ref.positions.shape
                and np.array_equal(ps.positions, ref.positions)
                and np.array_equal(ps.colors, ref.colors)
            )
            check(same and len(ps) > 0,
                  f"gather GOF {name} frame {f}: {len(ps)} points differ "
                  f"from the oracle's {len(ref)}")
            print(f"gather GOF {name} frame {f}: {len(ps)} points "
                  f"byte-equal to the numpy oracle (oracle GOF "
                  f"{ora_s:.1f} s)")
            k += 1
    n_r = len(frames_r)
    for f in range(len(frame_sets[0])):
        a, b = out[n_r + f], narrow_out[f]
        check(np.array_equal(a.positions, b.positions)
              and np.array_equal(a.colors, b.colors),
              f"GOF W frame {f} differs from phase 3's 10-bit decode")
    print("GOF W: each frame equal to phase 3's 10-bit decode of its "
          "frames")
    moved_pos = moved_col = 0
    for f in range(n_r):
        a, b = out[n_r + len(frame_sets[0]) + f], out[f]
        check(a.positions.shape == b.positions.shape,
              "smoothing changed a point count")
        moved_pos += int((a.positions != b.positions).any(axis=1).sum())
        moved_col += int((a.colors != b.colors).any(axis=1).sum())
    check(moved_pos > 0 and moved_col > 0,
          f"smoothing moved {moved_pos} positions and {moved_col} colours")
    print(f"smoothing ran: GOF RS against GOF R, {moved_pos} positions and "
          f"{moved_col} colours differ")

    # the rotated patches' own points: a dispatch of their groups alone
    # (each slot's validity depends on its own group only)
    di = staged["R"]
    fields = di.arrays[0].copy()
    for f, rot in enumerate(rotated):
        keep = np.isin(fields[f, :, G.G_PATCH], sorted(rot))
        fields[f, :, G.G_VALID] *= keep
    t = gather_inputs_to_device(fields, *di.arrays[1:], dev)
    _, n_rot = reconstruct_batch(*t, di.cfg)
    n_rot = n_rot.tolist()
    check(min(n_rot) > 0, f"the rotated patches emit {n_rot} points")
    print(f"GOF R: the rotated patches emit {n_rot} of "
          f"{[len(out[f]) for f in range(n_r)]} points per frame")

    # the colour conversion on samples up to 16 bits, card against CPU
    gen = torch.Generator().manual_seed(16)
    yuv = torch.randint(0, 1 << 16, (1 << 20, 3), generator=gen,
                        dtype=torch.int32)
    for j, bits in enumerate((10, 11, 12, 13)):
        yuv[j << 16 : (j + 1) << 16] >>= 16 - bits
    rgb_card = rgb8_from_yuv16(yuv.to(dev)).cpu()
    check(torch.equal(rgb_card, rgb8_from_yuv16(yuv)),
          "rgb8_from_yuv16 on the card differs from the CPU on 16-bit "
          "samples")
    print(f"rgb8_from_yuv16: {yuv.shape[0]} samples of 10-16 bits equal on "
          f"the card and the CPU")

    # timings at GOF R's dispatch shape (not counted)
    t = gather_inputs_to_device(*di.arrays, dev)
    w0, w1, w2, valid = gather_words(*t, di.cfg)
    got, n_got = sc.shift_compact_full((w0, w1, w2), valid)
    ref, n_ref = sc.shift_compact_full_reference((w0, w1, w2), valid)
    torch.cuda.synchronize()
    check(torch.equal(n_got, n_ref), "K1F counts differ on the gather path")
    err = prefix_err(got, ref, n_ref.tolist())
    check(err == 0, f"K1F differs from plain on the gather path ({err})")
    F, S = valid.shape
    print(f"gather dispatch shape (GOF R): F={F} groups={fields.shape[1]} "
          f"S={S}, {int(valid.sum())} valid slots")
    # K1F must read the validity once and each valid slot's three words,
    # and write those words and the counts
    k1f_bytes = valid.numel() + 2 * int(n_ref.sum()) * 12 + 4 * F
    k1f = measure(lambda: sc._shift_compact_full_cuda((w0, w1, w2), valid),
                  lambda: sc.shift_compact_full_reference((w0, w1, w2),
                                                          valid),
                  nbytes=k1f_bytes)
    tensors = {name: gather_inputs_to_device(*d.arrays, dev)
               for name, d in staged.items()}
    runs = {
        "slot math": lambda: gather_words(*t, di.cfg),
        "dispatch": lambda: reconstruct_batch(*t, di.cfg),
    }
    ms = {name: [] for name in runs}
    for name in ("slot math", "dispatch", "dispatch", "slot math"):
        ms[name].append(event_ms(runs[name], reps=10))
    med = {name: statistics.median(v) for name, v in ms.items()}
    slot_ms = {name: event_ms(lambda name=name: gather_words(
        *tensors[name], staged[name].cfg), reps=10) for name in staged}
    t0 = time.perf_counter()
    for _ in range(5):
        gather_inputs_to_device(*di.arrays, dev)
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) / 5 * 1e3
    ops, counts_t = reconstruct_batch(*t, di.cfg)
    counts = counts_t.cpu().numpy()
    ms_fetch = event_ms(lambda: P._fetch_prefixes_packed(
        ops, counts, color_mode="yuv10", layout="gather"), reps=10)
    print(measured_line(f"K1F on the gather path at GOF R's dispatch shape, "
                        f"{launches['K1F'] / len(gofs):g} launches per "
                        f"two-frame GOF", k1f, smi))
    print(f"gather timings (median CUDA events, {smi}): " + "; ".join(
        f"{name} {med[name]:.4f} ms (runs {ms[name]})" for name in runs)
        + f"; fetch {ms_fetch:.4f} ms; slot math per GOF "
        + ", ".join(f"{n} {v:.4f} ms" for n, v in slot_ms.items())
        + f"; H2D of the seven arrays (host clock) {h2d_ms:.2f} ms")
    share = k1f["ms"] / med["dispatch"]
    print(f"gather dispatch (GOF R): slot math {med['slot math']:.4f} ms, "
          f"K1F {k1f['ms']:.4f} ms device-only = {share:.1%} of the "
          f"dispatch's {med['dispatch']:.4f} ms ({smi})")
    # what the slot math is made of: one call's device records (a
    # single trace, not held whole) and its time queued behind a spin
    spins = _trace(None, 0)
    recs = {n: v for n, v in _trace(runs["slot math"], 1).items()
            if n not in spins}
    top = sorted(((sum(v) / 1e3, len(v), short_name(n))
                  for n, v in recs.items()), reverse=True)
    print(f"gather slot math (GOF R, one call's trace, {smi}): "
          f"{sum(len(v) for v in recs.values())} device records, "
          f"{sum(t[0] for t in top):.4f} ms of device time, queued "
          f"{queued_ms(runs['slot math']):.4f} ms; largest: " + ", ".join(
              f"{name} {ms:.4f} ms x{n}" for ms, n, name in top[:6]))

    for name in ("R", "RS"):
        g = gofs[list(specs).index(name)]
        list(P._reconstruct_gof_device(g, dev))  # warm
        reps = 3
        stages = GofStats()
        for _ in range(reps):
            list(P._reconstruct_gof_device(g, dev, stats=stages))
        print(f"gather device stage split (host clock, ms per GOF, GOF "
              f"{name}): " + ", ".join(
                  f"{k} {v * 1e3 / reps:.2f}"
                  for k, v in sorted(stages.stage_seconds.items())))

    stream = gofs * 2
    dec_s = {1: [], 2: []}
    for depth in (1, 2, 2, 1):
        t0 = time.perf_counter()
        n = len(decode_gofs(stream, depth))
        dec_s[depth].append(time.perf_counter() - t0)
        check(n == 2 * n_frames, f"Decoder emitted {n} frames")
    print(f"gather Decoder.start_gofs (host clock, {len(stream)} GOFs R, W, "
          f"RS twice, {2 * n_frames} frames, {smi}): " + "; ".join(
              f"pipeline_gofs={d}: runs {[round(x, 4) for x in v]} s, "
              f"{2 * n_frames / statistics.median(v):.1f} frames/s"
              for d, v in dec_s.items()))
    print(f"peak device memory of the gather phase: counted run "
          f"{peak_run / 2 ** 20:.0f} MiB, with the timings "
          f"{torch.cuda.max_memory_allocated() / 2 ** 20:.0f} MiB")
    return dict(k1f, name="shift_compact_full (gather path)", route="cuda",
                source=K1_SOURCE, replaces=K1F_REPLACES,
                launches=launches["K1F"], max_abs_err=err), gofs, out


def _ply_outputs(out_dir, entry, where):
    """The PLY files under ``out_dir``, by name: the names and SHA-256
    digests of ``entry``'s manifest."""
    import hashlib

    files = {p.name: p.read_bytes() for p in sorted(Path(out_dir).glob("*.ply"))}
    check(sorted(files) == [o["name"] for o in entry.outputs],
          f"{entry.name} ({where}): files {sorted(files)}, manifest "
          f"{[o['name'] for o in entry.outputs]}")
    for o in entry.outputs:
        check(hashlib.sha256(files[o["name"]]).hexdigest() == o["sha256"],
              f"{entry.name} ({where}): {o['name']} differs from the "
              f"manifest's digest")
    return files


def _launch_counts():
    from tpu_vpcc_torch.ops import pack, payload
    from tpu_vpcc_torch.ops import shift_compact as sc

    return {"K1": sc.launches, "K2W": payload.launches,
            "K1F": sc.full_launches, "K5": pack.launches}


def _reset_launches():
    from tpu_vpcc_torch.ops import pack, payload
    from tpu_vpcc_torch.ops import shift_compact as sc

    sc.reset_launches()
    payload.reset_launches()
    pack.reset_launches()


def _quantized(stream: Path) -> bool:
    """Whether the stream's atlas codes quantized patch extents (whose
    cats the host packs, as the reference does)."""
    from tpu_vpcc_torch.bitio import Bitstream
    from tpu_vpcc_torch.v3c.context import Context
    from tpu_vpcc_torch.v3c.stream import SampleStreamV3CUnit

    ssvu = SampleStreamV3CUnit.from_bitstream(Bitstream(stream.read_bytes()))
    ctx = Context()
    ssvu.decode_gof(ctx)
    return bool(ctx.get_asps(0).patch_size_quantizer_present_flag)


def _check_launches(name, entry, what, host_packed: bool = False):
    """The K1, K2W and K1F launches since the last reset equal the
    manifest's, and K5's the device-packed tiled dispatches: one a K1 or
    K2W launch, none where the host packs the cats (quantized patch
    extents)."""
    launches = _launch_counts()
    check({k: launches[k] for k in entry.launches} == entry.launches,
          f"{name} ({what}): kernel launches {launches}, manifest "
          f"{entry.launches}")
    k5 = 0 if host_packed else entry.launches["K1"] + entry.launches["K2W"]
    check(launches["K5"] == k5,
          f"{name} ({what}): K5 launched {launches['K5']} times, want {k5}")
    return launches


def phase_stream():
    """Phase 6: every entry of the committed video store
    (``tools/video_store.py``) through the port's CLI on the card, the
    HEVC decode replaced by the store's lookup and nothing else; then
    the 1280^2 lossy stream through ``Decoder``, timed. Returns the
    oracle CLI's files of the :data:`REBUILT` entries, by name."""
    import logging
    import tempfile

    from tpu_vpcc_torch.runtime import cli
    from tpu_vpcc_torch.tools.video_store import VideoStore, served

    # the CLI's per-frame log lines stay off; its errors still print
    logging.basicConfig(level=logging.WARNING)
    t_phase = time.perf_counter()
    store = VideoStore()
    check(STREAM_FLAGSHIP in store.entries,
          f"the video store has no entry {STREAM_FLAGSHIP}")
    oracles = {}
    with served(store), tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for name, e in store.entries.items():
            args = ["-i", str(e.stream), *e.flags]
            # the main path, counted: the port's CLI on the card
            _reset_launches()
            t0 = time.perf_counter()
            rc = cli.main([*args, "-o", str(tmp / name / "cuda"),
                           "--device", "cuda"])
            dt = time.perf_counter() - t0
            check(rc == 0, f"{name}: the CLI on the card exited {rc}")
            launches = _check_launches(name, e, "CLI",
                                       host_packed=_quantized(e.stream))
            rc = cli.main([*args, "-o", str(tmp / name / "oracle"),
                           "--oracle", "--device", "cpu"])
            check(rc == 0, f"{name}: the oracle CLI exited {rc}")
            dev = _ply_outputs(tmp / name / "cuda", e, "card")
            ora = _ply_outputs(tmp / name / "oracle", e, "oracle")
            for n in dev:
                check(dev[n] == ora[n], f"{name}: {n} differs from the "
                      f"oracle's")
            if name in REBUILT:
                oracles[name] = ora
            print(f"stream {name} {' '.join(e.flags)}: "
                  f"{len(dev)} frames, "
                  f"{[o['points'] for o in e.outputs]} points, byte-equal "
                  f"to the oracle and the manifest; launches {launches}; "
                  f"CLI {dt:.2f} s")
        # the reference's unread options, on the default device (cuda)
        e = store.entries["verify"]
        rc = cli.main(["-i", str(e.stream), "-o", str(tmp / "unread"),
                       "-d", "/nonexistent", "--keep-intermediate-files"])
        check(rc == 0, f"-d and --keep-intermediate-files: exit {rc}")
        _ply_outputs(tmp / "unread", e, "-d, --keep-intermediate-files")
        # several -i through the batcher
        multi = [store.entries[n] for n in store.multi["entries"]]
        _reset_launches()
        rc = cli.main([*(a for m in multi for a in ("-i", str(m.stream))),
                       "-o", str(tmp / "multi"), "--device", "cuda",
                       *store.multi["flags"]])
        launches = _launch_counts()
        check(rc == 0, f"several -i: exit {rc}")
        for m in multi:
            _ply_outputs(tmp / "multi" / m.stream.stem, m, "several -i")
        check(launches["K1"] > 0 and launches["K2W"] > 0
              and launches["K1F"] > 0
              and launches["K5"] == launches["K1"] + launches["K2W"],
              f"several -i: kernel launches {launches}")
        print(f"several -i ({', '.join(m.name for m in multi)}, "
              f"{' '.join(store.multi['flags'])}): each stream's files "
              f"equal to its single-stream decode; launches {launches}")
        flagship_stream(store)
    print(f"phase 6: {len(store.entries)} store entries on the card, "
          f"{store.hits} lookups; {time.perf_counter() - t_phase:.1f} s")
    return oracles


def flagship_stream(store):
    """``STREAM_FLAGSHIP`` through ``Decoder(Params(stream,
    device="cuda"))``, one and two GOFs in flight, with the device pack
    and the host pack (:func:`staged_as`), in turns: its stream repeated to
    :data:`STREAM_GOFS` GOFs (each GOF starts at its VPS), every frame
    equal to the GOF's first decode, whose PLY bytes match the manifest;
    host clock, ``DecodeStats`` stage split per GOF."""
    import hashlib

    import numpy as np

    from tpu_vpcc_torch.runtime.pipeline import Decoder, Params
    from tpu_vpcc_torch.tools.kernel_times import nvidia_smi_line
    from tpu_vpcc_torch.utils.ply import format_ply

    e = store.entries[STREAM_FLAGSHIP]
    one = e.stream.read_bytes()
    # the sample stream header once, then the GOF's units again
    data = one + one[1:] * (STREAM_GOFS - 1)
    n_frames = STREAM_GOFS * len(e.outputs)
    turns = (("device pack", 1), ("device pack", 2), ("host pack", 2),
             ("host pack", 1), ("host pack", 1), ("host pack", 2),
             ("device pack", 2), ("device pack", 1))
    runs = {turn: [] for turn in turns}
    splits = {turn: [] for turn in turns}
    first = None
    for name, depth in turns:
        with staged_as(name):
            dec = Decoder(Params(data, device="cuda", pipeline_gofs=depth,
                                 **e.params))
            t0 = time.perf_counter()
            dec.start()
            frames = list(dec)
        runs[name, depth].append(time.perf_counter() - t0)
        splits[name, depth].append(dec.stats.stage_totals())
        check(len(frames) == n_frames,
              f"{STREAM_FLAGSHIP}: {len(frames)} frames, want {n_frames}")
        if first is None:
            first = frames[: len(e.outputs)]
            for ps, o in zip(first, e.outputs):
                check(hashlib.sha256(format_ply(ps)).hexdigest()
                      == o["sha256"],
                      f"{STREAM_FLAGSHIP}: Decoder frame {o['name']} "
                      f"differs from the manifest's digest")
        for k, ps in enumerate(frames):
            ref = first[k % len(first)]
            check(np.array_equal(ps.positions, ref.positions)
                  and np.array_equal(ps.colors, ref.colors),
                  f"{STREAM_FLAGSHIP}: frame {k} differs from its GOF's "
                  f"first decode")
    smi = nvidia_smi_line()
    pts = sum(o["points"] for o in e.outputs)
    print(f"{STREAM_FLAGSHIP} through Decoder(Params(stream, device="
          f"'cuda')), HEVC replaced by the store lookup ({smi}): "
          f"{STREAM_GOFS} GOFs of {len(e.outputs)} 1280^2 frames, "
          f"{pts} points a GOF; " + "; ".join(
              f"{name}, pipeline_gofs={d}: runs "
              f"{[round(s, 4) for s in v]} s, "
              f"{n_frames / statistics.median(v):.2f} frames/s"
              for (name, d), v in runs.items()))
    for (name, depth), totals in splits.items():
        med = {k: statistics.median(t.get(k, 0.0) for t in totals)
               for k in totals[0]}
        print(f"{STREAM_FLAGSHIP} stage split, {name}, pipeline_gofs="
              f"{depth} (host clock, ms per GOF, median of 2 runs; "
              f"host_prepare holds video_decode, the store lookup, and "
              f"reconstruct holds the recon_ stages): " + ", ".join(
                  f"{STAGE_LABELS.get(k, k)} {v * 1e3 / STREAM_GOFS:.2f}"
                  for k, v in sorted(med.items())))


@contextmanager
def bridge_refused():
    """While open, every call of the native video bridge's loader
    (``video.codec._load``) is refused and recorded, and the PLY writer
    formats with numpy, as it does where the bridge cannot load; on exit
    the run fails if there was a call."""
    from tpu_vpcc_torch.utils import ply
    from tpu_vpcc_torch.video import codec

    calls = []

    def refuse():
        calls.append(1)
        raise OSError("the native video bridge may not load here")

    real, real_ply = codec._load, ply._ply_lib
    codec._load, ply._ply_lib = refuse, False
    try:
        yield
    finally:
        codec._load, ply._ply_lib = real, real_ply
    check(not calls, f"the native video bridge's loader was called "
          f"{len(calls)} times")


def phase_encode(oracles):
    """Phase 6b: the port's encode side. With the video store in place of
    libx265 (``served_encode``), the port's ``build_fixture_stream``
    rebuilds the :data:`REBUILT` entries from their recipes, each
    byte-equal to its committed stream, host clock. With the store in
    place of the HEVC decode (``served``), the rebuilt streams decode on
    the card: ``flagship_1280_q8`` through ``Decoder`` with one and with
    two GOFs in flight, the roundtrip example through its ``main`` on the
    card; every frame byte-equal to ``oracles`` (phase 6's oracle CLI
    on the committed stream, which the rebuilt one equals) and to the
    manifest's SHA-256, and K1, K2W, K1F and K5 launched as the manifest
    says. Then the rebuilt flagship repeated to :data:`STREAM_GOFS` GOFs,
    frames/s by host clock. The native video bridge is never loaded."""
    import hashlib
    import tempfile

    import numpy as np

    from tpu_vpcc_torch.examples import roundtrip
    from tpu_vpcc_torch.runtime.pipeline import Decoder, Params
    from tpu_vpcc_torch.tools.kernel_times import nvidia_smi_line
    from tpu_vpcc_torch.tools.video_store import (
        FLAGSHIP_BUILD,
        VideoStore,
        flagship_frames,
        served,
        served_encode,
    )
    from tpu_vpcc_torch.utils.fixtures import build_fixture_stream
    from tpu_vpcc_torch.utils.ply import format_ply

    t_phase = time.perf_counter()
    store = VideoStore()
    recipes = {
        STREAM_FLAGSHIP: lambda: build_fixture_stream(flagship_frames(),
                                                      **FLAGSHIP_BUILD),
        "roundtrip": lambda: build_fixture_stream(roundtrip.scene()),
    }
    check(set(recipes) == set(REBUILT) == set(oracles),
          f"phase 6b: recipes {sorted(recipes)}, oracles {sorted(oracles)}")
    smi = nvidia_smi_line()
    with bridge_refused(), served_encode(store), served(store):
        rebuilt = {}
        for name, build in recipes.items():
            t0 = time.perf_counter()
            data = build()
            dt = time.perf_counter() - t0
            check(data == store.entries[name].stream.read_bytes(),
                  f"{name}: the port's rebuild differs from the committed "
                  f"stream")
            rebuilt[name] = data
            print(f"rebuild {name}: the port's build_fixture_stream, the "
                  f"store in place of libx265, {len(data)} bytes "
                  f"byte-equal to the committed stream; host {dt:.3f} s")
        name = STREAM_FLAGSHIP
        e = store.entries[name]
        first = None
        for depth in (1, 2):
            _reset_launches()
            dec = Decoder(Params(rebuilt[name], device="cuda",
                                 pipeline_gofs=depth, **e.params))
            dec.start()
            frames = list(dec)
            _check_launches(name, e, f"pipeline_gofs={depth}")
            check(len(frames) == len(e.outputs),
                  f"{name}: {len(frames)} frames, want {len(e.outputs)}")
            if first is None:
                first = frames
                for ps, o in zip(frames, e.outputs):
                    ply = format_ply(ps)
                    check(ply == oracles[name][o["name"]],
                          f"{name}: {o['name']} differs from the oracle's")
                    check(hashlib.sha256(ply).hexdigest() == o["sha256"],
                          f"{name}: {o['name']} differs from the "
                          f"manifest's digest")
            for k, (ps, ref) in enumerate(zip(frames, first)):
                check(np.array_equal(ps.positions, ref.positions)
                      and np.array_equal(ps.colors, ref.colors),
                      f"{name}: frame {k} at pipeline_gofs={depth} differs")
        print(f"rebuilt {name} on the card: {len(first)} frames "
              f"{[len(f) for f in first]} points, byte-equal to the oracle "
              f"and the manifest at pipeline_gofs 1 and 2; launches "
              f"{_launch_counts()} a decode")
        # frames/s: the rebuilt stream repeated, as phase 6 times the
        # committed one
        data = rebuilt[name] + rebuilt[name][1:] * (STREAM_GOFS - 1)
        n_frames = STREAM_GOFS * len(e.outputs)
        runs = {1: [], 2: []}
        for depth in (1, 2, 2, 1):
            dec = Decoder(Params(data, device="cuda", pipeline_gofs=depth,
                                 **e.params))
            t0 = time.perf_counter()
            dec.start()
            frames = list(dec)
            runs[depth].append(time.perf_counter() - t0)
            check(len(frames) == n_frames,
                  f"{name}: {len(frames)} frames, want {n_frames}")
            for k, ps in enumerate(frames):
                ref = first[k % len(first)]
                check(np.array_equal(ps.positions, ref.positions)
                      and np.array_equal(ps.colors, ref.colors),
                      f"{name}: repeated frame {k} differs")
        print(f"rebuilt {name} through Decoder(Params(stream, device="
              f"'cuda')), {STREAM_GOFS} GOFs of {len(e.outputs)} frames "
              f"({smi}): " + "; ".join(
                  f"pipeline_gofs={d}: runs {[round(s, 4) for s in v]} s, "
                  f"{n_frames / statistics.median(v):.2f} frames/s"
                  for d, v in runs.items()))
        name = "roundtrip"
        e = store.entries[name]
        with tempfile.TemporaryDirectory() as tmp:
            _reset_launches()
            t0 = time.perf_counter()
            rc = roundtrip.main(tmp, device="cuda")
            dt = time.perf_counter() - t0
            launches = _check_launches(name, e, "example")
            check(rc == 0, f"the roundtrip example exited {rc}")
            check((Path(tmp) / "stream.bin").read_bytes() == rebuilt[name],
                  "the roundtrip example's stream differs from the rebuild")
            files = _ply_outputs(tmp, e, "the roundtrip example")
            check(files == oracles[name],
                  "the roundtrip example's files differ from the oracle's")
        print(f"roundtrip example on the card (tpu_vpcc_torch.examples."
              f"roundtrip.main, device 'cuda'): {len(files)} frames "
              f"{[o['points'] for o in e.outputs]} points, byte-equal to "
              f"the oracle and the manifest; launches {launches}; "
              f"{dt:.2f} s ({smi})")
    print(f"phase 6b: {store.encode_hits} encodes served, {store.hits} "
          f"lookups, no native bridge; {time.perf_counter() - t_phase:.1f} s")


def _covered_err(got, ref, valid) -> int:
    """Max |a - b| over K3's covered windows (0 = byte-equal)."""
    from tpu_vpcc_torch.ops import cursor_compact as k3

    cov = k3.covered_elements(valid)
    return words_err(*zip(*((a.reshape(-1)[:cov], b.reshape(-1)[:cov])
                            for a, b in zip(got[:3], ref[:3]))))


def phase_cursor(gof, S_flag: int):
    """K3 against its plain version, on random words and on the first
    flagship GOF's wide words; then the compaction experiment's ``main``
    at batch 2, counted. Returns K3's kernels entry."""
    import torch

    from tpu_vpcc_torch.ops import cursor_compact as k3
    from tpu_vpcc_torch.ops import payload
    from tpu_vpcc_torch.runtime import pipeline as P
    from tpu_vpcc_torch.tools import compaction_experiment as E
    from tpu_vpcc_torch.tools.kernel_times import (
        device_ms,
        measure,
        measured_line,
        nvidia_smi_line,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    lo, hi = -(2 ** 31), 2 ** 31 - 1
    err, n_cases = 0, 0
    # the two-frame flagship wide extent (448 chunks) and two odd chunk
    # counts (7 chunks in one frame and across two)
    for F, S in ((2, S_flag), (1, 7 * k3.CH), (2, 7 * k3.CH // 2)):
        for density in (0.0, 0.3, 0.7, 1.0):
            w = [torch.randint(lo, hi, (F, S), dtype=torch.int32, device=dev,
                               generator=gen) for _ in range(3)]
            valid = torch.rand((F, S), device=dev, generator=gen) < density
            got = k3.cursor_compact(*w, valid)
            ref = k3.cursor_compact_reference(*w, valid)
            torch.cuda.synchronize()
            check(torch.equal(got[3], ref[3]) and int(got[3]) ==
                  int(valid.sum()), f"K3 count {int(got[3])} != plain "
                  f"{int(ref[3])} (F={F} S={S} density={density})")
            e = _covered_err(got, ref, valid)
            check(e == 0, f"K3 differs from plain on the covered windows "
                          f"(F={F} S={S} density={density}, max abs err {e})")
            err = max(err, e)
            n_cases += 1
            print(f"K3 vs plain: F={F} S={S} ({F * S // k3.CH} chunks) "
                  f"density={density}: count {int(got[3])} equal, "
                  f"{k3.covered_elements(valid)} covered elements equal")

    # the flagship's own wide words (K2W on the first GOF's staging)
    cfg, tables, g_bucket = P._gof_tables_and_bucket(gof)
    di = P._gof_device_inputs(gof, gof.metas, (cfg, tables), g_bucket)
    fields, cat = di.on_device(dev)
    w0, w1, w2, valid = payload.wide_words(fields, cat, di.cfg)
    got = k3.cursor_compact(w0, w1, w2, valid)
    ref = k3.cursor_compact_reference(w0, w1, w2, valid)
    torch.cuda.synchronize()
    nc = valid.numel() // k3.CH
    _, _, win = k3._windows(valid)
    writers = int((win[1:] != win[:-1]).sum()) + 1
    check(torch.equal(got[3], ref[3]) and int(got[3]) == int(valid.sum()),
          "K3 count differs at the flagship")
    e = _covered_err(got, ref, valid)
    check(e == 0, f"K3 differs from plain at the flagship ({e})")
    err = max(err, e)
    print(f"K3 vs plain on the flagship's wide words: F={valid.shape[0]} "
          f"S={valid.shape[1]}, {nc} chunks, {writers} last writers, count "
          f"{int(got[3])} equal, covered windows equal")
    print(f"phase 7: {n_cases + 1} K3 cases byte-equal to the plain version")
    # K3 must read the validity once, and the three words of each
    # element its covered windows end with, write those words, and the
    # count
    k3_bytes = valid.numel() + k3.covered_elements(valid) * 12 * 2 + 4
    m = measure(lambda: k3._cursor_compact_cuda(w0, w1, w2, valid),
                lambda: k3.cursor_compact_reference(w0, w1, w2, valid),
                nbytes=k3_bytes)
    smi = nvidia_smi_line()
    print(measured_line("K3 on the first flagship GOF's wide words, two "
                        "frames", m, smi))
    from tpu_vpcc_torch.ops import shift_compact as sc

    k1f_ms = device_ms(
        lambda: sc._shift_compact_full_cuda((w0, w1, w2), valid))
    print(f"K1F on the same words ({smi}): device-only {k1f_ms:.4f} ms")

    # the experiment's entry point, counted
    torch.cuda.synchronize()
    k3.reset_launches()
    t0 = time.perf_counter()
    rc = E.main(["2", "20"])
    torch.cuda.synchronize()
    launches = k3.launches
    check(rc == 0, f"the compaction experiment exited {rc}")
    check(launches > 0, "the compaction experiment launched K3 no time")
    print(f"compaction experiment: batch 2 in {time.perf_counter() - t0:.2f} "
          f"s, K3 launches {launches} ({smi})")
    return dict(m, name="cursor_compact", route="cuda", source=K3_SOURCE,
                replaces=K3_REPLACES, launches=launches, max_abs_err=err,
                card=smi)


def _probe_check(cases_k, cases_p, where, twice=False):
    """Kernel cases against the plain cases and both against ``want``
    (``kernel_times.mismatches``)."""
    from tpu_vpcc_torch.tools.kernel_times import mismatches

    bad = mismatches(cases_k, cases_p, where, twice)
    check(not bad, "; ".join(bad))
    for k in cases_k:
        print(f"{k.name} ({where}): kernel OK, plain OK, equal")


def phase_probes():
    """The three probe tools through their entry points, counted; every
    probe against its plain version and its ``want`` at the probe's shape,
    P10 and P11, P4, P5 and P8 at their edge shapes, and every probe at about
    64 MiB per operand with its device-only times. Returns the probes'
    kernels entries."""
    import torch

    from tpu_vpcc_torch.ops import probes
    from tpu_vpcc_torch.tools import hopper_probe as H1
    from tpu_vpcc_torch.tools import hopper_probe2 as H2
    from tpu_vpcc_torch.tools import hopper_probe3 as H3
    from tpu_vpcc_torch.tools.kernel_times import (
        NO_LIBRARY,
        edge_cases,
        event_ms,
        measured_line,
        nvidia_smi_line,
        time_probe,
    )

    tools = {"hopper_probe": H1, "hopper_probe2": H2, "hopper_probe3": H3}
    torch.cuda.synchronize()
    probes.reset_launches()
    for name, mod in tools.items():
        rc = mod.main(["--device", "cuda"])
        check(rc == 0, f"{name} exited {rc}")
    torch.cuda.synchronize()
    launches = dict(probes.launches)
    check(all(launches[p] > 0 for p in probes.PROBES),
          f"a probe kernel was launched no time: {launches}")
    print(f"probe tools: launches per probe {launches}")

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    small = {}  # probe -> (kernel ms, plain ms), single calls
    for fn in (fn for mod in tools.values() for fn in mod.PROBE_FUNCTIONS):
        cases_k = fn(dev, probes.call)
        cases_p = fn(dev, probes.plain)
        torch.cuda.synchronize()
        _probe_check(cases_k, cases_p, "probe shape")
        c = cases_k[0]
        small[c.probe] = tuple(
            event_ms(lambda run=run, c=c: run(c.probe, *c.args), reps=10)
            for run in (probes.call, probes.plain))
    for R, L in H3.EDGE_SHAPES:
        for fn in (H3.probe_repeat, H3.probe_rev):
            cases_k = fn(dev, probes.call, R=R, L=L)
            cases_p = fn(dev, probes.plain, R=R, L=L)
            torch.cuda.synchronize()
            _probe_check(cases_k, cases_p, f"R={R} L={L}")
    for _, where, fn in edge_cases():
        cases_k = fn(dev, probes.call)
        cases_p = fn(dev, probes.plain)
        torch.cuda.synchronize()
        _probe_check(cases_k, cases_p, where, twice=True)
    big = {}
    for probe in probes.PROBES:
        try:
            big[probe] = time_probe(probe, dev)
        except AssertionError as e:
            raise SmokeFailure(str(e)) from None
        print(f"{probe} (64 MiB): kernel OK, plain OK, equal")
    for probe in probes.PROBES:
        k, p = small[probe]
        print(f"{probe} at the probe's shape ({smi}): single call kernel "
              f"{k:.4f} ms vs plain {p:.4f} ms")
        print(measured_line(f"{probe} at 64 MiB per operand", big[probe], smi))
        if probe in NO_LIBRARY:
            print(f"  {probe} library call: {NO_LIBRARY[probe]}")
    print("phase 8: every probe OK against its plain version and want")
    return [
        dict(big[p], name=f"{p} {PROBE_ENTRIES[p]}", route="cuda",
             source=PROBES_SOURCE, replaces=PROBE_REPLACES[p],
             launches=launches[p], max_abs_err=0, card=smi)
        for p in probes.PROBES
    ]


def run_batcher(streams, stats=None):
    """The batcher's wave loop on the card over prepared GOFs (one list
    per stream; the prep hands out each stream's next GOF); each
    stream's frames, in order."""
    from tpu_vpcc_torch.parallel import batcher as B
    from tpu_vpcc_torch.runtime.pipeline import Params

    out = [[] for _ in streams]
    for s, f, ps in B._decode_waves([iter(g) for g in streams],
                                    lambda it: next(it, None),
                                    Params(device="cuda"), stats=stats):
        check(f == len(out[s]), f"stream {s}: frame {f} out of order")
        out[s].append(ps)
    return out


def phase_batcher(gofs, narrow_out, wide_gofs, wide_out, gather_gofs,
                  gather_out):
    """The multi-stream batcher on the card (see the module note): 8
    streams of two prepared GOFs, counted, each frame byte-equal to its
    earlier decode; then frames/s beside ``Decoder.start_gofs``, the stage
    split, peak memory and the narrow merged input at chunks of 2-12."""
    from dataclasses import replace

    import numpy as np
    import torch

    from tpu_vpcc_torch.ops import pack, payload
    from tpu_vpcc_torch.ops import shift_compact as sc
    from tpu_vpcc_torch.ops.tiled import reconstruct_batch_pretiled_packed
    from tpu_vpcc_torch.parallel import batcher as B
    from tpu_vpcc_torch.runtime import pipeline as P
    from tpu_vpcc_torch.tools.kernel_times import event_ms, nvidia_smi_line
    from tpu_vpcc_torch.utils.stats import GofStats

    smi = nvidia_smi_line()
    # streams 0-5: phase 3's narrow GOFs; 6: phase 5's smoothed and 45°
    # GOFs; 7: phase 5b's GOFs R and W
    streams = [list(gofs)] * 6 + [list(wide_gofs), list(gather_gofs[:2])]
    want = [list(narrow_out)] * 6 + [list(wide_out), list(gather_out[:4])]
    n_frames = sum(len(w) for w in want)

    calls = []  # (via, frames, layout) of every _dispatch_device call
    real_device = P._dispatch_device

    def spy(via):
        def dispatch(di, device, stats=None, mesh=None):
            calls.append((via, di.n_frames, di.layout))
            return real_device(di, device, stats=stats, mesh=mesh)
        return dispatch

    # the batcher's main path, counted: one call through the batcher per
    # merged input, which splits into chunks through the pipeline's name
    B._dispatch_device, P._dispatch_device = spy("batcher"), spy("pipeline")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sc.reset_launches()
        payload.reset_launches()
        pack.reset_launches()
        t0 = time.perf_counter()
        out = run_batcher(streams)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = {"K1": sc.launches, "K2W": payload.launches,
                    "K1F": sc.full_launches, "K5": pack.launches}
        peak = torch.cuda.max_memory_allocated()
    finally:
        B._dispatch_device = P._dispatch_device = real_device
    merged = [(f, layout) for via, f, layout in calls if via == "batcher"]
    chunks = [(f, layout) for _, f, layout in calls if f <= P.DEVICE_BATCH]
    n = {k: sum(1 for c in chunks if c[1] == k)
         for k in ("narrow", "wide", "gather")}
    print(f"batcher main path: 8 streams of 2 GOFs, {n_frames} frames in "
          f"{first_s:.3f} s (first run), merged inputs (frames, path) "
          f"{merged}, chunks per path {n}, launches {launches}")
    check(sorted(merged[:3]) == [(2, "gather"), (2, "wide"), (12, "narrow")],
          f"the first wave's merged inputs are {merged[:3]}, want the 12 "
          f"narrow frames of streams 0-5 in one, the wide and the gather "
          f"GOF alone")
    first_narrow = next(i for i, c in enumerate(chunks) if c[1] == "narrow")
    check(chunks[first_narrow:first_narrow + 6] == [(P.DEVICE_BATCH,
                                                     "narrow")] * 6,
          f"the 12-frame narrow input was not dispatched as 6 chunks of "
          f"{P.DEVICE_BATCH}: {chunks}")
    check(launches == {"K1": n["narrow"], "K2W": n["wide"],
                       "K1F": n["wide"] + n["gather"],
                       "K5": n["narrow"] + n["wide"]},
          f"launches {launches} for {n} chunks")
    for s, (got, ref) in enumerate(zip(out, want)):
        check(len(got) == len(ref), f"stream {s}: {len(got)} frames, want "
                                    f"{len(ref)}")
        for f, (a, b) in enumerate(zip(got, ref)):
            check(np.array_equal(a.positions, b.positions)
                  and np.array_equal(a.colors, b.colors),
                  f"stream {s} frame {f}: {len(a)} points differ from the "
                  f"earlier decode's {len(b)}")
    print(f"batcher: all {n_frames} frames of the 8 streams byte-equal to "
          f"phases 3, 5 and 5b (peak device memory {peak / 2 ** 20:.0f} "
          f"MiB, {smi})")

    # frames/s after the counted run as warm-up, in turns with the
    # Decoder over the same 16 GOFs one stream after another
    flat = [g for stream in streams for g in stream]
    runs = {"batcher": [], "Decoder": []}
    stages = GofStats()
    for name in ("batcher", "Decoder", "Decoder", "batcher"):
        t0 = time.perf_counter()
        got = (sum(len(x) for x in run_batcher(streams, stats=stages))
               if name == "batcher" else len(decode_gofs(flat, depth=2)))
        torch.cuda.synchronize()
        runs[name].append(time.perf_counter() - t0)
        check(got == n_frames, f"{name} emitted {got} frames")
    print(f"aggregate frames/s (host clock, {n_frames} frames, {smi}): "
          + "; ".join(f"{k}: runs {[round(x, 4) for x in v]} s, "
                      f"{n_frames / statistics.median(v):.1f} frames/s"
                      for k, v in runs.items())
          + " (Decoder: pipeline_gofs=2)")
    sec = stages.stage_seconds
    split = {"staging": sec.get("recon_tables", 0) + sec.get("recon_stage", 0),
             "dispatch": sec.get("recon_dispatch", 0),
             "fetch": sec.get("recon_fetch", 0),
             "emit": sec.get("recon_emit", 0)}
    reps = len(runs["batcher"])
    print(f"batcher stage split (host clock, ms per pass of {n_frames} "
          f"frames, {smi}): " + ", ".join(
              f"{k} {v * 1e3 / reps:.1f}" for k, v in split.items()))

    # the 12-frame narrow merged input at chunks of 2, 4, 6 and 12 frames
    cfg, tables, g_bucket = P._gof_tables_and_bucket(gofs[0])
    di = B._concat_inputs(
        [P._gof_device_inputs(gofs[0], gofs[0].metas, (cfg, tables),
                              g_bucket)] * 6)
    dev = torch.device("cuda")

    def dispatch_all(chunk):
        for i in range(0, di.n_frames, chunk):
            sub = replace(di, arrays=tuple(a[i:i + chunk] for a in di.arrays))
            reconstruct_batch_pretiled_packed(*sub.on_device(dev), di.cfg)

    lines = []
    try:
        for chunk in (2, 4, 6, 12):
            P.DEVICE_BATCH = chunk
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            whole = []
            for _ in range(3):
                t0 = time.perf_counter()
                res = P._dispatch_device(di, dev)
                whole.append(time.perf_counter() - t0)
            check(len(res) == di.n_frames, f"chunk {chunk}: {len(res)} frames")
            ms = event_ms(lambda: dispatch_all(chunk), reps=5, warmup=1)
            lines.append(
                f"chunk {chunk}: dispatch incl. H2D {ms:.3f} ms (CUDA "
                f"events), whole {statistics.median(whole) * 1e3:.1f} ms "
                f"(host clock, runs {[round(x * 1e3, 1) for x in whole]}), "
                f"peak {torch.cuda.max_memory_allocated() / 2 ** 20:.0f} MiB")
    finally:
        P.DEVICE_BATCH = 2
    print(f"narrow merged input of {di.n_frames} frames by chunk size, "
          f"device-packed ({smi}): " + "; ".join(lines))


def phase_color():
    """The colour proof on the card: ``rgb8_from_yuv16`` against the f64
    chain over all 2^30 10-bit (y, u, v) triples."""
    from tpu_vpcc_torch.tools import verify_color_exact
    from tpu_vpcc_torch.tools.kernel_times import nvidia_smi_line

    t0 = time.perf_counter()
    rc = verify_color_exact.main(["--device", "cuda"])
    check(rc == 0, "verify_color_exact found mismatches on the card")
    print(f"colour proof: 0 mismatches in r, g and b over the whole 10-bit "
          f"domain in {time.perf_counter() - t0:.2f} s ({nvidia_smi_line()})")


def _same_frames(a, b) -> bool:
    import numpy as np

    return (a.positions.shape == b.positions.shape
            and np.array_equal(a.positions, b.positions)
            and np.array_equal(a.colors, b.colors))


def _moved(smoothed, plain):
    """Positions and colours smoothing moved: rows that differ."""
    pos = sum(int((a.positions != b.positions).any(axis=1).sum())
              for a, b in zip(smoothed, plain))
    col = sum(int((a.colors != b.colors).any(axis=1).sum())
              for a, b in zip(smoothed, plain))
    return pos, col


def phase_mesh(gofs, narrow_out, wide_gofs, wide_out, gather_gofs,
               gather_out):
    """Phase 11, the device mesh (see the module note): phase 3's narrow
    GOFs, phase 5's smoothed and 45-degree GOFs and phase 5b's GOF R
    through ``Decoder.start_gofs`` with ``Params(mesh=...)``, counted and
    byte-equal to their meshless decodes; the gather drivers against the
    unsharded gather at GOF R's shape; dispatch and ``combine_stats``
    times, peak memory per device."""
    import numpy as np
    import torch

    from tpu_vpcc_torch.ops import pack, payload
    from tpu_vpcc_torch.ops import shift_compact as sc
    from tpu_vpcc_torch.ops import smoothing as S
    from tpu_vpcc_torch.ops.reconstruct import reconstruct_batch
    from tpu_vpcc_torch.ops.tiled import (
        _unpack_ops_points,
        gather_inputs_to_device,
    )
    from tpu_vpcc_torch.parallel.mesh import (
        make_mesh,
        pad_batch,
        reconstruct_batch_data_parallel,
    )
    from tpu_vpcc_torch.parallel.spatial import (
        reconstruct_gof_spatial,
        stitch_spatial,
    )
    from tpu_vpcc_torch.runtime import pipeline as P
    from tpu_vpcc_torch.runtime.pipeline import Decoder, Params
    from tpu_vpcc_torch.tools.kernel_times import event_ms, nvidia_smi_line

    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    card0 = torch.device("cuda", 0)
    layouts = [("cuda:0 named 4 times", [card0] * 4, 1, 4),
               ("cuda:0 named 4 times", [card0] * 4, 2, 2)]
    if torch.cuda.device_count() >= 4:
        cards = [torch.device("cuda", i) for i in range(4)]
        layouts += [("4 distinct cards", cards, d, s)
                    for d, s in ((1, 4), (2, 2), (4, 1))]
    sets = {  # name: (GOFs, their meshless decode)
        "narrow": (list(gofs), list(narrow_out)),
        "wide": (list(wide_gofs), list(wide_out)),
        "gather R": (list(gather_gofs[:1]), list(gather_out[:2])),
    }
    n_sm = len(wide_gofs[0].metas)
    moved_want = _moved(wide_out[:n_sm], narrow_out[:n_sm])
    print(f"phase 11: the mesh on {torch.cuda.device_count()} card(s), "
          f"layouts {[(lbl, d, s) for lbl, _, d, s in layouts]}; phase 5's "
          f"smoothing moved {moved_want[0]} positions and {moved_want[1]} "
          f"colours")

    # GOF R's gather arrays, bucketed to a multiple of every 'space' size
    gof_r = gather_gofs[0]
    cfg, tables, g_bucket = P._gof_tables_and_bucket(gof_r, 4)
    di_r = P._gof_device_inputs(gof_r, gof_r.metas, (cfg, tables), g_bucket)
    check(not di_r.use_tiled, "GOF R would take a tiled path")
    ops, cnt_t = reconstruct_batch(
        *gather_inputs_to_device(*di_r.arrays, card0), di_r.cfg)
    pos_t, col_t = _unpack_ops_points(ops, "gather")
    unsharded_cnt = cnt_t.cpu().numpy()
    unsharded = [(P._u16_host(pos_t[k, :n]), P._u16_host(col_t[k, :n]))
                 for k, n in enumerate(unsharded_cnt)]
    # the narrow GOF 0 and the smoothed GOF staged for the dispatch timings
    staged = {}
    for name, g in (("narrow", gofs[0]), ("wide", wide_gofs[0])):
        cfg_g, tables_g, bucket = P._gof_tables_and_bucket(g, 4)
        staged[name] = P._gof_device_inputs(g, g.metas, (cfg_g, tables_g),
                                            bucket)

    real_combine = S.combine_stats
    for label, devs, data, space in layouts:
        mesh = make_mesh(devs, data=data, space=space)
        distinct = list(dict.fromkeys(devs))
        where = f"({data}, {space}) on {label}"

        def sync():
            for d in distinct:
                torch.cuda.synchronize(d)

        for d in distinct:
            torch.cuda.reset_peak_memory_stats(d)
        # the mesh main path, counted: each set decoded with the counts
        # set to 0 just before and read just after
        for name, (set_gofs, want) in sets.items():
            chunk = P.DEVICE_BATCH * (1 if name == "gather R" else data)
            chunks = sum(-(-len(g.metas) // chunk) for g in set_gofs)
            sync()
            sc.reset_launches()
            payload.reset_launches()
            pack.reset_launches()
            S.reset_launches()
            t0 = time.perf_counter()
            dec = Decoder(Params(device="cuda", mesh=mesh))
            dec.start_gofs(set_gofs)
            out = list(dec)
            sync()
            secs = time.perf_counter() - t0
            launches = {"K1": sc.launches, "K2W": payload.launches,
                        "K1F": sc.full_launches, "K5": pack.launches,
                        "smoothing": S.launches}
            fallbacks = dec.stats.counter_totals().get(
                "mesh_fallback_dispatches", 0)
            shards = data * space
            # K5 runs once on each distinct device of each data row
            rows = sum(len(dict.fromkeys(mesh.devices[r]))
                       for r in range(data))
            # the smoothing kernels: three a pass on every shard of a
            # smoothed GOF's chunks (the gather fallback runs unsharded)
            smoothing = sum(smooth_launches(
                g, -(-len(g.metas) // chunk),
                1 if name == "gather R" else shards) for g in set_gofs)
            expect = {
                "narrow": {"K1": shards * chunks, "K2W": 0, "K1F": 0,
                           "K5": rows * chunks},
                "wide": {"K1": 0, "K2W": shards * chunks,
                         "K1F": shards * chunks, "K5": rows * chunks},
                "gather R": {"K1": 0, "K2W": 0, "K1F": chunks, "K5": 0},
            }[name]
            expect["smoothing"] = smoothing
            check((smoothing > 0) == (name == "wide"),
                  f"{where}, {name}: {smoothing} smoothing launches due")
            check(launches == expect,
                  f"{where}, {name}: launches {launches}, want {expect} "
                  f"({shards} shards x {chunks} chunks, K5 {rows} "
                  f"row devices x {chunks} chunks, smoothing 3 a pass on "
                  f"each shard of the smoothed GOF's chunks)")
            check((fallbacks >= 1) == (name == "gather R"),
                  f"{where}, {name}: {fallbacks} mesh fallback dispatches")
            check(len(out) == len(want), f"{where}, {name}: {len(out)} "
                                         f"frames for {len(want)}")
            for k, (a, b) in enumerate(zip(out, want)):
                check(_same_frames(a, b) and len(a) > 0,
                      f"{where}, {name} frame {k}: {len(a)} points differ "
                      f"from the meshless decode's {len(b)}")
            line = (f"mesh {where}: {name}, {len(set_gofs)} GOFs, "
                    f"{len(out)} frames byte-equal to the meshless decode "
                    f"in {secs:.3f} s, launches {launches} = {shards} shards "
                    f"x {chunks} chunks (K5: {rows} row devices x {chunks} "
                    f"chunks), mesh_fallback_dispatches {fallbacks}")
            if name == "wide":
                moved = _moved(out[:n_sm], narrow_out[:n_sm])
                check(moved == moved_want and moved[0] > 0,
                      f"{where}: smoothing moved {moved}, phase 5 "
                      f"{moved_want}")
                line += (f", smoothing moved {moved[0]} positions and "
                         f"{moved[1]} colours as in phase 5")
            print(line)

        # the gather drivers at GOF R's shape against the unsharded gather
        arrays = [pad_batch(a, data) for a in di_r.arrays]
        s_loc = g_bucket // space * cfg.slots_per_block
        before = sc.full_launches
        pos, col, cnt, tot = reconstruct_gof_spatial(mesh, *arrays, di_r.cfg)
        spatial_launches = sc.full_launches - before
        dp_pos, dp_col, dp_cnt = reconstruct_batch_data_parallel(
            mesh, *arrays, di_r.cfg)
        for k, (up, uc) in enumerate(unsharded):
            gp, gc = stitch_spatial(pos[k], col[k], cnt[k], s_loc)
            n = len(up)
            check(int(tot[k, 0]) == n and np.array_equal(gp, up)
                  and np.array_equal(gc, uc),
                  f"{where}: reconstruct_gof_spatial frame {k} stitches to "
                  f"{len(gp)} points, unsharded {n}")
            check(int(dp_cnt[k]) == n and np.array_equal(dp_pos[k, :n], up)
                  and np.array_equal(dp_col[k, :n], uc),
                  f"{where}: reconstruct_batch_data_parallel frame {k} "
                  f"differs from the unsharded gather")
        print(f"mesh {where}: reconstruct_gof_spatial (counts "
              f"{cnt.tolist()}, {spatial_launches} K1F launches) and "
              f"reconstruct_batch_data_parallel equal the unsharded gather "
              f"at GOF R's shape ({g_bucket} groups, totals "
              f"{tot[:, 0].tolist()})")

        # the host clock of a dispatch with and without the mesh, in turns
        disp = []
        for name, di in staged.items():
            runs = {"meshless": [], "mesh": []}
            for which in ("meshless", "mesh", "mesh", "meshless",
                          "meshless", "mesh"):
                sync()
                t0 = time.perf_counter()
                P._dispatch_device(di, card0, mesh=(
                    mesh if which == "mesh" else None))
                sync()
                runs[which].append(time.perf_counter() - t0)
            disp.append(f"{name} " + ", ".join(
                f"{w} {statistics.median(v) * 1e3:.2f} ms (runs "
                f"{[round(x * 1e3, 2) for x in v]})"
                for w, v in runs.items()))
        print(f"mesh {where}: dispatch of {len(staged['narrow'].arrays[0])} "
              f"frames incl. staging's H2D and fetch (host clock, {smi}): "
              + "; ".join(disp))

        # combine_stats on the smoothing GOF's geometry grids of every shard
        captured = []

        def capture(stats, devices):
            if not captured:
                captured.append((stats, devices))
            return real_combine(stats, devices)

        S.combine_stats = capture
        try:
            P._dispatch_device(staged["wide"], card0, mesh=mesh)
        finally:
            S.combine_stats = real_combine
        stats, cdevs = captured[0]
        one = sum(t.numel() * t.element_size() for t in stats[0])
        n_out = len(dict.fromkeys(cdevs))
        ev = event_ms(lambda: real_combine(stats, cdevs), reps=10)
        host = []
        for _ in range(5):
            sync()
            t0 = time.perf_counter()
            real_combine(stats, cdevs)
            sync()
            host.append(time.perf_counter() - t0)
        print(f"mesh {where}: combine_stats of {len(stats)} shards' geometry "
              f"grids, {one:,} B a shard ({len(stats[0])} int32 grids of "
              f"{stats[0][0].numel():,} cells): reads {one * len(stats):,} "
              f"B, writes {one * n_out:,} B; {ev:.4f} ms (CUDA events on "
              f"{cdevs[0]}), {statistics.median(host) * 1e3:.3f} ms (host "
              f"clock, all devices synchronised), {smi}")
        print(f"mesh {where}: peak device memory "
              + ", ".join(f"{d} {torch.cuda.max_memory_allocated(d) / 2 ** 20:.0f}"
                          f" MiB" for d in distinct))
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s")


#: the meshes of phase 12's dry runs on ``cuda:0``: 1, 2, 3, 4 and 8
#: devices, that is 1, 1, 3, 2 and 4 'data' rows
GRAFT_MESHES = (1, 2, 3, 4, 8)


def phase_graft():
    """Phase 12, the port's graft entry (``tpu_vpcc_torch.graft_entry``)
    on the card: ``entry("cuda")``'s dispatch against ``entry("cpu")``'s
    plain versions (counts equal, compacted prefixes byte-equal; K5 and
    K1 launched once), then ``dryrun_multichip(n, "cuda:0")`` for the
    :data:`GRAFT_MESHES` and, on a machine with several cards,
    ``dryrun_multichip(device_count, "cuda")`` over distinct cards; each
    dry run authors its stream with the port's builder, serves its video
    from the store and raises on a mismatch with the oracle, and K5, K2W,
    K1F and K1 are each launched. The native video bridge is never
    loaded."""
    import torch

    from tpu_vpcc_torch import graft_entry
    from tpu_vpcc_torch.tools.kernel_times import nvidia_smi_line
    from tpu_vpcc_torch.tools.video_store import VideoStore

    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    secs = {}
    with bridge_refused():
        fn, args = graft_entry.entry("cuda")
        _reset_launches()
        t0 = time.perf_counter()
        ops, counts = fn(*args)
        torch.cuda.synchronize()
        secs["entry"] = time.perf_counter() - t0
        launches = _launch_counts()
        check(launches == {"K1": 1, "K2W": 0, "K1F": 0, "K5": 1},
              f"entry('cuda'): kernel launches {launches}, want K5 1, K1 1")
        fn_c, args_c = graft_entry.entry("cpu")
        ops_c, counts_c = fn_c(*args_c)
        check(torch.equal(counts.cpu(), counts_c) and int(counts_c[0]) > 0,
              f"entry('cuda'): counts {counts.tolist()}, plain "
              f"{counts_c.tolist()}")
        check(len(ops) == len(ops_c) and all(
            torch.equal(a[f, :n].cpu(), b[f, :n])
            for a, b in zip(ops, ops_c)
            for f, n in enumerate(counts_c.tolist())),
              "entry('cuda'): a compacted prefix differs from the plain "
              "version's")
        print(f"graft entry('cuda'): {len(ops)} operands, counts "
              f"{counts_c.tolist()}, byte-equal to entry('cpu'); launches "
              f"{launches}")
        store = VideoStore()
        runs = [(n, "cuda:0") for n in GRAFT_MESHES]
        if torch.cuda.device_count() > 1:
            runs.append((torch.cuda.device_count(), "cuda"))
        for n, device in runs:
            _reset_launches()
            t0 = time.perf_counter()
            graft_entry.dryrun_multichip(n, device, store=store)
            torch.cuda.synchronize()
            secs[f"dryrun_multichip({n}, {device!r})"] = \
                time.perf_counter() - t0
            launches = _launch_counts()
            check(min(launches.values()) > 0,
                  f"dryrun_multichip({n}, {device!r}): kernel launches "
                  f"{launches}, want each of K5, K2W, K1F, K1")
            print(f"graft dryrun_multichip({n}, {device!r}): passed, "
                  f"launches {launches}")
    print(f"phase 12 ({smi}): seconds "
          + ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
          + f"; store: {store.encode_hits} encodes served, {store.hits} "
          f"lookups; no native bridge; {time.perf_counter() - t_phase:.1f} s")


def _ok_lines(smi: str) -> None:
    import torch

    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


def mesh_only(t_script) -> int:
    """``python3 chip_smoke.py --mesh-only``: the builds, the meshless
    decodes phase 11 compares with, phase 11 and phase 12; for a machine
    with four cards, where the other phases would only repeat the
    one-card run."""
    from tpu_vpcc_torch.tools.kernel_times import TimingError, nvidia_smi_line

    try:
        phase_build()
        fcfg, frame_sets, gofs, _ = flagship_inputs()
        wide_gofs, gather_gofs, narrow_out, wide_out, gather_out = \
            mesh_only_inputs(fcfg, frame_sets, gofs)
        phase_mesh(gofs, narrow_out, wide_gofs, wide_out, gather_gofs,
                   gather_out)
        phase_graft()
        print(f"script: {time.perf_counter() - t_script:.1f} s")
    except (SmokeFailure, TimingError) as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    _ok_lines(nvidia_smi_line())
    return 0


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
    from tpu_vpcc_torch.tools.kernel_times import TimingError

    t_script = time.perf_counter()
    if sys.argv[1:] == ["--mesh-only"]:
        return mesh_only(t_script)
    if sys.argv[1:]:
        print(f"FAIL: unknown arguments {sys.argv[1:]} (none, or --mesh-only)",
              file=sys.stderr)
        return 1
    try:
        phase_build()
        fcfg, frame_sets, gofs, S_flag = flagship_inputs()
        phase_k1(S_flag)
        k1f_err = phase_k1f(S_flag)
        k5 = phase_k5(gofs[0])
        k1, narrow_out, k5["launches"] = phase_flagship(frame_sets, gofs)
        k2w_err = phase_k2w(gofs[0])
        wide, wide_gofs, wide_out = phase_wide(fcfg, frame_sets, narrow_out,
                                               k1f_err, k2w_err)
        gather, gather_gofs, gather_out = phase_gather(fcfg, frame_sets,
                                                       narrow_out)
        phase_encode(phase_stream())
        k3 = phase_cursor(gofs[0], S_flag)
        probe_kernels = phase_probes()
        t0 = time.perf_counter()
        phase_batcher(gofs, narrow_out, wide_gofs, wide_out, gather_gofs,
                      gather_out)
        phase_color()
        print(f"phases 9-10: {time.perf_counter() - t0:.1f} s; script so "
              f"far: {time.perf_counter() - t_script:.1f} s")
        phase_mesh(gofs, narrow_out, wide_gofs, wide_out, gather_gofs,
                   gather_out)
        phase_graft()
        print(f"script so far: {time.perf_counter() - t_script:.1f} s")
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                        ("jax", "jaxlib", "tpu_vpcc"))
        check(not loaded, f"jax or the JAX package was imported: {loaded}")
    except (SmokeFailure, TimingError) as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    from tpu_vpcc_torch.tools.kernel_times import nvidia_smi_line

    smi = nvidia_smi_line()
    kernels = [dict(k, card=k.get("card", smi))
               for k in [k1] + wide + [gather, k3, k5] + probe_kernels]
    print(json.dumps({"kernels": kernels}))
    _ok_lines(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
