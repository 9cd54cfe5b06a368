"""The cursor compaction experiment on the card: how much could a single
compaction pass with a carried cursor save over the full-order compaction
K1F?

Counterpart of ``tools/compaction_experiment.py`` (its ``main`` and the
variants ``run_full``, ``run_nosort`` and ``run_pallas_cursor``). On the
same flagship inputs (``FlagshipConfig(batch=batch)``: 1280², 48 patches,
occupancy fill 0.7, the pipeline's group bucketing, staged as a
host-packed cat), four variants, each ending in the unpacked
``(positions, colors16, counts)``:

  full        the narrow main path: gather + words + K1 + unpack;
  nosort      K2W wide words + a direct unpack, no compaction (output
              uncompacted: a cost probe, not a result);
  full_order  K2W + K1F + unpack;
  cursor      K2W + K3 (``ops.cursor_compact``: the cursor pass, whose data
              output is deliberately uncompacted chunks; only its count and
              its traffic are real) + unpack.

Each is timed as ms per frame: on a card by its device-only time
(``kernel_times.device_ms``: the card's own time per call, from a whole
``torch.profiler`` trace of ``reps`` back-to-back calls, so the host's
enqueue is not in it), on the CPU by the host clock. ``ceiling_ms =
full_order - nosort`` is K1F's marginal cost: the most any single-pass
redesign of K1F could save. ``floor_ms = cursor - nosort`` is the marginal
cost of moving the chunks with a carried cursor and no packing work: any
single pass costs at least that. Each variant is timed twice, in turns;
``spread_ms`` is the largest gap between the two times of ``nosort``,
``full_order`` or ``cursor``. Decision
rule: if the ceiling, or its gap to the floor, is below the noise (the
larger of ``spread_ms`` and a negative floor's size, since no pass costs
less than none), the verdict is unresolved; else if ``floor_ms >=
ceiling_ms``, a single pass cannot beat K1F; otherwise it could save at
most ``ceiling_ms - max(floor_ms, 0)`` per frame. The cursor's count is checked against the sum of
``full``'s counts.

    python -m tpu_vpcc_torch.tools.compaction_experiment [batch] [reps] \\
        [variants] [--device cuda|cpu] [--size W] [--patches P]

``variants`` is a comma list (default all four). The reference's other
variants (sorts, split sorts, segment sorts, megarow/megaraw/raw gathers,
cell tables) are TPU workarounds and raise; so does its ``fori_loop``
K-vs-1 timing harness, which the device-only times replace. Without ``--device
cpu`` the tool needs a card and raises when it finds none; on the CPU it
runs the plain versions and times them by the host clock.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

from ..models.flagship import (
    FlagshipConfig,
    bucket_flagship_inputs,
    example_batch_inputs,
)
from ..ops.cursor_compact import cursor_compact
from ..ops.payload import wide_words
from ..ops.shift_compact import shift_compact_full
from ..ops.tiled import (
    _hi16,
    _lo16,
    _unpack_ops_points,
    reconstruct_batch_pretiled_packed,
    stage_cat_inputs,
    tile_plane,
    to_device,
)
from . import resolve_device
from .kernel_times import device_ms

VARIANTS = ("full", "nosort", "full_order", "cursor")

#: the reference's variants that are TPU workarounds, not ported
NOT_PORTED = (
    "raw_gather", "raw_nosort", "raw_slicerows", "megarow", "megaraw",
    "sort_primitive", "halfsplit", "split2", "split4", "split8", "split16",
    "split32", "split64", "splitb8", "splitb16", "splitb48", "splitb64",
    "splitb96", "splitb192", "splitb384", "splitb96tree", "splitb48tree",
    "mega_nosort", "raw_noup", "raw_blocksorted", "cell_full",
    "nosort_narrow", "nosort_narrow_nocolor", "nosort_nofix",
    "nosort_nocolor", "payload_sort", "packed_sort", "key_iota_sort",
    "scatter_partition", "narrow_stable", "narrow_unique", "segsort_8k",
    "segsort_2k",
)
_RENAMED = {"full_sort": "full", "pallas_cursor": "cursor"}


def stage_inputs(raw, fcfg, device):
    """Flagship raster inputs -> the staged dispatch on ``device``: the
    pipeline's group bucketing and pack30 gating, the planes tiled as
    ``main`` of the reference tiles them, and the host-packed,
    host-oriented cat. Returns ``(fields, cat, cfg, tiled)``; ``tiled``
    are the host arrays before packing (the reference's inputs)."""
    raw, fcfg, _g_bucket, _n_live = bucket_flagship_inputs(raw, fcfg)
    res = fcfg.occupancy_resolution
    tiled = (
        raw[0],
        tile_plane(raw[1], res // fcfg.occupancy_precision),
        tile_plane(raw[2], res),
        tile_plane(raw[3], res),
        tile_plane(raw[4], res),
        tile_plane(raw[5], res // 2),
        tile_plane(raw[6], res // 2),
    )
    (fields, cat), cfg = stage_cat_inputs(*tiled, fcfg)
    fields_t, cat_t = to_device(fields, cat, device)
    return fields_t, cat_t, cfg, tiled


def flagship_inputs(batch: int, device, size: int = 1280, patches: int = 48,
                    seed: int = 0):
    """The experiment's inputs: ``batch`` synthetic frames of ``size``²
    (frame k from seed ``seed + k``), staged on ``device``."""
    cfg = FlagshipConfig(width=size, height=size, batch=batch)
    raw = example_batch_inputs(cfg, seed=seed, occupancy_fill=0.7,
                               n_patches=patches)
    return stage_inputs(raw, cfg.frame_config(), device)


def _unpack(w0, w1, w2, F, S):
    """(positions, colors16), each (F, S, 3) int32, from (F, S) wide
    words, as ``run_nosort``/``run_pallas_cursor`` unpack them."""
    positions = torch.stack([_lo16(w0), _hi16(w0), _lo16(w1)], dim=-1)
    colors16 = torch.stack([_hi16(w1), _lo16(w2), _hi16(w2)], dim=-1)
    return positions.reshape(F, S, 3), colors16.reshape(F, S, 3)


def run_full(fields, cat, cfg):
    ops, counts = reconstruct_batch_pretiled_packed(fields, cat, cfg)
    positions, colors16 = _unpack_ops_points(ops, "narrow")
    return positions, colors16, counts


def run_nosort(fields, cat, cfg):
    w0, w1, w2, valid = wide_words(fields, cat, cfg)
    F, S = valid.shape
    return (*_unpack(w0, w1, w2, F, S), valid.sum(dim=1, dtype=torch.int32))


def run_full_order(fields, cat, cfg):
    w0, w1, w2, valid = wide_words(fields, cat, cfg)
    F, S = valid.shape
    (o0, o1, o2), counts = shift_compact_full((w0, w1, w2), valid)
    return (*_unpack(o0, o1, o2, F, S), counts)


def run_cursor(fields, cat, cfg):
    w0, w1, w2, valid = wide_words(fields, cat, cfg)
    F, S = valid.shape
    o0, o1, o2, count = cursor_compact(w0, w1, w2, valid)
    return (*_unpack(o0, o1, o2, F, S), count.expand(F))


RUNS = {
    "full": run_full,
    "nosort": run_nosort,
    "full_order": run_full_order,
    "cursor": run_cursor,
}


def parse_variants(spec: str):
    names = [v for v in spec.split(",") if v]
    for v in names:
        if v in _RENAMED:
            raise ValueError(f"variant {v!r} is named {_RENAMED[v]!r} here")
        if v in NOT_PORTED:
            raise ValueError(
                f"variant {v!r} is a TPU workaround of the reference "
                f"(ROADMAP.md, not ported); the port has {', '.join(VARIANTS)}"
            )
        if v not in RUNS:
            raise ValueError(f"unknown variant {v!r}; the port has "
                             f"{', '.join(VARIANTS)}")
    return names


def _time_ms(fn, device, reps: int, warmup: int = 2) -> float:
    """The time of one ``fn()`` in ms: on a card its device-only time
    over ``reps`` back-to-back calls, on the CPU the median host-clock
    time of ``reps`` calls."""
    if device.type == "cuda":
        return device_ms(fn, calls=reps, warmup=warmup)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi not available ({type(e).__name__})"


def experiment(batch: int, reps: int, variants, device, size: int = 1280,
               patches: int = 48):
    """Run the experiment; returns the result dict (see the module note)."""
    fields, cat, cfg, _ = flagship_inputs(batch, device, size, patches)
    F, S = fields.shape[0], fields.shape[1] * cfg.slots_per_block
    print(f"# inputs: {batch} frames of {size}x{size}, {patches} patches, "
          f"{fields.shape[1]} groups per frame, S={S}, N={F * S}",
          flush=True)
    results = {}
    if "cursor" in variants:
        # the cursor's count against the narrow path's counts, as the
        # reference checks its kernel's count against the XLA count
        want = int(run_full(fields, cat, cfg)[2].sum())
        got = int(run_cursor(fields, cat, cfg)[2][0])
        if got != want:
            raise AssertionError(f"cursor count {got} != full's {want}")
        results["total_points_check"] = want
    ms = {v: [] for v in variants}
    for order in (variants, variants[::-1]):  # in turns
        for v in order:
            ms[v].append(_time_ms(
                lambda v=v: RUNS[v](fields, cat, cfg), device, reps))
    for v in variants:
        results[v] = statistics.median(ms[v]) / batch
        print(f"# {v}: {results[v]:.6f} ms/frame (windows "
              f"{[round(x / batch, 6) for x in ms[v]]})", flush=True)
    if "full_order" in results and "nosort" in results:
        results["ceiling_ms"] = results["full_order"] - results["nosort"]
    if "cursor" in results and "nosort" in results:
        results["floor_ms"] = results["cursor"] - results["nosort"]
    results["spread_ms"] = max(
        ((max(ms[v]) - min(ms[v])) / batch
         for v in ("nosort", "full_order", "cursor") if v in ms), default=0.0)
    results["batch"] = batch
    if device.type == "cuda":
        results["device"] = torch.cuda.get_device_name(device)
        results["card"] = _card_line()
        results["clock"] = "device-only (torch.profiler)"
    else:
        results["device"] = "cpu"
        results["clock"] = "host"
    return results


def verdict(results) -> str:
    """The decision rule's verdict, in one line."""
    if "floor_ms" not in results or "ceiling_ms" not in results:
        return "verdict: needs the nosort, full_order and cursor variants"
    floor, ceiling = results["floor_ms"], results["ceiling_ms"]
    spread = results["spread_ms"]
    head = (f"verdict: floor {floor:.6f}, ceiling {ceiling:.6f}, spread "
            f"{spread:.6f} ms/frame")
    # no pass costs less than no compaction: a floor below 0 is noise too
    noise = max(spread, -floor)
    if ceiling < noise or abs(ceiling - floor) < noise:
        return (f"{head}: unresolved, the ceiling or its gap to the floor "
                f"lies within the noise ({noise:.6f})")
    if floor >= ceiling:
        return f"{head}: a single pass cannot beat K1F"
    return (f"{head}: a single pass could save at most "
            f"{ceiling - max(floor, 0.0):.6f} ms/frame of K1F's "
            f"{ceiling:.6f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_vpcc_torch.tools.compaction_experiment",
        description="Cursor compaction floor vs the K1F ceiling.")
    ap.add_argument("batch", nargs="?", type=int, default=1)
    ap.add_argument("reps", nargs="?", type=int, default=20)
    ap.add_argument("variants", nargs="?", default=",".join(VARIANTS))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--size", type=int, default=1280,
                    help="frame width and height (default the flagship's)")
    ap.add_argument("--patches", type=int, default=48)
    args = ap.parse_args(argv)
    variants = parse_variants(args.variants)
    device = resolve_device(args.device)
    results = experiment(args.batch, args.reps, variants, device,
                         args.size, args.patches)
    print(verdict(results))
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
