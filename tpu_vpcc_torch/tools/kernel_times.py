"""Device-only kernel times on the card, beside the kernel's plain
version, one PyTorch call that computes the same function where there is
one, and the kernel's bound.

The helpers (:func:`measure` and what it is built from, and K5's
:func:`time_pack`) are what ``chip_smoke.py`` times every kernel with.
As a command this module times the probe kernels P1-P12
(``ops/probes.py``) at about 64 MiB per operand, after checking each
against its plain version and the probe's ``want``:

    python -m tpu_vpcc_torch.tools.kernel_times [--probes P10,P11] [--repeats 3]

or K5, the device pack, on seeded planes at the first flagship GOF's
shape (:data:`PACK_SHAPE`) at swap densities 0, 0.3 and 1, after checking
its cat against its plain version's:

    python -m tpu_vpcc_torch.tools.kernel_times --pack [--repeats 5]

or the smoothing kernels (``ops/smoothing.py``, ``csrc/grid_smooth.cu``)
on a flagship wide two-frame dispatch (:func:`smooth_inputs`), each
pass's statistics and apply beside its plain version, after checking
their bytes against the plain versions':

    python -m tpu_vpcc_torch.tools.kernel_times --smooth [--repeats 3]

or the host's group tables of the first flagship GOF (32 1280² frames,
frame seeds 0-31): the per-patch ``atlas.groups.build_group_table``
against the vectorised ``build_group_tables``, after checking that their
tables are equal, in ms a frame (no card needed; the host's CPU and,
where there is one, the card are named):

    python -m tpu_vpcc_torch.tools.kernel_times --tables [--repeats 5]

The other modes need a card; every line names the card and its power
limit. With
``--repeats N`` each probe (each density) is measured N times in turn;
a line per probe compares its kernel with its library call
(:func:`verdict`), a line per density gives K5's median and spread. The
last line is one JSON object with the numbers, by probe or density. Run
in a parent commit's tree and this one in turns (parent, this, this,
parent), ``--pack`` compares two versions of K5 on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..ops import probes
from . import hopper_probe as H1
from . import hopper_probe2 as H2
from . import hopper_probe3 as H3
from . import resolve_device

#: the H100 SXM's memory rate (NVIDIA's data sheet), bytes per second
HBM_BYTES_PER_S = 3.35e12


def nvidia_smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def event_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event window of one ``fn()`` call, in ms: the card's
    time plus whatever of the host's enqueue it waits for."""
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


class TimingError(RuntimeError):
    """A device-only time that the run cannot vouch for."""


#: empty spin kernels that open every traced window: after a dozen
#: traces in one process, the H100's traces lose the first device records
#: of each (mostly 4-5, once 257 in 255 traces), and these take that loss;
#: a longer loss fails the trace's check
LEAD_SPINS = 256
#: clock cycles of the spin kernel before and after the calls (some
#: 10 ms), during which the host enqueues the calls
PAD_CYCLES = 20_000_000
#: traces taken before a device-only time is given up
TRIES = 8


def _trace(fn, calls: int) -> dict:
    """The kernels, memsets and copies on the card while spin kernels,
    ``calls`` back-to-back ``fn()`` calls and a last spin kernel run, by
    name: their durations in µs, from a ``torch.profiler`` trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_SPINS):
            torch.cuda._sleep(0)
        torch.cuda._sleep(PAD_CYCLES)
        for _ in range(calls):
            fn()
        torch.cuda._sleep(PAD_CYCLES)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    durs: dict = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy"):
            durs.setdefault(e.get("name"), []).append(e.get("dur", 0))
    return durs


def trace_split_ms(spins: dict, one: dict, many: dict, calls: int) -> dict:
    """The device time per call of a trace of ``calls`` calls (``many``),
    in ms, by record name, from a trace of the spin kernels alone
    (``spins``, which names them) and of one call (``one``), all by name
    as :func:`_trace` gives them; the spins themselves are left out.
    Raises :class:`TimingError` unless the trace is whole: each name that
    one call puts on the card ran exactly ``calls`` times as often, and
    nothing else ran."""
    def count(d):
        return {n: len(v) for n, v in d.items() if n not in spins}

    per_call = count(one)
    if not spins or not per_call:
        raise TimingError(f"spin trace {sorted(spins)}, one-call trace "
                          f"{count(one)}")
    want = {n: calls * k for n, k in per_call.items()}
    if count(many) != want:
        raise TimingError(f"trace of {calls} calls is not whole: "
                          f"{count(many)} against {want}")
    return {n: sum(many[n]) / 1e3 / calls for n in per_call}


def device_split_ms(fn, calls: int = 20, warmup: int = 3) -> dict:
    """The card's own time per ``fn()`` call, in ms, by record name (each
    kernel, memset and copy that one call puts on the card): the summed
    durations of the device work of ``calls`` back-to-back calls, from a
    whole ``torch.profiler`` trace (:func:`trace_split_ms`), so the
    host's enqueue is not in it. A trace that is not whole is taken
    again, up to :data:`TRIES` times; then :class:`TimingError`."""
    for _ in range(warmup):
        fn()
    err = None
    for _ in range(TRIES):
        try:
            return trace_split_ms(_trace(None, 0), _trace(fn, 1),
                                  _trace(fn, calls), calls)
        except TimingError as e:
            err = e
    raise TimingError(f"no whole trace in {TRIES} tries; last: {err}")


def device_ms(fn, calls: int = 20, warmup: int = 3) -> float:
    """The sum of :func:`device_split_ms`: the card's own time per
    ``fn()`` call, in ms."""
    return sum(device_split_ms(fn, calls, warmup).values())


def short_name(name: str) -> str:
    """A profiler record's name without its namespace and argument list
    (``ns::kernel<true>(int*, ...)`` -> ``kernel<true>``)."""
    name = name.replace("(anonymous namespace)::", "")
    head = (name.split("(", 1)[0] or name).strip()
    return head.removeprefix("void ").rsplit("::", 1)[-1]


def queued_ms(fn, calls: int = 20, warmup: int = 3) -> float:
    """CUDA-event time per call of ``calls`` back-to-back ``fn()`` calls
    queued behind a spin kernel of some 10 ms, so that the card runs them
    without waiting for the host, in ms: the card's time plus the gaps
    between its launches. A ``fn`` that synchronises with the host waits
    for the spin and then puts the host's time back in."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # clock cycles
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def bound_ms(nbytes: int) -> float:
    """The least time the card could take to move ``nbytes``. Every kernel
    of the port is bound by its bytes (each input byte read once, each
    output byte written once), not by its few integer operations."""
    return nbytes / HBM_BYTES_PER_S * 1e3


#: how far a device-only time may lie above the queued time of the same
#: calls, which holds that device time and the gaps between launches
QUEUED_SLACK = 1.05
#: measurements taken before a kernel's times are given up: late in a
#: process that has taken many traces, one trace now and then runs 20-40%
#: long (``PERF.md`` §7), which :func:`check_measured` catches
MEASURE_TRIES = 3


def check_measured(out: dict, traces: str = "") -> None:
    """Raise :class:`TimingError` (with ``traces``) where :func:`measure`'s
    device-only time is below its bound or more than
    :data:`QUEUED_SLACK` times its queued time: then work was missed, the
    bound is wrong or a trace ran long."""
    if out["ms"] < out["bound_ms"]:
        raise TimingError(f"device-only {out['ms']:.4f} ms is below the "
                          f"bound {out['bound_ms']:.4f} ms{traces}")
    if out["ms"] > QUEUED_SLACK * out["queued_ms"]:
        raise TimingError(f"device-only {out['ms']:.4f} ms is above the "
                          f"queued {out['queued_ms']:.4f} ms{traces}")


def measure(kernel, plain, library=None, nbytes: int = 0) -> dict:
    """A kernel beside its plain version and, where one PyTorch call
    computes the same function, that call: the single-call CUDA-event
    windows of kernel and plain version, then the device-only times of
    all three in turns (kernel, library, plain, plain, library, kernel),
    the kernel's device-only time split by record name (``split``: each
    kernel, memset and copy of one call, by :func:`short_name`), and the
    kernel's bound. Medians, in ms. A measurement that fails
    :func:`check_measured` is taken anew; ``tries`` counts them. After
    :data:`MEASURE_TRIES` failed ones, :class:`TimingError` with each
    one's traces."""
    errors = []
    for tries in range(1, MEASURE_TRIES + 1):
        out, traces = _measure_once(kernel, plain, library, nbytes)
        try:
            check_measured(out, traces)
        except TimingError as e:
            errors.append(f"try {tries}: {e}")
            continue
        out["tries"] = tries
        return out
    raise TimingError("; ".join(errors))


def _measure_once(kernel, plain, library, nbytes: int):
    """One measurement of :func:`measure`, unchecked, and its kernel
    traces' times as text."""
    single = {"kernel": [], "plain": []}
    runs = {"kernel": kernel, "plain": plain}
    for who in ("plain", "kernel", "kernel", "plain"):
        single[who].append(event_ms(runs[who], reps=10))
    if library is not None:
        runs["library"] = library
    dev = {who: [] for who in runs}
    splits = []
    for who in ("kernel", "library", "plain", "plain", "library", "kernel"):
        if who in runs:
            split = device_split_ms(runs[who])
            dev[who].append(sum(split.values()))
            if who == "kernel":
                splits.append(split)
    med = {who: statistics.median(v) for who, v in dev.items()}
    split: dict = {}
    for n in splits[0]:
        k = short_name(n)
        split[k] = split.get(k, 0.0) + statistics.median(s[n] for s in splits)
    out = {
        "ms": med["kernel"],
        "split": split,
        "plain_ms": med["plain"],
        "library_ms": med.get("library"),
        "single_call_ms": statistics.median(single["kernel"]),
        "plain_single_call_ms": statistics.median(single["plain"]),
        "queued_ms": queued_ms(kernel),
        "bytes": int(nbytes),
        "bound_ms": bound_ms(nbytes),
        "bound_by": "bytes",
    }
    out["share_of_bound"] = out["bound_ms"] / out["ms"]
    return out, f"; its traces {dev['kernel']} ms, splits {splits}"


def measured_line(name: str, m: dict, smi: str) -> str:
    """One report line of :func:`measure`'s numbers."""
    lib = ("none" if m["library_ms"] is None
           else f"{m['library_ms']:.4f} ms")
    tries = m.get("tries", 1)
    if tries > 1:
        name = f"{name}, measurement {tries} of {MEASURE_TRIES}"
    return (f"{name} ({smi}): device-only {m['ms']:.4f} ms "
            f"(queued {m['queued_ms']:.4f} ms), single call "
            f"{m['single_call_ms']:.4f} ms; plain "
            f"{m['plain_ms']:.4f} ms device-only, "
            f"{m['plain_single_call_ms']:.4f} ms single call; library "
            f"call {lib}; {m['bytes']} bytes, bound {m['bound_ms']:.4f} ms "
            f"at 3.35 TB/s, {100 * m['share_of_bound']:.1f}% of it; "
            f"split {split_text(m['split'])}")


def split_text(split: dict) -> str:
    """``name ms, ...`` of a device-only split, largest first."""
    return ", ".join(f"{n} {ms:.4f}" for n, ms in
                     sorted(split.items(), key=lambda kv: -kv[1]))


# ---------------------------------------------------------------------------
# the probes at about 64 MiB per operand
# ---------------------------------------------------------------------------

_STEPS = np.random.default_rng(4).integers(0, 513, 255)
#: P4's 256 row offsets: overlapping, in order
_OFFS = np.concatenate([[0], np.cumsum(_STEPS)])

#: per probe, its tool function at about 64 MiB per operand
BIG = {
    "P1": lambda d, run: H1.probe_rolls(d, run, R=131072),
    "P2": lambda d, run: H1.probe_flat_shift(d, run, R=131072, ks=(1, 1024)),
    "P3": lambda d, run: H1.probe_interleave(d, run, R=131072)[:1],
    "P4": lambda d, run: H1.probe_dyn_dma(d, run, nstep=256, step_rows=512,
                                          offs=_OFFS),
    "P5": lambda d, run: H2.probe_bitcast(d, run, R=32768),
    "P6": lambda d, run: H2.probe_wide_u16(d, run, R=32768, ks=(1, 4096)),
    "P7": lambda d, run: H2.probe_dynamic_roll(d, run, R=65536),
    "P8": lambda d, run: H2.probe_mini_compact(d, run, n_seg=8192),
    "P9": lambda d, run: H3.probe_interleave(d, run, R=32768),
    "P10": lambda d, run: H3.probe_repeat(d, run, R=32768),
    "P11": lambda d, run: H3.probe_rev(d, run, R=32768),
    "P12": lambda d, run: H3.probe_interleave16(d, run, R=65536),
}

#: why no one PyTorch call computes these probes' functions
NO_LIBRARY = {
    "P4": "none: no call applies overlapping row writes in step order "
          "(index_put_ leaves the order of duplicate rows undefined)",
    "P8": "none: no call joins the two u16 streams and moves each slot by "
          "its own shift",
}


def _nb(t) -> int:
    return t.numel() * t.element_size()


def probe_bytes(case) -> int:
    """The bytes ``case``'s probe must move: each input byte read once,
    each output byte written once. P4 reads only the rows of the step
    that wins each covered output row, and writes every output row."""
    p, a = case.probe, case.args
    if p in ("P1", "P2", "P5", "P6", "P11"):
        return 2 * _nb(a[0])
    if p == "P7":
        return 2 * _nb(a[0]) + _nb(a[1])
    if p in ("P3", "P9", "P12"):
        return 2 * (_nb(a[0]) + _nb(a[1]))
    if p == "P10":
        return 3 * _nb(a[0])
    if p == "P8":  # three (R, L) streams in, (R, 2L) int32 out
        return 5 * _nb(a[0])
    if p == "P4":
        x, offs, out_rows = a
        covered = np.zeros(out_rows, bool)
        for o in offs.cpu().tolist():
            covered[o:o + x.shape[1]] = True
        row = x.shape[2] * x.element_size()
        return _nb(offs) + int(covered.sum()) * row + out_rows * row
    raise ValueError(f"unknown probe {p!r}")


def library_call(case):
    """One PyTorch call that computes ``case``'s probe on its arguments,
    or None where there is none (:data:`NO_LIBRARY`)."""
    p, a = case.probe, case.args
    if p == "P1":
        x, shift, axis = a
        return lambda: torch.roll(x, shift, axis)
    if p in ("P2", "P6"):
        flat, k = a[0].view(-1), a[1]
        return lambda: torch.roll(flat, -k)
    if p in ("P3", "P9", "P12"):
        return lambda: torch.stack(a, -1)
    if p == "P5":
        x, dtype = a
        return lambda: x.view(dtype).clone()
    if p == "P7":
        x, shift = a[0], int(a[1].reshape(-1)[0])
        return lambda: torch.roll(x, shift, 1)
    if p == "P10":
        return lambda: torch.cat([a[0], a[0]], 1)
    if p == "P11":
        return lambda: torch.flip(a[0], (1,))
    return None


# ---------------------------------------------------------------------------
# K5, the device pack
# ---------------------------------------------------------------------------

#: why no one PyTorch call computes K5's function
PACK_NO_LIBRARY = ("none: no one call packs three planes with a nearest "
                   "upsample and a per-block transpose")


def pack_bytes(occ, geo0, geo1, ay, au, av, swap, cfg) -> int:
    """The bytes K5 must move on these planes: each plane it reads once
    (``geo1`` and map 1 only with two maps) and the swap mask, and the
    cat written once."""
    maps = 2 if cfg.map_count > 1 else 1
    read = (_nb(occ) + maps * _nb(geo0) + _nb(swap)
            + maps * (_nb(ay[:, 0]) + _nb(au[:, 0]) + _nb(av[:, 0])))
    res = cfg.occupancy_resolution
    return read + occ.shape[0] * occ.shape[1] * 3 * res * res * 4


#: K5's timed shape, the first flagship GOF's planes: ``(F, nb, res,
#: prec, chroma shift, map count)`` (two 1280^2 frames, 4:2:0, two maps)
PACK_SHAPE = (2, 6400, 16, 4, 1, 2)
#: the swap densities ``--pack`` times K5 at
PACK_DENSITIES = (0.0, 0.3, 1.0)


def seeded_planes(mc, cs, res, prec, F, density, nb, gen, maps=None):
    """Random planes on ``gen``'s device as ``ops.tiled.planes_to_device``
    gives them: occupancy over 0-255, samples over the full 10-bit range,
    ``maps`` (default ``mc``) maps of colour, a swap mask of
    ``density``."""
    dev = gen.device
    rp, rc, M = res // prec, res >> cs, maps or mc

    def u10(*shape):
        return torch.randint(0, 1024, shape, dtype=torch.int16, device=dev,
                             generator=gen)

    occ = torch.randint(0, 256, (F, nb, rp, rp), dtype=torch.uint8,
                        device=dev, generator=gen)
    swap = (torch.rand((F, nb), device=dev, generator=gen)
            < density).to(torch.uint8)
    return (occ, u10(F, nb, res, res), u10(F, nb, res, res),
            u10(F, M, nb, res, res), u10(F, M, nb, rc, rc),
            u10(F, M, nb, rc, rc), swap)


def pack_config(mc, cs, res, prec, nb):
    """The port's FrameConfig of a one-block-high canvas of ``nb``
    blocks: what K5 reads of it is the block edge, the occupancy
    precision, the chroma shift and the map count."""
    from ..ops.reconstruct import make_config

    return make_config(width=res * nb, height=res, occupancy_resolution=res,
                       occupancy_precision=prec, map_count=mc,
                       chroma_shift=cs)


def time_pack(planes, cfg) -> dict:
    """K5 on ``planes`` (``(occ, geo0, geo1, ay, au, av, swap)`` on the
    card) by :func:`measure`, beside ``pack_cat_plain``; no library
    call (:data:`PACK_NO_LIBRARY`)."""
    from ..ops import pack

    return measure(lambda: pack._pack_cat_cuda(*planes, cfg),
                   lambda: pack.pack_cat_plain(*planes, cfg),
                   nbytes=pack_bytes(*planes, cfg))


# ---------------------------------------------------------------------------
# the smoothing kernels
# ---------------------------------------------------------------------------

def smooth_inputs(device):
    """The flat slot arrays of a flagship wide two-frame dispatch (the
    first flagship GOF's two 1280^2 frames, frame seeds 0-1, with
    geometry and colour smoothing), as ``ops.tiled.smooth_words_shards``
    takes them from K2W's words on ``device``: ``(cols, (valid, pid,
    frame), n_frames, cfg)``, ``cols`` the int32 ``[x, y, z, cy, cu,
    cv]``."""
    from ..models.flagship import (ATTR_SMOOTHING, GEO_SMOOTHING,
                                   FlagshipConfig, example_frames,
                                   example_gof)
    from ..ops import payload
    from ..ops.tiled import smooth_slot_arrays
    from ..runtime import pipeline as P

    fcfg = FlagshipConfig(batch=2)
    gof = example_gof(fcfg, example_frames(fcfg, seed=0),
                      geo_smoothing=GEO_SMOOTHING,
                      attr_smoothing=ATTR_SMOOTHING)
    cfg, tables, g_bucket = P._gof_tables_and_bucket(gof)
    di = P._gof_device_inputs(gof, gof.metas, (cfg, tables), g_bucket)
    fields, cat = di.on_device(device)
    words = payload.wide_words(fields, cat, di.cfg)
    cols, args = smooth_slot_arrays(fields, *words)
    return cols, args, words[3].shape[0], di.cfg


def smooth_stats_bytes(xs, ys, zs, a, b, c, valid, pid, frame, n_frames,
                       cfg) -> int:
    """The bytes a pass's cell statistics must move: the validity of
    every slot, each valid slot's coordinates, payload (when it is not
    the coordinates), pid and frame read once, and the six int32 grids
    written once."""
    per_valid = 3 * 4 + (0 if a is xs else 3 * 4) + 4 + 8
    return (valid.numel() + int(valid.sum()) * per_valid
            + 6 * 4 * n_frames * cfg.grid_width ** 3)


def smooth_apply_bytes(stats, xs, ys, zs, a, b, c, valid, pid, frame,
                       cfg) -> int:
    """The bytes a pass's apply must move: every slot's validity and
    payload read and its three outputs written, a valid slot's
    coordinates (when the payload is not them), pid and frame read, and
    of each cell a valid slot's in-range neighbourhood touches, its count
    read and, where it holds points, its sums, min and max."""
    from ..ops import smoothing as S

    gs, gw = cfg.grid_size, cfg.grid_width
    per_valid = (0 if a is xs else 3 * 4) + 4 + 8
    in_range, corners = S._neighbourhood(xs, ys, zs, frame * gw ** 3, gs,
                                         gw)
    use = valid & in_range
    cells = torch.unique(torch.cat([nid[use] for nid, _ in corners]))
    filled = int((stats[0][cells] > 0).sum())
    return (valid.numel() * (1 + 2 * 3 * 4) + int(valid.sum()) * per_valid
            + cells.numel() * 4 + filled * 5 * 4)


def smooth_cases(cols, args, n_frames: int, cfg):
    """The smoothing kernels on a wide dispatch's flat slot arrays
    (``cols``, ``args`` and ``n_frames`` as :func:`smooth_inputs` gives
    them; ``cfg`` the dispatch's ``FrameConfig`` with both smoothings):
    the geometry pass, then the colour pass on the smoothed positions,
    each pass's grids and outputs held against the plain versions'.
    Returns ``(max_abs_err, moved, runs)``: the largest difference over
    every grid and output (0 when byte-equal), the coordinates and
    colour components the passes moved, and per half of a pass
    (``geometry stats``, ``geometry apply``, ``colour stats``, ``colour
    apply``) its ``(kernel, plain, nbytes)`` for :func:`measure`."""
    from ..ops import smoothing as S

    xs, ys, zs, cy, cu, cv = cols
    valid, pid, frame = args
    F = n_frames
    geo, attr = cfg.smoothing, cfg.attr_smoothing
    g_args = (xs, ys, zs, xs, ys, zs, valid, pid, frame)
    g_stats = S._stats_cuda(*g_args, F, geo)
    sx, sy, sz = S._apply_cuda(g_stats, *g_args, geo, color=False)
    c_args = (sx, sy, sz, cy, cu, cv, valid, pid, frame)
    c_stats = S._stats_cuda(*c_args, F, attr)
    c_out = S._apply_cuda(c_stats, *c_args, attr, color=True)
    pairs = (
        (g_stats, S._stats_plain(*g_args, F, geo)),
        ((sx, sy, sz),
         S.geometry_apply_plain(g_stats, *g_args[:3], *g_args[6:], geo)),
        (c_stats, S._stats_plain(*c_args, F, attr)),
        (c_out, S.color_apply_plain(c_stats, *c_args, attr)),
    )
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
              for got, want in pairs for g, w in zip(got, want))
    moved = (sum(int((a != b).sum()) for a, b in zip((sx, sy, sz),
                                                     (xs, ys, zs))),
             sum(int((a != b).sum()) for a, b in zip(c_out, (cy, cu, cv))))
    runs = {
        "geometry stats": (
            lambda: S._stats_cuda(*g_args, F, geo),
            lambda: S._stats_plain(*g_args, F, geo),
            smooth_stats_bytes(*g_args, F, geo)),
        "geometry apply": (
            lambda: S._apply_cuda(g_stats, *g_args, geo, color=False),
            lambda: S.geometry_apply_plain(g_stats, *g_args[:3],
                                           *g_args[6:], geo),
            smooth_apply_bytes(g_stats, *g_args, geo)),
        "colour stats": (
            lambda: S._stats_cuda(*c_args, F, attr),
            lambda: S._stats_plain(*c_args, F, attr),
            smooth_stats_bytes(*c_args, F, attr)),
        "colour apply": (
            lambda: S._apply_cuda(c_stats, *c_args, attr, color=True),
            lambda: S.color_apply_plain(c_stats, *c_args, attr),
            smooth_apply_bytes(c_stats, *c_args, attr)),
    }
    return err, moved, runs


def smooth_passes(cols, args, n_frames: int, cfg, plain: bool = False):
    """Both smoothing passes on a dispatch's flat slot arrays (as
    :func:`smooth_cases` takes them), without the words' unpack and
    repack: through ``ops.smoothing``'s entries (the kernels on a card),
    or with ``plain`` in the plain versions on the tensors' device.
    Returns the smoothed ``(x, y, z)`` and ``(cy, cu, cv)``."""
    from ..ops import smoothing as S

    xs, ys, zs, cy, cu, cv = cols
    geo, attr = cfg.smoothing, cfg.attr_smoothing
    if plain:
        pos = S.geometry_apply_plain(
            S._stats_plain(xs, ys, zs, xs, ys, zs, *args, n_frames, geo),
            xs, ys, zs, *args, geo)
        c_stats, c_apply = S._stats_plain, S.color_apply_plain
    else:
        pos = S.geometry_apply(
            S.geometry_stats(xs, ys, zs, *args, n_frames, geo),
            xs, ys, zs, *args, geo)
        c_stats, c_apply = S.color_stats, S.color_apply
    c_args = (*pos, cy, cu, cv, *args)
    return pos, c_apply(c_stats(*c_args, n_frames, attr), *c_args, attr)


def smooth_main(repeats: int, smi: str, device) -> dict:
    """``--smooth``: the smoothing kernels on :func:`smooth_inputs`. Each
    pass's kernel grids and outputs are first checked against the plain
    versions' (raises on a difference, :func:`smooth_cases`); then
    ``repeats`` measurements each, in turn, of the geometry pass's
    statistics (the initialisation's launch and
    ``smooth_stats_kernel``) and apply, and the colour pass's on the
    smoothed positions, beside the plain versions, with their bytes and
    bounds."""
    cols, args, F, cfg = smooth_inputs(device)
    err, moved, runs = smooth_cases(cols, args, F, cfg)
    if err:
        raise AssertionError(f"the smoothing kernels' grids or outputs "
                             f"differ from the plain versions' by up to "
                             f"{err}")
    valid = args[0]
    print(f"smoothing kernels at F={F} S={valid.shape[0] // F}, "
          f"{int(valid.sum())} valid slots, grid "
          f"{cfg.smoothing.grid_width}^3 a frame: grids and outputs equal "
          f"to the plain versions' in both passes; moved {moved[0]} "
          f"coordinates and {moved[1]} colour components")
    out = {name: [] for name in runs}
    for r in range(repeats):
        for name, (kernel, plain, nbytes) in runs.items():
            m = measure(kernel, plain, nbytes=nbytes)
            out[name].append(m)
            print(measured_line(f"smoothing {name}, measurement {r + 1} of "
                                f"{repeats}", m, smi))
    if repeats > 1:
        for name, ms in out.items():
            dev = [m["ms"] for m in ms]
            print(f"smoothing {name} ({smi}), {repeats} measurements: "
                  f"median {statistics.median(dev):.4f} ms, spread "
                  f"{max(dev) - min(dev):.4f} ms, "
                  f"{100 * ms[0]['bound_ms'] / statistics.median(dev):.1f}% "
                  f"of the bound {ms[0]['bound_ms']:.4f} ms")
    return {name: ms[0] if len(ms) == 1 else ms for name, ms in out.items()}


#: probes whose cases compare only part of the output (P8 each segment's
#: prefix, P4 the covered rows): their kernels are also held against the
#: plain version over the whole output
WHOLE_OUTPUT = ("P4", "P8")


def whole_output_mismatches(case, where: str, twice: bool = False):
    """``case``'s probe on its arguments, the whole output of
    :func:`probes.call` against :func:`probes.plain` and, with ``twice``,
    against a second call: a line per disagreement."""
    got = probes.call(case.probe, *case.args)
    bad = []
    if not torch.equal(got, probes.plain(case.probe, *case.args)):
        bad.append(f"{case.name} ({where}): whole output differs from plain")
    if twice and not torch.equal(got, probes.call(case.probe, *case.args)):
        bad.append(f"{case.name} ({where}): two calls differ")
    return bad


def mismatches(cases_k, cases_p, where: str, twice: bool = False):
    """Kernel cases against the plain cases and both against ``want``,
    and the :data:`WHOLE_OUTPUT` probes (with ``twice``, every probe)
    over their whole output (:func:`whole_output_mismatches`): a line per
    disagreement."""
    bad = []
    for k, p in zip(cases_k, cases_p):
        if not (k.got.shape == p.got.shape and np.array_equal(k.got, p.got)):
            bad.append(f"{k.name} ({where}): kernel differs from plain")
        for c, who in ((k, "kernel"), (p, "plain")):
            if not (c.got.shape == c.want.shape
                    and np.array_equal(c.got, c.want)):
                bad.append(f"{c.name} ({where}): {who} differs from want")
        if twice or k.probe in WHOLE_OUTPUT:
            bad += whole_output_mismatches(k, where, twice)
    return bad


def edge_cases():
    """P4's, P5's and P8's edge shapes (``hopper_probe.DYN_WRITE_EDGES``,
    ``hopper_probe2.REINTERPRET_EDGES``, ``hopper_probe2.MINI_COMPACT_EDGES``)
    as ``(probe, label, fn)``, each ``fn(device, run)`` giving the shape's
    cases like a probe function."""
    out = []
    rows = H1.DYN_WRITE_EDGE_ROWS
    for n, L, in_order in H1.DYN_WRITE_EDGES:
        offs = H1.dyn_write_offsets(n, rows, in_order, seed=n)
        label = f"nstep={n} L={L} {'in order' if in_order else 'shuffled'}"
        out.append(("P4", label, lambda d, run, n=n, L=L, offs=offs:
                    H1.probe_dyn_dma(d, run, nstep=n, step_rows=rows, L=L,
                                     offs=offs)))
    for R, L in H2.REINTERPRET_EDGES:
        out.append(("P5", f"nbytes={4 * R * L}",
                    lambda d, run, R=R, L=L:
                    H2.probe_bitcast(d, run, R=R, L=L)))
    for w, n in H2.MINI_COMPACT_EDGES:
        out.append(("P8", f"seg_words={w} n_seg={n}",
                    lambda d, run, w=w, n=n:
                    H2.probe_mini_compact(d, run, R=1, L=w, n_seg=n)))
    return out


def time_probe(probe: str, device) -> dict:
    """``probe`` at about 64 MiB per operand: kernel, plain version and
    ``want`` checked (raises on a difference), then :func:`measure` on
    the first case's arguments."""
    cases_k = BIG[probe](device, probes.call)
    cases_p = BIG[probe](device, probes.plain)
    torch.cuda.synchronize()
    bad = mismatches(cases_k, cases_p, "64 MiB")
    if bad:
        raise AssertionError("; ".join(bad))
    c = cases_k[0]
    m = measure(lambda: probes.call(c.probe, *c.args),
                lambda: probes.plain(c.probe, *c.args),
                library=library_call(c), nbytes=probe_bytes(c))
    return m


def verdict(kernel_ms, library_ms) -> dict:
    """Repeated device-only times of a kernel and of its library call:
    their medians, the spread (the larger of the two ranges) and which
    is faster by more than the spread (else ``tie``)."""
    k, lib = statistics.median(kernel_ms), statistics.median(library_ms)
    spread = max(max(kernel_ms) - min(kernel_ms),
                 max(library_ms) - min(library_ms))
    if k - lib > spread:
        who = "library faster"
    elif lib - k > spread:
        who = "kernel faster"
    else:
        who = "tie"
    return {"kernel_ms": k, "library_ms": lib, "spread_ms": spread,
            "verdict": who}


def pack_main(repeats: int, smi: str) -> dict:
    """``--pack``: K5 at :data:`PACK_SHAPE` at each of
    :data:`PACK_DENSITIES`, its cat checked against the plain version's
    (raises on a difference), then ``repeats`` measurements a density in
    turn; a line per measurement and, with ``repeats`` above 1, a line
    per density with the median and spread of the device-only times."""
    from ..ops import pack

    F, nb, res, prec, cs, mc = PACK_SHAPE
    cfg = pack_config(mc, cs, res, prec, nb)
    cases = {}
    for i, density in enumerate(PACK_DENSITIES):
        gen = torch.Generator(device="cuda").manual_seed(60 + i)
        planes = seeded_planes(mc, cs, res, prec, F, density, nb, gen)
        got = pack._pack_cat_cuda(*planes, cfg)
        if not torch.equal(got, pack.pack_cat_plain(*planes, cfg)):
            raise AssertionError(f"K5 differs from its plain version at "
                                 f"swap density {density}")
        cases[density] = planes
    print(f"K5 at F={F} nb={nb} res={res} prec={prec} chroma shift {cs}, "
          f"{mc} maps: cat equal to the plain version's at swap densities "
          f"{list(PACK_DENSITIES)}")
    runs = {d: [] for d in PACK_DENSITIES}
    for r in range(repeats):
        for density, planes in cases.items():
            m = time_pack(planes, cfg)
            runs[density].append(m)
            print(measured_line(f"K5 at swap density {density}, "
                                f"measurement {r + 1} of {repeats}", m, smi))
    out = {}
    for density, ms in runs.items():
        dev = [m["ms"] for m in ms]
        out[str(density)] = {
            "ms": dev, "median_ms": statistics.median(dev),
            "spread_ms": max(dev) - min(dev), "bound_ms": ms[0]["bound_ms"],
            "single_call_ms": [m["single_call_ms"] for m in ms],
            "queued_ms": [m["queued_ms"] for m in ms],
        }
        if repeats > 1:
            print(f"K5 at swap density {density} ({smi}), {repeats} "
                  f"measurements: median {statistics.median(dev):.4f} ms, "
                  f"spread {max(dev) - min(dev):.4f} ms, "
                  f"{100 * ms[0]['bound_ms'] / statistics.median(dev):.1f}% "
                  f"of the bound {ms[0]['bound_ms']:.4f} ms")
    return out


#: frames of the GOF ``--tables`` times: a GOF of the 8iVFB CTC streams
TABLES_FRAMES = 32


def _same_table(a, b) -> bool:
    return (a.n_groups == b.n_groups and a.tiled_ok == b.tiled_ok
            and np.array_equal(a.fields, b.fields)
            and a.fields.dtype == b.fields.dtype
            and np.array_equal(a.block_to_patch, b.block_to_patch)
            and a.block_to_patch.dtype == b.block_to_patch.dtype
            and (a.trim is None) == (b.trim is None)
            and (a.trim is None or np.array_equal(a.trim, b.trim)))


def tables_main(repeats: int, n_frames: int = TABLES_FRAMES) -> dict:
    """``--tables``: the group tables of the first flagship GOF
    (``n_frames`` frames) built per patch (``build_group_table``, the
    oracle, a frame at a time) and vectorised
    (``build_group_tables``, as ``runtime.pipeline._gof_frame_tables``
    calls it), checked equal (raises on a difference), then ``repeats``
    timings of each in turn after one warm call; ms a frame, a line per
    timing and one with the medians."""
    import platform
    import time

    from ..atlas import groups as G
    from ..models.flagship import FlagshipConfig, example_frames

    fcfg = FlagshipConfig(batch=n_frames)
    frames = example_frames(fcfg, seed=0)
    metas = [f.meta for f in frames]
    res, prec = fcfg.occupancy_resolution, fcfg.occupancy_precision

    def occ_provider_for(m):
        return lambda: frames[m.frame_index].occ_plane

    def per_patch():
        return [G.build_group_table(m, occupancy_resolution=res,
                                    occ_provider=occ_provider_for(m),
                                    occ_precision=prec) for m in metas]

    def vectorised():
        return G.build_group_tables(metas, res, occ_provider_for, prec)[0]

    for k, (a, b) in enumerate(zip(per_patch(), vectorised())):
        if not _same_table(a, b):
            raise AssertionError(f"the vectorised table of frame {k} "
                                 f"differs from build_group_table's")
    host = f"{platform.processor() or platform.machine()}, " \
           f"{os.cpu_count()} CPUs"
    print(f"group tables of {n_frames} flagship frames "
          f"({sum(len(m.patches) for m in metas)} patches), equal frame "
          f"for frame; host {host}")
    runs = {"per_patch": [], "vectorised": []}
    for r in range(repeats):
        for name, fn in (("per_patch", per_patch),
                         ("vectorised", vectorised)):
            t0 = time.perf_counter()
            fn()
            runs[name].append((time.perf_counter() - t0) * 1e3 / n_frames)
            print(f"{name} tables, timing {r + 1} of {repeats}: "
                  f"{runs[name][-1]:.4f} ms a frame")
    med = {name: statistics.median(ms) for name, ms in runs.items()}
    print(f"group tables ({host}), {repeats} timings each: per patch "
          f"{med['per_patch']:.4f}, vectorised {med['vectorised']:.4f} ms "
          f"a frame (medians), {med['per_patch'] / med['vectorised']:.2f}x")
    return {"host": host, "frames": n_frames, "ms_per_frame": runs,
            "median_ms_per_frame": med}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=f"python -m {__name__}")
    ap.add_argument("--probes", default=",".join(probes.PROBES),
                    help="comma-separated probes (default: all twelve)")
    ap.add_argument("--pack", action="store_true",
                    help="time K5, the device pack, instead of the probes")
    ap.add_argument("--smooth", action="store_true",
                    help="time the smoothing kernels instead of the probes")
    ap.add_argument("--tables", action="store_true",
                    help="time the host's group tables instead of the "
                         "probes (no card needed)")
    ap.add_argument("--repeats", type=int, default=1,
                    help="measurements of each probe, density or "
                         "smoothing kernel, in turn")
    args = ap.parse_args(argv)
    names = [p.strip() for p in args.probes.split(",") if p.strip()]
    unknown = [p for p in names if p not in BIG]
    if unknown:
        ap.error(f"unknown probes {unknown}")
    if args.repeats < 1:
        ap.error("--repeats must be at least 1")
    if args.tables:
        out = {"tables": tables_main(args.repeats)}
        if torch.cuda.is_available():
            out["card"] = nvidia_smi_line()
            print(f"card: {out['card']}")
        print(json.dumps(out))
        return 0
    device = resolve_device("cuda")
    smi = nvidia_smi_line()
    print(f"device: {torch.cuda.get_device_name(device)} ({smi})")
    if args.pack:
        print(json.dumps({"card": smi,
                          "pack": pack_main(args.repeats, smi)}))
        return 0
    if args.smooth:
        print(json.dumps({"card": smi,
                          "smooth": smooth_main(args.repeats, smi, device)}))
        return 0
    results = {p: [] for p in names}
    for r in range(args.repeats):
        for p in names:
            m = time_probe(p, device)
            results[p].append(m)
            print(measured_line(f"{p} at 64 MiB per operand, measurement "
                                f"{r + 1} of {args.repeats}", m, smi))
    out = {"card": smi, "probes": {p: ms[0] if len(ms) == 1 else ms
                                   for p, ms in results.items()}}
    if args.repeats > 1:
        out["verdicts"] = {}
        for p, ms in results.items():
            if ms[0]["library_ms"] is None:
                continue
            v = verdict([m["ms"] for m in ms], [m["library_ms"] for m in ms])
            out["verdicts"][p] = v
            print(f"{p} against its library call ({smi}), {args.repeats} "
                  f"measurements each: kernel {v['kernel_ms']:.4f} ms, "
                  f"library {v['library_ms']:.4f} ms (medians), spread "
                  f"{v['spread_ms']:.4f} ms: {v['verdict']}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
