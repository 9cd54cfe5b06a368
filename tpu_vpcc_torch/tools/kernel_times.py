"""Device-only kernel times on the card, beside the kernel's plain
version, one PyTorch call that computes the same function where there is
one, and the kernel's bound.

The helpers (:func:`measure` and what it is built from, and K5's
:func:`time_pack`) are what ``chip_smoke.py`` times every kernel with.
As a command this module times the probe kernels P1-P12
(``ops/probes.py``) at about 64 MiB per operand, after checking each
against its plain version and the probe's ``want``:

    python -m tpu_vpcc_torch.tools.kernel_times [--probes P10,P11] [--repeats 3]

It needs a card; every line names the card and its power limit. With
``--repeats N`` each probe is measured N times in turn and a line per
probe compares its kernel with its library call (:func:`verdict`). The
last line is one JSON object with the numbers, by probe.
"""

from __future__ import annotations

import argparse
import json
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


def time_pack(planes, cfg) -> dict:
    """K5 on ``planes`` (``(occ, geo0, geo1, ay, au, av, swap)`` on the
    card) by :func:`measure`, beside ``pack_cat_plain``; no library
    call (:data:`PACK_NO_LIBRARY`)."""
    from ..ops import pack

    return measure(lambda: pack._pack_cat_cuda(*planes, cfg),
                   lambda: pack.pack_cat_plain(*planes, cfg),
                   nbytes=pack_bytes(*planes, cfg))


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=f"python -m {__name__}")
    ap.add_argument("--probes", default=",".join(probes.PROBES),
                    help="comma-separated probes (default: all twelve)")
    ap.add_argument("--repeats", type=int, default=1,
                    help="measurements of each probe, in turn")
    args = ap.parse_args(argv)
    names = [p.strip() for p in args.probes.split(",") if p.strip()]
    unknown = [p for p in names if p not in BIG]
    if unknown:
        ap.error(f"unknown probes {unknown}")
    if args.repeats < 1:
        ap.error("--repeats must be at least 1")
    device = resolve_device("cuda")
    smi = nvidia_smi_line()
    print(f"device: {torch.cuda.get_device_name(device)} ({smi})")
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
