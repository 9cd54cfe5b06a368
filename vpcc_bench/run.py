"""One run of one cell of the benchmark of ``tpu_vpcc_torch``.

    python3 -m vpcc_bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the checkout's root. The cell (``BENCHMARK.json``) names a
deployment (``configs/``) and a traffic mix (``traffic/``). The run
makes a pool of distinct frames from the seed, warms the decoder up on
the pool's GOFs, then drives ``Decoder.start_gofs`` with fresh ``GofData``
objects over the pool in turn, the consumer calling ``recv_frame``:

- closed loop (``"loop": "closed"``): the next GOF is handed over as soon
  as the decoder pulls it. The window opens when the consumer has
  received ``open_after_gofs`` whole GOFs and closes at the first GOF
  completed ``--seconds`` or more later; ``frames_per_s`` is the frames
  received in it over its length.
- open loop (``"loop": "open"``): GOF k is due, and handed over no
  earlier, at ``(k + 1) * frames_per_gof / frames_per_s`` seconds from
  the start, for the GOFs due within ``--seconds``; a frame's latency
  runs from its GOF's due time to its receipt.
- several streams (``"streams": S``, closed loop): the program's
  multi-stream batcher decodes S streams in shared dispatches, fed per
  stream (stream s's k-th GOF is pool GOF ``(s + k) mod pool_gofs``) by
  ``host_workers`` prep threads. The window opens on the receipt that
  completes the ``open_after_gofs``-th whole GOF over all streams and
  closes at the first GOF completed ``--seconds`` or more later at which
  every stream has completed as many whole GOFs; ``frames_per_s`` is the
  frames of all streams received in it over its length.

Once the window has closed, the plain reference (``ref/``) reconstructs
the pool's frames and every frame received is held to its pool frame's
(``check.py``). With ``--trace 1`` a ``torch.profiler`` trace covers the
whole timed run, and the per-layer metrics' readers (``metrics/``) read
it and the program's stage spans. The last line of standard output is
the result; the numbers compared, each with its limit, are the last
lines of standard error.
"""

from __future__ import annotations

import argparse
import json
import queue
import resource
import subprocess
import sys
import threading
import time
from contextlib import contextmanager
from typing import List, Optional

import numpy as np

from . import PROCESS_T0, adapter, check, gen, roofline
from .registry import Bench

#: top-level module names that no run may load: the JAX package the
#: program was ported from, and JAX
BANNED = ("jax", "jaxlib", "flax", "tpu_vpcc")
#: the limits of the numbers compared: the output is exact
LIMITS = {"frames_wrong": 0, "frames_missing": 0}
#: seconds past the window's close that the run waits for due frames
DRAIN_S = 60.0


class NoCard(RuntimeError):
    """The cell's cards are not there."""


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is banned, compared whole."""
    return sorted({n.split(".", 1)[0] for n in list(sys.modules)}
                  & set(BANNED))


def smi(query: str) -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def host_cpu(u0, u1) -> str:
    """The process's CPU time between two ``getrusage`` readings."""
    return (f"host CPU during the run: {u1.ru_utime - u0.ru_utime:.3f} s "
            f"user, {u1.ru_stime - u0.ru_stime:.3f} s system")


class Sampler:
    """``nvidia-smi`` clocks, power and temperature every five seconds while
    the window runs, in one process of its own."""

    QUERY = "clocks.sm,clocks.mem,power.draw,temperature.gpu"

    def __init__(self):
        self._p = None
        self.lines: List[str] = []

    def __enter__(self):
        try:
            self._p = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={self.QUERY}",
                 "--format=csv,noheader,nounits", "-lms", "5000"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self._p = None
        return self

    def __exit__(self, *exc):
        if self._p is not None:
            self._p.terminate()
            out, _ = self._p.communicate(timeout=60)
            self.lines = [ln for ln in out.splitlines() if ln.strip()]
        return False

    def summary(self) -> str:
        cols = [[] for _ in self.QUERY.split(",")]
        for ln in self.lines:
            parts = [x.strip() for x in ln.split(",")]
            for c, x in zip(cols, parts):
                try:
                    c.append(float(x))
                except ValueError:
                    pass
        return "; ".join(
            f"{name} min {min(c)} median {float(np.median(c))} max {max(c)}"
            for name, c in zip(self.QUERY.split(","), cols) if c
        ) + f" ({len(self.lines)} samples)"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def require_cards(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: this benchmark "
                     "runs on the card only")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} card(s); "
                     f"torch.cuda.device_count() is {torch.cuda.device_count()}")


def reference_digests(pool, config: dict, device, colour_dtype=None):
    """The reference's digest and point count of each pool frame."""
    import torch

    from .ref.recon import reconstruct_frame

    out, counts = [], []
    for f in pool:
        pos, rgb = reconstruct_frame(
            f.patches, f.occ, f.geo, f.attr, config, device,
            colour_dtype=colour_dtype or torch.float64)
        out.append(check.digest(pos, rgb))
        counts.append(len(pos))
    return out, counts


class SpanLog(dict):
    """A GOF's ``stage_seconds`` that also logs each span as the program
    closes it: ``(name, start, end, gof)`` by ``time.perf_counter``
    (the program's stage timer adds the span's length to the entry as
    it ends). List appends are atomic, so the decoder's threads share
    one log."""

    def __init__(self, log: list, gof: int):
        super().__init__()
        self._log, self._gof = log, gof

    def __setitem__(self, key, value):
        now = time.perf_counter()
        length = value - self.get(key, 0.0)
        super().__setitem__(key, value)
        self._log.append((key, now - length, now, self._gof))


def tapped_stats(log: list):
    """A ``DecodeStats`` whose GOFs log their spans into ``log``."""
    from tpu_vpcc_torch.utils.stats import DecodeStats, GofStats

    class Tapped(DecodeStats):
        def new_gof(self):
            g = GofStats(gof_index=len(self.gofs),
                         stage_seconds=SpanLog(log, len(self.gofs)))
            self.gofs.append(g)
            return g

    return Tapped()


@contextmanager
def traced(profiler):
    """``profiler`` (None: nothing) over the block, which it marks as the
    traced window."""
    if profiler is None:
        yield
        return
    from torch.profiler import record_function

    from .trace import WINDOW
    with profiler, record_function(WINDOW):
        yield


class Timed:
    """The timed part of a run and what it saw."""

    def __init__(self, staged, config: dict, traffic: dict, seconds: float,
                 device: str):
        self.staged, self.config, self.traffic = staged, config, traffic
        self.seconds = float(seconds)
        self.device = device
        self.F = config["frames_per_gof"]
        self.live = traffic["loop"] == "open"
        self.handed: List[tuple] = []  # (due or None, handed at)
        self.recv_t: List[float] = []
        self.t_start = 0.0
        self.t_open = self.t_close = None
        self.stats = None
        self.spans: List[tuple] = []
        self.checker = check.Checker()

    def _feed(self, stop: threading.Event):
        k = 0
        period = self.F / self.traffic.get("frames_per_s", 1.0)
        while not stop.is_set():
            due = None
            if self.live:
                due = self.t_start + (k + 1) * period
                if due > self.t_start + self.seconds:
                    return
                time.sleep(max(0.0, due - time.perf_counter()))
            gof = adapter.gof_data(self.staged[k % len(self.staged)],
                                   self.config)
            self.handed.append((due, time.perf_counter()))
            yield gof
            k += 1

    def _recv(self, dec):
        """The next frame; None at the end, or where the decoder failed
        (its error is logged, and the frames not received are missing)."""
        try:
            return dec.recv_frame()
        except Exception as e:  # the program's failure is the run's result
            log(f"the decoder failed: {e!r}")
            return None

    def run(self, profiler=None):
        """Drive the decoder through the window and drain it; with
        ``profiler``, the whole of it is traced."""
        from tpu_vpcc_torch.runtime.pipeline import Decoder, Params

        stop = threading.Event()
        dec = Decoder(Params(device=self.device,
                             pipeline_gofs=self.traffic["pipeline_gofs"]))
        dec.stats = tapped_stats(self.spans)
        # past this the run stops waiting: frames not yet received count
        # as missing
        give_up = threading.Timer(self.seconds + 2 * DRAIN_S, dec.close)
        open_after = self.traffic.get("open_after_gofs", 0)
        with traced(profiler):
            self.t_start = time.perf_counter()
            dec.start_gofs(self._feed(stop))
            give_up.start()
            n = 0
            try:
                while (ps := self._recv(dec)) is not None:
                    t = time.perf_counter()
                    self.recv_t.append(t)
                    self.checker.put(n, ps)
                    n += 1
                    if self.live or n % self.F or self.t_close:
                        continue
                    if self.t_open is None:
                        if n // self.F >= open_after:
                            self.t_open, self.n_open = t, n
                    elif t - self.t_open >= self.seconds:
                        self.t_close, self.n_close = t, n
                        stop.set()
                        give_up.cancel()
                        give_up = threading.Timer(DRAIN_S, dec.close)
                        give_up.start()
            finally:
                give_up.cancel()
                stop.set()
            self.t_end = time.perf_counter()
        self.stats = dec.stats
        self.checker.close()

    def handed_gofs(self) -> List[int]:
        """The pool GOF of each hand-over."""
        P = self.traffic["pool_gofs"]
        return [k % P for k in range(len(self.handed))]

    def gof_ends(self) -> List[float]:
        """When each whole GOF had been received."""
        return self.recv_t[self.F - 1::self.F]

    def judge(self, want) -> tuple:
        """``(wrong, missing, extra)``: received frame i held to
        ``want``'s digest of its pool frame."""
        F, P = self.F, self.traffic["pool_gofs"]
        n_handed = len(self.handed) * F
        expected = [want[((i // F) % P) * F + i % F] for i in range(n_handed)]
        wrong, missing = check.compare(self.checker.digests, expected)
        return wrong, missing, max(0, len(self.recv_t) - n_handed)


def decode_gof_streams(feeds, params, max_host_workers: int, stats):
    """The program's multi-stream batcher over one GOF feed a stream,
    yielding ``(stream, frame, PointSet3)``: its wave loop
    (``parallel.batcher._decode_waves``), each stream's next GOF pulled
    from its feed in the batcher's prep pool. ``stats`` is one
    ``GofStats`` for the whole decode."""
    from tpu_vpcc_torch.parallel import batcher

    return batcher._decode_waves([iter(f) for f in feeds],
                                 lambda it: next(it, None), params,
                                 max_host_workers, stats=stats)


class TimedStreams:
    """The timed part of a multi-stream run and what it saw. The
    batcher's generator runs on a thread of its own, which the run
    abandons where the program hangs; received frames are keyed by
    stream and by their place in it."""

    live = False

    def __init__(self, staged, config: dict, traffic: dict, seconds: float,
                 device: str):
        self.staged, self.config, self.traffic = staged, config, traffic
        self.seconds = float(seconds)
        self.device = device
        self.F = config["frames_per_gof"]
        self.S, self.P = traffic["streams"], traffic["pool_gofs"]
        self.handed: List[tuple] = []  # (None, handed at), all streams
        self.gofs_handed = [0] * self.S
        self.received = [0] * self.S
        #: (stream, place) of frames whose frame index was not their place
        self.mislabelled: set = set()
        self.recv_t: List[float] = []
        self.gof_t: List[float] = []
        self.t_start = 0.0
        self.t_open = self.t_close = None
        self.stats = None
        self.spans: List[tuple] = []
        self.checker = check.Checker()
        self._stop = threading.Event()
        #: GOFs a stream may be handed: set, once the window is long
        #: enough, where the streams' counts differ, so that they meet
        self._cap = float("inf")
        self._lock = threading.Lock()

    def _feed(self, s: int):
        """Stream s's GOFs, fresh objects each, until the window closes;
        only the batcher's prep for stream s pulls it, one at a time."""
        while True:
            with self._lock:
                k = self.gofs_handed[s]
                if self._stop.is_set() or k >= self._cap:
                    return
                self.gofs_handed[s] += 1
            gof = adapter.gof_data(self.staged[(s + k) % self.P], self.config)
            self.handed.append((None, time.perf_counter()))
            yield gof

    def _consume(self, out: queue.Queue, stats) -> None:
        from tpu_vpcc_torch.runtime.pipeline import Params

        try:
            for s, f, ps in decode_gof_streams(
                    [self._feed(s) for s in range(self.S)],
                    Params(device=self.device), self.traffic["host_workers"],
                    stats):
                out.put((s, f, ps, time.perf_counter()))
        except Exception as e:  # the program's failure is the run's result
            log(f"the batcher failed: {e!r}")
        finally:
            out.put(None)

    def _take(self, n: int, s, f, ps) -> bool:
        """File received frame n; True where it completed a whole GOF of
        its stream. A frame on no stream of the run is filed apart, and
        counts as extra."""
        if not (isinstance(s, (int, np.integer)) and 0 <= s < self.S):
            self.checker.put(("stray", n), ps)
            return False
        place = self.received[s]
        self.received[s] += 1
        if f != place:
            self.mislabelled.add((s, place))
        self.checker.put((s, place), ps)
        return self.received[s] % self.F == 0

    def _at_gof_end(self, t: float, n: int) -> bool:
        """A whole GOF was received at ``t``, with frame n: open or close
        the window; True where it closes."""
        self.gof_t.append(t)
        if self.t_close:
            return False
        whole = [r // self.F for r in self.received]
        if self.t_open is None:
            if sum(whole) >= self.traffic["open_after_gofs"]:
                self.t_open, self.n_open = t, n
            return False
        if t - self.t_open < self.seconds:
            return False
        if len(set(whole)) == 1:
            self.t_close, self.n_close = t, n
            self._stop.set()
            return True
        # a stream lags a whole GOF: feed none further than the furthest
        # has been fed, so that the streams meet
        with self._lock:
            self._cap = max(self.gofs_handed)
        return False

    def run(self, profiler=None):
        """Drive the batcher through the window and drain it; with
        ``profiler``, the whole of it is traced."""
        self.stats = tapped_stats(self.spans)
        out: queue.Queue = queue.Queue()
        consumer = threading.Thread(
            target=self._consume, args=(out, self.stats.new_gof()),
            name="vpcc_bench-batcher", daemon=True)
        with traced(profiler):
            self.t_start = time.perf_counter()
            consumer.start()
            # past this the run stops waiting: frames not yet
            # received count as missing
            give_up = self.t_start + self.seconds + 2 * DRAIN_S
            n = 0
            try:
                while True:
                    try:
                        item = out.get(timeout=max(
                            0.0, give_up - time.perf_counter()))
                    except queue.Empty:
                        log("the batcher gave no frame in time")
                        break
                    if item is None:
                        consumer.join()
                        break
                    s, f, ps, t = item
                    self.recv_t.append(t)
                    n += 1
                    if (self._take(n - 1, s, f, ps)
                            and self._at_gof_end(t, n)):
                        give_up = time.perf_counter() + DRAIN_S
            finally:
                self._stop.set()
            self.t_end = time.perf_counter()
        self.checker.close()

    def handed_gofs(self) -> List[int]:
        return [(s + k) % self.P for s in range(self.S)
                for k in range(self.gofs_handed[s])]

    def gof_ends(self) -> List[float]:
        return self.gof_t

    def judge(self, want) -> tuple:
        """``(wrong, missing, extra)``: frame i of stream s held to
        ``want``'s digest of pool frame ``((s + i // F) mod P) * F + i mod
        F``; a frame whose index was not its place is wrong, one past its
        stream's hand-overs or on no stream extra."""
        F, P = self.F, self.P
        got = self.checker.digests
        wrong = missing = 0
        for s in range(self.S):
            for i in range(self.gofs_handed[s] * F):
                d = got.get((s, i))
                if d is None:
                    missing += 1
                elif (d != want[((s + i // F) % P) * F + i % F]
                      or (s, i) in self.mislabelled):
                    wrong += 1
        extra = sum(1 for s, i in got
                    if s == "stray" or i >= self.gofs_handed[s] * F)
        return wrong, missing, extra


def warm_up_streams(staged, config: dict, traffic: dict, device: str) -> int:
    """One wave through the batcher, one GOF a stream, stream s taking
    pool GOF s mod ``pool_gofs``: the kernel libraries load, and every
    pool GOF and the wave's merged input are decoded once. Returns the
    frames out."""
    from tpu_vpcc_torch.runtime.pipeline import Params

    feeds = [[adapter.gof_data(staged[s % len(staged)], config)]
             for s in range(traffic["streams"])]
    return sum(1 for _ in decode_gof_streams(
        feeds, Params(device=device), traffic["host_workers"], None))


def warm_up(staged, config: dict, traffic: dict, device: str) -> int:
    """Decode each pool GOF once on a decoder of the cell's settings:
    the kernel libraries load (built on a checkout's first run), and every
    shape the window uses is allocated once. Returns the frames out."""
    from tpu_vpcc_torch.runtime.pipeline import Decoder, Params

    dec = Decoder(Params(device=device,
                         pipeline_gofs=traffic["pipeline_gofs"]))
    dec.start_gofs([adapter.gof_data(s, config) for s in staged])
    return sum(1 for _ in dec)


def profiler_for(device: str):
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def run_cell(bench: Bench, cell_name: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda") -> dict:
    """One run of a cell; returns the result line's object. ``device``
    other than a card serves the CPU tests, at their configurations."""
    import torch

    cell = bench.cell(cell_name)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    F = config["frames_per_gof"]
    if torch.device(device).type == "cuda":
        require_cards(cell["chips"])
        kind = torch.cuda.get_device_name(0)
        log(f"card: {kind}, {torch.cuda.device_count()} visible, "
            f"{cell['chips']} used; nvidia-smi name, power.limit: "
            f"{smi('name,power.limit')}")
    else:
        kind = f"{device} (not a card)"

    # set-up: the pool, its staging, the warm decode
    last = [PROCESS_T0]

    def lap(what: str) -> None:
        now = time.perf_counter()
        log(f"set-up: {what} {now - last[0]:.3f} s")
        last[0] = now

    lap("torch and the card")
    pool = gen.make_pool(seed, config, traffic["pool_gofs"] * F)
    lap("the pool")
    staged = [adapter.stage(pool[g * F:(g + 1) * F], config)
              for g in range(traffic["pool_gofs"])]
    lap("its staging")
    multi = "streams" in traffic
    warm = warm_up_streams if multi else warm_up
    warm_frames = warm(staged, config, traffic, device)
    lap(f"the warm decode ({warm_frames} frames of {len(pool)})")
    timed = (TimedStreams if multi else Timed)(staged, config, traffic,
                                               seconds, device)
    prof = profiler_for(device) if trace else None
    with Sampler() as sampler:
        setup_s = time.perf_counter() - PROCESS_T0
        use0 = resource.getrusage(resource.RUSAGE_SELF)
        timed.run(prof)
        use1 = resource.getrusage(resource.RUSAGE_SELF)
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    log(f"window: {len(timed.handed)} GOFs handed over, "
        f"{len(timed.recv_t)} frames received, "
        f"{timed.t_end - timed.t_start:.3f} s from the first hand-over to "
        f"the last frame; nvidia-smi during it: {sampler.summary()}")
    log(host_cpu(use0, use1))
    log("GOFs completed at (s from the first hand-over): " + " ".join(
        f"{t - timed.t_start:.3f}" for t in timed.gof_ends()))
    timed.staged = staged = None  # the program's inputs go

    # the reference, once the window has closed
    t_ref = time.perf_counter()
    want, counts = reference_digests(pool, config, device)
    log(f"reference: {len(pool)} pool frames in "
        f"{time.perf_counter() - t_ref:.3f} s")
    n_handed = len(timed.handed) * F
    wrong, missing, extra = timed.judge(want)
    checks = {"frames_wrong": wrong + extra, "frames_missing": missing}
    log(f"host memory peak (ru_maxrss): "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024} bytes")

    if trace:
        metrics = per_layer(bench, cell_name, config, traffic, timed, pool,
                            counts, prof)
    else:
        metrics = end_to_end(bench, cell_name, timed, setup_s)
    result = {
        "correct": all(checks[k] <= LIMITS[k] for k in LIMITS),
        "attempted": n_handed,
        "failed": wrong + missing,
        "metrics": metrics,
        "device": {"platform": "gpu", "kind": kind, "count": cell["chips"],
                   "memory_peak_bytes": int(peak)},
        "checks": {k: {"value": v, "limit": LIMITS[k]}
                   for k, v in checks.items()},
    }
    if trace:
        result["device"].update(busy_s=metrics.pop("_busy_s"),
                                window_s=metrics.pop("_window_s"))
        result["breakdown"] = metrics.pop("_breakdown")
        result["checks"] = result.pop("checks")
    return result


def end_to_end(bench: Bench, cell: str, timed: Timed, setup_s: float
               ) -> dict:
    out = {}
    for m in bench.metrics(cell, "end_to_end"):
        name = m["name"]
        if name == "setup_s":
            v = setup_s
        elif name == "frames_per_s":
            if timed.t_close is not None:
                v = ((timed.n_close - timed.n_open)
                     / (timed.t_close - timed.t_open))
            else:  # the decoder stopped early: that run is not correct
                v = len(timed.recv_t) / (timed.t_end - timed.t_start)
        elif name == "frame_latency_p95_ms":
            v = float(np.percentile(latencies_s(timed), 95)) * 1e3
        else:
            raise KeyError(f"no end-to-end metric {name!r} in the harness")
        out[name] = {"value": v, "unit": m["unit"]}
    return out


def latencies_s(timed: Timed) -> np.ndarray:
    """Each handed-over frame's latency from its GOF's due time; a frame
    never received counts from its due time to the run's end."""
    F = timed.F
    out = []
    for i in range(len(timed.handed) * F):
        due = timed.handed[i // F][0]
        got = timed.recv_t[i] if i < len(timed.recv_t) else None
        out.append((got if got is not None else timed.t_end) - due)
    return np.asarray(out)


def per_layer(bench: Bench, cell: str, config: dict, traffic: dict,
              timed: Timed, pool, counts, prof) -> dict:
    from . import trace as T

    tr = T.read_profile(prof)
    F = config["frames_per_gof"]
    pool_bytes = [
        roofline.gof_bytes(config, [f.patches for f in pool[g * F:(g + 1) * F]],
                           counts[g * F:(g + 1) * F])
        for g in range(traffic["pool_gofs"])
    ]
    total_bytes: dict = {}
    for g in timed.handed_gofs():
        for key, b in pool_bytes[g].items():
            total_bytes[key] = total_bytes.get(key, 0) + b
    spans: dict = {}
    for g in timed.stats.gofs:
        for key, v in dict(g.stage_seconds).items():
            spans[key] = spans.get(key, 0.0) + v
    record = {
        "frames": len(timed.recv_t),
        "gofs": len(timed.stats.gofs),
        "spans": spans,
        "trace": tr,
        "busy_s": T.busy_s(tr),
        "window_s": tr.window_s,
        "bytes": total_bytes,
        "late_s": [t - due for due, t in timed.handed if due is not None],
    }
    out = {}
    for m in bench.metrics(cell, "per_layer"):
        v = bench.reader(m["name"])(record)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    out["_busy_s"] = record["busy_s"]
    out["_window_s"] = record["window_s"]
    out["_breakdown"] = {"device_ops": T.top_device_ops(tr),
                         "idle_gaps": T.idle_gaps(tr, timed.spans,
                                                  timed.t_start)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m vpcc_bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run_cell(Bench(), args.workload, args.seed, args.seconds,
                          bool(args.trace))
    except NoCard as e:
        log(f"no result: {e}")
        return 1
    found = banned_modules()
    if found:
        log(f"no result: the run loaded {', '.join(found)}")
        return 1
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0
