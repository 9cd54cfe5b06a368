"""The smoothing kernels (``csrc/grid_smooth.cu``) against the plain
PyTorch versions of ``tpu_vpcc_torch.ops.smoothing``.

On the CPU: the kernel wrappers refuse what the kernels do not take
before any launch, and CPU tensors take the plain versions without
loading the kernels. The ``cuda``-marked tests hold the kernels on a
card to the plain versions' bytes on the CPU: the six cell grids of
both passes and the apply's outputs on one and two frames (coordinates
on the grid's far edge, invalid slots and empty cells, a frame's slots
all in one cell, seeded slots with negative coordinates), the wide
words' smoothing on one and two shards, the gather fallback's flat
functions, the launch count, and the wide dispatch's
``smooth_kernel_passes``. They skip without a card (on the card:
``pytest -m cuda tests/test_torch_smooth_kernels.py``). This file
imports no JAX, so it runs where JAX is missing.
"""

import numpy as np
import pytest
import torch

from tpu_vpcc_torch.atlas import groups as G
from tpu_vpcc_torch.ops import smoothing as S
from tpu_vpcc_torch.ops import tiled as T

#: the benchmark's smoothing (``vpcc8i_1280_smooth``): grids of 128³ a frame
GEO = S.SmoothingConfig(grid_size=8, threshold=16)
ATTR = S.AttrSmoothingConfig(8, 255, 1)
#: the far edge of the 10-bit grid of 8: grid_size * grid_width
EDGE = GEO.grid_size * GEO.grid_width
#: slots a group holds (one cluster id a group, as in the wide path)
GROUP_SLOTS = 64
#: a small grid for the CPU cases: 6-bit coordinates, 16³ cells a frame
SMALL_GEO = S.SmoothingConfig(grid_size=4, threshold=4,
                              geometry_bitdepth_3d=6)
SMALL_ATTR = S.AttrSmoothingConfig(4, 255, 1, geometry_bitdepth_3d=6)

CASES = ("far_edge", "invalid_and_empty", "one_cell", "seeded")


def _slots(case, F, seed=0, n=4096):
    """Flat slot arrays of ``F`` frames of ``n`` slots as numpy: ``(xs,
    ys, zs, cy, cu, cv, valid, pid, frame)``.

    - ``far_edge``: points near the grid's far corner, a share of them
      at x, y or z = :data:`EDGE`;
    - ``invalid_and_empty``: a few boxes of points over a mostly empty
      grid, half the slots invalid, the invalid ones in boxes of their
      own whose cells stay empty;
    - ``one_cell``: all of a frame's slots in one cell;
    - ``seeded``: slots crowded near the grid's origin, a tenth of them
      anywhere on it, and past both of its ends (negative coordinates,
      as the gather path may give), their frames in no order.
    """
    r = np.random.default_rng(seed)
    N = F * n

    def ints(lo, hi):
        return r.integers(lo, hi, N).astype(np.int32)

    frame = np.repeat(np.arange(F), n)
    valid = r.random(N) < 0.9
    if case == "far_edge":
        xs, ys, zs = ints(992, EDGE), ints(992, EDGE), ints(992, EDGE)
        edge = r.choice(N, N // 8, replace=False)
        for axis, part in zip((xs, ys, zs), np.array_split(edge, 3)):
            axis[part] = EDGE
        valid[edge] = True
    elif case == "invalid_and_empty":
        box = r.integers(0, 992, (N // 256, 3))
        corner = np.repeat(box, 256, axis=0)
        xs, ys, zs = ((corner[:, k] + ints(0, 32)).astype(np.int32)
                      for k in range(3))
        valid = np.repeat(r.random(N // 256) < 0.5, 256)
    elif case == "one_cell":
        xs, ys, zs = ints(8, 16), ints(8, 16), ints(8, 16)
        valid[:] = True
    elif case == "seeded":
        xs, ys, zs = ints(-16, 112), ints(-16, 112), ints(-16, 112)
        far = r.random(N) < 0.1
        for axis in (xs, ys, zs):
            axis[far] = r.integers(-16, EDGE + 16, int(far.sum()))
        frame = r.integers(0, F, N)
    else:
        raise ValueError(case)
    pid = np.repeat(r.integers(0, 4, N // GROUP_SLOTS),
                    GROUP_SLOTS).astype(np.int32)
    cy, cu, cv = ints(0, 1024), ints(0, 1024), ints(0, 1024)
    return xs, ys, zs, cy, cu, cv, valid, pid, frame.astype(np.int64)


def _torch(arrays, device="cpu"):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


def _pass_args(kind, slots):
    """The arguments of one pass's ``_stats``/apply: geometry's payload
    is its coordinates, colour's ``cy, cu, cv``."""
    xs, ys, zs, cy, cu, cv, valid, pid, frame = slots
    payload = (xs, ys, zs) if kind == "geometry" else (cy, cu, cv)
    return (xs, ys, zs, *payload, valid, pid, frame)


def _plain_apply(kind, stats, args, cfg):
    if kind == "geometry":
        return S.geometry_apply_plain(stats, *args[:3], *args[6:], cfg)
    return S.color_apply_plain(stats, *args, cfg)


@pytest.fixture
def no_kernels(monkeypatch):
    """Fails a test that loads the kernel library, and counts from 0."""

    def refuse():
        raise AssertionError("the smoothing kernels were loaded")

    monkeypatch.setattr(S, "_load", refuse)
    S.reset_launches()
    passes = S.thread_passes()
    yield
    assert S.launches == 0
    assert S.thread_passes() == passes


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------


def _small(F=2, seed=3, n=1024):
    """Flat slot tensors of F frames in frame order on the small grid
    (:data:`SMALL_GEO`), as :func:`_slots` gives them."""
    r = np.random.default_rng(seed)
    N = F * n
    xs, ys, zs = (r.integers(0, 64, N).astype(np.int32) for _ in range(3))
    cy, cu, cv = (r.integers(0, 1024, N).astype(np.int32) for _ in range(3))
    valid = r.random(N) < 0.8
    pid = np.repeat(r.integers(0, 3, N // GROUP_SLOTS),
                    GROUP_SLOTS).astype(np.int32)
    frame = np.repeat(np.arange(F), n).astype(np.int64)
    return _torch((xs, ys, zs, cy, cu, cv, valid, pid, frame))


#: what the wrappers refuse: (slot argument, its bad value)
BAD_SLOTS = {
    "xs_int64": ("xs", lambda t: t.to(torch.int64)),
    "valid_uint8": ("valid", lambda t: t.to(torch.uint8)),
    "frame_int32": ("frame", lambda t: t.to(torch.int32)),
    "pid_strided": ("pid", lambda t: t.repeat(2)[::2]),
    "c_short": ("c", lambda t: t[:-1]),
    "ys_2d": ("ys", lambda t: t.reshape(2, -1)),
}
SLOT_NAMES = ("xs", "ys", "zs", "a", "b", "c", "valid", "pid", "frame")


@pytest.mark.parametrize("wrapper", ["stats", "apply"])
@pytest.mark.parametrize("bad", sorted(BAD_SLOTS))
def test_kernel_wrappers_refuse_bad_slots_before_any_launch(no_kernels,
                                                            wrapper, bad):
    name, spoil = BAD_SLOTS[bad]
    args = dict(zip(SLOT_NAMES, _pass_args("colour", _small())))
    args[name] = spoil(args[name])
    with pytest.raises((TypeError, ValueError), match=rf"\b{name}\b"):
        if wrapper == "stats":
            S._stats_cuda(*args.values(), 2, SMALL_ATTR)
        else:
            grids = S._stats_plain(*_pass_args("colour", _small()), 2,
                                   SMALL_ATTR)
            S._apply_cuda(grids, *args.values(), SMALL_ATTR, color=True)


#: grids the apply wrapper refuses
BAD_GRIDS = {
    "five": lambda g: g[:5],
    "int64": lambda g: (g[0].to(torch.int64),) + tuple(g[1:]),
    "short": lambda g: tuple(t[:-1] for t in g),
    "part_frame": lambda g: tuple(t[: t.numel() // 2 + 8] for t in g),
}


@pytest.mark.parametrize("bad", sorted(BAD_GRIDS))
def test_apply_wrapper_refuses_bad_grids_before_any_launch(no_kernels, bad):
    args = _pass_args("geometry", _small())
    grids = BAD_GRIDS[bad](S._stats_plain(*args, 2, SMALL_GEO))
    with pytest.raises(ValueError, match="grid|stats"):
        S._apply_cuda(grids, *args, SMALL_GEO, color=False)


def test_stats_wrapper_refuses_no_frames(no_kernels):
    with pytest.raises(ValueError, match="n_frames"):
        S._stats_cuda(*_pass_args("geometry", _small()), 0, SMALL_GEO)


@pytest.mark.parametrize("entry", ["stats_and_apply", "flat", "words"])
def test_cpu_tensors_take_the_plain_path(no_kernels, entry):
    """On CPU tensors every entry runs the plain versions: both passes
    give the bytes of calling them directly, no kernel is loaded and no
    launch counted."""
    F = 2
    slots = _small(F)
    xs, ys, zs, cy, cu, cv, valid, pid, frame = slots
    tail = (valid, pid, frame)
    pos = S.geometry_apply_plain(
        S._stats_plain(*_pass_args("geometry", slots), F, SMALL_GEO),
        xs, ys, zs, *tail, SMALL_GEO)
    c_args = (*pos, cy, cu, cv, *tail)
    want = (*pos, *S.color_apply_plain(
        S._stats_plain(*c_args, F, SMALL_ATTR), *c_args, SMALL_ATTR))
    if entry == "stats_and_apply":
        st = S.geometry_stats(xs, ys, zs, *tail, F, SMALL_GEO)
        p = S.geometry_apply(st, xs, ys, zs, *tail, SMALL_GEO)
        st = S.color_stats(*p, cy, cu, cv, *tail, F, SMALL_ATTR)
        got = (*p, *S.color_apply(st, *p, cy, cu, cv, *tail, SMALL_ATTR))
    elif entry == "flat":
        p = S.smooth_flat(xs, ys, zs, *tail, F, SMALL_GEO)
        got = (*p, *S.smooth_colors_flat(*p, cy, cu, cv, *tail, F,
                                         SMALL_ATTR))
    else:
        shards = _shards(slots[:8], F, 1)
        (words,) = T.smooth_words_shards(shards,
                                         _wide_config(SMALL_GEO, SMALL_ATTR))
        got = tuple(f(w).reshape(-1) for w in words
                    for f in (T._lo16, T._hi16))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(not torch.equal(w, a)
               for w, a in zip(want, (xs, ys, zs, cy, cu, cv)))


@pytest.fixture
def checked_kernels(monkeypatch):
    """The kernel path on CPU tensors: each launch's arrays go through the
    wrappers' own checks (:func:`S._check_slots`), then the plain
    versions run in the kernels' place."""

    def stats(xs, ys, zs, a, b, c, valid, pid, frame, n_frames, cfg):
        S._check_slots(**dict(zip(SLOT_NAMES, (xs, ys, zs, a, b, c, valid,
                                               pid, frame))))
        return S._stats_plain(xs, ys, zs, a, b, c, valid, pid, frame,
                              n_frames, cfg)

    def apply(stats, xs, ys, zs, a, b, c, valid, pid, frame, cfg, color):
        S._check_slots(**dict(zip(SLOT_NAMES, (xs, ys, zs, a, b, c, valid,
                                               pid, frame))))
        if color:
            return S.color_apply_plain(stats, xs, ys, zs, a, b, c, valid,
                                       pid, frame, cfg)
        return S.geometry_apply_plain(stats, xs, ys, zs, valid, pid, frame,
                                      cfg)

    monkeypatch.setattr(S, "uses_kernels", lambda t: True)
    monkeypatch.setattr(S, "_stats_cuda", stats)
    monkeypatch.setattr(S, "_apply_cuda", apply)


@pytest.mark.parametrize("F", [1, 2])
@pytest.mark.parametrize("entry", ["words", "flat", "batch"])
def test_every_entry_gives_the_kernels_arrays_they_take(checked_kernels,
                                                        entry, F):
    """What each entry hands the kernels passes their wrappers' checks,
    one frame included, where a flattened broadcast of the frame index
    is a stride-0 view: the wide words (one shard's frames, as a mesh
    row of one frame has them), the gather fallback's flat slots (frame
    and cluster id broadcast over (F, groups, slots), as
    ``ops.reconstruct.gather_words`` builds them) and (F, S) slots."""
    slots = _small(F)
    xs, ys, zs, cy, cu, cv, valid, pid, _frame = slots
    if entry == "words":
        T.smooth_words_shards(_shards(slots[:8], F, 1),
                              _wide_config(SMALL_GEO, SMALL_ATTR))
    elif entry == "flat":
        f = torch.arange(F).view(F, 1, 1)
        shape = (F, xs.numel() // F // GROUP_SLOTS, GROUP_SLOTS)
        frame = f.expand(shape)
        pid_b = pid.view(shape)[:, :, :1].expand(shape)
        pos = S.smooth_flat(*(t.view(shape) for t in (xs, ys, zs)),
                            valid.view(shape), pid_b, frame, F, SMALL_GEO)
        S.smooth_colors_flat(*pos, cy, cu, cv, valid.view(shape), pid_b,
                             frame, F, SMALL_ATTR)
    else:
        two_d = [t.view(F, -1) for t in (xs, ys, zs, cy, cu, cv, valid,
                                          pid)]
        pos = S.smooth_batch(*two_d[:3], *two_d[6:], SMALL_GEO)
        S.smooth_colors_batch(*pos, *two_d[3:], SMALL_ATTR)


def test_kernel_times_smooth_passes_match_the_words(no_kernels):
    """``tools.kernel_times.smooth_passes``, which the smoke times beside
    the kernels, gives ``smooth_words_shards``'s bytes on the slot arrays
    ``smooth_slot_arrays`` unpacks, through the entries and in the plain
    versions."""
    from tpu_vpcc_torch.tools import kernel_times

    F = 2
    (shard,) = _shards(_small(F)[:8], F, 1)
    cfg = _wide_config(SMALL_GEO, SMALL_ATTR)
    (words,) = T.smooth_words_shards([shard], cfg)
    want = [f(w).reshape(-1) for w in words for f in (T._lo16, T._hi16)]
    cols, args = T.smooth_slot_arrays(*shard)
    for plain in (False, True):
        pos, col = kernel_times.smooth_passes(cols, args, F, cfg, plain)
        assert all(torch.equal(a, b) for a, b in zip((*pos, *col), want))


def test_uses_kernels_names_the_device():
    assert S.uses_kernels(torch.zeros(1)) is False
    with pytest.raises(NotImplementedError, match="meta"):
        S.uses_kernels(torch.zeros(1, device="meta"))


def test_kernel_constants_match_the_plain_versions():
    """The kernels' empty-cell min and max pid (``kBig``) and block size
    are the plain versions' ``BIG`` and a whole number of warps."""
    import re
    from pathlib import Path

    src = (Path(S.__file__).resolve().parent.parent / "csrc"
           / "grid_smooth.cu").read_text()
    big = re.search(r"constexpr int32_t kBig = 1 << (\d+);", src)
    threads = re.search(r"constexpr int kThreads = (\d+);", src)
    assert big and 1 << int(big.group(1)) == S.BIG
    assert threads and int(threads.group(1)) % 32 == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the card: pytest -m cuda)")


def _wide_config(geo, attr):
    from tpu_vpcc_torch.ops.reconstruct import make_config

    return make_config(width=128, height=128, occupancy_resolution=16,
                       occupancy_precision=4, smoothing=geo,
                       attr_smoothing=attr)


def _shards(batch, F, n_shards):
    """Flat slot tensors ``(xs, ys, zs, cy, cu, cv, valid, pid)`` of F
    frames in frame order, as wide words split over ``n_shards``
    contiguous group ranges: ``(fields, w0, w1, w2, valid)`` each, with
    ``G_PATCH`` the groups' cluster ids."""
    xs, ys, zs, cy, cu, cv, valid, pid = (t.reshape(F, -1) for t in batch)
    n = xs.shape[1]
    groups = n // GROUP_SLOTS
    fields = torch.zeros((F, groups, G.N_GROUP_FIELDS), dtype=torch.int32,
                         device=xs.device)
    fields[:, :, G.G_PATCH] = pid[:, ::GROUP_SLOTS]
    words = (T._pack16(xs, ys), T._pack16(zs, cy), T._pack16(cu, cv))
    g_step, s_step = groups // n_shards, n // n_shards
    return [
        (fields[:, k * g_step:(k + 1) * g_step].contiguous(),
         *(w[:, k * s_step:(k + 1) * s_step].contiguous() for w in words),
         valid[:, k * s_step:(k + 1) * s_step].contiguous())
        for k in range(n_shards)
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [1, 2])
@pytest.mark.parametrize("kind", ["geometry", "colour"])
@pytest.mark.parametrize("case", CASES)
def test_stats_kernel_matches_plain_on_card(case, kind, frames):
    _cuda_or_skip()
    cfg = GEO if kind == "geometry" else ATTR
    slots = _slots(case, frames, seed=len(case) + frames)
    want = S._stats_plain(*_pass_args(kind, _torch(slots)), frames, cfg)
    args = _pass_args(kind, _torch(slots, "cuda"))
    before = S.launches
    got = S._stats(*args, frames, cfg)
    again = S._stats(*args, frames, cfg)
    torch.cuda.synchronize()
    assert S.launches == before + 4
    for k, (a, b, w) in enumerate(zip(got, again, want)):
        assert a.dtype == torch.int32 and a.shape == w.shape, k
        assert torch.equal(a.cpu(), w), f"grid {k}"
        assert torch.equal(b.cpu(), w), f"grid {k}, second run"
    if case == "one_cell":
        assert int((want[0] > 0).sum()) <= frames
        assert int(want[0].sum()) == len(slots[0])


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [1, 2])
@pytest.mark.parametrize("kind", ["geometry", "colour"])
@pytest.mark.parametrize("case", CASES)
def test_apply_kernel_matches_plain_on_card(case, kind, frames):
    _cuda_or_skip()
    cfg = GEO if kind == "geometry" else ATTR
    slots = _slots(case, frames, seed=len(case) + frames)
    cpu = _pass_args(kind, _torch(slots))
    stats = S._stats_plain(*cpu, frames, cfg)
    want = _plain_apply(kind, stats, cpu, cfg)
    args = _pass_args(kind, _torch(slots, "cuda"))
    before = S.launches
    if kind == "geometry":
        got = S.geometry_apply([t.cuda() for t in stats], *args[:3],
                               *args[6:], cfg)
    else:
        got = S.color_apply([t.cuda() for t in stats], *args, cfg)
    torch.cuda.synchronize()
    assert S.launches == before + 1
    for a, w in zip(got, want):
        assert a.dtype == torch.int32
        assert torch.equal(a.cpu(), w)
    assert any(not torch.equal(w, p) for w, p in zip(want, cpu[3:6]))


@pytest.mark.cuda
@pytest.mark.parametrize("F", [1, 2])
@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("geo,attr", [(GEO, None), (None, ATTR),
                                      (GEO, ATTR)],
                         ids=["geometry", "colour", "both"])
def test_wide_words_smoothing_on_card_matches_cpu(n_shards, geo, attr, F):
    """``smooth_words_shards`` on one and two frames with far-edge
    points, one shard and two combined by ``combine_stats``: the card's
    words are the CPU's, three launches a pass a shard, one of them an
    apply that ``thread_passes`` counts."""
    _cuda_or_skip()
    slots = _slots("far_edge", F, seed=7)
    batch = slots[:8]
    cfg = _wide_config(geo, attr)

    def run(device):
        shards = _shards(_torch(batch, device), F, n_shards)
        combine = (None if n_shards == 1 else
                   lambda grids: S.combine_stats(grids, [device] * n_shards))
        return [[t.cpu() for t in out]
                for out in T.smooth_words_shards(shards, cfg, combine)]

    want = run("cpu")
    before, before_passes = S.launches, S.thread_passes()
    got = run("cuda")
    passes = (geo is not None) + (attr is not None)
    assert S.launches == before + 3 * passes * n_shards
    assert S.thread_passes() == before_passes + passes * n_shards
    for g, w in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(g, w))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_gather_smoothing_on_card_matches_cpu(seed):
    """The gather fallback's ``smooth_flat`` and ``smooth_colors_flat``
    on slots of three frames in no order, some coordinates negative:
    the card's bytes are the CPU's, three launches a pass."""
    _cuda_or_skip()
    xs, ys, zs, cy, cu, cv, valid, pid, frame = _slots("seeded", 3, seed)

    def run(device):
        t = _torch((xs, ys, zs, cy, cu, cv, valid, pid, frame), device)
        pos = S.smooth_flat(*t[:3], *t[6:], 3, GEO)
        col = S.smooth_colors_flat(*pos, *t[3:], 3, ATTR)
        return [a.cpu() for a in (*pos, *col)]

    want = run("cpu")
    before = S.launches
    got = run("cuda")
    assert S.launches == before + 6
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert any(not np.array_equal(w.numpy(), a)
               for w, a in zip(want, (xs, ys, zs, cy, cu, cv)))


@pytest.mark.cuda
def test_kernel_times_smooth_cases_on_card():
    """``tools.kernel_times.smooth_cases``, the smoke's check of the
    kernels at a dispatch's shape, finds them byte-equal to the plain
    versions on far-edge slots of two frames, and both passes move
    something; three launches a pass."""
    _cuda_or_skip()
    from tpu_vpcc_torch.tools import kernel_times

    F = 2
    (shard,) = _shards(_torch(_slots("far_edge", F, seed=5)[:8], "cuda"),
                       F, 1)
    cols, args = T.smooth_slot_arrays(*shard)
    before = S.launches
    err, moved, runs = kernel_times.smooth_cases(cols, args, F,
                                                 _wide_config(GEO, ATTR))
    assert S.launches == before + 6
    assert err == 0 and all(moved)
    assert sorted(runs) == ["colour apply", "colour stats",
                            "geometry apply", "geometry stats"]


@pytest.mark.cuda
def test_wide_decode_counts_kernel_passes_on_card():
    """A smoothed decode on the card: two ``smooth_kernel_passes`` a
    wide dispatch, frames equal to the CPU decode's."""
    _cuda_or_skip()
    from test_torch_stats import _decode_seeing_smoothing, _wide_gofs
    from tpu_vpcc_torch.runtime.pipeline import Decoder, Params
    from tpu_vpcc_torch.utils.ply import format_ply

    _cpu, want, _ = _decode_seeing_smoothing(_wide_gofs(n=1))
    dec = Decoder(Params(device="cuda"))
    dec.start_gofs(_wide_gofs(n=1))
    frames = list(dec)
    assert [format_ply(f) for f in frames] == [format_ply(f) for f in want]
    (g,) = dec.stats.gofs
    dispatches = sum(s.name == "recon_smooth" for s in g.spans)
    assert dispatches == 2
    assert g.counters["smooth_kernel_passes"] == 2 * dispatches

