"""Grid smoothing on the grid's far edge, over several frames at once.

The wide path smooths a dispatch's frames in one pass, each frame's grid
folded into one flat cell axis at ``frame * grid_width³``. A point at a
coordinate of ``grid_size * grid_width`` (z = 1024 on the 10-bit grid of
8) has a cell id past its frame's last cell; the per-frame numpy oracle
clips it into that last cell. Clipping the flat id over all frames
instead would put it in the next frame's first cells, where it pulls the
next frame's centroids and cluster gates. Only a batch of two frames or
more can show that, so every case here has two.

The port (``tpu_vpcc_torch.ops.smoothing`` and the wide words'
``ops.tiled.smooth_words_shards``, one shard and two) is held to the
oracle frame by frame. ``tpu_vpcc``'s device path clips over all frames,
and is pinned as differing from the oracle on the same batch: the
divergence lives in the reference, which stays as it is.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_vpcc.ops import smoothing as ref_smoothing
from tpu_vpcc_torch.atlas import groups as G
from tpu_vpcc_torch.ops import smoothing as S
from tpu_vpcc_torch.ops import smoothing_np as SNP
from tpu_vpcc_torch.ops import tiled as T

GEO = S.SmoothingConfig(grid_size=8, threshold=16)
ATTR = S.AttrSmoothingConfig(8, 255, 1)
#: the far edge of the 10-bit grid of 8: grid_size * grid_width
EDGE = GEO.grid_size * GEO.grid_width
#: slots a group holds in :func:`_edge_batch`
GROUP_SLOTS = 64


def _edge_batch(seed=0, n=2048):
    """Two frames of slot data (F = 2, S = n). Frame 0: points of four
    clusters near the grid's far corner, among them points at z = EDGE,
    and one each at x = EDGE and y = EDGE (with z in the last cell
    row). Frame 1: points of four other clusters near z = 0, under the
    x and y of frame 0's z = EDGE points, so that any of those landing in
    frame 1's grid would move them. Cluster ids are constant over each
    run of :data:`GROUP_SLOTS` slots, as a group's are."""
    assert EDGE == 1024 and n % GROUP_SLOTS == 0
    r = np.random.default_rng(seed)
    xs = np.zeros((2, n), np.int32)
    ys = np.zeros((2, n), np.int32)
    zs = np.zeros((2, n), np.int32)
    # frame 0 near the far corner; frame 1 low in z, same x and y span
    xs[0], ys[0] = r.integers(992, 1024, n), r.integers(992, 1024, n)
    zs[0] = r.integers(992, 1024, n)
    xs[1], ys[1] = r.integers(992, 1024, n), r.integers(992, 1024, n)
    zs[1] = r.integers(0, 24, n)
    # frame 0's far-edge points, spread over the groups
    edge = r.choice(n, 96, replace=False)
    zs[0, edge[:64]] = EDGE
    xs[0, edge[64:80]] = EDGE
    ys[0, edge[80:]] = EDGE
    groups = n // GROUP_SLOTS
    gpid = np.stack([r.integers(0, 4, groups), r.integers(4, 8, groups)])
    pid = np.repeat(gpid, GROUP_SLOTS, axis=1).astype(np.int32)
    valid = r.random((2, n)) < 0.9
    valid[0, edge] = True
    cy, cu, cv = (r.integers(0, 1024, (2, n)).astype(np.int32)
                  for _ in range(3))
    # the far-edge points' colours stand out, so a centroid they enter
    # moves
    cy[0, edge], cu[0, edge], cv[0, edge] = 1023, 0, 1023
    return xs, ys, zs, valid, pid, cy, cu, cv


def _oracle(batch, geo, attr):
    """The numpy oracle, one frame at a time: geometry smoothing, then
    colour smoothing on the smoothed positions."""
    xs, ys, zs, valid, pid, cy, cu, cv = batch
    out = []
    for f in range(xs.shape[0]):
        p = (xs[f], ys[f], zs[f])
        c = (cy[f], cu[f], cv[f])
        if geo is not None:
            p = SNP.smooth_slots_np(*p, valid[f], pid[f], geo)
        if attr is not None:
            c = SNP.smooth_colors_np(*p, *c, valid[f], pid[f], attr)
        out.append(tuple(np.asarray(a) for a in (*p, *c)))
    return out


def _assert_frames_equal(got, want):
    """``got``: six (F, S) arrays x, y, z, cy, cu, cv; ``want``: per
    frame, the oracle's six."""
    for f, w in enumerate(want):
        for name, a, b in zip(("x", "y", "z", "cy", "cu", "cv"), got, w):
            np.testing.assert_array_equal(np.asarray(a)[f], b,
                                          err_msg=f"frame {f}, {name}")


def test_the_batch_reaches_the_far_edge_and_smoothing_moves_points():
    batch = _edge_batch()
    xs, ys, zs = batch[:3]
    assert (zs[0] == EDGE).sum() == 64
    assert (xs[0] == EDGE).sum() >= 16 and (ys[0] == EDGE).sum() >= 16
    want = _oracle(batch, GEO, ATTR)
    for f in range(2):
        moved = sum(int((w != o[f]).sum())
                    for w, o in zip(want[f], (*batch[:3], *batch[5:])))
        assert moved > 0, f


def test_geometry_smoothing_keeps_each_frame_in_its_own_grid():
    batch = _edge_batch()
    xs, ys, zs, valid, pid = batch[:5]
    got = S.smooth_batch(*(torch.from_numpy(a) for a in
                           (xs, ys, zs, valid, pid)), GEO)
    _assert_frames_equal(
        [t.numpy() for t in got] + list(batch[5:]), _oracle(batch, GEO, None)
    )


def test_colour_smoothing_keeps_each_frame_in_its_own_grid():
    batch = _edge_batch(seed=1)
    xs, ys, zs, valid, pid, cy, cu, cv = batch
    got = S.smooth_colors_batch(*(torch.from_numpy(a) for a in
                                  (xs, ys, zs, cy, cu, cv, valid, pid)),
                                ATTR)
    _assert_frames_equal(
        [xs, ys, zs] + [t.numpy() for t in got], _oracle(batch, None, ATTR)
    )


def _shards(batch, n_shards):
    """The batch as wide words, split over ``n_shards`` contiguous group
    ranges: ``(fields, w0, w1, w2, valid)`` each, with ``G_PATCH`` the
    groups' cluster ids."""
    xs, ys, zs, valid, pid, cy, cu, cv = (torch.from_numpy(a) for a in batch)
    F, n = xs.shape
    groups = n // GROUP_SLOTS
    fields = torch.zeros((F, groups, G.N_GROUP_FIELDS), dtype=torch.int32)
    fields[:, :, G.G_PATCH] = pid[:, ::GROUP_SLOTS]
    words = (T._pack16(xs, ys), T._pack16(zs, cy), T._pack16(cu, cv))
    g_step, s_step = groups // n_shards, n // n_shards
    return [
        (fields[:, k * g_step:(k + 1) * g_step],
         *(w[:, k * s_step:(k + 1) * s_step] for w in words),
         valid[:, k * s_step:(k + 1) * s_step])
        for k in range(n_shards)
    ]


@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("geo,attr", [(GEO, None), (None, ATTR),
                                      (GEO, ATTR)],
                         ids=["geometry", "colour", "both"])
def test_wide_words_smoothing_keeps_each_frame_in_its_own_grid(
        n_shards, geo, attr):
    from tpu_vpcc_torch.ops.reconstruct import make_config

    batch = _edge_batch(seed=2)
    cfg = make_config(width=128, height=128, occupancy_resolution=16,
                      occupancy_precision=4, smoothing=geo,
                      attr_smoothing=attr)
    shards = _shards(batch, n_shards)
    combine = (None if n_shards == 1
               else lambda grids: S.combine_stats(grids, ["cpu"] * n_shards))
    out = T.smooth_words_shards(shards, cfg, combine)
    w0, w1, w2 = (torch.cat([o[i] for o in out], dim=1) for i in range(3))
    got = [T._lo16(w0), T._hi16(w0), T._lo16(w1), T._hi16(w1),
           T._lo16(w2), T._hi16(w2)]
    _assert_frames_equal([t.numpy() for t in got],
                         _oracle(batch, geo, attr))


@pytest.mark.parametrize("kind", ["geometry", "colour"])
def test_reference_device_path_spills_into_the_next_frame(kind):
    """``tpu_vpcc``'s device path clips the flat cell id over all frames,
    so frame 0's z = EDGE points land in frame 1's grid: its frame 1
    differs from the oracle (frame 0 may too), where the port's equals
    it (the tests above). Pinned as the reference's divergence."""
    batch = _edge_batch(seed=0 if kind == "geometry" else 1)
    xs, ys, zs, valid, pid, cy, cu, cv = batch
    if kind == "geometry":
        ref = ref_smoothing.smooth_batch(
            *(jnp.asarray(a) for a in (xs, ys, zs, valid, pid)), GEO)
        got = [np.asarray(a) for a in ref]
        want = [w[:3] for w in _oracle(batch, GEO, None)]
    else:
        ref = ref_smoothing.smooth_colors_batch(
            *(jnp.asarray(a) for a in (xs, ys, zs, cy, cu, cv, valid, pid)),
            ATTR)
        got = [np.asarray(a) for a in ref]
        want = [w[3:] for w in _oracle(batch, None, ATTR)]
    assert any(not np.array_equal(g[1], w) for g, w in zip(got, want[1]))
