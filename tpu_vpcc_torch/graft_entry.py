"""Entry points of the port: a single-device forward check and a
multi-device dry run.

Counterpart of the repository's root ``__graft_entry__.py`` (which stays
the JAX package's). The reference's dry run creates virtual CPU devices;
here the mesh is a grid of ``torch.device``: the machine's cards, or one
device named ``n`` times (``device="cpu"``, or one card named repeatedly)
(``parallel.mesh``). The dry run authors the reference's mesh stream
with the port's ``build_fixture_stream`` (:func:`dryrun_stream`), as the
reference does, and serves its HEVC encode and decode from the committed
video store (``tools.video_store``, entries ``graft_dryrun_d<rows>``), so
it runs the same way on the CPU and on a card, with or without the
native video bridge.
"""

from __future__ import annotations

from dataclasses import replace

#: the video store's entry of the dry run's stream at ``data`` rows
DRYRUN_ENTRY = "graft_dryrun_d{data}"


def entry(device: str = "cuda"):
    """Returns ``(fn, example_args)``: the flagship's narrow dispatch on
    raw pre-tiled planes (``ops.tiled.reconstruct_planes_packed``: the
    swap mask from the fields, K5, gather, words and K1 on a card), as
    the reference's entry feeds raw planes to ``_flat_pretiled_impl``, at
    256^2, one frame, and its bucketed ``(fields, occ_t, geo0_t, geo1_t,
    ay_t, au_t, av_t)`` on ``device``. ``fn(*example_args)`` returns
    ``(ops, counts)``. A CUDA device without a card raises."""
    from functools import partial

    from .models.flagship import (
        FlagshipConfig,
        bucket_flagship_inputs,
        example_pretiled_batch_inputs,
    )
    from .ops.tiled import gather_inputs_to_device, reconstruct_planes_packed
    from .runtime.pipeline import resolve_device

    dev = resolve_device(device)
    # small-but-representative shapes so the check is quick
    cfg = FlagshipConfig(
        width=256, height=256, occupancy_resolution=16, occupancy_precision=4,
        map_count=2, batch=1,
    )
    tiled, fcfg, _, _ = bucket_flagship_inputs(
        example_pretiled_batch_inputs(cfg, n_patches=8), cfg.frame_config())
    args = gather_inputs_to_device(*tiled, dev)
    return partial(reconstruct_planes_packed, cfg=fcfg), args


def dryrun_stream(data: int) -> bytes:
    """The dry run's V3C stream at ``data`` 'data' rows, authored as the
    reference's dry run authors it: one generator seeded 51, one 64^2
    synthetic frame per row (occupancy 8/4, two maps, three patches),
    ``build_fixture_stream(frames, atlas_hash_sei=True)``. The HEVC
    encodes go through ``utils.fixtures.encode_yuv420``: the bridge's
    libx265, or the video store's lookup under ``served_encode``."""
    import numpy as np

    from .utils import fixtures
    from .utils.synthetic import make_synthetic_frame

    rng = np.random.default_rng(51)
    sfs = [
        make_synthetic_frame(
            rng, width=64, height=64, occupancy_resolution=8,
            occupancy_precision=4, map_count=2, n_patches=3, frame_index=i,
        )
        for i in range(data)  # one frame per 'data' row
    ]
    return fixtures.build_fixture_stream(sfs, atlas_hash_sei=True)


def _mesh_devices(n_devices: int, device: str):
    import torch

    from .runtime.pipeline import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        n_cards = torch.cuda.device_count()
        if n_cards < n_devices:
            raise RuntimeError(
                f"{n_devices} devices asked, {n_cards} CUDA card(s) here "
                f"(name one card, e.g. device='cuda:0', to repeat it)")
        return [torch.device("cuda", i) for i in range(n_devices)]
    return [dev] * n_devices


def dryrun_multichip(n_devices: int, device: str = "cuda", store=None) -> None:
    """Run the sharded reconstruction over an ``n_devices`` mesh on tiny
    shapes, and decode the reference's dry-run stream through it.

    The mesh is ('data', 'space'): frames over 'data' and the group axis
    of each frame's field table over 'space' (two shards when
    ``n_devices`` is even), the per-frame totals summed across the
    shards. ``device="cuda"`` takes the first ``n_devices`` cards;
    another device name (``"cpu"``, ``"cuda:0"``) is named ``n_devices``
    times. Exercised: the device pack (K5, once per distinct device of a
    data row), the wide path (K2W, K1F), the narrow path (K1), the
    gather drivers, a smoothed step (the grids combined across the
    shards), and ``Decoder(Params(mesh=...))`` on :func:`dryrun_stream`
    at the mesh's 'data' rows: one frame per row, each with points,
    byte-equal to the oracle decode and to the digests of the store's
    entry; raises AssertionError on a mismatch. The stream's HEVC encode
    and decode both come from the video store (``served_encode``,
    ``served``) on every device, never from the native bridge; a row
    count with no entry raises ``StoreMiss``. ``store``: the
    ``tools.video_store.VideoStore`` to serve from (by default the
    committed store, read anew)."""
    import hashlib

    import numpy as np

    from .models.flagship import (
        FlagshipConfig,
        example_batch_inputs,
        example_pretiled_batch_inputs,
    )
    from .ops.smoothing import AttrSmoothingConfig, SmoothingConfig
    from .ops.tiled import device_pack_stager, stage_plane_inputs
    from .parallel.mesh import make_mesh
    from .parallel.spatial import (
        reconstruct_gof_spatial,
        reconstruct_gof_spatial_pretiled,
        reconstruct_gof_spatial_pretiled_packed,
        stitch_spatial,
    )
    from .runtime.pipeline import Decoder, Params, _fetch_sharded_packed
    from .tools.video_store import StoreMiss, VideoStore, served, served_encode
    from .utils.ply import format_ply

    space = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    data = n_devices // space
    store = VideoStore() if store is None else store
    name = DRYRUN_ENTRY.format(data=data)
    if name not in store.entries:
        raise StoreMiss(f"the video store {store.root} holds no entry "
                        f"{name}: the dry run's stream at {data} 'data' rows")
    entry = store.entries[name]
    mesh = make_mesh(_mesh_devices(n_devices, device), data=data,
                     space=space)
    cfg = FlagshipConfig(
        width=64, height=64, occupancy_resolution=8, occupancy_precision=4,
        map_count=2, batch=data,  # one frame per 'data' row
    )
    fcfg = cfg.frame_config()
    s_loc = fcfg.s_cap // space

    # the wide path on the device pack's planes, groups sharded over
    # 'space'
    arrays, scfg = stage_plane_inputs(
        *example_pretiled_batch_inputs(cfg, n_patches=3), fcfg)
    staged = device_pack_stager(*arrays, scfg)
    ops, cnt, totals = reconstruct_gof_spatial_pretiled(mesh, *staged, scfg)
    wide = _fetch_sharded_packed(ops, cnt, space, s_loc, layout="wide")
    total = sum(len(p) for p, _ in wide)
    assert total > 0, "dry run produced no points"
    assert (totals[:, 0] == cnt.sum(axis=1)).all()

    # the narrow path (K1 per shard): the same points
    ops_p, cnt_p, _ = reconstruct_gof_spatial_pretiled_packed(
        mesh, *staged, scfg)
    narrow = _fetch_sharded_packed(ops_p, cnt_p, space, s_loc)
    for (pw, cw), (pn, cn) in zip(wide, narrow):
        assert np.array_equal(pw, pn) and np.array_equal(cw, cn), (
            "narrow sharded dry run disagrees with the wide one")

    # the gather drivers (slot ranges per shard)
    pos, col, cnt_g, _ = reconstruct_gof_spatial(
        mesh, *example_batch_inputs(cfg, n_patches=3), fcfg)
    for f, (pw, _) in enumerate(wide):
        gp, _ = stitch_spatial(pos[f], col[f], cnt_g[f], s_loc)
        assert np.array_equal(gp, pw), "gather dry run disagrees"

    # a smoothed step: the cell grids combined across the shards
    smooth = replace(
        scfg,
        smoothing=SmoothingConfig(8, 16, 10),
        attr_smoothing=AttrSmoothingConfig(8, 255, 1, 10),
    )
    _, cnt_s, _ = reconstruct_gof_spatial_pretiled(mesh, *staged, smooth)
    assert int(cnt_s.sum()) == total, "smoothing changed the point count"

    # the reference's stream, authored here, through
    # Decoder(Params(mesh=...)) against the oracle decode
    with served_encode(store), served(store):
        stream = dryrun_stream(data)
        assert stream == entry.stream.read_bytes(), (
            f"the dry run's stream differs from the store's {name}")
        dm = Decoder(Params(stream, mesh=mesh,
                            device=str(mesh.devices[0, 0])))
        dm.start()
        frames = list(dm)
        dorc = Decoder(Params(stream, use_device=False))
        dorc.start()
        oracle = [format_ply(f) for f in dorc]
    sharded = [format_ply(f) for f in frames]
    assert len(sharded) == len(oracle) == data, (
        f"{len(sharded)} mesh and {len(oracle)} oracle frames, want {data}")
    assert sharded == oracle, "mesh bitstream decode differs from the oracle"
    assert [hashlib.sha256(p).hexdigest() for p in sharded] == [
        o["sha256"] for o in entry.outputs], (
        f"mesh bitstream decode differs from the digests of {name}")
    assert all(len(f) > 0 for f in frames), "a frame has no points"
    assert not dm.stats.counter_totals().get("mesh_fallback_dispatches"), (
        "the stream's dispatches fell back to one device")
