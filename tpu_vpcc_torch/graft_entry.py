"""Entry points of the port: a single-device forward check and a
multi-device dry run.

Counterpart of the repository's root ``__graft_entry__.py`` (which stays
the JAX package's). The reference's dry run creates virtual CPU devices;
here the mesh is a grid of ``torch.device``: the machine's cards, or one
device named ``n`` times (``device="cpu"``, or one card named repeatedly)
(``parallel.mesh``). The port has no encoder, so the bitstream check
decodes the committed ``tests/data/verify_64x64_2f.bin``.
"""

from __future__ import annotations

from dataclasses import replace
from pathlib import Path

VERIFY_STREAM = (Path(__file__).resolve().parent.parent / "tests" / "data"
                 / "verify_64x64_2f.bin")


def entry(device: str = "cuda"):
    """Returns ``(fn, example_args)``: the flagship's narrow dispatch on
    staged inputs (``ops.tiled.reconstruct_batch_pretiled_packed``:
    gather, words and K1 on a card) at 256^2, one frame, and its staged
    ``(fields, cat)`` on ``device``. ``fn(*example_args)`` returns
    ``(ops, counts)``. A CUDA device without a card raises."""
    from functools import partial

    from .models.flagship import (
        FlagshipConfig,
        bucket_flagship_inputs,
        example_pretiled_batch_inputs,
    )
    from .ops.tiled import (
        reconstruct_batch_pretiled_packed,
        stage_cat_inputs,
        to_device,
    )
    from .runtime.pipeline import resolve_device

    # small-but-representative shapes so the check is quick
    cfg = FlagshipConfig(
        width=256, height=256, occupancy_resolution=16, occupancy_precision=4,
        map_count=2, batch=1,
    )
    tiled, fcfg, _, _ = bucket_flagship_inputs(
        example_pretiled_batch_inputs(cfg, n_patches=8), cfg.frame_config())
    (fields, cat), fcfg = stage_cat_inputs(*tiled, fcfg)
    args = to_device(fields, cat, resolve_device(device))
    return partial(reconstruct_batch_pretiled_packed, cfg=fcfg), args


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


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """Run the sharded reconstruction over an ``n_devices`` mesh on tiny
    shapes, and decode a committed stream through it.

    The mesh is ('data', 'space'): frames over 'data' and the group axis
    of each frame's field table over 'space' (two shards when
    ``n_devices`` is even), the per-frame totals summed across the
    shards. ``device="cuda"`` takes the first ``n_devices`` cards;
    another device name (``"cpu"``, ``"cuda:0"``) is named ``n_devices``
    times. Exercised: the wide path (K2W, K1F), the narrow path (K1), the
    gather drivers, a smoothed step (the grids combined across the
    shards), and ``Decoder(Params(mesh=...))`` on
    ``tests/data/verify_64x64_2f.bin`` byte-equal to the oracle; raises
    AssertionError on a mismatch. The stream decode needs the video
    bridge (libavcodec)."""
    import numpy as np

    from .models.flagship import (
        FlagshipConfig,
        example_batch_inputs,
        example_pretiled_batch_inputs,
    )
    from .ops.smoothing import AttrSmoothingConfig, SmoothingConfig
    from .ops.tiled import stage_cat_inputs
    from .parallel.mesh import make_mesh
    from .parallel.spatial import (
        reconstruct_gof_spatial,
        reconstruct_gof_spatial_pretiled,
        reconstruct_gof_spatial_pretiled_packed,
        stitch_spatial,
    )
    from .runtime.pipeline import Decoder, Params, _fetch_sharded_packed
    from .utils.ply import format_ply

    space = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    data = n_devices // space
    mesh = make_mesh(_mesh_devices(n_devices, device), data=data,
                     space=space)
    cfg = FlagshipConfig(
        width=64, height=64, occupancy_resolution=8, occupancy_precision=4,
        map_count=2, batch=data,  # one frame per 'data' row
    )
    fcfg = cfg.frame_config()
    s_loc = fcfg.s_cap // space

    # the wide path on the staged cat, groups sharded over 'space'
    (fields, cat), scfg = stage_cat_inputs(
        *example_pretiled_batch_inputs(cfg, n_patches=3), fcfg)
    ops, cnt, totals = reconstruct_gof_spatial_pretiled(mesh, fields, cat,
                                                         scfg)
    wide = _fetch_sharded_packed(ops, cnt, space, s_loc, layout="wide")
    total = sum(len(p) for p, _ in wide)
    assert total > 0, "dry run produced no points"
    assert (totals[:, 0] == cnt.sum(axis=1)).all()

    # the narrow path (K1 per shard): the same points
    ops_p, cnt_p, _ = reconstruct_gof_spatial_pretiled_packed(
        mesh, fields, cat, scfg)
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
    _, cnt_s, _ = reconstruct_gof_spatial_pretiled(mesh, fields, cat, smooth)
    assert int(cnt_s.sum()) == total, "smoothing changed the point count"

    # a committed bitstream through Decoder(Params(mesh=...)) against the
    # oracle decode
    stream = VERIFY_STREAM.read_bytes()
    dm = Decoder(Params(stream, mesh=mesh, device=str(mesh.devices[0, 0])))
    dm.start()
    sharded = [format_ply(f) for f in dm]
    dorc = Decoder(Params(stream, use_device=False))
    dorc.start()
    oracle = [format_ply(f) for f in dorc]
    assert len(sharded) == len(oracle) > 0
    assert sharded == oracle, "mesh bitstream decode differs from the oracle"
    assert not dm.stats.counter_totals().get("mesh_fallback_dispatches"), (
        "the stream's dispatches fell back to one device")
