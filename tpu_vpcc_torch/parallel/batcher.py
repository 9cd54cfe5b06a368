"""Multi-stream batched decoding (BASELINE.json config 5).

Counterpart of ``tpu_vpcc.parallel.batcher``.
Decodes several V3C bitstreams concurrently: the host stages (V3C parse +
HEVC sub-stream decode) run in a thread pool, one worker per stream, and
frames from all streams are reconstructed in shared device dispatches:
GOFs whose :class:`~tpu_vpcc_torch.runtime.pipeline.DeviceInputs` share a
batch key (staged ``FrameConfig``, layout, colour mode, group extent) are
concatenated along the frame axis and dispatched together, in chunks of
``pipeline.DEVICE_BATCH`` frames, through the same kernels as the
single-stream ``Decoder``. With a ``mesh``, each shared batch is chunked
at ``DEVICE_BATCH x data`` frames and its tiled chunks shard frames over
the mesh's 'data' axis and groups over 'space'
(``tpu_vpcc_torch.parallel.spatial``).
"""

from __future__ import annotations

from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..bitio import Bitstream
from ..reconstruction.pointset import PointSet3
from ..runtime import pipeline
from ..runtime.pipeline import (
    DeviceInputs,
    GofData,
    Params,
    _append_eom_points,
    _append_layer_frame,
    _append_plr_points,
    _append_raw_points,
    _dispatch_device,
    _emit_pointset,
    _gof_device_inputs,
    _gof_map_pair_view,
    _gof_tables_and_bucket,
    _merge_layer_sec_vals,
    _meta_has_plr,
    _reconstruct_gof_oracle,
    _secondary_chunk_values,
    _st,
    prepare_gof,
    resolve_device,
)
from ..v3c.context import Context
from ..v3c.stream import SampleStreamV3CUnit


@dataclass
class _StreamState:
    index: int
    source: object  # what the stream's prep reads its next GOF from
    next_frame: int = 0


def _concat_inputs(dis: List[DeviceInputs]) -> DeviceInputs:
    """Merge same-key DeviceInputs along the frame axis (one dispatch):
    the tiled layout's (fields, cat) or the gather's seven arrays."""
    if len(dis) == 1:
        return dis[0]
    return replace(
        dis[0],
        arrays=tuple(
            np.concatenate(arrays) for arrays in zip(*(di.arrays for di in dis))
        ),
        n_frames=sum(di.n_frames for di in dis),
    )


def _dispatch_chunked(di: DeviceInputs, device, stats=None, mesh=None):
    """Dispatch a (possibly merged) batch in ``pipeline.DEVICE_BATCH``
    frame chunks (``DEVICE_BATCH x data`` on a ``mesh``), sliced without
    copies; returns the flat per-frame result list."""
    chunk = pipeline.DEVICE_BATCH * (
        mesh.shape["data"] if mesh is not None else 1
    )
    out = []
    for i in range(0, di.n_frames, chunk):
        sub = replace(
            di,
            arrays=tuple(a[i : i + chunk] for a in di.arrays),
            n_frames=min(chunk, di.n_frames - i),
        )
        out.extend(_dispatch_device(sub, device, stats=stats, mesh=mesh))
    return out


def _decode_waves(
    sources: Sequence,
    prep: Callable[[object], Optional[GofData]],
    params: Params,
    max_host_workers: int = 8,
    coalesce_initial: bool = True,
    stats=None,
    mesh=None,
) -> Iterator[Tuple[int, int, PointSet3]]:
    """The wave loop of :func:`decode_streams_batched` over any per-stream
    GOF source: ``prep(sources[i])`` returns stream i's next GOF, or None
    once it is done, and runs in the pool. ``stats`` (a ``GofStats``)
    collects the host-clock stage split (``recon_tables``,
    ``recon_stage``, ``recon_dispatch``, ``recon_fetch``,
    ``recon_emit``) and the ``mesh_fallback_dispatches`` counter.
    ``mesh`` wins over ``params.mesh``."""
    device = resolve_device(params.device) if params.use_device else None
    mesh = mesh if mesh is not None else params.mesh
    space = mesh.shape["space"] if mesh is not None else 1
    states = [_StreamState(index=i, source=s) for i, s in enumerate(sources)]

    def run(state: _StreamState):
        return state, prep(state.source)

    with ThreadPoolExecutor(max_workers=max_host_workers) as pool:
        pending = {pool.submit(run, s) for s in states}
        first_wave = coalesce_initial
        while pending:
            when = "ALL_COMPLETED" if first_wave else FIRST_COMPLETED
            finished, pending = wait(pending, return_when=when)
            first_wave = False
            # one wave: every GOF whose host prep has completed by now
            items = []  # (state, gof, DeviceInputs, tables, g_bucket, layers)
            for fut in finished:
                state, gof = fut.result()
                if gof is None or not gof.metas:
                    continue
                if not params.use_device:
                    # oracle path: per-stream scalar decode (debug/CI)
                    for ps in _reconstruct_gof_oracle(gof):
                        yield state.index, state.next_frame, ps
                        state.next_frame += 1
                    pending.add(pool.submit(run, state))
                    continue
                layer_views = []
                if gof.map_count > 2:
                    # >2 maps: the batched dispatch covers the map-0/1
                    # pair; trailing layers run per GOF after it (the
                    # same drop_map0 passes as _reconstruct_gof_device)
                    layer_views = [
                        _gof_map_pair_view(gof, m - 1)
                        for m in range(2, gof.map_count)
                    ]
                    gof = _gof_map_pair_view(gof, 0)
                with _st(stats, "recon_tables"):
                    cfg, tables, g_bucket = _gof_tables_and_bucket(gof, space)
                with _st(stats, "recon_stage"):
                    di = _gof_device_inputs(gof, gof.metas, (cfg, tables),
                                            g_bucket)
                items.append((state, gof, di, (cfg, tables), g_bucket,
                              layer_views))
                pending.add(pool.submit(run, state))

            by_key: Dict[object, list] = {}
            for it in items:
                by_key.setdefault(it[2].batch_key, []).append(it)
            for group in by_key.values():
                merged = _concat_inputs([it[2] for it in group])
                results = _dispatch_chunked(merged, device, stats=stats,
                                            mesh=mesh)
                offset = 0
                for state, gof, di, prebuilt, g_b, layer_views in group:
                    sec_vals = (
                        _secondary_chunk_values(gof, gof.metas, prebuilt, g_b,
                                                device, stats=stats,
                                                mesh=mesh)
                        if gof.sec_attrs else None
                    )
                    layer_results = None
                    if layer_views:
                        lcfg = replace(prebuilt[0], drop_map0=True)
                        layer_results = [
                            _dispatch_chunked(
                                _gof_device_inputs(lv, lv.metas,
                                                   (lcfg, prebuilt[1]), g_b),
                                device, stats=stats, mesh=mesh,
                            )
                            for lv in layer_views
                        ]
                        if sec_vals is not None:
                            for lv in layer_views:
                                _merge_layer_sec_vals(
                                    sec_vals,
                                    _secondary_chunk_values(
                                        lv, lv.metas, (lcfg, prebuilt[1]),
                                        g_b, device, stats=stats, mesh=mesh,
                                    ),
                                )
                    for j, (pos, col) in enumerate(
                        results[offset : offset + di.n_frames]
                    ):
                        with _st(stats, "recon_emit"):
                            ps = _emit_pointset(pos, col, gof)
                            if layer_results is not None:
                                for lres in layer_results:
                                    _append_layer_frame(ps, *lres[j], gof)
                            if sec_vals is not None:
                                ps.extra_attrs = sec_vals[j]
                            meta = gof.metas[j]
                            # the same tail order as the single-stream GOF
                            # decode: PLR, then EOM, then raw
                            if _meta_has_plr(gof, meta):
                                _append_plr_points(ps, gof, meta)
                            if meta.eom_patches:
                                _append_eom_points(ps, gof, meta)
                            if meta.raw_patches:
                                _append_raw_points(ps, gof, meta)
                        yield state.index, state.next_frame, ps
                        state.next_frame += 1
                    offset += di.n_frames


def decode_streams_batched(
    paths: Sequence,
    max_host_workers: int = 8,
    mesh=None,
    coalesce_initial: bool = True,
    params: Params = None,
) -> Iterator[Tuple[int, int, PointSet3]]:
    """Decode multiple streams, yielding (stream_index, frame_index, frame).

    GOFs across streams are host-prepared concurrently; every wave of
    prepared GOFs is grouped by device-batch key and each group runs as
    ONE concatenated device dispatch (chunked at the device batch size).
    With ``coalesce_initial`` the first wave waits for every stream's
    first GOF so all streams share the first dispatch (they start
    together; later waves take whatever has completed). Yields in
    completion order across streams; frames within a stream are in order.

    ``params`` carries the same decode options as the single-stream
    ``Decoder`` (smoothing toggles, per-GOF video threads, oracle path,
    ``device``, mesh) and applies to every stream; the explicit ``mesh``
    argument wins over ``params.mesh`` when both are given.
    """
    params = params if params is not None else Params()
    sources = [
        SampleStreamV3CUnit.from_bitstream(Bitstream(Path(p).read_bytes()))
        for p in paths
    ]

    def prep(ssvu: SampleStreamV3CUnit) -> Optional[GofData]:
        if ssvu.get_v3c_unit_count() == 0:
            return None
        context = Context()
        ssvu.decode_gof(context)
        return prepare_gof(
            context,
            num_video_threads=max(1, params.num_threads),
            tiled=params.use_device,
            apply_geo_smoothing=params.apply_geo_smoothing_type,
            apply_attr_smoothing=params.apply_attr_smoothing_type,
            apply_occupancy_synthesis=params.apply_occupancy_synthesis_type,
        )

    yield from _decode_waves(sources, prep, params, max_host_workers,
                             coalesce_initial, mesh=mesh)


def decode_streams(paths: Sequence, **kw) -> List[List[PointSet3]]:
    """Convenience wrapper: fully decode all streams, returning per-stream
    ordered frame lists."""
    out: Dict[int, List[PointSet3]] = {i: [] for i in range(len(paths))}
    for stream_idx, _frame_idx, ps in decode_streams_batched(paths, **kw):
        out[stream_idx].append(ps)
    return [out[i] for i in range(len(paths))]
