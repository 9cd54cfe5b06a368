"""Multi-stream batched decoding (BASELINE.json config 5).

Counterpart of ``tpu_vpcc.parallel.batcher``.
Decodes several V3C bitstreams concurrently: the host stages (V3C parse +
HEVC sub-stream decode) run in a thread pool, one worker per stream, and
frames from all streams are reconstructed in shared device dispatches:
GOFs whose :class:`~tpu_vpcc_torch.runtime.pipeline.DeviceInputs` share a
batch key (staged ``FrameConfig``, layout, colour mode, group extent,
and whether the cat is packed on the device or the host) are
concatenated along the frame axis into one input, which
``pipeline._dispatch_device`` runs in chunks of ``pipeline.DEVICE_BATCH``
frames through the same kernels as the single-stream ``Decoder``. Each
GOF's slice of the results is then finished as the ``Decoder`` finishes
a chunk (``pipeline._finish_frames``: trailing layers, secondary
attributes, host tails). With a ``mesh``, each shared batch is chunked
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
from ..runtime.pipeline import (
    DeviceInputs,
    GofData,
    Params,
    _dispatch_device,
    _finish_frames,
    _gof_device_inputs,
    _plan_gof,
    _reconstruct_gof_oracle,
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
    the device pack's fields, seven planes and swap mask, the host
    pack's (fields, cat), or the gather's seven arrays."""
    if len(dis) == 1:
        return dis[0]
    return replace(
        dis[0],
        arrays=tuple(
            np.concatenate(arrays) for arrays in zip(*(di.arrays for di in dis))
        ),
        n_frames=sum(di.n_frames for di in dis),
    )


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
            items = []  # (state, GofPlan, DeviceInputs)
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
                # >2 maps: the merged dispatch covers the map-0/1 pair;
                # the trailing layers run per GOF in _finish_frames
                plan = _plan_gof(gof, stats, space)
                with _st(stats, "recon_stage"):
                    di = _gof_device_inputs(plan.gof, plan.gof.metas,
                                            plan.prebuilt, plan.g_bucket)
                items.append((state, plan, di))
                pending.add(pool.submit(run, state))

            by_key: Dict[object, list] = {}
            for it in items:
                by_key.setdefault(it[2].batch_key, []).append(it)
            for group in by_key.values():
                merged = _concat_inputs([di for _, _, di in group])
                # _dispatch_device chunks the merged input
                results = _dispatch_device(merged, device, stats=stats,
                                           mesh=mesh)
                offset = 0
                for state, plan, di in group:
                    for ps in _finish_frames(
                            plan, slice(None),
                            results[offset : offset + di.n_frames], device,
                            stats=stats, mesh=mesh):
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
