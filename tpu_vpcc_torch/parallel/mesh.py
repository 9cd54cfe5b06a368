"""The device mesh of the port: frames over 'data', groups over 'space'.

Counterpart of ``tpu_vpcc.parallel.mesh``. The reference lays a
``jax.sharding.Mesh`` over its devices and lets ``shard_map`` place the
work. The port keeps the reference's single-controller model: one
process, one ``Decoder``, and a ``(data, space)`` grid of
``torch.device``. Each shard's kernels run on its own device, one loop
step per shard; launches on distinct cards are asynchronous, so shards
on different cards overlap, and what the reference does with
collectives (the per-frame totals, the smoothing grids) is an explicit
reduction across the shards' devices (``parallel.spatial``,
``ops.smoothing.combine_stats``). A mesh may name one device several
times, the counterpart of the reference's virtual CPU devices: its
shards then run one after another on that device.

The workload's axes (SURVEY.md §2.3):
  * ``data``  — frames within a GOF / concurrent streams (embarrassingly
    parallel, ``src/decoder.rs:186``),
  * ``space`` — slots within a frame (``tpu_vpcc_torch.parallel.spatial``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, Optional, Sequence

import numpy as np
import torch

from ..ops.reconstruct import FrameConfig


@dataclass(frozen=True, eq=False)
class Mesh:
    """A ``(data, space)`` grid of devices: ``devices[r, d]`` runs shard
    ``d`` of data row ``r``."""

    devices: np.ndarray  # (data, space) object array of torch.device
    axis_names: ClassVar[tuple] = ("data", "space")

    @property
    def shape(self) -> dict:
        """``{"data": d, "space": s}``, as the reference's ``mesh.shape``."""
        data, space = self.devices.shape
        return {"data": data, "space": space}


def make_mesh(
    devices: Optional[Sequence] = None, data: int = 0, space: int = 1
) -> Mesh:
    """Build a ('data', 'space') mesh. With space=1 this is pure DP.

    ``devices`` defaults to every CUDA card of the machine; without a
    card that raises (name the devices to build a CPU mesh, e.g.
    ``[torch.device("cpu")] * 8``). Devices fill the grid row by row."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() without devices takes the CUDA cards, and CUDA "
                "is not available"
            )
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if data <= 0:
        data = n // space
    if data * space != n:
        raise ValueError(f"mesh {data}x{space} != {n} devices")
    grid = np.empty((data, space), dtype=object)
    for i, dev in enumerate(devices):
        grid[i // space, i % space] = dev
    return Mesh(grid)


def reconstruct_batch_data_parallel(
    mesh: Mesh,
    fields,
    occ,
    geo0,
    geo1,
    attr_y,
    attr_u,
    attr_v,
    cfg: FrameConfig,
):
    """Batched reconstruction with the frame axis sharded over 'data':
    the gather dispatch (``ops.reconstruct.reconstruct_batch``: slot math
    and K1F) of each data row's frames on the row's first device (the
    reference replicates a row's work over 'space'; one copy is enough).

    Host arrays in, as the reference takes them (fields (F, G,
    N_GROUP_FIELDS) int32, the raster planes of the gather dispatch);
    the batch size must be divisible by the 'data' axis size. Every row
    is launched before any result is read back. Returns host arrays
    ``(positions (F, S, 3) u16, colors16 (F, S, 3) u16, counts (F,)
    int32)``, ``S = G * 2 res²``, each frame's points compacted to the
    front (the tail is unspecified)."""
    from ..ops.reconstruct import reconstruct_batch
    from ..ops.tiled import _unpack_ops_points, gather_inputs_to_device
    from ..runtime.pipeline import _u16_host

    data = mesh.shape["data"]
    arrays = [np.asarray(a) for a in
              (fields, occ, geo0, geo1, attr_y, attr_u, attr_v)]
    F = arrays[0].shape[0]
    if F % data:
        raise ValueError(f"{F} frames do not divide by the 'data' axis {data}")
    f_loc = F // data
    runs = [
        reconstruct_batch(*gather_inputs_to_device(
            *(a[r * f_loc:(r + 1) * f_loc] for a in arrays),
            mesh.devices[r, 0]), cfg)
        for r in range(data)
    ]
    pos, col, cnt = [], [], []
    for ops, counts in runs:
        p, c = _unpack_ops_points(ops, "gather")
        pos.append(_u16_host(p))
        col.append(_u16_host(c))
        cnt.append(counts.cpu().numpy())
    return np.concatenate(pos), np.concatenate(col), np.concatenate(cnt)


def pad_batch(arr: np.ndarray, multiple: int) -> np.ndarray:
    """Pad the leading axis to a multiple (padding frames are empty)."""
    n = arr.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return arr
    return np.concatenate([arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)])
