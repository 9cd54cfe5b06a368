"""Static reconstruction geometry of one dispatch.

Counterpart of ``tpu_vpcc.ops.reconstruct.FrameConfig``/``make_config``
with the fields the narrow and wide paths read (the TPU compaction
policy fields are not ported), and ``apply_inverse_rot45``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class FrameConfig:
    width: int
    height: int
    occupancy_resolution: int
    occupancy_precision: int
    map_count: int = 2
    absolute_d1: bool = True
    # trailing-layer pass over the map pair (m-1, m): the D0 slots are
    # dedup comparands only, so only the D1 points emit
    drop_map0: bool = False
    geo_shift: int = 2  # depth = sample >> geo_shift
    # attribute chroma subsampling: 1 for 4:2:0, 0 for 4:4:4/RGB
    chroma_shift: int = 1
    # geometry / attribute smoothing configs (None = off): the wide path
    smoothing: object = None
    attr_smoothing: object = None
    # the host transposed SWAP-family blocks in the packed cat, so the
    # gathered tiles arrive in patch memory order
    host_oriented: bool = False
    # some patch projects onto a 45-degree plane (wide path only)
    additional_planes: bool = False
    geometry_bitdepth_3d: int = 10
    # all three coordinates pack into one u32, 10 bits each (the host
    # proved every axis value < 1024: atlas.groups.coords_fit_10bit)
    pack30: bool = False

    @property
    def slots_per_block(self) -> int:
        return self.occupancy_resolution * self.occupancy_resolution * 2

    @property
    def g_cap(self) -> int:
        """Canvas blocks: the group-axis capacity."""
        res = self.occupancy_resolution
        return (self.height // res) * (self.width // res)


def make_config(
    width: int,
    height: int,
    occupancy_resolution: int,
    occupancy_precision: int,
    map_count: int = 2,
    absolute_d1: bool = True,
    geo_shift: int = 2,
    chroma_shift: int = 1,
    smoothing=None,
    attr_smoothing=None,
    pack30: bool = False,
    additional_planes: bool = False,
    geometry_bitdepth_3d: int = 10,
) -> FrameConfig:
    return FrameConfig(
        width=width,
        height=height,
        occupancy_resolution=occupancy_resolution,
        occupancy_precision=occupancy_precision,
        map_count=map_count,
        absolute_d1=absolute_d1,
        geo_shift=geo_shift,
        chroma_shift=chroma_shift,
        smoothing=smoothing,
        attr_smoothing=attr_smoothing,
        pack30=pack30,
        additional_planes=additional_planes,
        geometry_bitdepth_3d=geometry_bitdepth_3d,
    )


def apply_inverse_rot45(px, py, pz, plane, bitdepth: int):
    """Inverse 45-degree rotation, counterpart of
    ``tpu_vpcc.ops.reconstruct.apply_inverse_rot45``.

    ``px/py/pz``: int32 rotated-frame components; ``plane``: int32
    ``axis_of_additional_plane`` broadcastable against them (0 =
    identity). ``>> 1`` on int32 is an arithmetic shift (floor), as in
    the scalar oracle. Returns u16-masked int32 components."""
    shift = (1 << (bitdepth - 1)) - 1

    def pair(rs, rd):
        return (rs - rd + shift) >> 1, (rs + rd - shift) >> 1

    x1, z1 = pair(px, pz)  # plane 1 mixes (x, z)
    z2, y2 = pair(pz, py)  # plane 2 mixes (z, y)
    y3, x3 = pair(py, px)  # plane 3 mixes (y, x)
    nx = torch.where(plane == 1, x1, torch.where(plane == 3, x3, px))
    ny = torch.where(plane == 2, y2, torch.where(plane == 3, y3, py))
    nz = torch.where(plane == 1, z1, torch.where(plane == 2, z2, pz))
    return nx & 0xFFFF, ny & 0xFFFF, nz & 0xFFFF
