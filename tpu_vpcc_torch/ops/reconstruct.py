"""Static reconstruction geometry of one dispatch.

Counterpart of ``tpu_vpcc.ops.reconstruct.FrameConfig``/``make_config``
with the fields the narrow path reads. The gating fields (``smoothing``,
``attr_smoothing``, ``additional_planes``) are kept so that the port can
refuse what it does not run yet; the TPU compaction policy fields are
not ported.
"""

from __future__ import annotations

from dataclasses import dataclass


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
    # geometry / attribute smoothing configs (None = off); not ported
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
