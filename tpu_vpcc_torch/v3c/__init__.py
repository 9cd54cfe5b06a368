"""V3C (ISO/IEC 23090-5) bitstream syntax layer.

Host-side parsing of the V-PCC sample stream into frozen syntax objects:
V3C units, VPS, atlas NAL units (ASPS/AFPS/ATL/SEI) and patch data units.
Parity reference: ``tmc2-rs src/bitstream/reader.rs`` (C3–C11 in SURVEY.md).
"""

from .syntax import (  # noqa: F401
    V3CUnitType,
    NalUnitType,
    TileType,
    PatchOrientation,
    SeiPayloadType,
    V3CParameterSet,
    ProfileTierLevel,
    OccupancyInformation,
    GeometryInformation,
    AttributeInformation,
    AtlasSequenceParameterSet,
    AtlasFrameParameterSet,
    AtlasFrameTileInformation,
    RefListStruct,
    AtlasTileHeader,
    AtlasTileLayer,
    IntraPatchDataUnit,
    InterPatchDataUnit,
    MergePatchDataUnit,
    SkipPatchDataUnit,
    PatchInformationData,
    SeiMessage,
    SeiGeometrySmoothing,
    VideoType,
    ceil_log2,
)
from .context import Context, AtlasHighLevelSyntax  # noqa: F401
from .stream import (  # noqa: F401
    V3CUnit,
    SampleStreamV3CUnit,
    parse_sample_stream,
    decode_gof,
)
