"""V3C bitstream inspector — ffprobe for V-PCC streams.

    python -m tpu_vpcc_torch.runtime.inspect stream.bin [-v]

Prints the sample-stream structure, per-GOF parameter sets, video
sub-stream sizes, and per-frame patch statistics without decoding video.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from ..bitio import Bitstream
from ..v3c.context import Context
from ..v3c.stream import SampleStreamV3CUnit
from ..v3c.syntax import SeiDecodedAtlasInformationHash, TileType, VideoType


def inspect(path, verbose: bool = False, out=sys.stdout) -> int:
    data = Path(path).read_bytes()
    print(f"{path}: {len(data)} bytes", file=out)
    ssvu = SampleStreamV3CUnit.from_bitstream(Bitstream(data))
    print(
        f"sample stream: {ssvu.get_v3c_unit_count()} V3C units, "
        f"size precision {ssvu.ssvh_unit_size_precision_bytes_minus1 + 1} bytes",
        file=out,
    )
    gof = 0
    while ssvu.get_v3c_unit_count() > 0:
        context = Context()
        ssvu.decode_gof(context)
        vps = context.get_vps()
        oi, gi, ai = (
            vps.occupancy_information,
            vps.geometry_information,
            vps.attribute_information,
        )
        print(f"\nGOF {gof}:", file=out)
        print(
            f"  VPS: atlas {vps.frame_width}x{vps.frame_height}, "
            f"maps={vps.map_count_minus1 + 1}, "
            f"profile rec{vps.profile_tier_level.profile_reconstruction_idc}",
            file=out,
        )
        print(
            f"  occupancy: codec {oi.occupancy_codec_id}, "
            f"{oi.occupancy_2d_bitdepth_minus1 + 1}-bit"
            f"{' msb-aligned' if oi.occupancy_msb_align_flag else ''}",
            file=out,
        )
        print(
            f"  geometry: codec {gi.geometry_codec_id}, "
            f"2d {gi.geometry_2d_bitdepth_minus1 + 1}-bit, "
            f"3d {gi.geometry_3d_coordinates_bitdepth_minus1 + 1}-bit",
            file=out,
        )
        print(
            f"  attributes: {ai.attribute_count}"
            + "".join(
                f" [type {ai.attribute_type_id[i]}, codec {ai.attribute_codec_id[i]},"
                f" {ai.attribute_2d_bitdepth_minus1[i] + 1}-bit]"
                for i in range(ai.attribute_count)
            ),
            file=out,
        )
        for asps in context.atlas_hls.atlas_sequence_parameter_set:
            print(
                f"  ASPS {asps.atlas_sequence_parameter_set_id}: "
                f"{asps.frame_width}x{asps.frame_height}, "
                f"block {1 << asps.log2_patch_packing_block_size}px, "
                f"orientations={'8' if asps.use_eight_orientations_flag else '2'}"
                + (", vui=yes" if asps.vui_parameters_present_flag else ""),
                file=out,
            )
        n_attrs = (
            context.vps.attribute_information.attribute_count
            if context.vps is not None else 1
        )
        for vt in (
            [VideoType.OCCUPANCY, VideoType.GEOMETRY]
            # every per-map sub-stream slot (D0..D15 / T0..T15)
            + [VideoType(VideoType.GEOMETRY_D0 + m) for m in range(16)]
            + [VideoType.ATTRIBUTE]
            + [VideoType(VideoType.ATTRIBUTE_T0 + m) for m in range(16)]
            + [VideoType.GEOMETRY_RAW, VideoType.ATTRIBUTE_RAW]
        ):
            is_attr = (
                vt == VideoType.ATTRIBUTE
                or VideoType.ATTRIBUTE_T0 <= vt <= VideoType.ATTRIBUTE_T15
                or vt == VideoType.ATTRIBUTE_RAW
            )
            for k in range(max(1, n_attrs) if is_attr else 1):
                vbs = context.get_video_bitstream(vt, k)
                if vbs is not None:
                    idx = f"[{k}]" if is_attr and k > 0 else ""
                    print(
                        f"  {vt.name.lower()}{idx} video: "
                        f"{len(vbs.data)} bytes", file=out,
                    )
        n_layers = context.atlas_tile_layer_len()
        total_patches = 0
        for i in range(n_layers):
            atl = context.get_atlas_tile_layer(i)
            n_patches = len(atl.patch_information_data)
            total_patches += n_patches
            if verbose:
                ath = atl.header
                has_daih = atl.sei is not None and any(
                    isinstance(p, SeiDecodedAtlasInformationHash)
                    for p in atl.sei.sei_suffix
                )
                print(
                    f"  tile layer {i}: {TileType(ath.tile_type).name}-tile, "
                    f"afoc_lsb={ath.atlas_frame_order_count_lsb}, "
                    f"{n_patches} patches, sei={'yes' if atl.sei else 'no'}"
                    + (", hash-sei=yes" if has_daih else ""),
                    file=out,
                )
                if n_patches:
                    for j, pid in enumerate(atl.patch_information_data[:8]):
                        pdu = pid.patch_data_unit
                        desc = type(pdu).__name__.replace("PatchDataUnit", "")
                        extra = ""
                        if hasattr(pdu, "pos_2d"):
                            extra = f" pos2d={pdu.pos_2d}"
                        if hasattr(pdu, "size_2d_minus1"):
                            extra += f" size2d_m1={pdu.size_2d_minus1}"
                        print(f"    patch {j}: {desc}{extra}", file=out)
                    if n_patches > 8:
                        print(f"    ... {n_patches - 8} more", file=out)
        print(
            f"  atlas: {n_layers} tile layers, {total_patches} patches total",
            file=out,
        )
        gof += 1
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="V3C bitstream inspector")
    parser.add_argument("stream", type=Path)
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)
    try:
        return inspect(args.stream, args.verbose)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except Exception as e:
        print(f"error: malformed stream: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
