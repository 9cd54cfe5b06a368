"""Command-line decoder on PyTorch.

    python -m tpu_vpcc_torch.runtime.cli -i stream.bin -o out_dir/ [--device cuda|cpu]

The flags are ``tpu_vpcc.runtime.cli``'s, plus ``--device``, minus the
no-op ``-d`` and ``--keep-intermediate-files``. Several ``-i`` inputs
(the multi-stream batcher) are not ported yet (ROADMAP queue 1 item 4).
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

from ..utils.ply import frame_output_path, write_ply


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="An MPEG-VPCC-TMC2 conformant decoder (PyTorch)"
    )
    parser.add_argument(
        "-i", "--compressed-stream-path", required=True, type=Path,
        action="append", dest="compressed_stream_paths",
        help="Path to the compressed bitstream input",
    )
    parser.add_argument(
        "-o", "--reconstructed-data-path", required=True, type=Path,
        help="Output folder (or %%4d-patterned path) for decoded point clouds",
    )
    parser.add_argument("--start-frame", type=int, default=0,
                        help="First frame number in the output naming")
    parser.add_argument("--num-threads", type=int, default=4,
                        help="Host video-decode worker threads")
    parser.add_argument("--oracle", action="store_true",
                        help="Use the NumPy oracle path instead of the device")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="torch device of the reconstruction")
    parser.add_argument("--apply-geo-smoothing", action="store_true",
                        help="honor the geometry-smoothing SEI")
    parser.add_argument("--apply-occupancy-synthesis", action="store_true",
                        help="honor the occupancy-synthesis (PBF) SEI")
    parser.add_argument("--apply-attr-smoothing", action="store_true",
                        help="honor the attribute-smoothing SEI")
    parser.add_argument("--ply-format", choices=["ascii", "binary_little_endian"],
                        default="ascii", help="PLY output format")
    parser.add_argument("-v", "--verbose", action="count", default=0)
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(levelname).1s %(name)s: %(message)s",
    )
    print("PccAppDecoder (tpu_vpcc_torch)")

    if len(args.compressed_stream_paths) > 1:
        print("error: several -i inputs need the multi-stream batcher, not "
              "yet ported (ROADMAP queue 1 item 4)", file=sys.stderr)
        return 2

    from .pipeline import Decoder, Params

    out = args.reconstructed_data_path
    if "%4d" not in out.name:
        out.mkdir(parents=True, exist_ok=True)
    else:
        out.parent.mkdir(parents=True, exist_ok=True)

    try:
        decoder = Decoder(
            Params(
                args.compressed_stream_paths[0],
                use_device=not args.oracle,
                num_threads=args.num_threads,
                apply_geo_smoothing_type=args.apply_geo_smoothing,
                apply_attr_smoothing_type=args.apply_attr_smoothing,
                apply_occupancy_synthesis_type=args.apply_occupancy_synthesis,
                device=args.device,
            )
        )
        decoder.start()
        for i, frame in enumerate(decoder):
            frame_num = i + args.start_frame
            path = frame_output_path(out, frame_num)
            write_ply(frame, path, fmt=args.ply_format)
            logging.info(
                "Frame %d written to %s (%d points)", frame_num, path, len(frame)
            )
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except Exception as e:
        if args.verbose:
            raise
        print(f"error: decode failed: {e}", file=sys.stderr)
        return 1
    totals = decoder.stats.stage_totals()
    if totals:
        logging.info(
            "decoded %d frames, %d points total; %s",
            decoder.stats.total_frames,
            decoder.stats.total_points,
            " ".join(f"{k}={v:.2f}s" for k, v in sorted(totals.items())),
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
