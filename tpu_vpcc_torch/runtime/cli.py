"""Command-line decoder on PyTorch.

    python -m tpu_vpcc_torch.runtime.cli -i stream.bin -o out_dir/ [--device cuda|cpu]
    python -m tpu_vpcc_torch.runtime.cli -i a.bin -i b.bin -o out_dir/

The flags are ``tpu_vpcc.runtime.cli``'s, plus ``--device``; ``-d`` and
``--keep-intermediate-files`` are accepted and not read, as there.
Several ``-i`` inputs decode through the multi-stream batcher into one
directory per stream.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

from ..utils.ply import frame_output_path, write_ply


def _main_multistream(args, out: Path) -> int:
    """Decode several streams in shared device batches (BASELINE config 5).

    Frames land in per-stream subdirectories of the output folder, named
    after each input's stem (suffixed with the stream index on collision).
    Framework extension: the reference CLI decodes exactly one stream.
    """
    from ..parallel.batcher import decode_streams_batched
    from .pipeline import Params

    paths = args.compressed_stream_paths
    if "%4d" in out.name:
        print("error: %4d-patterned output paths require a single -i",
              file=sys.stderr)
        return 2
    stems = [p.stem for p in paths]
    names = []
    seen = set()
    for stem in stems:
        # unique per-stream directory even when stems repeat or a literal
        # stem collides with a de-duplicated name
        name, k = (stem if stems.count(stem) == 1 else f"{stem}.0"), 0
        while name in seen:
            k += 1
            name = f"{stem}.{k}"
        seen.add(name)
        names.append(name)
    dirs = []
    for name in names:
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        dirs.append(d)

    params = Params(
        paths[0],  # carried for option plumbing; the batcher opens each path
        use_device=not args.oracle,
        num_threads=args.num_threads,
        apply_geo_smoothing_type=args.apply_geo_smoothing,
        apply_attr_smoothing_type=args.apply_attr_smoothing,
        apply_occupancy_synthesis_type=args.apply_occupancy_synthesis,
        device=args.device,
    )
    n_frames = 0
    n_points = 0
    try:
        for stream_idx, frame_idx, frame in decode_streams_batched(
            paths, params=params
        ):
            frame_num = frame_idx + args.start_frame
            path = frame_output_path(dirs[stream_idx], frame_num)
            write_ply(frame, path, fmt=args.ply_format)
            n_frames += 1
            n_points += len(frame)
            logging.info(
                "Stream %d frame %d written to %s (%d points)",
                stream_idx, frame_num, path, len(frame),
            )
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except Exception as e:
        if args.verbose:
            raise
        print(f"error: decode failed: {e}", file=sys.stderr)
        return 1
    logging.info(
        "decoded %d frames, %d points total across %d streams",
        n_frames, n_points, len(paths),
    )
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="An MPEG-VPCC-TMC2 conformant decoder (PyTorch)"
    )
    parser.add_argument(
        "-i", "--compressed-stream-path", required=True, type=Path,
        action="append", dest="compressed_stream_paths",
        help="Path to the compressed bitstream input; repeat to decode "
             "several streams in shared device batches",
    )
    parser.add_argument(
        "-o", "--reconstructed-data-path", required=True, type=Path,
        help="Output folder (or %%4d-patterned path) for decoded point clouds",
    )
    parser.add_argument("--start-frame", type=int, default=0,
                        help="First frame number in the output naming")
    parser.add_argument("--num-threads", type=int, default=4,
                        help="Host video-decode worker threads")
    parser.add_argument("--keep-intermediate-files", action="store_true")
    parser.add_argument("-d", "--video-decoder-path", type=Path, default=None,
                        help="Unused: decoding is in-process (native libavcodec)")
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

    out = args.reconstructed_data_path
    if "%4d" not in out.name:
        out.mkdir(parents=True, exist_ok=True)
    else:
        out.parent.mkdir(parents=True, exist_ok=True)

    if len(args.compressed_stream_paths) > 1:
        return _main_multistream(args, out)

    from .pipeline import Decoder, Params

    try:
        decoder = Decoder(
            Params(
                args.compressed_stream_paths[0],
                keep_intermediate_files=args.keep_intermediate_files,
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
