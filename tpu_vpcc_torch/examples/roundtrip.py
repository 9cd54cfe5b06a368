"""End-to-end example: synthesize a scene, mux a V3C bitstream, decode it
back with the streaming API on a torch device, and write PLY files.

    python -m tpu_vpcc_torch.examples.roundtrip [out_dir]

Everything runs locally: the scene generator and the lossless HEVC
encoder (libx265 through the native bridge) stand in for a V-PCC encoder;
the decode path is the same one used for real rec0 conformance streams,
on the CUDA card. The scene is that of ``examples/roundtrip.py``, and
the stream and PLY files are byte for byte those it writes. ``main``
takes the device the decode runs on (``"cpu"`` runs the kernels' plain
versions).
"""

import sys
import time
from pathlib import Path

import numpy as np

from ..runtime.pipeline import Decoder, Params
from ..utils.fixtures import build_fixture_stream
from ..utils.ply import write_ply
from ..utils.synthetic import make_synthetic_frame


def scene() -> list:
    """The example's four frames: one generator seeded 2024, a 256x256
    atlas, occupancy resolution 16 and precision 4, 12 patches a frame."""
    rng = np.random.default_rng(2024)
    return [
        make_synthetic_frame(
            rng, width=256, height=256, occupancy_resolution=16,
            occupancy_precision=4, n_patches=12, frame_index=i,
        )
        for i in range(4)
    ]


def main(out_dir="roundtrip_out", device: str = "cuda") -> int:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    print("synthesizing a 4-frame scene (256x256 atlas)...")
    frames = scene()

    print("encoding to a V3C sample stream (lossless HEVC sub-streams)...")
    stream = build_fixture_stream(frames)
    stream_path = out_dir / "stream.bin"
    stream_path.write_bytes(stream)
    print(f"  wrote {stream_path} ({len(stream)} bytes)")

    print(f"decoding with the streaming API on {device}...")
    decoder = Decoder(Params(stream, device=device))  # in-memory bytes work too
    t0 = time.time()
    decoder.start()
    for i, frame in enumerate(decoder):
        ply = out_dir / f"{i:04d}.ply"
        write_ply(frame, ply)
        print(f"  frame {i}: {len(frame)} points -> {ply}")
    print(f"done in {time.time() - t0:.2f}s")
    for gof in decoder.stats.gofs:
        print(" ", gof.summary())
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:2]))
