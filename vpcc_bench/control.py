"""The control of the comparison that decides ``correct``: the reference
put in the program's place, with its colour conversion computed in
float32, the precision below the float64 that the configurations state.
A run compares each frame it receives with its pool frame's reference
frame; the control's frames are held to the same reference frames, and
the comparison has to call them wrong.

    python3 -m vpcc_bench.control --workload <cell> --seeds <n>,<n>,...

Each seed's pool is made as a run makes it; every pool frame is compared
(a run's frames are the pool's, replayed). One JSON line per seed, then
the least number of wrong frames over the seeds. On the card it needs
no window: the control's frames do not depend on the load.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import gen
from .registry import Bench


def control_readings(bench: Bench, cell_name: str, seed: int,
                     device: str) -> dict:
    """The reference's and the control's digests of one seed's pool,
    compared frame by frame."""
    import torch

    from .run import reference_digests

    cell = bench.cell(cell_name)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    pool = gen.make_pool(seed, config,
                         traffic["pool_gofs"] * config["frames_per_gof"])
    t0 = time.perf_counter()
    want, _ = reference_digests(pool, config, device)
    got, _ = reference_digests(pool, config, device,
                               colour_dtype=torch.float32)
    wrong = sum(g != w for g, w in zip(got, want))
    return {"seed": seed, "frames": len(pool), "frames_wrong": wrong,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m vpcc_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("no card: the control runs on the card", file=sys.stderr)
        return 1
    bench = Bench()
    rows = [control_readings(bench, args.workload, int(s), args.device)
            for s in args.seeds.split(",")]
    for r in rows:
        print(json.dumps(r), flush=True)
    print(json.dumps({"workload": args.workload,
                      "least_frames_wrong": min(r["frames_wrong"]
                                                for r in rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
