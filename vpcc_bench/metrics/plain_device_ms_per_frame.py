"""Plain PyTorch on the device (the narrow gather and words; the wide
path's smoothing): the device time of every kernel other than K1, K1F,
K2W and K5, ms per frame."""

from vpcc_bench.roofline import KERNEL_NAMES
from vpcc_bench.trace import short_name


def read(record):
    ours = set(KERNEL_NAMES.values())
    recs = [r for r in record["trace"].device
            if r.cat == "kernel" and short_name(r.name) not in ours]
    if not recs or not record["frames"]:
        return None
    return sum(r.dur_us for r in recs) / 1e3 / record["frames"]
