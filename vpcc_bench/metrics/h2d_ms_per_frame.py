"""Host-to-device copies: the device time of the trace's HtoD memcpy
records, ms per frame."""


def read(record):
    recs = [r for r in record["trace"].device
            if r.cat == "gpu_memcpy" and "HtoD" in r.name]
    if not recs or not record["frames"]:
        return None
    return sum(r.dur_us for r in recs) / 1e3 / record["frames"]
