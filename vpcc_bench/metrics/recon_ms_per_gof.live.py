"""The decoder's ``reconstruct`` span, ms per GOF: the whole GOF's
tables, staging, dispatches, fetches and emission, mean over the run's
GOFs (total over count)."""


def read(record):
    s = record["spans"].get("reconstruct")
    if s is None or not record["gofs"]:
        return None
    return s * 1e3 / record["gofs"]
