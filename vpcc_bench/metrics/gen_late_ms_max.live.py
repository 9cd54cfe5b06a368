"""The load generator's lateness: the latest that any GOF was handed over
after it was due, in ms (the timer's own slack when the decoder kept
up)."""


def read(record):
    late = record["late_s"]
    return max(late) * 1e3 if late else None
