"""The frame hand-off: the program's ``emit_handoff`` span, from a frame
put on the decoder's queue to its return from ``recv_frame``, ms per
frame."""

from vpcc_bench.readers import span_ms_per_frame


def read(record):
    return span_ms_per_frame(record, "emit_handoff")
