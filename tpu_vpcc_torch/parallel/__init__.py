"""Multi-stream decoding of the port: :mod:`.batcher` (frames of several
streams in shared device dispatches)."""
