"""Parallel decoding of the port: :mod:`.batcher` (frames of several
streams in shared device dispatches), :mod:`.mesh` and :mod:`.spatial`
(dispatches sharded over a ('data', 'space') mesh of devices)."""
