"""Examples of the port, each run with ``python -m``: ``roundtrip``, the
counterpart of the repository's ``examples/roundtrip.py``."""
