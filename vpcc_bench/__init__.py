"""The benchmark of ``tpu_vpcc_torch``, the PyTorch and CUDA decoder of
V-PCC point-cloud streams: ``python3 -m vpcc_bench --help``."""

import time

#: the process's start, as near as the harness can take it: ``setup_s``
#: runs from here to the first timed hand-over
PROCESS_T0 = time.perf_counter()
