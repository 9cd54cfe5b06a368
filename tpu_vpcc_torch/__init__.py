"""tpu_vpcc_torch — the tpu_vpcc V-PCC (MPEG V3C) decoder on PyTorch.

The port of ``tpu_vpcc`` to PyTorch and CUDA: its own copies of the
host layers (V3C parse, HEVC decode, group tables, the numpy oracle),
with the reconstruction on a torch device and the TPU's Pallas kernels
rewritten by hand for NVIDIA Hopper (``csrc/``). It imports neither jax
nor ``tpu_vpcc``.

    from tpu_vpcc_torch import Decoder, Params
    decoder = Decoder(Params("stream.bin", device="cuda"))
    decoder.start()
    for frame in decoder:          # PointSet3 per frame, in order
        ...
"""

__version__ = "0.1.0"

_LAZY = {
    "Decoder": ("tpu_vpcc_torch.runtime.pipeline", "Decoder"),
    "Params": ("tpu_vpcc_torch.runtime.pipeline", "Params"),
    "PointSet3": ("tpu_vpcc_torch.reconstruction.pointset", "PointSet3"),
}


def __getattr__(name):
    # lazy, so that importing the package pulls in neither torch nor
    # the decoder
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'tpu_vpcc_torch' has no attribute {name!r}")
