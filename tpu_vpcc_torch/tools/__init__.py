"""Tool entry points of the port: the cursor compaction experiment
(``compaction_experiment``), the Hopper probes (``hopper_probe``,
``hopper_probe2``, ``hopper_probe3``) and the colour proof
(``verify_color_exact``), each the counterpart of a script in the
repository's ``tools/``. Run each with ``python -m``."""


def resolve_device(name: str):
    """The ``--device`` of a tool. A card is required unless ``cpu`` is
    named: a tool never carries on quietly on the CPU."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card (torch.cuda.is_available() is false); pass "
            "--device cpu to run the plain versions on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device {name!r}: want cuda or cpu")
    return device
