"""bootstrapper_torch: the PyTorch/CUDA port of the JAX package beside it,
for an NVIDIA H100 (Hopper, sm_90a).

The main path is ``run_prediction`` (tiled bf16 U-Net inference over a
Zarr volume) followed by ``run_segmentation`` (watershed fragments and
agglomeration).  Each Pallas TPU kernel of the JAX package has a
hand-written CUDA counterpart under ``csrc/``, built at first use.

Entry points take a ``device`` argument and run on ``cuda`` unless the
caller asks for ``"cpu"``; without a GPU they raise instead of falling
back.  The package imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import torch

__version__ = "0.3.0"  # the distribution's, as in pyproject.toml


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    return dev


def resolve_devices(device=None) -> list:
    """The device list of a multi-device entry point, the counterpart of
    ``jax.devices()``: ``None`` or ``"cuda"`` means every visible card in
    order, ``"cpu"`` one CPU device; a list, or a comma-separated string
    such as ``"cuda:0,cuda:0"`` or ``"cpu,cpu,cpu,cpu"``, is taken as
    given, repeats included (a repeated entry is a second logical device
    on the same card or CPU).  A CUDA entry without a GPU raises."""
    if isinstance(device, str) and "," in device:
        device = [d.strip() for d in device.split(",")]
    if isinstance(device, (list, tuple)):
        if not device:
            raise ValueError("an empty device list")
        return [resolve_device(d) for d in device]
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


__all__ = ["resolve_device", "resolve_devices"]
