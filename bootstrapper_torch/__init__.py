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


__all__ = ["resolve_device"]
