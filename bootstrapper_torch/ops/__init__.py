"""Hand-written Hopper kernels and their plain PyTorch versions."""

from . import conv3d, quant, seeds
from .conv3d import conv3d_supported
from .seeds import seed_maxima, seed_maxima_3d


def launch_counts() -> dict:
    """Launch counts of every route, keyed ``<module>.<route>``."""
    return {
        **{f"conv3d.{k}": v for k, v in conv3d.COUNTS.items()},
        **{f"qconv3d.{k}": v for k, v in quant.COUNTS.items()},
        **{f"seed_maxima.{k}": v for k, v in seeds.COUNTS.items()},
    }


def conv3d_kernel_launches() -> dict:
    """The conv kernel's CUDA launches since the last reset, by conv:
    ``(x shape, w shape) -> count``."""
    return dict(conv3d.KERNEL_LAUNCHES)


def qconv_kernel_launches() -> dict:
    """The int8 conv kernel's CUDA launches since the last reset, by conv:
    ``(x shape, w shape) -> count``."""
    return dict(quant.KERNEL_LAUNCHES)


def reset_launch_counts() -> None:
    for counts in (conv3d.COUNTS, quant.COUNTS, seeds.COUNTS):
        for k in counts:
            counts[k] = 0
    conv3d.KERNEL_LAUNCHES.clear()
    quant.KERNEL_LAUNCHES.clear()


__all__ = [
    "conv3d_kernel_launches",
    "conv3d_supported",
    "launch_counts",
    "qconv_kernel_launches",
    "reset_launch_counts",
    "seed_maxima",
    "seed_maxima_3d",
]
