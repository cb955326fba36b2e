"""Hand-written Hopper kernels and their plain PyTorch versions."""

from . import conv3d, seeds
from .conv3d import conv3d_supported
from .seeds import seed_maxima, seed_maxima_3d


def launch_counts() -> dict:
    """Launch counts of every route, keyed ``<module>.<route>``."""
    return {
        **{f"conv3d.{k}": v for k, v in conv3d.COUNTS.items()},
        **{f"seed_maxima.{k}": v for k, v in seeds.COUNTS.items()},
    }


def reset_launch_counts() -> None:
    for counts in (conv3d.COUNTS, seeds.COUNTS):
        for k in counts:
            counts[k] = 0


__all__ = [
    "conv3d_supported",
    "launch_counts",
    "reset_launch_counts",
    "seed_maxima",
    "seed_maxima_3d",
]
