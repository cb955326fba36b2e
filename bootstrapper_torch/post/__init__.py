from .fragments import watershed_from_affinities
from .segment import segmentation_from_merge_scores, waterz_segmentation

__all__ = [
    "segmentation_from_merge_scores",
    "watershed_from_affinities",
    "waterz_segmentation",
]
