from .filter import compute_ids_to_remove, filter_segmentation_blockwise, outlier_filter, size_filter
from .fragments import watershed_from_affinities
from .rag import RagDB
from .segment import segmentation_from_merge_scores, waterz_segmentation

__all__ = [
    "RagDB",
    "compute_ids_to_remove",
    "filter_segmentation_blockwise",
    "outlier_filter",
    "segmentation_from_merge_scores",
    "size_filter",
    "watershed_from_affinities",
    "waterz_segmentation",
]
