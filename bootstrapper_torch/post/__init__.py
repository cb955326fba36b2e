from .filter import compute_ids_to_remove, filter_segmentation_blockwise, outlier_filter, size_filter
from .fragments import cc_from_affinities, mutex_watershed_from_affinities, watershed_from_affinities
from .rag import RagDB
from .segment import (
    METHOD_DEFAULTS,
    cc_segmentation,
    mws_segmentation,
    remove_small_segments,
    segmentation_from_merge_scores,
    waterz_segmentation,
)

__all__ = [
    "METHOD_DEFAULTS",
    "RagDB",
    "cc_from_affinities",
    "cc_segmentation",
    "compute_ids_to_remove",
    "filter_segmentation_blockwise",
    "mutex_watershed_from_affinities",
    "mws_segmentation",
    "outlier_filter",
    "remove_small_segments",
    "segmentation_from_merge_scores",
    "size_filter",
    "watershed_from_affinities",
    "waterz_segmentation",
]
