"""Evaluation: VOI against ground truth and prediction-error maps.

The skeleton, min-cut and threshold-sweep modules import networkx, so
they are imported from their own modules, never from here."""

from .errors import compute_aff_errors, compute_lsd_errors
from .metrics import compute_metrics
from .voi import rand_voi

__all__ = ["compute_aff_errors", "compute_lsd_errors", "compute_metrics", "rand_voi"]
