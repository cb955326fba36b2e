from .predict import run_prediction
from .segment import run_segmentation

__all__ = ["run_prediction", "run_segmentation"]
