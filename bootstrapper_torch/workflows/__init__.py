from .evaluate import run_evaluation
from .filter import run_filter
from .predict import run_prediction
from .segment import run_segmentation
from .train import run_training

__all__ = ["run_evaluation", "run_filter", "run_prediction", "run_segmentation", "run_training"]
