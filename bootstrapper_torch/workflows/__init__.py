from .predict import run_prediction
from .segment import run_segmentation
from .train import run_training

__all__ = ["run_prediction", "run_segmentation", "run_training"]
