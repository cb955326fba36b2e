from .scan import Predictor, prepare_prediction_outputs, tile_rois

__all__ = ["Predictor", "prepare_prediction_outputs", "tile_rois"]
