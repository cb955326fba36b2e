from .model import Model, head_dims
from .unet import UNetConfig, compute_output_shape, min_input_shape
from .weights import (
    init_params_numpy,
    latest_checkpoint,
    load_checkpoint,
    load_params,
    params_from_jax,
    save_checkpoint,
)

__all__ = [
    "Model",
    "UNetConfig",
    "compute_output_shape",
    "head_dims",
    "init_params_numpy",
    "latest_checkpoint",
    "load_checkpoint",
    "load_params",
    "min_input_shape",
    "params_from_jax",
    "save_checkpoint",
]
