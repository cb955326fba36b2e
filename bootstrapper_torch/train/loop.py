"""Training loop: state, step, checkpoints (the JAX package's
``train/loop.py`` on one device).

- Adam as ``optax.adam`` sets it up: betas 0.9/0.999, eps 1e-8 added
  outside the square root, bias-corrected moments (torch's Adam computes
  the same update).  fp32 parameters; the model's convs run in its
  ``compute_dtype``.
- loss: the masked weighted MSE summed over the output heads, on the
  targets centre-cropped to the predictions.
- checkpoints: ``model_checkpoint_{step}`` npz files in the JAX layout,
  ``params/<path>``, ``step`` and optax's state as flat leaves
  ``opt/0000...`` (``models/weights.py``), so that either package resumes
  the other's training.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Callable

import numpy as np
import torch

from ..models.model import Model, multi_output_loss
from ..models.weights import (
    init_params_numpy,
    latest_checkpoint,
    load_params,
    opt_leaves_from_jax,
    opt_leaves_to_jax,
    params_to_jax,
)
from ..models.weights import load_checkpoint as load_params_tree

logger = logging.getLogger(__name__)

__all__ = [
    "TrainState", "create_train_state", "make_train_step", "loss_fn", "save_checkpoint",
    "load_checkpoint", "latest_checkpoint",
]


@dataclasses.dataclass
class TrainState:
    """``step`` (updates so far), the model (its parameters) and the
    optimizer (its state): the JAX ``TrainState(step, params, opt_state)``."""

    step: int
    model: Model
    optimizer: torch.optim.Adam


def make_optimizer(model: Model, learning_rate: float) -> torch.optim.Adam:
    # not fused: fused Adam updates parameters without bumping their
    # version, and Conv.packed keys the kernel's packed weights on it
    return torch.optim.Adam(
        model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, fused=False
    )


def create_train_state(model: Model, seed: int = 0, learning_rate: float = 1e-4) -> TrainState:
    """Random parameters from ``seed`` (numpy; ``jax.random`` gives other
    numbers) and a fresh Adam."""
    load_params(model, init_params_numpy(model.net_config, seed))
    return TrainState(0, model, make_optimizer(model, learning_rate))


def _center_crop_like(x, ref):
    if x.shape == ref.shape:
        return x
    slices = [slice(None)]
    for s, t in zip(x.shape[1:-1], ref.shape[1:-1]):
        o = (s - t) // 2
        slices.append(slice(o, o + t))
    slices.append(slice(None))
    return x[tuple(slices)]


def loss_fn(model: Model, batch: dict):
    """The loss of ``batch`` (``{"input", "targets", "weights"}``)."""
    preds = model(batch["input"])
    targets = {k: _center_crop_like(batch["targets"][k], preds[k]) for k in preds}
    weights = {k: _center_crop_like(batch["weights"][k], preds[k]) for k in preds}
    return multi_output_loss(preds, targets, weights)


def make_train_step() -> Callable:
    """The step: ``(state, batch) -> (state, {"loss": loss})``: forward,
    backward, one Adam update.  The loss stays on the device (reading it
    waits for the card)."""

    def step(state: TrainState, batch: dict):
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.model, batch)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach()}

    return step


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int) -> str:
    """Write ``<ckpt_dir>/model_checkpoint_{step}`` in the JAX layout."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"model_checkpoint_{step}")
    arrays = {f"params/{k}": v for k, v in params_to_jax(state.model).items()}
    for i, leaf in enumerate(opt_leaves_to_jax(state.model, state.optimizer)):
        arrays[f"opt/{i:04d}"] = leaf
    arrays["step"] = np.asarray(int(state.step))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, state: TrainState) -> TrainState:
    """Restore a checkpoint of either package into ``state``: parameters,
    step and, where the file's optimizer leaves fit the model, Adam's state.
    Leaves that do not fit leave a fresh Adam, as the JAX loader does
    (with a warning here)."""
    load_params(state.model, load_params_tree(path))
    with np.load(path) as data:
        saved = sorted(k for k in data.files if k.startswith("opt/"))
        leaves = [data[k] for k in saved]
        step = int(data["step"])
    state.optimizer.state.clear()
    try:
        opt_leaves_from_jax(state.model, state.optimizer, leaves)
    except ValueError as e:
        logger.warning("%s: optimizer state not restored (%s); Adam starts afresh", path, e)
        state.optimizer.state.clear()
    state.step = step
    return state

