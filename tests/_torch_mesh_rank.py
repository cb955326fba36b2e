"""A rank of the spawned mesh runs in ``tests/test_torch_mesh_train.py``:
one sharded step from given parameters on a given batch.  It imports only
torch and the port, so that a spawned rank imports neither JAX nor a test
module."""

import numpy as np
import torch

from bootstrapper_torch.models import Model, load_params
from bootstrapper_torch.models.weights import params_in_leaf_order, params_to_jax, to_jax_layout
from bootstrapper_torch.train.loop import (
    TrainState,
    broadcast_batch,
    broadcast_state,
    make_optimizer,
    shard_train_step,
)


def one_sharded_step(mesh, net_config: dict, params: dict, batch: dict, lr: float) -> dict:
    """Rank 0 starts from ``params`` (the others from zeros, so that the
    broadcast is what makes them equal), each data group's leader holds its
    rows of ``batch`` (numpy, the whole batch), one sharded step; returns
    the loss and, in the JAX layout, the parameters, the gradient that the
    step took (each parameter's ``grad``: the sum over the ranks) and
    Adam's first moment (0.1 of that gradient after one step)."""
    model = Model(net_config, compute_dtype=torch.float32)
    if mesh.rank == 0:
        load_params(model, params)
    state = broadcast_state(TrainState(0, model, make_optimizer(model, lr)), mesh)
    d, _ = mesh.coords
    rows = len(batch["input"]) // mesh.data
    group = None
    if mesh.rank == mesh.leader:
        take = lambda a: torch.from_numpy(np.ascontiguousarray(a[d * rows : (d + 1) * rows]))  # noqa: E731
        group = {"input": take(batch["input"]),
                 "targets": {k: take(v) for k, v in batch["targets"].items()},
                 "weights": {k: take(v) for k, v in batch["weights"].items()}}
    group = broadcast_batch(group, mesh)
    state, metrics = shard_train_step(mesh, model.unet_config, model.dims)(state, group)
    moments = state.optimizer.state
    return {
        "loss": float(metrics["loss"]), "step": state.step, "params": params_to_jax(model),
        "grads": _leaves(model, lambda p: p.grad), "exp_avg": _leaves(model, lambda p: moments[p]["exp_avg"]),
    }


def _leaves(model, tensor_of) -> dict:
    """``{JAX path: tensor_of(parameter)}`` in the JAX layout (numpy)."""
    return {path: to_jax_layout(model, path, tensor_of(p).detach().cpu().numpy())
            for path, p in params_in_leaf_order(model)}
