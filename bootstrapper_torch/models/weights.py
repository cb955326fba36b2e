"""Weights: JAX-layout params <-> the port's state dict, checkpoints.

The JAX package keeps params as a nested dict/list pytree (conv weights
DHWIO, biases), saved as ``model_checkpoint_<step>`` npz files with
``params/<path>`` keys.  The port's modules keep the same layouts, so
``params_from_jax`` is a pure renaming: ``unet/l_conv/0/layers/0/w`` ->
``unet.l_conv.0.layers.0.w`` and ``head_<name>/...`` ->
``heads.<name>....``; a transposed-upsample net's ``unet/r_up/0/<level>/w``
is ``unet.r_up.0.<level>.w``.  Folded-weight caches (``_pf*`` entries) and
the empty upsample entries of constant-upsample nets carry no parameters.
A 2D setup's JAX conv weights are HWIO; the port's lifted net
(``unet.lift_2d_config``) keeps them with a unit z axis, inserted on the
way in and squeezed out on the way out (``to_port_layout`` /
``to_jax_layout``), so that either package reads the other's 2D
checkpoints.

The optimizer state carries across too (``opt_leaves_to_jax`` /
``opt_leaves_from_jax``): the JAX trainer's checkpoint holds optax Adam's
state as flat leaves ``opt/0000...`` in ``jax.tree_util.tree_leaves``
order of ``(ScaleByAdamState(count, mu, nu), EmptyState())``: the count,
then every first moment, then every second moment, each in the params
tree's leaf order (dict keys sorted as strings, list items by index).
torch's Adam keeps the same moments per parameter (``exp_avg``,
``exp_avg_sq``) and the count as each parameter's ``step``.
"""

from __future__ import annotations

import math
import os
import re
from typing import Optional

import numpy as np
import torch

from .model import head_dims, unet_config

_CKPT_RE = re.compile(r"model_checkpoint_(\d+)$")


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            if str(k).startswith("_pf"):
                continue
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def to_port_layout(path: str, arr):
    """A JAX leaf in the port's layout: a 2D conv weight (HWIO, 4D) gains
    the lifted net's unit z axis."""
    return arr[None] if path.rsplit("/", 1)[-1] == "w" and arr.ndim == 4 else arr


def to_jax_layout(model, path: str, arr):
    """A leaf of ``model`` in the JAX layout: a 2D setup's conv weights
    (and their Adam moments) lose the unit z axis."""
    return arr[0] if model.dims == 2 and path.rsplit("/", 1)[-1] == "w" else arr


def params_from_jax(params) -> dict:
    """JAX params pytree (numpy leaves) -> the port's ``state_dict``."""
    state = {}
    for path, arr in _flatten(params).items():
        arr = to_port_layout(path, arr)
        if path.startswith("head_"):
            path = "heads/" + path[len("head_") :]
        state[path.replace("/", ".")] = torch.tensor(arr, dtype=torch.float32)
    return state


def _unflatten_params(flat: dict):
    root: dict = {}
    for path, arr in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node)
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root.get("params", root))


def _is_npz(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"PK"


def load_checkpoint(path: str):
    """Params of a ``model_checkpoint_*`` npz file, as a JAX-layout tree
    of numpy arrays (optimiser state is dropped)."""
    if not _is_npz(path):
        raise ValueError(
            f"{path} is not an npz checkpoint; legacy pickle checkpoints "
            "are not read by bootstrapper_torch"
        )
    with np.load(path) as data:
        return _unflatten_params(
            {k: data[k] for k in data.files if k.startswith("params/")}
        )


def save_checkpoint(ckpt_dir: str, params, step: int) -> str:
    """Write JAX-layout ``params`` as ``<ckpt_dir>/model_checkpoint_<step>``
    in the npz layout both packages read (no optimiser state)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"model_checkpoint_{step}")
    arrays = {f"params/{k}": v for k, v in _flatten(params).items()}
    arrays["step"] = np.asarray(int(step))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_it = None, -1
    for name in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(name)
        if m and int(m.group(1)) > best_it:
            best_it = int(m.group(1))
            best = os.path.join(ckpt_dir, name)
    return best


def _conv_init(rng, kernel, in_ch, out_ch):
    """He-uniform initialisation, as the JAX package's ``_conv_init``
    (different random numbers: numpy, not ``jax.random``)."""
    bound = math.sqrt(1.0 / (in_ch * math.prod(kernel)))
    w = rng.uniform(-bound, bound, (*kernel, in_ch, out_ch)) * math.sqrt(3.0)
    b = rng.uniform(-bound, bound, (out_ch,))
    return {"w": w.astype(np.float32), "b": b.astype(np.float32)}


def _conv_pass_init(rng, in_ch, out_ch, kernel_sizes):
    layers = []
    ch = in_ch
    for k in kernel_sizes:
        layers.append(_conv_init(rng, tuple(k), ch, out_ch))
        ch = out_ch
    residual = _conv_init(rng, (1,) * len(kernel_sizes[0]), in_ch, out_ch)
    return {"layers": layers, "residual": residual}


def init_params_numpy(net_config: dict, seed: int = 0) -> dict:
    """Random JAX-layout params for a net config, made with numpy from
    ``seed`` (for machines without JAX)."""
    rng = np.random.default_rng(seed)
    cfg = unet_config(net_config)
    nf, inc, n = cfg.num_fmaps, cfg.fmap_inc_factor, cfg.num_levels
    l_conv = [
        _conv_pass_init(
            rng,
            cfg.in_channels if level == 0 else nf * inc ** (level - 1),
            nf * inc**level,
            cfg.kernel_size_down[level],
        )
        for level in range(n)
    ]
    # per decoder level, its upsample's parameters (a transposed-upsample
    # net) and then its conv pass, in the JAX package's order of draws
    r_up, r_conv = [], []
    for level in range(n - 1):
        ch = nf * inc ** (level + 1)
        r_up.append({} if cfg.constant_upsample else _conv_init(rng, cfg.downsample_factors[level], ch, ch))
        r_conv.append(
            _conv_pass_init(
                rng,
                nf * inc**level + ch,
                cfg.num_fmaps_out
                if cfg.num_fmaps_out is not None and level == 0
                else nf * inc**level,
                cfg.kernel_size_up[level],
            )
        )
    params = {"unet": {"l_conv": l_conv, "r_up": [r_up], "r_conv": [r_conv]}}  # one decoder
    for name, out in net_config["outputs"].items():
        params[f"head_{name}"] = _conv_pass_init(
            rng, cfg.out_channels, head_dims(out), [(1,) * cfg.dims]
        )
    return params


def load_params(model, params):
    """Load a JAX-layout params tree into ``model`` (strict)."""
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


def jax_path(name: str) -> str:
    """A ``state_dict`` key -> its path in the JAX params tree (the inverse
    of ``params_from_jax``'s renaming)."""
    if name.startswith("heads."):
        head, rest = name[len("heads.") :].split(".", 1)
        return f"head_{head}/" + rest.replace(".", "/")
    return name.replace(".", "/")


def _leaf_key(path: str) -> tuple:
    """Sort key of a params path in ``jax.tree_util`` leaf order: dict keys
    as strings, list indices as numbers."""
    return tuple((0, int(p), "") if p.isdigit() else (1, 0, p) for p in path.split("/"))


def params_in_leaf_order(model) -> list:
    """``(JAX path, parameter)`` of ``model`` in the JAX params tree's leaf
    order."""
    named = [(jax_path(n), p) for n, p in model.named_parameters()]
    return sorted(named, key=lambda kv: _leaf_key(kv[0]))


def params_to_jax(model) -> dict:
    """``model``'s parameters as ``{JAX path: numpy array}`` in the JAX
    layout."""
    return {
        path: to_jax_layout(model, path, p.detach().cpu().numpy())
        for path, p in params_in_leaf_order(model)
    }


def opt_leaves_to_jax(model, optimizer) -> list:
    """torch Adam's state as optax Adam's leaves: ``[count (int32), mu...,
    nu...]``; a parameter not yet stepped has zero moments and count 0."""
    mus, nus, counts = [], [], set()
    for path, p in params_in_leaf_order(model):
        st = optimizer.state.get(p)
        if st:
            mu = st["exp_avg"].detach().float().cpu().numpy()
            nu = st["exp_avg_sq"].detach().float().cpu().numpy()
            counts.add(int(st["step"]))
        else:
            mu = nu = np.zeros(tuple(p.shape), np.float32)
            counts.add(0)
        mus.append(to_jax_layout(model, path, mu))
        nus.append(to_jax_layout(model, path, nu))
    if len(counts) != 1:
        raise ValueError(f"parameters were stepped unequally often: {sorted(counts)}")
    return [np.asarray(counts.pop(), np.int32), *mus, *nus]


def opt_leaves_from_jax(model, optimizer, leaves) -> None:
    """Set torch Adam's state from optax Adam's leaves (``opt_leaves_to_jax``
    order); the count becomes every parameter's ``step``."""
    params = params_in_leaf_order(model)
    n = len(params)
    if len(leaves) != 1 + 2 * n:
        raise ValueError(f"{len(leaves)} optimizer leaves for {n} parameters, want {1 + 2 * n}")
    count = int(np.asarray(leaves[0]))
    for i, (path, p) in enumerate(params):
        mu = to_port_layout(path, np.asarray(leaves[1 + i]))
        nu = to_port_layout(path, np.asarray(leaves[1 + n + i]))
        if mu.shape != tuple(p.shape) or nu.shape != tuple(p.shape):
            raise ValueError(f"{path}: moments {mu.shape}/{nu.shape}, parameter {tuple(p.shape)}")
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.tensor(mu, dtype=p.dtype, device=p.device),
            "exp_avg_sq": torch.tensor(nu, dtype=p.dtype, device=p.device),
        }
