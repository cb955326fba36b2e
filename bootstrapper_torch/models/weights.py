"""Weights: JAX-layout params <-> the port's state dict, checkpoints.

The JAX package keeps params as a nested dict/list pytree (conv weights
DHWIO, biases), saved as ``model_checkpoint_<step>`` npz files with
``params/<path>`` keys.  The port's modules keep the same layouts, so
``params_from_jax`` is a pure renaming: ``unet/l_conv/0/layers/0/w`` ->
``unet.l_conv.0.layers.0.w`` and ``head_<name>/...`` ->
``heads.<name>....``.  Folded-weight caches (``_pf*`` entries) and the
empty upsample entries of constant-upsample nets carry no parameters.
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


def params_from_jax(params) -> dict:
    """JAX params pytree (numpy leaves) -> the port's ``state_dict``."""
    state = {}
    for path, arr in _flatten(params).items():
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
    r_conv = [
        _conv_pass_init(
            rng,
            nf * inc**level + nf * inc ** (level + 1),
            cfg.num_fmaps_out
            if cfg.num_fmaps_out is not None and level == 0
            else nf * inc**level,
            cfg.kernel_size_up[level],
        )
        for level in range(n - 1)
    ]
    params = {
        "unet": {
            "l_conv": l_conv,
            "r_up": [[{} for _ in range(n - 1)]],  # one decoder
            "r_conv": [r_conv],
        }
    }
    for name, out in net_config["outputs"].items():
        params[f"head_{name}"] = _conv_pass_init(
            rng, cfg.out_channels, head_dims(out), [(1,) * cfg.dims]
        )
    return params


def load_params(model, params):
    """Load a JAX-layout params tree into ``model`` (strict)."""
    model.load_state_dict(params_from_jax(params), strict=True)
    return model
