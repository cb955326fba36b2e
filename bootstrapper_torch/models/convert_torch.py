"""Import reference PyTorch checkpoints as JAX-layout params (the JAX
package's ``models/convert_torch.py`` on the port's ``Model``).

Migration path for users of the reference framework: its checkpoints
are torch ``state_dict``s (raw, or Lightning ``.ckpt`` with a
``model.`` prefix — reference ``bootstrapper/models/3d_affs/predict.py:98-107``)
over the module tree

    unet.l_conv.{level}.conv_pass.{j}.weight   (convs at Sequential
    unet.l_conv.{level}.residual.0.weight       indices 0, 2, ...)
    unet.r_conv.{head}.{level}.conv_pass.{j}.weight
    unet.r_up.{head}.{level}.up.weight          (transposed upsampling)
    {lsd,aff,affs,lsds}_head.conv_pass.0.weight / .residual.0.weight

Torch conv weights are (O, I, *K); the JAX layout is channels-last
(*K, I, O).  The result is the JAX package's params tree, written as a
``model_checkpoint_*`` npz that both packages load (the port through
``models.weights.params_from_jax``).  The port's ``Model`` has one decoder.
A ``constant_upsample = false`` setup's transposed-conv weights are torch
``ConvTranspose`` (I, O, *K): they go to (*K, I, O) with every kernel axis
reversed (``_to_jax_conv_transpose``); a resize-upsample setup has no
``r_up`` parameters.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .model import Model
from .weights import _flatten


def _to_jax_conv(w: np.ndarray) -> np.ndarray:
    # (O, I, *K) -> (*K, I, O)
    dims = w.ndim - 2
    return np.transpose(w, tuple(range(2, 2 + dims)) + (1, 0))


def _to_jax_conv_transpose(w: np.ndarray) -> np.ndarray:
    # torch ConvTranspose (I, O, *K) -> (*K, I, O) with every kernel axis
    # reversed: ``lax.conv_transpose(transpose_kernel=False)``, which the
    # JAX layout feeds, reads output offset j from w[k-1-j]; torch from w[j]
    dims = w.ndim - 2
    w = np.transpose(w, tuple(range(2, 2 + dims)) + (0, 1))
    return w[tuple(slice(None, None, -1) for _ in range(dims))]


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:  # Lightning
        ckpt = ckpt["state_dict"]
    if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
        ckpt = ckpt["model_state_dict"]
    out = {}
    for k, v in ckpt.items():
        if k.startswith("model."):
            k = k[len("model."):]
        out[k] = v.detach().numpy() if hasattr(v, "detach") else np.asarray(v)
    return out


_HEAD_ALIASES = {
    "3d_affs": ["affs_head", "aff_head"],
    "2d_affs": ["aff_head", "affs_head"],
    "3d_lsds": ["lsd_head", "lsds_head"],
    "2d_lsds": ["lsd_head", "lsds_head"],
}


def torch_to_params(state: Dict[str, np.ndarray], model: Model) -> dict:
    """Map a reference state_dict onto ``model``'s parameter pytree."""
    cfg = model.unet_config
    missing = []

    def conv(prefix: str, seq_idx=None, layout=_to_jax_conv):
        key = prefix if seq_idx is None else f"{prefix}.{seq_idx}"
        wk, bk = f"{key}.weight", f"{key}.bias"
        if wk not in state:
            missing.append(wk)
            return None
        w = layout(state[wk]).astype(np.float32)
        if bk in state:
            b = state[bk].astype(np.float32)
        else:
            # bias=False conv: a zero bias is exactly equivalent
            b = np.zeros(w.shape[-1], np.float32)
        return {"w": w, "b": b}

    def conv_pass(prefix: str, n_convs: int):
        layers = []
        for j in range(n_convs):
            layers.append(conv(f"{prefix}.conv_pass", 2 * j))
        residual = conv(f"{prefix}.residual", 0)
        return {"layers": layers, "residual": residual}

    params = {"unet": {"l_conv": [], "r_up": [], "r_conv": []}}
    for level in range(cfg.num_levels):
        params["unet"]["l_conv"].append(
            conv_pass(
                f"unet.l_conv.{level}", len(cfg.kernel_size_down[level])
            )
        )
    for h in range(1):  # the port's U-Net has one decoder
        ups, convs = [], []
        for level in range(cfg.num_levels - 1):
            if cfg.constant_upsample:
                ups.append({})
            else:
                ups.append(conv(f"unet.r_up.{h}.{level}.up", layout=_to_jax_conv_transpose))
            convs.append(
                conv_pass(
                    f"unet.r_conv.{h}.{level}",
                    len(cfg.kernel_size_up[level]),
                )
            )
        params["unet"]["r_up"].append(ups)
        params["unet"]["r_conv"].append(convs)

    for name in model.net_config["outputs"]:
        aliases = _HEAD_ALIASES.get(name, [f"{name}_head"])
        found = None
        for alias in aliases + [f"{name}_head"]:
            if f"{alias}.conv_pass.0.weight" in state:
                found = alias
                break
        if found is None:
            missing.append(f"<head for {name}>")
            continue
        params[f"head_{name}"] = conv_pass(found, 1)

    if missing:
        raise KeyError(
            f"state_dict is missing expected parameters: {missing[:8]}"
            f" (of {len(missing)}); is this a checkpoint for this setup?"
        )
    return params


def convert_checkpoint(torch_path: str, setup_dir: str, out_path: str) -> str:
    """CLI-facing: torch checkpoint -> a ``model_checkpoint`` npz at
    ``out_path`` (params only, step 0)."""
    model = Model.from_setup(setup_dir)
    params = torch_to_params(load_torch_state_dict(torch_path), model)
    arrays = {f"params/{k}": v for k, v in _flatten(params).items()}
    arrays["step"] = np.asarray(0)
    with open(out_path, "wb") as f:
        np.savez(f, **arrays)
    return out_path
