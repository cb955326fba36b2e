"""The plain reference of a training step: the masked weighted MSE summed
over the heads, its gradient by autograd through ``reference/unet.py`` in
fp32, and Adam (betas 0.9 / 0.999, eps 1e-8 outside the square root,
bias-corrected moments, as ``optax.adam`` and the published setups use
it), written out.  Imports nothing of the program."""

from __future__ import annotations

import torch

from .unet import UNetReference, center_crop, no_tf32

BETAS = (0.9, 0.999)
EPS = 1e-8


def _channels_first(t, dims: int):
    """A channels-last batch array -> ``(N, C, D, H, W)``: 3D ``(N, D, H,
    W, C)``; a 2D net's input ``(N, adj, H, W, 1)`` with its sections as
    channels and a unit z; a 2D net's target ``(N, H, W, C)``."""
    if dims == 3:
        return t.permute(0, 4, 1, 2, 3)
    if t.dim() == 5:
        return t[..., 0][:, :, None]
    return t.permute(0, 3, 1, 2)[:, :, None]


def loss(net: UNetReference, batch: dict, dims: int):
    preds = net.forward(_channels_first(batch["input"], dims))
    total = 0.0
    for name, p in preds.items():
        t = center_crop(_channels_first(batch["targets"][name], dims), p.shape[2:])
        w = center_crop(_channels_first(batch["weights"][name], dims), p.shape[2:])
        count = torch.clamp(torch.count_nonzero(w > 0), min=1).to(torch.float32)
        total = total + torch.sum(w * (p - t) ** 2) / count
    return total


def reference_steps(net_config: dict, weights: dict, batches: list, lr: float, quantize=None) -> dict:
    """Adam steps from ``weights`` on ``batches`` (device tensors, the
    program's batch layout): each step's loss, the first step's gradient,
    and the parameters after the last step."""
    no_tf32()
    dims = len(net_config["input_shape"])
    params = {n: w.detach().clone().float().requires_grad_(True) for n, w in weights.items()}
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    net = UNetReference(net_config, params, quantize=quantize)
    out = {"losses": [], "grad": None}
    for step, batch in enumerate(batches, 1):
        for p in params.values():
            p.grad = None
        value = loss(net, {k: _float(b) for k, b in batch.items()}, dims)
        value.backward()
        out["losses"].append(float(value.detach()))
        with torch.no_grad():
            if step == 1:
                out["grad"] = {n: p.grad.clone() for n, p in params.items()}
            for n, p in params.items():
                g = p.grad
                m[n].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v[n].mul_(BETAS[1]).add_(g * g, alpha=1 - BETAS[1])
                m_hat = m[n] / (1 - BETAS[0] ** step)
                v_hat = v[n] / (1 - BETAS[1] ** step)
                p.sub_(lr * m_hat / (torch.sqrt(v_hat) + EPS))
    out["params"] = {n: p.detach() for n, p in params.items()}
    return out


def _float(b):
    if isinstance(b, dict):
        return {k: t.float() for k, t in b.items()}
    return b.float()
