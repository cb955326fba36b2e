"""Setup models: the U-Net plus one 1x1 sigmoid head per output dataset,
instantiated from a net config dict (the contents of a
``net_config.json``), as in the JAX package's ``models/model.py``.

``Model`` is an ``nn.Module``: ``model(x) -> {name: (N, *spatial, C)
fp32}`` for channels-last input ``x``; ``forward_stream`` is one step of
overlap-save z streaming (``models/zstream.py``, 3D setups).
``multi_output_loss`` is the training loss.  Weights come from
JAX-layout params through ``models/weights.py``.

2D setups take ``adj_slices`` neighbouring sections as channels: an
``(N, adj, H, W, C)`` input is folded into ``(N, H, W, adj * C)`` in the
JAX package's order (channel ``d * C + c``), and the net runs lifted to a
unit z axis (``unet.lift_2d_config``), heads included.  Outputs are
``(N, H', W', C)``, or ``(N, 1, H', W', C)`` with ``stack_infer`` (the
predictor's sections stacked in z).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.quant import int8_enabled
from .unet import Conv, ConvPass, UNet, UNetConfig, compute_output_shape
from .zoo import get_net_config


def head_dims(output_cfg: dict) -> int:
    """Channel count of an output head; neighborhood wins over 'dims'."""
    if "neighborhood" in output_cfg:
        return len(output_cfg["neighborhood"])
    return output_cfg["dims"]


def unet_config(net_config: dict) -> UNetConfig:
    nc = net_config
    in_channels = nc.get("in_channels")
    if in_channels is None:
        # 'from' models: inputs are prediction channels, concatenated
        in_channels = sum(i["dims"] for i in nc["inputs"].values())
    elif "adj_slices" in nc:
        in_channels = in_channels * nc["adj_slices"]
    return UNetConfig(
        in_channels=in_channels,
        num_fmaps=nc["num_fmaps"],
        fmap_inc_factor=nc["fmap_inc_factor"],
        downsample_factors=nc["downsample_factors"],
        kernel_size_down=nc["kernel_size_down"],
        kernel_size_up=nc["kernel_size_up"],
        num_fmaps_out=nc.get("num_fmaps_out"),
        constant_upsample=nc.get("constant_upsample", True),
    )


class Model(nn.Module):
    def __init__(self, net_config: dict, compute_dtype=torch.bfloat16, stack_infer: bool = False):
        super().__init__()
        self.net_config = net_config
        self.compute_dtype = compute_dtype
        self.stack_infer = stack_infer
        self._unet_config = unet_config(net_config)
        self.unet = UNet(self._unet_config)
        self.heads = nn.ModuleDict(
            {
                name: ConvPass(self.unet.cfg.out_channels, head_dims(out), [(1, 1, 1)], "sigmoid")
                for name, out in net_config["outputs"].items()
            }
        )

    @classmethod
    def from_setup(cls, name_or_path: str, **kw) -> "Model":
        return cls(get_net_config(name_or_path), **kw)

    def replicate(self, device, compute_dtype=None) -> "Model":
        """A copy of this model on ``device`` with its own parameters, cast
        to ``compute_dtype`` (default: this model's) once, and an empty
        packed-weight cache (``unet.Conv.packed``): one per device of a
        multi-device predictor, so that no replica packs from, or launches
        on, another device's tensors.  Under ``BS_INT8=1`` the replica's
        int8 weights are this model's, quantized from fp32 parameters:
        packed from them here, or, where this model was cast already, its
        own int8 weights moved to ``device``."""
        dtype = compute_dtype or self.compute_dtype
        rep = Model(self.net_config, compute_dtype=dtype, stack_infer=self.stack_infer)
        rep.load_state_dict(self.state_dict())
        if int8_enabled():
            for mine, theirs in zip(self.convs(), rep.convs()):
                theirs.prepare_int8(device, mine)
        return rep._cast(device, dtype)

    def convs(self) -> list:
        """Every conv of the net and its heads."""
        return [m for m in self.modules() if isinstance(m, Conv)]

    def to_compute(self, device, dtype) -> "Model":
        """This model on ``device`` in ``dtype`` (in place, as ``.to``).
        Under ``BS_INT8=1`` every conv's int8 weights are first quantized
        from the fp32 parameters on ``device``, one conv at a time, and kept
        across the cast: the JAX package's ``qconv`` quantizes its fp32
        parameters, and a cast to bf16 first would round the weights and
        nearly every per-channel scale."""
        if int8_enabled():
            for conv in self.convs():
                conv.prepare_int8(device)
        return self._cast(device, dtype)

    def _cast(self, device, dtype) -> "Model":
        self.compute_dtype = dtype
        out = self.to(device=device, dtype=dtype)
        if int8_enabled():
            for conv in self.convs():
                conv.keep_int8()
        return out

    @property
    def unet_config(self) -> UNetConfig:
        """The net's config as the JAX package states it (2D for a 2D
        setup); ``self.unet.cfg`` is the one the convs run."""
        return self._unet_config

    @property
    def dims(self) -> int:
        return len(self.net_config["input_shape"])

    @property
    def input_shape(self) -> tuple:
        return tuple(self.net_config["input_shape"])

    def forward(self, x) -> dict:
        """x: (N, *spatial, C), or (N, adj, H, W, C) for a 2D setup.
        Returns ``{output name: fp32 (N, *spatial', C_head)}`` (a 2D setup
        with ``stack_infer``: (N, 1, H', W', C_head)); convolutions run in
        ``compute_dtype``."""
        if self.dims == 2 and x.dim() == 5:
            n, d, h, w, c = x.shape
            x = torch.movedim(x, 1, 3).reshape(n, h, w, d * c)
        spatial = tuple(x.shape[1:-1])
        try:
            compute_output_shape(self.unet_config, spatial)
        except ValueError as e:
            raise ValueError(
                f"input spatial shape {spatial} is invalid for this setup "
                f"({e}); the standard tile is {self.input_shape}"
            ) from None
        if self.dims == 2:
            x = x[:, None]  # the lifted net's unit z axis
        z = self.unet(x.to(self.compute_dtype))
        outs = {name: head(z).float() for name, head in self.heads.items()}
        if self.dims == 2 and not self.stack_infer:
            outs = {name: y[:, 0] for name, y in outs.items()}
        return outs

    def forward_stream(self, x, state):
        """One overlap-save z-streaming step (the JAX package's
        ``Model.apply_stream``): ``state=None`` is the warm step (``x``
        carries the full z context), later steps take ``s`` new z slices.
        Returns ``({output name: fp32 (N, s, H', W', C_head)}, new state)``."""
        from .zstream import unet_stream_step

        z, new_state = unet_stream_step(self.unet, x.to(self.compute_dtype), state)
        return {name: head(z[0]).float() for name, head in self.heads.items()}, new_state


def weighted_mse_loss(pred, target, weights, count=None):
    """Masked MSE: the weighted sum of squared errors over the count of
    elements with ``weights > 0`` (at least 1), as the JAX package's
    ``models/model.py:weighted_mse_loss``; no host sync.  ``count`` replaces
    that count: a rank of a sharded step passes the whole batch's, so that
    the ranks' losses add up to the one-device loss."""
    scale = weights * (pred - target) ** 2
    if count is None:
        count = torch.count_nonzero(weights > 0)
    return torch.sum(scale) / torch.clamp(count, min=1).to(scale.dtype)


def multi_output_loss(preds: dict, targets: dict, weights: dict, counts: dict = None):
    """Sum of the weighted-MSE losses of all outputs (``counts``: each
    output's normaliser, ``weighted_mse_loss``'s ``count``)."""
    return sum(
        weighted_mse_loss(preds[k], targets[k], weights[k], None if counts is None else counts[k]) for k in preds
    )
