"""Random weights of a U-Net setup, made on the device from the seed.

The parameter list (names, shapes, fan-ins) is derived here from the net
config, in the layout the program's ``Model`` keeps (DHWIO conv weights, a
bias per conv; a 2D net lifted to a unit z axis), and the harness checks
it against the program's own list before loading.  The reference reads
the same dictionary by the same names.

Every weight is drawn from one normal tensor made by one
``torch.Generator`` on the device, scaled by ``sqrt(GAIN / fan_in)``, and
rounded to bf16, the type the predictors serve the net in; a bias is a
normal draw times BIAS_SCALE.  GAIN keeps the activations' second moment
about level through a residual conv pass (``relu(conv(relu(conv x)) +
res(x))`` multiplies it by ``GAIN (1 + GAIN / 2) / 2``, which is 1 at
``GAIN = sqrt(5) - 1``), so that the heads' sigmoids are neither flat at
0.5 nor saturated.
"""

from __future__ import annotations

import math

import torch

from .flops import net_shape

GAIN = math.sqrt(5.0) - 1.0
BIAS_SCALE = 0.05


def param_specs(net_config: dict) -> list:
    """``[(name, shape)]`` of the model's parameters, in its order."""
    s = net_shape(net_config)
    nf, inc = s["num_fmaps"], s["fmap_inc_factor"]
    n_levels = len(s["factors"]) + 1
    specs = []

    def conv_pass(prefix, ci, co, kernels):
        ch = ci
        for i, k in enumerate(kernels):
            specs.append((f"{prefix}.layers.{i}.w", (*k, ch, co)))
            specs.append((f"{prefix}.layers.{i}.b", (co,)))
            ch = co
        specs.append((f"{prefix}.residual.w", (1, 1, 1, ci, co)))
        specs.append((f"{prefix}.residual.b", (co,)))

    for level in range(n_levels):
        ci = s["in_channels"] if level == 0 else nf * inc ** (level - 1)
        conv_pass(f"unet.l_conv.{level}", ci, nf * inc**level, s["k_down"][level])
    for level in range(n_levels - 1):
        co = s["num_fmaps_out"] if level == 0 else nf * inc**level
        conv_pass(f"unet.r_conv.0.{level}", nf * inc**level + nf * inc ** (level + 1), co, s["k_up"][level])
    for name, dims in zip(net_config["outputs"], s["heads"]):
        conv_pass(f"heads.{name}", s["num_fmaps_out"], dims, [(1, 1, 1)])
    return specs


def make_weights(net_config: dict, seed: int, device) -> dict:
    """``{name: fp32 tensor holding bf16 values}`` on ``device``."""
    specs = param_specs(net_config)
    sizes = [math.prod(shape) for _, shape in specs]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out = {}
    off = 0
    for (name, shape), n in zip(specs, sizes):
        v = flat[off : off + n].view(shape)
        off += n
        if name.endswith(".w"):
            fan_in = math.prod(shape[:-1])
            v = v * math.sqrt(GAIN / fan_in)
        else:
            v = v * BIAS_SCALE
        out[name] = v.to(torch.bfloat16).to(torch.float32)
    return out
