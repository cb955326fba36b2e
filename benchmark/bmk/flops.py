"""Operations and bytes of the U-Net's convolutions, and the H100's peaks.

A frozen copy of ``chip_smoke.py``'s ``tile_flops``, ``conv_work`` and
``bound``, computed from a net config (a ``net_config.json`` dict) alone:
it reads nothing of the program, so that a change to the program cannot
change the yardstick.  2 operations per multiply-add; a conv pass's 1x1
residual reads the centre crop of its input; a decoder conv over
``[skip, upsampled]`` counts both parts; each head is a conv pass of one
1x1 conv and its residual.
"""

from __future__ import annotations

import numpy as np

#: NVIDIA H100 SXM (data sheet, dense): bf16 tensor cores, HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
#: the smallest contraction the program's conv kernel takes (a frozen copy
#: of ``ops/conv3d.py:conv3d_supported``'s ``ci >= 128``): a conv below it
#: runs in the library, and the split is reported, never used in a share
KERNEL_MIN_CI = 128


def _lift(k, dims):
    return tuple(k) if dims == 3 else (1, *k)


def net_shape(net_config: dict) -> dict:
    """The U-Net's sizes from a net config, lifted to 3D for a 2D net (a
    unit z axis, ``adj_slices`` sections as input channels)."""
    nc = net_config
    dims = len(nc["input_shape"])
    in_ch = nc.get("in_channels")
    if in_ch is None:
        in_ch = sum(i["dims"] for i in nc["inputs"].values())
    elif "adj_slices" in nc:
        in_ch *= nc["adj_slices"]
    return {
        "dims": dims,
        "in_channels": in_ch,
        "num_fmaps": nc["num_fmaps"],
        "fmap_inc_factor": nc["fmap_inc_factor"],
        "num_fmaps_out": nc.get("num_fmaps_out") or nc["num_fmaps"],
        "factors": [_lift(f, dims) for f in nc["downsample_factors"]],
        "k_down": [[_lift(k, dims) for k in lvl] for lvl in nc["kernel_size_down"]],
        "k_up": [[_lift(k, dims) for k in lvl] for lvl in nc["kernel_size_up"]],
        "heads": [len(o["neighborhood"]) if "neighborhood" in o else o["dims"] for o in nc["outputs"].values()],
    }


def tile_flops(net_config: dict, input_shape) -> dict:
    """Operations of one forward (a 2D net's: of one section) at the
    spatial ``input_shape``, by route (``kernel`` where the contraction is
    at least KERNEL_MIN_CI channels, else ``library``), the part whose convs
    read the net's input (``on_input``), and the output voxels."""
    s = net_shape(net_config)
    if s["dims"] == 2:
        input_shape = (1, *input_shape)
    n_levels = len(s["factors"]) + 1
    nf, inc = s["num_fmaps"], s["fmap_inc_factor"]
    flops = {"kernel": 0.0, "library": 0.0, "on_input": 0.0}
    crop_factors = []
    prod = None
    for f in s["factors"][::-1]:
        prod = list(f) if prod is None else [a * b for a, b in zip(f, prod)]
        crop_factors.append(prod)
    crop_factors = crop_factors[::-1]

    def conv(shape, parts, co, k, on_input=False):
        out = [a - kk + 1 for a, kk in zip(shape, k)]
        if any(o < 1 for o in out):
            raise ValueError(f"input {tuple(input_shape)} too small")
        for ci in parts:
            f = 2.0 * np.prod(out) * ci * co * np.prod(k)
            flops["kernel" if ci >= KERNEL_MIN_CI else "library"] += f
            if on_input:
                flops["on_input"] += f
        return out

    def conv_pass(shape, parts, co, kernels, on_input=False):
        for i, k in enumerate(kernels):
            shape = conv(shape, parts if i == 0 else [co], co, k, on_input and i == 0)
        conv(shape, parts, co, (1, 1, 1), on_input)  # the residual, on the crop
        return shape

    def rec(level, shape):
        i = n_levels - level - 1
        ci = s["in_channels"] if i == 0 else nf * inc ** (i - 1)
        shape = conv_pass(shape, [ci], nf * inc**i, s["k_down"][i], on_input=i == 0)
        if level == 0:
            return shape
        f = s["factors"][i]
        if any(a % b for a, b in zip(shape, f)):
            raise ValueError(f"input {tuple(input_shape)} off the pooling grid")
        inner = rec(level - 1, [a // b for a, b in zip(shape, f)])
        up = [a * b for a, b in zip(inner, f)]
        cc = [sum(k[d] - 1 for k in s["k_up"][i]) for d in range(3)]
        up = [((a - c) // cf) * cf + c for a, c, cf in zip(up, cc, crop_factors[i])]
        co = s["num_fmaps_out"] if i == 0 else nf * inc**i
        return conv_pass(up, [nf * inc**i, nf * inc ** (i + 1)], co, s["k_up"][i])

    out = rec(n_levels - 1, list(input_shape))
    for dims in s["heads"]:
        conv_pass(out, [s["num_fmaps_out"]], dims, [(1, 1, 1)])
    return {**flops, "output_voxels": int(np.prod(out)), "output_shape": [int(o) for o in out]}


def total(flops: dict) -> float:
    return flops["kernel"] + flops["library"]


def per_output_voxel(flops: dict) -> float:
    return total(flops) / flops["output_voxels"]


def context(net_config: dict) -> list:
    """Input minus output extent of the net, per spatial axis."""
    return [a - b for a, b in zip(net_config["input_shape"], net_config["output_shape"])]


def valid_output_extent(net_config: dict, axis: int, at_most: int) -> int:
    """The largest output extent along ``axis`` of the net's spatial axes
    that is at most ``at_most`` and lies on the net's output grid (base
    output plus a multiple of the pooling product)."""
    step = 1
    for f in net_config["downsample_factors"]:
        step *= f[axis]
    base = net_config["output_shape"][axis]
    if at_most < base:
        raise ValueError(f"an extent of {at_most} is under the net's output of {base}")
    return base + (at_most - base) // step * step


def least_volume_flops(net_config: dict, out_vox) -> float:
    """The least work of one pass over a volume whose output is ``out_vox``
    voxels (z, y, x): the operations per output voxel of one valid forward
    of the net whose output is the largest valid extent inside the volume,
    times the volume's output voxels.  A 2D net's forward is one section
    at a time, as its input is ``adj_slices`` sections whatever the tile."""
    dims = len(net_config["input_shape"])
    spatial = list(out_vox)[-dims:]
    out = [valid_output_extent(net_config, a, v) for a, v in enumerate(spatial)]
    if dims == 3 and net_config["downsample_factors"][0][0] == 1:
        out[0] = spatial[0]  # z is never pooled: any z extent is valid
    fl = tile_flops(net_config, [o + c for o, c in zip(out, context(net_config))])
    return per_output_voxel(fl) * float(np.prod(out_vox))


def train_step_flops(net_config: dict, batch: int) -> float:
    """The conv products of one training step at the net's input shape:
    the forward, and the backward as dW of every conv and dX of every conv
    but those that read the net's input."""
    fl = tile_flops(net_config, net_config["input_shape"])
    forward = total(fl) * batch
    return forward + forward + (forward - fl["on_input"] * batch)


def conv_key_work(x_shape, w_shape, item: int = 2) -> tuple:
    """``(operations, bytes)`` of one conv launch keyed as the program's
    launch counter keys it: the input view's shape ``(n, d, h, w, ci)`` and
    the DHWIO weight's shape.  Each operand read once, the output written
    once, in ``item`` bytes a value (bf16); the bias, a few kB, is left
    out."""
    n, d, h, w, ci = x_shape
    kd, kh, kw, _, co = w_shape
    out = n * (d - kd + 1) * (h - kh + 1) * (w - kw + 1)
    flops = 2.0 * out * co * kd * kh * kw * ci
    nbytes = item * (n * d * h * w * ci + kd * kh * kw * ci * co + out * co)
    return flops, float(nbytes)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations at the bf16 peak or
    bytes at the memory rate, whichever is longer."""
    return max(flops / PEAK_BF16, nbytes / PEAK_BYTES)


def sam_section_flops(cfg: dict, clicks: int) -> float:
    """The least work of one section of a SAM proofreading session: the
    image encoder once, the mask decoder ``clicks`` times, 2 operations a
    multiply-add, as the architecture defines them (``cfg`` holds its
    widths).  The encoder: the patch embedding; in a windowed block the
    attention's projections and products on the window grid padded to a
    multiple of the window (70 x 70 for 64 x 64 tokens in windows of 14),
    the MLP on the tokens; in a global block all of it on the tokens; the
    decomposed relative positions (one product per query, key row or
    column and channel); the neck's two convs.  The decoder, for one point
    and the padding point: the two-way blocks, the final attention, the
    two transposed convs, the hypernetworks, the masks' product and the
    IOU head.  Resizes, norms, softmax and elementwise work are left out;
    they are no multiply-adds of the model."""
    c, heads, p = cfg["encoder_dim"], cfg["encoder_heads"], cfg["patch_size"]
    grid = cfg["img_size"] // p
    tokens = grid * grid
    win = cfg["window_size"]
    padded = -(-grid // win) * win
    enc = 2.0 * tokens * c * 3 * p * p  # the patch embedding
    for i in range(cfg["encoder_depth"]):
        if i in cfg["global_attn_indexes"]:
            side, n_win = grid, 1
        else:
            side, n_win = win, (padded // win) ** 2
        t = side * side
        enc += 2.0 * n_win * t * c * 4 * c  # qkv and proj
        enc += 2.0 * n_win * 2 * t * t * c  # q k^T and attn v, over the heads
        enc += 2.0 * n_win * t * 2 * side * c  # the relative positions along h and w
        enc += 2.0 * tokens * c * 8 * c  # the MLP
    d = cfg["prompt_dim"]
    enc += 2.0 * tokens * c * d + 2.0 * tokens * d * d * 9  # the neck

    n_tok = 1 + cfg["num_mask_tokens"] + 2  # the output tokens, the point, the padding point

    def cross(nq, nk, inner):
        # projections of queries, keys, values and out; the two products
        return 2.0 * (nq * d * inner + 2 * nk * d * inner + nq * inner * d + 2 * nq * nk * inner)

    dec = 0.0
    for i in range(cfg["decoder_depth"]):
        dec += cross(n_tok, n_tok, d)  # self-attention
        dec += cross(n_tok, tokens, d // 2)  # tokens to image
        dec += 2.0 * n_tok * d * cfg["decoder_mlp_dim"] * 2
        dec += cross(tokens, n_tok, d // 2)  # image to tokens
    dec += cross(n_tok, tokens, d // 2)  # the final attention
    up1, up2 = 4 * tokens, 16 * tokens
    dec += 2.0 * up1 * d * (d // 4) + 2.0 * up2 * (d // 4) * (d // 8)
    t = cfg["num_mask_tokens"]
    dec += t * 2.0 * (d * d * 2 + d * d // 8) + 2.0 * t * (d // 8) * up2
    h = cfg["iou_head_hidden_dim"]
    dec += 2.0 * (d * h + h * h + h * t)
    return enc + clicks * dec
