"""Random weights of a SAM configuration under the official state-dict keys
(``segment_anything``'s ``sam_vit_*.pth``), made on the device from the
seed.

The key list is derived here from the configuration's widths; the program
loads the dictionary from a file by ``models/sam.py:load_sam``, which
refuses a key that is not its schema's or a missing one, and the
reference reads the same dictionary by the same keys.  The mask-prompt
tower (``prompt_encoder.mask_downscaling``), which no point prompt runs, is
left out, as the program's loader allows.

Every value is drawn from one normal tensor made by one
``torch.Generator`` on the device and rounded to bf16 (the file set-up
writes is then half the size; the program loads it into its fp32
parameters): linear and conv weights scaled by ``1 / sqrt(fan_in)``, biases
by BIAS_SCALE, relative-position tables and the absolute position
embedding by TABLE_SCALE, embeddings and the prompt encoder's Gaussian
matrix at unit scale (their official inits), LayerNorms at weight 1 and
bias 0.  The mask head is set as the proofreading smoke set it, so that a
click's masks follow the section's content and are neither empty nor the
whole section: the output upscaling's and the mask MLPs' last biases are
zero (drawn, they outweigh the image).
"""

from __future__ import annotations

import math

import torch

BIAS_SCALE = 0.02
TABLE_SCALE = 0.02

#: biases set to zero (see above)
ZERO_BIASES = ("mask_decoder.output_upscaling.0.bias", "mask_decoder.output_upscaling.3.bias")


def sam_specs(cfg: dict) -> list:
    """``[(key, shape, init)]`` of the official schema for the widths in
    ``cfg``; ``init`` is ``fan_in`` (with the fan-in), ``bias``, ``table``,
    ``unit``, ``one`` or ``zero``."""
    c, depth, heads = cfg["encoder_dim"], cfg["encoder_depth"], cfg["encoder_heads"]
    p, img, win = cfg["patch_size"], cfg["img_size"], cfg["window_size"]
    d, t = cfg["prompt_dim"], cfg["num_mask_tokens"]
    grid, hd = img // p, c // heads
    specs = []

    def lin(key, n_in, n_out):
        specs.append((f"{key}.weight", (n_out, n_in), ("fan_in", n_in)))
        specs.append((f"{key}.bias", (n_out,), "bias"))

    def norm(key, n):
        specs.append((f"{key}.weight", (n,), "one"))
        specs.append((f"{key}.bias", (n,), "zero"))

    e = "image_encoder"
    specs.append((f"{e}.patch_embed.proj.weight", (c, 3, p, p), ("fan_in", 3 * p * p)))
    specs.append((f"{e}.patch_embed.proj.bias", (c,), "bias"))
    specs.append((f"{e}.pos_embed", (1, grid, grid, c), "table"))
    for i in range(depth):
        b = f"{e}.blocks.{i}"
        size = grid if i in cfg["global_attn_indexes"] else win
        norm(f"{b}.norm1", c)
        lin(f"{b}.attn.qkv", c, 3 * c)
        lin(f"{b}.attn.proj", c, c)
        specs.append((f"{b}.attn.rel_pos_h", (2 * size - 1, hd), "table"))
        specs.append((f"{b}.attn.rel_pos_w", (2 * size - 1, hd), "table"))
        norm(f"{b}.norm2", c)
        lin(f"{b}.mlp.lin1", c, 4 * c)
        lin(f"{b}.mlp.lin2", 4 * c, c)
    specs.append((f"{e}.neck.0.weight", (d, c, 1, 1), ("fan_in", c)))
    norm(f"{e}.neck.1", d)
    specs.append((f"{e}.neck.2.weight", (d, d, 3, 3), ("fan_in", 9 * d)))
    norm(f"{e}.neck.3", d)

    pe = "prompt_encoder"
    specs.append((f"{pe}.pe_layer.positional_encoding_gaussian_matrix", (2, d // 2), "unit"))
    for i in range(4):
        specs.append((f"{pe}.point_embeddings.{i}.weight", (1, d), "unit"))
    specs.append((f"{pe}.not_a_point_embed.weight", (1, d), "unit"))
    specs.append((f"{pe}.no_mask_embed.weight", (1, d), "unit"))

    md = "mask_decoder"

    def attn(key, down):
        inner = d // down
        for name in ("q", "k", "v"):
            lin(f"{key}.{name}_proj", d, inner)
        lin(f"{key}.out_proj", inner, d)

    for i in range(cfg["decoder_depth"]):
        layer = f"{md}.transformer.layers.{i}"
        attn(f"{layer}.self_attn", 1)
        norm(f"{layer}.norm1", d)
        attn(f"{layer}.cross_attn_token_to_image", 2)
        norm(f"{layer}.norm2", d)
        lin(f"{layer}.mlp.lin1", d, cfg["decoder_mlp_dim"])
        lin(f"{layer}.mlp.lin2", cfg["decoder_mlp_dim"], d)
        norm(f"{layer}.norm3", d)
        norm(f"{layer}.norm4", d)
        attn(f"{layer}.cross_attn_image_to_token", 2)
    attn(f"{md}.transformer.final_attn_token_to_image", 2)
    norm(f"{md}.transformer.norm_final_attn", d)
    specs.append((f"{md}.iou_token.weight", (1, d), "unit"))
    specs.append((f"{md}.mask_tokens.weight", (t, d), "unit"))
    # transposed convs, [in, out, k, k]; at kernel 2 and stride 2 each
    # output pixel takes one tap of each input channel
    specs.append((f"{md}.output_upscaling.0.weight", (d, d // 4, 2, 2), ("fan_in", d)))
    specs.append((f"{md}.output_upscaling.0.bias", (d // 4,), "bias"))
    norm(f"{md}.output_upscaling.1", d // 4)
    specs.append((f"{md}.output_upscaling.3.weight", (d // 4, d // 8, 2, 2), ("fan_in", d // 4)))
    specs.append((f"{md}.output_upscaling.3.bias", (d // 8,), "bias"))
    for i in range(t):
        for j, (a, b) in enumerate(((d, d), (d, d), (d, d // 8))):
            lin(f"{md}.output_hypernetworks_mlps.{i}.layers.{j}", a, b)
    h = cfg["iou_head_hidden_dim"]
    for j, (a, b) in enumerate(((d, h), (h, h), (h, t))):
        lin(f"{md}.iou_prediction_head.layers.{j}", a, b)
    return [(k, s, "zero" if k in ZERO_BIASES or _last_hyper_bias(k) else i) for k, s, i in specs]


def _last_hyper_bias(key: str) -> bool:
    return key.startswith("mask_decoder.output_hypernetworks_mlps.") and key.endswith(".layers.2.bias")


def parameter_count(cfg: dict) -> int:
    return sum(math.prod(s) for _, s, _ in sam_specs(cfg))


def make_sam_weights(cfg: dict, seed: int, device) -> dict:
    """``{key: bf16 tensor}`` on ``device``."""
    specs = sam_specs(cfg)
    sizes = [math.prod(s) for _, s, _ in specs]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.bfloat16)
    out, off = {}, 0
    for (key, shape, init), n in zip(specs, sizes):
        v = flat[off : off + n].view(shape)
        off += n
        if init == "one":
            v = torch.ones_like(v)
        elif init == "zero":
            v = torch.zeros_like(v)
        elif init == "unit":
            v = v.clone()
        else:
            scale = {"bias": BIAS_SCALE, "table": TABLE_SCALE}.get(init) or 1.0 / math.sqrt(init[1])
            v = (v.float() * scale).to(torch.bfloat16)
        out[key] = v
    del flat
    return out
