"""Segment Anything (SAM) in plain torch, from an official-key state dict:
a section embedded, a point prompted, the masks post-processed, as the
official ``SamPredictor`` does it.

Written from facebookresearch/segment-anything's modules
(``modeling/image_encoder.py``, ``modeling/prompt_encoder.py``,
``modeling/mask_decoder.py``, ``modeling/transformer.py``,
``modeling/common.py``) and the predictor's transforms
(``utils/transforms.py:ResizeLongestSide``, ``Sam.preprocess``,
``Sam.postprocess_masks``).  Functions of a weight dictionary, not modules,
so that one code computes in any precision: ``dtype`` casts the weights and
every activation.  Imports nothing of the program.

One departure, the one the measured program states: every resize is
``jax.image.resize(..., "linear")`` (``linear_resize`` below: half-pixel
centres, a triangle kernel widened by the scale when downscaling, the taps
outside the image dropped and the rest renormalised), where the official
predictor resizes the image with PIL to uint8 and the masks with
``F.interpolate(..., "bilinear")``.  Upscaling, the two agree but for
rounding; downscaling, PIL's antialiasing filter is this kernel too.  EM
sections are grayscale and are replicated to RGB, as ``set_image`` takes a
grayscale image.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

#: the official preprocessing constants (``modeling/sam.py``)
PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


@contextlib.contextmanager
def precision(tf32: bool):
    """Both of torch's TF32 flags set to ``tf32`` inside, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def linear_resize_matrix(m: int, n: int, device) -> torch.Tensor:
    """``(m, n)`` fp32 weights that take ``m`` samples to ``n`` along one
    axis as ``jax.image.resize(..., "linear")`` does."""
    scale = n / m
    support = max(1.0 / scale, 1.0)  # the kernel widened when downscaling
    centre = (torch.arange(n, dtype=torch.float64, device=device) + 0.5) / scale - 0.5
    dist = (centre[None, :] - torch.arange(m, dtype=torch.float64, device=device)[:, None]).abs() / support
    w = (1.0 - dist).clamp(min=0.0)
    w = w / w.sum(0, keepdim=True)
    return w.to(torch.float32)


def linear_resize(x: torch.Tensor, hw) -> torch.Tensor:
    """The last two axes of ``x`` resized to ``hw``."""
    h, w = x.shape[-2:]
    if h != hw[0]:
        x = (x.transpose(-1, -2) @ linear_resize_matrix(h, hw[0], x.device).to(x.dtype)).transpose(-1, -2)
    if w != hw[1]:
        x = x @ linear_resize_matrix(w, hw[1], x.device).to(x.dtype)
    return x


class SamReference:
    """SAM of ``cfg`` (the configuration's widths: ``encoder_dim``,
    ``encoder_depth``, ``encoder_heads``, ``global_attn_indexes``,
    ``img_size``, ``patch_size``, ``window_size``, ``prompt_dim``,
    ``decoder_heads``, ``decoder_depth``, ``num_mask_tokens``) over the
    official-key weights ``sd``, computed in ``dtype``."""

    def __init__(self, sd: dict, cfg: dict, dtype=torch.float32):
        self.cfg = cfg
        self.dtype = dtype
        self.w = {k: v.to(dtype) for k, v in sd.items()}

    # -- common.py ---------------------------------------------------------

    def linear(self, x, key):
        return F.linear(x, self.w[f"{key}.weight"], self.w.get(f"{key}.bias"))

    def layer_norm(self, x, key, eps):
        """``nn.LayerNorm`` over the last axis."""
        return F.layer_norm(x, x.shape[-1:], self.w[f"{key}.weight"], self.w[f"{key}.bias"], eps)

    def layer_norm_2d(self, x, key, eps=1e-6):
        """``common.LayerNorm2d``: over the channels of ``[B, C, H, W]``."""
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + eps)
        return self.w[f"{key}.weight"][:, None, None] * x + self.w[f"{key}.bias"][:, None, None]

    # -- image_encoder.py --------------------------------------------------

    @staticmethod
    def window_partition(x, win):
        b, h, w, c = x.shape
        ph, pw = (win - h % win) % win, (win - w % win) % win
        if ph or pw:
            x = F.pad(x, (0, 0, 0, pw, 0, ph))
        hp, wp = h + ph, w + pw
        x = x.view(b, hp // win, win, wp // win, win, c)
        return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, win, win, c), (hp, wp)

    @staticmethod
    def window_unpartition(x, win, pad_hw, hw):
        hp, wp = pad_hw
        h, w = hw
        b = x.shape[0] // (hp * wp // win // win)
        x = x.view(b, hp // win, wp // win, win, win, -1)
        x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, hp, wp, -1)
        if hp > h or wp > w:
            x = x[:, :h, :w, :].contiguous()
        return x

    @staticmethod
    def get_rel_pos(q_size, k_size, rel_pos):
        max_rel = int(2 * max(q_size, k_size) - 1)
        if rel_pos.shape[0] != max_rel:
            rel_pos = F.interpolate(rel_pos.reshape(1, rel_pos.shape[0], -1).permute(0, 2, 1), size=max_rel,
                                    mode="linear").reshape(-1, max_rel).permute(1, 0)
        dev = rel_pos.device
        q = torch.arange(q_size, device=dev)[:, None] * max(k_size / q_size, 1.0)
        k = torch.arange(k_size, device=dev)[None, :] * max(q_size / k_size, 1.0)
        rel = (q - k) + (k_size - 1) * max(q_size / k_size, 1.0)
        return rel_pos[rel.long()]

    def attention(self, x, key):
        """``image_encoder.Attention`` with decomposed relative positions."""
        b, h, w, c = x.shape
        heads = self.cfg["encoder_heads"]
        qkv = self.linear(x, f"{key}.qkv").reshape(b, h * w, 3, heads, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, b * heads, h * w, -1).unbind(0)
        attn = (q * (c // heads) ** -0.5) @ k.transpose(-2, -1)
        rh = self.get_rel_pos(h, h, self.w[f"{key}.rel_pos_h"])
        rw = self.get_rel_pos(w, w, self.w[f"{key}.rel_pos_w"])
        r_q = q.reshape(b * heads, h, w, -1)
        rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
        rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
        attn = (attn.view(b * heads, h, w, h, w) + rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :]).view(
            b * heads, h * w, h * w)
        attn = attn.softmax(dim=-1)
        out = (attn @ v).view(b, heads, h, w, -1).permute(0, 2, 3, 1, 4).reshape(b, h, w, -1)
        return self.linear(out, f"{key}.proj")

    def block(self, x, i):
        key = f"image_encoder.blocks.{i}"
        win = 0 if i in self.cfg["global_attn_indexes"] else self.cfg["window_size"]
        shortcut = x
        x = self.layer_norm(x, f"{key}.norm1", 1e-6)
        if win:
            hw = x.shape[1:3]
            x, pad_hw = self.window_partition(x, win)
        x = self.attention(x, f"{key}.attn")
        if win:
            x = self.window_unpartition(x, win, pad_hw, hw)
        x = shortcut + x
        y = self.layer_norm(x, f"{key}.norm2", 1e-6)
        y = self.linear(F.gelu(self.linear(y, f"{key}.mlp.lin1")), f"{key}.mlp.lin2")
        return x + y

    def encode(self, x):
        """``ImageEncoderViT``: ``[B, 3, img, img]`` preprocessed ->
        ``[B, prompt_dim, g, g]``."""
        p = self.cfg["patch_size"]
        x = F.conv2d(x, self.w["image_encoder.patch_embed.proj.weight"], self.w["image_encoder.patch_embed.proj.bias"],
                     stride=p).permute(0, 2, 3, 1)
        x = x + self.w["image_encoder.pos_embed"]
        for i in range(self.cfg["encoder_depth"]):
            x = self.block(x, i)
        x = F.conv2d(x.permute(0, 3, 1, 2), self.w["image_encoder.neck.0.weight"])
        x = self.layer_norm_2d(x, "image_encoder.neck.1")
        x = F.conv2d(x, self.w["image_encoder.neck.2.weight"], padding=1)
        return self.layer_norm_2d(x, "image_encoder.neck.3")

    # -- the predictor's set_image -----------------------------------------

    def input_size(self, hw):
        """``ResizeLongestSide.get_preprocess_shape``."""
        scale = self.cfg["img_size"] / max(hw)
        return int(hw[0] * scale + 0.5), int(hw[1] * scale + 0.5)

    def embed(self, section: np.ndarray, device):
        """A grayscale ``[H, W]`` section -> its embedding ``[1, C, g, g]``:
        replicated to RGB, resized so that its long side is ``img_size``,
        normalised, padded to a square (``Sam.preprocess``), encoded."""
        size = self.cfg["img_size"]
        x = torch.as_tensor(np.asarray(section), device=device).to(torch.float32)
        x = x[None].expand(3, *x.shape)
        x = linear_resize(x, self.input_size(section.shape))
        mean = torch.tensor(PIXEL_MEAN, device=device)[:, None, None]
        std = torch.tensor(PIXEL_STD, device=device)[:, None, None]
        x = (x - mean) / std
        x = F.pad(x, (0, size - x.shape[-1], 0, size - x.shape[-2]))
        return self.encode(x[None].to(self.dtype))

    # -- prompt_encoder.py -------------------------------------------------

    def pe_encoding(self, coords):
        g = self.w["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"]
        coords = 2 * math.pi * ((2 * coords - 1) @ g)
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)

    def dense_pe(self, grid, device):
        """``PositionEmbeddingRandom.forward`` over the embedding grid:
        ``[1, C, g, g]``."""
        ones = torch.ones((grid, grid), device=device, dtype=self.dtype)
        y = (ones.cumsum(0) - 0.5) / grid
        x = (ones.cumsum(1) - 0.5) / grid
        return self.pe_encoding(torch.stack([x, y], dim=-1)).permute(2, 0, 1)[None]

    def prompt(self, points, labels):
        """``PromptEncoder.forward`` for points and no box: ``(sparse [1,
        N + 1, C], dense [1, C, g, g])``; ``points`` ``[1, N, 2]`` (x, y) in
        the resized image's pixels."""
        size = self.cfg["img_size"]
        dev = points.device
        pts = torch.cat([points + 0.5, torch.zeros((1, 1, 2), device=dev, dtype=points.dtype)], dim=1)
        lab = torch.cat([labels, -torch.ones((1, 1), device=dev, dtype=labels.dtype)], dim=1)
        emb = self.pe_encoding((pts / size).to(self.dtype))
        emb[lab == -1] = 0.0
        emb[lab == -1] += self.w["prompt_encoder.not_a_point_embed.weight"][0]
        emb[lab == 0] += self.w["prompt_encoder.point_embeddings.0.weight"][0]
        emb[lab == 1] += self.w["prompt_encoder.point_embeddings.1.weight"][0]
        grid = size // self.cfg["patch_size"]
        dense = self.w["prompt_encoder.no_mask_embed.weight"].reshape(1, -1, 1, 1).expand(1, -1, grid, grid)
        return emb, dense

    # -- transformer.py ----------------------------------------------------

    def dec_attention(self, q, k, v, key):
        """``transformer.Attention``: projections, heads, softmax."""
        heads = self.cfg["decoder_heads"]
        q, k, v = self.linear(q, f"{key}.q_proj"), self.linear(k, f"{key}.k_proj"), self.linear(v, f"{key}.v_proj")

        def split(t):
            b, n, c = t.shape
            return t.reshape(b, n, heads, c // heads).transpose(1, 2)

        q, k, v = split(q), split(k), split(v)
        attn = (q @ k.permute(0, 1, 3, 2)) / math.sqrt(q.shape[-1])
        out = attn.softmax(dim=-1) @ v
        b, _, n, _ = out.shape
        return self.linear(out.transpose(1, 2).reshape(b, n, -1), f"{key}.out_proj")

    def two_way_block(self, queries, keys, query_pe, key_pe, i):
        key = f"mask_decoder.transformer.layers.{i}"
        if i == 0:  # skip_first_layer_pe
            queries = self.dec_attention(queries, queries, queries, f"{key}.self_attn")
        else:
            q = queries + query_pe
            queries = queries + self.dec_attention(q, q, queries, f"{key}.self_attn")
        queries = self.layer_norm(queries, f"{key}.norm1", 1e-5)
        q, k = queries + query_pe, keys + key_pe
        queries = self.layer_norm(queries + self.dec_attention(q, k, keys, f"{key}.cross_attn_token_to_image"),
                                  f"{key}.norm2", 1e-5)
        mlp = self.linear(torch.relu(self.linear(queries, f"{key}.mlp.lin1")), f"{key}.mlp.lin2")
        queries = self.layer_norm(queries + mlp, f"{key}.norm3", 1e-5)
        q, k = queries + query_pe, keys + key_pe
        keys = self.layer_norm(keys + self.dec_attention(k, q, queries, f"{key}.cross_attn_image_to_token"),
                               f"{key}.norm4", 1e-5)
        return queries, keys

    # -- mask_decoder.py ---------------------------------------------------

    def mlp_head(self, x, key, layers):
        for j in range(layers):
            x = self.linear(x, f"{key}.layers.{j}")
            if j < layers - 1:
                x = F.relu(x)
        return x

    def decode(self, embedding, points, labels):
        """``MaskDecoder.predict_masks`` for one point prompt: ``(masks [1,
        T, 4g, 4g], iou [1, T])`` (every mask token; the predictor's
        ``multimask_output`` only selects among them)."""
        w = self.w
        t = self.cfg["num_mask_tokens"]
        sparse, dense = self.prompt(points, labels)
        out_tokens = torch.cat([w["mask_decoder.iou_token.weight"], w["mask_decoder.mask_tokens.weight"]], dim=0)
        tokens = torch.cat([out_tokens[None], sparse], dim=1)
        src = embedding + dense
        b, c, h, ww = src.shape
        pos = self.dense_pe(h, src.device)
        keys = src.flatten(2).permute(0, 2, 1)
        key_pe = pos.flatten(2).permute(0, 2, 1)
        queries = tokens
        for i in range(self.cfg["decoder_depth"]):
            queries, keys = self.two_way_block(queries, keys, tokens, key_pe, i)
        q, k = queries + tokens, keys + key_pe
        attn = self.dec_attention(q, k, keys, "mask_decoder.transformer.final_attn_token_to_image")
        queries = self.layer_norm(queries + attn, "mask_decoder.transformer.norm_final_attn", 1e-5)
        iou_out, mask_out = queries[:, 0, :], queries[:, 1 : 1 + t, :]
        x = keys.transpose(1, 2).reshape(b, c, h, ww)
        x = F.conv_transpose2d(x, w["mask_decoder.output_upscaling.0.weight"],
                               w["mask_decoder.output_upscaling.0.bias"], stride=2)
        x = F.gelu(self.layer_norm_2d(x, "mask_decoder.output_upscaling.1"))
        x = F.gelu(F.conv_transpose2d(x, w["mask_decoder.output_upscaling.3.weight"],
                                      w["mask_decoder.output_upscaling.3.bias"], stride=2))
        hyper = torch.stack([self.mlp_head(mask_out[:, i, :], f"mask_decoder.output_hypernetworks_mlps.{i}", 3)
                             for i in range(t)], dim=1)
        b, c, h, ww = x.shape
        masks = (hyper @ x.view(b, c, h * ww)).view(b, -1, h, ww)
        return masks, self.mlp_head(iou_out, "mask_decoder.iou_prediction_head", 3)

    # -- the predictor's predict -------------------------------------------

    def predict(self, embedding, point_xy, image_hw):
        """One positive point ``(x, y)`` in the section's pixels ->
        ``(masks [T, 4g, 4g], iou [T], logits [T, H, W])``: the decoder's
        masks, its IOU predictions, and the masks' logits at the section's
        size (``postprocess_masks``: up to ``img_size``, the padding cut
        off, to the section's size)."""
        dev = embedding.device
        size = self.cfg["img_size"]
        ih, iw = self.input_size(image_hw)
        # ``ResizeLongestSide.apply_coords``
        pts = torch.tensor([[[point_xy[0] * (iw / image_hw[1]), point_xy[1] * (ih / image_hw[0])]]],
                           device=dev, dtype=torch.float32)
        labels = torch.ones((1, 1), device=dev, dtype=torch.int64)
        masks, iou = self.decode(embedding, pts, labels)
        logits = linear_resize(masks, (size, size))[..., :ih, :iw]
        logits = linear_resize(logits, image_hw)
        return masks[0], iou[0], logits[0]
