"""Segment Anything (SAM) as ``nn.Module``s: the JAX package's
``models/sam.py``.

The proofreading session (``proofread.py``) turns a clicked point into a
mask with SAM when a checkpoint is given.  The modules carry the official
``segment_anything`` parameter names (``image_encoder.*``,
``prompt_encoder.*``, ``mask_decoder.*``), so ``load_state_dict`` takes a
``sam_vit_{b,l,h}*.pth`` as it is, and ``load_sam`` infers the variant from
the encoder's width.  ``sam_params_to_state_dict`` turns the JAX package's
params into the same state dict.

The modules' inputs and outputs are channels-last, as the JAX functions'
are: the encoder maps ``[B, img, img, 3]`` (preprocessed) to ``[B, g, g,
C]`` embeddings; the prompt encoder points ``[B, N, 2]`` (x, y), labels and
an optional box to ``(sparse [B, N', C], dense [B, g, g, C])``; the mask
decoder those and the dense positional encoding to ``(masks [B, T, 4g,
4g], iou [B, T])``.  Everything is fp32 plain PyTorch, as the JAX package's
``jnp`` is; attention is written out (scaled products, the decomposed
relative positions added, softmax).  Point and box prompts and the
no-mask dense embedding, as in the JAX package: the ``mask_downscaling``
tower of a checkpoint loads but runs nowhere.

``SamPredictor`` embeds a section once and answers point prompts, resizing
as ``jax.image.resize(..., "linear")`` does, downscaling included (an
antialiasing triangle kernel; ``pipeline/augment.py:resize``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import resolve_device
from ..pipeline.augment import resize


@dataclasses.dataclass(frozen=True)
class SamConfig:
    encoder_dim: int = 768
    encoder_depth: int = 12
    encoder_heads: int = 12
    global_attn_indexes: tuple = (2, 5, 8, 11)
    img_size: int = 1024
    patch_size: int = 16
    window_size: int = 14
    prompt_dim: int = 256
    decoder_heads: int = 8
    num_mask_tokens: int = 4  # 1 "whole" + 3 multimask outputs
    decoder_depth: int = 2
    decoder_mlp_dim: int = 2048
    iou_head_hidden_dim: int = 256


PRESETS = {
    "vit_b": SamConfig(),
    "vit_l": SamConfig(
        encoder_dim=1024, encoder_depth=24, encoder_heads=16, global_attn_indexes=(5, 11, 17, 23),
    ),
    "vit_h": SamConfig(
        encoder_dim=1280, encoder_depth=32, encoder_heads=16, global_attn_indexes=(7, 15, 23, 31),
    ),
}

#: official preprocessing constants (segment_anything/modeling/sam.py)
PIXEL_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
PIXEL_STD = np.array([58.395, 57.12, 57.375], np.float32)

#: the decoder transformer's LayerNorms are torch's default (eps 1e-5),
#: the encoder's and the 2D ones 1e-6
_DEC_EPS = 1e-5


def _ln(x, norm, eps):
    """LayerNorm over the last axis with ``norm``'s weight and bias, in the
    JAX package's form (mean, then the biased variance)."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * norm.weight + norm.bias


class LayerNorm2d(nn.Module):
    """The official channels-first LayerNorm's parameters; applied here to
    channels-last tensors (``_ln`` with eps 1e-6)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)

    def forward(self, x, act):
        return self.lin2(act(self.lin1(x)))


def _gelu(x):
    return F.gelu(x)  # the exact erf form, as torch's nn.GELU and the JAX port


# ---------------------------------------------------------------------------
# image encoder
# ---------------------------------------------------------------------------


def get_rel_pos(q_size: int, k_size: int, rel_pos):
    """The relative-position table for ``q_size`` queries and ``k_size``
    keys, linearly resized (half-pixel, no antialiasing) where its length
    is not ``2 * max(q, k) - 1``: ``[q, k, dim]``."""
    max_rel = 2 * max(q_size, k_size) - 1
    n = rel_pos.shape[0]
    if n != max_rel:
        rel_pos = F.interpolate(rel_pos.t()[None], size=max_rel, mode="linear", align_corners=False)[0].t()
    dev = rel_pos.device
    q_coords = torch.arange(q_size, device=dev)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=dev)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long()]


class Attention(nn.Module):
    """Multi-head self-attention over ``[B, H, W, C]`` tokens with
    decomposed relative positions (``rel_pos_h``, ``rel_pos_w``)."""

    def __init__(self, dim: int, heads: int, input_size: tuple):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        hd = dim // heads
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, hd))

    def forward(self, x):
        b, h, w, c = x.shape
        hd = c // self.heads
        qkv = self.qkv(x).reshape(b, h * w, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # [B, heads, HW, hd]
        attn = (q * hd**-0.5) @ k.transpose(-2, -1)
        rh = get_rel_pos(h, h, self.rel_pos_h)
        rw = get_rel_pos(w, w, self.rel_pos_w)
        r_q = q.reshape(b, self.heads, h, w, hd)
        rel_h = torch.einsum("bnhwc,hkc->bnhwk", r_q, rh)
        rel_w = torch.einsum("bnhwc,wkc->bnhwk", r_q, rw)
        attn = (attn.reshape(b, self.heads, h, w, h, w) + rel_h[..., :, None] + rel_w[..., None, :]).reshape(
            b, self.heads, h * w, h * w
        )
        out = (attn.softmax(-1) @ v).transpose(1, 2).reshape(b, h, w, c)
        return self.proj(out)


def window_partition(x, win: int):
    b, h, w, c = x.shape
    ph, pw = (-h) % win, (-w) % win
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // win, win, wp // win, win, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, win, win, c), (hp, wp)


def window_unpartition(x, win: int, hw_pad, hw):
    hp, wp = hw_pad
    h, w = hw
    b = x.shape[0] // (hp // win * (wp // win))
    x = x.reshape(b, hp // win, wp // win, win, win, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :h, :w]


class Block(nn.Module):
    def __init__(self, cfg: SamConfig, window: int):
        super().__init__()
        dim = cfg.encoder_dim
        grid = cfg.img_size // cfg.patch_size
        self.window = window
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, cfg.encoder_heads, (window, window) if window else (grid, grid))
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, 4 * dim)

    def forward(self, x):
        xn = _ln(x, self.norm1, 1e-6)
        if self.window:
            hw = xn.shape[1:3]
            xw, hw_pad = window_partition(xn, self.window)
            xn = window_unpartition(self.attn(xw), self.window, hw_pad, hw)
        else:
            xn = self.attn(xn)
        x = x + xn
        return x + self.mlp(_ln(x, self.norm2, 1e-6), _gelu)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.encoder_dim, cfg.patch_size, cfg.patch_size)


class ImageEncoderViT(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        grid = cfg.img_size // cfg.patch_size
        self.patch_embed = PatchEmbed(cfg)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, cfg.encoder_dim))
        self.blocks = nn.ModuleList(
            Block(cfg, 0 if i in cfg.global_attn_indexes else cfg.window_size)
            for i in range(cfg.encoder_depth)
        )
        self.neck = nn.Sequential(
            nn.Conv2d(cfg.encoder_dim, cfg.prompt_dim, 1, bias=False),
            LayerNorm2d(cfg.prompt_dim),
            nn.Conv2d(cfg.prompt_dim, cfg.prompt_dim, 3, padding=1, bias=False),
            LayerNorm2d(cfg.prompt_dim),
        )

    def forward(self, x):
        """[B, img, img, 3] preprocessed -> [B, g, g, prompt_dim]."""
        x = self.patch_embed.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        x = x @ self.neck[0].weight[:, :, 0, 0].t()
        x = _ln(x, self.neck[1], 1e-6)
        x = F.conv2d(x.permute(0, 3, 1, 2), self.neck[2].weight, padding=1).permute(0, 2, 3, 1)
        return _ln(x, self.neck[3], 1e-6)


# ---------------------------------------------------------------------------
# prompt encoder
# ---------------------------------------------------------------------------


class PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix", torch.randn((2, num_pos_feats)))

    def encode(self, coords01):
        """Random-Fourier encoding of ``[..., 2]`` coordinates in [0, 1]."""
        c = 2.0 * math.pi * ((2.0 * coords01 - 1.0) @ self.positional_encoding_gaussian_matrix)
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


class PromptEncoder(nn.Module):
    def __init__(self, cfg: SamConfig, mask_in_chans: int = 16):
        super().__init__()
        self.cfg = cfg
        dim = cfg.prompt_dim
        self.pe_layer = PositionEmbeddingRandom(dim // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, dim) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, dim)
        self.no_mask_embed = nn.Embedding(1, dim)
        # the mask-prompt tower of the official schema: loaded, not run
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mask_in_chans // 4, 2, 2),
            LayerNorm2d(mask_in_chans // 4),
            nn.GELU(),
            nn.Conv2d(mask_in_chans // 4, mask_in_chans, 2, 2),
            LayerNorm2d(mask_in_chans),
            nn.GELU(),
            nn.Conv2d(mask_in_chans, dim, 1),
        )

    def dense_pe(self, grid: int):
        """Positional encoding of the embedding grid, ``[g, g, C]``."""
        dev = self.pe_layer.positional_encoding_gaussian_matrix.device
        t = (torch.arange(grid, device=dev, dtype=torch.float32) + 0.5) / grid
        coords = torch.stack(torch.meshgrid(t, t, indexing="xy"), dim=-1)  # (x, y)
        return self.pe_layer.encode(coords)

    def forward(self, points, labels, box=None):
        """``points`` [B, N, 2] pixel (x, y) of the input image, ``labels``
        [B, N] (1 foreground, 0 background), ``box`` [B, 4] (x0, y0, x1, y1)
        or None.  A padding point is appended only without a box."""
        cfg = self.cfg
        b = points.shape[0]
        dev = points.device
        pts = (points + 0.5) / cfg.img_size
        lab = labels.long()
        if box is None:
            pts = torch.cat([pts, torch.zeros((b, 1, 2), device=dev)], dim=1)
            lab = torch.cat([lab, torch.full((b, 1), -1, device=dev, dtype=lab.dtype)], dim=1)
        else:
            corners = (box.float().reshape(b, 2, 2) + 0.5) / cfg.img_size
            pts = torch.cat([pts, corners], dim=1)
            extra = torch.tensor([2, 3], device=dev, dtype=lab.dtype).expand(b, 2)
            lab = torch.cat([lab, extra], dim=1)
        emb = self.pe_layer.encode(pts)
        pad = (lab == -1)[..., None]
        emb = torch.where(pad, 0.0, emb)
        table = torch.stack([e.weight[0] for e in self.point_embeddings])  # [4, C]
        emb = emb + torch.where(pad, self.not_a_point_embed.weight[0], table[lab.clamp(0, 3)])
        grid = cfg.img_size // cfg.patch_size
        dense = self.no_mask_embed.weight[0].expand(b, grid, grid, cfg.prompt_dim)
        return emb, dense


# ---------------------------------------------------------------------------
# mask decoder (two-way transformer)
# ---------------------------------------------------------------------------


class DecoderAttention(nn.Module):
    """Attention with separate q/k/v projections to ``dim // downsample``."""

    def __init__(self, dim: int, heads: int, downsample: int = 1):
        super().__init__()
        inner = dim // downsample
        self.heads = heads
        self.q_proj = nn.Linear(dim, inner)
        self.k_proj = nn.Linear(dim, inner)
        self.v_proj = nn.Linear(dim, inner)
        self.out_proj = nn.Linear(inner, dim)

    def forward(self, q, k, v):
        q, k, v = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        b, nq, c = q.shape
        hd = c // self.heads

        def split(t):
            return t.reshape(b, -1, self.heads, hd).transpose(1, 2)

        qh, kh, vh = split(q), split(k), split(v)
        attn = ((qh * hd**-0.5) @ kh.transpose(-2, -1)).softmax(-1)
        return self.out_proj((attn @ vh).transpose(1, 2).reshape(b, nq, c))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, cfg: SamConfig, first: bool):
        super().__init__()
        dim, heads = cfg.prompt_dim, cfg.decoder_heads
        self.first = first
        self.self_attn = DecoderAttention(dim, heads)
        self.norm1 = nn.LayerNorm(dim)
        self.cross_attn_token_to_image = DecoderAttention(dim, heads, 2)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = MLPBlock(dim, cfg.decoder_mlp_dim)
        self.norm3 = nn.LayerNorm(dim)
        self.norm4 = nn.LayerNorm(dim)
        self.cross_attn_image_to_token = DecoderAttention(dim, heads, 2)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.first:
            queries = _ln(self.self_attn(queries, queries, queries), self.norm1, _DEC_EPS)
        else:
            q = queries + query_pe
            queries = _ln(queries + self.self_attn(q, q, queries), self.norm1, _DEC_EPS)
        q, k = queries + query_pe, keys + key_pe
        queries = _ln(queries + self.cross_attn_token_to_image(q, k, keys), self.norm2, _DEC_EPS)
        queries = _ln(queries + self.mlp(queries, torch.relu), self.norm3, _DEC_EPS)
        q, k = queries + query_pe, keys + key_pe
        keys = _ln(keys + self.cross_attn_image_to_token(k, q, queries), self.norm4, _DEC_EPS)
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        self.layers = nn.ModuleList(TwoWayAttentionBlock(cfg, i == 0) for i in range(cfg.decoder_depth))
        self.final_attn_token_to_image = DecoderAttention(cfg.prompt_dim, cfg.decoder_heads, 2)
        self.norm_final_attn = nn.LayerNorm(cfg.prompt_dim)


class MLP(nn.Module):
    def __init__(self, dims: list):
        super().__init__()
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


class MaskDecoder(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        self.cfg = cfg
        dim, t = cfg.prompt_dim, cfg.num_mask_tokens
        self.transformer = TwoWayTransformer(cfg)
        self.iou_token = nn.Embedding(1, dim)
        self.mask_tokens = nn.Embedding(t, dim)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(dim, dim // 4, 2, 2),
            LayerNorm2d(dim // 4),
            nn.GELU(),
            nn.ConvTranspose2d(dim // 4, dim // 8, 2, 2),
            nn.GELU(),
        )
        self.output_hypernetworks_mlps = nn.ModuleList(MLP([dim, dim, dim, dim // 8]) for _ in range(t))
        h = cfg.iou_head_hidden_dim
        self.iou_prediction_head = MLP([dim, h, h, t])

    def forward(self, image_emb, img_pe, sparse, dense):
        """-> (masks [B, T, 4g, 4g], iou [B, T])."""
        cfg = self.cfg
        b, grid = sparse.shape[0], image_emb.shape[1]
        out_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight], 0)
        tokens = torch.cat([out_tokens[None].expand(b, -1, -1), sparse], dim=1)
        keys = (image_emb + dense).reshape(b, grid * grid, cfg.prompt_dim)
        key_pe = img_pe.reshape(1, grid * grid, cfg.prompt_dim).expand_as(keys)
        tf = self.transformer
        queries = tokens
        for layer in tf.layers:
            queries, keys = layer(queries, keys, tokens, key_pe)
        q, k = queries + tokens, keys + key_pe
        queries = _ln(queries + tf.final_attn_token_to_image(q, k, keys), tf.norm_final_attn, _DEC_EPS)
        iou_tok = queries[:, 0]
        mask_toks = queries[:, 1 : 1 + cfg.num_mask_tokens]

        up0, ln1, _, up3, _ = self.output_upscaling
        x = keys.reshape(b, grid, grid, cfg.prompt_dim).permute(0, 3, 1, 2)
        x = F.conv_transpose2d(x, up0.weight, up0.bias, stride=2).permute(0, 2, 3, 1)
        x = _gelu(_ln(x, ln1, 1e-6)).permute(0, 3, 1, 2)
        up = _gelu(F.conv_transpose2d(x, up3.weight, up3.bias, stride=2))  # [B, C/8, 4g, 4g]
        hyper = torch.stack(
            [mlp(mask_toks[:, i]) for i, mlp in enumerate(self.output_hypernetworks_mlps)], dim=1
        )
        masks = torch.einsum("bnc,bchw->bnhw", hyper, up)
        return masks, self.iou_prediction_head(iou_tok)


class Sam(nn.Module):
    """The three modules under the official checkpoint's key prefixes."""

    def __init__(self, cfg: SamConfig):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = ImageEncoderViT(cfg)
        self.prompt_encoder = PromptEncoder(cfg)
        self.mask_decoder = MaskDecoder(cfg)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

#: keys of the official schema that no forward reads, so a state dict
#: without them (the JAX package does not import them) still loads
_UNUSED = "prompt_encoder.mask_downscaling."


def config_from_state_dict(sd, cfg: Optional[SamConfig] = None) -> SamConfig:
    """The ``SamConfig`` of an official-key state dict: the preset of its
    encoder width unless ``cfg`` is given, with the mask-token count, the
    decoder's depth and widths read from the weights."""
    if cfg is None:
        dim = sd["image_encoder.patch_embed.proj.weight"].shape[0]
        match = [c for c in PRESETS.values() if c.encoder_dim == dim]
        if not match:
            raise ValueError(f"no SAM preset has an encoder width of {dim}")
        cfg = match[0]
    depth = 0
    while f"mask_decoder.transformer.layers.{depth}.norm1.weight" in sd:
        depth += 1
    return dataclasses.replace(
        cfg,
        num_mask_tokens=sd["mask_decoder.mask_tokens.weight"].shape[0],
        decoder_depth=depth,
        decoder_mlp_dim=sd["mask_decoder.transformer.layers.0.mlp.lin1.weight"].shape[0],
        iou_head_hidden_dim=sd["mask_decoder.iou_prediction_head.layers.0.weight"].shape[0],
    )


def sam_from_state_dict(sd, cfg: Optional[SamConfig] = None, device=None) -> Sam:
    """A ``Sam`` on ``device`` from an official-key state dict (tensors or
    arrays); every key must be the schema's, and every key of the schema
    but the unused mask tower must be there."""
    sd = {k: v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    cfg = config_from_state_dict(sd, cfg)
    model = Sam(cfg)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.startswith(_UNUSED)]
    if missing or unexpected:
        raise ValueError(f"not a SAM state dict of this schema: missing {missing[:5]}, unexpected {unexpected[:5]}")
    return model.to(resolve_device(device)).eval()


def load_sam(path: str, device=None, cfg: Optional[SamConfig] = None):
    """``(Sam, SamConfig)`` from an official ``sam_vit_*.pth`` file, on
    ``device`` (``cuda`` unless ``"cpu"`` is asked for); the variant is the
    preset of the encoder's width unless ``cfg`` is given."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model = sam_from_state_dict(sd, cfg, device)
    return model, model.cfg


def sam_params_to_state_dict(params) -> dict:
    """The JAX package's SAM params (numpy or JAX leaves) -> the port's
    state dict under the official keys (linears transposed back to
    ``[out, in]``, convs to ``[out, in, kh, kw]``, transposed convs to
    ``[in, out, kh, kw]``)."""
    a = np.asarray
    sd = {}

    def lin(key, p):
        sd[f"{key}.weight"] = a(p["w"]).T
        sd[f"{key}.bias"] = a(p["b"])

    def norm(key, p):
        sd[f"{key}.weight"] = a(p["w"])
        sd[f"{key}.bias"] = a(p["b"])

    enc = params["image_encoder"]
    sd["image_encoder.patch_embed.proj.weight"] = a(enc["patch_embed"]["w"]).transpose(3, 2, 0, 1)
    sd["image_encoder.patch_embed.proj.bias"] = a(enc["patch_embed"]["b"])
    sd["image_encoder.pos_embed"] = a(enc["pos_embed"])
    for i, blk in enumerate(enc["blocks"]):
        b = f"image_encoder.blocks.{i}"
        norm(f"{b}.norm1", blk["norm1"])
        norm(f"{b}.norm2", blk["norm2"])
        lin(f"{b}.attn.qkv", blk["attn"]["qkv"])
        lin(f"{b}.attn.proj", blk["attn"]["proj"])
        sd[f"{b}.attn.rel_pos_h"] = a(blk["attn"]["rel_pos_h"])
        sd[f"{b}.attn.rel_pos_w"] = a(blk["attn"]["rel_pos_w"])
        lin(f"{b}.mlp.lin1", blk["mlp"]["lin1"])
        lin(f"{b}.mlp.lin2", blk["mlp"]["lin2"])
    sd["image_encoder.neck.0.weight"] = a(enc["neck0"]["w"]).T[:, :, None, None]
    norm("image_encoder.neck.1", enc["neck1"])
    sd["image_encoder.neck.2.weight"] = a(enc["neck2"]["w"]).transpose(3, 2, 0, 1)
    norm("image_encoder.neck.3", enc["neck3"])

    pe = params["prompt_encoder"]
    sd["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] = a(pe["pe_gauss"])
    for i in range(4):
        sd[f"prompt_encoder.point_embeddings.{i}.weight"] = a(pe["point_embed"][i])[None]
    sd["prompt_encoder.not_a_point_embed.weight"] = a(pe["not_a_point"])[None]
    sd["prompt_encoder.no_mask_embed.weight"] = a(pe["no_mask"])[None]

    dec = params["mask_decoder"]

    def dec_attn(key, p):
        for name in ("q", "k", "v"):
            lin(f"{key}.{name}_proj", p[name])
        lin(f"{key}.out_proj", p["out"])

    for i, layer in enumerate(dec["layers"]):
        L = f"mask_decoder.transformer.layers.{i}"
        dec_attn(f"{L}.self_attn", layer["self_attn"])
        dec_attn(f"{L}.cross_attn_token_to_image", layer["cross_t2i"])
        dec_attn(f"{L}.cross_attn_image_to_token", layer["cross_i2t"])
        lin(f"{L}.mlp.lin1", layer["mlp"]["lin1"])
        lin(f"{L}.mlp.lin2", layer["mlp"]["lin2"])
        for n in range(1, 5):
            norm(f"{L}.norm{n}", layer[f"norm{n}"])
    dec_attn("mask_decoder.transformer.final_attn_token_to_image", dec["final_t2i"])
    norm("mask_decoder.transformer.norm_final_attn", dec["norm_final"])
    sd["mask_decoder.iou_token.weight"] = a(dec["iou_token"])
    sd["mask_decoder.mask_tokens.weight"] = a(dec["mask_tokens"])
    for key, p in (("0", dec["up0"]), ("3", dec["up2"])):
        sd[f"mask_decoder.output_upscaling.{key}.weight"] = a(p["w"]).transpose(3, 2, 0, 1)
        sd[f"mask_decoder.output_upscaling.{key}.bias"] = a(p["b"])
    norm("mask_decoder.output_upscaling.1", dec["up1"])
    for i, mlp in enumerate(dec["hyper"]):
        for j, p in enumerate(mlp):
            lin(f"mask_decoder.output_hypernetworks_mlps.{i}.layers.{j}", p)
    for j, p in enumerate(dec["iou_head"]):
        lin(f"mask_decoder.iou_prediction_head.layers.{j}", p)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


# ---------------------------------------------------------------------------
# predictor
# ---------------------------------------------------------------------------


class SamPredictor:
    """Embed once, prompt many: the JAX package's ``SamPredictor``.

    ``sam`` is a ``Sam`` module, an official-key state dict, or the JAX
    package's params (``sam_params_to_state_dict``); ``cfg`` its config
    (inferred from a state dict when None).  Runs on ``device`` (``cuda``
    unless ``"cpu"`` is asked for).  EM sections are grayscale: they are
    replicated to RGB and resized so that the long side is
    ``cfg.img_size`` (the official ``ResizeLongestSide``)."""

    def __init__(self, sam, cfg: Optional[SamConfig] = None, device=None):
        self.device = resolve_device(device)
        if isinstance(sam, Sam):
            self.model = sam.to(self.device).eval()
        else:
            if isinstance(sam.get("image_encoder"), dict):
                sam = sam_params_to_state_dict(sam)
            self.model = sam_from_state_dict(sam, cfg, self.device)
        self.cfg = self.model.cfg
        self._embedding = None
        self._scale = 1.0
        self._orig_hw = None

    @torch.no_grad()
    def set_image(self, image: np.ndarray):
        """image: [H, W] grayscale or [H, W, 3], any real dtype."""
        img = np.asarray(image)
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        self._orig_hw = img.shape[:2]
        size = self.cfg.img_size
        self._scale = scale = size / max(img.shape[:2])
        new_hw = (max(1, round(img.shape[0] * scale)), max(1, round(img.shape[1] * scale)))
        x = torch.as_tensor(img.astype(np.float32), device=self.device)
        x = resize(x, (*new_hw, 3), "linear")
        x = (x - torch.as_tensor(PIXEL_MEAN, device=self.device)) / torch.as_tensor(PIXEL_STD, device=self.device)
        x = F.pad(x, (0, 0, 0, size - new_hw[1], 0, size - new_hw[0]))
        self._embedding = self.model.image_encoder(x[None])
        return self

    @torch.no_grad()
    def predict(self, points, labels, box=None, return_logits: bool = False):
        """points [N, 2] (x, y) in the original image's pixels, labels [N]
        (1 foreground, 0 background), box (x0, y0, x1, y1) or None ->
        (masks [T, H, W] bool, iou [T]) as numpy; ``return_logits`` gives
        the masks' fp32 logits instead (a mask is where its logit > 0), as
        the official predictor's option of that name."""
        if self._embedding is None:
            raise RuntimeError("call set_image first")
        cfg, dev = self.cfg, self.device
        pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)[None] * self._scale
        lab = torch.as_tensor(np.asarray(labels, np.int64), device=dev)[None]
        if box is not None:
            box = torch.as_tensor(np.asarray(box, np.float32), device=dev)[None] * self._scale
        m = self.model
        sparse, dense = m.prompt_encoder(pts, lab, box)
        pe = m.prompt_encoder.dense_pe(cfg.img_size // cfg.patch_size)
        masks, iou = m.mask_decoder(self._embedding, pe, sparse, dense)
        masks = resize(masks, (1, masks.shape[1], cfg.img_size, cfg.img_size), "linear")
        h, w = self._orig_hw
        sh = max(1, round(h * self._scale))
        sw = max(1, round(w * self._scale))
        masks = resize(masks[:, :, :sh, :sw], (1, masks.shape[1], h, w), "linear")
        return (masks[0] if return_logits else masks[0] > 0.0).cpu().numpy(), iou[0].cpu().numpy()
