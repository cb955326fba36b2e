"""The plain reference of the training transform's targets, for a draw
with mirrors and a transpose and no other augment (numpy, scipy).

Written from the published gunpowder nodes the setups train with
(``Normalize``, ``SimpleAugment``, ``GrowBoundary``, ``AddAffinities``,
``BalanceLabels``, ``AddLocalShapeDescriptor``): raw scaled to [0, 1] and
then to [-1, 1]; labels renumbered densely by rank (background kept at 0,
ranks past 63 merged into 63); the output crop centred; a boundary grown
in xy between touching labels inside the mask; affinities of each
neighbourhood offset (both ends the same foreground label) and their mask
(both ends labelled); class-balanced weights per affinity channel (a
foreground share clipped to [0.05, 0.95]); a 2D net's LSDs of its centre
section on a grid strided by ``downsample``, as Gaussian moments of each
label's mask (3 sigma wide), nearest-upsampled back.  Imports nothing of
the program.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import correlate1d

MAX_LABELS = 64


def renumber(labels: np.ndarray) -> np.ndarray:
    ids = np.unique(labels)
    ranks = np.searchsorted(ids, labels) + (0 if ids[0] == 0 else 1)
    return np.minimum(ranks, MAX_LABELS - 1).astype(np.int64)


def centre_crop(x: np.ndarray, shape) -> np.ndarray:
    return x[tuple(slice((s - t) // 2, (s - t) // 2 + t) for s, t in zip(x.shape, shape))]


def shifted(a: np.ndarray, offset, fill) -> np.ndarray:
    """``out[v] = a[v + offset]``, ``fill`` where ``v + offset`` is outside."""
    out = np.full_like(a, fill)
    src, dst = [], []
    for n, o in zip(a.shape, offset):
        src.append(slice(o, n) if o >= 0 else slice(0, max(n + o, 0)))
        dst.append(slice(0, max(n - o, 0)) if o >= 0 else slice(-o, n))
    out[tuple(dst)] = a[tuple(src)]
    return out


def grow_boundary(seg, mask, steps: int):
    inside = mask > 0
    for _ in range(steps):
        boundary = np.zeros(seg.shape, bool)
        for d in (1, 2):
            for s in (-1, 1):
                o = [0, 0, 0]
                o[d] = s
                valid = shifted(np.ones(seg.shape, bool), o, False)
                boundary |= (shifted(seg, o, 0) != seg) & valid & inside & shifted(inside, o, False)
        seg = np.where(boundary, 0, seg)
    return seg


def affinities(seg, neighborhood):
    return np.stack(
        [(seg == (p := shifted(seg, o, 0))) & (seg > 0) & (p > 0) for o in neighborhood]
    ).astype(np.float32)


def affinity_mask(mask, neighborhood):
    u = mask > 0
    return np.stack([u & shifted(u, o, False) for o in neighborhood]).astype(np.float32)


def balance(t, m):
    """Per channel (axis 0): positives ``1 / (2 p)``, negatives ``1 / (2 (1
    - p))`` inside the mask, ``p`` the clipped foreground share; in fp32."""
    one, two = np.float32(1.0), np.float32(2.0)
    axes = tuple(range(1, t.ndim))
    total = np.maximum(m.sum(axes, dtype=np.float32), one)
    frac = np.clip((t * m).sum(axes, dtype=np.float32) / total, np.float32(0.05), np.float32(0.95))
    view = (-1,) + (1,) * (t.ndim - 1)
    w_pos = (one / (two * frac)).reshape(view)
    w_neg = (one / (two * (one - frac))).reshape(view)
    return m * np.where(t > 0.5, w_pos, w_neg)


def gaussian(sigma_vox: float, order: int) -> np.ndarray:
    radius = max(1, int(3.0 * sigma_vox + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-0.5 * (x / sigma_vox) ** 2)
    g /= g.sum()
    return g * x**order


def lsd_2d(seg, sigma: float, voxel_size, downsample: int) -> np.ndarray:
    """The 6 LSDs of a 2D label image (offset y, x; variance y, x; Pearson
    yx; size), each voxel from its own label's moments."""
    sub = seg[::downsample, ::downsample]
    vs = [v * downsample for v in voxel_size]
    sv = [sigma / v for v in vs]
    out = np.zeros((6, *sub.shape))
    for label in np.unique(sub):
        if label == 0:
            continue
        m = (sub == label).astype(np.float64)

        def moment(oy, ox):
            return correlate1d(correlate1d(m, gaussian(sv[0], oy), 0, mode="constant"), gaussian(sv[1], ox), 1, mode="constant")

        count = np.maximum(moment(0, 0), 1e-6)
        fy, fx = moment(1, 0) / count * vs[0], moment(0, 1) / count * vs[1]
        syy, sxx = moment(2, 0) / count * vs[0] ** 2, moment(0, 2) / count * vs[1] ** 2
        sxy = moment(1, 1) / count * vs[0] * vs[1]
        vy, vx = np.maximum(syy - fy * fy, 0), np.maximum(sxx - fx * fx, 0)
        pearson = np.clip((sxy - fy * fx) / (np.sqrt(vy * vx) + 1e-6), -1, 1)
        desc = [
            np.clip(fy / sigma, -1, 1) * 0.5 + 0.5, np.clip(fx / sigma, -1, 1) * 0.5 + 0.5,
            np.clip(vy / sigma**2, 0, 1), np.clip(vx / sigma**2, 0, 1),
            pearson * 0.5 + 0.5, np.clip(count, 0, 1),
        ]
        sel = sub == label
        for c, d in enumerate(desc):
            out[c][sel] = d[sel]
    up = out.repeat(downsample, 1).repeat(downsample, 2)
    return up[:, : seg.shape[0], : seg.shape[1]].astype(np.float32)


def transform_reference(net_config: dict, voxel_size, raw, labels, mask, flips, transpose) -> dict:
    """``{"input", "targets", "weights"}`` as the program's transform lays
    them out (channels last; a 2D net's targets ``(h, w, C)``) for one host
    crop (``raw`` uint8, ``labels`` ids, ``mask`` 0/1, each the input
    tile)."""
    dims = len(net_config["input_shape"])
    adj = net_config.get("adj_slices", 1)
    out_tile = (1, *net_config["output_shape"]) if dims == 2 else tuple(net_config["output_shape"])
    if dims == 2 and adj != raw.shape[0]:
        raise ValueError(f"a 2D crop of {raw.shape[0]} sections for adj_slices {adj}")
    arrays = [raw.astype(np.float32) / np.float32(255.0), renumber(labels), mask.astype(np.float32)]
    axes = [a for a, f in zip((0, 1, 2), flips) if f]
    arrays = [np.flip(a, axes) if axes else a for a in arrays]
    if transpose:
        arrays = [np.swapaxes(a, 1, 2) for a in arrays]
    raw, labels, mask = (np.ascontiguousarray(a) for a in arrays)
    raw = np.clip(raw, 0.0, 1.0)
    labels_out, mask_out = centre_crop(labels, out_tile), centre_crop(mask, out_tile)
    targets, weights = {}, {}
    for name, spec in net_config["outputs"].items():
        if "neighborhood" in spec:
            nbhd = [list(o) if dims == 3 else [0, *o] for o in spec["neighborhood"]]
            lab = labels_out
            if spec.get("grow_boundary", 0):
                lab = grow_boundary(lab, mask_out, int(spec["grow_boundary"]))
            t = affinities(lab, nbhd)
            w = balance(t, affinity_mask(mask_out, nbhd))
        elif dims == 2:
            t = lsd_2d(labels_out[0], float(spec["sigma"]), voxel_size[1:], int(spec.get("downsample", 1)))[:, None]
            w = np.broadcast_to(mask_out[None], t.shape)
        else:
            raise NotImplementedError("the reference holds 2D LSDs only")
        t, w = np.moveaxis(t, 0, -1), np.moveaxis(w, 0, -1)
        if dims == 2:
            t, w = t[0], w[0]
        targets[name] = np.ascontiguousarray(t, dtype=np.float32)
        weights[name] = np.ascontiguousarray(w, dtype=np.float32)
    return {"input": (raw * np.float32(2.0) - np.float32(1.0))[..., None], "targets": targets, "weights": weights}
