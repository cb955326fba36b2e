"""Affinity targets, their mask, boundary growing and class balancing on
tensors: the JAX package's ``ops/affinities.py`` (the gunpowder
``AddAffinities``/``GrowBoundary``/``BalanceLabels`` capabilities).

- ``seg_to_affs``: for each neighborhood offset ``o``, the affinity at
  voxel ``v`` is 1 iff ``seg[v] == seg[v+o]`` and both are foreground.
- ``affs_mask``: both endpoints inside the labelled region.
- ``grow_boundary``: zero every voxel whose cross neighbourhood holds
  another label, ``steps`` times (xy only with ``only_xy``).
- ``balance_weights``: positives weigh 1/(2p), negatives 1/(2(1-p)).

Every function takes unbatched ``(*spatial,)`` tensors.  All are exact:
sums of 0/1 values in fp32 are exact integers, so even the balance
weights equal the JAX package's bit for bit.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _shifted(seg, offset, fill=0):
    """``seg`` shifted so that ``result[v] = seg[v + offset]``; voxels whose
    partner lies outside take ``fill``."""
    out = torch.full_like(seg, fill)
    src, dst = [], []
    for n, o in zip(seg.shape, offset):
        o = int(o)
        if o >= 0:
            src.append(slice(o, n))
            dst.append(slice(0, max(n - o, 0)))
        else:
            src.append(slice(0, max(n + o, 0)))
            dst.append(slice(-o, n))
    out[tuple(dst)] = seg[tuple(src)]
    return out


def _in_bounds(shape, offset, device=None):
    """Boolean mask of voxels whose ``+offset`` partner is inside."""
    m = torch.ones(shape, dtype=torch.bool, device=device)
    for d, o in enumerate(offset):
        o, n = int(o), shape[d]
        sl = [slice(None)] * len(shape)
        sl[d] = slice(max(n - o, 0), n) if o >= 0 else slice(0, min(-o, n))
        m[tuple(sl)] = False
    return m


def seg_to_affs(seg, neighborhood: Sequence[Sequence[int]], dtype=torch.float32):
    """Affinities ``(len(neighborhood), *spatial)`` of a label volume."""
    # a partner outside is filled with background, so ``partner > 0``
    # already holds the JAX package's in-bounds term
    affs = []
    for offset in neighborhood:
        partner = _shifted(seg, offset, fill=0)
        affs.append((seg == partner) & (seg > 0) & (partner > 0))
    return torch.stack(affs).to(dtype)


def affs_mask(unlabelled, neighborhood, dtype=torch.float32):
    """Training mask: both edge endpoints inside the labelled region."""
    u = unlabelled > 0
    # a partner outside is filled with False: in bounds by construction
    masks = [u & _shifted(u, offset, fill=False) for offset in neighborhood]
    return torch.stack(masks).to(dtype)


def grow_boundary(seg, steps: int = 1, only_xy: bool = False, mask=None):
    """Grow a background boundary between touching labels: a voxel is
    zeroed when a neighbour in the cross (xy cross with ``only_xy``)
    carries another label, ``steps`` times.  With ``mask``, voxels outside
    it neither erode nor cause erosion."""
    dims = seg.dim()
    start = 1 if (only_xy and dims == 3) else 0
    offsets = []
    for d in range(start, dims):
        for s in (-1, 1):
            o = [0] * dims
            o[d] = s
            offsets.append(o)
    in_mask = None if mask is None else mask > 0
    shape = tuple(seg.shape)
    for _ in range(int(steps)):
        boundary = torch.zeros(shape, dtype=torch.bool, device=seg.device)
        for o in offsets:
            diff = (_shifted(seg, o, fill=0) != seg) & _in_bounds(shape, o, seg.device)
            if in_mask is not None:
                diff = diff & in_mask & _shifted(in_mask, o, fill=False)
            boundary |= diff
        seg = torch.where(boundary, torch.zeros_like(seg), seg)
    return seg


def balance_weights(target, mask=None, clip_min: float = 0.05, clip_max: float = 0.95, slab_axis=None):
    """Class-balancing weights for binary targets: within the mask,
    foreground fraction ``p`` (clipped to ``[clip_min, clip_max]``);
    positives weigh ``1/(2p)``, negatives ``1/(2(1-p))``, masked-out voxels
    0.  ``slab_axis``: a fraction per index of that axis (per affinity
    channel with 0)."""
    t = target
    m = torch.ones_like(t) if mask is None else mask.to(t.dtype)
    if slab_axis is None:
        t, m = t[None], m[None]
    else:
        t, m = torch.movedim(t, slab_axis, 0), torch.movedim(m, slab_axis, 0)
    axes = tuple(range(1, t.dim()))
    view = (-1,) + (1,) * (t.dim() - 1)
    total = torch.clamp(m.sum(axes), min=1.0)
    frac = torch.clamp((t * m).sum(axes) / total, clip_min, clip_max)
    w_pos = (1.0 / (2.0 * frac)).reshape(view)
    w_neg = (1.0 / (2.0 * (1.0 - frac))).reshape(view)
    w = m * torch.where(t > 0.5, w_pos, w_neg)
    return w[0] if slab_axis is None else torch.movedim(w, 0, slab_axis)
