"""Inputs made from the seed: a raw volume for prediction, a Voronoi
training sample.

``voronoi_sample`` is a frozen copy of ``chip_smoke.py:voronoi_sample``
(labels, raw and mask made on the device, returned as numpy arrays).
"""

from __future__ import annotations

import numpy as np
import torch

#: distances computed at once in ``voronoi_sample`` (fp32, 1 GB)
VORONOI_ELEMENTS = 2**28
#: a section's candidate cells: those within this many mean cell spacings
#: in weighted z
VORONOI_REACH = 2.0


def seed32(seed: int, salt: int = 0) -> int:
    """A 63-bit generator seed from any whole ``seed`` and a salt."""
    return int(np.random.SeedSequence([seed & (2**64 - 1), salt]).generate_state(1, np.uint64)[0]) >> 1


def raw_volume(shape, seed: int, device) -> np.ndarray:
    """Uniform random bytes of ``shape``, drawn on the device."""
    gen = torch.Generator(device=device).manual_seed(seed32(seed, 1))
    return torch.randint(0, 256, tuple(shape), generator=gen, device=device, dtype=torch.uint8).cpu().numpy()


def voronoi_sample(shape, n_cells: int, seed: int, device) -> dict:
    """A training sample: Voronoi labels (z distances weighted 10x, as 40
    nm sections against 4 nm pixels) with ids past 2^32 and a tenth of the
    cells as background, raw with dark membranes between the cells and
    noise, a mask with the first eighth of the sections masked out."""
    rng = np.random.default_rng(seed32(seed, 2))
    pts = torch.tensor(rng.uniform(0, 1, (n_cells, 3)) * np.array(shape), dtype=torch.float32, device=device)
    ids = torch.tensor(rng.integers(1, 2**40, n_cells).astype(np.int64), device=device)
    ids[torch.tensor(rng.random(n_cells) < 0.1, device=device)] = 0
    yy, xx = torch.meshgrid(
        torch.arange(shape[1], device=device, dtype=torch.float32),
        torch.arange(shape[2], device=device, dtype=torch.float32),
        indexing="ij",
    )
    labels = torch.empty(tuple(shape), dtype=torch.int64, device=device)
    # a section's candidates are the cells nearer than ``reach`` in weighted
    # z; where each pixel of a row chunk has a candidate nearer than that,
    # no other cell can win, else the chunk takes all cells
    reach2 = (VORONOI_REACH * (10.0 * shape[0] * shape[1] * shape[2] / n_cells) ** (1 / 3)) ** 2

    def nearest(dz, p, cell_ids, y0, rows):
        yc, xc = yy[y0 : y0 + rows].reshape(-1, 1), xx[y0 : y0 + rows].reshape(-1, 1)
        d = dz + (yc - p[:, 1]) ** 2 + (xc - p[:, 2]) ** 2
        dmin, arg = d.min(1)
        return cell_ids[arg].reshape(-1, shape[2]), dmin

    all_rows = max(1, VORONOI_ELEMENTS // (shape[2] * n_cells))
    for z in range(shape[0]):
        dz = ((z - pts[:, 0]) * 10.0) ** 2
        near = dz < reach2
        n_near = int(near.sum())
        rows = max(1, VORONOI_ELEMENTS // (shape[2] * max(n_near, 1)))
        for y0 in range(0, shape[1], rows):
            if n_near:
                got, dmin = nearest(dz[near], pts[near], ids[near], y0, rows)
                if bool((dmin < reach2).all()):
                    labels[z, y0 : y0 + rows] = got
                    continue
            for y1 in range(y0, min(y0 + rows, shape[1]), all_rows):
                labels[z, y1 : min(y1 + all_rows, y0 + rows)] = nearest(
                    dz, pts, ids, y1, min(all_rows, y0 + rows - y1)
                )[0]
    edge = torch.zeros(tuple(shape), dtype=torch.bool, device=device)
    edge[:, 1:] |= labels[:, 1:] != labels[:, :-1]
    edge[:, :, 1:] |= labels[:, :, 1:] != labels[:, :, :-1]
    gen = torch.Generator(device=device).manual_seed(seed32(seed, 3))
    raw = 170.0 - 110.0 * edge.float() + 15.0 * torch.randn(tuple(shape), generator=gen, device=device)
    del edge
    mask = torch.ones(tuple(shape), dtype=torch.uint8, device=device)
    mask[: max(1, shape[0] // 8)] = 0
    return {
        "raw": raw.clamp(0, 255).to(torch.uint8).cpu().numpy(),
        "labels": labels.cpu().numpy().view(np.uint64),
        "mask": mask.cpu().numpy(),
    }
