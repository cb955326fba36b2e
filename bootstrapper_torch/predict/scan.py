"""Sliding-window prediction over world-unit Zarr volumes (the JAX
package's ``predict/scan.py``).

- The output ROI is tiled by the net's output size; edge tiles shift
  inward so every tile is full-sized.
- Reads grow each write tile by the context ((input-output)/2) and
  reflect-pad outside the volume.
- uint8 tiles are uploaded as bytes and normalised on the device in fp32
  (to [-1, 1] for image inputs); outputs are written as
  ``round(clamp(y, 0, 1) * 255)`` uint8 (``torch.round`` rounds half to
  even, like ``jnp.round``; the clamp comes before the cast).
- The next tile's host read and the previous tile's download and write
  overlap the device's compute (``_pipeline.run_pipelined``).

The tile is the net config's ``input_shape + shape_increase``, or, with
``auto_shape_increase`` (``bs predict --auto-tile``), the JAX package's
growth rule under a budget of input voxels that this card's memory sets
(``default_tile_budget``).  A 2D setup's tile is ``adj_slices`` sections in and one out,
``(adj, H, W) -> (1, H', W')``, and its tiles run ``batch_tiles`` at a
time (32 by default, as in the JAX package; 3D setups 1): a short last
batch is padded with its last tile, whose extra outputs are discarded.
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..core.arrays import Array, prepare_ds
from ..core.geometry import Coordinate, Roi
from ..models.model import Model, head_dims
from ..models.unet import compute_output_shape
from ._pipeline import Lane, TileWriter, fetch, make_tile_reader, run_pipelined


#: device memory a tiled bf16 forward of the full-width 3d_affs net takes
#: per input voxel, rounded up from the most that ``chip_smoke.py``'s ``cli``
#: phase read (``torch.cuda.max_memory_allocated`` over the forward, less the
#: weights and input; it grows with the tile: 233 at (32,412,412), 380 at
#: (92,604,604), 432 at (152,908,908)) on an H100 80GB HBM3 (700.00 W limit)
TILE_BYTES_PER_INPUT_VOXEL = 450
#: share of the card's memory one tile's forward may plan for; the rest holds
#: the weights, the pipeline's buffers and the allocator's slack
TILE_MEMORY_SHARE = 0.6
#: budgets made for a device that reports no memory size (the CPU) assume
#: one H100's
DEFAULT_DEVICE_BYTES = 80 * 10**9


def normalize_on_device(x, is_image: bool):
    """uint8 input on the device -> float32 in [0, 1], or [-1, 1] for an
    image input (the host's ``normalize_raw`` arithmetic); other inputs are
    already normalised."""
    if x.dtype == torch.uint8:
        x = x.to(torch.float32) / 255.0
        if is_image:
            x = x * 2.0 - 1.0
    return x


def quantize(outs: dict) -> dict:
    """Per head ``round(clamp(y, 0, 1) * 255)`` as uint8."""
    return {k: torch.round(torch.clamp(v, 0, 1) * 255).to(torch.uint8) for k, v in outs.items()}


@torch.no_grad()
def forward_uint8(model: Model, x, is_image: bool) -> dict:
    """One forward of ``model`` on a batch of input tiles on its device ->
    uint8 outputs per head: what every predictor runs per tile."""
    return quantize(model(normalize_on_device(x, is_image)))


def device_memory_bytes(device=None) -> Optional[int]:
    """Total memory of a CUDA device; None for any other device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_properties(dev).total_memory


def default_tile_budget(device=None) -> int:
    """Input voxels one tiled forward may take on ``device``."""
    mem = device_memory_bytes(device) or DEFAULT_DEVICE_BYTES
    return int(TILE_MEMORY_SHARE * mem / TILE_BYTES_PER_INPUT_VOXEL)


def auto_shape_increase(
    net_config: dict,
    volume_vox_shape,
    max_input_voxels: Optional[int] = None,
    device=None,
) -> list:
    """A ``shape_increase`` for the largest tile, as the JAX package's
    ``auto_shape_increase`` picks it: valid convs make outputs independent
    of the tile, so a larger tile pays the fixed context fewer times.  Grow
    z first (the z context dominates) up to 124 output slices, then y and x
    together in steps of the pooling product, staying inside the volume and
    ``max_input_voxels`` (default: ``device``'s ``default_tile_budget``).
    A 2D setup keeps its config's ``shape_increase``."""
    base_in = list(net_config["input_shape"])
    base_out = list(net_config["output_shape"])
    dims = len(base_in)
    if dims != 3:
        return list(net_config.get("shape_increase", [0] * dims))
    if max_input_voxels is None:
        max_input_voxels = default_tile_budget(device)
    vol = list(volume_vox_shape)[-3:]
    step = [1, 1, 1]
    for f in net_config["downsample_factors"]:
        step = [a * b for a, b in zip(step, f)]

    def fits(inc):
        out = [o + s for o, s in zip(base_out, inc)]
        inp = [i + s for i, s in zip(base_in, inc)]
        return all(o <= v for o, v in zip(out, vol)) and int(np.prod(inp)) <= max_input_voxels

    inc = [0, 0, 0]
    while True:  # z: any step is conv-valid when z is not pooled
        cand = [inc[0] + max(step[0], 4), inc[1], inc[2]]
        if base_out[0] + cand[0] > 124 or not fits(cand):
            break
        inc = cand
    while True:
        cand = [inc[0], inc[1] + step[1], inc[2] + step[2]]
        if not fits(cand):
            break
        inc = cand
    return inc


def shrink_shape_increase(model: Model, volume_vox_shape, inc=None) -> list:
    """``inc`` (default: the net config's ``shape_increase``), shrunk
    (possibly below zero) so one output tile fits inside the volume, in
    pooling-product steps, keeping the shrunk input/output pair valid for
    the net's conv arithmetic."""
    nc = model.net_config
    dims = model.dims
    base_in = list(nc["input_shape"])
    base_out = list(nc["output_shape"])
    inc = list(nc.get("shape_increase", [0] * dims) if inc is None else inc)
    vol = list(volume_vox_shape)[-dims:]
    step = [1] * dims
    for f in nc["downsample_factors"]:
        step = [a * b for a, b in zip(step, f)]

    def valid(cand):
        ishape = [a + b for a, b in zip(base_in, cand)]
        oshape = [a + b for a, b in zip(base_out, cand)]
        if any(o < 1 for o in oshape):
            return False
        try:
            got = compute_output_shape(model.unet_config, tuple(ishape))
        except ValueError:
            return False
        return list(got) == oshape

    for d in range(dims):
        while base_out[d] + inc[d] > vol[d]:
            cand = list(inc)
            cand[d] -= step[d]
            if not valid(cand):
                break
            inc = cand
    return inc


def tile_rois(total: Roi, tile_size: Coordinate, with_fresh: bool = False) -> list:
    """Cover ``total`` with full-sized tiles; edge tiles shift inward, so
    they overlap their neighbour (z-major order).

    ``with_fresh=True`` returns ``(tile, fresh)`` pairs, where ``fresh``
    is the part of the tile that no earlier tile covers: statistics summed
    over whole tiles would count the overlap twice."""
    per_dim = []
    for b, e, t in zip(total.begin, total.end, tile_size):
        starts = list(range(b, e - t + 1, t)) or [b]
        if starts[-1] + t < e:
            starts.append(e - t)
        prev_ends = [starts[0]] + [s + t for s in starts[:-1]]
        per_dim.append([(s, max(s, p), s + t) for s, p in zip(starts, prev_ends)])
    out = []
    for combo in itertools.product(*per_dim):
        tile = Roi(Coordinate(c[0] for c in combo), tile_size)
        if with_fresh:
            fresh = Roi(Coordinate(c[1] for c in combo), Coordinate(c[2] - c[1] for c in combo))
            out.append((tile, fresh))
        else:
            out.append(tile)
    return out


class Predictor:
    """Tiled, batched inference for one setup on one device.

    ``model`` holds the weights (``models.weights.load_params``); it is
    moved to ``device`` and cast to ``compute_dtype`` here, and a 2D setup
    stacks its sections in z (``stack_infer``)."""

    def __init__(
        self,
        model: Model,
        voxel_size,
        shape_increase: Optional[Sequence[int]] = None,
        batch_tiles: Optional[int] = None,
        device=None,
        compute_dtype=torch.bfloat16,
    ):
        self.device = resolve_device(device)
        self.voxel_size = Coordinate(voxel_size)
        nc = model.net_config
        inc = (
            list(shape_increase)
            if shape_increase is not None
            else list(nc.get("shape_increase", [0] * len(nc["input_shape"])))
        )
        in_shape = [a + b for a, b in zip(nc["input_shape"], inc)]
        out_shape = [a + b for a, b in zip(nc["output_shape"], inc)]
        if model.dims == 2:
            in_shape = [nc.get("adj_slices", 1), *in_shape]
            out_shape = [1, *out_shape]
        self.input_tile = tuple(in_shape)
        self.output_tile = tuple(out_shape)
        # the JAX package's default: a 2D section is small, so sections
        # batch (its knee on a TPU v5e was 32); a 3D tile runs alone
        self.batch_tiles = batch_tiles or (32 if model.dims == 2 else 1)
        self.input_size = Coordinate(self.input_tile) * self.voxel_size
        self.output_size = Coordinate(self.output_tile) * self.voxel_size
        self.context = (self.input_size - self.output_size) / 2
        model.stack_infer = model.dims == 2
        self._lane = Lane.adopt(model, self.device, compute_dtype)
        self.model = self._lane.model
        self._is_image = "raw" in nc.get("inputs", {"raw": {}})

    def forward(self, x) -> dict:
        """A batch of input tiles on the device (a 2D setup's: ``(B, adj, H,
        W, C)``) -> uint8 outputs per head, ``(B, *output_tile, C)``."""
        return forward_uint8(self.model, x, self._is_image)


    def predict(self, raw, outputs: Dict[str, Array], roi: Optional[Roi] = None) -> dict:
        """Run inference over ``roi`` (default: the outputs' ROI), writing
        into ``outputs``.  ``raw`` is one Array or a list whose channels are
        concatenated.  Returns tile count, seconds and ``voxels_per_sec``: the
        ROI's output voxels over the seconds, each voxel once however often
        it is computed."""
        inputs = raw if isinstance(raw, (list, tuple)) else [raw]
        total = roi if roi is not None else next(iter(outputs.values())).roi
        tiles = tile_rois(total, self.output_size)
        B = self.batch_tiles
        t0 = time.perf_counter()
        read_tile = make_tile_reader(inputs, self.context, self._is_image)
        writer = TileWriter(outputs, self.model.net_config["outputs"], self.voxel_size)

        def read_batch(batch):
            arrs = [read_tile(t) for t in batch]
            arrs += arrs[-1:] * (B - len(arrs))  # pad; the extra outputs are not written
            return np.stack(arrs)

        run_pipelined(
            [tiles[i : i + B] for i in range(0, len(tiles), B)],
            read=read_batch,
            dispatch=lambda arr: self._lane.run(arr, self.forward),
            drain=lambda batch, handle: writer.drain_batch(batch, fetch(handle)),
        )
        dt = time.perf_counter() - t0
        out_voxels = int(np.prod(Coordinate(total.shape) / self.voxel_size))
        return {"tiles": len(tiles), "seconds": dt, "voxels_per_sec": out_voxels / dt}


def prepare_prediction_outputs(
    container: str,
    model: Model,
    roi: Roi,
    voxel_size,
    predictor,
    dataset_prefix: str = "",
) -> Dict[str, Array]:
    """Create uint8 output Zarrs for each model output over ``roi``, chunked
    to the predictor's ``chunk_tile`` where it has one (a z stream's write
    grid), else to its output tile, so that no write straddles a chunk."""
    vs = Coordinate(voxel_size)
    out = {}
    vox_shape = tuple(Coordinate(roi.shape) / vs)
    for name, ocfg in model.net_config["outputs"].items():
        dims = head_dims(ocfg)
        ds_name = f"{dataset_prefix}{name}" if dataset_prefix else name
        out[name] = prepare_ds(
            f"{container}/{ds_name}",
            shape=(dims, *vox_shape),
            offset=roi.offset,
            voxel_size=vs,
            dtype=np.uint8,
            chunk_shape=(dims, *getattr(predictor, "chunk_tile", predictor.output_tile)),
        )
    return out
