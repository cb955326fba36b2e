"""Multi-device prediction with the tile batch split over the devices (the
JAX package's ``predict/sharded.py``).

Each step reads ``n_dev`` tiles and runs tile ``i`` on device ``i``, each
device with its own replica of the model; the last batch is padded with
copies of its last tile, whose outputs are not written.  No data moves
between devices, and each tile's forward is the one-device
``scan.Predictor``'s at the same tile, so the per-tile results are the
same.  2D setups run as stacked sections, one section a device.

The devices are a list (``resolve_devices``) that may name one device more
than once: each entry is a logical device with its own replica, stream and
buffers.  All of them are driven from one host thread: a step queues every
device's tile before it waits for any of them.  Under ``BS_INT8=1`` each
device's forward is queued from a thread of its own, and the devices share
every int8 activation scale (``_pipeline.dispatch_lanes``): the JAX
package's scales, one per conv-pass input over the batch of all devices.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import resolve_devices
from ..core.arrays import Array
from ..core.geometry import Coordinate, Roi
from ..models.model import Model
from ._pipeline import Lane, TileWriter, dispatch_lanes, fetch, make_tile_reader, run_pipelined
from .scan import forward_uint8, tile_rois


class ShardedPredictor:
    """Tiled inference with each step's batch of tiles one per device.

    ``model`` holds the weights; every device entry of ``devices`` (default:
    every visible card) gets its own replica in ``compute_dtype``."""

    def __init__(
        self,
        model: Model,
        voxel_size,
        devices=None,
        shape_increase: Optional[Sequence[int]] = None,
        compute_dtype=torch.bfloat16,
    ):
        self.voxel_size = Coordinate(voxel_size)
        nc = model.net_config
        inc = list(shape_increase) if shape_increase is not None else list(
            nc.get("shape_increase", [0] * len(nc["input_shape"]))
        )
        in_shape = [a + b for a, b in zip(nc["input_shape"], inc)]
        out_shape = [a + b for a, b in zip(nc["output_shape"], inc)]
        if model.dims == 2:
            in_shape = [nc.get("adj_slices", 1), *in_shape]
            out_shape = [1, *out_shape]
        self.input_tile = tuple(in_shape)
        self.output_tile = tuple(out_shape)
        self.input_size = Coordinate(self.input_tile) * self.voxel_size
        self.output_size = Coordinate(self.output_tile) * self.voxel_size
        self.context = (self.input_size - self.output_size) / 2
        model.stack_infer = model.dims == 2
        self.net_config = nc
        self.lanes = [Lane(model, d, compute_dtype) for d in resolve_devices(devices)]
        self.n_dev = len(self.lanes)
        self._is_image = "raw" in nc.get("inputs", {"raw": {}})

    def predict(self, raw, outputs: Dict[str, Array], roi: Optional[Roi] = None) -> dict:
        """Run inference over ``roi`` (default: the outputs' ROI), writing
        into ``outputs``.  Returns tiles, devices, seconds, the ROI's output
        voxels/s and the conv kernel's launches per device."""
        inputs = raw if isinstance(raw, (list, tuple)) else [raw]
        total = roi if roi is not None else next(iter(outputs.values())).roi
        tiles = tile_rois(total, self.output_size)
        B = self.n_dev
        t0 = time.perf_counter()
        read_tile = make_tile_reader(inputs, self.context, self._is_image)
        writer = TileWriter(outputs, self.net_config["outputs"], self.voxel_size)
        launches = [0] * B

        def read_batch(batch):
            arrs = [read_tile(t)[None] for t in batch]
            return arrs + arrs[-1:] * (B - len(arrs))  # pad; the extras are not written

        def dispatch(arrs):
            fns = [lambda x, m=lane.model: forward_uint8(m, x, self._is_image) for lane in self.lanes]
            return dispatch_lanes(self.lanes, arrs, fns, launches)

        def drain(batch, handles):
            for wroi, handle in zip(batch, handles):
                writer.drain_batch([wroi], fetch(handle))

        run_pipelined(
            [tiles[i : i + B] for i in range(0, len(tiles), B)], read=read_batch, dispatch=dispatch, drain=drain
        )
        dt = time.perf_counter() - t0
        out_voxels = int(np.prod(Coordinate(total.shape) / self.voxel_size))
        return {
            "tiles": len(tiles), "devices": B, "seconds": dt, "voxels_per_sec": out_voxels / dt,
            "launches_by_device": launches,
        }
