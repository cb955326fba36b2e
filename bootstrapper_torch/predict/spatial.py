"""Multi-device prediction with one tile split over the devices (the JAX
package's ``predict/spatial.py``).

``sharded.ShardedPredictor`` gives each device a whole tile: it scales
throughput but not memory.  This predictor splits one tile's extent along
one spatial axis instead:

- the input tile, padded to ``c_in * n`` rows along the axis, goes to the
  devices in equal slabs of ``c_in`` rows, device ``k`` receiving its own
  rows ``[k * c_in, (k + 1) * c_in)`` from the host as uint8;
- each device gets its halos from its neighbours as ``m_l`` leftward and
  ``m_r`` rightward whole-slab hops, device-to-device copies made on the
  receiving device's stream (the JAX package's ``lax.ppermute`` hops); a
  device past the edge receives zeros, which no slice reads;
- each device cuts its receptive field, ``own + 2 * context`` rows from
  global row ``k * own``, runs the usual forward and returns its ``own``
  output rows.

Valid convs are translation-equivariant, so a slab's output equals the
forward of a tile the slab's size at that place; against the whole tile's
forward it differs only within the trilinear upsample's reach of a slab
seam, where the upsample clamps at the slab's edge.  Each device's working
set is that of a ``1/n + halo`` slab.  The axis picked is the one with the
least redundant halo compute, ``2 * context / own``.

Devices are a list that may name one device more than once (a logical
device each: its own replica, stream and buffers); what moves between two
of them is copied, also on one card.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import resolve_devices
from ..core.arrays import Array
from ..core.geometry import Coordinate, Roi
from ..models.model import Model, unet_config
from ..models.unet import compute_output_shape
from ._pipeline import Lane, TileWriter, fetch, launches_now, make_tile_reader, run_pipelined
from .scan import forward_uint8, tile_rois


def slab_is_valid(unet_cfg, in_tile, out_tile, d: int, n_dev: int) -> bool:
    """A device's slab (own output rows + full context) must itself be a
    valid input to the net along axis ``d``: output extents move on the
    downsample-factor lattice, so ``own`` must keep the slab's input
    length conv/pool-compatible."""
    own = out_tile[d] // n_dev
    ctx = (in_tile[d] - out_tile[d]) // 2
    slab = list(in_tile)
    slab[d] = own + 2 * ctx
    try:
        produced = compute_output_shape(unet_cfg, slab)
    except Exception:
        return False
    expect = list(out_tile)
    expect[d] = own
    return list(produced) == expect


def pick_shard_axis(out_tile: Sequence[int], context: Sequence[int],
                    n_dev: int, unet_cfg=None,
                    in_tile: Optional[Sequence[int]] = None) -> int:
    """Axis with the least halo overhead: maximise own_slab / context
    among axes whose output extent splits evenly into valid slabs."""
    best, best_cost = None, None
    for d in range(len(out_tile)):
        if out_tile[d] % n_dev:
            continue
        own = out_tile[d] // n_dev
        if own < 1:
            continue
        if unet_cfg is not None and not slab_is_valid(
            unet_cfg, in_tile, out_tile, d, n_dev
        ):
            continue
        cost = (2 * context[d]) / own  # redundant fraction
        if best_cost is None or cost < best_cost:
            best, best_cost = d, cost
    if best is None:
        raise ValueError(
            f"no output axis of {tuple(out_tile)} divides into {n_dev} "
            "valid slabs; adjust shape_increase (slab outputs must land "
            "on the net's downsample lattice)"
        )
    return best


def spatial_shape_increase(nc: dict, n_dev: int,
                           vol_shape: Optional[Sequence[int]] = None):
    """shape_increase growing the net's default tile so one axis splits
    into ``n_dev`` valid slabs (used when ``--sharded spatial`` is given
    without an explicit tile).

    Picks the axis with the least halo overhead whose grown extent still
    fits the volume; each device's output slab is at least the net's
    default output extent rounded up to the downsample lattice."""
    from math import ceil, prod

    in0, out0 = list(nc["input_shape"]), list(nc["output_shape"])
    ctx = [(i - o) // 2 for i, o in zip(in0, out0)]
    dims = len(in0)
    steps = [
        prod(f[d] for f in nc["downsample_factors"]) for d in range(dims)
    ]
    cfg = unet_config(nc)
    best = None
    for d in range(dims):
        own = steps[d] * ceil(max(out0[d], 2 * ctx[d]) / steps[d])
        for _ in range(8):  # bump until the slab is lattice-valid
            inc = [0] * dims
            inc[d] = n_dev * own - out0[d]
            in_tile = [a + b for a, b in zip(in0, inc)]
            out_tile = [a + b for a, b in zip(out0, inc)]
            if inc[d] >= 0 and slab_is_valid(
                cfg, in_tile, out_tile, d, n_dev
            ):
                break
            own += steps[d]
        else:
            continue
        if vol_shape is not None and out_tile[d] > vol_shape[d]:
            continue
        cost = 2 * ctx[d] / own
        if best is None or cost < best[0]:
            best = (cost, inc)
    if best is None:
        raise ValueError(
            f"cannot grow tile {tuple(out0)} into {n_dev} valid slabs "
            f"within volume {vol_shape}; use fewer devices or pass "
            "shape_increase explicitly"
        )
    return best[1]


class SpatialShardedPredictor:
    """Tiled inference with each tile's extent split over the devices, halos
    exchanged between neighbours (module docstring)."""

    def __init__(
        self,
        model: Model,
        voxel_size,
        devices=None,
        shape_increase: Optional[Sequence[int]] = None,
        shard_axis: Optional[int] = None,
        compute_dtype=torch.bfloat16,
    ):
        if model.dims != 3:
            raise ValueError(
                "spatial sharding targets 3D volumes; 2D setups use the "
                "batch-sharded predictor"
            )
        self.voxel_size = Coordinate(voxel_size)
        devices = resolve_devices(devices)
        self.n_dev = n = len(devices)

        nc = model.net_config
        inc = list(shape_increase) if shape_increase is not None else list(
            nc.get("shape_increase", [0] * len(nc["input_shape"]))
        )
        self.in_tile = tuple(a + b for a, b in zip(nc["input_shape"], inc))
        self.out_tile = tuple(a + b for a, b in zip(nc["output_shape"], inc))
        self.input_size = Coordinate(self.in_tile) * self.voxel_size
        self.output_size = Coordinate(self.out_tile) * self.voxel_size
        self.context = (self.input_size - self.output_size) / 2
        ctx_vox = tuple((i - o) // 2 for i, o in zip(self.in_tile, self.out_tile))

        d = shard_axis if shard_axis is not None else pick_shard_axis(
            self.out_tile, ctx_vox, n, unet_cfg=model.unet_config, in_tile=self.in_tile
        )
        if self.out_tile[d] % n:
            raise ValueError(
                f"output extent {self.out_tile[d]} along axis {d} not "
                f"divisible into {n} slabs"
            )
        if not slab_is_valid(model.unet_config, self.in_tile, self.out_tile, d, n):
            raise ValueError(
                f"slab along axis {d} is not a valid net input "
                f"(own={self.out_tile[d] // n} rows must land on the "
                "downsample lattice); adjust shape_increase"
            )
        self.shard_axis = d
        self.own_out = own = self.out_tile[d] // n
        # equal input slabs (padded to divisibility)
        self.c_in = c_in = math.ceil(self.in_tile[d] / n)
        self.in_padded = c_in * n
        self.slab_rows = own + 2 * ctx_vox[d]  # the rows each device needs
        # device k needs global rows [k*own, k*own + slab_rows) of the input
        # and holds [k*c_in, (k+1)*c_in); the overlap with its neighbours may
        # span more than one slab, so halos travel as whole-slab hops
        h_l = (n - 1) * (c_in - own)
        h_r = max(0, self.slab_rows - c_in)
        self.halo = (h_l, h_r)
        self.hops = (-(-h_l // c_in), -(-h_r // c_in))
        self.net_config = nc
        self.lanes = [Lane(model, d, compute_dtype) for d in devices]
        self._is_image = "raw" in nc.get("inputs", {"raw": {}})
        #: bytes copied between devices for halos, and the conv kernel's
        #: launches per device, since construction
        self.halo_bytes = 0
        self.launches_by_device = [0] * n

    @property
    def input_tile(self):
        """Alias matching Predictor's naming (used by output chunking)."""
        return self.in_tile

    @property
    def output_tile(self):
        return self.out_tile

    def read_tile(self, inputs, write_roi: Roi) -> np.ndarray:
        """The host input of one tile, edge-padded along the shard axis to
        ``c_in * n`` rows (rows no slab reads)."""
        x = make_tile_reader(inputs, self.context, self._is_image)(write_roi)
        pad = self.in_padded - x.shape[self.shard_axis]
        if pad:
            widths = [(0, 0)] * x.ndim
            widths[self.shard_axis] = (0, pad)
            x = np.pad(x, widths, mode="edge")
        return x

    def dispatch(self, x: np.ndarray) -> list:
        """Queue one padded tile ``(*in_padded tile, C)`` over the devices:
        own rows up, the halo hops, each device's forward, its outputs down.
        Returns one download handle per device (``_pipeline.fetch``): device
        ``k``'s ``own`` output rows along the shard axis."""
        n, c_in, ax = self.n_dev, self.c_in, self.shard_axis
        (m_l, m_r), lanes = self.hops, self.lanes
        own = [
            lane.upload(np.ascontiguousarray(np.take(x, range(k * c_in, (k + 1) * c_in), axis=ax))[None])
            for k, lane in enumerate(lanes)
        ]
        parts = [[t] for t in own]
        for step, m in ((-1, m_l), (1, m_r)):
            cur = own
            for _ in range(m):
                # hop: device k receives what device k + step held (slab
                # k + j * step after j hops); past the edge, zeros
                nxt = []
                for k, lane in enumerate(lanes):
                    src = k + step
                    if 0 <= src < n:
                        nxt.append(lane.receive(cur[src], lanes[src]))
                        self.halo_bytes += cur[src].numel() * cur[src].element_size()
                    else:
                        with lane.on_stream():
                            nxt.append(torch.zeros_like(cur[k]))
                cur = nxt
                for k in range(n):
                    if step < 0:
                        parts[k].insert(0, cur[k])
                    else:
                        parts[k].append(cur[k])
        handles = []
        for k, lane in enumerate(lanes):
            n0 = launches_now()
            with lane.on_stream():
                ext = torch.cat(parts[k], dim=1 + ax) if len(parts[k]) > 1 else parts[k][0]
                # ext covers global rows [(k - m_l) * c_in, (k + m_r + 1) * c_in);
                # this device's receptive field starts at global row k * own
                start = k * self.own_out - k * c_in + m_l * c_in
                slab = ext.narrow(1 + ax, start, self.slab_rows)
                outs = forward_uint8(lane.model, slab, self._is_image)
            handles.append(lane.download(outs))
            self.launches_by_device[k] += launches_now() - n0
        return handles

    def gather(self, handles) -> Dict[str, np.ndarray]:
        """Wait for ``dispatch``'s handles; the whole tile's outputs, the
        devices' rows concatenated along the shard axis."""
        got = [fetch(h) for h in handles]
        return {k: np.concatenate([g[k] for g in got], axis=1 + self.shard_axis) for k in got[0]}

    def predict(self, raw, outputs: Dict[str, Array], roi: Optional[Roi] = None) -> dict:
        """Run inference over ``roi`` (default: the outputs' ROI), writing
        into ``outputs``; one tile at a time, each split over the devices.
        Returns tiles, devices, the shard axis, the halo rows, the halo bytes
        copied, seconds, the ROI's output voxels/s and the conv kernel's launches per
        device."""
        inputs = raw if isinstance(raw, (list, tuple)) else [raw]
        total = roi if roi is not None else next(iter(outputs.values())).roi
        tiles = tile_rois(total, self.output_size)
        t0 = time.perf_counter()
        halo0, launches0 = self.halo_bytes, list(self.launches_by_device)
        writer = TileWriter(outputs, self.net_config["outputs"], self.voxel_size)
        run_pipelined(
            tiles,
            read=lambda wroi: self.read_tile(inputs, wroi),
            dispatch=self.dispatch,
            drain=lambda wroi, handles: writer.drain_batch([wroi], self.gather(handles)),
        )
        dt = time.perf_counter() - t0
        out_voxels = int(np.prod(Coordinate(total.shape) / self.voxel_size))
        return {
            "tiles": len(tiles),
            "devices": self.n_dev,
            "shard_axis": self.shard_axis,
            "halo": self.halo,
            "halo_bytes": self.halo_bytes - halo0,
            "seconds": dt,
            "voxels_per_sec": out_voxels / dt,
            "launches_by_device": [a - b for a, b in zip(self.launches_by_device, launches0)],
        }
