"""Training loop: state, step, checkpoints (the JAX package's
``train/loop.py`` on one device).

- Adam as ``optax.adam`` sets it up: betas 0.9/0.999, eps 1e-8 added
  outside the square root, bias-corrected moments (torch's Adam computes
  the same update).  fp32 parameters; the model's convs run in its
  ``compute_dtype``.
- loss: the masked weighted MSE summed over the output heads, on the
  targets centre-cropped to the predictions.
- checkpoints: ``model_checkpoint_{step}`` npz files in the JAX layout,
  ``params/<path>``, ``step`` and optax's state as flat leaves
  ``opt/0000...`` (``models/weights.py``), so that either package resumes
  the other's training.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import pickle
import socket
import tempfile
from datetime import timedelta
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..models.model import Model, multi_output_loss
from ..models.unet import compute_output_shape
from ..utils.profiling import span
from ..models.weights import (
    init_params_numpy,
    latest_checkpoint,
    load_params,
    opt_leaves_from_jax,
    opt_leaves_to_jax,
    params_to_jax,
)
from ..models.weights import load_checkpoint as load_params_tree

logger = logging.getLogger(__name__)

__all__ = [
    "TrainState", "create_train_state", "make_train_step", "loss_fn", "save_checkpoint",
    "load_checkpoint", "latest_checkpoint", "make_mesh", "mesh_backend", "MeshRank", "init_mesh",
    "spawn_mesh", "MeshWindow", "mesh_windows", "seam_margin", "rank_slab", "slab_counts", "broadcast_state",
    "broadcast_batch", "shard_train_step",
]


@dataclasses.dataclass
class TrainState:
    """``step`` (updates so far), the model (its parameters) and the
    optimizer (its state): the JAX ``TrainState(step, params, opt_state)``."""

    step: int
    model: Model
    optimizer: torch.optim.Adam


def make_optimizer(model: Model, learning_rate: float) -> torch.optim.Adam:
    # not fused: fused Adam updates parameters without bumping their
    # version, and Conv.packed keys the kernel's packed weights on it
    return torch.optim.Adam(
        model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, fused=False
    )


def create_train_state(model: Model, seed: int = 0, learning_rate: float = 1e-4) -> TrainState:
    """Random parameters from ``seed`` (numpy; ``jax.random`` gives other
    numbers) and a fresh Adam."""
    load_params(model, init_params_numpy(model.net_config, seed))
    return TrainState(0, model, make_optimizer(model, learning_rate))


def _center_crop_like(x, ref):
    if x.shape == ref.shape:
        return x
    slices = [slice(None)]
    for s, t in zip(x.shape[1:-1], ref.shape[1:-1]):
        o = (s - t) // 2
        slices.append(slice(o, o + t))
    slices.append(slice(None))
    return x[tuple(slices)]


def loss_fn(model: Model, batch: dict, counts: Optional[dict] = None):
    """The loss of ``batch`` (``{"input", "targets", "weights"}``, and, for
    a mesh rank's window, ``keep``: the ``(offset, rows)`` of the outputs'
    first spatial axis that the loss takes, ``rank_slab``); ``counts``:
    each output's normaliser, where not the batch's own
    (``models.model.weighted_mse_loss``)."""
    preds = model(batch["input"])
    if "keep" in batch:
        preds = {k: v.narrow(1, *batch["keep"]) for k, v in preds.items()}
    targets = {k: _center_crop_like(batch["targets"][k], preds[k]) for k in preds}
    weights = {k: _center_crop_like(batch["weights"][k], preds[k]) for k in preds}
    return multi_output_loss(preds, targets, weights, counts)


def make_train_step() -> Callable:
    """The step: ``(state, batch) -> (state, {"loss": loss})``: forward,
    backward, one Adam update.  The loss stays on the device (reading it
    waits for the card).  Spans: ``bs.train.step``, and in it
    ``bs.train.forward``, ``bs.train.backward`` and ``bs.train.optimizer``
    (Adam's update).  The gradients are set to None before the forward,
    which queues no device work, and stay on the parameters after the
    step."""

    def step(state: TrainState, batch: dict):
        with span("bs.train.step"):
            state.optimizer.zero_grad(set_to_none=True)
            with span("bs.train.forward"):
                loss = loss_fn(state.model, batch)
            with span("bs.train.backward"):
                loss.backward()
            with span("bs.train.optimizer"):
                state.optimizer.step()
            state.step += 1
            return state, {"loss": loss.detach()}

    return step


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int) -> str:
    """Write ``<ckpt_dir>/model_checkpoint_{step}`` in the JAX layout."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"model_checkpoint_{step}")
    arrays = {f"params/{k}": v for k, v in params_to_jax(state.model).items()}
    for i, leaf in enumerate(opt_leaves_to_jax(state.model, state.optimizer)):
        arrays[f"opt/{i:04d}"] = leaf
    arrays["step"] = np.asarray(int(state.step))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, state: TrainState) -> TrainState:
    """Restore a checkpoint of either package into ``state``: parameters,
    step and, where the file's optimizer leaves fit the model, Adam's state.
    Leaves that do not fit leave a fresh Adam, as the JAX loader does
    (with a warning here)."""
    load_params(state.model, load_params_tree(path))
    with np.load(path) as data:
        saved = sorted(k for k in data.files if k.startswith("opt/"))
        leaves = [data[k] for k in saved]
        step = int(data["step"])
    state.optimizer.state.clear()
    try:
        opt_leaves_from_jax(state.model, state.optimizer, leaves)
    except ValueError as e:
        logger.warning("%s: optimizer state not restored (%s); Adam starts afresh", path, e)
        state.optimizer.state.clear()
    state.step = step
    return state



# ---------------------------------------------------------------------------
# mesh training: one process per device entry, over torch.distributed
# ---------------------------------------------------------------------------


def make_mesh(
    n_devices: Optional[int] = None,
    data: Optional[int] = None,
    batch_size: Optional[int] = None,
    spatial: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> list:
    """A ``(data, space)`` grid of device entries (``devices``, default
    ``resolve_devices()``), factorised as the JAX package's ``make_mesh``:

    the data axis must divide the global ``batch_size`` and the space axis
    the leading spatial extent (``spatial``: the gcd of the input's and the
    output's); as many devices as those allow are used, data parallelism
    (no halos) first, and devices that cannot be used evenly are left out
    with a warning.  Without ``batch_size`` and ``spatial`` the balanced
    split is kept (factors of two shared between the axes, at least 2 data).
    Returns ``data`` rows of ``space`` device entries each."""
    if devices is None:
        from .. import resolve_devices

        devices = resolve_devices(None)
    devices = list(devices)
    n = n_devices or len(devices)
    if data is not None:
        space = n // data
    elif batch_size is None and spatial is None:
        data = n
        space = 1
        while data % 2 == 0 and data > 2:
            data //= 2
            space *= 2
    else:
        b = batch_size or 1
        best = (0, 0, 0)  # (devices used, data, space)
        for d in range(1, n + 1):
            if b % d:
                continue
            s = n // d
            while s > 1 and spatial is not None and spatial % s:
                s -= 1
            best = max(best, (d * s, d, s))
        _, data, space = best
        if data * space < n:
            logger.warning(
                "mesh uses %d of %d devices: batch %s / spatial %s "
                "constrain the factorisation to (%d data, %d space)",
                data * space, n, batch_size, spatial, data, space,
            )
    return [devices[d * space : (d + 1) * space] for d in range(data)]


def mesh_backend(devices: Sequence) -> str:
    """The collective backend for a list of device entries, chosen before
    any launch: NCCL when every entry is a distinct CUDA device, gloo when
    the entries are CPUs or a CUDA device repeats (NCCL refuses two ranks
    on one card; gloo's all_reduce and broadcast take CUDA tensors)."""
    devs = [torch.device(d) for d in devices]
    cuda = [d for d in devs if d.type == "cuda"]
    if len(cuda) == len(devs) and len({d.index for d in cuda}) == len(cuda) and None not in {d.index for d in cuda}:
        return "nccl"
    return "gloo"


@dataclasses.dataclass
class MeshRank:
    """One rank of a ``(data, space)`` grid: ``rank = d * space + s``.
    ``group`` is the process group of its data group (its ``space`` ranks,
    which share one share of the batch), None where ``space`` is 1."""

    rank: int
    grid: list
    backend: str
    group: object = None

    @property
    def data(self) -> int:
        return len(self.grid)

    @property
    def space(self) -> int:
        return len(self.grid[0])

    @property
    def world(self) -> int:
        return self.data * self.space

    @property
    def coords(self) -> tuple:
        return divmod(self.rank, self.space)

    @property
    def leader(self) -> int:
        """The global rank that draws this rank's data group's batch."""
        return self.coords[0] * self.space

    @property
    def device(self) -> torch.device:
        d, s = self.coords
        return torch.device(self.grid[d][s])


def init_mesh(grid: list, rank: int, backend: str, init_method: str) -> MeshRank:
    """Join the process group of ``grid`` as ``rank`` and make each data
    group's subgroup (every rank makes every group, in one order)."""
    import torch.distributed as dist

    mesh = MeshRank(rank, [list(map(str, row)) for row in grid], backend)
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)
    dist.init_process_group(
        backend, init_method=init_method, world_size=mesh.world, rank=rank, timeout=timedelta(minutes=30)
    )
    if mesh.space > 1:
        for d in range(mesh.data):
            g = dist.new_group(list(range(d * mesh.space, (d + 1) * mesh.space)))
            if d == mesh.coords[0]:
                mesh.group = g
    return mesh


def free_port() -> int:
    """A free TCP port on ``localhost`` (for a process group's address)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _mesh_worker(rank: int, fn, grid, backend, init_method, args, result_path):
    import torch.distributed as dist

    mesh = init_mesh(grid, rank, backend, init_method)
    try:
        out = fn(mesh, *args)
        if rank == 0:
            with open(result_path, "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn_mesh(fn, grid: list, args: tuple = ()):
    """Run ``fn(mesh, *args)`` in one spawned process per device entry of
    ``grid``, each rank joined to a process group on ``localhost`` over
    ``mesh_backend``'s choice, logged before the launch.  ``fn`` must be
    importable (a module-level function).  Returns rank 0's result, which
    it pickles into a file this call reads back; a rank that fails makes
    the call raise, and the others are stopped."""
    import torch.multiprocessing as mp

    entries = [d for row in grid for d in row]
    backend = mesh_backend(entries)
    logger.info("mesh of %d ranks over %s", len(entries), backend)
    init_method = f"tcp://localhost:{free_port()}"
    with tempfile.TemporaryDirectory(prefix="bs_mesh_") as tmp:
        result_path = os.path.join(tmp, "rank0.pkl")
        mp.start_processes(
            _mesh_worker,
            args=(fn, [list(map(str, row)) for row in grid], backend, init_method, args, result_path),
            nprocs=len(entries), join=True, start_method="spawn",
        )
        with open(result_path, "rb") as f:
            return pickle.load(f)


@dataclasses.dataclass(frozen=True)
class MeshWindow:
    """What one space rank computes along the net's first spatial axis (z of
    a 3D net, y of a 2D one): the output rows ``[start, start + rows)`` of
    the whole training tile's output, from its input rows ``[start, start +
    rows + context)`` (``context``: input rows less output rows), of which
    it keeps its own ``own_rows`` rows from ``own`` on."""

    start: int
    rows: int
    own: int
    own_rows: int


def _edge_reach(unet_cfg, n_in: int) -> tuple:
    """``(output rows, reach at the start, reach at the end)`` of the net
    along its first spatial axis for ``n_in`` input rows: the output rows,
    counted from each end, that the resampling upsample's clamp at the
    input's edge reaches.  ``align_corners=False`` linear resampling by
    ``f`` clamps the ``f // 2`` outer rows and spreads ``d`` rows that
    differ into ``f * d + f // 2``; a transposed upsample spreads them into
    ``f * d`` and clamps nothing; each valid conv keeps the count from its
    own edge; a centre crop removes its rows.  Raises ``ValueError`` where
    ``n_in`` is no valid input length."""
    L = unet_cfg.num_levels

    def convs(n, kernels):
        n -= sum(k[0] - 1 for k in kernels)
        if n <= 0:
            raise ValueError("input too small")
        return n

    def rec(level, n):
        i = L - level - 1
        n = convs(n, unet_cfg.kernel_size_down[i])
        if level == 0:
            return n, 0, 0
        f = unet_cfg.downsample_factors[i][0]
        if n % f:
            raise ValueError(f"{n} rows not divisible by {f}")
        m, rs, re = rec(level - 1, n // f)
        up = m * f
        if unet_cfg.constant_upsample:
            rs, re = f * rs + f // 2, f * re + f // 2
        else:
            rs, re = f * rs, f * re
        cc = sum(k[0] - 1 for k in unet_cfg.kernel_size_up[i])
        fc = unet_cfg.crop_factors[i][0]
        t = ((up - cc) // fc) * fc + cc
        off = (up - t) // 2
        return convs(t, unet_cfg.kernel_size_up[i]), max(0, rs - off), max(0, re - (up - t - off))

    return rec(L - 1, n_in)


def seam_margin(unet_cfg, in_rows: int) -> int:
    """Output rows next to a window's inner edge that differ from the whole
    tile's (``_edge_reach`` of an ``in_rows`` input): 5 for the 2D setups
    at their (196, 196) tile, 0 for a net that never resamples its first
    axis or upsamples by transposed convs."""
    _, rs, re = _edge_reach(unet_cfg, in_rows)
    return max(rs, re)


def mesh_windows(unet_cfg, in_tile, out_tile, space: int) -> list:
    """Each space rank's ``MeshWindow`` of a training tile ``in_tile ->
    out_tile`` split ``space`` ways along the net's first spatial axis.

    Rank ``s`` owns the output rows ``[s * own, (s + 1) * own)``, ``own =
    out // space``.  Its window starts on the pooling lattice (a multiple
    of the axis's downsample factors' product from the tile's origin), has
    a valid input length, reaches the tile's own edges where it meets them
    (so the tile's edge effects are reproduced), and reaches past every
    inner seam far enough that the upsample's clamp at its edge
    (``_edge_reach``) misses the rank's own rows: its own rows are then the
    whole tile's.  A net that never pools the axis gets the plain slabs
    (own rows plus the context).  Raises only where the space axis does not
    divide the axis's input and output (``make_mesh`` never factorises so)."""
    n_in, n_out = int(in_tile[0]), int(out_tile[0])
    if n_in % space or n_out % space:
        raise ValueError(
            f"a space axis of {space} does not divide the training tile's first axis "
            f"({n_in} -> {n_out}); make_mesh factorises it only by a divisor of both"
        )
    ctx = n_in - n_out
    lattice = 1
    for f in unet_cfg.downsample_factors:
        lattice *= f[0]

    def reach(rows):
        try:
            got, rs, re = _edge_reach(unet_cfg, rows + ctx)
        except ValueError:
            return None
        return (rs, re) if got == rows else None

    own = n_out // space
    windows = []
    for s in range(space):
        a, b = s * own, (s + 1) * own
        start, need = a - a % lattice, b
        while True:
            rows = next((r for r in range(need - start, n_out - start + 1) if reach(r) is not None), None)
            if rows is None:  # no valid length from here: start a lattice step earlier
                start -= lattice
                continue
            rs, re = reach(rows)
            if start > 0 and a - start < rs:
                start = max(0, start - lattice)
            elif start + rows < n_out and start + rows - b < re:
                need = start + rows + 1
            else:
                break
        windows.append(MeshWindow(start, rows, a - start, own))
    return windows


def _state_tensors(state: TrainState) -> list:
    """Parameters, then each parameter's Adam moments, in one order."""
    out = [p.data for p in state.model.parameters()]
    for p in state.model.parameters():
        st = state.optimizer.state.get(p)
        if st:
            out += [st["exp_avg"], st["exp_avg_sq"]]
    return out


def broadcast_state(state: TrainState, mesh: MeshRank) -> TrainState:
    """Rank 0's parameters, Adam state and step on every rank."""
    import torch.distributed as dist

    params = list(state.model.parameters())
    meta = [state.step, [int(state.optimizer.state[p]["step"]) if p in state.optimizer.state else None for p in params]]
    dist.broadcast_object_list(meta, src=0)
    state.step, steps = meta
    for p, step in zip(params, steps):
        if step is None:
            state.optimizer.state.pop(p, None)
            continue
        st = state.optimizer.state[p]
        if "exp_avg" not in st:
            st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        st["step"] = torch.tensor(float(step))
    for t in _state_tensors(state):
        dist.broadcast(t, src=0)
    return state


def broadcast_batch(batch: Optional[dict], mesh: MeshRank) -> dict:
    """The data group leader's batch on each of its space ranks (``batch``
    is the leader's; the others pass None)."""
    import torch.distributed as dist

    if mesh.space == 1:
        return batch
    leader = mesh.rank == mesh.leader
    keys = [("input", None)] + [(part, k) for part in ("targets", "weights") for k in sorted(batch[part])] if leader else None
    meta = [[(key, tuple(_get(batch, key).shape), _get(batch, key).dtype) for key in keys] if leader else None]
    dist.broadcast_object_list(meta, src=mesh.leader, group=mesh.group)
    out: dict = {"targets": {}, "weights": {}}
    for key, shape, dtype in meta[0]:
        t = _get(batch, key).contiguous() if leader else torch.empty(shape, dtype=dtype, device=mesh.device)
        dist.broadcast(t, src=mesh.leader, group=mesh.group)
        if key[1] is None:
            out["input"] = t
        else:
            out[key[0]][key[1]] = t
    return out


def _get(batch: dict, key: tuple):
    return batch[key[0]] if key[1] is None else batch[key[0]][key[1]]


def rank_slab(batch: dict, unet_cfg, dims: int, space: int, s: int) -> dict:
    """Space rank ``s``'s share of its data group's batch along the net's
    first spatial axis: the input rows of its window (``mesh_windows``),
    and its own output rows of the targets and weights (centre-cropped to
    the net's output first); ``keep`` says which rows of the window's
    output those are (``loss_fn``)."""
    x = batch["input"]
    ax = x.dim() - 1 - dims
    spatial = tuple(x.shape[ax:-1])
    out_shape = compute_output_shape(unet_cfg, spatial)
    win = mesh_windows(unet_cfg, spatial, out_shape, space)[s]
    slab = {
        "input": x.narrow(ax, win.start, win.rows + spatial[0] - out_shape[0]),
        "targets": {}, "weights": {}, "keep": (win.own, win.own_rows),
    }
    for part in ("targets", "weights"):
        for k, t in batch[part].items():
            t = _crop_spatial(t, out_shape)
            slab[part][k] = t.narrow(t.dim() - 1 - dims, win.start + win.own, win.own_rows)
    return slab


def slab_counts(slab: dict) -> torch.Tensor:
    """Each output's count of ``weights > 0`` in ``slab``, by sorted name."""
    return torch.stack([torch.count_nonzero(slab["weights"][k] > 0) for k in sorted(slab["weights"])]).float()


def shard_train_step(mesh: MeshRank, unet_cfg, dims: int) -> Callable:
    """The sharded step of ``mesh``'s rank: ``(state, group_batch) ->
    (state, {"loss": loss})``, ``group_batch`` being its data group's share
    of the batch (``broadcast_batch``).  The rank runs its window
    (``rank_slab``), takes its loss over its own output rows and the whole
    batch's count of ``weights > 0`` (the ranks' counts summed), sums the
    gradients over all ranks, and takes the same Adam step as every other
    rank.  The loss returned is the ranks' sum: the one-device loss, as the
    ranks' own rows are the rows of the whole output, each computed as the
    whole tile computes it (``mesh_windows``)."""
    import torch.distributed as dist

    _, s = mesh.coords

    def step(state: TrainState, batch: dict):
        slab = rank_slab(batch, unet_cfg, dims, mesh.space, s)
        counts = slab_counts(slab)
        dist.all_reduce(counts)
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.model, slab, dict(zip(sorted(slab["weights"]), counts)))
        loss.backward()
        grads = [p.grad for p in state.model.parameters()]
        flat = torch._utils._flatten_dense_tensors(grads)
        dist.all_reduce(flat)
        for g, r in zip(grads, torch._utils._unflatten_dense_tensors(flat, grads)):
            g.copy_(r)
        state.optimizer.step()
        state.step += 1
        loss = loss.detach().reshape(1).clone()
        dist.all_reduce(loss)
        return state, {"loss": loss[0]}

    return step


def _crop_spatial(t: torch.Tensor, out_shape) -> torch.Tensor:
    """Centre-crop the last ``len(out_shape)`` spatial axes of a batch
    tensor (``(N, ..., *spatial, C)``) to ``out_shape``."""
    dims = len(out_shape)
    sl = [slice(None)] * t.dim()
    for i, o in enumerate(out_shape):
        ax = t.dim() - 1 - dims + i
        off = (t.shape[ax] - o) // 2
        sl[ax] = slice(off, off + o)
    return t[tuple(sl)]
