"""Training pipelines for real samples: host sampling, then one device
transform per sample (the JAX package's ``pipeline/training.py``).

- The host draws random crops from Zarr (``train/sampler.py``) with labels
  read at input size, so that geometric augments move raw and labels
  alike, and ships raw bytes, uint32 ids and the mask.
- The device transform does the rest on the card: renumbering,
  mirror/transpose, the gated elastic deform, the gated per-section
  shift of a 2D setup's ``adj_slices`` sections, the intensity chain,
  section defects, boundary growth, affinity targets, their mask and
  balance weights, LSD targets (``ops/lsd.py``) with the mask as their
  weights, and the [-1, 1] input scaling.

The transform is a draw (``draw_transform``: every random number, scalars
from the host generator, dense fields from the card's) and an apply
(``apply_transform``: deterministic given the draws).  The JAX package
selects each gated augment with ``jnp.where`` after computing both
branches; here the coin is a host draw and only the branch taken runs,
which gives the same result.  The batch is a loop over samples in place
of ``vmap``.

Semantics kept from the JAX package: 3D setups train at batch 1 and
learning rate 0.5e-4; 2D setups at batch 10 and 1e-4, on ``adj_slices``
sections with targets of the centre one (neighbourhoods given a z of 0,
LSDs the 2D ones of the centre section), squeezed to 2D; deform, the
shift (2D), noise, intensity, gamma, impulse and smooth each apply with
probability 0.5; defects on multi-slice inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.geometry import Coordinate
from ..ops.affinities import affs_mask, balance_weights, grow_boundary, seg_to_affs
from ..ops.lsd import lsd_descriptors_downsampled
from ..train.sampler import ArtifactSampler, BatchLoader, RandomLocationSampler, Sample
from ..utils.profiling import span
from .augment import (
    Generators,
    apply_defect,
    apply_elastic,
    apply_flow,
    apply_gamma,
    apply_impulse,
    apply_intensity,
    apply_noise,
    apply_shift,
    apply_simple,
    apply_smooth,
    draw_defect,
    draw_flow,
    draw_gamma,
    draw_impulse,
    draw_intensity,
    draw_noise,
    draw_shift,
    draw_simple,
    draw_smooth,
)

MAX_LABELS = 64

# the transform's augment settings (the JAX package's make_device_transform)
MIRROR_AXES = (0, 1, 2)
TRANSPOSE_AXES = (1, 2)
INTERP = {"raw": 1, "labels": 0, "mask": 0}
CONTROL_SPACING = (8, 32, 32)
JITTER_SIGMA = (0.0, 2.0, 2.0)
ROTATION_MAX = np.pi / 2
SCALE_RANGE = (0.9, 1.1)
MAX_SHIFT = 3  # the 2D setups' per-section shift
SHIFT_PROB = 0.2
GATE_P = 0.5


@dataclasses.dataclass
class SetupSpec:
    """Static training-relevant facts derived from a net config."""

    net_config: dict
    voxel_size: tuple

    @property
    def is_2d(self) -> bool:
        return len(self.net_config["input_shape"]) == 2

    @property
    def adj_slices(self) -> int:
        return self.net_config.get("adj_slices", 1)

    @property
    def input_tile(self) -> tuple:
        """Voxel shape of the raw crop (3D, z = adj_slices for 2D nets)."""
        s = self.net_config["input_shape"]
        return (self.adj_slices, *s) if self.is_2d else tuple(s)

    @property
    def output_tile(self) -> tuple:
        s = self.net_config["output_shape"]
        return (1, *s) if self.is_2d else tuple(s)

    @property
    def batch_size(self) -> int:
        return 10 if self.is_2d else 1

    @property
    def learning_rate(self) -> float:
        return 1e-4 if self.is_2d else 0.5e-4

    def output_spec(self, name):
        out = dict(self.net_config["outputs"][name])
        if self.is_2d:
            if "neighborhood" in out:
                out["neighborhood"] = [[0, *o] for o in out["neighborhood"]]
            if "sigma" in out:
                out["sigma"] = (0.01, out["sigma"], out["sigma"])
        return out


def device_renumber(labels, max_labels: int = MAX_LABELS):
    """Dense relabel to 0..K-1 on the device (gp Renumber): sorted-unique
    ranks; background 0 keeps rank 0 when present, other ids stay >= 1;
    ranks beyond ``max_labels`` merge into the last.  The ranks come from
    a sort and a running count of new values, as ``jnp.unique`` computes
    them: every shape is static, so nothing waits for the card
    (``torch.unique``'s output size would)."""
    flat = labels.reshape(-1)
    ordered, perm = torch.sort(flat)
    new = torch.ones_like(ordered, dtype=torch.int32)
    new[0] = 0
    new[1:] = ordered[1:] != ordered[:-1]
    inv = torch.empty_like(new)
    inv[perm] = torch.cumsum(new, 0, dtype=torch.int32)
    inv = inv.reshape(labels.shape) + (ordered[0] != 0).to(torch.int32)
    return torch.clamp(inv, max=max_labels - 1)


def device_normalize_raw(raw):
    """uint8/uint16 -> float32 in [0, 1] on the device (gp.Normalize)."""
    if raw.dtype == torch.uint8:
        return raw.to(torch.float32) / 255.0
    if raw.dtype == torch.uint16:
        return raw.to(torch.float32) / 65535.0
    return raw.to(torch.float32)


def draw_transform(gen: Generators, spec: SetupSpec) -> dict:
    """Every random number of one sample's transform.  A gated augment's
    own draws are made only where its coin says it applies."""
    shape = spec.input_tile
    z = shape[0]
    slab = torch.empty((z, 1, 1), device=gen.device)  # one draw per section
    draws = {"simple": draw_simple(gen, len(MIRROR_AXES))}
    if gen.coin(GATE_P):
        draws["deform"] = draw_flow(gen, shape, CONTROL_SPACING, ROTATION_MAX, SCALE_RANGE)
    if spec.adj_slices > 1 and gen.coin(GATE_P):
        draws["shift"] = draw_shift(gen, z, MAX_SHIFT, SHIFT_PROB)
    if gen.coin(GATE_P):
        draws["noise"] = draw_noise(gen, shape, 0.05)
    if gen.coin(GATE_P):
        draws["intensity"] = draw_intensity(gen, slab)
    if gen.coin(GATE_P):
        draws["gamma"] = draw_gamma(gen, slab, slab_axis=0)
    if gen.coin(GATE_P):
        draws["impulse"] = draw_impulse(gen, shape, 0.05)
    if gen.coin(GATE_P):
        draws["smooth"] = draw_smooth(gen, slab)
    draws["defect"] = draw_defect(gen, z)
    return draws


def _crop_out(x, out_tile):
    sl = tuple(slice((s - t) // 2, (s - t) // 2 + t) for s, t in zip(x.shape, out_tile))
    return x[sl]


def apply_transform(
    spec: SetupSpec, draws: dict, raw, labels, mask, artifact=None, artifact_mask=None,
    prob_artifact: float = 0.0,
):
    """One sample through the transform with the given draws: ``raw``
    (input tile, bytes or float), ``labels`` (input-sized ids, any int
    dtype), ``mask`` (uint8) -> ``(net input (*tile, 1), {name: target
    (*out, C)}, {name: weights (*out, C)})``, channels last, fp32.  Spans:
    ``bs.train.augment`` (normalisation through the clamp), then
    ``bs.train.targets``."""
    with span("bs.train.augment"):
        raw = device_normalize_raw(raw)
        labels = device_renumber(labels)
        mask = mask.to(torch.float32)

        arrays = apply_simple(
            {"raw": raw, "labels": labels, "mask": mask}, **draws["simple"],
            mirror_axes=MIRROR_AXES, transpose_axes=TRANSPOSE_AXES,
        )
        if "deform" in draws:
            flow = apply_flow(tuple(raw.shape), JITTER_SIGMA, **draws["deform"])
            arrays = apply_elastic(arrays, INTERP, flow)
        if "shift" in draws:
            arrays = apply_shift(arrays, **draws["shift"])
        raw, labels, mask = arrays["raw"], arrays["labels"], arrays["mask"]

        if "noise" in draws:
            raw = apply_noise(raw, **draws["noise"])
        if "intensity" in draws:
            raw = apply_intensity(raw, **draws["intensity"], slab_axis=0)
        if "gamma" in draws:
            raw = apply_gamma(raw, **draws["gamma"], slab_axis=0)
        if "impulse" in draws:
            raw = apply_impulse(raw, **draws["impulse"])
        if "smooth" in draws:
            raw = apply_smooth(raw, **draws["smooth"], slab_axis=0)
        raw = apply_defect(
            raw, **draws["defect"],
            prob_missing=0.05 if spec.input_tile[0] > 1 else 0.0,
            prob_low_contrast=0.1,
            prob_artifact=prob_artifact if artifact is not None else 0.0,
            artifact=artifact, artifact_mask=artifact_mask,
        )
        raw = torch.clamp(raw, 0.0, 1.0)

    with span("bs.train.targets"):
        labels_out = _crop_out(labels, spec.output_tile)
        mask_out = _crop_out(mask, spec.output_tile)
        targets, weights = {}, {}
        for name in spec.net_config["outputs"]:
            out = spec.output_spec(name)
            if "neighborhood" in out:  # affinities head
                lab = labels_out
                if out.get("grow_boundary", 0):
                    lab = grow_boundary(lab, steps=out["grow_boundary"], only_xy=True, mask=mask_out)
                t = seg_to_affs(lab, out["neighborhood"])
                m = affs_mask(mask_out, out["neighborhood"])
                w = balance_weights(t, m, slab_axis=0)
            elif spec.is_2d:  # LSD head: the centre section's 2D LSDs, z put back
                t = lsd_descriptors_downsampled(
                    labels_out[0], sigma=spec.net_config["outputs"][name]["sigma"],
                    voxel_size=spec.voxel_size[1:], downsample=out.get("downsample", 1),
                    max_labels=MAX_LABELS,
                )[:, None]
                w = mask_out[None].expand(t.shape)
            else:  # LSD head
                t = lsd_descriptors_downsampled(
                    labels_out, sigma=out["sigma"], voxel_size=spec.voxel_size,
                    downsample=out.get("downsample", 1), max_labels=MAX_LABELS,
                )
                w = mask_out[None].expand(t.shape)
            t, w = torch.movedim(t, 0, -1), torch.movedim(w, 0, -1)
            if spec.is_2d:  # (1, h, w, C) -> (h, w, C)
                t, w = t[0], w[0]
            targets[name] = t.to(torch.float32)
            weights[name] = w.to(torch.float32)
    return (raw * 2.0 - 1.0)[..., None], targets, weights


def make_device_transform(spec: SetupSpec, prob_artifact: float = 0.0):
    """``(gen, raw, labels, mask[, artifact, artifact_mask])`` unbatched ->
    ``(input, targets, weights)``: ``apply_transform`` of a fresh
    ``draw_transform``."""

    def transform(gen, raw, labels, mask, artifact=None, artifact_mask=None):
        return apply_transform(
            spec, draw_transform(gen, spec), raw, labels, mask, artifact, artifact_mask,
            prob_artifact=prob_artifact,
        )

    return transform


def make_batch_transform(spec: SetupSpec, prob_artifact: float = 0.0, with_artifact: bool = False):
    """``(gen, raw, labels, mask[, artifact, artifact_mask])`` batched ->
    ``{"input", "targets", "weights"}`` stacked over the batch."""
    single = make_device_transform(spec, prob_artifact=prob_artifact)

    def batched(gen, raw, labels, mask, artifact=None, artifact_mask=None):
        if with_artifact != (artifact is not None):
            raise ValueError("artifact crops are given exactly when with_artifact is set")
        outs = [
            single(
                gen, raw[i], labels[i], mask[i],
                None if artifact is None else artifact[i],
                None if artifact_mask is None else artifact_mask[i],
            )
            for i in range(raw.shape[0])
        ]
        return {
            "input": torch.stack([o[0] for o in outs]),
            "targets": {k: torch.stack([o[1][k] for o in outs]) for k in outs[0][1]},
            "weights": {k: torch.stack([o[2][k] for o in outs]) for k in outs[0][2]},
        }

    return batched


def upload(batch: dict, device, ids=("labels",)) -> dict:
    """A host batch on ``device``: raw bytes, the mask and artifact crops as
    they are, the uint32 ids of the arrays named in ``ids`` as int64 (their
    bits, widened on the card); from pinned memory, queued without waiting
    for the card."""
    device = torch.device(device)

    def to(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    out = {}
    for k, v in batch.items():
        if k not in ids:
            out[k] = to(v)
        elif v.dtype == np.uint32:
            out[k] = to(v.view(np.int32)).to(torch.int64) & 0xFFFFFFFF
        else:
            out[k] = to(v.astype(np.int64, copy=False))
    return out


class TrainingPipeline:
    """End-to-end batch source for a real-data setup: ``next_batch()`` gives
    a device batch."""

    def __init__(
        self,
        net_config: dict,
        voxel_size,
        samples: Sequence[Sample],
        batch_size: Optional[int] = None,
        min_masked: float = 0.05,
        seed: Optional[int] = 0,
        prefetch: int = 6,
        num_threads: int = 4,
        artifact_samples: Optional[Sequence] = None,
        prob_artifact: float = 0.05,
        device="cuda",
    ):
        self.spec = SetupSpec(net_config, tuple(voxel_size))
        self.batch_size = batch_size or self.spec.batch_size
        self.device = torch.device(device)
        vs = Coordinate(voxel_size)
        in_size = Coordinate(self.spec.input_tile) * vs
        self.sampler = RandomLocationSampler(
            samples,
            input_size=in_size,
            output_size=in_size,  # labels read at input size (geometric augs)
            min_masked=min_masked,
            seed=seed,
        )
        self.artifact_sampler = None
        if artifact_samples:
            # the crop is in VOXELS: the artifact volume may have its own
            # voxel size, and the blend needs exactly input_tile voxels
            self.artifact_sampler = ArtifactSampler(artifact_samples, self.spec.input_tile, seed=seed)
        self.loader = BatchLoader(self._draw, self.batch_size, prefetch, num_threads)
        self.transform = make_batch_transform(
            self.spec, prob_artifact=prob_artifact,
            with_artifact=self.artifact_sampler is not None,
        )
        self.gen = Generators(seed or 0, self.device)

    def _draw(self):
        d = self.sampler.sample()
        out = {"raw": d["raw"], "labels": d["labels"], "mask": d["mask"]}
        if self.artifact_sampler is not None:
            out.update(self.artifact_sampler.sample())
        return out

    def next_batch(self):
        return self.transform_batch(next(self.loader))

    def transform_batch(self, host_batch: dict) -> dict:
        """A host batch (``self.loader``'s) through the device transform:
        the span ``bs.train.transform``, ``bs.train.upload`` in it."""
        with span("bs.train.transform"):
            with span("bs.train.upload"):
                b = upload(host_batch, self.device)
            return self.transform(
                self.gen, b["raw"], b["labels"], b["mask"], b.get("artifact"), b.get("artifact_mask"),
            )

    def stop(self):
        self.loader.stop()
