"""Synthetic training pipeline for the ``3d_affs_from_*`` refiner setups
(the JAX package's ``pipeline/synthetic.py``).

No data on disk: each host draw generates a random label volume and a copy
with simulated 2D prediction errors (``train/synth.py``).  The device
transform derives the refiner's inputs from the obfuscated copy (2D LSDs,
2D affinities or 3D LSDs, in the order of the net config's ``inputs``,
each after its own boundary growth), corrupts them as the reference
corrupts simulated predictions (noise, intensity per channel and per
z-section, gamma and smoothing per z-section, section defects shared by
every channel), and takes the targets, 3D affinities, from the clean
labels.

As in ``pipeline/training.py`` the transform is a draw
(``draw_synth_transform``: every random number, from the ``Generators``)
and an apply (``apply_synth_transform``: deterministic given the draws).
The JAX package computes both branches of each gated augment and selects
with ``jnp.where``, using one key for the coin and the augment; here the
coin is a host draw and only the branch taken runs, which gives the same
result.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..ops.affinities import affs_mask, balance_weights, grow_boundary, seg_to_affs
from ..ops.lsd import lsd_descriptors_2d_stack, lsd_descriptors_downsampled
from ..train.sampler import BatchLoader, fold_ids_u32
from ..train.synth import synthetic_pair
from ..utils.profiling import span
from .augment import (
    Generators,
    apply_defect,
    apply_gamma,
    apply_intensity,
    apply_noise,
    apply_simple,
    apply_smooth,
    draw_defect,
    draw_gamma,
    draw_intensity,
    draw_noise,
    draw_simple,
    draw_smooth,
)
from .training import GATE_P, MIRROR_AXES, TRANSPOSE_AXES, SetupSpec, _crop_out, device_renumber, upload

# more ids than a real crop's MAX_LABELS: obfuscation splits add ids
MAX_LABELS = 96


def check_synth_inputs(net_config: dict) -> None:
    """Every input of a synthetic setup is LSDs (``sigma``) or affinities
    (``neighborhood``) of the obfuscated labels; anything else (a raw
    input) the transform cannot make."""
    for name, icfg in net_config["inputs"].items():
        if "sigma" not in icfg and "neighborhood" not in icfg:
            raise ValueError(
                f"synthetic training cannot make input {name!r} ({icfg}): "
                "its inputs must be LSDs (sigma) or affinities (neighborhood)"
            )


def input_channels(net_config: dict) -> int:
    """The channels ``synth_inputs`` makes: 6 per 2D LSD input, 10 per 3D
    one, one per offset of an affinity input."""
    return sum(
        (6 if name.startswith("2d") else 10) if "sigma" in icfg else len(icfg["neighborhood"])
        for name, icfg in net_config["inputs"].items()
    )


def draw_synth_transform(gen: Generators, spec: SetupSpec) -> dict:
    """Every random number of one sample's synthetic transform; a gated
    augment's own draws are made only where its coin says it applies."""
    z = spec.input_tile[0]
    channels = input_channels(spec.net_config)
    shape = (channels, *spec.input_tile)
    per_channel = torch.empty((channels, 1), device=gen.device)
    per_section = torch.empty((1, z), device=gen.device)
    draws = {"simple": draw_simple(gen, len(MIRROR_AXES))}
    if gen.coin(GATE_P):
        draws["noise"] = draw_noise(gen, shape, 0.05)
    if gen.coin(GATE_P):
        draws["intensity_channel"] = draw_intensity(gen, per_channel, slab_axis=0)
    if gen.coin(GATE_P):
        draws["intensity_section"] = draw_intensity(gen, per_section, slab_axis=1)
    if gen.coin(GATE_P):
        draws["gamma"] = draw_gamma(gen, per_section, slab_axis=1)
    if gen.coin(GATE_P):
        draws["smooth"] = draw_smooth(gen, per_section, slab_axis=1)
    draws["defect"] = draw_defect(gen, z)
    return draws


def synth_inputs(spec: SetupSpec, obf):
    """The net's input channels ``(C, *tile)`` from renumbered obfuscated
    labels, one block per entry of ``inputs``, in order."""
    vs = spec.voxel_size
    chans = []
    for name, icfg in spec.net_config["inputs"].items():
        src = obf
        if icfg.get("grow_boundary", 0):
            src = grow_boundary(src, steps=icfg["grow_boundary"], only_xy=True)
        if "sigma" in icfg:
            if name.startswith("2d"):
                t = lsd_descriptors_2d_stack(src, sigma=icfg["sigma"], voxel_size_yx=vs[1:], max_labels=MAX_LABELS)
            else:
                t = lsd_descriptors_downsampled(
                    src, sigma=icfg["sigma"], voxel_size=vs, downsample=icfg.get("downsample", 1),
                    max_labels=MAX_LABELS,
                )
        else:
            nbhd = icfg["neighborhood"]
            if len(nbhd[0]) == 2:
                nbhd = [[0, *o] for o in nbhd]
            t = seg_to_affs(src, nbhd)
        chans.append(t)
    return torch.cat(chans, dim=0)


def apply_synth_transform(spec: SetupSpec, draws: dict, clean, obf):
    """One sample through the synthetic transform with the given draws:
    ``clean`` and ``obf`` (input-sized ids, any int dtype) -> ``(net input
    (*tile, C) in [0, 1], {name: target (*out, C)}, {name: weights (*out,
    C)})``, channels last, fp32."""
    # obfuscation splits add ids: each copy is renumbered on its own
    clean = device_renumber(clean, MAX_LABELS)
    obf = device_renumber(obf, MAX_LABELS)
    arrays = apply_simple(
        {"clean": clean, "obf": obf}, **draws["simple"], mirror_axes=MIRROR_AXES, transpose_axes=TRANSPOSE_AXES,
    )
    clean, obf = arrays["clean"], arrays["obf"]

    # the simulated predictions, corrupted: x is (C, z, y, x); intensity
    # per channel and per z-section, gamma and smoothing per z-section
    # (per-section 2D predictions never smear across z)
    x = synth_inputs(spec, obf)
    if "noise" in draws:
        x = apply_noise(x, **draws["noise"])
    if "intensity_channel" in draws:
        x = apply_intensity(x, **draws["intensity_channel"], slab_axis=0)
    if "intensity_section" in draws:
        x = apply_intensity(x, **draws["intensity_section"], slab_axis=1)
    if "gamma" in draws:
        x = apply_gamma(x, **draws["gamma"], slab_axis=1)
    if "smooth" in draws:
        x = apply_smooth(x, **draws["smooth"], slab_axis=1)
    # one defect draw for every channel; each channel's low-contrast mean
    # is its own
    x = torch.stack(
        [apply_defect(xc, **draws["defect"], prob_missing=0.05, prob_low_contrast=0.05) for xc in x]
    )
    x = torch.clamp(x, 0.0, 1.0)

    # the targets from the clean labels, every voxel labelled
    labels_out = _crop_out(clean, spec.output_tile)
    mask_out = torch.ones(labels_out.shape, dtype=torch.float32, device=labels_out.device)
    targets, weights = {}, {}
    for name, ocfg in spec.net_config["outputs"].items():
        lab = labels_out
        if ocfg.get("grow_boundary", 0):
            lab = grow_boundary(lab, steps=ocfg["grow_boundary"], only_xy=True)
        t = seg_to_affs(lab, ocfg["neighborhood"])
        m = affs_mask(mask_out, ocfg["neighborhood"])
        w = balance_weights(t, m, slab_axis=0)
        targets[name] = torch.movedim(t, 0, -1).to(torch.float32)
        weights[name] = torch.movedim(w, 0, -1).to(torch.float32)
    return torch.movedim(x, 0, -1), targets, weights


def make_synth_device_transform(spec: SetupSpec):
    """``(gen, clean, obf)`` unbatched -> ``(input, targets, weights)``:
    ``apply_synth_transform`` of a fresh ``draw_synth_transform``."""

    def transform(gen, clean, obf):
        return apply_synth_transform(spec, draw_synth_transform(gen, spec), clean, obf)

    return transform


def make_synth_batch_transform(spec: SetupSpec):
    """``(gen, clean, obf)`` batched -> ``{"input", "targets", "weights"}``
    stacked over the batch, one draw per sample."""
    single = make_synth_device_transform(spec)

    def batched(gen, clean, obf):
        outs = [single(gen, clean[i], obf[i]) for i in range(clean.shape[0])]
        return {
            "input": torch.stack([o[0] for o in outs]),
            "targets": {k: torch.stack([o[1][k] for o in outs]) for k in outs[0][1]},
            "weights": {k: torch.stack([o[2][k] for o in outs]) for k in outs[0][2]},
        }

    return batched


class SyntheticTrainingPipeline:
    """Batch source for a synthetic setup: ``next_batch()`` gives a device
    batch.  The host draws label pairs on ``num_threads`` loader threads,
    each draw seeded from one locked master generator, as the JAX package
    draws them; the transform runs on ``device``."""

    def __init__(
        self,
        net_config: dict,
        voxel_size=(1, 1, 1),
        batch_size: int = 1,
        seed: int = 0,
        prefetch: int = 6,
        num_threads: int = 4,
        device="cuda",
    ):
        check_synth_inputs(net_config)
        self.spec = SetupSpec(net_config, tuple(voxel_size))
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.rng = np.random.default_rng(seed)
        self._rng_lock = threading.Lock()
        self.transform = make_synth_batch_transform(self.spec)
        self.gen = Generators(seed, self.device)
        self.loader = BatchLoader(self._draw, batch_size, prefetch, num_threads)

    def _draw(self):
        with self._rng_lock:
            seed = int(self.rng.integers(0, 2**31))
        clean, obf = synthetic_pair(np.random.default_rng(seed), shape=self.spec.input_tile)
        # renumbered on the card (device_renumber)
        return {"clean": fold_ids_u32(clean), "obf": fold_ids_u32(obf)}

    def next_batch(self):
        return self.transform_batch(next(self.loader))

    def transform_batch(self, host_batch: dict) -> dict:
        """A host batch (``self.loader``'s) through the device transform
        (spans as ``TrainingPipeline.transform_batch``'s)."""
        with span("bs.train.transform"):
            with span("bs.train.upload"):
                b = upload(host_batch, self.device, ids=("clean", "obf"))
            return self.transform(self.gen, b["clean"], b["obf"])

    def stop(self):
        self.loader.stop()
