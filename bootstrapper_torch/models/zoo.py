"""Model zoo: the 10 standard setups and their network configurations.

Capability-parity with the reference model catalogue (reference
``bootstrapper/models/*/net_config.json`` and ``bootstrapper/configs.py:21-39``):
same inputs/outputs, shapes, neighborhoods and sigmas, so configs and
trained expectations transfer.  One deliberate fix: head width defaults
to ``len(neighborhood)`` when an affinity neighborhood is given (the
reference ``3d_affs`` config says ``dims: 6`` against a 9-offset
neighborhood, which cannot train).

Setups here are *data*, not copied scripts: a single parametric
U-Net (``unet.py``) is instantiated from these dicts.  This module is a
copy of the JAX package's ``models/zoo.py``, so both packages read the
same ``net_config.json`` files.
"""

from __future__ import annotations

import copy
import json
import os

_K2 = [[[3, 3], [3, 3]]]
_K3 = [[[3, 3, 3], [3, 3, 3]]]

_NBHD_2D = [[-1, 0], [0, -1], [-9, 0], [0, -9], [-27, 0], [0, -27]]
_NBHD_3D = [
    [-1, 0, 0], [0, -1, 0], [0, 0, -1],
    [-2, 0, 0], [0, -9, 0], [0, 0, -9],
    [-3, 0, 0], [0, -27, 0], [0, 0, -27],
]

_2D_BASE = {
    "in_channels": 1,
    "adj_slices": 3,
    "num_fmaps": 12,
    "fmap_inc_factor": 5,
    "downsample_factors": [[2, 2]] * 3,
    "kernel_size_down": _K2 * 4,
    "kernel_size_up": _K2 * 3,
    "input_shape": [196, 196],
    "output_shape": [104, 104],
    "shape_increase": [216, 216],
    "inputs": {"raw": {"dims": 1}},
}

_3D_BASE = {
    "in_channels": 1,
    "num_fmaps": 12,
    "fmap_inc_factor": 5,
    "downsample_factors": [[1, 2, 2]] * 3,
    "kernel_size_down": _K3 * 4,
    "kernel_size_up": _K3 * 3,
    "input_shape": [32, 196, 196],
    "output_shape": [4, 104, 104],
    "shape_increase": [0, 216, 216],
    "inputs": {"raw": {"dims": 1}},
}

_K3_FLAT = [[[1, 3, 3], [1, 3, 3]]]

_FROM_BASE = {
    "num_fmaps": 9,
    "num_fmaps_out": 18,
    "fmap_inc_factor": 3,
    "downsample_factors": [[1, 2, 2]] * 3,
    "kernel_size_down": _K3_FLAT * 2 + _K3 * 2,
    "kernel_size_up": _K3 * 3,
    "input_shape": [24, 148, 148],
    "output_shape": [4, 56, 56],
    "shape_increase": [12, 240, 240],
}


def _setup(base, **over):
    cfg = copy.deepcopy(base)
    cfg.update(copy.deepcopy(over))
    return cfg


SETUPS: dict[str, dict] = {
    "2d_lsd": _setup(
        _2D_BASE,
        outputs={"2d_lsds": {"dtype": "uint8", "dims": 6, "sigma": 80, "downsample": 2}},
    ),
    "2d_affs": _setup(
        _2D_BASE,
        outputs={"2d_affs": {"dtype": "uint8", "dims": 6, "neighborhood": _NBHD_2D, "grow_boundary": 1}},
    ),
    "2d_mtlsd": _setup(
        _2D_BASE,
        outputs={
            "2d_lsds": {"dtype": "uint8", "dims": 6, "sigma": 80, "downsample": 2},
            "2d_affs": {"dtype": "uint8", "dims": 6, "neighborhood": _NBHD_2D, "grow_boundary": 1},
        },
    ),
    "3d_lsd": _setup(
        _3D_BASE,
        outputs={"3d_lsds": {"dtype": "uint8", "dims": 10, "sigma": 80, "downsample": 2}},
    ),
    "3d_affs": _setup(
        _3D_BASE,
        outputs={"3d_affs": {"dtype": "uint8", "dims": 9, "neighborhood": _NBHD_3D, "grow_boundary": 1}},
    ),
    "3d_mtlsd": _setup(
        _3D_BASE,
        outputs={
            "3d_lsds": {"dtype": "uint8", "dims": 10, "sigma": 80, "downsample": 2},
            "3d_affs": {"dtype": "uint8", "dims": 9, "neighborhood": _NBHD_3D, "grow_boundary": 1},
        },
    ),
    "3d_affs_from_2d_lsd": _setup(
        _FROM_BASE,
        inputs={"2d_lsds": {"dims": 6, "sigma": 10, "downsample": 2, "grow_boundary": 1}},
        outputs={"3d_affs": {"dtype": "uint8", "dims": 9, "neighborhood": _NBHD_3D, "grow_boundary": 1}},
    ),
    "3d_affs_from_2d_affs": _setup(
        _FROM_BASE,
        inputs={"2d_affs": {"dims": 6, "neighborhood": _NBHD_2D, "grow_boundary": 1}},
        outputs={"3d_affs": {"dtype": "uint8", "dims": 9, "neighborhood": _NBHD_3D, "grow_boundary": 0}},
    ),
    "3d_affs_from_2d_mtlsd": _setup(
        _FROM_BASE,
        inputs={
            "2d_lsds": {"dims": 6, "sigma": 10, "downsample": 2, "grow_boundary": 1},
            "2d_affs": {"dims": 6, "neighborhood": _NBHD_2D, "grow_boundary": 1},
        },
        outputs={"3d_affs": {"dtype": "uint8", "dims": 9, "neighborhood": _NBHD_3D, "grow_boundary": 0}},
    ),
    "3d_affs_from_3d_lsd": _setup(
        _FROM_BASE,
        num_fmaps=12,
        inputs={"3d_lsds": {"dims": 10, "sigma": 10, "downsample": 2, "grow_boundary": 1}},
        outputs={"3d_affs": {"dtype": "uint8", "dims": 9, "neighborhood": _NBHD_3D, "grow_boundary": 1}},
    ),
}

MODEL_SHORT_NAMES = {
    "3d_affs_from_2d_lsd": "3Af2L",
    "3d_affs_from_2d_affs": "3Af2A",
    "3d_affs_from_2d_mtlsd": "3Af2M",
    "3d_affs_from_3d_lsd": "3Af3L",
}


def get_net_config(name_or_path: str) -> dict:
    """Load a net config: a zoo setup name, a setup dir, or a JSON path."""
    if name_or_path in SETUPS:
        return copy.deepcopy(SETUPS[name_or_path])
    path = name_or_path
    if os.path.isdir(path):
        path = os.path.join(path, "net_config.json")
    with open(path) as f:
        return json.load(f)


def write_net_config(setup_name: str, setup_dir: str) -> str:
    """Materialise a zoo setup's net_config.json into a setup dir."""
    os.makedirs(setup_dir, exist_ok=True)
    path = os.path.join(setup_dir, "net_config.json")
    with open(path, "w") as f:
        json.dump(SETUPS[setup_name], f, indent=4)
    return path


def model_chains(names=None, require_affs=True) -> list[list[str]]:
    """Enumerate valid model chains: an image model optionally followed by
    a compatible ``*_from_*`` refiner (matched on output/input datasets,
    same rule as the reference ``configs.py:198-217``).

    With ``require_affs`` (default), only chains whose final model emits
    a ``3d_affs`` output are returned — the reference's wizard keeps
    extending a chain while a compatible refiner exists
    (``configs.py:198-217``), so it never offers e.g. a bare ``2d_lsd``
    whose outputs nothing downstream can segment."""
    names = list(names or SETUPS)
    chains = []
    for name in names:
        if "_from_" in name:
            continue
        chains.append([name])
        outs = set(SETUPS[name]["outputs"])
        for refiner in names:
            if "_from_" not in refiner:
                continue
            ins = set(SETUPS[refiner]["inputs"])
            if ins <= outs:
                chains.append([name, refiner])
    if require_affs:
        chains = [
            c for c in chains
            if any(o.startswith("3d_affs") for o in SETUPS[c[-1]]["outputs"])
        ]
    return chains
