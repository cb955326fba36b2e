"""Interactive prompts for ``bs prepare`` (reference wizard capability,
``bootstrapper/prepare.py:22-385``)."""

from __future__ import annotations

import os


from ..core.arrays import open_ds
from .styles import cli_echo, cli_prompt


def prompt_volumes() -> dict:
    """Prompt for volumes: raw/labels/mask datasets + metadata."""
    volumes = {}
    while True:
        name = cli_prompt(
            "Volume name (empty to finish)", "prepare", default="",
            show_default=False,
        )
        if not name:
            if volumes:
                break
            cli_echo("need at least one volume", "prepare")
            continue
        raw = cli_prompt("Path to raw dataset (zarr)", "prepare")
        try:
            arr = open_ds(raw)
            voxel_size = list(arr.voxel_size)
            cli_echo(f"found {arr.roi} voxel_size={voxel_size}", "prepare")
        except Exception as e:
            cli_echo(f"cannot open {raw}: {e}", "prepare")
            voxel_size = [
                int(x)
                for x in cli_prompt(
                    "Voxel size (z y x)", "prepare", default="1 1 1"
                ).split()
            ]
        labels = cli_prompt(
            "Path to labels dataset (empty if none)", "prepare", default="",
            show_default=False,
        )
        mask = cli_prompt(
            "Path to labels mask (empty if none)", "prepare", default="",
            show_default=False,
        )
        container = cli_prompt(
            "Output container",
            "prepare",
            default=os.path.join(os.path.dirname(raw.rstrip("/")), ""),
        )
        volumes[name] = {
            "raw_dataset": raw,
            "voxel_size": voxel_size,
            "output_container": container.rstrip("/"),
        }
        if labels:
            volumes[name]["labels_dataset"] = labels
        if mask:
            volumes[name]["labels_mask_dataset"] = mask
    return volumes


def prompt_models(model_names) -> list:
    """Prompt for the model chain."""
    from ..models.zoo import model_chains

    chains = model_chains(model_names)
    cli_echo("Available model chains:", "prepare")
    for i, chain in enumerate(chains):
        cli_echo(f"  {i}: {' -> '.join(chain)}", "prepare")
    idx = cli_prompt("Pick a chain", "prepare", default=0, type=int)
    return chains[idx]
