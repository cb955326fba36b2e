"""``bs-torch utils`` subcommands: the JAX package's ``cli/utils_cmds.py``
over the port's ``data/tools.py``, ``models/convert_torch.py`` and
``configs.install_pretrained``; all host work."""

from __future__ import annotations

import click

from .styles import cli_echo


@click.group()
def utils():
    """Volume data tools: bbox, clahe, convert, mask, scale_pyramid, merge."""


@utils.command()
@click.argument("in_path")
@click.argument("out_path")
@click.option("--padding", "-p", type=int, default=0)
def bbox(in_path, out_path, padding):
    """Crop to the nonzero bounding box (+padding)."""
    from ..data.tools import bbox_crop

    out = bbox_crop(in_path, out_path, padding)
    cli_echo(f"cropped -> {out_path} roi={out.roi}", "utils")


@utils.command()
@click.argument("in_path")
@click.argument("out_path")
@click.option("--voxel-size", "-vs", nargs=3, type=int, default=(1, 1, 1))
@click.option("--offset", "-o", nargs=3, type=int, default=None)
@click.option("--dtype", "-d", default=None)
@click.option("--crop", "-c", default=None,
              help="z0:z1,y0:y1,x0:x1 crop before writing")
def convert(in_path, out_path, voxel_size, offset, dtype, crop):
    """Convert TIFF / image stack / npy to Zarr."""
    from ..data.tools import convert_to_zarr

    crop_spec = None
    if crop:
        crop_spec = [
            [int(x) if x else None for x in part.split(":")]
            for part in crop.split(",")
        ]
    out = convert_to_zarr(
        in_path, out_path, voxel_size, offset or None, dtype, crop_spec
    )
    cli_echo(f"wrote {out_path} shape={out.shape}", "utils")


@utils.command()
@click.argument("in_path")
@click.argument("out_path")
@click.option("--mode", "-m", type=click.Choice(["raw", "obj"]), default="obj")
@click.option("--num-workers", "-n", type=int, default=8)
def mask(in_path, out_path, mode, num_workers):
    """Create a raw-intensity or object (>0) mask."""
    from ..data.tools import make_obj_mask, make_raw_mask

    fn = make_raw_mask if mode == "raw" else make_obj_mask
    fn(in_path, out_path, num_workers=num_workers)
    cli_echo(f"wrote {out_path}", "utils")


@utils.command()
@click.argument("in_path")
@click.option("--scales", "-s", type=int, default=3)
@click.option("--factor", "-f", nargs=3, type=int, default=(1, 2, 2))
@click.option("--labels/--image", "is_labels", default=None)
def scale_pyramid(in_path, scales, factor, is_labels):
    """Create a multiscale pyramid (s0..sN)."""
    from ..data.tools import scale_pyramid as run

    paths = run(in_path, scales, factor, is_labels)
    for p in paths:
        cli_echo(p, "utils")


@utils.command()
@click.argument("in_path")
@click.argument("out_path")
@click.option("--clip-limit", type=float, default=0.01)
@click.option("--num-workers", "-n", type=int, default=8)
def clahe(in_path, out_path, clip_limit, num_workers):
    """Contrast-limited adaptive histogram equalisation."""
    from ..data.tools import clahe as run

    run(in_path, out_path, clip_limit=clip_limit, num_workers=num_workers)
    cli_echo(f"wrote {out_path}", "utils")


@utils.command()
@click.argument("in_path")
@click.argument("out_path")
@click.option("--pairs", "-p", multiple=True, required=True,
              help="id pairs to merge, e.g. -p 12,15 -p 15,99")
@click.option("--num-workers", "-n", type=int, default=8)
def merge(in_path, out_path, pairs, num_workers):
    """Merge segment ids via (a,b) pairs."""
    from ..data.tools import merge_ids

    merge_pairs = [[int(x) for x in p.split(",")] for p in pairs]
    merge_ids(in_path, out_path, merge_pairs, num_workers=num_workers)
    cli_echo(f"wrote {out_path}", "utils")


@utils.command()
@click.argument("torch_ckpt")
@click.argument("setup_dir")
@click.argument("out_path")
def convert_ckpt(torch_ckpt, setup_dir, out_path):
    """Convert a reference PyTorch checkpoint into this framework's
    format (raw state_dict or Lightning .ckpt both accepted)."""
    from ..models.convert_torch import convert_checkpoint

    path = convert_checkpoint(torch_ckpt, setup_dir, out_path)
    cli_echo(f"converted -> {path}", "utils")


@utils.command()
@click.argument("setup_name")
@click.argument("setup_dir")
def download_ckpts(setup_name, setup_dir):
    """Install pretrained checkpoints for a 'from' setup.

    The reference downloads GitHub release zips (``configs.py:354-382``);
    here the synthetic-trained release checkpoints ship with the package
    (``pretrained/``, override with $BS_PRETRAINED_DIR) and are copied
    into the setup dir — same UX, no network."""
    from ..configs import install_pretrained, pretrained_dir

    ckpt = install_pretrained(setup_name, setup_dir)
    if ckpt:
        cli_echo(f"installed {ckpt}", "utils")
    else:
        cli_echo(
            f"no shipped checkpoint for {setup_name!r} under "
            f"{pretrained_dir()}; train it from synthetic data instead "
            f"(synthetic setups need no samples: tools/train_refiners.py "
            f"or bs train with a setup_dir only)",
            "utils",
        )
