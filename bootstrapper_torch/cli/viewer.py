"""Dataset viewer (reference ``bootstrapper/view.py`` capability), as the
JAX package's ``cli/viewer.py``.

Uses neuroglancer when importable; otherwise prints a structured text
summary of each dataset (shape, dtype, ROI, voxel size, value summary), so
that ``bs-torch view`` is useful where neuroglancer is not installed.
"""

from __future__ import annotations

import os

import numpy as np

from ..core.arrays import open_ds
from .styles import cli_echo


def _find_arrays(path: str) -> list:
    out = []
    for root, dirs, files in os.walk(path):
        if ".zarray" in files:
            out.append(root)
            dirs.clear()
    return sorted(out) or ([path] if os.path.exists(path) else [])


def snapshot_metadata(container: str) -> dict:
    """Collect name -> (shape, voxel_size, offset) for every dataset in
    a snapshot container, in sorted order (reference ``view.py:134``
    walks the top-level members; our snapshots nest one level at most)."""
    meta = {}
    for ds_path in _find_arrays(container):
        arr = open_ds(ds_path)
        name = os.path.relpath(ds_path, container)
        meta[name] = (
            tuple(arr.shape),
            list(arr.voxel_size),
            list(arr.offset),
        )
    if "raw" in meta:  # 2D detection keys off raw; put it first
        meta = {"raw": meta.pop("raw"), **meta}
    return meta


def view_datasets(paths, snapshot: bool = False):
    try:
        import neuroglancer  # noqa: F401

        if snapshot:
            return _view_snapshot_neuroglancer(paths)
        return _view_neuroglancer(paths)
    except ImportError:
        pass
    if snapshot:
        # headless: print the layer plan the neuroglancer path would use
        from .view_spec import snapshot_view_spec

        for container in paths:
            spec = snapshot_view_spec(snapshot_metadata(container))
            cli_echo(
                f"{container}: {'2D' if spec.is_2d else '3D'} snapshot, "
                f"dims={spec.dims.names} scales={spec.dims.scales}",
                "view",
            )
            for layer in spec.layers:
                shader = (
                    "rg" if layer.shader and "getDataValue()" in layer.shader
                    else "rgb" if layer.shader else "-"
                )
                cli_echo(
                    f"  {layer.name}: {layer.kind} shader={shader} "
                    f"voxel_offset={layer.voxel_offset}",
                    "view",
                )
        return
    for path in paths:
        for ds_path in _find_arrays(path):
            try:
                arr = open_ds(ds_path)
            except Exception as e:
                cli_echo(f"{ds_path}: cannot open ({e})", "view")
                continue
            data = None
            try:
                # sample the central chunk for a value summary
                data = arr.store.read(
                    tuple(slice(0, min(s, 64)) for s in arr.shape)
                )
            except Exception:
                pass
            line = (
                f"{ds_path}: shape={arr.shape} dtype={arr.dtype} "
                f"roi={arr.roi} voxel_size={tuple(arr.voxel_size)}"
            )
            if data is not None and data.size:
                if np.issubdtype(arr.dtype, np.integer):
                    line += (
                        f" ids~{len(np.unique(data))}"
                        f" max={int(data.max())}"
                    )
                else:
                    line += f" range=[{data.min():.3f},{data.max():.3f}]"
            cli_echo(line, "view")


def _view_snapshot_neuroglancer(paths):
    """Snapshot layers with the reference's coordinate spaces, channel
    squeezing, and RGB/RG shaders (``view.py:125-186``), driven by the
    pure specs in ``view_spec``."""
    import neuroglancer
    import numpy as np

    from .view_spec import snapshot_view_spec

    neuroglancer.set_server_bind_address("0.0.0.0")
    viewer = neuroglancer.Viewer()
    for container in paths:
        meta = snapshot_metadata(container)
        spec = snapshot_view_spec(meta)
        dims = neuroglancer.CoordinateSpace(
            names=spec.dims.names, units=spec.dims.units,
            scales=spec.dims.scales,
        )
        with viewer.txn() as s:
            for layer in spec.layers:
                arr = open_ds(os.path.join(container, layer.name))
                data = arr.to_ndarray()
                if layer.squeeze_axis is not None:
                    data = np.squeeze(data, axis=layer.squeeze_axis)
                cls = (
                    neuroglancer.SegmentationLayer
                    if layer.kind == "segmentation"
                    else neuroglancer.ImageLayer
                )
                s.layers[layer.name] = cls(
                    source=neuroglancer.LocalVolume(
                        data=data, voxel_offset=layer.voxel_offset,
                        dimensions=dims,
                    )
                )
                if layer.shader is not None:
                    s.layers[layer.name].shader = layer.shader
            s.layout = spec.layout
    cli_echo(str(viewer), "view")
    input("press enter to exit")


def _view_neuroglancer(paths):
    import neuroglancer

    neuroglancer.set_server_bind_address("0.0.0.0")
    viewer = neuroglancer.Viewer()
    with viewer.txn() as s:
        for path in paths:
            for ds_path in _find_arrays(path):
                arr = open_ds(ds_path)
                data = arr.to_ndarray()
                dims = neuroglancer.CoordinateSpace(
                    names=["z", "y", "x"][-arr.spatial_dims :],
                    units="nm",
                    scales=list(arr.voxel_size),
                )
                is_seg = np.issubdtype(arr.dtype, np.integer) and \
                    arr.dtype.itemsize >= 4
                layer_cls = (
                    neuroglancer.SegmentationLayer
                    if is_seg
                    else neuroglancer.ImageLayer
                )
                s.layers[os.path.basename(ds_path)] = layer_cls(
                    source=neuroglancer.LocalVolume(
                        data=data, dimensions=dims,
                        voxel_offset=[
                            o // v for o, v in zip(arr.offset, arr.voxel_size)
                        ],
                    )
                )
    cli_echo(str(viewer), "view")
    input("press enter to exit")
