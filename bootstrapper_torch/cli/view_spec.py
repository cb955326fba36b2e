"""Pure layer-spec construction for the snapshot viewer (the JAX
package's ``cli/view_spec.py``).

The reference's snapshot viewer (reference ``bootstrapper/view.py:48-180``)
decides — per dataset — coordinate spaces, channel squeezing, voxel
offsets, image-vs-segmentation layer type, and an RGB or RG emitting
shader.  All of that logic is pure metadata manipulation; only the final
``neuroglancer.Viewer`` construction needs the package.  This module
holds the pure part so it is unit-testable headlessly and the
neuroglancer boundary in ``viewer.py`` stays a thin adapter.

Semantics matched to the reference:

- dataset discovery: top-level Zarr members without a ``.`` in the name
  (``view.py:134``)
- 2D detection from the shapes of ``raw`` and the first dataset
  (``view.py:144-152``): 5-D batch snapshots with a singleton z and a
  4-D raw are 2D; 4-D snapshots are 2D when raw isn't single-channel
  and differs in shape from the predictions
- coordinate space (``view.py:48-59``): 3D uses ``(c^, z, y, x)`` with
  a unit channel scale; 2D uses ``(b, c^, y, x)`` with the xy voxel
  size doubled in
- per-dataset processing (``view.py:62-88``): 2D non-raw 5-D arrays are
  squeezed along the singleton z; offsets are converted from world
  units to voxels and padded with zero channel/batch entries
- shaders (``view.py:91-122``): RGB everywhere in 3D; in 2D, raw keeps
  RGB while predictions use the RG variant (2-channel affinities)
- layer type (``view.py:167-172``): any dataset whose name contains
  ``label`` or ``seg`` becomes a segmentation layer (no shader)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

RGB_SHADER = """
void main() {
    emitRGB(
        vec3(
            toNormalized(getDataValue(0)),
            toNormalized(getDataValue(1)),
            toNormalized(getDataValue(2))
        )
    );
}
"""

RG_SHADER = """
void main() {
    emitRGB(
        vec3(
            toNormalized(getDataValue(0)),
            toNormalized(getDataValue(1)),
            toNormalized(getDataValue())
        )
    );
}
"""


@dataclass
class CoordSpec:
    """Coordinate-space description (names/units/scales) — the pure
    analog of ``neuroglancer.CoordinateSpace``."""

    names: List[str]
    scales: List[float]
    units: str = "nm"


@dataclass
class LayerSpec:
    """Everything needed to add one snapshot dataset as a layer."""

    name: str
    kind: str  # "image" | "segmentation"
    shader: Optional[str]
    voxel_offset: List[int]
    squeeze_axis: Optional[int]  # axis to squeeze out of the data, if any


@dataclass
class ViewSpec:
    dims: CoordSpec
    layers: List[LayerSpec] = field(default_factory=list)
    layout: str = "yz"
    is_2d: bool = False


def detect_2d(
    raw_shape: Sequence[int], first_shape: Sequence[int]
) -> bool:
    """Reference 2D/3D detection (``view.py:144-152``).

    2D training snapshots hold batches: 5-D ``(b, c, 1, y, x)``
    predictions next to 4-D ``(b, c, y, x)`` raw; a 3D snapshot has a
    real z extent instead.
    """
    shape = tuple(first_shape)
    raw_shape = tuple(raw_shape)
    if len(shape) == 5:
        return shape[-3] == 1 and len(raw_shape) == 4
    if len(shape) == 4:
        if raw_shape[0] == 1:
            return False
        return raw_shape != shape
    return False


def coordinate_space(voxel_size: Sequence[float], is_2d: bool) -> CoordSpec:
    """Reference ``create_coordinate_space`` (``view.py:48-59``)."""
    voxel_size = list(voxel_size)
    if is_2d:
        return CoordSpec(
            names=["b", "c^", "y", "x"],
            scales=voxel_size[-2:] + voxel_size[-2:],
        )
    return CoordSpec(names=["c^", "z", "y", "x"], scales=[1] + voxel_size)


def shader_for(ds_name: str, is_2d: bool) -> str:
    """Reference ``create_shader`` (``view.py:91-122``): 2D predictions
    render two channels (RG), everything else full RGB."""
    if is_2d and ds_name != "raw":
        return RG_SHADER
    return RGB_SHADER


def is_segmentation(ds_name: str) -> bool:
    """Reference layer-type choice (``view.py:167``)."""
    return "label" in ds_name or "seg" in ds_name


def dataset_layer(
    ds_name: str,
    shape: Sequence[int],
    voxel_size: Sequence[float],
    offset: Sequence[float],
    is_2d: bool,
) -> LayerSpec:
    """Per-dataset squeeze/offset/shader decisions
    (``view.py:62-88,163-180``)."""
    shape = tuple(shape)
    vs = list(voxel_size)
    off = list(offset)
    squeeze_axis = None
    if is_2d and ds_name != "raw" and len(shape) == 5:
        squeeze_axis = len(shape) - 3  # the singleton z
        off = off[1:]
        vs = vs[1:]
    elif is_2d and ds_name == "raw" and len(shape) == 4 and len(vs) == 3:
        # trim the z entry from BOTH voxel size and offset, else the
        # world->voxel conversion below pairs (z_off, vy)/(y_off, vx)
        # and drops x, displacing the raw layer under nonzero offsets
        off = off[1:]
        vs = vs[1:]
    vox = [int(o / v) for o, v in zip(off, vs)]
    voxel_offset = ([0, 0] if is_2d else [0]) + vox
    seg = is_segmentation(ds_name)
    return LayerSpec(
        name=ds_name,
        kind="segmentation" if seg else "image",
        shader=None if seg else shader_for(ds_name, is_2d),
        voxel_offset=voxel_offset,
        squeeze_axis=squeeze_axis,
    )


def snapshot_view_spec(
    datasets: Dict[str, Tuple[Sequence[int], Sequence[float], Sequence[float]]],
) -> ViewSpec:
    """Build the full snapshot view from dataset metadata.

    ``datasets`` maps name -> (shape, voxel_size, world_offset), in
    snapshot-container order.  Mirrors the reference's snapshot loop
    (``view.py:134-186``): 2D-ness is decided once from ``raw`` vs the
    first dataset, one coordinate space is shared by every layer, and
    the layout starts on the yz cross-section.
    """
    if not datasets:
        raise ValueError("snapshot container holds no datasets")
    names = list(datasets)
    first = names[0]
    raw_shape = datasets.get("raw", datasets[first])[0]
    # compare raw against a PREDICTION dataset: snapshot_metadata moves
    # ``raw`` to the front, so ``first`` is usually raw itself and
    # detect_2d(raw, raw) would never fire for 2D snapshots (4-D raw
    # vs 5-D (b,c,1,y,x) preds is the signal, view.py:144-152)
    first_pred = next((n for n in names if n != "raw"), first)
    is_2d = detect_2d(raw_shape, datasets[first_pred][0])
    vs = list(datasets[first][1])
    spec = ViewSpec(dims=coordinate_space(vs, is_2d), is_2d=is_2d)
    for name, (shape, voxel_size, offset) in datasets.items():
        spec.layers.append(
            dataset_layer(name, shape, voxel_size, offset, is_2d)
        )
    return spec
