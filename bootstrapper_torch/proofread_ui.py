"""Interactive proofreading UI plumbing, headlessly testable (the JAX
package's ``proofread_ui.py``).

The reference drives its SAM proofreading through a neuroglancer viewer
(reference ``ng_interactive_sam.py:133-214``): three layers (image,
labels, a linked point/box annotation layer), single-key action
bindings, and annotation parsing that turns the user's points/boxes
into selected segment ids and spatial masks.  All of that is pure state
manipulation except the final viewer construction, so — like
``cli/view_spec.py`` — the logic lives here as plain functions over
duck-typed annotation objects and the neuroglancer adapter stays a thin
shell, importing neuroglancer only where it is first needed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

#: key -> action name, matching the reference's bindings
#: (``ng_interactive_sam.py:156-160``)
PROOFREAD_KEYBINDINGS: Dict[str, str] = {
    "s": "segment",
    "m": "merge_labels",
    "u": "unmerge_labels",
    "f": "filter_labels",
    "o": "omit_labels",
    "w": "write_data",
}

ANNOTATION_COLOR = "#FC1DF4"  # reference ``ng_interactive_sam.py:141``


@dataclass
class ProofreadLayerSpec:
    name: str
    kind: str  # "image" | "segmentation" | "annotation"
    linked_segmentation: Optional[str] = None
    color: Optional[str] = None


def proofread_layer_specs() -> List[ProofreadLayerSpec]:
    """The reference's three-layer session (``_setup_viewer``)."""
    return [
        ProofreadLayerSpec("image", "image"),
        ProofreadLayerSpec("labels", "segmentation"),
        ProofreadLayerSpec(
            "merge_split", "annotation",
            linked_segmentation="labels", color=ANNOTATION_COLOR,
        ),
    ]


def start_position(vol_shape: Sequence[int]) -> List[int]:
    """Open centred in the volume (``_setup_viewer``: shape // 2)."""
    return [int(s) // 2 for s in vol_shape]


def selected_ids(annotations) -> Set[int]:
    """Segment ids referenced by point/line annotations
    (``_get_selected_ids``): linked segmentation layers populate a
    ``segments`` list-of-lists per annotation."""
    out: Set[int] = set()
    for anno in annotations:
        segs = getattr(anno, "segments", None)
        if segs:
            for sub in segs:
                if isinstance(sub, (list, tuple, np.ndarray)):
                    out.update(int(i) for i in sub)
                else:
                    out.add(int(sub))
    return out


def spatial_mask(
    annotations,
    shape: Sequence[int],
    crop_offset: Sequence[float],
    voxel_size: Sequence[float],
) -> Optional[np.ndarray]:
    """Boolean mask from axis-aligned bounding-box annotations
    (``_get_spatial_mask``): world-unit corners -> voxel slab within the
    current crop; None when no box annotations exist."""
    mask = np.zeros(tuple(int(s) for s in shape), dtype=bool)
    has_spatial = False
    crop_offset = np.asarray(crop_offset, float)
    voxel_size = np.asarray(voxel_size, float)
    for anno in annotations:
        pa = getattr(anno, "point_a", None)
        pb = getattr(anno, "point_b", None)
        if pa is None or pb is None:
            continue
        has_spatial = True
        mn = np.minimum(np.asarray(pa, float), np.asarray(pb, float))
        mx = np.maximum(np.asarray(pa, float), np.asarray(pb, float))
        lo = np.maximum(
            0, np.floor((mn - crop_offset) / voxel_size)
        ).astype(int)
        hi = np.minimum(
            np.asarray(shape), np.ceil((mx - crop_offset) / voxel_size)
        ).astype(int)
        if np.any(hi <= lo):
            continue
        mask[tuple(slice(a, b) for a, b in zip(lo, hi))] = True
    return mask if has_spatial else None


def patch_bounds(
    position: Sequence[float],
    vol_shape: Sequence[int],
    patch_shape: Sequence[int] = (3, 512, 512),
) -> Tuple[np.ndarray, np.ndarray]:
    """Clamped crop bounds around the cursor for a prompted segmentation
    (``_segment``: PATCH_SHAPE window centred on the position)."""
    pos = np.asarray(position, int)
    patch = np.asarray(patch_shape, int)
    spos = np.maximum(0, pos - patch // 2)
    epos = np.minimum(np.asarray(vol_shape, int), spos + patch)
    return spos, epos


def launch_viewer(session, bind_address: str = "0.0.0.0"):
    """Drive a :class:`ProofreadSession` in neuroglancer when the
    package is importable: layers from :func:`proofread_layer_specs`,
    actions wired to the session's merge/unmerge/omit/filter/write API,
    key bindings from :data:`PROOFREAD_KEYBINDINGS`."""
    import neuroglancer

    neuroglancer.set_server_bind_address(bind_address)
    viewer = neuroglancer.Viewer()
    dims = neuroglancer.CoordinateSpace(
        names=["z", "y", "x"], units="nm",
        scales=list(session.raw.voxel_size),
    )
    raw_vol = neuroglancer.LocalVolume(
        data=session.raw.to_ndarray(), dimensions=dims
    )
    labels_vol = neuroglancer.LocalVolume(
        data=session.labels, dimensions=dims
    )
    with viewer.txn() as s:
        for spec in proofread_layer_specs():
            if spec.kind == "image":
                s.layers[spec.name] = neuroglancer.ImageLayer(source=raw_vol)
            elif spec.kind == "segmentation":
                s.layers[spec.name] = neuroglancer.SegmentationLayer(
                    source=labels_vol
                )
            else:
                s.layers[spec.name] = neuroglancer.LocalAnnotationLayer(
                    linked_segmentation_layer={
                        "segments": spec.linked_segmentation
                    },
                    dimensions=dims,
                    annotation_color=spec.color,
                )
        s.layout = "yz"
        s.position = start_position(session.raw.spatial_shape)

    def annos(s):
        return s.viewer_state.layers["merge_split"].annotations

    def do_segment(s):
        pos = s.viewer_state.position
        if pos is None:
            return
        vs = session.raw.voxel_size
        world = [
            o + int(p) * v
            for o, p, v in zip(session.raw.offset, pos, vs)
        ]
        session.segment_from_point(world)
        labels_vol.invalidate()

    def do_merge(s):
        ids = selected_ids(annos(s))
        if ids:
            session.merge(sorted(ids))
            labels_vol.invalidate()

    def do_unmerge(s):
        for i in selected_ids(annos(s)):
            session.unmerge(i)
        labels_vol.invalidate()

    def do_omit(s):
        for i in selected_ids(annos(s)):
            session.omit(i)

    def do_filter(s):
        session.filter_small(64)
        labels_vol.invalidate()

    def do_write(s):
        session.write("proofread_output.zarr")

    actions = {
        "segment": do_segment,
        "merge_labels": do_merge,
        "unmerge_labels": do_unmerge,
        "filter_labels": do_filter,
        "omit_labels": do_omit,
        "write_data": do_write,
    }
    for name, fn in actions.items():
        viewer.actions.add(name, fn)
    with viewer.config_state.txn() as s:
        for key, action in PROOFREAD_KEYBINDINGS.items():
            s.input_event_bindings.data_view[f"key{key}"] = action
    return viewer
