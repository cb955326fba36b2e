"""Host-side batch sampling: random locations over Zarr volumes with
rejection, padding, and normalisation (a copy of the JAX package's
``train/sampler.py`` on the port's ``core/arrays.py``, with the same
seeded numpy draws, so that both packages cut the same crops).

This replaces the gunpowder source chain — ArraySource + MergeProvider +
Normalize + Pad + RandomLocation + Reject(min_masked) + RandomProvider
(usage: reference ``bootstrapper/models/3d_affs/train.py:74-100``) — with
a compact host sampler: numpy reads the chunks and does rejection;
everything downstream (augments, label->target transforms) runs on
device.

The sampler yields dicts of numpy arrays for one training example; a
``BatchLoader`` wraps it with a thread pool + prefetch queue so Zarr IO
overlaps device compute (the reference used PreCache subprocess pools).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional, Sequence

import numpy as np

from ..core.arrays import Array, open_ds
from ..core.geometry import Coordinate, Roi
from ..utils.profiling import span


def normalize_raw(raw: np.ndarray) -> np.ndarray:
    """uint8/uint16 -> float32 in [0,1] (gp.Normalize capability)."""
    if raw.dtype == np.uint8:
        return raw.astype(np.float32) / 255.0
    if raw.dtype == np.uint16:
        return raw.astype(np.float32) / 65535.0
    if np.issubdtype(raw.dtype, np.floating):
        return raw.astype(np.float32)
    raise ValueError(f"unsupported raw dtype {raw.dtype}")


class Sample:
    """One training sample: raw + labels (+ optional mask) arrays."""

    def __init__(self, raw: Array, labels: Array, mask: Optional[Array] = None):
        self.raw = raw
        self.labels = labels
        self.mask = mask

    @classmethod
    def open(cls, raw_path, labels_path, mask_path=None):
        return cls(
            open_ds(raw_path),
            open_ds(labels_path),
            open_ds(mask_path) if mask_path else None,
        )


class RandomLocationSampler:
    """Uniform random crops with Reject(min_masked) semantics.

    Picks a random output-sized ROI inside the labels ROI, grows it by
    the raw context for the input crop (reads are zero-padded when the
    grown ROI exceeds the raw extent, gp.Pad capability), and rejects
    crops whose mask coverage is below ``min_masked``.
    """

    def __init__(
        self,
        samples: Sequence[Sample],
        input_size: Coordinate,
        output_size: Coordinate,
        min_masked: float = 0.5,
        max_tries: int = 50,
        seed: Optional[int] = None,
    ):
        # label-id clamping lives in the device-side renumber
        # (pipeline/training.py MAX_LABELS), not in the sampler
        assert samples, "need at least one sample"
        self.samples = list(samples)
        self.input_size = Coordinate(input_size)
        self.output_size = Coordinate(output_size)
        self.context = (self.input_size - self.output_size) / 2
        self.min_masked = min_masked
        self.max_tries = max_tries
        self.rng = np.random.default_rng(seed)
        # numpy Generators are not thread-safe; BatchLoader runs several
        # sampling threads
        self._rng_lock = threading.Lock()

    def _random_output_roi(self, sample: Sample) -> Roi:
        vs = sample.labels.voxel_size
        room = sample.labels.roi.shape - self.output_size
        with self._rng_lock:
            begin = Coordinate(
                0 if r <= 0 else int(self.rng.integers(0, r // v + 1)) * v
                for r, v in zip(room, vs)
            )
        return Roi(sample.labels.roi.offset + begin, self.output_size)

    def sample(self) -> dict:
        for _ in range(self.max_tries):
            with self._rng_lock:
                s = self.samples[int(self.rng.integers(0, len(self.samples)))]
            out_roi = self._random_output_roi(s)
            labels = s.labels.to_ndarray(out_roi)
            if s.mask is not None:
                mask = s.mask.to_ndarray(out_roi)
                if (mask > 0).mean() < self.min_masked:
                    continue
                mask = (mask > 0).astype(np.uint8)
            else:
                mask = (labels > 0).astype(np.uint8)
                if self.min_masked > 0 and mask.mean() < self.min_masked:
                    continue
            in_roi = out_roi.grow(self.context, self.context)
            # raw ships as stored bytes; labels ship as raw ids folded to
            # 32 bits — normalisation and dense renumbering both run on
            # device (pipeline.training.device_renumber), keeping the
            # 1-core host out of the per-iteration critical path
            raw = s.raw.to_ndarray(in_roi)
            return {
                "raw": raw,
                "labels": fold_ids_u32(labels),
                "mask": mask,
                "roi": out_roi,
            }
        raise RuntimeError(
            f"rejected {self.max_tries} crops (min_masked={self.min_masked})"
        )


class ArtifactSampler:
    """Random input-tile crops from artifact volumes (+ alpha masks) for
    defect blending — the host side of the reference's
    ``artifact_source`` provider (``gp/defect_augment.py:44-53``): a
    second source queried for ``artifacts`` intensities and an
    ``artifacts_mask`` alpha, here a Zarr pair per sample."""

    def __init__(
        self,
        samples: Sequence,  # (artifact Array, alpha-mask Array | None) pairs
        crop_shape: Coordinate,  # VOXELS (the training input tile)
        seed: Optional[int] = None,
    ):
        assert samples, "need at least one artifact sample"
        self.samples = [
            s if isinstance(s, tuple) else (s, None) for s in samples
        ]
        # the crop is specified in voxels, not world units: the blend
        # happens tile-on-tile in the device transform, so every sample
        # must yield exactly crop_shape voxels even when the artifact
        # volume's voxel size differs from the training volume's
        self.crop_shape = Coordinate(crop_shape)
        self.rng = np.random.default_rng(seed)
        self._rng_lock = threading.Lock()

    @classmethod
    def open(cls, specs: Sequence[dict], crop_shape, seed=None):
        """specs: [{"artifacts": path, "artifacts_mask": path?}, ...]"""
        pairs = [
            (
                open_ds(s["artifacts"]),
                open_ds(s["artifacts_mask"]) if s.get("artifacts_mask")
                else None,
            )
            for s in specs
        ]
        return cls(pairs, crop_shape, seed=seed)

    def sample(self) -> dict:
        with self._rng_lock:
            art, msk = self.samples[
                int(self.rng.integers(0, len(self.samples)))
            ]
            vs = art.voxel_size
            crop_size = self.crop_shape * vs  # world units, per volume
            room = art.roi.shape - crop_size
            begin = Coordinate(
                0 if r <= 0 else int(self.rng.integers(0, r // v + 1)) * v
                for r, v in zip(room, vs)
            )
        roi = Roi(art.roi.offset + begin, crop_size)
        raw = normalize_raw(art.to_ndarray(roi))
        if msk is not None:
            mask = (msk.to_ndarray(roi) > 0).astype(np.float32)
        else:
            mask = (raw > 0).astype(np.float32)
        return {"artifact": raw, "artifact_mask": mask}


def fold_ids_u32(labels: np.ndarray) -> np.ndarray:
    """Label ids as uint32 for device transfer; ids beyond 2^32 (e.g.
    block-bumped pseudo-GT fragments) are xor-folded — 0 stays 0 and
    distinct ids collide with probability ~K^2/2^33 per crop.  A
    nonzero id whose halves are equal would fold to 0 (background);
    those are remapped to an odd id instead so no foreground label
    silently disappears from the training targets."""
    labels = np.asarray(labels)
    if labels.dtype == np.uint32:
        return labels
    src = labels.astype(np.uint64, copy=False)
    if src.size and int(src.max()) >> 32:
        folded = (src ^ (src >> np.uint64(32))).astype(np.uint32)
        folded[(src != 0) & (folded == 0)] = np.uint32(1)
        return folded
    return src.astype(np.uint32)


def renumber(labels: np.ndarray, max_labels: Optional[int] = None) -> np.ndarray:
    """Dense relabel to 0..K-1 preserving background 0 (gp Renumber
    capability, ``gp/renumber.py:5-27``; device ops need small dense ids).

    Vectorised via rank lookup — this runs per training draw on
    multi-megavoxel crops, so no per-id python loops.
    """
    ids = np.unique(labels)  # sorted
    ranks = np.searchsorted(ids, labels)
    if len(ids) and ids[0] == 0:
        out = ranks.astype(np.int32)  # background keeps rank 0
    else:
        out = (ranks + 1).astype(np.int32)
    if max_labels is not None and len(ids) >= max_labels:
        # clamp rare overflow: merge extra ids into max_labels-1
        out = np.minimum(out, max_labels - 1)
    return out


class BatchLoader:
    """Threaded prefetcher: stacks ``batch_size`` sampler draws into
    batched numpy arrays and keeps ``prefetch`` batches ready
    (gp.PreCache capability, host threads instead of subprocesses —
    file reads and numpy copies release the GIL).  Spans: ``bs.train.draw``
    on the workers, ``bs.train.loader_wait`` on the caller of ``next``."""

    def __init__(self, sample_fn: Callable[[], dict], batch_size: int,
                 prefetch: int = 4, num_threads: int = 2):
        self.sample_fn = sample_fn
        self.batch_size = batch_size
        self.q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self.threads = [
            threading.Thread(target=self._work, daemon=True)
            for _ in range(num_threads)
        ]
        for t in self.threads:
            t.start()

    def _make_batch(self):
        with span("bs.train.draw"):
            draws = [self.sample_fn() for _ in range(self.batch_size)]
            keys = [k for k in draws[0] if k != "roi"]
            return {k: np.stack([d[k] for d in draws]) for k in keys}

    def _work(self):
        while not self._stop.is_set():
            try:
                batch = self._make_batch()
            except Exception as e:  # surface errors to consumer
                self.q.put(e)
                return
            self.q.put(batch)

    def __iter__(self):
        return self

    def __next__(self):
        with span("bs.train.loader_wait"):
            item = self.q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def stop(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
