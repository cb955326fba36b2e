"""Proofreading cells: a ``ProofreadSession`` with a SAM checkpoint, as
``bs-torch proofread --sam-checkpoint`` runs it, paging through the
sections of a volume and clicking objects in each; then the window's first
sections held against the plain reference.

Set-up draws the checkpoint's weights on the card from the seed
(``bmk/sam_weights.py``), writes them under ``TMPDIR`` and opens the
session on that path, so that the program loads them by
``models/sam.py:load_sam``.  The raw is a Voronoi sample's (dark membranes
and noise: masks have edges to follow), held in memory; its labels give
each section's objects and, for each, the point farthest from its membrane
(``object_points``).  The run starts at a section drawn from the seed and
walks the sections in order, wrapping at the end; on each it clicks
``clicks_per_section`` of its objects, drawn from the seed, one positive
point each at that point, through ``segment_from_point``: the first click
embeds the section (``set_image``), each one decodes, resizes the masks to
the section, copies them to the host, takes the mask of highest predicted
IOU and writes the label.  The window's end-to-end numbers are its wall
time over its sections (``section_ms``) and the mean of its sections'
first clicks (``first_mask_ms``): the wait on paging to a section, its
read, embedding and first mask.

The check is the window's own first ``check_sections`` sections: a hook
on the session's mask decoder keeps, for each of their clicks, device
copies of the embedding it decoded from and of the decoder's masks and
IOUs, and the session's labels of those sections are the window's output.
After the window the reference recomputes the embeddings, masks and IOUs,
and replays each click's label write from its own masks.
"""

from __future__ import annotations

import gc
import os
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from . import flops
from .data import seed32, voronoi_sample
from .predict import on_cuda
from .sam_weights import make_sam_weights
from .trace import Tracer, span

#: the configuration's keys that are the program's ``SamConfig`` fields
SAM_KEYS = ("encoder_dim", "encoder_depth", "encoder_heads", "global_attn_indexes", "img_size", "patch_size",
            "window_size", "prompt_dim", "decoder_heads", "num_mask_tokens", "decoder_depth", "decoder_mlp_dim",
            "iou_head_hidden_dim")
#: a pixel of a replayed label write is sure where the reference's logit
#: lies beyond this share of its largest magnitude from 0
FLIP_MARGIN = 1e-3
#: multimask outputs whose reference IOU lies within this of the best one's
#: are tied: the label replay admits any of them
IOU_TIE = 1e-3
#: an object is clicked only where some pixel of it lies this many pixels
#: (chessboard) from its membrane
MIN_DEPTH = 4
#: dilations that measure a pixel's distance from the membrane
DEPTH_REACH = 64


def sam_config(cfg: dict) -> dict:
    return {k: cfg[k] for k in SAM_KEYS}


def object_points(labels: np.ndarray, device) -> list:
    """For each section of ``labels``, ``[(y, x)]`` of its objects (nonzero
    ids, in id order) that reach ``MIN_DEPTH``: each object's pixel farthest
    from any pixel of another id (chessboard distance, the first in raster
    order among equals)."""
    d, h, w = labels.shape
    out = []
    chunk = max(1, (1 << 26) // (h * w))
    flat = torch.arange(h * w, device=device)
    for z0 in range(0, d, chunk):
        lab = torch.from_numpy(np.ascontiguousarray(labels[z0 : z0 + chunk]).view(np.int64)).to(device)
        edge = torch.zeros(lab.shape, dtype=torch.bool, device=device)
        for axis in (1, 2):
            diff = lab.diff(dim=axis) != 0
            edge.narrow(axis, 1, diff.shape[axis]).logical_or_(diff)
            edge.narrow(axis, 0, diff.shape[axis]).logical_or_(diff)
        cover = edge[:, None].float()
        depth = torch.zeros(lab.shape, dtype=torch.int32, device=device)
        for _ in range(DEPTH_REACH):
            depth += cover[:, 0] == 0
            cover = F.max_pool2d(cover, 3, 1, 1)
        for z in range(lab.shape[0]):
            ids, dep = lab[z].reshape(-1), depth[z].reshape(-1)
            keep = ids != 0
            uniq, inv = torch.unique(ids[keep], return_inverse=True)
            key = dep[keep].long() * (h * w) + (h * w - 1 - flat[keep])
            best = torch.full((len(uniq),), -1, dtype=torch.long, device=device).scatter_reduce(0, inv, key, "amax")
            best = best[best // (h * w) >= MIN_DEPTH]
            pix = h * w - 1 - best % (h * w)
            out.append(torch.stack([pix // w, pix % w], 1).cpu().numpy())
    return out


class Plan:
    """The sections and clicks of a run, drawn from the seed: a start
    section, then the sections in order, wrapping; on each visit
    ``clicks_per_section`` of the section's objects, each at its point."""

    def __init__(self, traffic: dict, seed: int, objects: list):
        self.depth = int(traffic["volume"][0])
        self.clicks = int(traffic["clicks_per_section"])
        self.objects = objects
        self.rng = np.random.default_rng(seed32(seed, 7))
        self.next = int(self.rng.integers(self.depth))

    def visit(self) -> tuple:
        """``(z, [(y, x)] * clicks)`` of the next section."""
        z = self.next
        self.next = (z + 1) % self.depth
        pts = self.objects[z]
        if not len(pts):
            raise ValueError(f"section {z} holds no object to click")
        pick = self.rng.choice(len(pts), self.clicks, replace=len(pts) < self.clicks)
        return z, [(int(pts[i][0]), int(pts[i][1])) for i in pick]


def with_span(name, fn):
    def spanned(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)

    return spanned


def run(cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
        out: dict, quantize=None) -> dict:
    """One run of a proofreading cell; fills and returns ``out``.
    ``quantize`` (the control's runs): the reference in that precision
    (``bf16``, or ``tf32``: fp32 with TF32 on everywhere) takes the
    program's place on the check sections, and there is no window."""
    from bootstrapper_torch.core.arrays import Array

    scfg = sam_config(cfg)
    vol, vs = tuple(traffic["volume"]), tuple(traffic["voxel_size"])
    n_cells = max(8, int(np.prod(vol)) // int(traffic["cell_voxels"]))
    marks = {"start": time.perf_counter() - t_start}
    sample = voronoi_sample(vol, n_cells, seed, device)
    raw_np = sample["raw"]
    objects = object_points(sample["labels"], device)
    del sample
    marks["sample"] = time.perf_counter() - t_start
    plan = Plan(traffic, seed, objects)
    clicks = plan.clicks
    warm = [plan.visit() for _ in range(int(traffic["warm_sections"]))]
    checks = [plan.visit() for _ in range(int(traffic["check_sections"]))]
    # the session numbers its segments from 1, one a click
    first_id = 1 + len(warm) * clicks
    if len({z for z, _ in warm + checks}) < len(warm) + len(checks):
        raise ValueError(f"a volume of {plan.depth} sections is too shallow for the warm and check sections")
    if quantize is not None:
        got = reference_as_program(scfg, raw_np, checks, first_id, seed, device, quantize)
        out.update(setup_s=0.0, window_s=0.0, attempted=0, failed=0, memory_peak_bytes=0, e2e={})
        out["numbers"], out["detail"] = compare(scfg, raw_np, checks, got, first_id, seed, device)
        return out

    from bootstrapper_torch.proofread import ProofreadSession

    work = tempfile.mkdtemp(prefix="bmk_sam_", dir=os.environ.get("TMPDIR"))
    try:
        ckpt = os.path.join(work, "sam.pth")
        torch.save({k: v.cpu() for k, v in make_sam_weights(scfg, seed32(seed, 8), device).items()}, ckpt)
        marks["checkpoint"] = time.perf_counter() - t_start
        raw = Array.from_ndarray(raw_np, (0, 0, 0), vs)
        session = ProofreadSession(raw, sam_checkpoint=ckpt, device=device)
        os.remove(ckpt)
        marks["session"] = time.perf_counter() - t_start
        sam = session._sam
        if sam is None:
            raise RuntimeError("the session loaded no SAM checkpoint")
        got_cfg = {k: getattr(sam.cfg, k) for k in SAM_KEYS}
        if {k: list(v) if isinstance(v, tuple) else v for k, v in got_cfg.items()} != scfg:
            raise RuntimeError(f"the program took the checkpoint for {got_cfg}, the configuration is {scfg}")
        # the harness's spans around the predictor's two calls
        sam.set_image = with_span("bmk.embed", sam.set_image)
        sam.predict = with_span("bmk.prompt", sam.predict)
        check_z = [z for z, _ in checks]
        labels = {}

        def section(z, points) -> float:
            """Clicks ``points`` on section ``z``; returns the seconds of the
            first click, which embeds the section."""
            # a check section's labels, before a later visit writes more
            if z in check_z and z not in labels and len(caught) == len(checks) * clicks:
                labels[z] = session.labels[z].copy()
            with span("bmk.section"):
                for i, (y, x) in enumerate(points):
                    t = time.perf_counter()
                    with span("bmk.click"):
                        session.segment_from_point((z * vs[0], y * vs[1], x * vs[2]))
                    if i == 0:
                        first_s = time.perf_counter() - t
            return first_s

        caught, embeddings = [], []

        def catch(mod, args, res):
            """Device copies of what a check click decoded from and gave."""
            if not embeddings or embeddings[-1][0] is not args[0]:
                embeddings.append((args[0], args[0].detach().clone()))
            caught.append((len(embeddings) - 1, res[0][0].detach().clone(), res[1][0].detach().clone()))

        for v in warm:
            section(*v)
        if on_cuda(device):
            torch.cuda.synchronize()
        marks["warm"] = time.perf_counter() - t_start

        hook = sam.model.mask_decoder.register_forward_hook(catch)
        t_w0 = time.perf_counter()
        section_s, first_s = [], []
        while True:
            t = time.perf_counter()
            n = len(section_s)
            first_s.append(section(*(checks[n] if n < len(checks) else plan.visit())))
            if n + 1 == len(checks):
                hook.remove()
            section_s.append(time.perf_counter() - t)
            if len(section_s) >= len(checks) and time.perf_counter() - t_w0 >= seconds:
                break
        if on_cuda(device):
            torch.cuda.synchronize()
        t_w1 = time.perf_counter()
        sections = len(section_s)
        for z in check_z:
            labels.setdefault(z, session.labels[z].copy())
        out["section_s"] = section_s
        out["first_mask_s"] = first_s
        out.update(
            setup_s=t_w0 - t_start,
            window_s=t_w1 - t_w0,
            attempted=sections * clicks,
            failed=0,
            memory_peak_bytes=torch.cuda.max_memory_allocated(device) if on_cuda(device) else 0,
            e2e={"section_ms": (t_w1 - t_w0) / sections * 1e3, "first_mask_ms": sum(first_s) / sections * 1e3},
        )
        record = {
            "kind": "proofread",
            "window_s": t_w1 - t_w0,
            "sections": sections,
            "flops_per_section": flops.sam_section_flops(scfg, clicks),
            "trace": None,
            "trace_sections": 0,
        }
        if trace:
            n = int(traffic["trace_sections"])
            tracer = Tracer(device)
            with tracer:
                for _ in range(n):
                    section(*plan.visit())
            record.update(trace=tracer.events, trace_sections=n)
        out["record"] = record
        # seconds from the process's start to the end of each set-up stage
        out["setup_marks"] = marks

        if len(caught) != len(checks) * clicks:
            raise RuntimeError(f"the mask decoder ran {len(caught)} times in the check sections' "
                               f"{len(checks) * clicks} clicks")
        program = [{"embedding": embeddings[caught[k * clicks][0]][1][0],
                    "clicks": [c[1:] for c in caught[k * clicks : (k + 1) * clicks]],
                    "labels": labels[z]} for k, z in enumerate(check_z)]
        # the program's state goes before the reference runs
        del session, sam, raw, embeddings, caught
        gc.collect()
        if on_cuda(device):
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["numbers"], out["detail"] = compare(scfg, raw_np, checks, program, first_id, seed, device)
        out["check_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def reference_passes(scfg, raw_np, checks, seed, device, quantize=None):
    """The reference over the check sections, in fp32 with TF32 off, or in
    ``quantize``: yields ``(k, embedding)`` at each section and then
    ``(k, i, masks, iou, logits)`` at each of its clicks (the decoder's
    masks, its IOUs, the masks' logits at the section's size)."""
    from reference.sam import SamReference, precision

    dtype = torch.bfloat16 if quantize == "bf16" else torch.float32
    ref = SamReference(make_sam_weights(scfg, seed32(seed, 8), device), scfg, dtype)
    with torch.no_grad(), precision(tf32=quantize == "tf32"):
        for k, (z, points) in enumerate(checks):
            section = raw_np[z]
            emb = ref.embed(section, device)
            yield k, emb
            for i, (y, x) in enumerate(points):
                yield (k, i, *ref.predict(emb, (x, y), section.shape))
    del ref


def reference_as_program(scfg, raw_np, checks, first_id, seed, device, quantize) -> list:
    """The reference in ``quantize`` in the program's place: per check
    section its embedding, each click's masks and IOUs, and the labels that
    the session's write (the multimask output of highest IOU, where the
    label is still 0) makes of its masks, as the program's are kept."""
    clicks = len(checks[0][1])
    got = []
    for step in reference_passes(scfg, raw_np, checks, seed, device, quantize):
        if len(step) == 2:
            k, emb = step
            target = torch.zeros(raw_np.shape[1:], dtype=torch.int64, device=device)
            got.append({"embedding": emb[0].permute(1, 2, 0).float(), "clicks": [], "labels": target})
            continue
        k, i, masks, iou, logits = step
        got[k]["clicks"].append((masks.float(), iou.float()))
        best = 1 + int(torch.argmax(iou[1:].float()))
        target = got[k]["labels"]
        target[(logits[best] > 0) & (target == 0)] = first_id + k * clicks + i
    for g in got:
        g["labels"] = g["labels"].cpu().numpy().view(np.uint64)
    return got


def compare(scfg, raw_np, checks, program, first_id, seed, device) -> tuple:
    """``program``'s check sections against the fp32 reference's:
    ``(numbers, detail)``.  The numbers: the largest gap of the embeddings
    and of the decoder's masks, each over the reference's largest magnitude
    (per section, per click); the largest gap of the IOU predictions; and
    the share of the sections' pixels whose label differs from the
    reference's replay of the clicks' label writes, where the replay is
    sure.  The replay writes each click's id (from ``first_id``, one a
    click) where its mask is sure and the label is still 0: a pixel is sure
    in a click's mask where every multimask output tied for the best
    reference IOU (``IOU_TIE``) has a logit beyond ``FLIP_MARGIN`` of its
    largest magnitude, of the one sign; a pixel still 0 that some click's
    mask is unsure of stays unsure."""
    clicks = len(checks[0][1])
    embed_gap = logit_gap = iou_gap = 0.0
    flips = pixels = unsure_px = ties = 0
    mask_share = []
    want = unsure = None
    for step in reference_passes(scfg, raw_np, checks, seed, device):
        if len(step) == 2:
            k, emb = step
            r = emb[0].permute(1, 2, 0)
            p = program[k]["embedding"].to(r.device)
            embed_gap = max(embed_gap, float((p - r).abs().max() / r.abs().max()))
            want = torch.zeros(raw_np.shape[1:], dtype=torch.int64, device=r.device)
            unsure = torch.zeros(want.shape, dtype=torch.bool, device=r.device)
            continue
        k, i, masks, iou, logits = step
        p_masks, p_iou = (t.to(masks.device) for t in program[k]["clicks"][i])
        logit_gap = max(logit_gap, float((p_masks - masks).abs().max() / masks.abs().max()))
        iou_gap = max(iou_gap, float((p_iou - iou).abs().max()))
        multi = iou[1:]
        tied = 1 + torch.nonzero(multi >= multi.max() - IOU_TIE)[:, 0]
        ties += int(len(tied) > 1)
        lg = logits[tied]
        margin = FLIP_MARGIN * lg.abs().amax(dim=(1, 2), keepdim=True)
        pos, neg = (lg > margin).all(0), (lg < -margin).all(0)
        mask_share.append(round(float(pos.float().mean()), 4))
        free = (want == 0) & ~unsure
        unsure |= free & ~pos & ~neg
        want[free & pos] = first_id + k * clicks + i
        if i == clicks - 1:
            got = torch.from_numpy(np.ascontiguousarray(program[k]["labels"]).view(np.int64)).to(want.device)
            flips += int(((got != want) & ~unsure).sum())
            pixels += want.numel()
            unsure_px += int(unsure.sum())
    numbers = {"embed_gap": embed_gap, "logit_gap": logit_gap, "iou_gap": iou_gap,
               "label_flip_share": flips / max(pixels, 1)}
    detail = {"mask_share": mask_share, "tied_clicks": ties, "unsure_share": unsure_px / max(pixels, 1)}
    return numbers, detail
