"""Exact min-cut edit metrics: splits/merges needed to fix a segmentation
(a copy of the JAX package's ``eval/mincut.py``; networkx is imported
where a function first needs it).

Parity with the reference's mincut metric (reference
``bootstrapper/eval/evaluate_thresholds.py:285-470`` built on funlib
``split_graph``): for every *merging* segment (one whose ground-truth
skeleton sites span more than one skeleton), the fragments of each
skeleton form seed sets in the segment's RAG; recursive min-cuts
separate the seed sets, counting one split per cut, with edge capacity
``1 - merge_score``.  Fragments shared by several skeletons are
unsplittable and excluded.  Merges needed = per-skeleton segment count
minus one, plus the additional merges required to re-join seed sets that
the min-cuts themselves fragmented.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

_INF = float("inf")


def split_graph(
    graph: nx.Graph,
    components: Sequence[Sequence],
    weight_attribute: str = "weight",
    split_attribute: str = "split",
    impl: str = "auto",
) -> int:
    """Separate the seed-node sets in ``components`` by recursive min-cuts.

    Mutates ``graph``: writes a part label to ``split_attribute`` on every
    node.  Returns the number of cuts performed (funlib
    ``split_graph`` semantics).

    ``impl``: "native" (C++ Dinic, default when available — the
    networkx preflow-push path measured ~90% of a skeleton-dense
    threshold sweep, tools/eval_scale_probe.py), "nx" (the reference
    implementation below, kept as the dual pin), or "auto"."""
    if impl == "auto":
        import os

        impl = "nx" if os.environ.get("BS_MINCUT") == "nx" else "native"
    if impl == "native":
        from .. import native

        nodes = list(graph.nodes)
        dense = {n: i for i, n in enumerate(nodes)}
        eu, ev, cap = [], [], []
        for u, v, d in graph.edges(data=True):
            eu.append(dense[u])
            ev.append(dense[v])
            cap.append(max(float(d.get(weight_attribute, 1.0)), 1e-9))
        comps = [
            [dense[n] for n in comp if n in dense]
            for comp in components
        ]
        labels, n_splits = native.split_graph_mincut(
            len(nodes), eu, ev, cap, comps
        )
        for n, lab in zip(nodes, labels):
            graph.nodes[n][split_attribute] = int(lab)
        return n_splits
    import networkx as nx

    h = graph.copy()
    num_splits = 0
    while True:
        part_of = {}
        for pi, part in enumerate(nx.connected_components(h)):
            for n in part:
                part_of[n] = pi
        by_part: Dict[int, List[int]] = {}
        for ci, nodes in enumerate(components):
            for p in {part_of[n] for n in nodes if n in part_of}:
                lst = by_part.setdefault(p, [])
                if ci not in lst:
                    lst.append(ci)
        target = next((p for p, cs in by_part.items() if len(cs) > 1), None)
        if target is None:
            break
        cs = by_part[target]
        part_nodes = [n for n in h if part_of[n] == target]
        sub = nx.Graph()
        sub.add_nodes_from(part_nodes)
        for u, v, d in h.subgraph(part_nodes).edges(data=True):
            sub.add_edge(
                u, v, capacity=max(float(d.get(weight_attribute, 1.0)), 1e-9)
            )
        source, sink = ("__source__",), ("__sink__",)
        seeds_a = [n for n in components[cs[0]] if n in part_of]
        seeds_b = [
            n for n in components[cs[1]] if n in part_of and n not in seeds_a
        ]
        for n in seeds_a:
            sub.add_edge(source, n, capacity=_INF)
        for n in seeds_b:
            sub.add_edge(sink, n, capacity=_INF)
        try:
            _, (side_s, _) = nx.minimum_cut(sub, source, sink)
        except nx.NetworkXUnbounded:
            # seed sets inseparable (shouldn't happen once unsplittable
            # fragments are removed) -- give up on this part
            break
        side_s = set(side_s)
        cut_edges = [
            (u, v)
            for u, v in h.subgraph(part_nodes).edges()
            if (u in side_s) != (v in side_s)
        ]
        if not cut_edges:
            break
        h.remove_edges_from(cut_edges)
        num_splits += 1
    for pi, part in enumerate(nx.connected_components(h)):
        for n in part:
            graph.nodes[n][split_attribute] = pi
    return num_splits


def compute_edits(
    skeleton_comps: Sequence[set],
    node_frag: Dict,
    node_seg: Dict,
    frag_ids: np.ndarray,
    frag_seg: np.ndarray,
    edge_u: np.ndarray,
    edge_v: np.ndarray,
    edge_score: np.ndarray,
    threshold: float,
) -> Dict:
    """Exact splits/merges-needed for one threshold.

    - ``skeleton_comps``: list of node sets, one per ground-truth skeleton
    - ``node_frag`` / ``node_seg``: skeleton node -> fragment / segment id
    - ``frag_ids`` / ``frag_seg``: fragment id -> its segment at threshold
    - ``edge_*``: the full RAG edge list (fragment ids + merge scores)
    """
    # per-skeleton nonzero segment sets (split stats)
    merges_needed = 0
    seg_to_comps: Dict[int, List[int]] = {}
    for ci, comp in enumerate(skeleton_comps):
        segs = {node_seg.get(n, 0) for n in comp} - {0}
        merges_needed += max(0, len(segs) - 1)
        for s in segs:
            seg_to_comps.setdefault(int(s), []).append(ci)
    merging_segments = {s: cs for s, cs in seg_to_comps.items() if len(cs) > 1}

    if not merging_segments:
        return {
            "splits_needed": 0,
            "merges_needed": merges_needed,
            "unsplittable_fragments": 0,
            "merging_segments": 0,
        }

    seg_of = {int(f): int(s) for f, s in zip(frag_ids, frag_seg)}
    # group RAG edges (<= threshold, intra-segment) by segment
    seg_edges: Dict[int, List] = {s: [] for s in merging_segments}
    for u, v, sc in zip(edge_u, edge_v, edge_score):
        if sc > threshold:
            continue
        su = seg_of.get(int(u))
        if su in merging_segments and seg_of.get(int(v)) == su:
            seg_edges[su].append((int(u), int(v), float(sc)))

    splits_needed = 0
    n_unsplittable = 0
    for seg_id, comp_ids in merging_segments.items():
        # seed fragment sets per skeleton in this segment
        seed_sets: Dict[int, set] = {}
        frag_comps: Dict[int, set] = {}
        for ci in comp_ids:
            for n in skeleton_comps[ci]:
                f = int(node_frag.get(n, 0))
                if f != 0 and node_seg.get(n, 0) == seg_id:
                    seed_sets.setdefault(ci, set()).add(f)
                    frag_comps.setdefault(f, set()).add(ci)
        unsplittable = {f for f, cs in frag_comps.items() if len(cs) > 1}
        n_unsplittable += len(unsplittable)
        comps = [
            sorted(s - unsplittable)
            for s in seed_sets.values()
            if s - unsplittable
        ]
        if len(comps) <= 1:
            continue
        import networkx as nx

        rag = nx.Graph()
        rag.add_nodes_from(int(f) for f in frag_ids[frag_seg == seg_id])
        for u, v, sc in seg_edges[seg_id]:
            rag.add_edge(u, v, weight=1.0 - sc)
        splits_needed += split_graph(rag, comps)
        # min-cuts may fragment a seed set: count re-joins
        for comp in comps:
            labels = {rag.nodes[f].get("split") for f in comp}
            merges_needed += len(labels) - 1

    return {
        "splits_needed": splits_needed,
        "merges_needed": merges_needed,
        "unsplittable_fragments": n_unsplittable,
        "merging_segments": len(merging_segments),
    }
