"""Skeleton-based metrics: expected run length (ERL), merge/split counts
(a copy of the JAX package's ``eval/skeletons.py``; networkx is
imported where a function first needs it).

Capability parity with the reference's skeleton evaluation path
(reference ``bootstrapper/eval/compute_metrics.py:20-70,120-183``, built
on funlib.evaluate): ground-truth neuron skeletons arrive as graphml
(networkx) with world-unit node positions; each node is mapped to its
segment id; runs are maximal same-id connected stretches of a skeleton;

    ERL      = sum_runs len(run)^2 / total_skeleton_length
    max ERL  = sum_skels len(skel)^2 / total_skeleton_length
    NERL     = ERL / max_ERL

Edges touching background (id 0) break runs; segments containing nodes
of more than one skeleton are merge sites, and their edges are excluded
from correct runs (the conservative funlib behaviour).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..core.arrays import Array
from ..core.geometry import Coordinate


def load_skeletons(graphml_path: str, roi=None) -> nx.Graph:
    """Read a skeleton graphml; prune nodes outside ``roi``. Node attrs
    must include position (position_z/y/x or position as list)."""
    import networkx as nx

    g = nx.read_graphml(graphml_path)
    out = nx.Graph()
    for node, data in g.nodes(data=True):
        if "position_z" in data:
            pos = (
                float(data["position_z"]),
                float(data["position_y"]),
                float(data["position_x"]),
            )
        elif "position" in data:
            raw = data["position"]
            if isinstance(raw, str):
                pos = tuple(float(x) for x in raw.strip("[]()").split(","))
            else:
                pos = tuple(float(x) for x in raw)
        else:
            raise ValueError(f"node {node} has no position")
        if roi is not None and not roi.contains(Coordinate(*map(int, pos))):
            continue
        # only a real skeleton_id attribute groups nodes into neurons;
        # generic per-node 'id's must not (each node would become its
        # own skeleton)
        if "skeleton_id" in data:
            out.add_node(node, position=pos, skeleton_id=data["skeleton_id"])
        else:
            out.add_node(node, position=pos)
    for u, v in g.edges():
        if u in out and v in out:
            out.add_edge(u, v)
    return out


def _edge_length(g, u, v):
    pu = np.asarray(g.nodes[u]["position"])
    pv = np.asarray(g.nodes[v]["position"])
    return float(np.linalg.norm(pu - pv))


def lookup_segment_ids(skeletons: nx.Graph, seg: Array) -> Dict:
    """Segment id under each skeleton node (world-unit point lookups)."""
    ids = {}
    for node, data in skeletons.nodes(data=True):
        point = Coordinate(*(int(p) for p in data["position"]))
        if seg.roi.contains(point):
            ids[node] = int(seg[point])
        else:
            ids[node] = 0
    return ids


def _skeleton_components(skeletons: nx.Graph):
    """Split the skeleton graph into individual skeletons.

    When every node carries a ``skeleton_id``, group by it — funlib's
    behaviour: ROI pruning can cut one neuron into several connected
    pieces, and treating those pieces as separate skeletons would count
    a segment correctly covering both as a false merge (and collapse
    that neuron's ERL). Only graphs without ids fall back to connected
    components."""
    import networkx as nx

    by_id: Dict = {}
    for node, data in skeletons.nodes(data=True):
        if "skeleton_id" not in data:
            return list(nx.connected_components(skeletons))
        by_id.setdefault(data["skeleton_id"], set()).add(node)
    return list(by_id.values())


def expected_run_length(
    skeletons: nx.Graph, node_seg_ids: Dict
) -> Dict[str, float]:
    """ERL/NERL + merge/split stats for a segmentation."""
    import networkx as nx

    comps = _skeleton_components(skeletons)

    # merge detection: seg id -> set of skeleton indices containing it
    seg_to_skels: Dict[int, set] = {}
    for i, comp in enumerate(comps):
        for node in comp:
            sid = node_seg_ids.get(node, 0)
            if sid != 0:
                seg_to_skels.setdefault(sid, set()).add(i)
    merged_ids = {sid for sid, s in seg_to_skels.items() if len(s) > 1}

    total_length = 0.0
    erl_sum = 0.0
    max_erl_sum = 0.0
    split_count = 0
    for comp in comps:
        sub = skeletons.subgraph(comp)
        skel_len = sum(_edge_length(sub, u, v) for u, v in sub.edges())
        if skel_len == 0:
            continue
        total_length += skel_len
        max_erl_sum += skel_len * skel_len

        # correct edges: same nonzero id on both ends, id not a merge site
        run_graph = nx.Graph()
        run_graph.add_nodes_from(comp)
        for u, v in sub.edges():
            a, b = node_seg_ids.get(u, 0), node_seg_ids.get(v, 0)
            if a == b and a != 0 and a not in merged_ids:
                run_graph.add_edge(u, v, length=_edge_length(sub, u, v))
        for run in nx.connected_components(run_graph):
            run_len = sum(
                d["length"] for _, _, d in run_graph.subgraph(run).edges(data=True)
            )
            erl_sum += run_len * run_len

        ids_in_skel = {
            node_seg_ids.get(n, 0) for n in comp
        } - {0}
        split_count += max(0, len(ids_in_skel) - 1)

    erl = erl_sum / total_length if total_length > 0 else 0.0
    max_erl = max_erl_sum / total_length if total_length > 0 else 0.0
    return {
        "erl": erl,
        "max_erl": max_erl,
        "nerl": erl / max_erl if max_erl > 0 else 0.0,
        "total_skeleton_length": total_length,
        "n_skeletons": len(comps),
        "split_count": split_count,
        "merge_count": len(merged_ids),
    }


def skeleton_metrics(seg: Array, graphml_path: str) -> Dict[str, float]:
    """Convenience: load skeletons, look up ids, compute ERL metrics."""
    skels = load_skeletons(graphml_path, roi=seg.roi)
    ids = lookup_segment_ids(skels, seg)
    return expected_run_length(skels, ids)
