"""Scene-graph pair selection for multi-view reconstruction (counterpart of
gd3d/data/scene_graph.py, copied: pure stdlib).

Pairs are (i, j) index tuples over a stack of images, in the order of
dust3r's make_pairs (image_pairs.py:11-68) and filter_pairs_seq (:80-97).

Strategies (`scene_graph`):
  'complete'            all unordered pairs (i > j order, like upstream)
  'swin-W[-noncyclic]'  sliding window of width W (cyclic by default)
  'logwin-W[-noncyclic]' log-spaced offsets 2^0..2^(W-1)
  'oneref-R'            star graph around reference image R

`prefilter` ('seqN' / 'cycN') drops edges more than N frames apart
(cyclic distance for 'cyc').  `symmetrize` appends every reversed pair,
as global alignment requires both directions of each edge.
"""
from __future__ import annotations

from typing import List, Optional, Tuple


def make_pair_indices(
    n: int,
    scene_graph: str = "complete",
    prefilter: Optional[str] = None,
    symmetrize: bool = True,
) -> List[Tuple[int, int]]:
    """Pair (i, j) indices over n images, matching the reference's
    make_pairs sequence (image_pairs.py:11-68) element-for-element."""
    pairs: List[Tuple[int, int]] = []
    if scene_graph == "complete":
        for i in range(n):
            for j in range(i):
                pairs.append((i, j))
    elif scene_graph.startswith("swin"):
        iscyclic = not scene_graph.endswith("noncyclic")
        try:
            winsize = int(scene_graph.split("-")[1])
        except (IndexError, ValueError):
            winsize = 3
        pairsid = set()
        for i in range(n):
            for j in range(1, winsize + 1):
                idx = i + j
                if iscyclic:
                    idx = idx % n
                if idx >= n:
                    continue
                pairsid.add((i, idx) if i < idx else (idx, i))
        pairs.extend(pairsid)
    elif scene_graph.startswith("logwin"):
        iscyclic = not scene_graph.endswith("noncyclic")
        try:
            winsize = int(scene_graph.split("-")[1])
        except (IndexError, ValueError):
            winsize = 3
        offsets = [2 ** i for i in range(winsize)]
        pairsid = set()
        for i in range(n):
            ixs_l = [i - off for off in offsets]
            ixs_r = [i + off for off in offsets]
            for j in ixs_l + ixs_r:
                if iscyclic:
                    j = j % n
                if j < 0 or j >= n or j == i:
                    continue
                pairsid.add((i, j) if i < j else (j, i))
        pairs.extend(pairsid)
    elif scene_graph.startswith("oneref"):
        refid = int(scene_graph.split("-")[1]) if "-" in scene_graph else 0
        if not 0 <= refid < n:
            raise ValueError(
                f"oneref reference image {refid} out of range for {n} images")
        for j in range(n):
            if j != refid:
                pairs.append((refid, j))
    else:
        raise ValueError(f"unknown scene_graph {scene_graph!r}")

    if symmetrize:
        pairs = pairs + [(j, i) for i, j in pairs]

    if not pairs:
        return pairs
    if isinstance(prefilter, str) and prefilter.startswith(("seq", "cyc")):
        cyclic = prefilter.startswith("cyc")
        thr = int(prefilter[3:])
        # the reference derives n from the surviving edges, not the true
        # image count (image_pairs.py:82) — mirror it for parity
        n_f = max(max(e) for e in pairs) + 1

        def _dis(i: int, j: int) -> int:
            d = abs(i - j)
            if cyclic:
                d = min(d, abs(i + n_f - j), abs(i - n_f - j))
            return d

        pairs = [(i, j) for i, j in pairs if _dis(i, j) <= thr]
    elif prefilter:
        raise ValueError(f"unknown prefilter {prefilter!r}")
    return pairs
