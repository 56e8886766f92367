"""Hierarchical long-term visual memory tree (`streamchat_tpu/memory/tree.py`).

New chunks enter as depth-0 roots (centroids + caption + cached caption
embedding). The summarize depth is the deepest root depth whose count is a
positive multiple of `interval`; when it reaches `interval`, the first
`interval` roots there merge into a depth+1 parent (centroids k-means
reduced, captions LLM-summarized). Search descends each summarized root
greedily by caption-embedding cosine similarity and ranks the leftover
depth-0 roots once; the reference's "index 0 unless some similarity
strictly beats 0" rule is kept. Scoring runs on the host in numpy, as in
the JAX package; node centroids stay on the device.

`to_state` / `from_state` persist a tree (the runner's `--save_tree_dir`):
the state is plain Python with each node's centroids as a CPU tensor in
its own dtype (bf16 centroids have no numpy dtype without ml_dtypes, so
they are not turned into numpy) and the caption embedding as numpy;
pickling it needs torch and numpy only, and `from_state` moves the
centroids to the caller's device, bit for bit. `token_emb` (the MaxSim
token embeddings of the JAX package) is not ported and stays None.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

EmbedFn = Callable[[List[str]], torch.Tensor]
SummarizeFn = Callable[[List[str]], str]
MergeFn = Callable[[torch.Tensor, int], torch.Tensor]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


@dataclasses.dataclass
class MemoryTreeNode:
    centroids: torch.Tensor                # [K, P, D]
    text: str
    depth: int = 0
    children: List["MemoryTreeNode"] = dataclasses.field(default_factory=list)
    emb: Optional[np.ndarray] = None       # cached caption embedding [E]


def _count_by_depth(roots: Sequence[MemoryTreeNode]) -> Dict[int, int]:
    counts: Dict[int, int] = {}
    for n in roots:
        counts[n.depth] = counts.get(n.depth, 0) + 1
    return counts


def _summarize_depth(roots: Sequence[MemoryTreeNode], interval: int) -> int:
    counts = _count_by_depth(roots)
    for depth in range(max(counts), -1, -1):
        c = counts.get(depth, 0)
        if c > 0 and c % interval == 0:
            return depth
    return 0


class VisualMemoryTree:
    """Forest of memory nodes with incremental summarize-splice updates."""

    def __init__(self, num_clusters: int, interval: int, embed_fn: EmbedFn,
                 summarize_fn: SummarizeFn, merge_fn: MergeFn) -> None:
        self.num_clusters = num_clusters
        self.interval = interval
        self._embed = embed_fn
        self._summarize = summarize_fn
        self._merge = merge_fn
        self.roots: List[MemoryTreeNode] = []

    def add_chunks(self, centroids_list: Sequence[torch.Tensor],
                   captions: Sequence[str]) -> None:
        """Append captioned chunks as depth-0 roots, then merge if due."""
        if len(centroids_list) != len(captions):
            raise ValueError("centroids/captions length mismatch")
        if captions:
            embs = _host(self._embed(list(captions)))
            for c, t, e in zip(centroids_list, captions, embs):
                self.roots.append(MemoryTreeNode(centroids=c, text=t, emb=e))
        self._maybe_merge()

    def _maybe_merge(self) -> None:
        """One summarize-splice pass (at most one per update, as the reference)."""
        if not self.roots:
            return
        depth = _summarize_depth(self.roots, self.interval)
        at_depth = [n for n in self.roots if n.depth == depth]
        if len(at_depth) < self.interval:
            return
        start = next(i for i, n in enumerate(self.roots) if n.depth == depth)
        chunk = self.roots[start: start + self.interval]
        combined = torch.cat([n.centroids for n in chunk], dim=0)
        if combined.shape[0] > self.num_clusters:
            merged = self._merge(combined, self.num_clusters)
        else:
            merged = combined
        summary = self._summarize([n.text for n in chunk])
        parent = MemoryTreeNode(
            centroids=merged, text=summary, depth=chunk[0].depth + 1,
            children=list(chunk), emb=_host(self._embed([summary]))[0])
        self.roots[start: start + self.interval] = [parent]

    def search(self, query_emb) -> Tuple[List[torch.Tensor], List[str]]:
        """Greedy multi-root descent by cosine similarity to query_emb [E]
        -> (features per visited level, captions per visited level)."""
        q = _host(query_emb).reshape(-1)
        qn = q / max(float(np.sqrt(np.sum(q * q))), 1e-12)

        def best(nodes: Sequence[MemoryTreeNode]) -> int:
            embs = np.stack([np.asarray(n.emb, np.float32) for n in nodes])
            norms = np.maximum(np.sqrt(np.sum(embs * embs, axis=1, keepdims=True)), 1e-12)
            sims = (embs / norms) @ qn
            idx = int(np.argmax(sims))
            return idx if sims[idx] > 0 else 0

        return self._descend(best)

    def _descend(self, best) -> Tuple[List[torch.Tensor], List[str]]:
        path_features: List[torch.Tensor] = []
        path_text: List[str] = []
        redundant: List[MemoryTreeNode] = []
        for root in self.roots:
            if root.depth == 0:
                redundant.append(root)
                continue
            node = root
            while node.children:
                node = node.children[best(node.children)]
                path_features.append(node.centroids)
                path_text.append(node.text)
        if redundant:
            i = best(redundant)
            path_features.append(redundant[i].centroids)
            path_text.append(redundant[i].text)
        return path_features, path_text

    def counts_by_depth(self) -> Dict[int, int]:
        return _count_by_depth(self.roots)

    def __len__(self) -> int:
        return len(self.roots)

    def all_nodes(self) -> List[MemoryTreeNode]:
        """Every node, each root followed by its subtree (depth first)."""
        out: List[MemoryTreeNode] = []

        def walk(n: MemoryTreeNode) -> None:
            out.append(n)
            for c in n.children:
                walk(c)

        for r in self.roots:
            walk(r)
        return out

    def to_state(self) -> dict:
        """Picklable snapshot: {"roots": [node dicts]}, centroids as CPU
        tensors in their own dtype."""

        def pack(n: MemoryTreeNode) -> dict:
            return {"centroids": n.centroids.detach().to("cpu", copy=True), "text": n.text,
                    "depth": n.depth, "emb": None if n.emb is None else np.asarray(n.emb),
                    "token_emb": None, "children": [pack(c) for c in n.children]}

        return {"roots": [pack(r) for r in self.roots]}

    @classmethod
    def from_state(cls, state: dict, num_clusters: int, interval: int, embed_fn: EmbedFn,
                   summarize_fn: SummarizeFn, merge_fn: MergeFn, *,
                   device=None) -> "VisualMemoryTree":
        """The tree `to_state` saved, its centroids on `device` (default: as
        saved, on the CPU)."""
        tree = cls(num_clusters, interval, embed_fn, summarize_fn, merge_fn)

        def unpack(d: dict) -> MemoryTreeNode:
            c = d["centroids"]
            return MemoryTreeNode(centroids=c if device is None else c.to(device),
                                  text=d["text"], depth=d["depth"], emb=d["emb"],
                                  children=[unpack(x) for x in d["children"]])

        tree.roots = [unpack(r) for r in state["roots"]]
        return tree
