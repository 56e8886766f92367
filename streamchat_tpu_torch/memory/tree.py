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

With `embed_tokens_fn` each node also caches its caption's unpadded token
embeddings on the host (`token_emb`), and `search_maxsim` descends by
ColBERT MaxSim over them. `search_features` (the uni-modal answer's)
descends the summarized roots by the inner-product mass between query
rows and each child's centroids, scored on the device, one readback a
level. `build_bottom_up` and `build_top_down` are the reference's one-shot
builders.

`to_state` / `from_state` persist a tree (the runner's `--save_tree_dir`):
the state is plain Python with each node's centroids as a CPU tensor in
its own dtype (bf16 centroids have no numpy dtype without ml_dtypes, so
they are not turned into numpy) and the caption and token embeddings as
numpy; pickling it needs torch and numpy only, and `from_state` moves the
centroids to the caller's device, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from streamchat_tpu_torch.ops import retrieval
from streamchat_tpu_torch.utils.profiling import span

EmbedFn = Callable[[List[str]], torch.Tensor]
EmbedTokensFn = Callable[[List[str]], Tuple[torch.Tensor, torch.Tensor]]
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
    token_emb: Optional[np.ndarray] = None  # cached token embeddings [T, E] (MaxSim)


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
                 summarize_fn: SummarizeFn, merge_fn: MergeFn,
                 embed_tokens_fn: Optional[EmbedTokensFn] = None) -> None:
        """embed_tokens_fn (texts -> ([N, S, E] token states, [N, S] mask))
        caches each node's token embeddings, for `search_maxsim`."""
        self.num_clusters = num_clusters
        self.interval = interval
        self._embed = embed_fn
        self._summarize = summarize_fn
        self._merge = merge_fn
        self._embed_tokens = embed_tokens_fn
        self.roots: List[MemoryTreeNode] = []

    def add_chunks(self, centroids_list: Sequence[torch.Tensor],
                   captions: Sequence[str]) -> None:
        """Append captioned chunks as depth-0 roots, then merge if due (a
        `memory.tree_add` span, the captions' embedding included)."""
        if len(centroids_list) != len(captions):
            raise ValueError("centroids/captions length mismatch")
        with span("memory.tree_add", chunks=len(captions)):
            if captions:
                embs = _host(self._embed(list(captions)))
                tok_embs = self._token_embs(list(captions))
                for i, (c, t, e) in enumerate(zip(centroids_list, captions, embs)):
                    self.roots.append(MemoryTreeNode(
                        centroids=c, text=t, emb=e,
                        token_emb=None if tok_embs is None else tok_embs[i]))
            self._maybe_merge()

    def _token_embs(self, texts: List[str]) -> Optional[List[np.ndarray]]:
        """Per-text unpadded token embeddings on the host, or None when
        MaxSim is off."""
        if self._embed_tokens is None:
            return None
        hidden, mask = self._embed_tokens(texts)
        hidden, mask = _host(hidden), _host(mask)
        return [hidden[i][mask[i] > 0] for i in range(len(texts))]

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
        with span("memory.summarize", captions=len(chunk)):
            summary = self._summarize([n.text for n in chunk])
        parent_tok = self._token_embs([summary])
        parent = MemoryTreeNode(
            centroids=merged, text=summary, depth=chunk[0].depth + 1,
            children=list(chunk), emb=_host(self._embed([summary]))[0],
            token_emb=None if parent_tok is None else parent_tok[0])
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

    def search_maxsim(self, query_token_emb) -> Tuple[List[torch.Tensor], List[str]]:
        """Greedy descent scored by ColBERT MaxSim (`ops/retrieval.maxsim_score`)
        over the cached token embeddings -> (features, captions) per level.

        query_token_emb: [Tq, E] unpadded question token embeddings. Scored
        on the host, as in the JAX package, with its convention of
        zero-padding a level's candidates to a common token count: a padded
        row normalizes to zero and contributes similarity 0 to a query
        token's max. ValueError on a tree built without embed_tokens_fn."""
        q = torch.from_numpy(_host(query_token_emb))

        def best(nodes: Sequence[MemoryTreeNode]) -> int:
            if any(n.token_emb is None for n in nodes):
                raise ValueError("tree built without embed_tokens_fn")
            batch = torch.nn.utils.rnn.pad_sequence(
                [torch.from_numpy(np.asarray(n.token_emb, np.float32)) for n in nodes],
                batch_first=True)
            return int(torch.argmax(retrieval.maxsim_score(q, batch)))

        return self._descend(best)

    def search_features(self, query_feats: torch.Tensor) -> List[torch.Tensor]:
        """Feature-space greedy descent of the uni-modal answer: query rows
        [T, D] -> the centroids of each visited level (`_feature_walk`)."""
        return self._feature_walk(query_feats)[0]

    def _feature_walk(self, query_feats: torch.Tensor
                      ) -> Tuple[List[torch.Tensor], List[np.ndarray]]:
        """-> (path, each level's child scores). Depth-0 roots are skipped;
        each summarized root is descended to a leaf, the PARENT's centroids
        emitted at every level and the final leaf's last. A child scores
        the f32 sum of q @ C^T over its flattened centroids C, highest
        first, the first index on ties (the JAX package's reading of the
        reference's self-contradicting comparator). A level's scores are
        computed on the device and read back once."""
        q = query_feats.reshape(-1, query_feats.shape[-1]).float()
        path: List[torch.Tensor] = []
        levels: List[np.ndarray] = []
        for root in self.roots:
            if root.depth == 0 or not root.children:
                continue
            node = root
            while node.children:
                scores = torch.stack([
                    torch.sum(q @ c.centroids.reshape(-1, q.shape[-1]).float().T)
                    for c in node.children]).cpu().numpy()
                levels.append(scores)
                path.append(node.centroids)
                node = node.children[int(np.argmax(scores))]
            path.append(node.centroids)
        return path, levels

    @classmethod
    def build_bottom_up(cls, chunk_centroids: Sequence[torch.Tensor], num_clusters: int,
                        interval: int, merge_fn: MergeFn,
                        captions: Optional[Sequence[str]] = None,
                        summarize_fn: Optional[SummarizeFn] = None,
                        embed_fn: Optional[EmbedFn] = None) -> "VisualMemoryTree":
        """One-shot bottom-up build: every `interval` nodes of a level merge
        into a parent until one root remains (centroids merged past
        num_clusters; with captions, the merged nodes' texts summarized and,
        with embed_fn, embedded). As in the JAX package, the reference's
        stale slice of the base captions at levels above 0 is not
        reproduced: the nodes being merged are summarized. A tree without
        captions serves `search_features`."""
        with_text = captions is not None
        if with_text and summarize_fn is None:
            raise ValueError("captions given without summarize_fn")
        texts = list(captions) if with_text else [""] * len(chunk_centroids)
        embs = (_host(embed_fn(texts)) if (with_text and embed_fn)
                else [None] * len(texts))
        nodes = [MemoryTreeNode(centroids=c, text=t, depth=0, emb=e)
                 for c, t, e in zip(chunk_centroids, texts, embs)]
        while len(nodes) > 1:
            new_nodes: List[MemoryTreeNode] = []
            for i in range(0, len(nodes), interval):
                chunk = nodes[i: i + interval]
                combined = torch.cat([n.centroids for n in chunk], dim=0)
                merged = (merge_fn(combined, num_clusters)
                          if combined.shape[0] > num_clusters else combined)
                if with_text:
                    summary = summarize_fn([n.text for n in chunk])
                    emb = _host(embed_fn([summary]))[0] if embed_fn else None
                else:
                    summary, emb = "", None
                new_nodes.append(MemoryTreeNode(
                    centroids=merged, text=summary, depth=chunk[0].depth + 1,
                    children=list(chunk), emb=emb))
            nodes = new_nodes
        tree = cls(num_clusters, interval,
                   embed_fn or (lambda texts: torch.zeros(len(texts), 1)),
                   summarize_fn or (lambda caps: ""), merge_fn)
        tree.roots = nodes
        return tree

    @classmethod
    def build_top_down(cls, features: torch.Tensor, chunk_size: int, num_clusters: int,
                       merge_fn: MergeFn, compress_rate: int = 1) -> "VisualMemoryTree":
        """One-shot top-down build: [N, P, D] frame features (pooled by
        compress_rate first) cut into chunk_size chunks, each reduced to
        num_clusters centroids as one depth-0 node. The reference's
        recursion into a node with more than num_clusters centroids never
        runs (k-means returns num_clusters), so the result is that flat
        list, as in the JAX package; it carries no captions."""
        from streamchat_tpu_torch.ops.pooling import compress_spatial_features

        if compress_rate > 1:
            features = compress_spatial_features(features, compress_rate)
        roots = []
        for i in range(0, features.shape[0], chunk_size):
            chunk = features[i: i + chunk_size]
            reduced = merge_fn(chunk, num_clusters) if chunk.shape[0] > num_clusters else chunk
            roots.append(MemoryTreeNode(centroids=reduced, text="", depth=0))
        tree = cls(num_clusters, interval=len(roots) or 1,
                   embed_fn=lambda texts: torch.zeros(len(texts), 1),
                   summarize_fn=lambda caps: "", merge_fn=merge_fn)
        tree.roots = roots
        return tree

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
                    "token_emb": None if n.token_emb is None else np.asarray(n.token_emb),
                    "children": [pack(c) for c in n.children]}

        return {"roots": [pack(r) for r in self.roots]}

    @classmethod
    def from_state(cls, state: dict, num_clusters: int, interval: int, embed_fn: EmbedFn,
                   summarize_fn: SummarizeFn, merge_fn: MergeFn,
                   embed_tokens_fn: Optional[EmbedTokensFn] = None, *,
                   device=None) -> "VisualMemoryTree":
        """The tree `to_state` saved, its centroids on `device` (default: as
        saved, on the CPU)."""
        tree = cls(num_clusters, interval, embed_fn, summarize_fn, merge_fn,
                   embed_tokens_fn=embed_tokens_fn)

        def unpack(d: dict) -> MemoryTreeNode:
            c = d["centroids"]
            return MemoryTreeNode(centroids=c if device is None else c.to(device),
                                  text=d["text"], depth=d["depth"], emb=d["emb"],
                                  token_emb=d.get("token_emb"),
                                  children=[unpack(x) for x in d["children"]])

        tree.roots = [unpack(r) for r in state["roots"]]
        return tree
