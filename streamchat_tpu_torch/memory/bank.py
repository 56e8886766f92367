"""Textual dialogue memory (MemoryBank) — JSON-schema compatible rebuild.

Reference: `memory_bank/memory_utils.py` (store write-back, enter_name) +
`memory_bank/memory_retrieval/local_doc_qa.py` (JsonMemoryLoader document
construction, FAISS search with neighbor stitching, date grouping).

The on-disk JSON format is byte-compatible:
  {user: {"name": user, "history": {date: [{"query": q, "response": r}]},
          "summary": {date: text}, "personality": {...}, "overall_history":
          ..., "overall_personality": ...}}

The FAISS index is replaced by an on-device embedding matrix + one [1, N]
L2-distance matmul per query (the per-video index is tiny — hundreds of
rows, local_doc_qa.py:196-255 rebuilds it from scratch every round anyway).
Search semantics reproduced from `similarity_search_with_score_by_vector`
(local_doc_qa.py:135-178): top-k hits, neighbor expansion within the same
date up to `chunk_size` characters, consecutive-id grouping, page-content
stitching; then `search_memory`'s date grouping (local_doc_qa.py:263-288).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

# Batch text embedder: List[str] -> np.ndarray [N, E].
EmbedFn = Callable[[List[str]], np.ndarray]

USER_KW = {"en": "[|User|]:", "cn": "[|用户|]："}
AI_KW = {"en": "[|AI|]:", "cn": "[|AI恋人|]："}


@dataclasses.dataclass
class MemoryDoc:
    """One retrievable unit (reference langchain Document)."""

    page_content: str
    date: str                      # metadata["source"]


def _date_prefix(date: str, language: str) -> str:
    return (
        f"时间{date}的对话内容：" if language == "cn"
        else f"Conversation content on {date}:"
    )


def build_documents(
    memory: dict, user_name: str, language: str = "en"
) -> List[MemoryDoc]:
    """One doc per dialogue turn + one per daily summary, in date order.

    Mirrors JsonMemoryLoader.load (local_doc_qa.py:26-66): each turn renders
    as "<date prefix>[|User|]: q; [|AI|]: r"; a date's summary doc follows
    its turns.
    """
    user_memory = memory.get(user_name, {})
    docs: List[MemoryDoc] = []
    if "history" not in user_memory:
        return docs
    user_kw = USER_KW[language]
    ai_kw = AI_KW[language]
    for date, content in user_memory["history"].items():
        prefix = _date_prefix(date, language)
        for dialog in content:
            q, r = dialog["query"], dialog["response"]
            docs.append(MemoryDoc(
                page_content=f"{prefix}{user_kw} {q.strip()}; {ai_kw} {r.strip()}",
                date=date,
            ))
        summary = user_memory.get("summary", {})
        if date in summary:
            text = (
                f"时间{date}的对话总结为：{summary[date]}" if language == "cn"
                else f"The summary of the conversation on {date} is: {summary[date]}"
            )
            docs.append(MemoryDoc(page_content=text, date=date))
    return docs


def embed_into_cache(
    embed_fn: EmbedFn, cache: Dict[str, np.ndarray], texts: Sequence[str]
) -> List[np.ndarray]:
    """Embed cache misses in ONE batched call; return rows for all texts.

    The rows are collected BEFORE the cache is trimmed to its bound, so a
    text of this call can never be evicted ahead of its own lookup (the
    reference trims first and can then raise KeyError on a hit that the
    FIFO just dropped)."""
    misses = [t for t in dict.fromkeys(texts) if t not in cache]
    if misses:
        rows = np.asarray(embed_fn(misses), np.float32)
        for t, r in zip(misses, rows):
            cache[t] = r
    out = [cache[t] for t in texts]
    while len(cache) > 4096:                   # bound host residency
        cache.pop(next(iter(cache)))
    return out


class MemoryIndex:
    """Embedding index over MemoryDocs with the reference's stitched search."""

    def __init__(
        self,
        docs: Sequence[MemoryDoc],
        embed_fn: EmbedFn,
        chunk_size: int = 200,
        top_k: int = 1,
        embed_cache: Optional[Dict[str, np.ndarray]] = None,
    ) -> None:
        self.docs = list(docs)
        self.chunk_size = chunk_size
        self.top_k = top_k
        self._embed = embed_fn
        # text -> embedding row. The reference re-embeds EVERY doc on each
        # per-round FAISS rebuild (memory_utils.py:76-83); with a cache the
        # rebuild embeds only the turn just written — one small device call
        # instead of N (the bank shares one cache across rebuilds, and
        # queries go through it too).
        self._cache = embed_cache if embed_cache is not None else {}
        if self.docs:
            self._matrix = np.stack(embed_into_cache(
                self._embed, self._cache,
                [d.page_content for d in self.docs],
            ))
        else:
            self._matrix = np.zeros((0, 1), np.float32)

    def _embed_cached(self, texts: List[str]) -> List[np.ndarray]:
        return embed_into_cache(self._embed, self._cache, texts)

    def __len__(self) -> int:
        return len(self.docs)

    def _topk_l2(self, query: str, k: int) -> List[int]:
        """FAISS IndexFlatL2 equivalent: ascending squared-L2 over raw
        (unnormalized) embeddings."""
        if not self.docs:
            return []
        q = self._embed_cached([query])[0]
        d2 = np.sum((self._matrix - q[None, :]) ** 2, axis=1)
        k = min(k, len(self.docs))
        return list(np.argsort(d2, kind="stable")[:k])

    def _stitched_hits(self, hits: List[int]) -> List[MemoryDoc]:
        """Neighbor expansion + consecutive grouping
        (local_doc_qa.py:135-178)."""
        n = len(self.docs)
        id_set = set()
        for i in hits:
            id_set.add(i)
            docs_len = len(self.docs[i].page_content)
            for k in range(1, max(i, n - i)):
                for l in (i + k, i - k):
                    if 0 <= l < n:
                        other = self.docs[l]
                        if docs_len + len(other.page_content) > self.chunk_size:
                            break
                        if other.date == self.docs[i].date:
                            docs_len += len(other.page_content)
                            id_set.add(l)
        id_list = sorted(id_set)
        # Group consecutive ids (reference seperate_list) and stitch contents.
        groups: List[List[int]] = []
        for idx in id_list:
            if groups and idx == groups[-1][-1] + 1:
                groups[-1].append(idx)
            else:
                groups.append([idx])
        out = []
        for g in groups:
            content = "".join(self.docs[j].page_content for j in g)
            out.append(MemoryDoc(page_content=content, date=self.docs[g[0]].date))
        return out

    def search_memory(
        self, query: str, language: str = "en"
    ) -> Tuple[List[str], str]:
        """(date-grouped contents, comma-joined dates)
        (search_memory, local_doc_qa.py:263-288)."""
        hits = self._topk_l2(query, self.top_k)
        docs = self._stitched_hits(hits)
        docs.sort(key=lambda d: d.date)
        date_docs: List[str] = []
        dates: List[str] = []
        pre_date = ""
        for doc in docs:
            content = doc.page_content.replace(
                _date_prefix(doc.date, language), ""
            ).strip()
            if doc.date != pre_date:
                date_docs.append(content)
                pre_date = doc.date
                dates.append(pre_date)
            else:
                date_docs[-1] += f"\n{content}"
        return date_docs, ", ".join(dates)


class MemoryBank:
    """Per-user JSON store + index lifecycle.

    `enter_name` / `save_local_memory` mirror memory_utils.py:61-110; the
    caller re-enters after each write-back exactly like the reference
    (inference_streaming_longva_v2.py:913-924).
    """

    def __init__(
        self,
        memory_path: str,
        embed_fn: EmbedFn,
        language: str = "en",
        chunk_size: int = 200,
        top_k: int = 1,
    ) -> None:
        self.memory_path = memory_path
        self.language = language
        self.chunk_size = chunk_size
        self.top_k = top_k
        self._embed = embed_fn
        # Shared text->embedding cache across per-round index rebuilds and
        # query embeds (round-5 dispatch diet): each rebuild then embeds
        # only the newly written turn, and pre-warmed queries cost nothing.
        self.embed_cache: Dict[str, np.ndarray] = {}
        self.memory: Dict[str, dict] = {}
        if os.path.exists(memory_path):
            with open(memory_path, "r", encoding="utf-8") as f:
                self.memory = json.load(f)

    def precompute_embeddings(self, texts: Sequence[str]) -> None:
        """Embed `texts` into the shared cache in ONE batched call (callers
        hoist all of a video's questions out of the per-question path)."""
        embed_into_cache(self._embed, self.embed_cache,
                         [t for t in texts if t])

    def enter_name(self, name: str) -> Optional[MemoryIndex]:
        """Register/load a user and (re)build their index. Returns None for a
        brand-new user (reference returns user_memory_index=None)."""
        if name not in self.memory:
            self.memory[name] = {"name": name}
            return None
        docs = build_documents(self.memory, name, self.language)
        if not docs:
            return None
        return MemoryIndex(docs, self._embed, self.chunk_size, self.top_k,
                           self.embed_cache)

    def save_local_memory(
        self, name: str, query: str, response: str, date: Optional[str] = None
    ) -> None:
        """Append one turn and rewrite the JSON (memory_utils.py:95-110)."""
        date = date or time.strftime("%Y-%m-%d", time.localtime())
        user = self.memory.setdefault(name, {"name": name})
        history = user.setdefault("history", {})
        history.setdefault(date, []).append({"query": query, "response": response})
        self.flush()

    def flush(self) -> None:
        os.makedirs(os.path.dirname(self.memory_path) or ".", exist_ok=True)
        with open(self.memory_path, "w", encoding="utf-8") as f:
            json.dump(self.memory, f, ensure_ascii=False, indent=4)
