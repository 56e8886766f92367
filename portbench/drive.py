"""What every traffic kind's driver shares: the recorder of spans and
generate calls, a window's requests, and the loop that runs them.

A traffic kind is a module of its own, `portbench/kinds/<kind>.py`, found
by the `kind` of a traffic mix: its `Driver` warms up (set-up) and runs the
measured window through the program's own entry points, with the
benchmark's spans around each call into a layer, and hands the check what
the window produced (`check_inputs`); its `NUMBERS` are the compared
numbers a run of that kind must read.

A window runs whole requests until `seconds` have passed; its length is
the time to the end of the last one. A --trace 1 run first profiles
`trace_units` requests (the traced window), then runs the window untraced.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, Iterator, List, Optional

import torch


class Recorder:
    """Spans, and every generate call's shapes, steps, seconds and served
    tokens, labelled with the request it served. Hooks the program's entry
    points without changing what they compute: `models/longva`'s
    `generate_paged`, the model's `generate_with_image_embedding` and the
    pipeline's `embed_query`."""

    def __init__(self, pipe) -> None:
        from streamchat_tpu_torch.models import longva

        self.pipe = pipe
        self.model = pipe.model
        self.sync = torch.cuda.synchronize if self.model.device.type == "cuda" else (lambda: None)
        self.spans: List[dict] = []
        self.calls: List[dict] = []
        self.queries: Dict[int, torch.Tensor] = {}
        self.label: Optional[dict] = None
        self._longva = longva
        self._orig_gp = longva.generate_paged
        longva.generate_paged = self._generate_paged
        self._orig_gwie = self.model.generate_with_image_embedding
        self.model.generate_with_image_embedding = self._gwie
        self._orig_eq = pipe.embed_query
        pipe.embed_query = self._embed_query

    def close(self) -> None:
        """Unhook, and drop every reference to the program and its tensors
        (what the check needs was copied to the host), so that the program's
        memory is freed before the reference runs."""
        self._longva.generate_paged = self._orig_gp
        self.model.__dict__.pop("generate_with_image_embedding", None)
        self.pipe.__dict__.pop("embed_query", None)
        self._orig_gwie = self._orig_eq = self.pipe = self.model = None
        self.queries.clear()
        for call in self.calls:
            call.pop("blocks", None)

    @contextlib.contextmanager
    def span(self, name: str, **tags) -> Iterator[None]:
        """A host-clock span that ends in a device synchronize, also a
        `record_function` window of a trace."""
        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench." + name):
            try:
                yield
            finally:
                self.sync()
        self.spans.append({"name": name, "t0": t0, "t1": time.perf_counter(), **tags})

    @contextlib.contextmanager
    def labelled(self, **label) -> Iterator[None]:
        saved, self.label = self.label, label
        try:
            yield
        finally:
            self.label = saved

    def _generate_paged(self, params, cfg, prompt_embeds, seq_length, *args, **kw):
        st = self.model.gen_stats
        before = dict(st)
        t0 = time.perf_counter()
        toks, count = self._orig_gp(params, cfg, prompt_embeds, seq_length, *args, **kw)
        t1 = time.perf_counter()

        def delta(k):
            return st.get(k, 0) - before.get(k, 0)

        n = int(count[0])
        self.calls.append({
            **(self.label or {"kind": "other"}), "t0": t0, "t1": t1,
            "seq_len": int(seq_length.reshape(-1)[0]), "prompt_tokens": delta("prompt_tokens"),
            "steps": delta("decode_steps"), "prefill_s": delta("prefill_s"),
            "decode_s": delta("decode_s"), "captures": delta("graph_captures"),
            "temperature": float(kw.get("temperature", 0.0)), "tokens": toks[0][:n].copy()})
        return toks, count

    def _gwie(self, prompt, image_embeddings=None, **kw):
        n = len(self.calls)
        out = self._orig_gwie(prompt, image_embeddings, **kw)
        if len(self.calls) > n:
            call = self.calls[-1]
            call["prompt"] = prompt
            # An answer's blocks (short memory, the tree's centroids) outlive
            # the call anyway; a caption's would pin the segment's stack.
            if call.get("kind") == "answer":
                call["blocks"] = list(image_embeddings[0])
        return out

    def _embed_query(self, question: str):
        emb = self._orig_eq(question)
        if self.label and self.label.get("kind") == "answer":
            self.queries[self.label["index"]] = emb.detach().float().clone()
        return emb


@dataclasses.dataclass
class Unit:
    """One request of a window: a "segment" (ingest and memory update) or an
    "answer"."""
    index: int
    t0: float
    t1: float
    traced: bool
    kind: str
    frames: int = 0
    retrieval_s: float = 0.0        # an answer's AnswerResult.process_time


@dataclasses.dataclass
class Window:
    units: List[Unit]
    t0: float
    t1: float
    profile: object = None       # the torch.profiler of the traced requests

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def timed(self) -> List[Unit]:
        return [u for u in self.units if not u.traced]


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def run_window(step: Callable[[int, bool], Unit], seconds: float, trace_units: int,
                device) -> Window:
    """Traced requests first (--trace 1), then requests until `seconds`."""
    units: List[Unit] = []
    prof = None
    if trace_units:
        prof = _profiler(device)
        with prof:
            for _ in range(trace_units):
                units.append(step(len(units), True))
    t0 = time.perf_counter()
    while True:
        units.append(step(len(units), False))
        if time.perf_counter() - t0 >= seconds:
            break
    return Window(units=units, t0=t0, t1=units[-1].t1, profile=prof)
