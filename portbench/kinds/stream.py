"""The `stream` kind: the memory path, the loop body of
`StreamChatPipeline.process_video` without its answer.
`pipeline/ingest.encode_segment` (the next segment's frames prefetched by
`PrefetchReader`, as there), then `pipeline/memory_update.update_memory`
with the pipeline's captioner on a tree from `new_tree()`; segments back to
back. Summaries are decoded greedily, so that the check can judge them.

Judged: a seeded sample of the window's greedy captions with the longest
among them (the reference makes their visual tokens from the frames), every
summary the window finished, and two kept frames of each judged caption's
segment (one from each half of its ViT batch).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from portbench import check
from portbench.drive import Recorder, Unit, Window, run_window
from portbench.seeds import subseed

NUMBERS = ["vit_rel_err", "memory_logit_gap"]


class Driver:
    def __init__(self, pipe, plan, video, rec: Recorder) -> None:
        from streamchat_tpu_torch.pipeline.answer import make_captioner, make_summarizer

        self.pipe, self.plan, self.video, self.rec = pipe, plan, video, rec
        self.chunk = pipe.cfg.memory.chunk_size
        greedy = dataclasses.replace(pipe.cfg.sampling, caption_temperature=0.0)
        self.captioners = {True: make_captioner(pipe.model, greedy), False: pipe._caption}
        self.summarizer = make_summarizer(pipe.model, greedy)
        self.kept: Dict[int, tuple] = {}          # unit -> (frame indices, feature rows)
        self.frames_of: Dict[int, List[int]] = {}  # unit -> its segment's frame indices
        self.tree = None
        self.embedded: List[tuple] = []            # (texts, embeddings) of each tree embed call
        self.short = None                          # the last segment's short memory
        self.short_frames: List[int] = []          # the frames it was drawn from
        self.reader = None
        self.unit: Optional[int] = None           # the segment being run

    def new_tree(self):
        tree = self.pipe.new_tree()
        embed = tree._embed
        self.embedded = []

        def timed_summarize(captions):
            with self.rec.span("summary", unit=self.unit), \
                    self.rec.labelled(kind="summary", unit=self.unit, greedy=True):
                return self.summarizer(captions)

        def recorded_embed(texts):
            # The tree search ranks these rows; an empty caption's row hangs
            # on its batch's padding, so the check embeds the same batches.
            out = embed(texts)
            self.embedded.append((list(texts), out.detach().float().cpu()))
            return out

        tree._summarize = timed_summarize
        tree._embed = recorded_embed
        return tree

    def _captioner(self, greedy: bool, unit: int):
        cap = self.captioners[greedy]
        made = []

        def caption(chunk):
            with self.rec.span("caption", unit=unit), self.rec.labelled(
                    kind="caption", unit=unit, greedy=greedy, chunk=len(made)):
                made.append(cap(chunk))
                return made[-1]

        caption.batch = cap.batch
        caption.batch_size = cap.batch_size
        return caption

    def segment(self, seg: int, unit: int, greedy: bool, traced: bool, keep: bool) -> Unit:
        """One segment: ingest, then the memory update."""
        from streamchat_tpu_torch.pipeline.ingest import encode_segment, segment_indices
        from streamchat_tpu_torch.pipeline.memory_update import update_memory

        pipe = self.pipe
        self.unit = unit
        s0, s1 = self.plan.segments[seg]
        idx = segment_indices(self.reader, s0, s1, pipe.cfg.video, self.chunk)
        self.frames_of[unit] = idx
        t0 = time.perf_counter()
        with self.rec.span("ingest", unit=unit):
            features = encode_segment(pipe.model, self.reader, s0, s1, pipe.cfg.video,
                                      self.chunk)
        if seg + 1 < len(self.plan.segments):
            ns, ne = self.plan.segments[seg + 1]
            self.reader.schedule(segment_indices(self.reader, ns, ne, pipe.cfg.video,
                                                 self.chunk))
        n = features.shape[0]
        if keep and n:
            # A seeded frame of the first half and one of the last quarter,
            # so a fault in either half of the ViT batch (padded past n)
            # shows.
            rng = np.random.default_rng(subseed(self.plan.seed, f"keep/{unit}"))
            pick = [int(rng.integers(0, max(1, n // 2))), int(rng.integers(3 * n // 4, n))]
            self.kept[unit] = ([idx[p] for p in pick], features[pick].clone())
        box, features = [features], None
        with self.rec.span("memory_update", unit=unit):
            self.tree, self.short = update_memory(
                box, self.tree, self._captioner(greedy, unit), pipe.cfg.memory, pipe.generator,
                pipe.cluster_full_chunks, residents=pipe.residents)
        self.short_frames = idx[-pipe.cfg.memory.short_window:]
        return Unit(index=unit, t0=t0, t1=time.perf_counter(), traced=traced, kind="segment",
                    frames=n)

    def open(self) -> None:
        """The reader, and the frames of the segments a run reads made now
        (`cached_segments`, or the qa memory's)."""
        from streamchat_tpu_torch.pipeline.ingest import segment_indices
        from streamchat_tpu_torch.video.reader import PrefetchReader

        spec = self.plan.spec
        n = int(spec.get("memory_segments", spec["video"].get("cached_segments", 0)))
        self.video.cache([segment_indices(self.video, s0, s1, self.pipe.cfg.video, self.chunk)
                          for s0, s1 in self.plan.segments[:n]])
        self.reader = PrefetchReader(self.video)

    def close(self) -> None:
        if self.reader is not None:
            self.reader.stop()
            self.reader = None

    def warm(self) -> None:
        """Every shape the window uses: a segment captioned greedily and one
        sampled, and a summary, on a tree that is then dropped."""
        self.tree = self.new_tree()
        for k in range(int(self.plan.spec.get("warm_segments", 2))):
            self.segment(k, -1 - k, greedy=k % 2 == 0, traced=False, keep=False)
        texts = [node.text for node in self.tree.roots]
        interval = self.pipe.cfg.memory.interval
        self.unit = None
        self.tree._summarize((texts * interval)[:interval])
        self.tree = None

    def window(self, seconds: float, trace_units: int) -> Window:
        self.tree = self.new_tree()

        def step(unit, traced):
            return self.segment(unit % len(self.plan.segments), unit, self.plan.greedy[unit],
                                traced, keep=True)

        return run_window(step, seconds, trace_units, self.pipe.model.device)

    def check_inputs(self, window: Window, n: int, rng: np.random.Generator) -> dict:
        units = {u.index for u in window.units}
        calls = [c for c in self.rec.calls if c.get("kind") == "caption"
                 and c.get("unit") in units and c.get("greedy")]
        requests = []
        for c in check.sample_calls(calls, n, rng):
            lo = c["chunk"] * self.chunk
            requests.append({"gap": "memory_logit_gap", "unit": c["unit"], "prompt": c["prompt"],
                             "tokens": c["tokens"].tolist(),
                             "frames": self.frames_of[c["unit"]][lo:lo + self.chunk]})
        for c in self.rec.calls:
            if c.get("kind") == "summary" and c.get("unit") in units:
                requests.append({"gap": "memory_logit_gap", "unit": c["unit"],
                                 "prompt": c["prompt"], "tokens": c["tokens"].tolist(),
                                 "blocks": []})
        kept = [r["unit"] for r in requests if "frames" in r]
        return {"requests": requests, "frames": check.kept_frames(self.kept, kept)}
