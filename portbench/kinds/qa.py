"""The `qa` kind: the answer path over a memory built by the stream path in
set-up. The answer half of `process_video`'s loop body: `_history_prompt`,
`_answer` (`pipeline/answer.answer_question`) and `_record_and_store`, one
question after another.

Judged: a seeded sample of the window's greedy answers with the longest
among them. For each, the reference makes again from the frames the short
memory it was served (each of the program's short-memory frames matched to
the nearest of the frames it was drawn from), takes the retrieved nodes'
centroids from the program's tree, embeds the question and the tree's
captions (in the batches the program embedded them: the tree search's
scores), and judges the served tokens; also two kept frames of two memory
segments.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np

from portbench import check
from portbench.drive import Recorder, Unit, Window, run_window
from portbench.kinds.stream import Driver as StreamDriver

NUMBERS = ["vit_rel_err", "query_rel_err", "search_score_gap", "answer_logit_gap"]


class Driver(StreamDriver):
    def __init__(self, pipe, plan, video, rec: Recorder) -> None:
        super().__init__(pipe, plan, video, rec)
        self.tmp = tempfile.mkdtemp(prefix="portbench-bank-")
        self.bank = None
        self.index = None
        self.results: List[dict] = []
        self.end_s = 0.0
        self.questions_of: Dict[int, str] = {}

    def close(self) -> None:
        super().close()
        shutil.rmtree(self.tmp, ignore_errors=True)

    def answer(self, question: str, unit: int, greedy: bool, traced: bool) -> Unit:
        from portbench.system import with_sampling

        pipe = self.pipe
        base = pipe.cfg
        if greedy:
            pipe.cfg = with_sampling(pipe, temperature=0.0)
        q = {"question": question}
        self.questions_of[unit] = question
        t0 = time.perf_counter()
        try:
            with self.rec.span("history", unit=unit):
                history = pipe._history_prompt(self.index, question)
            with self.rec.span("answer", unit=unit), \
                    self.rec.labelled(kind="answer", unit=unit, index=unit, greedy=greedy):
                res = pipe._answer(q, self.short, self.tree, history)
            with self.rec.span("store", unit=unit):
                self.index = pipe._record_and_store(self.results, q, self.end_s, res, self.bank,
                                                    "User", None)
        finally:
            pipe.cfg = base
        return Unit(index=unit, t0=t0, t1=time.perf_counter(), traced=traced, kind="answer",
                    retrieval_s=res.process_time)

    def warm(self) -> None:
        """The memory the questions are asked of (traffic set-up: the stream
        path over `memory_segments` segments, their frames kept for the ViT
        check), a few warm-up questions at both temperatures (the dialogue
        bank then holds history, as in the window), then a generate call at
        every prompt bucket the window's answers can reach that those did
        not (`_warm_buckets`), so that no decode graph is captured in the
        window."""
        from streamchat_tpu_torch.memory.bank import MemoryBank

        pipe = self.pipe
        self.tree = self.new_tree()
        n = int(self.plan.spec["memory_segments"])
        for k in range(n):
            self.segment(k, -1 - k, greedy=self.plan.greedy[k], traced=False, keep=True)
        self.end_s = self.plan.segments[n - 1][1]
        self.bank = MemoryBank(os.path.join(self.tmp, "memory.json"), pipe.bank_embed,
                               language=pipe.cfg.retrieval.language,
                               top_k=pipe.cfg.retrieval.top_k)
        self.index = self.bank.enter_name("User")
        for k, question in enumerate(self.plan.warm_questions):
            self.answer(question, -100 - k, greedy=k % 2 == 0, traced=False)
        self._warm_buckets()

    def _text_tokens(self, question: str, history: List[str], response: str) -> int:
        """Text tokens of the answer prompt for `question` with the dialogue
        bank returning the turns of `history`, each answered `response`
        (the program's own prompt builders; the byte tokenizer: one token a
        byte)."""
        from streamchat_tpu_torch.memory.bank import AI_KW, USER_KW
        from streamchat_tpu_torch.pipeline import prompts

        cfg = self.pipe.cfg
        lang = cfg.retrieval.language
        caption = max((node.text for node in self.tree.roots), key=len)
        content = "\n".join(f"{USER_KW[lang]} {h.strip()}; {AI_KW[lang]} {response}"
                            for h in history)
        hist = prompts.build_history_prompt("\n" + content + "\n", lang)
        text = prompts.wrap_user_turn(cfg.conv_mode,
                                      prompts.build_answer_prompt(question, hist, caption))
        return len(text.replace("<image>", "").encode("utf-8"))

    def _warm_buckets(self) -> None:
        """One generate call (the answer's max_new_tokens, at each of the
        window's temperatures) at every 128-token prompt bucket between the
        shortest and the longest answer prompt the window's questions can
        make, with a turn of history answered in at most
        `warm_response_bytes` bytes, that no warm-up answer reached."""
        from streamchat_tpu_torch.models.longva import PROMPT_BUCKET

        pipe = self.pipe
        answers = [c for c in self.rec.calls if c.get("kind") == "answer"]
        blocks = answers[-1]["blocks"]
        visual = sum(b.shape[0] for b in blocks)
        qs = self.plan.questions + self.plan.warm_questions
        short = sorted(qs, key=len)[:2]
        long_ = sorted(qs, key=len)[-2:]
        r = "x" * int(self.plan.spec.get("warm_response_bytes", 16))
        lo = min(self._text_tokens(q, short[:1], "") for q in short)
        # Two turns come back only when both fit in the bank's 200-character
        # stitching budget, so the longest history is one long turn.
        hi = max(self._text_tokens(q, [h], r) for q in long_ for h in long_)
        seen = {(c["prompt_tokens"], c["temperature"]) for c in answers}
        temps = [0.0, pipe.cfg.sampling.temperature]
        first = -(-(visual + lo) // PROMPT_BUCKET) * PROMPT_BUCKET
        for s_pad in range(first, visual + hi + PROMPT_BUCKET, PROMPT_BUCKET):
            for t in temps:
                if (s_pad, t) in seen:
                    continue
                prompt = "<image>" + "x" * (s_pad - PROMPT_BUCKET // 2 - visual)
                with self.rec.labelled(kind="warm"):
                    pipe.model.generate_with_image_embedding(
                        prompt, image_embeddings=[blocks],
                        max_new_tokens=pipe.cfg.sampling.max_answer_tokens,
                        temperature=t, top_p=pipe.cfg.sampling.top_p)

    def window(self, seconds: float, trace_units: int) -> Window:
        def step(unit, traced):
            return self.answer(self.plan.questions[unit % len(self.plan.questions)], unit,
                               self.plan.greedy[unit], traced)

        return run_window(step, seconds, trace_units, self.pipe.model.device)

    def check_inputs(self, window: Window, n: int, rng: np.random.Generator) -> dict:
        units = {u.index for u in window.units}
        calls = [c for c in self.rec.calls if c.get("kind") == "answer"
                 and c.get("unit") in units and c.get("greedy")]
        p, d = self.short.shape[1], self.short.shape[2]
        requests = []
        for c in check.sample_calls(calls, n, rng):
            # The answer prompt's one <image> takes its blocks in order: the
            # short memory, then the retrieved levels.
            short, *levels = c["blocks"]
            requests.append({
                "gap": "answer_logit_gap", "unit": c["unit"], "prompt": c["prompt"],
                "tokens": c["tokens"].tolist(),
                "short": {"frames": list(self.short_frames),
                          "got": short.detach().float().cpu().reshape(-1, p, d)},
                "blocks": [b.detach().float().cpu() for b in levels],
                "question": self.questions_of[c["unit"]],
                "query": self.rec.queries[c["unit"]].cpu(), "nodes": self.embedded})
        kept = [int(u) for u in rng.permutation(sorted(self.kept))[:2]]
        return {"requests": requests, "frames": check.kept_frames(self.kept, kept)}
