"""Question answering, captioning and summarizing (`streamchat_tpu/pipeline/answer.py`).

The multi-modal answer: tree retrieval by the question's colbert
embedding, prompt assembly with the retrieved-dialogue history and the
most fine-grained caption, and a spliced [short | retrieved levels]
visual block at `<image>`; `SamplingConfig.max_visual_tokens` caps the
visual tokens by dropping the coarsest levels first. The uni-modal answer
(`--multi_modal_memory` unset, the CLI's default) puts no caption text in
the prompt and retrieves by feature-space search with the query
[question token embeddings | short memory], in up to
`max_answer_tokens_unimodal` tokens. With a `ppl_target` (`--ppl`) either
answer also scores the ground-truth answer under the same spliced prompt
(`LongVA.score_with_image_embedding`). The captioner also captions a
group of chunks in one batched generate (`SamplingConfig.caption_batch`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import torch

from streamchat_tpu_torch.config import SamplingConfig
from streamchat_tpu_torch.memory.tree import VisualMemoryTree
from streamchat_tpu_torch.pipeline import prompts
from streamchat_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class AnswerResult:
    output: str
    process_time: float          # retrieval + prompt assembly
    generate_time: float
    # Teacher-forced mean NLL and perplexity of the ground-truth answer
    # under the same spliced prompt (--ppl), else None.
    nll: Optional[float] = None
    ppl: Optional[float] = None
    # Host seconds of the retrieval half: embed_query_s, tree_search_s (the
    # `answer.embed_query` and `answer.tree_search` spans), assemble_s (the
    # multi-modal answer only).
    timings: Optional[dict] = None


def answer_question(question: str, model, embed_query, short_memory: torch.Tensor,
                    tree: Optional[VisualMemoryTree], history_prompt: Optional[str],
                    sampling: SamplingConfig, conv_mode: str = "qwen_1_5",
                    ppl_target: Optional[str] = None) -> AnswerResult:
    t0 = time.time()
    short_flat = short_memory.reshape(-1, short_memory.shape[-1])
    most_fine_grad_text: Optional[str] = None
    blocks: List[torch.Tensor] = [short_flat]
    t_embed = t_search = 0.0
    if tree is not None and len(tree) > 0:
        with span("answer.embed_query") as embed:
            q_emb = embed_query(question)
        with span("answer.tree_search") as search:
            feats, texts = tree.search(q_emb)
        t_embed, t_search = embed.seconds, search.seconds
        if feats:
            flat_levels = [f.reshape(-1, f.shape[-1]) for f in feats]
            budget = sampling.max_visual_tokens
            if budget is not None:
                # Drop the coarsest levels first (search returns coarse ->
                # fine); short memory and the finest level always survive.
                keep: List[torch.Tensor] = []
                used = short_flat.shape[0]
                for f in reversed(flat_levels):
                    if keep and used + f.shape[0] > budget:
                        break
                    keep.append(f)
                    used += f.shape[0]
                flat_levels = keep[::-1]
            most_fine_grad_text = texts[-1]
            blocks = [short_flat] + flat_levels
    qs = prompts.build_answer_prompt(question, history_prompt, most_fine_grad_text)
    prompt = prompts.wrap_user_turn(conv_mode, qs)
    t1 = time.time()
    output = model.generate_with_image_embedding(
        prompt, image_embeddings=[blocks], max_new_tokens=sampling.max_answer_tokens,
        temperature=sampling.temperature, top_p=sampling.top_p)
    t2 = time.time()
    nll, ppl = _maybe_score(model, prompt, [blocks], ppl_target)
    return AnswerResult(
        output, t1 - t0, t2 - t1, nll=nll, ppl=ppl,
        timings={"embed_query_s": round(t_embed, 4), "tree_search_s": round(t_search, 4),
                 "assemble_s": round(t1 - t0 - t_embed - t_search, 4)})


def _maybe_score(model, prompt, image_embeddings, ppl_target):
    if ppl_target is None:
        return None, None
    return model.score_with_image_embedding(prompt, ppl_target, image_embeddings)


def answer_question_unimodal(question: str, model, short_memory: torch.Tensor,
                             tree: Optional[VisualMemoryTree], history_prompt: Optional[str],
                             sampling: SamplingConfig, conv_mode: str = "qwen_1_5",
                             ppl_target: Optional[str] = None) -> AnswerResult:
    """The uni-modal answer: no caption text in the prompt; the tree
    searched in feature space (`search_features`) with the query
    [question token embeddings in short memory's dtype | short memory]."""
    t0 = time.time()
    short_flat = short_memory.reshape(-1, short_memory.shape[-1])
    blocks: List[torch.Tensor] = [short_flat]
    if tree is not None and len(tree) > 0:
        q_emb = model.embed_text(question)
        feats = tree.search_features(torch.cat([q_emb.to(short_flat.dtype), short_flat]))
        if feats:
            blocks = [short_flat] + [f.reshape(-1, f.shape[-1]) for f in feats]
    qs = prompts.build_answer_prompt_unimodal(question, history_prompt)
    prompt = prompts.wrap_user_turn(conv_mode, qs)
    t1 = time.time()
    output = model.generate_with_image_embedding(
        prompt, image_embeddings=[blocks], max_new_tokens=sampling.max_answer_tokens_unimodal,
        temperature=sampling.temperature, top_p=sampling.top_p)
    t2 = time.time()
    nll, ppl = _maybe_score(model, prompt, [blocks], ppl_target)
    return AnswerResult(output, t1 - t0, t2 - t1, nll=nll, ppl=ppl)


def make_captioner(model, sampling: SamplingConfig):
    """Chunk features [T, P, D] -> caption (conv qwen_1_5_ego, 128 tokens,
    caption_temperature, 128-token prompt bucket). `caption.batch` captions
    a list of chunks in one batched generate, in groups of
    `caption.batch_size` (sampling.caption_batch) chosen by the caller."""
    prompt = prompts.build_caption_prompt()

    def caption(chunk_features: torch.Tensor) -> str:
        flat = chunk_features.reshape(-1, chunk_features.shape[-1])
        return model.generate_with_image_embedding(
            prompt, image_embeddings=[flat], max_new_tokens=sampling.max_caption_tokens,
            temperature=sampling.caption_temperature)

    def caption_batch(chunks: List[torch.Tensor]) -> List[str]:
        flats = [c.reshape(-1, c.shape[-1]) for c in chunks]
        return model.generate_with_image_embedding_batch(
            [prompt] * len(flats), [[f] for f in flats],
            max_new_tokens=sampling.max_caption_tokens,
            temperature=sampling.caption_temperature)

    caption.batch = caption_batch
    caption.batch_size = max(1, sampling.caption_batch)
    return caption


def make_summarizer(model, sampling: SamplingConfig):
    """Caption list -> merged summary (text-only, ordinal prompt, 256 tokens)."""

    def summarize(captions: List[str]) -> str:
        return model.generate_with_image_embedding(
            prompts.build_summary_prompt(captions), image_embeddings=None,
            max_new_tokens=sampling.max_summary_tokens,
            temperature=sampling.caption_temperature)

    return summarize
