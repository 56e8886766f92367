"""Question answering, captioning and summarizing (`streamchat_tpu/pipeline/answer.py`).

The multi-modal answer: tree retrieval by the question's colbert
embedding, prompt assembly with the retrieved-dialogue history and the
most fine-grained caption, and a spliced [short | retrieved levels]
visual block at `<image>`. The captioner also captions a group of chunks
in one batched generate (`SamplingConfig.caption_batch`). The uni-modal
variant, label scoring (--ppl) and the visual-token budget are not ported
yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import torch

from streamchat_tpu_torch.config import SamplingConfig
from streamchat_tpu_torch.memory.tree import VisualMemoryTree
from streamchat_tpu_torch.pipeline import prompts


@dataclasses.dataclass
class AnswerResult:
    output: str
    process_time: float          # retrieval + prompt assembly
    generate_time: float


def answer_question(question: str, model, embed_query, short_memory: torch.Tensor,
                    tree: Optional[VisualMemoryTree], history_prompt: Optional[str],
                    sampling: SamplingConfig, conv_mode: str = "qwen_1_5") -> AnswerResult:
    if sampling.max_visual_tokens is not None:
        raise NotImplementedError(
            "max_visual_tokens is not ported yet: ROADMAP §A 'Retrieval and answer'")
    t0 = time.time()
    short_flat = short_memory.reshape(-1, short_memory.shape[-1])
    most_fine_grad_text: Optional[str] = None
    blocks: List[torch.Tensor] = [short_flat]
    if tree is not None and len(tree) > 0:
        feats, texts = tree.search(embed_query(question))
        if feats:
            most_fine_grad_text = texts[-1]
            blocks = [short_flat] + [f.reshape(-1, f.shape[-1]) for f in feats]
    qs = prompts.build_answer_prompt(question, history_prompt, most_fine_grad_text)
    prompt = prompts.wrap_user_turn(conv_mode, qs)
    t1 = time.time()
    output = model.generate_with_image_embedding(
        prompt, image_embeddings=[blocks], max_new_tokens=sampling.max_answer_tokens,
        temperature=sampling.temperature, top_p=sampling.top_p)
    return AnswerResult(output, t1 - t0, time.time() - t1)


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
