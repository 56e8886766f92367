"""Tokenization utilities.

Wraps a HF tokenizer when a checkpoint path is available, with a byte-level
fallback so every pipeline stage is testable offline. Also provides
`tokenize_with_image_token`, the equivalent of the reference's
`tokenizer_image_token` (`longva/mm_utils.py:341-360`): split the prompt on
`<image>` and insert IMAGE_TOKEN_INDEX (-200) markers between the chunks.
"""

from __future__ import annotations

import os
from typing import List, Protocol, Sequence

# Reference constants (longva/constants.py).
IMAGE_TOKEN_INDEX = -200
DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"


class Tokenizer(Protocol):
    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]: ...
    def decode(self, ids: Sequence[int]) -> str: ...
    @property
    def eos_ids(self) -> tuple: ...


class ByteTokenizer:
    """UTF-8 byte fallback tokenizer (ids 0..255, specials above).

    Used when no HF checkpoint is present (tests, random-weight benches).
    """

    BOS = 256
    EOS = 257

    def __init__(self) -> None:
        self.vocab_size = 258

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", errors="replace")

    @property
    def eos_ids(self) -> tuple:
        return (self.EOS,)


class HFTokenizer:
    """Thin adapter over transformers.AutoTokenizer (lazy import: the port
    needs `transformers` only to read a checkpoint's own tokenizer)."""

    def __init__(self, path: str) -> None:
        from transformers import AutoTokenizer  # deferred: a slow import

        self._tok = AutoTokenizer.from_pretrained(path, use_fast=True)
        self.vocab_size = len(self._tok)

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        # Default True: BERT embedders need [CLS]/[SEP] for CLS/mean pooling.
        # Decoder-side callers whose prompts carry explicit specials (ChatML
        # <|im_start|>, the judge's <|begin_of_text|> header) pass False:
        # LLaMA-3's tokenizer would otherwise inject a second BOS.
        return self._tok(text, add_special_tokens=add_special_tokens).input_ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode([i for i in ids if i >= 0], skip_special_tokens=True)

    @property
    def eos_ids(self) -> tuple:
        ids = [self._tok.eos_token_id]
        # ChatML models use <|im_end|> as the turn stop, LLaMA-3 <|eot_id|>.
        for t in ("<|im_end|>", "<|eot_id|>"):
            tid = self._tok.convert_tokens_to_ids(t)
            if tid is not None and tid >= 0 and tid not in ids:
                ids.append(tid)
        return tuple(i for i in ids if i is not None)


def load_tokenizer(path: str | None):
    """The checkpoint's tokenizer when `path` exists, else the byte fallback."""
    if path and os.path.exists(path):
        return HFTokenizer(path)
    return ByteTokenizer()


def tokenize_with_image_token(
    prompt: str, tokenizer, image_token_index: int = IMAGE_TOKEN_INDEX
) -> List[int]:
    """Token ids with `image_token_index` in place of each `<image>`.

    Mirrors mm_utils.tokenizer_image_token: encode the text between <image>
    occurrences and join with the marker id.
    """
    chunks = prompt.split(DEFAULT_IMAGE_TOKEN)
    ids: List[int] = []
    for i, chunk in enumerate(chunks):
        if i > 0:
            ids.append(image_token_index)
        if chunk:
            # ChatML prompts carry their specials in-text; per-chunk BOS
            # injection would corrupt the splice (the reference handles the
            # same hazard with an explicit BOS-offset dance,
            # mm_utils.py:341-360; Qwen2 adds no specials either way).
            ids.extend(tokenizer.encode(chunk, add_special_tokens=False))
    return ids
