"""LongVA assembly: vision tower + projector + Qwen2 decoder + splice
(`streamchat_tpu/models/longva.py`).

One model serves the answerer and the captioner. `encode_images` runs the
ViT (K1 per layer, folded, one-pass and clamp on the card) and the
projector (K2); `generate_with_image_embedding`
splices the prompt's `<image>` markers with visual embeddings, pads to a
128-token bucket and generates through the paged backend (K3 prefill, K5
for the chunks of a prompt over 8192 tokens, K4 decode, or K6 over int8
pages with `kv_int8`; K7 verify steps with `spec_tokens`). `quantize`
switches the decoder to int8 / int4 weight-only storage (W8, K10, K11 at
decode), and `shard` then cuts it to one rank's tensor-parallel slice.
`generate_with_image_embedding_batch` serves several prompts with one
batched decode loop (batched captioning), each row prefilled alone.
`score_with_image_embedding` gives a target's teacher-forced NLL and PPL
after the same splice (`--ppl`; models/scoring.py). `kv_budget_tokens`
caps the page pool and turns on H2O eviction (`_paged_budget`): batch 1,
bf16 pages, no speculative decode; a decode step whose heavy-hitter mass a
later compression needs attends through the plain gather that yields it.
Random draws come from the `torch.Generator` the facade holds (the JAX
package's `KeySeq`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import torch

from streamchat_tpu_torch.config import DecoderConfig, ViTConfig
from streamchat_tpu_torch.models import decoder, projector, scoring, vit, weights
from streamchat_tpu_torch.models.generate import pad_to_bucket
from streamchat_tpu_torch.models.generate_paged import generate_paged
from streamchat_tpu_torch.models.spec_decode import build_lookup_arrays
from streamchat_tpu_torch.models.tokenizer import (
    IMAGE_TOKEN_INDEX,
    ByteTokenizer,
    load_tokenizer,
    tokenize_with_image_token,
)
from streamchat_tpu_torch.ops.quant import embed_dtype, quantize_decoder_params

PROMPT_BUCKET = 128     # prompt padding granularity (tokens)


@dataclasses.dataclass
class LongVA:
    vit_params: dict
    proj_params: dict
    dec_params: dict
    vit_cfg: ViTConfig
    dec_cfg: DecoderConfig
    tokenizer: object
    generator: torch.Generator
    # Prefill / decode seconds, decode steps, prompt and generated tokens,
    # summed over every generate call (models/generate_paged `stats`).
    gen_stats: dict = dataclasses.field(default_factory=dict)
    # Store KV pages as int8 + per-(token, head) scales (half the pool
    # bytes a decode step reads). A facade attribute, not a CLI flag, as in
    # the JAX package.
    kv_int8: bool = False
    # Speculative decoding (models/spec_decode): draft tokens per verify
    # step, 0 = off; the prompt's text tokens are the lookup corpus. Applied
    # when top_p is unset; greedy output stays token-identical.
    spec_tokens: int = 0
    spec_ngram: int = 3
    # KV budget in tokens (page-aligned). None sizes the pool so that it
    # never overflows. When set, the pool holds ceil(budget / 128) pages and
    # H2O eviction compresses the cache to 3/4 of them (sink 4, recent a
    # quarter) whenever it runs out; speculative decode is then off, and
    # kv_int8 is refused.
    kv_budget_tokens: Optional[int] = None

    @property
    def device(self) -> torch.device:
        return self.dec_params["final_norm"].device

    def quantize(self, quantize_embed: bool = False, bits: int = 8) -> "LongVA":
        """Switch the decoder to int8 (bits=8) or group-128 int4 (bits=4,
        lm_head kept int8) weight-only storage (ops/quant.py); the ViT and
        projector stay as they are. quantize_embed also stores the token
        table as int8 rows."""
        self.dec_params = quantize_decoder_params(
            self.dec_params, quantize_embed=quantize_embed, bits=bits)
        return self

    def shard(self, mesh=None) -> "LongVA":
        """Cut the decoder to this rank's tensor-parallel slice, in place
        (`parallel.sharding.shard_decoder`; the whole leaves are freed), the
        way `main` calls it: after `quantize`. `mesh` is a `parallel.Mesh`,
        by default the initialized world's (`parallel.make_mesh`); with no
        process group a world of one, and nothing changes. The decoder is
        cut over the mesh's model group; each data replica keeps a whole
        copy, as no JAX pspec names the data axis. The ViT and the projector
        stay whole on every rank: K1 fuses a whole ViT layer, and each
        rank's tower is a one-device model."""
        from streamchat_tpu_torch.parallel import make_mesh
        from streamchat_tpu_torch.parallel.sharding import shard_decoder

        mesh = make_mesh(kv_heads=self.dec_cfg.num_kv_heads) if mesh is None else mesh
        self.dec_params, self.dec_cfg = shard_decoder(self.dec_params, self.dec_cfg,
                                                      mesh.model)
        return self

    @classmethod
    def init_random(cls, vit_cfg: ViTConfig | None = None,
                    dec_cfg: DecoderConfig | None = None, *, seed: int = 0,
                    device="cuda", dtype=torch.bfloat16) -> "LongVA":
        """Random weights at the given geometry (default LongVA-7B), built
        on `device` (the card unless the caller asks for the CPU) from a
        seeded generator."""
        vit_cfg = vit_cfg or ViTConfig()
        dec_cfg = dec_cfg or DecoderConfig.qwen2_7b()
        g = torch.Generator(device=device).manual_seed(seed)
        return cls(
            vit_params=vit.init(vit_cfg, g, device=device, dtype=dtype),
            proj_params=projector.init(vit_cfg.hidden_size, dec_cfg.hidden_size, g,
                                       device=device, dtype=dtype),
            dec_params=decoder.init(dec_cfg, g, device=device, dtype=dtype),
            vit_cfg=vit_cfg, dec_cfg=dec_cfg,
            tokenizer=ByteTokenizer(), generator=g)

    @classmethod
    def from_pretrained(cls, path: str, dtype=torch.bfloat16, *, device="cuda",
                        tokenizer=None) -> "LongVA":
        """Load a LongVA HF checkpoint (llava_qwen; the reference's
        builder.py:27) onto `device`, the card unless the caller asks for
        the CPU. `tokenizer` None reads the checkpoint's own
        (`load_tokenizer(path)`)."""
        vit_cfg, dec_cfg, vit_p, proj_p, dec_p = weights.load_longva(path, dtype,
                                                                     device=device)
        return cls(vit_params=vit_p, proj_params=proj_p, dec_params=dec_p,
                   vit_cfg=vit_cfg, dec_cfg=dec_cfg,
                   tokenizer=load_tokenizer(path) if tokenizer is None else tokenizer,
                   generator=torch.Generator(device=device).manual_seed(0))

    def encode_images(self, pixels: torch.Tensor) -> torch.Tensor:
        """[N, 3, H, W] -> [N, P, lm_hidden] (tower -> projector).

        Where the tower runs fused (weights on the card), the first call
        folds its weights once (`vit.fold_params`, ~350 MB at ViT-L), as the
        JAX package does; SC_NO_VIT_FOLD=1 opts out, and the fused block then
        folds inside each call (the same result)."""
        if (vit._use_fused(None, self.vit_params["patch_embed"]["w"].device)
                and not os.environ.get("SC_NO_VIT_FOLD")
                and "fused" not in self.vit_params["layers"][0]):
            self.vit_params = vit.fold_params(self.vit_params, self.vit_cfg)
        feats = vit.encode(self.vit_params, pixels, self.vit_cfg)
        return projector.apply(self.proj_params, feats)

    def embed_text(self, text: str) -> torch.Tensor:
        ids = torch.tensor(self.tokenizer.encode(text), device=self.device)
        return decoder.embed_tokens(self.dec_params, ids)

    def splice_prompt(self, prompt: str,
                      image_embeddings: Optional[Sequence[torch.Tensor]]
                      ) -> Tuple[torch.Tensor, int]:
        """Prompt text -> (embeds [1, S_pad, D] padded to a PROMPT_BUCKET
        multiple, valid length).

        Each `<image>` consumes the next entry of image_embeddings: a
        [T, D] block or a LIST of blocks. Truncates to
        max_position_embeddings like the reference's tokenizer clamp.
        """
        ids = tokenize_with_image_token(prompt, self.tokenizer)
        dtype = embed_dtype(self.dec_params)
        segments: List[torch.Tensor] = []
        img_idx = 0
        text_run: List[int] = []

        def flush_text():
            if text_run:
                segments.append(decoder.embed_tokens(
                    self.dec_params, torch.tensor(text_run, device=self.device)))
                text_run.clear()

        for tid in ids:
            if tid == IMAGE_TOKEN_INDEX:
                flush_text()
                if image_embeddings is None or img_idx >= len(image_embeddings):
                    raise ValueError("prompt has more <image> tokens than embeddings")
                feats = image_embeddings[img_idx]
                img_idx += 1
                blocks = feats if isinstance(feats, (list, tuple)) else [feats]
                segments.extend(b.reshape(-1, b.shape[-1]).to(dtype) for b in blocks)
            else:
                text_run.append(tid)
        flush_text()
        embeds = torch.cat(segments, dim=0)
        padded, length = self._bucketed(embeds.shape[0])
        out = torch.zeros(padded, embeds.shape[1], dtype=dtype, device=self.device)
        out[:length] = embeds[:length]
        return out[None], length

    def _bucketed(self, total: int) -> Tuple[int, int]:
        """(padded, valid) length of a spliced prompt of `total` tokens."""
        length = min(total, self.dec_cfg.max_position_embeddings)
        return pad_to_bucket(length, PROMPT_BUCKET, minimum=PROMPT_BUCKET), length

    def _splice_length(self, prompt: str,
                       image_embeddings: Optional[Sequence[torch.Tensor]]) -> Tuple[int, int]:
        """(padded, valid) lengths `splice_prompt` would produce, from the
        tokens and the blocks' shapes alone (no device work), so a batch can
        size its rows and splice each one at its prefill turn."""
        total, img_idx = 0, 0
        for tid in tokenize_with_image_token(prompt, self.tokenizer):
            if tid != IMAGE_TOKEN_INDEX:
                total += 1
                continue
            if image_embeddings is None or img_idx >= len(image_embeddings):
                raise ValueError("prompt has more <image> tokens than embeddings")
            feats = image_embeddings[img_idx]
            img_idx += 1
            for blk in feats if isinstance(feats, (list, tuple)) else [feats]:
                total += blk.numel() // blk.shape[-1]
        return self._bucketed(total)

    def generate_with_image_embedding(
        self, prompt: str, image_embeddings: Optional[Sequence[torch.Tensor]] = None,
        *, max_new_tokens: int = 256, temperature: float = 0.0,
        top_p: float | None = None,
    ) -> str:
        embeds, length = self.splice_prompt(prompt, image_embeddings)
        toks, count = generate_paged(
            self.dec_params, self.dec_cfg, embeds,
            torch.tensor([length], dtype=torch.int32, device=self.device),
            self.generator, max_new_tokens=max_new_tokens, temperature=temperature,
            top_p=top_p, eos_ids=tuple(self.tokenizer.eos_ids), stats=self.gen_stats,
            **self._paged_budget(),
            **self._spec_kwargs([prompt], top_p))
        return self.tokenizer.decode(toks[0][: int(count[0])].tolist()).strip()

    def score_with_image_embedding(
        self, prompt: str, target: str,
        image_embeddings: Optional[Sequence[torch.Tensor]] = None) -> Tuple[float, float]:
        """Teacher-forced (mean NLL, PPL) of `target` given the spliced
        prompt: the `--ppl` metric (models/scoring.sequence_nll). The
        target is a mid-sequence continuation, encoded without specials."""
        target_ids = self.tokenizer.encode(target, add_special_tokens=False)
        embeds, length = self.splice_prompt(prompt, image_embeddings)
        nll = scoring.sequence_nll(
            self.dec_params, self.dec_cfg, embeds, length,
            torch.tensor(target_ids, dtype=torch.int64, device=self.device))
        return float(nll), float(torch.exp(nll))

    def _spec_kwargs(self, prompts, top_p) -> dict:
        """Speculative-decode kwargs for generate_paged, or {} when off (or
        top_p or a KV budget is set). The lookup corpus is the prompts' text tokens, image
        sentinels dropped, in a 256-token bucket."""
        if self.spec_tokens <= 0 or top_p is not None or self.kv_budget_tokens is not None:
            return {}
        rows = [[t for t in tokenize_with_image_token(p, self.tokenizer) if t >= 0]
                for p in prompts]
        return {"spec_tokens": self.spec_tokens, "spec_ngram": self.spec_ngram,
                **build_lookup_arrays(rows)}

    def _paged_budget(self) -> dict:
        """`generate_paged`'s pool and H2O arguments. Without a budget: 128-
        token pages sized to never overflow (int8 with kv_int8). With
        `kv_budget_tokens`: a pool of cap = ceil(budget / 128) * 128 slots
        (at least two pages), recent = max(128, cap / 4), sink 4, hh =
        3 cap / 4 - sink - recent; ValueError when hh <= 0 or with kv_int8."""
        ps = 128
        if self.kv_budget_tokens is None:
            return {"page_size": ps, "kv_int8": True} if self.kv_int8 else {"page_size": ps}
        if self.kv_int8:
            raise ValueError("kv_int8 and kv_budget_tokens are exclusive")
        cap = max(-(-self.kv_budget_tokens // ps), 2) * ps
        recent = max(ps, cap // 4)
        sink = 4
        hh = (3 * cap) // 4 - sink - recent
        if hh <= 0:
            raise ValueError(f"kv_budget_tokens={self.kv_budget_tokens} too small")
        pages = cap // ps
        return {"page_size": ps, "num_pages": pages, "max_pages_per_seq": pages,
                "hh_size": hh, "recent_size": recent, "sink_size": sink}

    def generate_with_image_embedding_batch(
        self, prompts: Sequence[str],
        image_embeddings: Sequence[Optional[Sequence[torch.Tensor]]], *,
        max_new_tokens: int = 256, temperature: float = 0.0,
        top_p: float | None = None) -> List[str]:
        """Several prompts through one `generate_paged` call: ragged rows are
        padded to the longest row's bucket, each row prefills alone into a
        partitioned pool and one decode loop serves them all (the weights a
        decode step reads serve every row). Rows after the first are made
        lazily, at their prefill turn, so one spliced row at a time waits
        for its pages. Under `kv_budget_tokens` the rows generate one after
        another through `generate_with_image_embedding` (H2O eviction runs at
        batch 1), so no row's pool outgrows the budget."""
        if not prompts:
            return []
        if self.kv_budget_tokens is not None:
            return [self.generate_with_image_embedding(
                p, e, max_new_tokens=max_new_tokens, temperature=temperature, top_p=top_p)
                for p, e in zip(prompts, image_embeddings)]
        sizes = [self._splice_length(p, e) for p, e in zip(prompts, image_embeddings)]
        max_pad = max(padded for padded, _ in sizes)

        def make_row(p, embs):
            e, _ = self.splice_prompt(p, embs)
            return torch.nn.functional.pad(e, (0, 0, 0, max_pad - e.shape[1]))

        rows = [make_row(prompts[0], image_embeddings[0])] + [
            (lambda p=p, e=e: make_row(p, e))
            for p, e in zip(prompts[1:], image_embeddings[1:])]
        toks, count = generate_paged(
            self.dec_params, self.dec_cfg, rows,
            torch.tensor([n for _, n in sizes], dtype=torch.int32, device=self.device),
            self.generator, max_new_tokens=max_new_tokens, temperature=temperature,
            top_p=top_p, eos_ids=tuple(self.tokenizer.eos_ids), kv_int8=self.kv_int8,
            stats=self.gen_stats, **self._spec_kwargs(prompts, top_p))
        return [self.tokenizer.decode(toks[r][: int(count[r])].tolist()).strip()
                for r in range(len(prompts))]
