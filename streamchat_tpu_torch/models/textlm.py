"""Text-only causal LM facade: the LLaMA-3 judge (`streamchat_tpu/models/textlm.py`).

The reference loads a second HF stack (LlamaForCausalLM) just to run the
judge; here the decoder that runs LongVA's Qwen2 backbone runs LLaMA-3
weights. `generate_batch` pads the prompts to one 128-token bucket, prefills
them together (K3) and decodes them in one dense loop
(`models/generate.generate`: W8 GEMVs at decode for an int8 tree, K10 / K11
for int4), or with `spec_tokens` > 0 through `generate_paged`'s speculative
loop on a partitioned page pool (K7 verify steps), drafting from each
prompt and a rolling corpus of the last 8 outputs. Random draws come from
the `torch.Generator` the facade holds (the JAX package's `KeySeq`).
"""

from __future__ import annotations

import dataclasses

import torch

from streamchat_tpu_torch.config import DecoderConfig
from streamchat_tpu_torch.models import decoder, generate as genlib, weights
from streamchat_tpu_torch.models.generate_paged import generate_paged
from streamchat_tpu_torch.models.spec_decode import build_lookup_arrays
from streamchat_tpu_torch.models.tokenizer import ByteTokenizer, load_tokenizer
from streamchat_tpu_torch.ops.quant import embed_dtype, quantize_decoder_params


@dataclasses.dataclass
class TextLM:
    params: dict
    cfg: DecoderConfig
    tokenizer: object
    generator: torch.Generator
    # Speculative decoding (models/spec_decode), 0 = off. The judge is greedy
    # and its verdicts are formulaic, so a rolling corpus of recent outputs
    # drafts most of each verdict.
    spec_tokens: int = 0
    spec_ngram: int = 3
    # Prefill / decode seconds, decode steps, prompt and generated tokens
    # (and verify steps and accepted tokens), summed over every call.
    gen_stats: dict = dataclasses.field(default_factory=dict)
    # Rolling lookup corpus: token ids of the last 8 generations.
    _spec_corpus: list = dataclasses.field(default_factory=list, repr=False)

    @property
    def device(self) -> torch.device:
        return self.params["final_norm"].device

    @classmethod
    def init_random(cls, cfg: DecoderConfig | None = None, *, seed: int = 0, tokenizer=None,
                    device="cuda", dtype=torch.bfloat16) -> "TextLM":
        """Random weights at `cfg` (default LLaMA-3-8B), built on `device`
        (the card unless the caller asks for the CPU) from a seeded
        generator."""
        cfg = cfg or DecoderConfig.llama3_8b()
        g = torch.Generator(device=device).manual_seed(seed)
        return cls(decoder.init(cfg, g, device=device, dtype=dtype), cfg,
                   tokenizer or ByteTokenizer(), g)

    @classmethod
    def from_pretrained(cls, path: str, dtype=torch.bfloat16, *, device="cuda",
                        tokenizer=None) -> "TextLM":
        """Load a Qwen2 / LLaMA-3 HF checkpoint onto `device`, the card
        unless the caller asks for the CPU. `tokenizer` None reads the
        checkpoint's own (`load_tokenizer(path)`)."""
        cfg, params = weights.load_decoder(path, dtype, device=device)
        return cls(params, cfg, load_tokenizer(path) if tokenizer is None else tokenizer,
                   torch.Generator(device=device).manual_seed(0))

    def shard(self, mesh=None) -> "TextLM":
        """Tensor-parallel slice of the decoder, in place (see LongVA.shard)."""
        from streamchat_tpu_torch.parallel import make_mesh
        from streamchat_tpu_torch.parallel.sharding import shard_decoder

        mesh = make_mesh(kv_heads=self.cfg.num_kv_heads) if mesh is None else mesh
        self.params, self.cfg = shard_decoder(self.params, self.cfg, mesh.model)
        return self

    def quantize(self, bits: int = 8) -> "TextLM":
        """int8 (bits=8) or group-128 int4 (bits=4, lm_head int8) weight-only
        decoder storage (ops/quant.py)."""
        self.params = quantize_decoder_params(self.params, bits=bits)
        return self

    def generate(self, prompt: str, *, max_new_tokens: int = 128, temperature: float = 0.0,
                 top_p: float | None = None) -> str:
        return self.generate_batch([prompt], max_new_tokens=max_new_tokens,
                                   temperature=temperature, top_p=top_p)[0]

    def generate_batch(self, prompts: list, *, max_new_tokens: int = 128,
                       temperature: float = 0.0, top_p: float | None = None) -> list:
        """Batched generation: the prompts pad to one 128-token bucket, one
        prefill and one decode loop serve the whole batch, and tokens and
        counts come back to the host in one copy."""
        if isinstance(prompts, str):
            # A bare string iterates as characters: one batch row per character.
            raise TypeError("generate_batch expects a list of prompts; "
                            "got a bare str — use generate() instead")
        if not prompts:
            return []
        # Judge prompts carry their special tokens in the text: no second BOS.
        ids = [self.tokenizer.encode(p, add_special_tokens=False) for p in prompts]
        lengths = [len(i) for i in ids]
        padded = genlib.pad_to_bucket(max(lengths))
        b, dev = len(prompts), self.device
        tokens = torch.zeros(b, padded, dtype=torch.long)
        for row, seq in enumerate(ids):
            tokens[row, :len(seq)] = torch.tensor(seq, dtype=torch.long)
        tokens = tokens.to(dev)
        pad = torch.arange(padded)[None] >= torch.tensor(lengths)[:, None]
        embeds = decoder.embed_tokens(self.params, tokens).to(embed_dtype(self.params))
        embeds = embeds.masked_fill(pad.to(dev)[..., None], 0.0)     # zeros past each prompt
        common = dict(max_new_tokens=max_new_tokens, temperature=temperature, top_p=top_p,
                      eos_ids=tuple(self.tokenizer.eos_ids), stats=self.gen_stats)
        seq_length = torch.tensor(lengths, dtype=torch.int32, device=dev)
        if self.spec_tokens > 0 and top_p is None:
            toks, count = generate_paged(self.params, self.cfg, embeds, seq_length,
                                         self.generator, spec_tokens=self.spec_tokens,
                                         spec_ngram=self.spec_ngram, **common,
                                         **self._spec_lookup(ids))
        else:
            toks, count = genlib.fetch(*genlib.generate(self.params, self.cfg, embeds, seq_length,
                                                        self.generator, **common))
        outs = [toks[row][: int(count[row])].tolist() for row in range(b)]
        if self.spec_tokens > 0:
            # Feed the rolling corpus: later verdicts share these n-grams.
            self._spec_corpus.extend(o for o in outs if o)
            del self._spec_corpus[:-8]
        return [self.tokenizer.decode(o).strip() for o in outs]

    def _spec_lookup(self, ids) -> dict:
        """Lookup corpus rows: each prompt's own tokens plus the last 1,024
        tokens of the rolling corpus (spec_decode.build_lookup_arrays)."""
        recent = [t for o in self._spec_corpus for t in o][-1024:]
        return build_lookup_arrays([list(r) + recent for r in ids])
