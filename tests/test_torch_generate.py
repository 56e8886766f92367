"""The port's dense-cache generation against the JAX package's, on the CPU.

Inputs are numpy arrays made from a seed and handed to both packages, at
tiny geometry in float32 with the same weights (`convert`). Tolerances:
- `decoder.decode_step` over a dense `KVCache` of three ragged rows: logits
  and the appended K/V within 1e-4 of JAX's `decoder.decode_step` (f32,
  another summation order in the products).
- `generate`: greedy tokens identical to JAX's `generate` and the same
  counts, with an EOS that ends one row early.
- The dense loop on LongVA's spliced prompts: the same strings as the JAX
  package's contiguous backend (`LongVA.decode_backend="contiguous"`, the
  same loop) and as the port's paged backend.
On a CPU tensor no wrapper may count a kernel launch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamchat_tpu import config as jconfig
from streamchat_tpu.models import decoder as jdec
from streamchat_tpu.models import generate as jgen
from streamchat_tpu.models.longva import LongVA as JLongVA
from streamchat_tpu_torch import config, convert, kernels
from streamchat_tpu_torch.models import decoder, generate
from streamchat_tpu_torch.models.longva import LongVA
from streamchat_tpu_torch.models.tokenizer import ByteTokenizer

ATOL = 1e-4


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture
def no_launches():
    kernels.reset_launch_counts()
    yield
    assert all(v == 0 for v in kernels.launch_counts().values()), \
        "a CPU tensor must run the plain twin, never count a launch"


@pytest.fixture(scope="module")
def tiny():
    """Tiny f32 decoder weights in both packages."""
    jcfg = jconfig.DecoderConfig.tiny()
    jparams = jdec.init(jax.random.key(0), jcfg, jnp.float32)
    return dict(jcfg=jcfg, jparams=jparams,
                cfg=config.DecoderConfig(**dataclasses.asdict(jcfg)),
                params=convert.to_torch(_np(jparams)))


def test_decode_step_matches_jax(no_launches, tiny):
    """Three ragged rows prefilled into a 64-slot cache, then three decode
    steps: each row appends at its own length."""
    jcfg, cfg = tiny["jcfg"], tiny["cfg"]
    lengths = np.asarray([29, 17, 5], np.int32)
    embeds = _rand(3, 3, 32, jcfg.hidden_size, scale=0.5)
    jcache = jdec.KVCache.create(jcfg, 3, 64, dtype=jnp.float32)
    ref, jcache = jdec.prefill(tiny["jparams"], jcfg, jnp.asarray(embeds), jcache,
                               jnp.asarray(lengths))
    cache = decoder.KVCache.create(cfg, 3, 64, dtype=torch.float32)
    out, cache = decoder.prefill(tiny["params"], cfg, torch.from_numpy(embeds), cache,
                                 torch.from_numpy(lengths))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    for step, toks in enumerate(([7, 300, 1], [42, 42, 511], [0, 9, 128])):
        ref, jcache = jdec.decode_step(tiny["jparams"], jcfg, jnp.asarray(toks, jnp.int32),
                                       jcache)
        out, cache = decoder.decode_step(tiny["params"], cfg, torch.tensor(toks), cache)
        assert out.shape == (3, jcfg.vocab_size) and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
        assert cache.length.tolist() == (lengths + step + 1).tolist()
    for got, want in ((cache.k, jcache.k), (cache.v, jcache.v)):
        for row, n in enumerate(lengths):
            np.testing.assert_allclose(got[:, row, :, n:n + 3].numpy(),
                                       np.asarray(want)[:, row, :, n:n + 3], atol=ATOL, rtol=0)


def test_decode_step_refuses_an_int8_cache(tiny):
    cache = decoder.Int8KVCache.create(tiny["cfg"], 1, 16)
    with pytest.raises(NotImplementedError, match="Int8KVCache"):
        decoder.decode_step(tiny["params"], tiny["cfg"], torch.tensor([3]), cache)


def test_generate_matches_jax_with_early_eos(no_launches, tiny):
    """Greedy: the same tokens and counts as JAX's `generate`. The EOS id is
    the token row 1 emits at step 2 without one, so that row ends early
    while the others run on; finished rows emit the pad id."""
    jcfg, cfg = tiny["jcfg"], tiny["cfg"]
    lengths = np.asarray([37, 12, 25], np.int32)
    embeds = _rand(4, 3, 40, jcfg.hidden_size, scale=0.5)
    args = (jnp.asarray(embeds), jnp.asarray(lengths), jax.random.key(1))
    free, _ = jgen.generate(tiny["jparams"], jcfg, *args, max_new_tokens=10, eos_ids=(-1,))
    eos = int(np.asarray(free)[1, 2])
    ref_toks, ref_count = jgen.generate(tiny["jparams"], jcfg, *args, max_new_tokens=10,
                                        eos_ids=(eos,))
    stats = {}
    toks, count = generate.generate(tiny["params"], cfg, torch.from_numpy(embeds),
                                    torch.from_numpy(lengths), max_new_tokens=10,
                                    eos_ids=(eos,), stats=stats)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(ref_toks))
    np.testing.assert_array_equal(count.numpy(), np.asarray(ref_count))
    assert int(count[1]) <= 2 < int(count.max())
    assert (toks[1, int(count[1]) + 1:] == cfg.pad_token_id).all()
    assert stats["prompt_tokens"] == 3 * 40 and stats["generated_tokens"] == int(count.sum())


def _longvas():
    dcfg = jconfig.DecoderConfig.tiny()
    jm = JLongVA.init_random(jax.random.key(0), jconfig.ViTConfig.tiny(
        projection_dim=dcfg.hidden_size), dcfg, dtype=jnp.float32)
    m = LongVA(vit_params=convert.vit_params(_np(jm.vit_params)),
               proj_params=convert.to_torch(_np(jm.proj_params)),
               dec_params=convert.to_torch(_np(jm.dec_params)),
               vit_cfg=config.ViTConfig(**dataclasses.asdict(jm.vit_cfg)),
               dec_cfg=config.DecoderConfig(**dataclasses.asdict(dcfg)),
               tokenizer=ByteTokenizer(), generator=torch.Generator().manual_seed(0))
    return jm, m


PROMPTS = ["<|im_start|>user\n<image>\nDescribe.<|im_end|>\n",
           "<|im_start|>user\n<image>\nWhat is here, and why?<|im_end|>\n",
           "<|im_start|>user\nNo picture.<|im_end|>\n"]


@pytest.mark.parametrize("batch", [False, True], ids=["one_prompt", "three_prompts"])
def test_contiguous_backend_matches_jax_and_paged(no_launches, batch):
    """`generate` over LongVA's spliced rows (zero-padded to the widest, as
    the JAX contiguous backend concatenates them) gives the JAX package's
    contiguous backend's strings and the port's paged backend's (ragged
    multimodal rows for a batch)."""
    jm, m = _longvas()
    feats = [_rand(100, 150, 128, scale=0.5), _rand(101, 20, 128, scale=0.5)]
    jembs = [[jnp.asarray(feats[0])], [jnp.asarray(feats[1])], None]
    pembs = [[torch.from_numpy(feats[0])], [torch.from_numpy(feats[1])], None]
    jm.decode_backend = "contiguous"
    rows = range(3) if batch else [1]
    if batch:
        ref = jm.generate_with_image_embedding_batch(PROMPTS, jembs, max_new_tokens=8,
                                                     temperature=0.0)
        paged = m.generate_with_image_embedding_batch(PROMPTS, pembs, max_new_tokens=8,
                                                      temperature=0.0)
    else:
        ref = [jm.generate_with_image_embedding(PROMPTS[1], jembs[1], max_new_tokens=8,
                                                temperature=0.0)]
        paged = [m.generate_with_image_embedding(PROMPTS[1], pembs[1], max_new_tokens=8,
                                                 temperature=0.0)]
    spliced = [m.splice_prompt(PROMPTS[r], pembs[r]) for r in rows]
    width = max(e.shape[1] for e, _ in spliced)
    embeds = torch.cat([torch.nn.functional.pad(e, (0, 0, 0, width - e.shape[1]))
                        for e, _ in spliced])
    stats = {}
    toks, count = generate.fetch(*generate.generate(
        m.dec_params, m.dec_cfg, embeds, torch.tensor([n for _, n in spliced]),
        max_new_tokens=8, eos_ids=tuple(m.tokenizer.eos_ids), stats=stats))
    dense = [m.tokenizer.decode(toks[r][: int(count[r])].tolist()).strip()
             for r in range(len(spliced))]
    assert dense == ref == paged and any(dense)
    assert stats["decode_steps"] == m.gen_stats["decode_steps"] == 8
