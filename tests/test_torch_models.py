"""The port's models against the JAX package's, on the same weights.

JAX parameters are built at tiny geometry in float32, handed over as numpy
(`streamchat_tpu_torch.convert`), and both packages run the same inputs:
whole models agree to 1e-4, generation is token-exact under greedy
decoding. On the CPU the port runs its kernels' plain twins.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamchat_tpu import config as jconfig
from streamchat_tpu.models import decoder as jdec
from streamchat_tpu.models import embedder as jemb
from streamchat_tpu.models import projector as jproj
from streamchat_tpu.models import vit as jvit
from streamchat_tpu.models.generate_paged import generate_paged_fetch
from streamchat_tpu.models.longva import LongVA as JLongVA
from streamchat_tpu.models.paged_kv import decode_step_paged as j_decode_step_paged
from streamchat_tpu.models.paged_kv import from_contiguous as j_from_contiguous
from streamchat_tpu.pipeline import ingest as jingest
from streamchat_tpu.pipeline.preprocess import preprocess_frames as j_preprocess
from streamchat_tpu.video.reader import SyntheticVideoReader
from streamchat_tpu_torch import config, convert
from streamchat_tpu_torch.models import decoder, embedder, paged_kv, projector, vit
from streamchat_tpu_torch.models.generate_paged import generate_paged
from streamchat_tpu_torch.models.longva import LongVA
from streamchat_tpu_torch.models.tokenizer import ByteTokenizer
from streamchat_tpu_torch.pipeline import ingest
from streamchat_tpu_torch.pipeline.preprocess import preprocess_frames

ATOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfg(jcfg, cls):
    return cls(**dataclasses.asdict(jcfg))


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def port_longva(jm: JLongVA) -> LongVA:
    return LongVA(
        vit_params=convert.vit_params(_np(jm.vit_params)),
        proj_params=convert.to_torch(_np(jm.proj_params)),
        dec_params=convert.to_torch(_np(jm.dec_params)),
        vit_cfg=_cfg(jm.vit_cfg, config.ViTConfig),
        dec_cfg=_cfg(jm.dec_cfg, config.DecoderConfig),
        tokenizer=ByteTokenizer(), generator=torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def jmodel():
    dcfg = jconfig.DecoderConfig.tiny()
    return JLongVA.init_random(
        jax.random.key(0), jconfig.ViTConfig.tiny(projection_dim=dcfg.hidden_size),
        dcfg, dtype=jnp.float32)


@pytest.fixture(scope="module")
def model(jmodel):
    return port_longva(jmodel)


@pytest.mark.parametrize("n,h,w,size", [(3, 40, 64, 28), (2, 20, 30, 28), (2, 64, 48, 28)])
def test_preprocess_matches_jax(n, h, w, size):
    frames = np.random.default_rng(n).integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    ref = j_preprocess(jnp.asarray(frames), size)
    out = preprocess_frames(frames, size)
    assert out.shape == (n, 3, size, size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_vit_encode_matches_jax(jmodel, model):
    pixels = _rand(1, 2, 3, 56, 56)
    ref = jvit.encode(jmodel.vit_params, jnp.asarray(pixels), jmodel.vit_cfg)
    out = vit.encode(model.vit_params, torch.from_numpy(pixels), model.vit_cfg)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_projector_matches_jax(jmodel, model):
    feats = _rand(2, 2, 16, 64)
    ref = jproj.apply(jmodel.proj_params, jnp.asarray(feats))
    out = projector.apply(model.proj_params, torch.from_numpy(feats))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


@pytest.mark.parametrize("start,end", [(0, 2), (1, 3)])
def test_encode_segment_matches_jax(jmodel, model, start, end):
    reader = SyntheticVideoReader(total_frames=120, frame_rate=30, height=56, width=56)
    jvc = jconfig.VideoConfig(image_size=56)
    ref = jingest.encode_segment(jmodel, reader, start, end, jvc, chunk_size=4)
    out = ingest.encode_segment(model, reader, start, end,
                                _cfg(jvc, config.VideoConfig), chunk_size=4)
    assert out.shape == ref.shape == (12, 16, 128)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def _prefill_inputs(jmodel, s, valid, seed=3):
    embeds = _rand(seed, 1, s, jmodel.dec_cfg.hidden_size, scale=0.5)
    return embeds, np.asarray([valid], np.int32)


def test_decoder_prefill_matches_jax(jmodel, model):
    jcfg = jmodel.dec_cfg
    embeds, length = _prefill_inputs(jmodel, 48, 45)
    jcache = jdec.KVCache.create(jcfg, 1, 48, dtype=jnp.float32)
    ref_logits, ref_cache = jdec.prefill(jmodel.dec_params, jcfg, jnp.asarray(embeds),
                                         jcache, jnp.asarray(length))
    cache = decoder.KVCache.create(model.dec_cfg, 1, 48, dtype=torch.float32)
    logits, cache = decoder.prefill(model.dec_params, model.dec_cfg,
                                    torch.from_numpy(embeds), cache, torch.from_numpy(length))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=ATOL, rtol=0)
    np.testing.assert_allclose(cache.k.numpy()[..., :45, :],
                               np.asarray(ref_cache.k)[..., :45, :], atol=ATOL, rtol=0)
    np.testing.assert_allclose(cache.v.numpy()[..., :45, :],
                               np.asarray(ref_cache.v)[..., :45, :], atol=ATOL, rtol=0)
    assert int(cache.length[0]) == int(ref_cache.length[0]) == 45


def test_one_shot_prefill_matches_jax_chunked_prefill(jmodel, model):
    """The JAX package chunks long prompts, and so does the port
    (`decoder.prefill_chunked`): both chunked prefills give the same logits
    and cache, and over a dense float cache so does the port's one-pass
    prefill."""
    jcfg = jmodel.dec_cfg
    embeds, length = _prefill_inputs(jmodel, 384, 370, seed=5)
    jcache = jdec.KVCache.create(jcfg, 1, 384, dtype=jnp.float32)
    ref_logits, ref_cache = jdec.prefill_chunked(
        jmodel.dec_params, jcfg, jnp.asarray(embeds), jcache, jnp.asarray(length),
        chunk=128)
    for chunked in (True, False):
        cache = decoder.KVCache.create(model.dec_cfg, 1, 384, dtype=torch.float32)
        prefill = (lambda *a: decoder.prefill_chunked(*a, chunk=128)) if chunked else \
            decoder.prefill
        logits, cache = prefill(model.dec_params, model.dec_cfg, torch.from_numpy(embeds),
                                cache, torch.from_numpy(length))
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=ATOL, rtol=0)
        np.testing.assert_allclose(cache.k.numpy()[..., :370, :],
                                   np.asarray(ref_cache.k)[..., :370, :], atol=ATOL, rtol=0)
        np.testing.assert_allclose(cache.v.numpy()[..., :370, :],
                                   np.asarray(ref_cache.v)[..., :370, :], atol=ATOL, rtol=0)


@pytest.mark.parametrize("sequential_pages", [True, False])
def test_decode_step_paged_matches_jax(jmodel, model, sequential_pages):
    jcfg = jmodel.dec_cfg
    embeds, length = _prefill_inputs(jmodel, 32, 29, seed=7)
    jcache = jdec.KVCache.create(jcfg, 1, 32, dtype=jnp.float32)
    _, jcache = jdec.prefill(jmodel.dec_params, jcfg, jnp.asarray(embeds), jcache,
                             jnp.asarray(length))
    jpaged = j_from_contiguous(jcache, 5, 5, page_size=8)
    cache = decoder.KVCache.create(model.dec_cfg, 1, 32, dtype=torch.float32)
    _, cache = decoder.prefill(model.dec_params, model.dec_cfg, torch.from_numpy(embeds),
                               cache, torch.from_numpy(length))
    paged = paged_kv.from_contiguous(cache, 5, 5, page_size=8)
    np.testing.assert_array_equal(paged.page_table.numpy(), np.asarray(jpaged.page_table))
    for tok in (17, 300):
        ref_logits, jpaged = j_decode_step_paged(
            jmodel.dec_params, jcfg, jnp.asarray([tok], jnp.int32), jpaged)
        logits, paged = paged_kv.decode_step_paged(
            model.dec_params, model.dec_cfg, torch.tensor([tok]), paged,
            sequential_pages=sequential_pages)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=ATOL, rtol=0)
    np.testing.assert_allclose(paged.k_pages.numpy(), np.asarray(jpaged.k_pages),
                               atol=ATOL, rtol=0)
    assert int(paged.length[0]) == int(jpaged.length[0]) == 31


@pytest.mark.parametrize("valid,max_new", [(37, 12), (16, 20)])
def test_generate_paged_token_exact(jmodel, model, valid, max_new):
    embeds, length = _prefill_inputs(jmodel, 40, valid, seed=valid)
    ref_toks, ref_count = generate_paged_fetch(
        jmodel.dec_params, jmodel.dec_cfg, jnp.asarray(embeds), jnp.asarray(length),
        jax.random.key(2), max_new_tokens=max_new, temperature=0.0, page_size=16)
    toks, count = generate_paged(
        model.dec_params, model.dec_cfg, torch.from_numpy(embeds), torch.from_numpy(length),
        max_new_tokens=max_new, temperature=0.0, page_size=16)
    np.testing.assert_array_equal(toks, np.asarray(ref_toks))
    np.testing.assert_array_equal(count, np.asarray(ref_count))


@pytest.mark.parametrize("prompt", [
    "<|im_start|>user\n<image>\nDescribe the scene.<|im_end|>\n<|im_start|>assistant\n",
    "no image here, just text",
])
def test_longva_generate_with_image_embedding_token_exact(jmodel, model, prompt):
    img = _rand(11, 10, jmodel.dec_cfg.hidden_size, scale=0.5)
    images = [jnp.asarray(img)] if "<image>" in prompt else None
    j_embeds, j_len = jmodel.splice_prompt(prompt, images)
    embeds, n = model.splice_prompt(prompt, None if images is None else
                                    [torch.from_numpy(img)])
    assert n == j_len and embeds.shape == j_embeds.shape
    np.testing.assert_allclose(embeds.numpy(), np.asarray(j_embeds), atol=0, rtol=0)
    ref_toks, _ = generate_paged_fetch(
        jmodel.dec_params, jmodel.dec_cfg, j_embeds, jnp.asarray([j_len], jnp.int32),
        jax.random.key(0), max_new_tokens=10, temperature=0.0,
        eos_ids=tuple(jmodel.tokenizer.eos_ids))
    toks, _ = generate_paged(model.dec_params, model.dec_cfg, embeds,
                             torch.tensor([n], dtype=torch.int32), max_new_tokens=10,
                             eos_ids=tuple(model.tokenizer.eos_ids))
    np.testing.assert_array_equal(toks, np.asarray(ref_toks))
    ref_text = jmodel.generate_with_image_embedding(prompt, images, max_new_tokens=10)
    text = model.generate_with_image_embedding(
        prompt, None if images is None else [torch.from_numpy(img)], max_new_tokens=10)
    assert text == ref_text


def test_embed_text_matches_jax(jmodel, model):
    ref = jmodel.embed_text("What is on the table?")
    out = model.embed_text("What is on the table?")
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("pooling", ["cls", "mean"])
def test_text_embedder_matches_jax(pooling):
    jcfg = dataclasses.replace(jconfig.BertConfig.tiny(), pooling=pooling)
    jm = jemb.TextEmbedder.init_random(jax.random.key(4), jcfg)
    m = embedder.TextEmbedder(convert.to_torch(_np(jm.params)),
                              _cfg(jcfg, config.BertConfig), ByteTokenizer(),
                              max_length=jm.max_length)
    texts = ["hello world", "", "a longer sentence with more tokens than sixteen"]
    ref = jm.embed(texts)
    out = m.embed(texts)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
