"""The yardstick's FLOP and byte counts against hand counts at two shapes."""

import pytest

from portbench import counts, manifest
from portbench.tests.conftest import ROOT, tiny


def _full():
    return manifest.config(manifest.load(ROOT), "longva7b-int8", ROOT)


def test_linear_params_of_qwen2_7b():
    # q 3584x3584, k and v 3584x512, o 3584x3584, gate / up 3584x18944,
    # down 18944x3584: 233,046,016 a layer; 28 layers; head 3584x152064.
    assert counts.linear_params(_full(), head=False) == 28 * 233_046_016
    assert counts.linear_params(_full()) == 28 * 233_046_016 + 3584 * 152_064


def test_weight_bytes_by_storage():
    assert counts.weight_bytes(256, 512, 16) == 2 * 256 * 512
    assert counts.weight_bytes(256, 512, 8) == 256 * 512 + 4 * 512
    assert counts.weight_bytes(256, 512, 4) == 256 * 512 // 2 + 4 * 512 * 2


@pytest.mark.parametrize("which", ["tiny", "full"])
def test_decode_step_by_hand(which):
    cfg = tiny("stream")[0] if which == "tiny" else _full()
    d, f, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    hq, hkv, layers = cfg["num_attention_heads"], cfg["num_key_value_heads"], \
        cfg["num_hidden_layers"]
    dh = d // hq
    ctx = 1000
    lin = [(d, hq * dh), (d, hkv * dh), (d, hkv * dh), (hq * dh, d), (d, f), (d, f), (f, d)]
    params = layers * sum(i * o for i, o in lin) + d * v
    attn = layers * hq * 4 * dh * ctx                     # QK^T and PV over ctx keys
    flops, nbytes = counts.decode_step(cfg, 8, False, ctx)
    assert flops == 2 * params + attn
    wbytes = layers * sum(i * o + 4 * o for i, o in lin) + (d * v + 4 * v)
    bias = layers * 2 * (hq * dh + 2 * hkv * dh)
    acts = layers * 2 * ((d + hq * dh + d + f) + sum(o for _, o in lin)) + 2 * d + 4 * v
    kv = ctx * layers * hkv * 2 * (2 * dh)
    assert nbytes == wbytes + bias + acts + kv + 2 * d


@pytest.mark.parametrize("length", [1, 23_441])
def test_prefill_attention_by_hand(length):
    cfg = _full()
    pairs = length * (length + 1) // 2
    assert counts.attention_flops(cfg, length, 0) == 28 * 28 * 4 * 128 * pairs
    # A decode step after a prompt: one query against length + 1 keys.
    assert counts.attention_flops(cfg, 1, length) == 28 * 28 * 4 * 128 * (length + 1)


@pytest.mark.parametrize("which", ["tiny", "full"])
def test_vit_batch_by_hand(which):
    cfg = tiny("stream")[0] if which == "tiny" else _full()
    vc = cfg["vision_config"]
    dv, fv = vc["hidden_size"], vc["intermediate_size"]
    p = (vc["image_size"] // vc["patch_size"]) ** 2
    n, d = p + 1, cfg["hidden_size"]
    blocks = vc["num_hidden_layers"] - 1
    per = (2 * p * 3 * vc["patch_size"] ** 2 * dv
           + blocks * (2 * n * (4 * dv * dv + 2 * dv * fv) + 4 * n * n * dv)
           + 2 * p * (dv * d + d * d))
    flops, _ = counts.vit_batch(cfg, 40)
    assert flops == 40 * per


def test_least_time_takes_the_larger_bound():
    assert counts.least_time(989e12, 0) == pytest.approx(1.0)
    assert counts.least_time(0, 3.35e12) == pytest.approx(1.0)
    assert counts.least_time(989e12, 6.7e12) == pytest.approx(2.0)
