"""A run with the timed path broken underneath comes out not correct.

Each case drives the rest of a run (the tiny CPU geometry: the chip check
skipped, every kernel's plain twin) with one fault planted in the program
and sees `correct` turn false; the clean run beside them is correct. The
faults a one-chip serving cell can have: a decode step that returns its
state unchanged, half of a batch left out (the ViT's, the rest repeated
in its place), a served token altered where it is produced. The exchange
between chips does not exist on one chip.
"""

import numpy as np
import pytest


def test_clean_runs_are_correct(run_tiny):
    for kind, bits in (("stream", 8), ("qa", 8), ("qa", 4)):
        out = run_tiny(kind, bits)
        assert out["correct"], (kind, bits, out["checks"])


def _altered_token(monkeypatch):
    from streamchat_tpu_torch.models import longva

    orig = longva.generate_paged

    def faulty(*a, **kw):
        toks, count = orig(*a, **kw)
        toks = toks.copy()
        toks[0, 1] = (toks[0, 1] + 101) % 256
        return toks, count

    monkeypatch.setattr(longva, "generate_paged", faulty)


def _state_unchanged(monkeypatch):
    from streamchat_tpu_torch.models import generate_paged as gp

    for name in ("decode_step_paged", "decode_step_paged_int8"):
        orig = getattr(gp, name)
        first = {}

        def stuck(params, cfg, tok, cache, *a, _orig=orig, _first=first, **kw):
            logits, rest = _orig(params, cfg, tok, cache, *a, **kw)
            key = id(cache)
            if key not in _first:
                _first.clear()
                _first[key] = logits.clone()
            return _first[key].clone(), rest

        monkeypatch.setattr(gp, name, stuck)


def _half_batch(monkeypatch):
    from streamchat_tpu_torch.models.longva import LongVA

    orig = LongVA.encode_images

    def half(self, pixels):
        n = pixels.shape[0]
        kept = orig(self, pixels[: (n + 1) // 2])
        return kept[np.arange(n) % kept.shape[0]]

    monkeypatch.setattr(LongVA, "encode_images", half)


@pytest.mark.parametrize("fault", [_altered_token, _state_unchanged, _half_batch],
                         ids=["altered_token", "state_unchanged", "half_batch"])
@pytest.mark.parametrize("kind", ["stream", "qa"])
def test_planted_fault_is_not_correct(run_tiny, monkeypatch, fault, kind):
    fault(monkeypatch)
    out = run_tiny(kind)
    assert not out["correct"], out["checks"]
