"""Shared pieces of the portbench CPU tests: the repo root on sys.path and
a tiny CPU run of a cell (the port's unit-test geometry, every kernel's
plain twin)."""

import copy
import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Limits for the tiny CPU geometry, from its own readings over six seeds
# (see test_portbench_faults.py): the program reads under 0.006 on the ViT,
# 0 to 0.003 on the memory gap, 0 to 0.078 on the answer gap (int4 weights
# and int8 KV against a reference that makes the short memory from the
# frames) and 0 on the embeddings; the controls read 0.076 and more on the
# ViT, 1.1 and more on the memory gap, 0.25 and more on the answer gap,
# 0.0039 and more on the query and 0.00018 and more on the search scores.
TINY_LIMITS = {"vit_rel_err": 0.03, "memory_logit_gap": 0.06, "answer_logit_gap": 0.15,
               "query_rel_err": 1e-4, "search_score_gap": 1e-4}


def tiny(kind: str, bits: int = 8):
    """(config, traffic) of the tiny CPU geometry."""
    with open(os.path.join(HERE, "tiny_config.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(HERE, f"tiny_{kind}.json")) as f:
        spec = json.load(f)
    cfg["serving"] = dict(cfg["serving"], weight_bits=bits, kv_int8=bits == 4)
    cfg["control"] = {"decoder": [4, None] if bits == 8 else [4, 4], "vision": "fp8",
                      "embedder": "bf16"}
    cfg["limits"] = dict(TINY_LIMITS)
    return cfg, spec


@pytest.fixture
def run_tiny():
    """run_tiny(kind, bits=8, seed=..., trace=False, root=ROOT, control=False)
    -> the result object of a short CPU run of the tiny geometry."""
    import torch

    from portbench import run

    threads = torch.get_num_threads()

    def go(kind, bits=8, seed=98765432109, trace=False, root=ROOT, control=False,
           workload=None):
        cfg, spec = tiny(kind, bits)
        return run.run_cell(workload or f"longva7b-int8.{kind}", seed, 0.5, trace, "cpu",
                            root=root, control=control, config_override=copy.deepcopy(cfg),
                            spec_override=spec)

    yield go
    torch.set_num_threads(threads)
