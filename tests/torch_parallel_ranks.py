"""Rank functions of the port's parallel CPU tests (`test_torch_parallel.py`,
`test_torch_ring_ulysses.py`).

No jax here: the spawn start method re-imports a rank function's module in
every child. `spawn` runs one function in `world` processes over one gloo
group (a FileStore under the test's tmp_path, so parallel test workers
never share a port; one torch thread a rank; a timeout on every
collective) and returns what each rank returned. Each rank function runs
every case of its test module, so one spawn serves many small tests.
"""

from __future__ import annotations

import copy
import dataclasses
import datetime
import json
import os

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from streamchat_tpu_torch.config import MemoryConfig, PipelineConfig, SamplingConfig
from streamchat_tpu_torch.memory import bank as bank_mod
from streamchat_tpu_torch.memory.bank import MemoryBank
from streamchat_tpu_torch.models.embedder import TextEmbedder
from streamchat_tpu_torch.models import decoder
from streamchat_tpu_torch.models.longva import LongVA
from streamchat_tpu_torch.models.textlm import TextLM
from streamchat_tpu_torch.models.tokenizer import ByteTokenizer
from streamchat_tpu_torch.ops import ring_attention as ring
from streamchat_tpu_torch.ops import ulysses
from streamchat_tpu_torch.parallel import make_mesh, mesh as mesh_mod
from streamchat_tpu_torch.parallel.multihost import host_shard
from streamchat_tpu_torch.pipeline import runner
from streamchat_tpu_torch.video.reader import SyntheticVideoReader

TIMEOUT_S = 120


def spawn(fn, world: int, tmp, *args) -> list:
    """fn(rank, world, *args) in `world` gloo ranks -> [each rank's result]."""
    tmp = str(tmp)
    mp.spawn(_entry, args=(fn, world, tmp, args), nprocs=world, join=True)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _entry(rank, fn, world, tmp, args):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        torch.save(fn(rank, world, *args), os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _pairs():
    """This rank's tp-2 group: ranks (0, 1) or (2, 3); every rank makes both."""
    groups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    return groups[dist.get_rank() // 2]


# ---------------------------------------------------------------------------
# Tensor parallelism
# ---------------------------------------------------------------------------


def _longva(inp) -> LongVA:
    return LongVA(vit_params=copy.deepcopy(inp["vit"]), proj_params=copy.deepcopy(inp["proj"]),
                  dec_params=copy.deepcopy(inp["dec"]), vit_cfg=inp["vit_cfg"],
                  dec_cfg=inp["dec_cfg"], tokenizer=ByteTokenizer(),
                  generator=torch.Generator().manual_seed(0))


def _generations(model: LongVA, inp) -> dict:
    """The LongVA calls the tests hold: greedy answer, batched captions,
    and the teacher-forced NLL."""
    feats = inp["feats"]
    out = {"answer": model.generate_with_image_embedding(
        inp["prompt"], [feats], max_new_tokens=4, temperature=0.0),
        "batch": model.generate_with_image_embedding_batch(
            inp["prompts"], inp["batch_feats"], max_new_tokens=6, temperature=0.0)}
    out["nll"] = model.score_with_image_embedding(inp["prompt"], "a red cup", [feats])
    return out


def _variants(model_fn, mesh, inp) -> dict:
    """int4, kv_int8, spec 4 and H2O under a budget: greedy answers."""
    out = {}
    for name, setup in (("int4", lambda m: m.quantize(bits=4)),
                        ("kv_int8", lambda m: setattr(m, "kv_int8", True)),
                        ("spec4", lambda m: setattr(m, "spec_tokens", 4)),
                        ("h2o", lambda m: setattr(m, "kv_budget_tokens", 256))):
        m = model_fn()
        setup(m)
        if mesh is not None:
            m.shard(mesh)
        feats = inp["long_feats"] if name == "h2o" else inp["feats"]
        out[name] = m.generate_with_image_embedding(inp["prompt"], [feats], max_new_tokens=8,
                                                    temperature=0.0)
    return out


def _judge(inp, mesh) -> list:
    lm = TextLM(copy.deepcopy(inp["dec"]), inp["dec_cfg"], ByteTokenizer(),
                torch.Generator().manual_seed(0))
    if mesh is not None:
        lm.shard(mesh)
    return lm.generate_batch(inp["judge_prompts"], max_new_tokens=6)


def _prefill(inp, mesh):
    params, cfg = copy.deepcopy(inp["dec"]), inp["dec_cfg"]
    if mesh is not None:
        from streamchat_tpu_torch.parallel.sharding import shard_decoder

        params, cfg = shard_decoder(params, cfg, mesh.model)
    embeds, lengths = inp["prefill_embeds"], inp["prefill_lengths"]
    cache = decoder.KVCache.create(cfg, embeds.shape[0], embeds.shape[1], dtype=torch.float32)
    return decoder.prefill(params, cfg, embeds, cache, lengths)[0]


def _short_config(args):
    cfg = runner_config(args)
    return cfg.replace(sampling=dataclasses.replace(
        cfg.sampling, max_answer_tokens=4, max_answer_tokens_unimodal=4, max_caption_tokens=4,
        max_summary_tokens=4, caption_temperature=0.0))


runner_config = runner.config_from_args


def _tiny_pipeline(models, cfg) -> runner.StreamChatPipeline:
    """The runner's pipeline on the JAX package's tiny weights (f32)."""
    def emb(e):
        return TextEmbedder(copy.deepcopy(e["params"]), e["cfg"], ByteTokenizer(),
                            max_length=e["max_length"])

    model = LongVA(vit_params=copy.deepcopy(models["vit"]),
                   proj_params=copy.deepcopy(models["proj"]),
                   dec_params=copy.deepcopy(models["dec"]), vit_cfg=models["vit_cfg"],
                   dec_cfg=models["dec_cfg"], tokenizer=ByteTokenizer(),
                   generator=torch.Generator().manual_seed(0))
    return runner.StreamChatPipeline(model, emb(models["tree"]), emb(models["bank"]), cfg)


def _recording_open(sink):
    def recording(path, mode="r", *a, **kw):
        if any(c in mode for c in "wax"):
            sink.add(os.path.abspath(path))
        return open(path, mode, *a, **kw)
    return recording


def _runner(tmp, rank, inp) -> dict:
    """The CLI (int8, the default) at the tiny geometry's 2 kv heads over
    the annotation files of `inp["runner"]`. Under the multi-modal memory:
    on ranks 0 and 2 unsharded with --num_chunks 2 --chunk_idx rank // 2
    (each rank its own output paths), then on every rank with --shard (the
    2 x 2 mesh, shared output paths, as under torchrun). Then the uni-modal
    run with --shard -> the saved records of each run this rank wrote, the
    bank files this rank wrote in the multi-modal sharded run, and the files
    it opened for writing in the uni-modal one."""
    spec = inp["runner"]
    mm = spec["multimodal"]

    def cli(run, out, *flags):
        return (["--video_dir", spec["videos"], "--annotations", run["annotations"],
                 "--device", "cpu", "--geometry", "tiny", "--memory_basic_dir", out,
                 "--save_file", out + ".json"] + run["cli"] + list(flags))

    def records(out):
        with open(out + ".json") as f:
            return json.load(f)

    written, mm_written = set(), set()
    runner.config_from_args = _short_config
    runner.open_video = lambda path: SyntheticVideoReader(total_frames=150, frame_rate=30,
                                                          height=56, width=56)
    build = runner.build_pipeline
    runner.build_pipeline = lambda cfg, **kw: _tiny_pipeline(spec["models"], cfg)
    saved = {}
    try:
        if rank % 2 == 0:
            out = os.path.join(tmp, f"mm_unsharded{rank}")
            runner.main(cli(mm, out, "--num_chunks", "2", "--chunk_idx", str(rank // 2)))
            saved["mm_unsharded"] = records(out)
        for run, out, sink, key in ((mm, "mm_sharded", mm_written, "mm_sharded"),
                                    (spec, "sharded", written, "sharded")):
            out = os.path.join(tmp, out)
            runner.open = bank_mod.open = _recording_open(sink)
            try:
                runner.main(cli(run, out, "--shard"))
            finally:
                del runner.open, bank_mod.open
            if rank == 0:
                saved[key] = records(out)
    finally:
        runner.build_pipeline = build
        runner.config_from_args = runner_config
    saved["written"] = sorted(os.path.relpath(p, tmp) for p in written)
    saved["mm_banks"] = sorted(os.path.basename(p) for p in mm_written
                               if os.path.basename(p).startswith("memory_"))
    return saved


def _members(group, world) -> list:
    """The world ranks of `group`, by an all_reduce of one-hot rows."""
    t = torch.zeros(world)
    t[dist.get_rank()] = 1
    dist.all_reduce(t, group=group)
    return [int(r) for r in torch.nonzero(t).flatten()]


# make_mesh(dp, tp) argument cases, held to JAX make_mesh over 4 devices.
MESH_ARGS = [(None, None), (2, None), (None, 2), (4, None), (None, 4), (1, 4), (4, 1),
             (2, 2), (3, None), (None, 3), (3, 2), (4, 4)]


def _grid_cases(rank, world, inp) -> dict:
    """The 2 x 2 mesh at 2 kv heads: coordinates, group members, the
    make_mesh argument rules, host_shard's data split, LongVA / TextLM
    sharded on it, USP over its groups."""
    grid = make_mesh(kv_heads=2)
    out = {"grid": dict(coords=grid.coords, shape=grid.shape,
                        model=_members(grid.model.group, world),
                        data=_members(grid.data_group, world)),
           "host_shard": {"tp4": host_shard(list(range(10)), mesh=make_mesh(tp=4)),
                          "grid": host_shard(list(range(10)), mesh=grid),
                          "ids": host_shard(list(range(10)), rank % 2, 2)}}
    try:
        out["host_shard"]["no_mesh"] = host_shard(list(range(10)))
    except ValueError as e:
        out["host_shard"]["no_mesh"] = str(e)
    shapes = {}
    for args in MESH_ARGS:
        try:
            shapes[args] = make_mesh(*args).shape
        except ValueError as e:
            shapes[args] = str(e)
    out["mesh_args"] = shapes
    m22 = make_mesh(2, 2)
    out["prefill22"] = _prefill(inp, m22)
    out["generate22"] = _generations(_longva(inp).shard(m22), inp)
    out["judge22"] = _judge(inp, m22)
    q, k, v = inp["usp"]
    out["usp"] = ulysses.usp_attention(*(ring.sequence_shard(t, rank, world)
                                         for t in (q, k, v)), grid, causal=True)
    return out


def _online(mesh, bank_path) -> dict:
    """process_video_online at tiny geometry in f32, the decoder sharded
    over `mesh` (None: whole) -> its answers and, when sharded, the
    (thread, label) of every all_reduce in call order."""
    cfg = PipelineConfig(
        memory=MemoryConfig(chunk_size=4, num_clusters=2, interval=3, short_window=4,
                            remember_window=2),
        sampling=SamplingConfig(temperature=0.0, caption_temperature=0.0, max_answer_tokens=4,
                                max_caption_tokens=4, max_summary_tokens=4))
    pipe = runner.build_pipeline(cfg, device="cpu", geometry="tiny", dtype=torch.float32)
    if mesh is not None:
        pipe.model.shard(mesh)
    reader = SyntheticVideoReader(total_frames=150, frame_rate=30, height=56, width=56)
    bank = MemoryBank(bank_path, pipe.bank_embed)
    breakpoints = [{"question": "What do I see?", "answer": "a", "time": 2},
                   {"question": "What changed?", "answer": "b", "time": 5}]
    with mesh_mod.record_collectives() as trace:
        results = pipe.process_video_online(reader, breakpoints, bank, "User")
    roles = {}
    for name, _ in trace:
        roles.setdefault(name, "main" if name == "MainThread" else "worker")
    return {"answers": [r["predict"] for r in results],
            "trace": [(roles[name], label) for name, label in trace]}


def tp_cases(rank: int, world: int, inputs_path: str, tmp: str) -> dict:
    """Every tensor-parallel case in this rank (world 4: tp 4 over the
    world, tp 2 over this rank's pair, the 2 x 2 mesh)."""
    inp = torch.load(inputs_path, weights_only=False)
    pair = make_mesh(group=_pairs())
    world_mesh = make_mesh(kv_heads=inp["dec_cfg"].num_kv_heads)
    out = {"mesh": (pair.model.rank, pair.model.size, world_mesh.model.rank,
                    world_mesh.model.size),
           "prefill": {tp: _prefill(inp, m) for tp, m in ((1, None), (2, pair), (4, world_mesh))}}
    out["generate"] = {1: _generations(_longva(inp), inp)}
    for tp, m in ((2, pair), (4, world_mesh)):
        out["generate"][tp] = _generations(_longva(inp).shard(m), inp)
    out["variants"] = {1: _variants(lambda: _longva(inp), None, inp),
                       2: _variants(lambda: _longva(inp), pair, inp)}
    out["judge"] = {1: _judge(inp, None), 2: _judge(inp, pair)}
    try:
        m = _longva(inp).quantize(bits=4)
        m.shard(world_mesh)
    except ValueError as e:
        out["int4_tp4_error"] = str(e)
    out.update(_grid_cases(rank, world, inp))
    out["runner"] = _runner(tmp, rank, inp)
    out["online"] = {tp: _online(m, os.path.join(tmp, f"bank{rank}_{tp}.json"))
                     for tp, m in ((1, None), (2, pair))}
    return out


# ---------------------------------------------------------------------------
# Sequence parallelism
# ---------------------------------------------------------------------------


def sp_cases(rank: int, world: int, inputs_path: str) -> dict:
    """Every sequence-parallel case in this rank: each op at n = 2 (this
    rank's pair) and n = 4 (the world), USP on the 2 x 2 mesh. Each rank
    cuts its shard of the whole q / k / v it is given -> {case: output shard}."""
    inp = torch.load(inputs_path, weights_only=False)
    groups = {2: _pairs(), 4: None}
    out = {}
    for n, g in groups.items():
        r = dist.get_rank(g)
        for case, (q, k, v) in inp["cases"].items():
            for causal in (True, False):
                key = (case, n, causal)
                sq, sk, sv = (ring.sequence_shard(t, r, n) for t in (q, k, v))
                out[("ring",) + key] = ring.ring_attention(sq, sk, sv, g, causal=causal)
                zq, zk, zv = (ring.sequence_shard(t, r, n, "zigzag") for t in (q, k, v))
                out[("zigzag",) + key] = ring.zigzag_ring_attention(zq, zk, zv, g,
                                                                    causal=causal)
                tq, tk, tv = (ring.sequence_shard(t, r, n, "stripe") for t in (q, k, v))
                out[("stripe",) + key] = ring.stripe_ring_attention(tq, tk, tv, g,
                                                                    causal=causal)
                if q.shape[1] % n == 0 and k.shape[1] % n == 0:
                    out[("ulysses",) + key] = ulysses.ulysses_attention(sq, sk, sv, g,
                                                                       causal=causal)
        q, k, v = inp["varlen"]
        out[("varlen", n)] = ring.ring_attention(
            *(ring.sequence_shard(t, r, n) for t in (q, k, v)), g, causal=True,
            kv_length=inp["lengths"])
        q, k, v = inp["cases"]["mha"]
        out[("scaled", n)] = ring.ring_attention(
            *(ring.sequence_shard(t, r, n) for t in (q, k, v)), g, causal=True, sm_scale=0.3)
    grid = make_mesh(2, 2)
    for causal in (True, False):
        q, k, v = inp["cases"]["mha"]
        out[("usp", causal)] = ulysses.usp_attention(
            *(ring.sequence_shard(t, rank, world) for t in (q, k, v)), grid, causal=causal)
    return out
