"""Streaming pipeline and CLI (`streamchat_tpu/pipeline/runner.py`),
off-line and on-line.

Per video: reset the visual memory tree and open a dialogue memory bank;
per breakpoint segment: ingest -> dedup (when `VideoConfig.dedup_threshold`
> 0) -> memory update (captions + tree) -> dialogue retrieval -> answer ->
result append -> memory write-back. `process_video` (off-line, the v0.3
benchmark path) updates memory segment by segment and resets the short
memory at each breakpoint; its phase totals are host wall-clock windows
that end in a device synchronize, so on a GPU they are true
device-inclusive times; the "caption" phase times each caption call, a
batched one (`SamplingConfig.caption_batch` > 1) included.
`process_video_online` (`--mode on_line`) pushes each segment into a
`StreamingSession`, whose worker thread captions chunks while the next
segment is ingested, and keeps the short memory as a FIFO across the
stream; it times no phases, as in the JAX package. Both answer through
`_answer`: the multi-modal answer with `--multi_modal_memory`, else the
uni-modal one (the CLI's default), and with `--ppl` the record also
carries the ground-truth answer's teacher-forced `nll` and `ppl`. The
off-line phase totals split the answer into `answer.retrieval`,
`answer.generate` and the multi-modal answer's `answer.embed_query_s`,
`answer.tree_search_s` and `answer.assemble_s`; the "qembed" phase embeds
the questions for tree search only when the multi-modal answer will use
them, so each phase name means the same in both modes.

`--int8` (the default) and `--int4` quantize the decoder after it is built,
as the JAX `main` does; `--bf16` keeps it bf16. `--spec_tokens N` turns on
speculative decoding (`--spec_ngram` drafting) on the model,
`--literal_kmeans` keeps every chunk's raw features in its tree node, and
`--save_tree_dir` pickles each video's tree state, as the JAX `main` does.
`--model_name`, `--embedding_model` and `--minilm_model` load HF
checkpoints (models/weights); a model whose path is unset is random at
`--geometry`. `--compress_rate` > 1 average-pools each frame's patch grid
before the off-line memory update (the on-line session, as the JAX
package's, does not pool). `--offload_chunks` parks each segment's raw
caption chunks in pinned host memory until its caption (as does a segment
over `MemoryConfig.offload_chunks_over` frames) and `--offload_residents`
parks the ViT, projector and both embedders there for each caption loop
(pipeline/memory_update.py, utils/offload.py); `last_offload_stats` holds
the run's chunk offload seconds and bytes. Both act in `process_video`
only: the on-line session never calls `update_memory`, as in the JAX
package. Not ported yet, raising NotImplementedError that names its
ROADMAP item: --shard.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import threading
import time
from typing import Optional

import numpy as np
import torch

from streamchat_tpu_torch.config import (
    BertConfig,
    DecoderConfig,
    MemoryConfig,
    ModelPaths,
    PipelineConfig,
    RetrievalConfig,
    SamplingConfig,
    VideoConfig,
    ViTConfig,
)
from streamchat_tpu_torch.video.reader import PrefetchReader, open_video
from streamchat_tpu_torch.memory.bank import MemoryBank
from streamchat_tpu_torch.memory.tree import VisualMemoryTree
from streamchat_tpu_torch.models.embedder import TextEmbedder
from streamchat_tpu_torch.models.longva import LongVA
from streamchat_tpu_torch.ops.kmeans import weighted_kmeans_feature
from streamchat_tpu_torch.pipeline import prompts
from streamchat_tpu_torch.pipeline.answer import (
    answer_question,
    answer_question_unimodal,
    make_captioner,
    make_summarizer,
)
from streamchat_tpu_torch.pipeline.ingest import dedup_segment, encode_segment, segment_indices
from streamchat_tpu_torch.pipeline.memory_update import offload_stats, update_memory
from streamchat_tpu_torch.pipeline.streaming import StreamingSession
from streamchat_tpu_torch.utils.offload import WeightOffloader
from streamchat_tpu_torch.utils.profiling import PhaseTimer


class StreamChatPipeline:
    """Wires models + memory + prompts into the per-video streaming loop."""

    def __init__(self, model: LongVA, tree_embedder: TextEmbedder,
                 bank_embedder: TextEmbedder, cfg: PipelineConfig):
        self.model = model
        self.tree_embedder = tree_embedder
        self.bank_embedder = bank_embedder
        if cfg.video.image_size != model.vit_cfg.image_size:
            cfg = cfg.replace(video=dataclasses.replace(
                cfg.video, image_size=model.vit_cfg.image_size))
        self.cfg = cfg
        self._caption = make_captioner(model, cfg.sampling)
        self._summarize = make_summarizer(model, cfg.sampling)
        # The trees the caption loop leaves idle, parked in host memory
        # around it under offload_residents (utils/offload.py).
        self.residents = None
        if cfg.memory.offload_residents:
            self.residents = (WeightOffloader()
                              .register("vit", model, "vit_params")
                              .register("projector", model, "proj_params")
                              .register("tree_embedder", tree_embedder, "params")
                              .register("bank_embedder", bank_embedder, "params"))
        self.generator = torch.Generator(device=model.device).manual_seed(cfg.seed)
        # Held around every draw from `generator` that the on-line session's
        # worker may make at the same time as the caller.
        self._generator_lock = threading.Lock()
        # False (--literal_kmeans) keeps every chunk's raw features in its
        # tree node (pipeline/memory_update.py).
        self.cluster_full_chunks = True
        self._q_emb_cache = {}
        self.last_tree = None
        self.last_phase_totals = {}
        self.last_phase_counts = {}
        self.last_offload_stats = offload_stats()

    def new_tree(self) -> VisualMemoryTree:
        def merge(combined, k):
            with self._generator_lock:
                return weighted_kmeans_feature(combined, k, generator=self.generator)[0]

        return VisualMemoryTree(
            num_clusters=self.cfg.memory.num_clusters, interval=self.cfg.memory.interval,
            embed_fn=lambda texts: self.tree_embedder.embed(texts),
            summarize_fn=self._summarize, merge_fn=merge)

    def bank_embed(self, texts) -> np.ndarray:
        """Dialogue-bank embedder: texts -> [N, E] float32 numpy rows."""
        return self.bank_embedder.embed(list(texts)).float().cpu().numpy()

    def embed_query(self, question: str):
        emb = self._q_emb_cache.get(question)
        if emb is None:
            emb = self.tree_embedder.embed([question])[0]
            if len(self._q_emb_cache) >= 4096:
                self._q_emb_cache.pop(next(iter(self._q_emb_cache)))
            self._q_emb_cache[question] = emb
        return emb

    def _prewarm_question_embeddings(self, breakpoints, bank: MemoryBank):
        """Batch-embed a video's questions up front: for tree search when
        the multi-modal answer will search by them, and for the dialogue bank."""
        questions = [q["question"] for q in breakpoints if q.get("question")]
        missing = [t for t in dict.fromkeys(questions) if t not in self._q_emb_cache]
        if missing and self.cfg.multi_modal_memory:
            for t, r in zip(missing, self.tree_embedder.embed(missing)):
                if len(self._q_emb_cache) >= 4096:
                    self._q_emb_cache.pop(next(iter(self._q_emb_cache)))
                self._q_emb_cache[t] = r
        bank.precompute_embeddings(questions)

    def process_video(self, reader, breakpoints, bank: MemoryBank, user_name: str,
                      save_file: Optional[str] = None):
        """Stream one video through its breakpoints. Returns result dicts."""
        sync = torch.cuda.synchronize if self.model.device.type == "cuda" else None
        timer = PhaseTimer(synchronize=sync)
        orig_summarize = self._summarize

        def timed_summarize(captions):
            with timer.phase("summarize"):
                return orig_summarize(captions)

        self._summarize = timed_summarize
        tree = self.new_tree()
        self._summarize = orig_summarize

        def timed_caption(chunk):
            with timer.phase("caption"):
                return self._caption(chunk)

        def timed_batch(chunks):
            with timer.phase("caption"):
                return self._caption.batch(chunks)

        timed_caption.batch = timed_batch
        timed_caption.batch_size = self._caption.batch_size

        results = []
        with timer.phase("store"):
            memory_index = bank.enter_name(user_name)
        with timer.phase("qembed"):
            self._prewarm_question_embeddings(breakpoints, bank)
        frame_line = [0] + [int(q["time"]) for q in breakpoints]
        segments = list(zip(breakpoints, frame_line[:-1], frame_line[1:]))
        reader = PrefetchReader(reader)
        short_memory = None
        stats = offload_stats()
        try:
            for i, (q, start_s, end_s) in enumerate(segments):
                with timer.phase("ingest"):
                    features = encode_segment(self.model, reader, start_s, end_s,
                                              self.cfg.video, self.cfg.memory.chunk_size)
                if i + 1 < len(segments):
                    _, ns, ne = segments[i + 1]
                    reader.schedule(segment_indices(reader, ns, ne, self.cfg.video,
                                                    self.cfg.memory.chunk_size))
                with timer.phase("dedup"):
                    features = dedup_segment(features, self.cfg.video.dedup_threshold)
                if features.shape[0] > 0:
                    # The stack passes in a box that update_memory empties,
                    # so no frame here pins it while the captions run.
                    box, features = [features], None
                    with timer.phase("memory_update"):
                        tree, short_memory = update_memory(
                            box, tree, timed_caption, self.cfg.memory,
                            self.generator, self.cluster_full_chunks,
                            residents=self.residents, stats=stats)
                if short_memory is None:
                    continue    # an empty first segment has nothing to answer from
                with timer.phase("history"):
                    history_prompt = self._history_prompt(memory_index, q["question"])
                with timer.phase("answer"):
                    res = self._answer(q, short_memory, tree, history_prompt)
                timer.totals["answer.retrieval"] += res.process_time
                timer.totals["answer.generate"] += res.generate_time
                timer.counts["answer.retrieval"] += 1
                timer.counts["answer.generate"] += 1
                for k, v in (res.timings or {}).items():
                    timer.totals[f"answer.{k}"] += v
                    timer.counts[f"answer.{k}"] += 1
                with timer.phase("store"):
                    memory_index = self._record_and_store(
                        results, q, end_s, res, bank, user_name, save_file)
        finally:
            reader.stop()
        self.last_tree = tree
        self.last_phase_totals = {k: round(v, 3) for k, v in timer.summary().items()}
        self.last_phase_counts = dict(timer.counts)
        self.last_offload_stats = stats
        return results

    def process_video_online(self, reader, breakpoints, bank: MemoryBank, user_name: str,
                             save_file: Optional[str] = None):
        """on_line mode: memory updates run in a `StreamingSession` worker
        while the next segment is ingested; the short memory is a FIFO
        across the stream. As in the JAX package the frames are read without
        a PrefetchReader, and a breakpoint is skipped only when no frame has
        arrived yet (after `sync()`, so a worker error still surfaces)."""
        session = StreamingSession(
            self.new_tree(), self._caption, self.cfg.memory, self.generator,
            self.cluster_full_chunks, generator_lock=self._generator_lock,
            device=self.model.device)
        memory_index = bank.enter_name(user_name)
        self._prewarm_question_embeddings(breakpoints, bank)
        results = []
        frame_line = [0] + [int(q["time"]) for q in breakpoints]
        try:
            for q, start_s, end_s in zip(breakpoints, frame_line[:-1], frame_line[1:]):
                features = encode_segment(self.model, reader, start_s, end_s, self.cfg.video,
                                          self.cfg.memory.chunk_size)
                features = dedup_segment(features, self.cfg.video.dedup_threshold)
                if features.shape[0] > 0:
                    session.push(features)
                session.flush()
                features = None
                history_prompt = self._history_prompt(memory_index, q["question"])
                if len(session.short_term) == 0:
                    session.sync()
                    continue

                def answer(short, tree, q=q, history=history_prompt):
                    return self._answer(q, short, tree, history)

                res = session.ask(answer)
                memory_index = self._record_and_store(
                    results, q, end_s, res, bank, user_name, save_file)
        finally:
            session.close()
        self.last_tree = session.tree
        self.last_phase_totals = {}
        self.last_phase_counts = {}
        return results

    def _answer(self, q, short_memory, tree, history_prompt):
        """The multi-modal or the uni-modal answer to breakpoint q, scoring
        its ground-truth answer under `ppl`."""
        ppl_target = q.get("answer") if self.cfg.ppl else None
        if self.cfg.multi_modal_memory:
            return answer_question(q["question"], self.model, self.embed_query, short_memory,
                                   tree, history_prompt, self.cfg.sampling, self.cfg.conv_mode,
                                   ppl_target=ppl_target)
        return answer_question_unimodal(q["question"], self.model, short_memory, tree,
                                        history_prompt, self.cfg.sampling, self.cfg.conv_mode,
                                        ppl_target=ppl_target)

    def _history_prompt(self, memory_index, question: str):
        if memory_index is None:
            return None
        date_docs, _ = memory_index.search_memory(question, self.cfg.retrieval.language)
        if not date_docs:
            return None
        related = "\n" + "\n".join(date_docs).strip() + "\n"
        return prompts.build_history_prompt(related, self.cfg.retrieval.language)

    def _record_and_store(self, results, q, end_s, res, bank, user_name, save_file):
        record = {"time": end_s, "question": q["question"], "label": q.get("answer"),
                  "predict": res.output, "class": q.get("class"),
                  "process_time": res.process_time}
        if res.nll is not None:
            record["nll"] = res.nll
            record["ppl"] = res.ppl
        results.append(record)
        if save_file:
            _append_result(save_file, record)
        bank.save_local_memory(user_name, q["question"], res.output)
        return bank.enter_name(user_name)


def _append_result(save_file: str, record: dict) -> None:
    """Read-append-rewrite, matching the reference sink."""
    data = []
    if os.path.exists(save_file):
        with open(save_file, "r", encoding="utf-8") as f:
            data = json.load(f)
    data.append(record)
    with open(save_file, "w", encoding="utf-8") as f:
        json.dump(data, f, ensure_ascii=False, indent=4)


def run_inference(pipeline: StreamChatPipeline, args) -> None:
    """Annotation loop over a StreamBench annotation file."""
    with open(args.annotations, "r", encoding="utf-8") as f:
        all_annotations = json.load(f)
    os.makedirs(args.memory_basic_dir, exist_ok=True)
    if not os.path.exists(args.save_file):
        with open(args.save_file, "w", encoding="utf-8") as f:
            json.dump([], f)
    for count, anno in enumerate(all_annotations):
        if count < args.start:
            continue
        if args.num_chunks > 1 and count % args.num_chunks != args.chunk_idx:
            continue
        bank = MemoryBank(os.path.join(args.memory_basic_dir, f"memory_{count}.json"),
                          pipeline.bank_embed, language=args.language,
                          top_k=args.memory_search_top_k)
        video_path = os.path.join(args.video_dir, anno["info"]["class_1"],
                                  anno["info"]["video_path"])
        if not os.path.exists(video_path):
            continue
        reader = open_video(video_path)
        process = (pipeline.process_video_online if args.mode == "on_line"
                   else pipeline.process_video)
        try:
            process(reader, anno["breakpoint"], bank, user_name="User",
                    save_file=args.save_file)
        finally:
            reader.close()
        if args.save_tree_dir:
            os.makedirs(args.save_tree_dir, exist_ok=True)
            with open(os.path.join(args.save_tree_dir, f"tree_{count}.pkl"), "wb") as f:
                pickle.dump(pipeline.last_tree.to_state(), f)


GEOMETRIES = ("tiny", "longva7b")


def build_pipeline(cfg: PipelineConfig, *, device, geometry: str,
                   dtype=torch.bfloat16, tokenizer=None) -> StreamChatPipeline:
    """The pipeline's three models on `device`. Each path set in `cfg.paths`
    is loaded from its HF checkpoint (models/weights): LongVA at `dtype`,
    mxbai-colbert (CLS pooling) and MiniLM (mean pooling) in f32, as in the
    JAX package; a path that fails to load raises. Each unset path is a
    random-weight model at `geometry`: the JAX package's tiny plumbing
    geometry, or full width ("longva7b": CLIP ViT-L/14-336, mlp2x_gelu to
    3584, Qwen2-7B, mxbai-colbert-large and MiniLM-L6). `tokenizer`, when
    given, serves every loaded model in place of its checkpoint's own
    (`ByteTokenizer()` where a checkpoint carries no tokenizer files or
    `transformers` is missing)."""
    if geometry == "tiny":
        dec_cfg = DecoderConfig.tiny()
        vit_cfg = ViTConfig.tiny(projection_dim=dec_cfg.hidden_size)
        tree_cfg = BertConfig.tiny()
        bank_cfg = dataclasses.replace(BertConfig.tiny(), pooling="mean")
    elif geometry == "longva7b":
        dec_cfg = DecoderConfig.qwen2_7b()
        vit_cfg = ViTConfig(projection_dim=dec_cfg.hidden_size)
        tree_cfg = BertConfig.mxbai_colbert_large()
        bank_cfg = BertConfig.minilm_l6()
    else:
        raise ValueError(f"geometry {geometry!r}: expected one of {GEOMETRIES}")
    paths = cfg.paths
    if paths.longva:
        model = LongVA.from_pretrained(paths.longva, dtype, device=device, tokenizer=tokenizer)
    else:
        model = LongVA.init_random(vit_cfg, dec_cfg, seed=cfg.seed, device=device,
                                   dtype=dtype)

    def embedder(path, pooling, random_cfg, seed):
        if path:
            return TextEmbedder.from_pretrained(path, pooling, device=device,
                                                tokenizer=tokenizer)
        return TextEmbedder.init_random(random_cfg, seed=seed, device=device)

    tree_emb = embedder(paths.colbert, "cls", tree_cfg, cfg.seed + 1)
    bank_emb = embedder(paths.minilm, "mean", bank_cfg, cfg.seed + 2)
    return StreamChatPipeline(model, tree_emb, bank_emb, cfg)


def parse_args(argv=None):
    """The reference flag surface (as `streamchat_tpu.pipeline.runner`)."""
    p = argparse.ArgumentParser(description="StreamChat on PyTorch/CUDA")
    p.add_argument("--video_dir", required=True)
    p.add_argument("--model_name", type=str, default=None)
    p.add_argument("--conv-mode", dest="conv_mode", type=str, default="qwen_1_5")
    p.add_argument("--mode", type=str, default="off_line")
    p.add_argument("--chunk_size", type=int, default=20)
    p.add_argument("--num_clusters", type=int, default=5)
    p.add_argument("--interval", type=int, default=10)
    p.add_argument("--short_window", type=int, default=20)
    p.add_argument("--remember_window", type=int, default=5)
    p.add_argument("--tau", type=float, default=5)
    p.add_argument("--compress_rate", type=int, default=1)
    p.add_argument("--num_chunks", type=int, default=1)
    p.add_argument("--chunk_idx", type=int, default=0)
    p.add_argument("--num_frames", type=int, default=4)
    p.add_argument("--num_beams", type=int, default=1)
    p.add_argument("--temperature", type=float, default=0.2)
    p.add_argument("--sample_rate", type=float, default=0.5)
    p.add_argument("--top_p", type=float, default=None)
    p.add_argument("--memory_basic_dir", type=str, required=True)
    p.add_argument("--save_file", type=str, required=True)
    p.add_argument("--annotations", type=str, required=True)
    p.add_argument("--language", type=str, default="en")
    p.add_argument("--memory_search_top_k", type=int, default=1)
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--embedding_model", type=str, default=None)
    p.add_argument("--minilm_model", type=str, default=None)
    p.add_argument("--ppl", action="store_true")
    p.add_argument("--multi_modal_memory", action="store_true")
    p.add_argument("--shard", action="store_true")
    p.add_argument("--int8", dest="int8", action="store_true", default=True)
    p.add_argument("--bf16", dest="int8", action="store_false")
    p.add_argument("--int4", action="store_true")
    p.add_argument("--save_tree_dir", type=str, default=None)
    p.add_argument("--offload_chunks", action="store_true",
                   help="park each segment's raw caption chunks in pinned host "
                        "memory until its caption runs (off-line mode only: the "
                        "on-line session never calls update_memory)")
    p.add_argument("--offload_residents", action="store_true",
                   help="park the ViT, projector and both embedders in pinned host "
                        "memory during each segment's caption loop (off-line mode "
                        "only)")
    p.add_argument("--literal_kmeans", action="store_true")
    p.add_argument("--spec_tokens", type=int, default=0)
    p.add_argument("--spec_ngram", type=int, default=3)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; a CPU run must be asked for (--device cpu)")
    p.add_argument("--geometry", choices=GEOMETRIES, default="longva7b",
                   help="geometry of the models whose checkpoint path is unset "
                        "(random weights); the CUDA kernels take only longva7b "
                        "shapes, tiny runs on the CPU")
    return p.parse_args(argv)


_NOT_PORTED = (
    ("shard", "--shard", "Multi-GPU"),
)


def config_from_args(args) -> PipelineConfig:
    for attr, flag, item in _NOT_PORTED:
        if getattr(args, attr):
            raise NotImplementedError(f"{flag} is not ported yet: ROADMAP §A '{item}'")
    return PipelineConfig(
        memory=MemoryConfig(
            chunk_size=args.chunk_size, num_clusters=args.num_clusters,
            interval=args.interval, short_window=args.short_window,
            remember_window=args.remember_window, tau=float(args.tau),
            compress_rate=args.compress_rate, offload_chunks=args.offload_chunks,
            offload_residents=args.offload_residents),
        sampling=SamplingConfig(temperature=args.temperature, top_p=args.top_p,
                                num_beams=args.num_beams),
        video=VideoConfig(sample_rate=args.sample_rate),
        retrieval=RetrievalConfig(top_k=args.memory_search_top_k, language=args.language),
        paths=ModelPaths(longva=args.model_name, colbert=args.embedding_model,
                         minilm=args.minilm_model),
        conv_mode=args.conv_mode, mode=args.mode,
        multi_modal_memory=args.multi_modal_memory, ppl=args.ppl)


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg = config_from_args(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu --geometry tiny for a CPU run)")
    pipeline = build_pipeline(cfg, device=device, dtype=torch.bfloat16,
                              geometry=args.geometry)
    if args.int4:
        pipeline.model.quantize(bits=4)
    elif args.int8:
        pipeline.model.quantize()
    if args.spec_tokens:
        pipeline.model.spec_tokens = args.spec_tokens
        pipeline.model.spec_ngram = args.spec_ngram
    if args.literal_kmeans:
        pipeline.cluster_full_chunks = False
    t0 = time.time()
    run_inference(pipeline, args)
    print(json.dumps({"seconds": round(time.time() - t0, 3),
                      "phase_totals": pipeline.last_phase_totals}))


if __name__ == "__main__":
    main()
