"""Typed configuration for the StreamChat pipeline.

A copy of `streamchat_tpu/config.py` (field for field; tests hold the two
equal), so that the port imports nothing of the JAX package.

One dataclass replaces the reference's four overlapping config mechanisms
(argparse in `inference_streaming_longva_v2.py:48-87`, the driver shell script
`inference_streamchat_v0.3.sh:6-27`, HF dataclasses in
`memory_bank/memory_utils.py:15-41`, and import-time dicts in
`memory_bank/memory_retrieval/configs/model_config.py`).

Defaults reproduce the canonical StreamBench v0.3 hyperparameters from
`inference_streamchat_v0.3.sh:10-27`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MemoryConfig:
    """Visual memory geometry (reference flags at inference_streaming_longva_v2.py:60-66)."""

    chunk_size: int = 40          # frames per caption chunk
    num_clusters: int = 5         # k-means centroids per chunk
    interval: int = 10            # nodes per summarize merge
    short_window: int = 20        # short-term FIFO length
    remember_window: int = 5      # frames sampled from the FIFO
    tau: float = 5.0              # Ebbinghaus decay constant
    compress_rate: int = 1        # spatial avg-pool factor over the patch grid
    # Park raw caption chunks in host RAM between chunking and captioning
    # (each rides back inside its caption's splice). Frees ~1 GB of HBM that
    # the long caption prefills need at chunk_size=40 / 7B geometry; costs
    # one extra H2D per caption, so off by default for small-model runs.
    offload_chunks: bool = False
    # Heavy-tail guard: segments with MORE sampled frames than this offload
    # their raw chunks automatically even when offload_chunks is False. The
    # reference clamps only >900-frame segments to 200
    # (inference_streaming_longva_v2.py:484-485), so a legal segment can
    # carry ~840 frames — a ~3.5 GB feature stack at 7B geometry whose
    # device-resident chunk copies would double it. 512 keeps every
    # benchmarked geometry (<=360 frames) on the no-offload fast path.
    # None disables the guard.
    offload_chunks_over: Optional[int] = 512
    # Park the IDLE weight trees (ViT + projector + both text embedders,
    # ~1.3 GB at production geometry) in host RAM for the duration of each
    # segment's caption loop (utils/offload.WeightOffloader). Frees the
    # margin batched captioning (caption_batch>1) needs at chunk_size=40 on
    # one 16 GB chip; costs one async H2D per tree per segment to restore.
    offload_residents: bool = False


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Generation settings (reference flags at inference_streaming_longva_v2.py:73-76)."""

    temperature: float = 0.2
    top_p: Optional[float] = None
    num_beams: int = 1
    # Per-role token budgets (inference_streaming_longva_v2.py:149,256; utiles.py:555,604).

    def __post_init__(self):
        # Beam search is deliberately unimplemented: every reference call
        # site runs num_beams=1 (inference_streaming_longva_v2.py:74 parses
        # the flag; no generate call forwards >1). Fail loudly instead of
        # silently decoding greedily.
        if self.num_beams != 1:
            raise NotImplementedError(
                f"num_beams={self.num_beams}: beam search is not implemented "
                "(the reference never exercises it either); use num_beams=1"
            )

    max_answer_tokens: int = 256
    max_answer_tokens_unimodal: int = 512
    max_caption_tokens: int = 128
    max_summary_tokens: int = 256
    caption_temperature: float = 0.1
    # Chunk captions per batched generate call (1 = the reference's strictly
    # sequential captioning, utiles.py:539-556). Batching amortizes per-call
    # dispatch overhead and reads decode weights once per step for the whole
    # batch; HBM-bound deployments size this against the KV pool
    # (batch x context tokens of cache).
    caption_batch: int = 1
    # Cap on spliced visual tokens per answer (None = unbounded, the
    # reference's literal behavior — its only clamp is the 224k
    # tokenizer_model_max_length). The tree deepens over a stream, so
    # unbounded retrieval grows the answer prompt without limit; a budget
    # keeps one compiled answer shape and bounds per-round latency. When
    # over budget, the COARSEST retrieved levels are dropped first (short
    # memory and the finest level always survive).
    max_visual_tokens: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class VideoConfig:
    """Frame ingest settings (inference_streaming_longva_v2.py:454-531)."""

    sample_rate: float = 0.2      # fraction of segment frames sampled
    frame_cap: int = 200          # clamp when sampled frames exceed frame_cap_trigger
    frame_cap_trigger: int = 900  # reference: >900 sampled frames -> clamp to 200
    image_size: int = 336         # CLIP ViT-L/14-336 input
    # ViT encode batch. 128 is the measured v5e throughput optimum
    # (CLAUDE.md); drop to 64 when the decoder shares the chip and HBM
    # headroom is tight (the encode program's workspace scales with batch).
    ingest_batch: int = 128
    # Selective frame stacking (paper's scene-change dedup; cosine-similarity
    # replacement for the reference's optical-flow test at utiles.py:182-248).
    dedup_threshold: float = 0.0  # 0.0 disables; v0.3 benchmark path uses uniform sampling


@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    """Dialogue memory retrieval (memory_bank/memory_retrieval/configs/model_config.py)."""

    top_k: int = 1                # --memory_search_top_k
    chunk_size: int = 200         # CHUNK_SIZE: neighbor-stitch budget in characters
    language: str = "en"


@dataclasses.dataclass(frozen=True)
class ModelPaths:
    """Checkpoint locations. None means run with random weights (testing/bench)."""

    longva: Optional[str] = None          # LongVA-7B-DPO
    llama3: Optional[str] = None          # LLaMA-3-8B-Instruct (judge / summaries)
    colbert: Optional[str] = None         # mxbai-colbert-large-v1 (tree retrieval)
    minilm: Optional[str] = None          # all-MiniLM-L6-v2 (dialogue retrieval)


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Device mesh layout. data x model axes over a TPU slice.

    The reference needs 2x80GB GPUs because it loads the same LongVA checkpoint
    twice (inference_streaming_longva_v2.py:697-700). Here one tensor-parallel
    copy serves both answering and captioning, so a v5p-8 runs the whole
    pipeline with the data axis free for benchmark sharding.
    """

    data_axis: str = "data"
    model_axis: str = "model"
    dp: int = 1
    tp: int = 1


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    memory: MemoryConfig = dataclasses.field(default_factory=MemoryConfig)
    sampling: SamplingConfig = dataclasses.field(default_factory=SamplingConfig)
    video: VideoConfig = dataclasses.field(default_factory=VideoConfig)
    retrieval: RetrievalConfig = dataclasses.field(default_factory=RetrievalConfig)
    paths: ModelPaths = dataclasses.field(default_factory=ModelPaths)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    conv_mode: str = "qwen_1_5"
    mode: str = "off_line"
    multi_modal_memory: bool = True
    # --ppl: persist teacher-forced NLL/perplexity of each ground-truth
    # answer alongside the prediction (reference threads args.ppl at
    # inference_streaming_longva_v2.py:908-910 with dead bookkeeping).
    ppl: bool = False
    seed: int = 0

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Model architecture configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """CLIP vision tower (longva/model/multimodal_encoder/clip_encoder.py).

    Defaults are CLIP ViT-L/14-336: 576 patch tokens after dropping CLS.
    """

    image_size: int = 336
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    layernorm_eps: float = 1e-5
    # Reference selects hidden_states[select_layer] and drops CLS
    # (clip_encoder.py:68-79); -2 means features from the penultimate block.
    select_layer: int = -2
    projection_dim: int = 4096    # mm_projector output = LM hidden size

    @property
    def num_patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.num_patches_per_side ** 2

    @classmethod
    def tiny(cls, projection_dim: int = 128) -> "ViTConfig":
        """Small geometry for unit tests and the multichip dry run."""
        return cls(
            image_size=56,
            patch_size=14,
            hidden_size=64,
            intermediate_size=128,
            num_layers=2,
            num_heads=4,
            projection_dim=projection_dim,
        )


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Causal decoder shared by Qwen2 (LongVA) and LLaMA-3 (judge).

    Differences are captured by fields: Qwen2-7B uses qkv biases and a 152k
    vocab; LLaMA-3-8B uses no biases, GQA 8, vocab 128256.
    """

    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_layers: int = 28
    num_heads: int = 28
    num_kv_heads: int = 4
    head_dim: int = 128
    rope_theta: float = 1e6
    rms_eps: float = 1e-6
    qkv_bias: bool = True          # Qwen2 yes, LLaMA-3 no
    tie_embeddings: bool = False
    max_position_embeddings: int = 224 * 1024   # LongVA long-context window
    eos_token_id: int = 151645     # <|im_end|> for Qwen2-chatml
    pad_token_id: int = 151643
    dtype: str = "bfloat16"

    @classmethod
    def qwen2_7b(cls) -> "DecoderConfig":
        """LongVA-7B backbone (Qwen2-7B-Instruct geometry)."""
        return cls()

    @classmethod
    def llama3_8b(cls) -> "DecoderConfig":
        """Judge model (eval_video_qa_with_llama3_ours.py:88-90)."""
        return cls(
            vocab_size=128256,
            hidden_size=4096,
            intermediate_size=14336,
            num_layers=32,
            num_heads=32,
            num_kv_heads=8,
            head_dim=128,
            rope_theta=5e5,
            rms_eps=1e-5,
            qkv_bias=False,
            max_position_embeddings=8192,
            eos_token_id=128009,   # <|eot_id|>
            pad_token_id=128001,
        )

    @classmethod
    def tiny(cls, vocab_size: int = 512) -> "DecoderConfig":
        """Small config for unit tests and the multichip dry run."""
        return cls(
            vocab_size=vocab_size,
            hidden_size=128,
            intermediate_size=256,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=32,
            rope_theta=1e4,
            max_position_embeddings=2048,
            eos_token_id=1,
            pad_token_id=0,
        )


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """BERT-style text encoders used for retrieval.

    mxbai-colbert-large-v1 (tree search, CLS pooling; utiles.py:688-708) and
    all-MiniLM-L6-v2 (dialogue memory, mean pooling; local_doc_qa.py:191).
    """

    vocab_size: int = 30522
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layernorm_eps: float = 1e-12
    pooling: str = "cls"           # "cls" (colbert) or "mean" (MiniLM)

    @classmethod
    def mxbai_colbert_large(cls) -> "BertConfig":
        return cls()

    @classmethod
    def minilm_l6(cls) -> "BertConfig":
        return cls(
            hidden_size=384,
            intermediate_size=1536,
            num_layers=6,
            num_heads=12,
            pooling="mean",
        )

    @classmethod
    def tiny(cls) -> "BertConfig":
        return cls(
            vocab_size=1024,
            hidden_size=64,
            intermediate_size=128,
            num_layers=2,
            num_heads=4,
            max_position_embeddings=128,
            pooling="cls",
        )
