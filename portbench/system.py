"""The system under test: `streamchat_tpu_torch`'s pipeline built from a
configuration file and the run's seed. Weights are made on the device under
the checkpoint's names (portbench/weights.py) and handed to the program's
own maps (`models/weights.map_*`); nothing is written to disk."""

from __future__ import annotations

import dataclasses

import torch

from portbench import weights
from portbench.seeds import subseed


def configs(cfg: dict):
    """The program's (DecoderConfig, ViTConfig, tree BertConfig, bank
    BertConfig) for a configuration file."""
    from streamchat_tpu_torch.config import BertConfig, DecoderConfig, ViTConfig

    d = cfg["hidden_size"]
    dec = DecoderConfig(
        vocab_size=cfg["vocab_size"], hidden_size=d,
        intermediate_size=cfg["intermediate_size"], num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"], num_kv_heads=cfg["num_key_value_heads"],
        head_dim=d // cfg["num_attention_heads"], rope_theta=float(cfg["rope_theta"]),
        rms_eps=float(cfg["rms_norm_eps"]), qkv_bias=True,
        tie_embeddings=bool(cfg["tie_word_embeddings"]),
        max_position_embeddings=cfg["tokenizer_model_max_length"])
    vc = cfg["vision_config"]
    vit = ViTConfig(image_size=vc["image_size"], patch_size=vc["patch_size"],
                    hidden_size=vc["hidden_size"], intermediate_size=vc["intermediate_size"],
                    num_layers=vc["num_hidden_layers"], num_heads=vc["num_attention_heads"],
                    layernorm_eps=float(vc["layer_norm_eps"]),
                    select_layer=cfg["mm_vision_select_layer"], projection_dim=d)

    def bert(bc):
        return BertConfig(vocab_size=bc["vocab_size"], hidden_size=bc["hidden_size"],
                          intermediate_size=bc["intermediate_size"],
                          num_layers=bc["num_hidden_layers"],
                          num_heads=bc["num_attention_heads"],
                          max_position_embeddings=bc["max_position_embeddings"],
                          type_vocab_size=bc["type_vocab_size"],
                          layernorm_eps=float(bc["layer_norm_eps"]), pooling=bc["pooling"])

    return dec, vit, bert(cfg["tree_embedder"]), bert(cfg["bank_embedder"])


def pipeline_config(spec: dict, seed: int, vit_cfg):
    """The PipelineConfig of a traffic mix: config.py's defaults with the
    fields the mix sets."""
    from streamchat_tpu_torch.config import (MemoryConfig, PipelineConfig, SamplingConfig,
                                             VideoConfig)

    return PipelineConfig(
        memory=MemoryConfig(**spec.get("memory", {})),
        sampling=SamplingConfig(**spec.get("sampling", {})),
        video=VideoConfig(image_size=vit_cfg.image_size, **spec.get("video_config", {})),
        multi_modal_memory=True, seed=subseed(seed, "pipeline"))


def serve(model, serving: dict) -> None:
    """Set the model up as the configuration's `serving` says: `weight_bits`
    16 (bf16 as made), 8 or 4 (`LongVA.quantize`); every other key is a
    serving field of the `LongVA` facade set as given (`kv_int8`,
    `spec_tokens`, `spec_ngram`, `kv_budget_tokens`)."""
    rest = dict(serving)
    bits = int(rest.pop("weight_bits"))
    if bits in (4, 8):
        model.quantize(bits=bits)
    elif bits != 16:
        raise ValueError(f"weight_bits {bits}: the program serves 16, 8 or 4")
    fields = {f.name for f in dataclasses.fields(model)}
    for key, value in rest.items():
        if key not in fields:
            raise KeyError(f"serving key {key!r} is no field of the program's LongVA")
        setattr(model, key, value)


def build(cfg: dict, spec: dict, seed: int, device):
    """-> the program's StreamChatPipeline, served as the configuration
    says (`serve`)."""
    from streamchat_tpu_torch.models.embedder import TextEmbedder
    from streamchat_tpu_torch.models.longva import LongVA
    from streamchat_tpu_torch.models.tokenizer import ByteTokenizer
    from streamchat_tpu_torch.models.weights import (map_bert, map_decoder, map_projector,
                                                     map_vit)
    from streamchat_tpu_torch.pipeline.runner import StreamChatPipeline

    dec_cfg, vit_cfg, tree_cfg, bank_cfg = configs(cfg)
    bf16 = torch.bfloat16
    w = weights.SeededWeights(weights.vit_groups(cfg), seed, device, bf16)
    vit_p = map_vit(w, vit_cfg, bf16, device=device)
    w = weights.SeededWeights(weights.projector_groups(cfg), seed, device, bf16)
    proj_p = map_projector(w, bf16, device=device)
    w = weights.SeededWeights(weights.decoder_groups(cfg), seed, device, bf16)
    dec_p = map_decoder(w, dec_cfg, bf16, device=device)
    del w
    model = LongVA(vit_params=vit_p, proj_params=proj_p, dec_params=dec_p, vit_cfg=vit_cfg,
                   dec_cfg=dec_cfg, tokenizer=ByteTokenizer(),
                   generator=torch.Generator(device=device).manual_seed(
                       subseed(seed, "sampling")))
    del vit_p, proj_p, dec_p
    serve(model, cfg["serving"])

    def embedder(bc_file, bc, tag):
        t = weights.SeededWeights(weights.bert_groups(bc_file, tag), seed, device,
                                  torch.float32)
        return TextEmbedder(map_bert(t, bc, torch.float32, device=device), bc, ByteTokenizer())

    tree = embedder(cfg["tree_embedder"], tree_cfg, "tree_embedder")
    bank = embedder(cfg["bank_embedder"], bank_cfg, "bank_embedder")
    pipe = StreamChatPipeline(model, tree, bank, pipeline_config(spec, seed, vit_cfg))
    return pipe


def with_sampling(pipe, **fields):
    """The pipeline's config with some SamplingConfig fields changed."""
    return pipe.cfg.replace(sampling=dataclasses.replace(pipe.cfg.sampling, **fields))
