"""Assigned architectures x input shapes (public-literature configs; port
of ``repro.configs.registry``, the same constructors and shapes).

``get_smoke`` shrinks every dimension while preserving the family topology
(pattern ratios, MoE routing, MLA ranks ...) so smoke tests exercise the
same code paths the full config runs. ``input_specs`` gives abstract
inputs as :class:`TensorSpec` records (shape and torch dtype), the
counterpart of ``jax.ShapeDtypeStruct``.
"""
from __future__ import annotations

import dataclasses

from typing import NamedTuple

import torch

from ..models.config import ModelConfig

# ---------------------------------------------------------------------------
# Full (published) configs
# ---------------------------------------------------------------------------

def deepseek_v3_671b() -> ModelConfig:
    # [arXiv:2412.19437] 61L d7168 128H MLA d_ff(moe)=2048 vocab 129280,
    # 1 shared + 256 routed top-8, MTP, first 3 layers dense (d_ff 18432)
    return ModelConfig(
        name="deepseek-v3-671b", family="moe",
        n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
        head_dim=128, d_ff=18432, vocab=129280,
        attn_kind="mla", q_lora_rank=1536, kv_lora_rank=512,
        rope_head_dim=64, nope_head_dim=128, v_head_dim=128,
        n_experts=256, n_shared_experts=1, moe_top_k=8, moe_d_ff=2048,
        first_k_dense=3, mtp_depth=1, tie_embeddings=False,
    )


def deepseek_v2_236b() -> ModelConfig:
    # [arXiv:2405.04434] 60L d5120 128H MLA kv_lora=512 d_ff(moe)=1536
    # vocab 102400, 2 shared + 160 routed top-6, first layer dense (d_ff 12288)
    return ModelConfig(
        name="deepseek-v2-236b", family="moe",
        n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
        head_dim=128, d_ff=12288, vocab=102400,
        attn_kind="mla", q_lora_rank=1536, kv_lora_rank=512,
        rope_head_dim=64, nope_head_dim=128, v_head_dim=128,
        n_experts=160, n_shared_experts=2, moe_top_k=6, moe_d_ff=1536,
        first_k_dense=1, tie_embeddings=False,
    )


def gemma_7b() -> ModelConfig:
    # [arXiv:2403.08295] 28L d3072 16H kv16 head_dim 256 GeGLU d_ff 24576
    return ModelConfig(
        name="gemma-7b", family="dense",
        n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16,
        head_dim=256, d_ff=24576, vocab=256000,
        activation="geglu", embed_scale=True, tie_embeddings=True,
    )


def phi3_mini_3_8b() -> ModelConfig:
    # [arXiv:2404.14219] 32L d3072 32H kv32 d_ff 8192 SwiGLU vocab 32064
    return ModelConfig(
        name="phi3-mini-3.8b", family="dense",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
        head_dim=96, d_ff=8192, vocab=32064, tie_embeddings=False,
    )


def qwen3_14b() -> ModelConfig:
    # [hf:Qwen/Qwen3-14B] 40L d5120 40H kv8 d_ff 17408, qk_norm
    return ModelConfig(
        name="qwen3-14b", family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
        head_dim=128, d_ff=17408, vocab=151936,
        qk_norm=True, rope_theta=1e6, tie_embeddings=False,
    )


def deepseek_7b() -> ModelConfig:
    # [arXiv:2401.02954] llama-arch 30L d4096 32H kv32 d_ff 11008 vocab 102400
    return ModelConfig(
        name="deepseek-7b", family="dense",
        n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
        head_dim=128, d_ff=11008, vocab=102400, tie_embeddings=False,
    )


def musicgen_large() -> ModelConfig:
    # [arXiv:2306.05284] 48L d2048 32H d_ff 8192, 4 EnCodec codebooks x 2048
    return ModelConfig(
        name="musicgen-large", family="audio",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
        head_dim=64, d_ff=8192, vocab=2048,
        n_codebooks=4, tie_embeddings=False,
    )


def llama32_vision_90b() -> ModelConfig:
    # [hf:meta-llama/Llama-3.2-90B-Vision] 100L (80 self + 20 cross) d8192
    # 64H kv8 d_ff 28672 vocab 128256; vision frontend stubbed
    return ModelConfig(
        name="llama-3.2-vision-90b", family="vlm",
        n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
        head_dim=128, d_ff=28672, vocab=128256,
        cross_attn_every=5, vision_dim=1280, n_vision_tokens=1601,
        rope_theta=5e5, tie_embeddings=False,
    )


def recurrentgemma_2b() -> ModelConfig:
    # [arXiv:2402.19427] 26L d2560 10H MQA(kv=1) head_dim 256 d_ff 7680
    # pattern (rglru, rglru, local_attn) window 2048, lru_width 2560
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid",
        n_layers=26 + 1, d_model=2560, n_heads=10, n_kv_heads=1,
        head_dim=256, d_ff=7680, vocab=256000,
        block_pattern=("rglru", "rglru", "local_attn"),
        sliding_window=2048, lru_width=2560,
        activation="geglu", embed_scale=True, tie_embeddings=True,
    )


def xlstm_1_3b() -> ModelConfig:
    # [arXiv:2405.04517] 48 blocks d2048 4H, mLSTM/sLSTM mix, no separate FFN
    return ModelConfig(
        name="xlstm-1.3b", family="ssm",
        n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
        head_dim=512, d_ff=0, vocab=50304,
        slstm_every=8, tie_embeddings=False,
    )


ARCHS = {
    "deepseek-v3-671b": deepseek_v3_671b,
    "deepseek-v2-236b": deepseek_v2_236b,
    "gemma-7b": gemma_7b,
    "phi3-mini-3.8b": phi3_mini_3_8b,
    "qwen3-14b": qwen3_14b,
    "deepseek-7b": deepseek_7b,
    "musicgen-large": musicgen_large,
    "llama-3.2-vision-90b": llama32_vision_90b,
    "recurrentgemma-2b": recurrentgemma_2b,
    "xlstm-1.3b": xlstm_1_3b,
}

# Pure full-attention archs skip long_500k (sub-quadratic required).
SUBQUADRATIC = {"recurrentgemma-2b", "xlstm-1.3b"}

SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, mode="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, mode="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, mode="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, mode="decode"),
}


def get(name: str) -> ModelConfig:
    return ARCHS[name]()


def shape_for(arch: str, shape: str) -> dict | None:
    """Shape dict, or None if the cell is skipped (with reason)."""
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return None
    return SHAPES[shape]


# ---------------------------------------------------------------------------
# Reduced smoke configs (same family topology, tiny dims)
# ---------------------------------------------------------------------------

def get_smoke(name: str) -> ModelConfig:
    full = get(name)
    common = dict(
        vocab=256, attn_chunk=32, mlstm_chunk=16, remat_policy="full")
    if full.family == "moe":
        return dataclasses.replace(
            full, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
            head_dim=16, d_ff=128, q_lora_rank=32, kv_lora_rank=32,
            rope_head_dim=16, nope_head_dim=16, v_head_dim=16,
            n_experts=8, moe_top_k=2, moe_d_ff=64, first_k_dense=1,
            mtp_depth=full.mtp_depth, **common)
    if full.family == "vlm":
        return dataclasses.replace(
            full, n_layers=5, d_model=64, n_heads=4, n_kv_heads=2,
            head_dim=16, d_ff=128, cross_attn_every=5,
            vision_dim=48, n_vision_tokens=16, **common)
    if full.family == "hybrid":
        return dataclasses.replace(
            full, n_layers=3, d_model=64, n_heads=4, n_kv_heads=1,
            head_dim=16, d_ff=128, lru_width=64, sliding_window=16, **common)
    if full.family == "ssm":
        return dataclasses.replace(
            full, n_layers=4, d_model=64, n_heads=2, slstm_every=4, **common)
    if full.family == "audio":
        return dataclasses.replace(
            full, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
            head_dim=16, d_ff=128, **common)
    return dataclasses.replace(
        full, n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=max(1, full.n_kv_heads * 4 // full.n_heads),
        head_dim=16, d_ff=128, **common)


# ---------------------------------------------------------------------------
# Abstract input specs for the dry-run (no allocation)
# ---------------------------------------------------------------------------

class TensorSpec(NamedTuple):
    """A tensor's shape and dtype, without its data."""
    shape: tuple
    dtype: torch.dtype


def input_specs(cfg: ModelConfig, shape: dict) -> dict:
    """Abstract inputs for train/prefill/decode lowering of ``cfg``."""
    B = shape["global_batch"]
    S = shape["seq_len"]
    mode = shape["mode"]
    def tok(*s):
        return TensorSpec(s, torch.int32)

    if mode == "train":
        if cfg.family == "audio":
            batch = {"tokens": tok(B, S, cfg.n_codebooks),
                     "labels": tok(B, S, cfg.n_codebooks)}
        else:
            batch = {"tokens": tok(B, S), "labels": tok(B, S)}
        if cfg.family == "vlm":
            batch["vision"] = TensorSpec(
                (B, cfg.n_vision_tokens, cfg.vision_dim), torch.bfloat16)
        if cfg.family == "moe" and cfg.mtp_depth:
            batch["tokens_next"] = tok(B, S)
            batch["labels_mtp"] = tok(B, S)
        return batch
    if mode == "prefill":
        if cfg.family == "audio":
            batch = {"tokens": tok(B, S, cfg.n_codebooks)}
        else:
            batch = {"tokens": tok(B, S)}
        if cfg.family == "vlm":
            batch["vision"] = TensorSpec(
                (B, cfg.n_vision_tokens, cfg.vision_dim), torch.bfloat16)
        return batch
    # decode: one new token against an S-long cache
    if cfg.family == "audio":
        return {"tokens": tok(B, cfg.n_codebooks)}
    return {"tokens": tok(B)}
