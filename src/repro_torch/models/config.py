"""Model configuration covering all 10 assigned architectures (port of
``repro.models.config``, copied field for field).

One dataclass, many knobs; per-arch constructors live in
``repro_torch.configs``.
Families:
  dense  — llama-style decoder (gemma/phi3/qwen3/deepseek-7b)
  moe    — DeepSeek V2/V3 (MLA attention + routed experts [+ MTP])
  hybrid — RecurrentGemma (RG-LRU + local attention, 1:2 pattern)
  ssm    — xLSTM (mLSTM/sLSTM blocks, no separate FFN)
  audio  — MusicGen (decoder over EnCodec codebook tokens; frontend stub)
  vlm    — Llama-3.2-Vision (interleaved cross-attention layers; vision stub)
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | audio | vlm

    # core dims
    n_layers: int = 12
    d_model: int = 1024
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 128
    d_ff: int = 4096
    vocab: int = 32000

    # attention flavor
    attn_kind: str = "gqa"            # gqa | mla
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None   # local attention window (if any)
    attn_logit_softcap: Optional[float] = None

    # activations / norms
    activation: str = "swiglu"        # swiglu | geglu
    rmsnorm_eps: float = 1e-6
    embed_scale: bool = False         # gemma-style sqrt(d_model) embedding scale
    tie_embeddings: bool = True

    # MLA (DeepSeek V2/V3)
    q_lora_rank: int = 0              # 0 = dense q projection
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 2
    moe_d_ff: int = 0                 # per-expert hidden dim
    first_k_dense: int = 0            # leading dense layers (DeepSeek)
    capacity_factor: float = 1.25
    # MTP (DeepSeek V3 multi-token prediction)
    mtp_depth: int = 0

    # hybrid (RecurrentGemma / Griffin): repeating layer pattern
    block_pattern: Tuple[str, ...] = ()    # e.g. ("rglru", "rglru", "local_attn")
    lru_width: int = 0                     # RG-LRU recurrence width
    conv_width: int = 4

    # ssm (xLSTM)
    slstm_every: int = 8              # every k-th block is sLSTM; rest mLSTM
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0

    # audio (MusicGen)
    n_codebooks: int = 0

    # vlm (Llama-3.2-Vision)
    cross_attn_every: int = 0         # every k-th layer is cross-attention
    vision_dim: int = 0
    n_vision_tokens: int = 0

    # numerics / execution
    dtype: str = "bfloat16"
    remat_policy: str = "nothing"     # nothing | dots | full(=no remat)
    scan_layers: bool = True
    attn_chunk: int = 512             # query-chunked exact attention (train/prefill)
    mlstm_chunk: int = 256            # chunkwise-parallel mLSTM chunk
    # beyond-paper serving/training knobs
    serve_quant: str = "none"         # none | int8 — int8 KV/latent cache decode
    attn_remat: bool = False          # flash-style recompute of attn chunks in bwd
    moe_groups: int = 0               # >0: EP-local grouped MoE dispatch (= data shards)

    # ------------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        if self.attn_kind == "mla":
            return self.n_heads * (self.nope_head_dim + self.rope_head_dim)
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def mla_cache_dim(self) -> int:
        return self.kv_lora_rank + self.rope_head_dim

    def param_count(self) -> int:
        """Exact parameter count (drives MODEL_FLOPS = 6*N*D roofline term)."""
        d = self.d_model
        n = 0
        n += self.vocab * d                       # embed
        if not self.tie_embeddings:
            n += self.vocab * d
        per_layer = 0
        if self.family in ("dense", "moe", "audio", "vlm"):
            per_layer += self._attn_params()
            per_layer += 2 * d                    # 2 rmsnorm scales
        if self.family == "dense" or self.family == "audio" or self.family == "vlm":
            per_layer += 3 * d * self.d_ff
        n += self.n_layers * per_layer
        if self.family == "moe":
            dense_ff = 3 * d * self.d_ff
            moe_ff = (
                self.n_experts * 3 * d * self.moe_d_ff
                + self.n_shared_experts * 3 * d * self.moe_d_ff
                + d * self.n_experts                      # router
            )
            n += self.first_k_dense * dense_ff
            n += (self.n_layers - self.first_k_dense) * moe_ff
        if self.family == "vlm":
            # cross layers are already inside n_layers; count only the delta
            # (their wk/wv read vision_dim instead of d) + kv_norm + gate
            n_cross = self.n_layers // max(self.cross_attn_every, 1)
            n += n_cross * (2 * (self.vision_dim - d) * self.kv_dim
                            + self.vision_dim + 1)
        if self.family == "hybrid":
            pat = self.block_pattern
            n_groups = self.n_layers // len(pat)
            for kind in pat:
                if kind == "local_attn":
                    blk = self._attn_params()
                else:  # rglru
                    w = self.lru_width
                    blk = 2 * d * w + w * d + 2 * w * w // 1 + 4 * w  # proj + gates + conv
                blk += 3 * d * self.d_ff + 2 * d
                n += n_groups * blk
        if self.family == "ssm":
            dh = self.d_model // self.n_heads
            f = self.mlstm_proj_factor
            dm_in = int(d * f)
            mlstm_blk = (
                2 * d * dm_in             # up projections (2 branches)
                + 3 * dm_in * dm_in // self.n_heads  # per-head qkv (block-diag)
                + 2 * self.n_heads * dm_in  # i/f gate logits
                + dm_in * d               # down proj
                + self.conv_width * dm_in
                + 2 * d
            )
            sf = self.slstm_proj_factor
            ds_in = int(d * sf)
            slstm_blk = (
                4 * d * d + 4 * d * dh    # recurrent (block-diag) + input projections
                + d * ds_in + ds_in * d   # post up/down
                + 2 * d
            )
            n_slstm = self.n_layers // self.slstm_every
            n += (self.n_layers - n_slstm) * mlstm_blk + n_slstm * slstm_blk
        if self.family == "moe" and self.mtp_depth > 0:
            n += self.mtp_depth * (self._attn_params() + 3 * d * self.moe_d_ff * (
                self.n_shared_experts + 0) + 2 * d * d)
        return int(n)

    def _attn_params(self) -> int:
        d = self.d_model
        if self.attn_kind == "mla":
            n = 0
            if self.q_lora_rank:
                n += d * self.q_lora_rank + self.q_lora_rank * self.q_dim
            else:
                n += d * self.q_dim
            n += d * (self.kv_lora_rank + self.rope_head_dim)          # down + k_rope
            n += self.kv_lora_rank * self.n_heads * (self.nope_head_dim + self.v_head_dim)
            n += self.n_heads * self.v_head_dim * d                    # out
            return n
        return d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d

    def active_param_count(self) -> int:
        """Active params per token (MoE): 6*N_active*D roofline term."""
        if self.family != "moe":
            return self.param_count()
        full = self.param_count()
        moe_layers = self.n_layers - self.first_k_dense
        inactive_experts = self.n_experts - self.moe_top_k
        full -= moe_layers * inactive_experts * 3 * self.d_model * self.moe_d_ff
        return int(full)
