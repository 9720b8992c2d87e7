"""TorR HDC reranker as an LM serving layer (port of
``repro.serving.reranker``).

Attaches the paper's associative aligner + graph reasoner to a decoder's
serve step: the pre-unembed hidden state is sign-projected to a query
hypervector, scored against a concept item memory, task-weighted
(s_hat = s * w), and folded into the logits as a bias. The query cache works
across *decode steps of the same sequence*: when consecutive hidden states
are similar (rho >= tau), cached concept scores are reused — the paper's
bypass path, measured by the returned telemetry.

For small vocabularies concepts map 1:1 to tokens; for large vocabularies an
[M, V]-sparse concept->token map projects concept scores onto the
vocabulary.

On the card a step launches two hand-written kernels: the encode
``sign_project_pack`` (``ops.encode_packed``) and the item-memory scan
``packed_hamming_batched`` (``ops.packed_similarity``). ``cfg.B`` is the
item memory's bank count, not the decode batch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import hdc
from ..core.item_memory import ItemMemory, random_item_memory
from ..core.types import TorrConfig
from ..device import resolve_device
from ..kernels import ops

# the reference draws the concept map's values and its mask from one key:
# an entry is kept where the uniform u < CONCEPT_DENSITY, and its value is
# the normal that the same u maps to, sqrt(2) erfinv(2u - 1)
CONCEPT_DENSITY = 0.02


@dataclasses.dataclass
class RerankerParams:
    R: torch.Tensor                   # f32 [D, d_model] projection
    task_w: torch.Tensor              # f32 [M] reasoner weights, active task
    concept_map: torch.Tensor | None  # f32 [M, V] or None (identity, M == V)
    alpha: torch.Tensor               # f32 [] logit-bias scale

    def to(self, device) -> "RerankerParams":
        return RerankerParams(
            self.R.to(device), self.task_w.to(device),
            None if self.concept_map is None else self.concept_map.to(device),
            self.alpha.to(device))


@dataclasses.dataclass
class RerankerState:
    prev_q: torch.Tensor   # int32 [B, D//32] previous step's packed query
    prev_s: torch.Tensor   # f32 [B, M] cached task-weighted scores
    valid: torch.Tensor    # bool [B]


def concept_map_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """The sparse concept->token map from uniforms u in [0, 1): the normal
    sqrt(2) erfinv(2u - 1) (argument kept above -1, as ``jax.random.normal``
    keeps it) where u < ``CONCEPT_DENSITY``, else 0. Every kept value lies
    at or below sqrt(2) erfinv(2 * 0.02 - 1), about -2.054, as in
    ``repro``, whose normal and mask come from one key."""
    lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)).item()
    normal = np.sqrt(2.0) * torch.erfinv(torch.clamp(2.0 * u - 1.0, min=lo))
    return torch.where(u < CONCEPT_DENSITY, normal, 0.0)


def init_reranker(cfg: TorrConfig, d_model: int, vocab: int,
                  alpha: float = 1.0,
                  generator: torch.Generator | None = None
                  ) -> tuple[RerankerParams, ItemMemory]:
    """Random item memory, projection, task weights (1 + <g, h_j>/D for a
    random task hypervector g) and, when ``vocab != cfg.M``, the concept
    map; drawn on the CPU from ``generator`` (``.to`` moves them)."""
    im = random_item_memory(generator, cfg)
    R = torch.randn((cfg.D, d_model), generator=generator) / np.sqrt(d_model)
    g = hdc.random_hv(generator, (cfg.D,))
    dots = torch.sum(im.bipolar.to(torch.int32) * g.to(torch.int32), dim=1,
                     dtype=torch.int32)
    task_w = 1.0 + dots.to(torch.float32) / cfg.D
    concept_map = None
    if vocab != cfg.M:
        concept_map = concept_map_from_uniform(
            torch.rand((cfg.M, vocab), generator=generator))
    return RerankerParams(R, task_w, concept_map,
                          torch.tensor(alpha, dtype=torch.float32)), im


def init_state(cfg: TorrConfig, B: int, device=None) -> RerankerState:
    """A cold state for a decode batch of ``B`` on ``device`` (the card
    unless the caller asks for the CPU)."""
    device = resolve_device(device)
    return RerankerState(
        prev_q=torch.zeros((B, cfg.words), dtype=torch.int32, device=device),
        prev_s=torch.zeros((B, cfg.M), dtype=torch.float32, device=device),
        valid=torch.zeros((B,), dtype=torch.bool, device=device),
    )


def rerank_step(params: RerankerParams, state: RerankerState,
                im: ItemMemory, hidden: torch.Tensor, logits: torch.Tensor,
                cfg: TorrConfig, tau: float = 0.9):
    """One decode step. hidden: [B, d_model]; logits: [B, V], on one
    device with the parameters, state and item memory.

    Returns (logits', state', telemetry{rho, bypassed})."""
    qp = ops.encode_packed(hidden, params.R, device=hidden.device)  # [B, W]
    return _rerank_from_packed(params, state, im, qp, logits, cfg, tau)


def _rerank_from_packed(params: RerankerParams, state: RerankerState,
                        im: ItemMemory, qp: torch.Tensor,
                        logits: torch.Tensor, cfg: TorrConfig,
                        tau: float = 0.9):
    """:func:`rerank_step` after the encode, from the packed queries int32
    [B, W]: integers and readouts exact, so equal queries give ``repro``'s
    results bit for bit."""
    ham = hdc.hamming_packed(qp, state.prev_q)                # [B]
    rho = torch.where(state.valid, 1.0 - 2.0 * ham.to(torch.float32) / cfg.D,
                      -1.0)
    bypass = rho >= tau                                       # [B]

    # full path: XNOR-popcount scores vs item memory (Eq. 4) + reasoner
    dots = ops.packed_similarity(qp, im.packed, banks=cfg.B,
                                 bank_words=cfg.bank_words)[0]   # [B, M]
    s_full = dots.to(torch.float32) / cfg.D * params.task_w[None, :]
    s = torch.where(bypass[:, None], state.prev_s, s_full)

    bias = s if params.concept_map is None else s @ params.concept_map
    logits = logits + params.alpha * bias
    new_state = RerankerState(prev_q=qp, prev_s=s,
                              valid=torch.ones_like(state.valid))
    return logits, new_state, {"rho": rho, "bypassed": bypass}
