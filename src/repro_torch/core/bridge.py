"""Image->event training bridge (port of ``repro.core.bridge``; paper
Sec. 3.2, Eq. 2-3).

Contrastive transfer that places event features near image features in CLIP
space while preserving text alignment:

    L_con = InfoNCE( f_img(I), f_evt(E_hat) ; tau_c )        (Eq. 2)
    L_zs  = InfoNCE( f_evt(E_hat), f_text(T) over vocab ; tau_t )   (Eq. 3)
    L     = L_con + alpha * L_zs

The CLIP encoders are *frozen*; offline, deterministic frozen proxy encoders
(random MLPs) stand in with the same interface — the bridge math, gradients
and convergence behaviour are the same, only the semantic quality of the
targets differs.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _l2norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


def info_nce(anchor: torch.Tensor, positives: torch.Tensor,
             temperature: float) -> torch.Tensor:
    """Diagonal InfoNCE: anchor[i] should match positives[i]. [B, d] each."""
    a = _l2norm(anchor)
    p = _l2norm(positives)
    logits = (a @ p.T) / temperature                     # [B, B]
    return torch.mean(-torch.diagonal(F.log_softmax(logits, dim=-1)))


def zero_shot_loss(event_emb: torch.Tensor, text_bank: torch.Tensor,
                   labels: torch.Tensor, temperature: float) -> torch.Tensor:
    """Eq. 3: event embedding vs the text vocabulary bank [V, d]."""
    e = _l2norm(event_emb)
    t = _l2norm(text_bank)
    logits = (e @ t.T) / temperature                     # [B, V]
    logp = F.log_softmax(logits, dim=-1)
    return torch.mean(-torch.gather(logp, 1, labels[:, None].to(torch.int64)))


def bridge_loss(image_emb: torch.Tensor, event_emb: torch.Tensor,
                text_bank: torch.Tensor, labels: torch.Tensor, *,
                tau_c: float = 0.07, tau_t: float = 0.07,
                alpha: float = 1.0) -> tuple[torch.Tensor, dict]:
    """L = L_con + alpha * L_zs, with a metrics dict (``l_con``, ``l_zs``,
    ``zs_acc``: zero-shot top-1 accuracy, the first maximum winning ties)."""
    l_con = info_nce(image_emb, event_emb, tau_c)
    l_zs = zero_shot_loss(event_emb, text_bank, labels, tau_t)
    loss = l_con + alpha * l_zs
    with torch.no_grad():
        logits = _l2norm(event_emb) @ _l2norm(text_bank).T
        acc = torch.mean((torch.argmax(logits, dim=-1) == labels)
                         .to(torch.float32))
    return loss, {"l_con": l_con.detach(), "l_zs": l_zs.detach(),
                  "zs_acc": acc}


# ---------------------------------------------------------------------------
# Frozen proxy CLIP encoders (offline stand-ins, deterministic)
# ---------------------------------------------------------------------------

class FrozenProxy(nn.Module):
    """tanh MLP whose weights are buffers, not parameters, and whose output
    is detached (``repro``'s ``stop_gradient``): no optimiser sees it."""

    def __init__(self, w1: torch.Tensor, w2: torch.Tensor):
        super().__init__()
        self.register_buffer("w1", w1)
        self.register_buffer("w2", w2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.tanh(x @ self.w1)
        return (h @ self.w2).detach()


def make_frozen_proxy(in_dim: int, emb_dim: int, hidden: int = 256,
                      generator: torch.Generator | None = None
                      ) -> FrozenProxy:
    """Random proxy weights drawn on the CPU (``FrozenProxy.to`` moves
    them)."""
    return FrozenProxy(
        w1=torch.randn((in_dim, hidden), generator=generator)
        / np.sqrt(in_dim),
        w2=torch.randn((hidden, emb_dim), generator=generator)
        / np.sqrt(hidden),
    )
