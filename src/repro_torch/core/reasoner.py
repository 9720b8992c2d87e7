"""HDC graph reasoner (port of ``repro.core.reasoner``; paper Sec. 3.2/4.5).

A k-hop relation path composes g_P = t (*) r_l1 (*) ... (*) r_lk by Hadamard
binding; the reasoner weight for concept j is w_j = cos(g_P, h_j) and the
final score is s_j * w_j. Reasoner gating: when the aligner's top-k key and
margin match the cached window, the cached output is forwarded.
"""
from __future__ import annotations

import dataclasses

import torch

from . import hdc
from .item_memory import ItemMemory, dim_mask
from .types import TorrConfig


@dataclasses.dataclass
class TaskGraph:
    relations: torch.Tensor  # int8 [n_relations, D]
    text_hv: torch.Tensor    # int8 [n_tasks, D] prompt hypervectors t


def init_task_graph(generator: torch.Generator, cfg: TorrConfig,
                    n_tasks: int) -> TaskGraph:
    return TaskGraph(
        relations=hdc.random_hv(generator, (cfg.n_relations, cfg.D)),
        text_hv=hdc.random_hv(generator, (n_tasks, cfg.D)),
    )


def compose_path(graph: TaskGraph, task_id: int,
                 path_ids) -> torch.Tensor:
    """g_P = t (*) r_{l1} (*) ... (*) r_{lk}; ``path_ids`` entries < 0 are
    padding (bind with the identity)."""
    g = graph.text_hv[task_id].to(torch.int32)
    for rid in [int(r) for r in path_ids]:
        if rid >= 0:
            g = g * graph.relations[rid].to(torch.int32)
    return g.to(torch.int8)


def task_weights(g_P: torch.Tensor, im: ItemMemory, cfg: TorrConfig,
                 banks) -> torch.Tensor:
    """w_j = cos(g_P, h_j) over enabled dims, f32 [M].

    The dot is a float32 matmul of +-1/0 values (integer matmuls do not run
    on CUDA in torch); exact, since every partial sum is an integer of
    magnitude <= D << 2^24."""
    dmask = dim_mask(cfg, banks, g_P.device)
    g = torch.where(dmask, g_P.to(torch.float32), 0.0)
    dots = im.bipolar.to(torch.float32) @ g
    d_eff = torch.sum(dmask, dtype=torch.int32).to(torch.float32)
    return dots / d_eff


def topk_key_margin(scores: torch.Tensor, cfg: TorrConfig):
    """Aligner top-k indices and top-1/top-2 margin used for gating.

    A stable descending sort keeps the lowest index first among equal
    scores, the order ``lax.top_k`` gives (``torch.topk`` promises none)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    margin = vals[..., 0] - vals[..., 1]
    return idx[..., :cfg.top_k].to(torch.int32), margin


def gate_and_apply(scores: torch.Tensor, weights: torch.Tensor,
                   cached_out: torch.Tensor, cached_key: torch.Tensor,
                   cached_margin: torch.Tensor, cfg: TorrConfig):
    """Sec. 4.5 gating. Returns (out [..., M], reasoner_active, new_key,
    new_margin)."""
    key, margin = topk_key_margin(scores, cfg)
    eps = torch.full((), cfg.margin_eps, dtype=torch.float32,
                     device=scores.device)
    match = torch.logical_and(
        torch.all(key == cached_key, dim=-1),
        torch.abs(margin - cached_margin) <= eps,
    )
    reasoned = scores * weights
    out = torch.where(match[..., None], cached_out, reasoned)
    return out, torch.logical_not(match), key, margin
