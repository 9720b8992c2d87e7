"""Associative cosine aligner: full scan, delta update and score readout
(port of ``repro.core.aligner``).

Accumulators are integer dot products over the enabled dimensions; cosine is
applied only at readout. Every function takes optional leading batch axes
(the multi-stream step's ``[S]``) on its per-query arguments.
"""
from __future__ import annotations

import torch

from ..kernels import fused_window as fw
from . import hdc
from .item_memory import ItemMemory, pmajor_bank_blocks, word_mask
from .types import TorrConfig

# torch._int_mm's shapes on CUDA: more than 16 rows, the inner dimension and
# the columns multiples of 8
INT_MM_MIN_ROWS = 17
INT_MM_ALIGN = 8


def full_dot(q_packed: torch.Tensor, im: ItemMemory,
             wmask: torch.Tensor) -> torch.Tensor:
    """Integer dot <q, h_j> over enabled words for all M classes.

    q_packed: int32 [..., W]; im.packed: int32 [M, W]; wmask: bool [..., W].
    dot = d_eff - 2 * hamming, with hamming counted on enabled words only.
    Returns int32 [..., M]."""
    x = q_packed[..., None, :] ^ im.packed                      # [..., M, W]
    pc = hdc.popcount32(x)
    pc = torch.where(wmask[..., None, :], pc, 0)
    d_eff = 32 * torch.sum(wmask, dim=-1, dtype=torch.int32)
    return d_eff[..., None] - 2 * torch.sum(pc, dim=-1, dtype=torch.int32)


def delta_indices(q_new_packed: torch.Tensor, q_old_packed: torch.Tensor,
                  wmask: torch.Tensor, budget: int, D: int):
    """PSU (Sec. 4.4): flipped dims between queries, within the delta budget.

    Returns (idx [..., budget] int32, weight [..., budget] int32 in
    {-2,0,+2}, count [...] int32 = true |Delta| over enabled words). Padding
    entries have weight 0 and idx 0; if count > budget the caller escalates
    to full. The k-th flipped dim is the smallest d whose cumulative flip
    count reaches k+1 (the same search as ``repro``)."""
    xor = torch.where(wmask, q_new_packed ^ q_old_packed, 0)
    count = torch.sum(hdc.popcount32(xor), dim=-1, dtype=torch.int32)
    shifts = torch.arange(32, dtype=torch.int32, device=xor.device)
    flip = ((xor[..., None] >> shifts) & 1).reshape(*xor.shape[:-1], D)
    cum = torch.cumsum(flip.to(torch.int64), dim=-1)
    k = torch.arange(budget, dtype=torch.int64, device=xor.device)
    in_budget = k < count[..., None]
    target = (k + 1).expand(*cum.shape[:-1], budget).contiguous()
    pos = torch.searchsorted(cum, target, side="left")
    idx = torch.where(in_budget, pos, 0)
    # q_new bit at a flipped dim: +1 bit -> new value +1 -> correction +2
    word = torch.gather(q_new_packed, -1, idx // 32)
    new_bits = (word >> (idx % 32).to(torch.int32)) & 1
    weight = torch.where(new_bits == 1, 2, -2).to(torch.int32)
    weight = torch.where(in_budget, weight, 0)
    return idx.to(torch.int32), weight, count


def delta_correct(acc: torch.Tensor, im: ItemMemory, idx: torch.Tensor,
                  weight: torch.Tensor,
                  dmajor_f32: torch.Tensor | None = None) -> torch.Tensor:
    """Eq. 6: acc_j += sum_{i in Delta} (q_i^t - q_i^{t-1}) h_{j,i}, as
    ``acc + delta_corrections(...)``."""
    return acc + delta_corrections(idx, weight, im, dmajor_f32)


def delta_corrections(d_idx: torch.Tensor, d_weight: torch.Tensor,
                      im: ItemMemory,
                      dmajor_f32: torch.Tensor | None = None) -> torch.Tensor:
    """Eq. 6 correction terms int32 [..., M] with
    ``corr = sum_k d_weight[..., k] * dmajor[d_idx[..., k]]``.

    The correction does not depend on the accumulator it lands on, so the
    batched apply pass takes it for a whole dispatch at once. ``repro``
    gathers ``budget`` rows per lane; here (as in ``repro``'s batched
    apply) the weights scatter into a dense [..., D] float32 vector and one
    matmul against ``dmajor`` (as float32; pass ``dmajor_f32`` to reuse a
    converted copy) gives the terms. Exact, and so TF32 must stay off:
    weights are in {-2, 0, +2}, dmajor in {-1, +1} and each row has at most
    ``budget`` nonzero terms, so every partial sum is an integer of
    magnitude <= 2*budget << 2^24, which float32 holds exactly in any
    order; TF32 would round the operands' products. Padding scatters weight
    0 onto dim 0 and adds nothing."""
    if dmajor_f32 is None:
        dmajor_f32 = im.dmajor.to(torch.float32)
    D = dmajor_f32.shape[0]
    wvec = torch.zeros(*d_idx.shape[:-1], D, dtype=torch.float32,
                       device=d_idx.device)
    wvec.scatter_add_(-1, d_idx.to(torch.int64), d_weight.to(torch.float32))
    return torch.round(wvec @ dmajor_f32).to(torch.int32)


def delta_apply(acc: torch.Tensor, im: ItemMemory, idx: torch.Tensor,
                weight: torch.Tensor) -> torch.Tensor:
    """Eq. 6 through the ``delta_update`` kernel (reads only the flipped
    rows of ``dmajor``), equal to :func:`delta_correct`. The kernel takes
    contiguous rows; the apply loop's per-proposal slices of a [S, N, ...]
    decision array are strided."""
    return fw.delta_apply(acc.contiguous(), im.dmajor, idx.contiguous(),
                          weight.contiguous())


def readout(acc: torch.Tensor, d_eff) -> torch.Tensor:
    """Cosine scores from integer accumulators (normalization 'shift')."""
    d_eff = torch.as_tensor(d_eff, device=acc.device).to(torch.float32)
    return acc.to(torch.float32) / d_eff


def full_scores(q_packed: torch.Tensor, im: ItemMemory, cfg: TorrConfig,
                banks):
    """Convenience: (acc int32 [..., M], cosine f32 [..., M]) for a full
    scan."""
    wmask = word_mask(cfg, banks, q_packed.device)
    acc = full_dot(q_packed, im, wmask)
    d_eff = torch.as_tensor(banks, dtype=torch.int32,
                            device=q_packed.device) * cfg.bank_dims
    return acc, readout(acc, d_eff)


def full_dot_mxu(q_bipolar: torch.Tensor, im: ItemMemory,
                 dmask: torch.Tensor) -> torch.Tensor:
    """Beyond-paper alternative: the bipolar dot as a tensor-core matmul.

    ``repro`` runs it as a bf16 product on the MXU; here it is
    ``torch._int_mm`` (int8 operands, int32 accumulation) on the +-1 codes
    masked by ``dmask``, exact at any D. The rows are padded to the shapes
    ``_int_mm`` takes on CUDA. q_bipolar: int8 [..., D]; returns int32 dots
    [..., M]."""
    D, M = q_bipolar.shape[-1], im.M
    q = torch.where(dmask, q_bipolar, 0).to(torch.int8).reshape(-1, D)
    n = q.shape[0]
    q = torch.nn.functional.pad(q, (0, 0, 0, max(n, INT_MM_MIN_ROWS) - n))
    cols = -(-M // INT_MM_ALIGN) * INT_MM_ALIGN
    h = torch.nn.functional.pad(im.bipolar, (0, 0, 0, cols - M))
    dots = torch._int_mm(q, h.T)[:n, :M]
    return dots.reshape(*q_bipolar.shape[:-1], M)


# ---------------------------------------------------------------------------
# Kernel dispatch (static plan cap, per-window bank choice)
# ---------------------------------------------------------------------------

def _plan_columns_bank_major(q_packed_all: torch.Tensor, im: ItemMemory,
                             banks: int, planes: int, cfg: TorrConfig):
    """(q_sel, im_sel) restricted to a static (banks, planes) plan's enabled
    words, in the bank-major column order of ``bank_plane_sel`` (bank
    boundaries stay word prefixes, the bank-prefix kernel's contract). Full
    precision keeps the contiguous bank prefix of ``packed``; reduced
    precision assembles contiguous slices of ``pmajor`` for the item memory
    and takes the query columns through a view (bank, word, plane) ->
    (bank, plane, word) of the same order, so no index array crosses from
    the host."""
    if planes >= cfg.bit_planes:
        we = banks * cfg.bank_words
        return q_packed_all[:, :we], im.packed[:, :we]
    n = q_packed_all.shape[0]
    q = q_packed_all.reshape(n, cfg.B, cfg.plane_words, cfg.bit_planes)
    q_sel = q[:, :banks, :, :planes].permute(0, 1, 3, 2).reshape(n, -1)
    return q_sel, pmajor_bank_blocks(im.pmajor, cfg, banks, planes)


def plan_prefix_hamming(q_packed: torch.Tensor, im: ItemMemory,
                        cfg: TorrConfig, *, planes: int,
                        cap: int) -> torch.Tensor:
    """Bank-prefix hamming over a (cap, planes) plan's enabled words:
    int32 [N, M, cap]. Column selection + the ``bank_prefix_hamming``
    kernel; the batched multi-stream step calls it once over its flattened
    S x N_max proposal batch."""
    q_sel, im_sel = _plan_columns_bank_major(q_packed, im, cap, planes, cfg)
    return fw.bank_prefix_hamming(q_sel.contiguous(), im_sel.contiguous(),
                                  cap=cap)


def prefix_select(ham_prefix: torch.Tensor, banks: torch.Tensor,
                  planes: int, cfg: TorrConfig) -> torch.Tensor:
    """Accumulators from bank-prefix hamming counts: each row selects its
    bank boundary and normalizes by its own D'. ``ham_prefix`` int32
    [..., M, cap], ``banks`` int [...]; returns int32 [..., M]."""
    banks = banks.to(torch.int64)
    sel = (banks - 1)[..., None, None].expand(*ham_prefix.shape[:-1], 1)
    ham = torch.gather(ham_prefix, -1, sel)[..., 0]
    d_eff = cfg.d_eff_planned(banks, planes).to(torch.int32)
    return d_eff[..., None] - 2 * ham


def full_scores_all(q_packed_all: torch.Tensor, im: ItemMemory,
                    banks: torch.Tensor, cfg: TorrConfig, *, planes: int,
                    cap: int) -> torch.Tensor:
    """Full-path integer accumulators for all proposals of a window batch
    through the bank-prefix dispatch: ``q_packed_all`` int32 [..., N, W]
    and ``banks`` [...] (one bank choice per window). One
    ``bank_prefix_hamming`` pass over the plan-capped prefix of every row
    of every window at once (the multi-stream step's whole S x N_max
    batch), then each window selects its bank boundary; no host read.
    Returns int32 [..., N, M], equal to :func:`full_dot` under the same
    plan."""
    banks = torch.clamp(banks, 1, cap)
    lead, (N, W) = q_packed_all.shape[:-2], q_packed_all.shape[-2:]
    ham_p = plan_prefix_hamming(
        q_packed_all.reshape(-1, W), im, cfg, planes=planes, cap=cap,
    ).reshape(*lead, N, cfg.M, cap)
    banks_rows = banks[..., None].expand(ham_p.shape[:-2])
    return prefix_select(ham_p, banks_rows, planes, cfg)


def switch_scores(q_packed_all: torch.Tensor, im: ItemMemory, choice,
                  cfg: TorrConfig, *, planes: int) -> torch.Tensor:
    """Full-path integer accumulators through the switch dispatch:
    ``choice`` holds each window's bank choice as host ints (the caller's
    one host read, clamped to [1, cap]); each choice slices its enabled
    words and one ``fused_scores`` pass scans them (the branch JAX's
    ``lax.switch`` picks on the device). Windows that share a choice
    share a launch. ``q_packed_all`` int32 [..., N, W] with one window per
    entry of ``choice``; returns int32 [..., N, M], equal to
    :func:`full_dot` under the same plan."""
    lead, (N, W) = q_packed_all.shape[:-2], q_packed_all.shape[-2:]
    q_win = q_packed_all.reshape(-1, N, W)
    if len(choice) != q_win.shape[0]:
        raise ValueError(f"{len(choice)} bank choices for {q_win.shape[0]} "
                         "windows")

    def scan(q, b):
        q_sel, im_sel = _plan_columns_bank_major(q.reshape(-1, W), im, b,
                                                 planes, cfg)
        acc, _best, _top2 = fw.fused_scores(
            q_sel.contiguous(), im_sel.contiguous(),
            d_eff=int(cfg.d_eff_planned(b, planes)))
        return acc.reshape(-1, N, cfg.M)

    if len(set(choice)) == 1:
        return scan(q_win, choice[0]).reshape(*lead, N, cfg.M)
    rows = {}
    for b in sorted(set(choice)):
        wins = [i for i, c in enumerate(choice) if c == b]
        rows.update(zip(wins, scan(torch.cat([q_win[i:i + 1] for i in wins]),
                                   b)))
    return torch.stack([rows[i] for i in range(len(choice))]).reshape(
        *lead, N, cfg.M)


def compact_full_scores(q_flat: torch.Tensor, full_mask: torch.Tensor,
                        banks_flat: torch.Tensor, im: ItemMemory,
                        cfg: TorrConfig, *, planes: int, cap: int,
                        bucket_cap: int, overflow: bool) -> torch.Tensor:
    """Compact-then-compute full-path accumulators: int32 [R, M], exact on
    every ``full_mask`` row and zero elsewhere (the apply pass never reads
    those).

    The decide pass already produced the path vector, so the bank-prefix
    scan runs only over the full-path rows, compacted into a dense bucket
    of the static ``bucket_cap`` rows (a ``policy.bucket_ladder`` tier):
    a row's bucket position is its rank among the full rows (a cumulative
    sum), unused positions point past the end and are dropped, so no
    compaction step reads the mask on the host. Each bucket row selects its
    own window's bank boundary. ``overflow`` is the caller's host read
    (more full rows than ``bucket_cap``): it takes the hoisted all-rows
    pass in place of the bucket, exact either way."""
    R = q_flat.shape[0]
    dev = q_flat.device
    bucket_cap = min(int(bucket_cap), R)
    banks_flat = torch.clamp(banks_flat, 1, cap)
    if overflow:                                  # the hoisted pass
        ham = plan_prefix_hamming(q_flat, im, cfg, planes=planes, cap=cap)
        acc = prefix_select(ham, banks_flat, planes, cfg)
        return torch.where(full_mask[:, None], acc, 0)
    pos = torch.cumsum(full_mask.to(torch.int64), 0) - 1
    pos = torch.where(full_mask, pos, bucket_cap)         # bucket_cap = drop
    rows = torch.full((bucket_cap + 1,), R, dtype=torch.int64, device=dev)
    rows.scatter_(0, pos, torch.arange(R, device=dev))
    rows = rows[:bucket_cap]                      # fill value R = unused
    safe = torch.clamp(rows, max=R - 1)
    ham_b = plan_prefix_hamming(q_flat[safe], im, cfg, planes=planes,
                                cap=cap)                  # [bucket, M, cap]
    acc_b = prefix_select(ham_b, banks_flat[safe], planes, cfg)
    out = torch.zeros((R + 1, cfg.M), dtype=torch.int32, device=dev)
    out[rows] = acc_b                             # unused rows land in R
    return out[:R]


def lookup_hamming_all(q_packed_all: torch.Tensor, entries: torch.Tensor,
                       wmask: torch.Tensor) -> torch.Tensor:
    """Batched associative-lookup hamming table int32 [..., N, K]: masked
    distances of every query against every entry
    (``ops.masked_hamming_all``, the batched decide pass's PSU primitive).
    ``entries`` may be the cache snapshot's packed queries or the proposal
    batch itself; ``wmask`` [..., W] may differ per window."""
    from ..kernels import ops

    return ops.masked_hamming_all(q_packed_all, entries, wmask)
