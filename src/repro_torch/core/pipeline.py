"""TorR end-to-end window step (port of ``repro.core.pipeline``; paper
Fig. 3/4/5).

One call processes one event window per stream: for each of up to N_max
proposal queries, the PSU finds the nearest cached query, Alg. 1 selects
bypass / delta / full, the associative aligner produces class scores, the
reasoner applies (or gates) task weights, and the query cache is refreshed.
Proposals run in order (a Python loop in place of ``lax.scan``), so later
proposals can hit entries written earlier in the same window.

The port writes the multi-stream batch out as a leading ``[S]`` axis in
place of ``vmap``. ``repro``'s vmapped ``lax.switch`` computes every path
for every stream and selects; so does this loop: at proposal ``i`` the
bypass, delta, full and pad outcomes of all S streams are computed and
``torch.where`` selects each stream's. Every branch is pure, so this is
exact. :func:`torr_window_step` is the same loop at S = 1.

Full-path lowerings (``fused``), all bit-identical:

  * ``"switch"`` (the single-window and serial default): one
    ``fused_scores`` pass per window over the bank choice's words before
    the loop, and Eq. 6 through the ``delta_update`` kernel;
  * ``"prefix"`` (the multi-stream default): the ``bank_prefix_hamming``
    kernel once over the whole step's flattened S x N_max proposal batch;
  * ``"compact"`` (the reuse-aware dispatch): a metadata-only decide pass
    produces every proposal's path first, the bank-prefix scan runs only
    over the full-path proposals compacted into a static ``bucket_cap``
    bucket, and an apply pass replays the decisions. The decide pass is
    the sequential scan (``decide="scan"``, the reference) or the batched
    decide (``"batched"``, the default: two hamming tables from
    ``packed_hamming_batched`` plus a K-sized metadata loop), whose writer
    chains let the apply pass run batched (one Eq. 6 GEMM, one top-k);
  * ``"off"``: the masked full scan per proposal inside the loop — the
    port's own oracle.

``serial=True`` runs the streams one after another through the
single-window step (JAX's ``lax.map``).
"""
from __future__ import annotations

import dataclasses
import warnings

import torch

from ..device import resolve_device
from . import aligner as al
from . import policy, query_cache, reasoner
from .item_memory import ItemMemory, plan_word_mask
from .query_cache import CacheState
from .types import (DECIDE_IDS, DECIDE_NONE, FUSED_IDS, PATH_BYPASS,
                    PATH_DELTA, PATH_FULL, StreamBatch, TorrConfig,
                    WindowTelemetry, map_tensors, plan_tag)

PATH_PAD = 3   # padding proposals: touch nothing, reported as bypass

_FUSED_MODES = ("switch", "prefix", "compact", "off")
_DECIDE_MODES = ("scan", "batched")


@dataclasses.dataclass
class TorrState:
    cache: CacheState
    task_weights: torch.Tensor  # f32 [M] precomputed w_j for the active task


def init_state(cfg: TorrConfig, task_w, device=None) -> TorrState:
    """One stream's state on ``device`` (the card unless the caller asks
    for the CPU)."""
    task_w = torch.as_tensor(task_w).to(device=resolve_device(device),
                                        dtype=torch.float32)
    return TorrState(cache=query_cache.init_cache(cfg, task_w.device),
                     task_weights=task_w)


def init_multi_stream_state(cfg: TorrConfig, task_w,
                            device=None) -> TorrState:
    """Stacked state for S independent streams on ``device`` (the card
    unless the caller asks for the CPU): ``task_w`` f32 [S, M], one
    reasoner-weight row per stream slot; every cache leaf gains [S]."""
    task_w = torch.as_tensor(task_w).to(device=resolve_device(device),
                                        dtype=torch.float32)
    return TorrState(
        cache=query_cache.init_cache_batch(cfg, task_w.shape[0],
                                           task_w.device),
        task_weights=task_w,
    )


@dataclasses.dataclass
class WindowOutput:
    scores: torch.Tensor  # f32 [N_max, M] final task-weighted scores
    best: torch.Tensor    # int32 [N_max] argmax class per proposal
    boxes: torch.Tensor   # f32 [N_max, 4] passthrough proposal boxes


def _resolve_decide(decide) -> str:
    """The compact dispatch's decide-pass lowering: the batched decide by
    default, ``"scan"`` pinning the sequential reference."""
    if decide is None:
        decide = "batched"
    if decide not in _DECIDE_MODES:
        raise ValueError(f"decide={decide!r} not in {_DECIDE_MODES}")
    return decide


def _plan_static(plan, cfg: TorrConfig):
    """Resolve the latched plan to its host knobs: (planes, cap, cfg'), with
    cfg' carrying the plan's tau offsets."""
    if plan is None:
        return cfg.bit_planes, cfg.B, cfg
    plan.validate(cfg)
    return plan.planes, min(plan.banks, cfg.B), plan.thresholds(cfg)


def _resolve_bucket_cap(bucket_cap, plan, n_rows: int) -> int:
    """The compact dispatch's bucket capacity. Precedence: the explicit
    ``bucket_cap`` argument, else the latched plan's ``bucket_cap``, else
    full capacity (no overflow possible, no savings either). A capacity
    above the dispatch's rows is clamped, with a warning: a ladder sized
    for another batch shape should not pass for a deliberate full-capacity
    choice."""
    cap, src = bucket_cap, "bucket_cap"
    if cap is None and plan is not None:
        cap, src = plan.bucket_cap, "plan.bucket_cap"
    if cap is None:
        return n_rows
    cap = int(cap)
    if cap < 1:
        raise ValueError(f"bucket_cap={cap} must be >= 1")
    if cap > n_rows:
        warnings.warn(
            f"{src}={cap} exceeds the dispatch's {n_rows} rows; clamping to "
            f"full capacity (the no-savings tier). The latched ladder was "
            f"likely sized for a different batch shape.",
            stacklevel=3)
        cap = n_rows
    return cap


def _select(conds, candidates, default):
    """Per-stream select among candidate states (dataclasses of [S, ...]
    tensors): stream s takes ``candidates[j]`` for the first j with
    ``conds[j][s]``, else ``default``."""
    fields = {}
    for f in dataclasses.fields(default):
        x = getattr(default, f.name)
        for cond, c in zip(reversed(conds), reversed(candidates)):
            v = getattr(c, f.name)
            x = torch.where(cond.reshape(-1, *([1] * (v.dim() - 1))), v, x)
        fields[f.name] = x
    return type(default)(**fields)


def _window_loop(state: TorrState, im: ItemMemory, q_packed_all, valid,
                 cfg: TorrConfig, banks, high, planes: int, acc_full_all,
                 fused_delta: bool = False, dec=None):
    """The per-proposal FSM over a stream batch ([S] leading axis on every
    argument). ``acc_full_all`` int32 [S, N_max, M] holds the full-path
    accumulators computed before the loop, or is None for the in-loop
    oracle. ``fused_delta`` routes Eq. 6 through the ``delta_update``
    kernel. ``dec`` (the compact dispatch's apply pass) carries the decide
    pass's per-proposal decisions [S, N_max, ...]; the loop then skips the
    PSU and Alg. 1 and only applies them."""
    S = q_packed_all.shape[0]
    dev = q_packed_all.device
    wmask = plan_word_mask(cfg, banks, planes)                     # [S, W]
    d_eff = cfg.d_eff_planned(banks, planes)                       # [S]
    tag = plan_tag(banks, planes).to(torch.int32)                  # [S]
    dmajor_f32 = None if fused_delta else im.dmajor.to(torch.float32)
    task_w = state.task_weights
    s_ix = torch.arange(S, device=dev)

    cache = state.cache
    outs, paths, d_counts, rhos, actives = [], [], [], [], []
    for i in range(cfg.N_max):
        q = q_packed_all[:, i]                                     # [S, W]
        v = valid[:, i]
        if dec is None:
            idx, rho, _ham = query_cache.nearest(cache, q, cfg, banks,
                                                 planes)
            d_idx, d_weight, d_count = al.delta_indices(
                q, cache.packed[s_ix, idx.to(torch.int64)], wmask,
                cfg.delta_budget, cfg.D)
            # Eq. 6 exactness: a cached accumulator is delta-correctable
            # only under the (banks, planes) it was computed with
            tag_ok = cache.acc_tag[s_ix, idx.to(torch.int64)] == tag
            action = policy.select_path(rho, d_count, tag_ok, high, cfg)
            eff = torch.where(v, action, PATH_PAD).to(torch.int32)
            lru = query_cache.lru_slot(cache)
            d_count = torch.where(v, d_count, 0)
            rho = torch.where(v, rho, 0.0)
        else:
            eff, idx, lru, d_idx, d_weight, d_count, rho = (
                x[:, i] for x in dec)
        idx64 = idx.to(torch.int64)
        is_delta, is_full = eff == PATH_DELTA, eff == PATH_FULL

        acc_hit = cache.acc[s_ix, idx64]
        out_hit = cache.out[s_ix, idx64]
        if fused_delta:
            acc_delta = al.delta_apply(acc_hit, im, d_idx, d_weight)
        else:
            acc_delta = al.delta_correct(acc_hit, im, d_idx, d_weight,
                                         dmajor_f32)
        if acc_full_all is None:
            acc_full = al.full_dot(q, im, wmask)
        else:
            acc_full = acc_full_all[:, i]
        # the delta and full branches run the same gate on their own
        # accumulator; the gate is per stream, so gating the selected
        # accumulator equals selecting between the two gated results
        acc = torch.where(is_delta[:, None], acc_delta, acc_full)
        s = al.readout(acc, d_eff[:, None])
        out_w, active, key, margin = reasoner.gate_and_apply(
            s, task_w, out_hit, cache.topk_key[s_ix, idx64],
            cache.margin[s_ix, idx64], cfg)

        written = dict(acc=acc, acc_tag=tag, out=out_w, topk_key=key,
                       margin=margin, packed=q)
        cache = _select(
            [eff == PATH_BYPASS, is_delta, is_full],
            [query_cache.touch(cache, idx),
             query_cache.write_entry(cache, idx, **written),
             query_cache.write_entry(cache, lru, **written)],
            cache)
        out = torch.where((eff == PATH_BYPASS)[:, None], out_hit, out_w)
        outs.append(torch.where((eff == PATH_PAD)[:, None], 0.0, out))
        paths.append(eff)
        d_counts.append(d_count)
        rhos.append(rho)
        actives.append(torch.logical_and(active, is_delta | is_full))

    telem = (torch.stack(paths, 1), torch.stack(d_counts, 1),
             torch.stack(rhos, 1), torch.stack(actives, 1))
    return cache, torch.stack(outs, 1), telem


def _decide_body(cfg: TorrConfig, banks, planes: int, wmask, high):
    """One step of the metadata-only decide pass over a stream batch:
    Alg. 1 for proposal ``i`` of every stream (cache nearest, delta
    feasibility, path choice) and only the metadata updates later
    proposals can observe (packed query, plan tag, age, validity). The
    loop carries a :class:`query_cache.MetaCache`, never the [K, M] value
    arrays; the apply pass replays these decisions."""
    tag = plan_tag(banks, planes).to(torch.int32)

    def body(meta: query_cache.MetaCache, inp):
        q_packed, valid = inp                                      # [S, W]
        s_ix = torch.arange(q_packed.shape[0], device=q_packed.device)
        idx, rho, _ham = query_cache.nearest(meta, q_packed, cfg, banks,
                                             planes)
        idx64 = idx.to(torch.int64)
        d_idx, d_weight, d_count = al.delta_indices(
            q_packed, meta.packed[s_ix, idx64], wmask, cfg.delta_budget,
            cfg.D)
        tag_ok = meta.acc_tag[s_ix, idx64] == tag
        action = policy.select_path(rho, d_count, tag_ok, high, cfg)
        eff = torch.where(valid, action, PATH_PAD).to(torch.int32)
        # the LRU choice the apply pass's full branch makes: both passes
        # see the same age/validity sequence
        lru = query_cache.lru_slot(meta)
        meta = _select(
            [eff == PATH_BYPASS, eff == PATH_DELTA, eff == PATH_FULL],
            [query_cache.meta_touch(meta, idx),
             query_cache.meta_write(meta, idx, packed=q_packed, acc_tag=tag),
             query_cache.meta_write(meta, lru, packed=q_packed,
                                    acc_tag=tag)],
            meta)
        dec = (eff, idx, lru, d_idx, d_weight,
               torch.where(valid, d_count, 0), torch.where(valid, rho, 0.0))
        return meta, dec

    return body


def _decide_pass(cache: CacheState, q_packed_all, valid, cfg: TorrConfig,
                 banks, planes: int, high):
    """The sequential decide pass over a stream batch's windows ([S]
    leading axis); returns the decision 7-tuple (action, idx, lru, d_idx,
    d_weight, d_count, rho), each [S, N_max, ...]. The reference the
    batched decide is held bit-identical to."""
    body = _decide_body(cfg, banks, planes, plan_word_mask(cfg, banks, planes),
                        high)
    meta = query_cache.meta_view(cache)
    decs = []
    for i in range(q_packed_all.shape[1]):
        meta, dec = body(meta, (q_packed_all[:, i], valid[:, i]))
        decs.append(dec)
    return tuple(torch.stack(x, 1) for x in zip(*decs))


def _decide_pass_batched_aux(cache: CacheState, q_packed_all, valid,
                             cfg: TorrConfig, banks, planes: int, high):
    """Batched intra-window decide over a stream batch, bit-identical to
    :func:`_decide_pass`.

    The similarity work leaves the loop: two ``packed_hamming_batched``
    tables over the frozen window-entry snapshot, ``ham_snap`` [S, N, K]
    (every proposal vs every cache entry) and ``ham_prop`` [S, N, N]
    (every proposal vs every proposal: an intra-window write can only
    install an earlier proposal's own query). The loop then carries only
    K-sized metadata — ``writer`` (the proposal that last wrote each slot,
    -1 = snapshot), ``age`` and ``valid`` — and reads slot k's hamming from
    ``ham_snap`` while untouched and from ``ham_prop[writer[k]]`` after a
    write, replaying ``meta_touch``/``meta_write`` update for update, with
    Eq. 5's float32 arithmetic and first-maximum ties. The delta indices
    follow in one pass against each proposal's resolved old entry.

    Returns ``(dec, aux)``: the decision 7-tuple, and the byproducts the
    batched apply pass needs — ``src`` [S, N] (which earlier proposal
    wrote each proposal's nearest slot, -1 = snapshot) and the final
    ``(writer, age, valid)`` [S, K]."""
    S, N, _W = q_packed_all.shape
    dev = q_packed_all.device
    s_ix = torch.arange(S, device=dev)
    wmask = plan_word_mask(cfg, banks, planes)                     # [S, W]
    tag = plan_tag(banks, planes).to(torch.int32)
    meta = query_cache.meta_view(cache)
    ham_snap = query_cache.hamming_all(meta, q_packed_all, cfg, banks,
                                       planes)                  # [S, N, K]
    ham_prop = al.lookup_hamming_all(q_packed_all, q_packed_all,
                                     wmask)                     # [S, N, N]
    d_eff = cfg.d_eff_planned(banks.to(torch.int32),
                              planes).to(torch.float32)[:, None]
    snap_tag_ok = meta.acc_tag == tag[:, None]                     # [S, K]

    writer = torch.full((S, cfg.K), -1, dtype=torch.int32, device=dev)
    age, valid_k = meta.age.clone(), meta.valid.clone()
    cols = {k: [] for k in ("eff", "idx", "lru", "d_count", "rho", "src")}
    for i in range(N):
        live = writer >= 0
        ham_k = torch.where(
            live, torch.gather(ham_prop[:, i], 1,
                               torch.clamp(writer, min=0).to(torch.int64)),
            ham_snap[:, i])                                        # [S, K]
        rho_k = 1.0 - 2.0 * ham_k.to(torch.float32) / d_eff        # Eq. 5
        rho_k = torch.where(valid_k, rho_k, float("-inf"))
        idx = torch.argmax(rho_k, dim=-1)
        rho = rho_k[s_ix, idx]
        d_count = ham_k[s_ix, idx]
        src = writer[s_ix, idx]
        tag_ok = torch.where(live[s_ix, idx], True, snap_tag_ok[s_ix, idx])
        action = policy.select_path(rho, d_count, tag_ok, high, cfg)
        v = valid[:, i]
        eff = torch.where(v, action, PATH_PAD).to(torch.int32)
        lru = torch.argmax(torch.where(valid_k, age, query_cache.INT32_MAX),
                           dim=-1)

        # replay the meta_touch / meta_write metadata updates
        bump = eff != PATH_PAD
        is_write = (eff == PATH_DELTA) | (eff == PATH_FULL)
        slot = torch.where(eff == PATH_FULL, lru, idx)
        age = age + bump.to(torch.int32)[:, None]
        age[s_ix, slot] = torch.where(bump, 0, age[s_ix, slot])
        writer[s_ix, slot] = torch.where(is_write, i, writer[s_ix, slot])
        valid_k[s_ix, slot] = valid_k[s_ix, slot] | is_write
        for k, x in (("eff", eff), ("idx", idx), ("lru", lru),
                     ("d_count", torch.where(v, d_count, 0)),
                     ("rho", torch.where(v, rho, 0.0)), ("src", src)):
            cols[k].append(x)
    eff, idx, lru, d_count, rho, src = (torch.stack(cols[k], 1) for k in cols)
    idx, lru = idx.to(torch.int32), lru.to(torch.int32)

    # one delta-index pass against the resolved old entries
    sn = s_ix[:, None]
    old_packed = torch.where(
        (src < 0)[..., None], cache.packed[sn, idx.to(torch.int64)],
        q_packed_all[sn, torch.clamp(src, min=0).to(torch.int64)])
    d_idx, d_weight, _cnt = al.delta_indices(
        q_packed_all, old_packed, wmask[:, None, :], cfg.delta_budget, cfg.D)
    dec = (eff, idx, lru, d_idx, d_weight, d_count, rho)
    return dec, (src, writer, age, valid_k)


def _apply_pass_batched(state: TorrState, im: ItemMemory, q_packed_all,
                        valid, boxes, queue_depth, cfg: TorrConfig, banks,
                        planes: int, high, n_valid, dec, aux, acc_rows,
                        bucket_tier: int):
    """Batched apply: replay a whole [S, N] dispatch's decisions without
    the per-proposal value loop, bit-identical to it.

      1. Eq. 6 corrections do not depend on the accumulator, so one
         :func:`aligner.delta_corrections` GEMM covers all S x N lanes;
      2. accumulators resolve along writer chains in an N-step loop whose
         step is one [S, M] gather and add (``src`` says whether a proposal
         reads its slot's snapshot row or an earlier proposal's result);
      3. the gate's top-k key and margin depend only on each proposal's own
         scores, so one stable sort covers the dispatch, and the cached key
         and margin each proposal compares against is a ``src`` gather;
      4. gated outputs resolve in a second N-step loop;
      5. the final cache takes each slot's last writer's values (``aux``'s
         writer table) and the decide pass's age and validity.

    Every per-element operation is the one the per-proposal loop runs."""
    eff, idx, _lru, d_idx, d_weight, d_count, rho = dec
    src, writer_f, age_f, valid_f = aux
    cache = state.cache
    S, N, _W = q_packed_all.shape
    M = cfg.M
    sn = torch.arange(S, device=q_packed_all.device)[:, None]

    is_byp, is_full = eff == PATH_BYPASS, eff == PATH_FULL
    is_pad = eff == PATH_PAD
    is_write = (eff == PATH_DELTA) | is_full
    d_eff = cfg.d_eff_planned(banks, planes)                       # [S]
    tag = plan_tag(banks, planes).to(torch.int32)                  # [S]
    corr = al.delta_corrections(d_idx.reshape(S * N, -1),
                                d_weight.reshape(S * N, -1),
                                im).reshape(S, N, M)

    idx64 = idx.to(torch.int64)
    snap_acc, snap_out = cache.acc[sn, idx64], cache.out[sn, idx64]
    snap_key, snap_margin = cache.topk_key[sn, idx64], cache.margin[sn, idx64]
    src_safe = torch.clamp(src, min=0).to(torch.int64)
    from_snap = src < 0

    acc_res = torch.zeros((S, N, M), dtype=torch.int32,
                          device=q_packed_all.device)
    for i in range(N):
        read = torch.where(from_snap[:, i, None], snap_acc[:, i],
                           acc_res[sn[:, 0], src_safe[:, i]])
        acc_res[:, i] = torch.where(is_full[:, i, None], acc_rows[:, i],
                                    read + corr[:, i])

    s_all = al.readout(acc_res, d_eff[:, None, None])              # [S, N, M]
    key_all, margin_all = reasoner.topk_key_margin(s_all, cfg)
    cached_key = torch.where(from_snap[..., None], snap_key,
                             key_all[sn, src_safe])
    cached_margin = torch.where(from_snap, snap_margin,
                                margin_all[sn, src_safe])
    eps = torch.tensor(cfg.margin_eps, dtype=torch.float32,
                       device=s_all.device)
    match = torch.logical_and(
        torch.all(key_all == cached_key, dim=-1),
        torch.abs(margin_all - cached_margin) <= eps)
    reasoned = s_all * state.task_weights[:, None, :]
    active = torch.logical_and(is_write, torch.logical_not(match))

    out_res = torch.zeros((S, N, M), dtype=torch.float32,
                          device=q_packed_all.device)
    outs = []
    for i in range(N):
        read = torch.where(from_snap[:, i, None], snap_out[:, i],
                           out_res[sn[:, 0], src_safe[:, i]])
        out_w = torch.where(match[:, i, None], read, reasoned[:, i])
        outs.append(torch.where(
            is_pad[:, i, None], 0.0,
            torch.where(is_byp[:, i, None], read, out_w)))
        out_res[:, i] = out_w

    written = writer_f >= 0                                        # [S, K]
    wsafe = torch.clamp(writer_f, min=0).to(torch.int64)

    def last_write(arr_prop, arr_snap):
        w = written.reshape(*written.shape,
                            *([1] * (arr_snap.dim() - 2)))
        return torch.where(w, arr_prop[sn, wsafe], arr_snap)

    cache = CacheState(
        packed=last_write(q_packed_all, cache.packed),
        acc=last_write(acc_res, cache.acc),
        acc_tag=torch.where(written, tag[:, None], cache.acc_tag),
        out=last_write(out_res, cache.out),
        topk_key=last_write(key_all, cache.topk_key),
        margin=last_write(margin_all, cache.margin),
        age=age_f,
        valid=valid_f,
    )
    telem = (eff, d_count, rho, active)
    return _finish_window(cache, state.task_weights, torch.stack(outs, 1),
                          telem, valid, boxes, queue_depth, banks, n_valid,
                          high, planes, FUSED_IDS["compact"],
                          DECIDE_IDS["batched"], bucket_tier)


def _finish_window(cache, task_w, outs, telem, valid, boxes, queue_depth,
                   banks, n_valid, high, planes, fused_mode=FUSED_IDS["off"],
                   decide_mode=DECIDE_NONE, bucket_tier=0):
    """Assemble (state, output, telemetry) from one window's loop results."""
    actions, d_counts, rhos, active = telem
    lead = banks.shape

    def const(x):
        return torch.full(lead, x, dtype=torch.int32, device=banks.device)

    telemetry = WindowTelemetry(
        path=torch.where(actions == PATH_PAD, PATH_BYPASS,
                         actions).to(torch.int32),
        delta_count=d_counts.to(torch.int32),
        banks=banks,
        rho=rhos.to(torch.float32),
        n_valid=n_valid,
        reasoner_active=torch.logical_and(active, valid),
        queue_depth=queue_depth.to(torch.int32),
        high_load=high,
        planes=const(planes),
        fused_mode=const(fused_mode),
        decide_mode=const(decide_mode),
        bucket_tier=const(bucket_tier),
    )
    out = WindowOutput(
        scores=outs,
        best=torch.argmax(outs, dim=-1).to(torch.int32),
        boxes=boxes,
    )
    return TorrState(cache=cache, task_weights=task_w), out, telemetry


def _as_batch(q_packed_all, valid, boxes, queue_depth, device):
    q = torch.as_tensor(q_packed_all, device=device)
    if q.dtype != torch.int32:
        raise TypeError(f"packed queries must be int32 words, got {q.dtype} "
                        "(convert.words_from_numpy takes uint32)")
    return (q, torch.as_tensor(valid, device=device).to(torch.bool),
            torch.as_tensor(boxes, device=device).to(torch.float32),
            torch.as_tensor(queue_depth, device=device).to(torch.int32))


def _load_gates(valid, queue_depth, cfg: TorrConfig, plan):
    """(n_valid, high, banks), each [S]: Alg. 1's per-stream load gating,
    the bank choice capped by the latched plan where its cap binds."""
    n_valid = torch.sum(valid, dim=-1, dtype=torch.int32)
    banks = policy.select_banks(n_valid, queue_depth, cfg)
    if plan is not None and plan.banks < cfg.B:
        banks = torch.clamp(banks, max=plan.banks)
    return n_valid, policy.high_load(n_valid, queue_depth, cfg), banks


def _multi_stream_compact_step(state: TorrState, im: ItemMemory, q, v, b,
                               qd, cfg: TorrConfig, *, serial: bool, plan,
                               bucket_cap, decide):
    """The compact-then-compute lowering (``fused="compact"``):

      1. decide: the metadata-only Alg. 1 pass over every stream (it reads
         the depth-K cache, never the item memory);
      2. compact + compute: the full-path rows of all S windows share one
         static bucket, and one bank-prefix pass scans only the bucket
         (``aligner.compact_full_scores``);
      3. apply: the batched apply when the decide pass was batched, else
         (or when ``serial``) the per-proposal loop replays the decisions,
         gathering full-path accumulators from the bucket and applying
         Eq. 6 through the ``delta_update`` kernel.

    The latched ``plan`` sets the planes and bank cap of every pass and the
    tau offsets of the decide pass."""
    planes, cap, cfg = _plan_static(plan, cfg)
    S, N, W = q.shape
    bcap = _resolve_bucket_cap(bucket_cap, plan, S * N)
    n_valid, high, banks = _load_gates(v, qd, cfg, plan)
    decide_mode = _resolve_decide(decide)
    aux = None
    if decide_mode == "batched":
        dec, aux = _decide_pass_batched_aux(state.cache, q, v, cfg, banks,
                                            planes, high)
    else:
        dec = _decide_pass(state.cache, q, v, cfg, banks, planes, high)
    acc_rows = al.compact_full_scores(
        q.reshape(S * N, W), (dec[0] == PATH_FULL).reshape(S * N),
        banks[:, None].expand(S, N).reshape(S * N), im, cfg, planes=planes,
        cap=cap, bucket_cap=bcap).reshape(S, N, cfg.M)
    if aux is not None and not serial:
        return _apply_pass_batched(state, im, q, v, b, qd, cfg, banks,
                                   planes, high, n_valid, dec, aux, acc_rows,
                                   bcap)
    cache, outs, telem = _window_loop(state, im, q, v, cfg, banks, high,
                                      planes, acc_rows, fused_delta=True,
                                      dec=dec)
    return _finish_window(cache, state.task_weights, outs, telem, v, b, qd,
                          banks, n_valid, high, planes,
                          fused_mode=FUSED_IDS["compact"],
                          decide_mode=DECIDE_IDS[decide_mode],
                          bucket_tier=bcap)


def _stack(items):
    """Stack a list of same-typed dataclasses of tensors along a new [S]."""
    first = items[0]
    return dataclasses.replace(first, **{
        f.name: (_stack([getattr(x, f.name) for x in items])
                 if dataclasses.is_dataclass(getattr(first, f.name))
                 else torch.stack([getattr(x, f.name) for x in items]))
        for f in dataclasses.fields(first)})


def torr_multi_stream_step(state: TorrState, im: ItemMemory, q_packed_all,
                           valid, boxes, queue_depth, cfg: TorrConfig,
                           serial: bool = False, plan=None, fused=None,
                           bucket_cap=None, decide=None):
    """One step over S streams' windows: ``q_packed_all`` int32 [S, N_max,
    D//32], ``valid`` bool [S, N_max], ``boxes`` f32 [S, N_max, 4],
    ``queue_depth`` int32 [S]; every state leaf has a leading [S] axis.

    Semantically identical to running :func:`torr_window_step` once per
    stream: each slot keeps its own cache, task weights and queue depth, so
    Alg. 1's load gating (H, D') is per stream; idle slots (``valid``
    all-False) leave their cache intact. ``fused`` defaults per lowering:
    ``"prefix"`` for the batched step (the bank-prefix kernel hoisted over
    the flattened S x N_max batch), ``"switch"`` for ``serial=True`` (a
    loop over the slots of the single-window step). ``"compact"`` takes
    ``bucket_cap`` (None = the plan's ``bucket_cap``, else full capacity)
    and ``decide`` (None = ``"batched"``); the other lowerings ignore both,
    as ``repro`` does.

    ``plan`` is a :class:`~repro_torch.control.plan.KnobPlan` latched for
    the whole step (None = uncontrolled): it caps Alg. 1's bank choice
    (``min``; the full cap is a bit-exact no-op), selects the bit-slice
    planes every scan reads, and offsets the tau thresholds; each window's
    telemetry records the ``banks`` and ``planes`` it ran with. The state
    passed in is not modified."""
    if fused is None:
        fused = "switch" if serial else "prefix"
    if fused not in _FUSED_MODES:
        raise ValueError(f"fused={fused!r} not in {_FUSED_MODES}")
    q, v, b, qd = _as_batch(q_packed_all, valid, boxes, queue_depth,
                            im.device)
    if fused == "compact":
        return _multi_stream_compact_step(state, im, q, v, b, qd, cfg,
                                          serial=serial, plan=plan,
                                          bucket_cap=bucket_cap,
                                          decide=decide)
    if serial:
        steps = []
        for s in range(q.shape[0]):
            one = TorrState(cache=map_tensors(lambda x: x[s], state.cache),
                            task_weights=state.task_weights[s])
            steps.append(torr_window_step(one, im, q[s], v[s], b[s], qd[s],
                                          cfg, plan=plan, fused=fused))
        return tuple(_stack(list(x)) for x in zip(*steps))
    planes, cap, cfg = _plan_static(plan, cfg)
    n_valid, high, banks = _load_gates(v, qd, cfg, plan)
    acc_full_all = None
    if fused != "off":
        acc_full_all = al.full_scores_all(q, im, banks, cfg, planes=planes,
                                          cap=cap, mode=fused)
    cache, outs, telem = _window_loop(state, im, q, v, cfg, banks, high,
                                      planes, acc_full_all,
                                      fused_delta=fused == "switch")
    return _finish_window(cache, state.task_weights, outs, telem, v, b, qd,
                          banks, n_valid, high, planes,
                          fused_mode=FUSED_IDS[fused])


def torr_window_step(state: TorrState, im: ItemMemory, q_packed_all, valid,
                     boxes, queue_depth, cfg: TorrConfig, plan=None,
                     fused=None, bucket_cap=None, decide=None):
    """Process one window; returns (new_state, detections, telemetry).

    ``q_packed_all`` int32 [N_max, D//32], ``valid`` bool [N_max], ``boxes``
    f32 [N_max, 4], ``queue_depth`` int32 []. ``fused`` picks the full
    path's lowering: ``"switch"`` (the default: ``fused_scores`` on the
    window's bank choice, Eq. 6 through ``delta_update``), ``"prefix"``,
    ``"compact"`` (with ``bucket_cap`` and ``decide``) or ``"off"`` (the
    per-proposal oracle); all are bit-identical to ``repro``'s every
    lowering, under any latched ``plan`` (see
    :func:`torr_multi_stream_step`)."""
    if fused is None:
        fused = "switch"
    q, v, b, qd = _as_batch(q_packed_all, valid, boxes, queue_depth,
                            im.device)
    one = TorrState(cache=map_tensors(lambda x: x[None], state.cache),
                    task_weights=state.task_weights[None])
    st, out, tel = torr_multi_stream_step(
        one, im, q[None], v[None], b[None], qd[None], cfg, plan=plan,
        fused=fused, bucket_cap=bucket_cap, decide=decide)
    return (TorrState(cache=map_tensors(lambda x: x[0], st.cache),
                      task_weights=st.task_weights[0]),
            map_tensors(lambda x: x[0], out),
            map_tensors(lambda x: x[0], tel))


def torr_stream_batch_step(state: TorrState, im: ItemMemory,
                           batch: StreamBatch, cfg: TorrConfig,
                           serial: bool = False, plan=None, fused=None,
                           bucket_cap=None, decide=None):
    """:func:`torr_multi_stream_step` over a packed :class:`StreamBatch`."""
    return torr_multi_stream_step(
        state, im, batch.q_packed, batch.valid, batch.boxes,
        batch.queue_depth, cfg, serial=serial, plan=plan, fused=fused,
        bucket_cap=bucket_cap, decide=decide)
