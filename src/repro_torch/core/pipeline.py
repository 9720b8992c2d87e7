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

Full-path lowerings (``fused``): ``"prefix"`` (the multi-stream default)
runs the ``bank_prefix_hamming`` kernel once over the whole step's
flattened S x N_max proposal batch before the loop; ``"off"`` computes the
masked full scan per proposal inside the loop — the port's own oracle,
which the kernel path is tested bit-identical against.
"""
from __future__ import annotations

import dataclasses

import torch

from . import aligner as al
from . import policy, query_cache, reasoner
from .item_memory import ItemMemory, plan_word_mask
from .query_cache import CacheState
from .types import (DECIDE_NONE, FUSED_IDS, PATH_BYPASS, PATH_DELTA,
                    PATH_FULL, StreamBatch, TorrConfig, WindowTelemetry,
                    map_tensors, plan_tag)

PATH_PAD = 3   # padding proposals: touch nothing, reported as bypass

_PORTED_FUSED = ("prefix", "off")


@dataclasses.dataclass
class TorrState:
    cache: CacheState
    task_weights: torch.Tensor  # f32 [M] precomputed w_j for the active task


def init_state(cfg: TorrConfig, task_w, device="cpu") -> TorrState:
    task_w = torch.as_tensor(task_w).to(device=device, dtype=torch.float32)
    return TorrState(cache=query_cache.init_cache(cfg, task_w.device),
                     task_weights=task_w)


def init_multi_stream_state(cfg: TorrConfig, task_w, device="cpu") -> TorrState:
    """Stacked state for S independent streams: ``task_w`` f32 [S, M], one
    reasoner-weight row per stream slot; every cache leaf gains [S]."""
    task_w = torch.as_tensor(task_w).to(device=device, dtype=torch.float32)
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


def _check_lowering(fused, plan, serial=False, decide=None) -> str:
    if fused is None:
        fused = "prefix"
    if plan is not None:
        raise NotImplementedError(
            "a latched KnobPlan comes with the control-plane part of the "
            "port (ROADMAP Queue 1 item 7); pass plan=None")
    if serial:
        raise NotImplementedError(
            "serial=True (the lax.map lowering with fused='switch') comes "
            "with a later part of the port (ROADMAP Queue 1 item 4)")
    if decide is not None or fused == "compact":
        raise NotImplementedError(
            "fused='compact' and its decide pass come with the compact "
            "dispatch part of the port (ROADMAP Queue 1 item 5)")
    if fused == "switch":
        raise NotImplementedError(
            "fused='switch' (fused_scores + delta_update kernels) comes with "
            "a later part of the port (ROADMAP Queue 1 item 3)")
    if fused not in _PORTED_FUSED:
        raise ValueError(f"fused={fused!r} not in {_PORTED_FUSED}")
    return fused


def _select_cache(conds, caches, default: CacheState) -> CacheState:
    """Per-stream select among candidate caches: stream s takes
    ``caches[j]`` for the first j with ``conds[j][s]``, else ``default``."""
    fields = {}
    for f in dataclasses.fields(CacheState):
        x = getattr(default, f.name)
        for cond, c in zip(reversed(conds), reversed(caches)):
            v = getattr(c, f.name)
            x = torch.where(cond.reshape(-1, *([1] * (v.dim() - 1))), v, x)
        fields[f.name] = x
    return CacheState(**fields)


def _window_loop(state: TorrState, im: ItemMemory, q_packed_all, valid,
                 cfg: TorrConfig, banks, high, planes: int, acc_full_all):
    """The per-proposal FSM over a stream batch ([S] leading axis on every
    argument). ``acc_full_all`` int32 [S, N_max, M] holds the hoisted
    kernel's full-path accumulators, or is None for the in-loop oracle."""
    S = q_packed_all.shape[0]
    dev = q_packed_all.device
    wmask = plan_word_mask(cfg, banks, planes)                     # [S, W]
    d_eff = cfg.d_eff_planned(banks, planes)                       # [S]
    tag = plan_tag(banks, planes).to(torch.int32)                  # [S]
    dmajor_f32 = im.dmajor.to(torch.float32)
    task_w = state.task_weights
    s_ix = torch.arange(S, device=dev)

    cache = state.cache
    outs, paths, d_counts, rhos, actives = [], [], [], [], []
    for i in range(cfg.N_max):
        q = q_packed_all[:, i]                                     # [S, W]
        v = valid[:, i]
        idx, rho, _ham = query_cache.nearest(cache, q, cfg, banks, planes)
        idx64 = idx.to(torch.int64)
        d_idx, d_weight, d_count = al.delta_indices(
            q, cache.packed[s_ix, idx64], wmask, cfg.delta_budget, cfg.D)
        # Eq. 6 exactness: a cached accumulator is delta-correctable only
        # under the (banks, planes) it was computed with
        tag_ok = cache.acc_tag[s_ix, idx64] == tag
        action = policy.select_path(rho, d_count, tag_ok, high, cfg)
        eff = torch.where(v, action, PATH_PAD).to(torch.int32)
        is_delta, is_full = eff == PATH_DELTA, eff == PATH_FULL

        acc_hit = cache.acc[s_ix, idx64]
        out_hit = cache.out[s_ix, idx64]
        acc_delta = al.delta_correct(acc_hit, im, d_idx, d_weight, dmajor_f32)
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

        lru = query_cache.lru_slot(cache)
        written = dict(acc=acc, acc_tag=tag, out=out_w, topk_key=key,
                       margin=margin, packed=q)
        cache = _select_cache(
            [eff == PATH_BYPASS, is_delta, is_full],
            [query_cache.touch(cache, idx),
             query_cache.write_entry(cache, idx, **written),
             query_cache.write_entry(cache, lru, **written)],
            cache)
        out = torch.where((eff == PATH_BYPASS)[:, None], out_hit, out_w)
        outs.append(torch.where((eff == PATH_PAD)[:, None], 0.0, out))
        paths.append(eff)
        d_counts.append(torch.where(v, d_count, 0))
        rhos.append(torch.where(v, rho, 0.0))
        actives.append(torch.logical_and(active, is_delta | is_full))

    telem = (torch.stack(paths, 1), torch.stack(d_counts, 1),
             torch.stack(rhos, 1), torch.stack(actives, 1))
    return cache, torch.stack(outs, 1), telem


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


def torr_multi_stream_step(state: TorrState, im: ItemMemory, q_packed_all,
                           valid, boxes, queue_depth, cfg: TorrConfig,
                           serial: bool = False, plan=None, fused=None,
                           decide=None):
    """One step over S streams' windows: ``q_packed_all`` int32 [S, N_max,
    D//32], ``valid`` bool [S, N_max], ``boxes`` f32 [S, N_max, 4],
    ``queue_depth`` int32 [S]; every state leaf has a leading [S] axis.

    Semantically identical to running :func:`torr_window_step` once per
    stream: each slot keeps its own cache, task weights and queue depth, so
    Alg. 1's load gating (H, D') is per stream; idle slots (``valid``
    all-False) leave their cache intact. ``fused="prefix"`` (the default)
    hoists the bank-prefix kernel over the flattened S x N_max batch, so
    the item memory is scanned once per step; ``"off"`` is the oracle.
    The state passed in is not modified."""
    fused = _check_lowering(fused, plan, serial, decide)
    planes, cap = cfg.bit_planes, cfg.B
    q, v, b, qd = _as_batch(q_packed_all, valid, boxes, queue_depth,
                            im.device)
    n_valid = torch.sum(v, dim=-1, dtype=torch.int32)              # [S]
    high = policy.high_load(n_valid, qd, cfg)                      # [S]
    banks = policy.select_banks(n_valid, qd, cfg)                  # [S]
    acc_full_all = None
    if fused == "prefix":      # one kernel pass over all S x N_max rows
        acc_full_all = al.full_scores_all(q, im, banks, cfg, planes=planes,
                                          cap=cap)
    cache, outs, telem = _window_loop(state, im, q, v, cfg, banks, high,
                                      planes, acc_full_all)
    return _finish_window(cache, state.task_weights, outs, telem, v, b, qd,
                          banks, n_valid, high, planes,
                          fused_mode=FUSED_IDS[fused])


def torr_window_step(state: TorrState, im: ItemMemory, q_packed_all, valid,
                     boxes, queue_depth, cfg: TorrConfig, plan=None,
                     fused=None, decide=None):
    """Process one window; returns (new_state, detections, telemetry).

    ``q_packed_all`` int32 [N_max, D//32], ``valid`` bool [N_max], ``boxes``
    f32 [N_max, 4], ``queue_depth`` int32 []. ``fused`` picks the full
    path's lowering: ``"prefix"`` (default here: the bank-prefix kernel over
    the window's proposals) or ``"off"`` (the per-proposal oracle); both are
    bit-identical to ``repro``'s every lowering."""
    fused = _check_lowering(fused, plan, False, decide)
    q, v, b, qd = _as_batch(q_packed_all, valid, boxes, queue_depth,
                            im.device)
    one = TorrState(cache=map_tensors(lambda x: x[None], state.cache),
                    task_weights=state.task_weights[None])
    st, out, tel = torr_multi_stream_step(one, im, q[None], v[None], b[None],
                                          qd[None], cfg, fused=fused)
    return (TorrState(cache=map_tensors(lambda x: x[0], st.cache),
                      task_weights=st.task_weights[0]),
            map_tensors(lambda x: x[0], out),
            map_tensors(lambda x: x[0], tel))


def torr_stream_batch_step(state: TorrState, im: ItemMemory,
                           batch: StreamBatch, cfg: TorrConfig,
                           serial: bool = False, plan=None, fused=None,
                           decide=None):
    """:func:`torr_multi_stream_step` over a packed :class:`StreamBatch`."""
    return torr_multi_stream_step(
        state, im, batch.q_packed, batch.valid, batch.boxes,
        batch.queue_depth, cfg, serial=serial, plan=plan, fused=fused,
        decide=decide)
