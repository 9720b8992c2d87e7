"""The plain reference of the served TorR path (paper Sec. 3-4, Alg. 1),
written from the algorithm and not from the program: numpy for the
per-proposal cache walk, plain torch for the bulk arithmetic. It imports
nothing of the program and takes no array the program made: it is handed
the run's inputs (``inputs.py``) and, to judge them, the program's outputs.

Two stages, each judged by itself:

  * **encode**: q = pack(sign(R z)), sign(0) -> +1, bit i of word w is
    dimension 32 w + i. :func:`encode_margins` computes y = R z in float64
    and reports, for every bit where the judged words disagree with
    sign(y), its margin |y| / sum_i |R_i z_i|.
  * **step**: the per-stream window loop of Alg. 1 over the judged words
    (so a bit that the encode may legitimately round the other way near
    y = 0 cannot move the rest). :func:`replay` walks each stream's
    windows in the order they were served: load gate H(N, q) and the bank
    choice D' from the window's proposal count and queue depth; per valid
    proposal the nearest cached query (Eq. 5), then bypass, delta or full
    (Alg. 1 lines 2-8), the aligner's scores, the reasoner's gate (top-k
    key and margin against the nearest entry's) and the cache write (LRU
    for full, in place for delta; a bypass refreshes the entry's age).

Eq. 6's delta update is exact: an entry's accumulator is the integer dot
of its own query under its plan tag, and a delta is taken only under the
same tag with every flipped dimension inside the budget, so the corrected
accumulator equals the dot of the new query. The reference therefore takes
every delta and full accumulator as that dot, computed once per proposal
in bulk (exact integer products), and the cache walk carries pointers to
rows instead of copying [M] vectors.

Float arithmetic follows the algorithm's float32 statement: rho = 1 -
2 ham / D'; scores = acc / D'; reasoned = scores * w; margin = top1 - top2
of the scores; |margin - cached| <= eps. ``dtype=torch.bfloat16`` computes
the scores, the reasoned rows and the margins in bfloat16 (the control).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

INT32_MAX = 2 ** 31 - 1
PATH_BYPASS, PATH_DELTA, PATH_FULL = 0, 1, 2


# ---------------------------------------------------------------------------
# bits and words
# ---------------------------------------------------------------------------

def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """int32 words [..., W] -> bool bits [..., 32 W] (dimension 32 w + i is
    bit i of word w)."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1).to(torch.bool)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool bits [..., D] -> int32 words [..., D / 32]."""
    b = bits.reshape(*bits.shape[:-1], -1, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    v = torch.sum(b << shifts, dim=-1)
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def encode(feats: torch.Tensor, R: torch.Tensor, *, tf32: bool = False,
           block: int = 4096) -> torch.Tensor:
    """pack(sign(feats @ R.T)) in float32 (TF32 products with ``tf32``:
    the control's precision). int32 [n, D / 32]."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        out = [pack_bits(feats[i:i + block].to(torch.float32)
                         @ R.to(torch.float32).T >= 0)
               for i in range(0, feats.shape[0], block)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return torch.cat(out) if out else torch.zeros(
        (0, R.shape[0] // 32), dtype=torch.int32, device=R.device)


def encode_margins(feats: torch.Tensor, R: torch.Tensor,
                   words: torch.Tensor, block: int = 2048) -> dict:
    """Judge packed words [n, W] against sign(feats @ R.T) in float64.
    Returns the bits compared, the bits that differ, and the largest margin
    |y| / sum|R_i z_i| of a differing bit (0 when none differ; inf for a
    bit that differs where y = 0 exactly, as on an all-zero row)."""
    R64 = R.to(torch.float64)
    Ra = R64.abs()
    n_diff, worst = 0, 0.0
    for i in range(0, feats.shape[0], block):
        z = feats[i:i + block].to(torch.float64)
        y = z @ R64.T
        diff = unpack_bits(words[i:i + block]) != (y >= 0)
        k = int(diff.sum())
        if k:
            scale = z.abs() @ Ra.T
            r = torch.where(scale > 0, y.abs() / scale.clamp_min(1e-300),
                            torch.full_like(y, float("inf")))
            worst = max(worst, float(torch.where(diff, r, 0.0).max()))
            n_diff += k
    return {"bits": int(feats.shape[0]) * R.shape[0], "differ": n_diff,
            "margin": worst}


# ---------------------------------------------------------------------------
# Alg. 1's load gate and bank choice
# ---------------------------------------------------------------------------

def select_banks(n_valid: int, qd: int, tc: dict) -> int:
    """Largest bank count whose worst case (every proposal full) fits the
    per-window cycle budget clock / fps, shrunk by 1 + q (float32)."""
    budget = (np.float32(tc["clock_hz"] / tc["fps_target"])
              / (np.float32(1.0) + np.float32(qd)))
    mw = -(-tc["M"] // tc["W"])
    n = max(int(n_valid), 1)
    best = 1
    for b in range(1, tc["B"] + 1):
        worst = n * b * (tc["D"] // tc["B"]) * mw + n * (mw + 64)
        if np.float32(worst) <= budget:
            best = b
    return best


def high_load(n_valid: int, qd: int, tc: dict) -> bool:
    """H(N, q) = (N >= N_hi) or (q >= q_hi)."""
    return n_valid >= tc["N_hi"] or qd >= tc["q_hi"]


# ---------------------------------------------------------------------------
# the dot products, in bulk
# ---------------------------------------------------------------------------

def _int_dot(q: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Exact int32 [n, M] = q [n, D] . h [M, D] of int8 codes."""
    n = q.shape[0]
    if n == 0:
        return torch.zeros((0, h.shape[0]), dtype=torch.int32,
                           device=q.device)
    pad = max(n, 17) - n          # _int_mm's shapes: more than 16 rows
    qp = torch.nn.functional.pad(q, (0, 0, 0, pad))
    return torch._int_mm(qp, h.T)[:n]


def dots(words: torch.Tensor, banks: int, codes: torch.Tensor, tc: dict,
         block: int = 8192) -> torch.Tensor:
    """acc int32 [n, M] = <q, h_j> over the first ``banks`` banks'
    dimensions, for packed queries ``words`` [n, W]."""
    d_eff = banks * (tc["D"] // tc["B"])
    out = []
    for i in range(0, words.shape[0], block):
        bits = unpack_bits(words[i:i + block])
        q = torch.where(bits, 1, -1).to(torch.int8)
        q[:, d_eff:] = 0
        out.append(_int_dot(q, codes))
    if not out:
        return torch.zeros((0, codes.shape[0]), dtype=torch.int32,
                           device=codes.device)
    return torch.cat(out)


def readout(acc: torch.Tensor, banks: int, tc: dict, top_k: int,
            dtype=torch.float32, block: int = 8192):
    """(scores [n, M] float32, top-k key int [n, k], margin float32 [n]):
    scores = acc / D' in ``dtype``; the key is the indices of the k largest
    scores, the lower index first among equal ones; margin = top1 - top2,
    in ``dtype``."""
    d_eff = torch.tensor(banks * (tc["D"] // tc["B"]), dtype=torch.float32,
                         device=acc.device)
    s_out, k_out, m_out = [], [], []
    for i in range(0, acc.shape[0], block):
        s = (acc[i:i + block].to(torch.float32) / d_eff).to(dtype)
        vals, idx = torch.sort(s, dim=-1, descending=True, stable=True)
        s_out.append(s.to(torch.float32))
        k_out.append(idx[:, :top_k])
        m_out.append((vals[:, 0] - vals[:, 1]).to(torch.float32))
    if not s_out:
        e = acc.new_zeros
        return (e((0, acc.shape[1]), dtype=torch.float32),
                e((0, top_k), dtype=torch.int64), e((0,), dtype=torch.float32))
    return torch.cat(s_out), torch.cat(k_out), torch.cat(m_out)


# ---------------------------------------------------------------------------
# the cache walk
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Served:
    """One stream's served windows, in the order served: each window's
    content id (a row block of the judged words), its valid mask and the
    queue depth its load gate saw."""
    content: np.ndarray      # int [n_win]
    valid: np.ndarray        # bool [n_win, N_max]
    qd: np.ndarray           # int [n_win]


@dataclasses.dataclass
class Replay:
    """The reference's answer for every served window of every stream, and
    every stream's cache at the end. Score rows are pointers into
    ``rows`` (-1: a zero row)."""
    path: list               # per stream: int8 [n_win, N_max]
    d_count: list            # int32 [n_win, N_max]
    rho: list                # float32 [n_win, N_max]
    out_ptr: list            # int64 [n_win, N_max]
    banks: list              # int [n_win]
    high: list               # bool [n_win]
    cache: dict              # name -> array [S, K, ...]
    rows: dict               # (content, banks) -> first row of its block
    s: torch.Tensor          # float32 [n_rows, M] scores
    key: np.ndarray          # int64 [n_rows, top_k]
    margin: np.ndarray       # float32 [n_rows]
    row_stream: np.ndarray   # int [n_rows] the stream a row belongs to


def _popcount(x: np.ndarray) -> np.ndarray:
    """Set bits of each uint64."""
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(x)
    b = x.view(np.uint8)
    return _LUT[b].reshape(*x.shape, 8).sum(-1)


_LUT = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def replay(tc: dict, codes: torch.Tensor, words: torch.Tensor,
           served: list, row_stream_of_content: np.ndarray,
           dtype=torch.float32) -> Replay:
    """Walk every stream's served windows (``served[s]``) through Alg. 1
    from an empty cache. ``words`` int32 [n_content, N_max, W] holds the
    judged packed queries of each content id; ``row_stream_of_content``
    the stream each content belongs to."""
    S, K, W = len(served), tc["K"], tc["D"] // 32
    bank_words = W // tc["B"]
    top_k = tc["top_k"]
    f32 = np.float32
    tau_byp, tau_q, eps = f32(tc["tau_byp"]), f32(tc["tau_q"]), f32(
        tc["margin_eps"])

    # load gate and bank choice per window; the dot of every valid proposal
    # of every (content, banks) pair the windows need, in bulk
    banks, high, need = [], [], {}
    for sv in served:
        nv = sv.valid.sum(1)
        b = np.array([select_banks(n, q, tc) for n, q in zip(nv, sv.qd)])
        banks.append(b)
        high.append(np.array([high_load(n, q, tc) for n, q in
                              zip(nv, sv.qd)]))
        for c, v, bb in zip(sv.content, sv.valid, b):
            need.setdefault((int(c), int(bb)), v)
    rows, acc_parts, s_parts, k_parts, m_parts, rs = {}, [], [], [], [], []
    n_rows = 0
    by_banks = {}
    for (c, b), v in need.items():
        by_banks.setdefault(b, []).append((c, v))
    for b, items in sorted(by_banks.items()):
        sel = []
        for c, v in items:
            r = np.flatnonzero(v)
            rows[(c, b)] = n_rows
            n_rows += len(r)
            sel.append((c, r))
            rs.append(np.full(len(r), row_stream_of_content[c]))
        idx_c = torch.as_tensor(np.concatenate([np.full(len(r), c) for c, r
                                                in sel]), device=words.device)
        idx_r = torch.as_tensor(np.concatenate([r for _c, r in sel]),
                                device=words.device)
        acc = dots(words[idx_c, idx_r], b, codes, tc)
        s, key, margin = readout(acc, b, tc, top_k, dtype)
        acc_parts.append(acc)
        s_parts.append(s)
        k_parts.append(key)
        m_parts.append(margin)
    acc_all = torch.cat(acc_parts)
    s_all = torch.cat(s_parts)
    key_all = torch.cat(k_parts).cpu().numpy()
    margin_all = torch.cat(m_parts).cpu().numpy()
    row_stream = np.concatenate(rs)
    words_h = words.cpu().numpy().view(np.uint32)

    # the cache of every stream, as pointers: the row that wrote an entry
    # (its query, accumulator, key and margin) and the row whose reasoned
    # scores it holds
    writer = np.full((S, K), -1, np.int64)
    out_ptr = np.full((S, K), -1, np.int64)
    tag = np.zeros((S, K), np.int64)
    age = np.full((S, K), INT32_MAX // 2, np.int64)
    valid_k = np.zeros((S, K), bool)
    cwords = np.zeros((S, K, W // 2), np.uint64)
    zero_key = np.full(top_k, -1, np.int64)

    n_max_win = max(len(sv.content) for sv in served)
    N = tc["N_max"]
    res = {"path": np.zeros((S, n_max_win, N), np.int8),
           "d_count": np.zeros((S, n_max_win, N), np.int32),
           "rho": np.zeros((S, n_max_win, N), np.float32),
           "out_ptr": np.full((S, n_max_win, N), -1, np.int64)}
    s_ix = np.arange(S)
    for t in range(n_max_win):
        live = np.array([t < len(sv.content) for sv in served])
        cont = np.array([sv.content[t] if l else 0
                         for sv, l in zip(served, live)])
        vmask = np.stack([sv.valid[t] if l else np.zeros_like(
            served[0].valid[0]) for sv, l in zip(served, live)])
        bk = np.array([banks[s][t] if live[s] else 1 for s in range(S)])
        hi = np.array([high[s][t] if live[s] else False for s in range(S)])
        d_eff = (bk * (tc["D"] // tc["B"])).astype(np.float32)
        wtag = bk * 256 + tc["bit_planes"]
        base = np.array([rows.get((int(cont[s]), int(bk[s])), 0)
                         for s in range(S)])
        wmask = (np.arange(W) < (bk * bank_words)[:, None])
        wmask64 = np.where(wmask, np.uint32(0xFFFFFFFF), np.uint32(0)) \
            .view(np.uint64).reshape(S, W // 2)
        rank = np.cumsum(vmask, 1) - 1      # a valid row's index among them
        for i in range(vmask.shape[1]):
            v = vmask[:, i]
            if not v.any():
                continue
            q = words_h[cont, i].view(np.uint64)              # [S, W/2]
            x = (cwords ^ q[:, None, :]) & wmask64[:, None, :]
            ham = _popcount(x).sum(-1).astype(np.int64)       # [S, K]
            rho_k = f32(1.0) - f32(2.0) * ham.astype(np.float32) \
                / d_eff[:, None]
            rho_k = np.where(valid_k, rho_k, f32(-np.inf)).astype(np.float32)
            idx = np.argmax(rho_k, 1)
            rho = rho_k[s_ix, idx]
            dcnt = ham[s_ix, idx]
            tag_ok = tag[s_ix, idx] == wtag
            bypass = (rho >= tau_byp) & hi
            delta = (rho >= tau_q) & (dcnt <= tc["delta_budget"]) & tag_ok
            path = np.where(bypass, PATH_BYPASS,
                            np.where(delta, PATH_DELTA, PATH_FULL))
            lru = np.argmax(np.where(valid_k, age, INT32_MAX), 1)
            row = base + rank[:, i]
            w_idx = writer[s_ix, idx]
            ck = np.where((w_idx >= 0)[:, None],
                          key_all[np.maximum(w_idx, 0)], zero_key)
            cm = np.where(w_idx >= 0, margin_all[np.maximum(w_idx, 0)],
                          f32(0.0))
            match = np.all(key_all[row] == ck, 1) & (
                np.abs(margin_all[row] - cm) <= eps)
            hit = out_ptr[s_ix, idx]
            ptr = np.where(path == PATH_BYPASS, hit,
                           np.where(match, hit, row))
            write = v & (path != PATH_BYPASS)
            slot = np.where(path == PATH_FULL, lru, idx)
            bump = v
            age = age + bump[:, None]
            age[s_ix[bump], np.where(path == PATH_BYPASS, idx, slot)[bump]] = 0
            ws = s_ix[write]
            sl = slot[write]
            writer[ws, sl] = row[write]
            out_ptr[ws, sl] = ptr[write]
            tag[ws, sl] = wtag[write]
            valid_k[ws, sl] = True
            cwords[ws, sl] = q[write]
            for k, x in (("path", path), ("d_count", dcnt), ("rho", rho),
                         ("out_ptr", ptr)):
                res[k][s_ix[v], t, i] = x[v]

    # the caches at the end, materialized from the pointers
    wr = np.maximum(writer, 0)
    has = writer >= 0
    acc_h = acc_all.cpu().numpy()
    cache = {
        "packed": np.where(has[..., None],
                           cwords.view(np.int32).reshape(S, K, W), 0),
        "acc": np.where(has[..., None], acc_h[wr], 0),
        "acc_tag": tag.astype(np.int32),
        "out_ptr": out_ptr,
        "topk_key": np.where(has[..., None], key_all[wr], -1),
        "margin": np.where(has, margin_all[wr], f32(0.0)).astype(np.float32),
        "age": age,
        "valid": valid_k,
    }
    n_win = [len(sv.content) for sv in served]
    return Replay(**{k: [res[k][s, :n] for s, n in enumerate(n_win)]
                     for k in res}, banks=banks, high=high,
                  cache=cache, rows=rows, s=s_all, key=key_all,
                  margin=margin_all, row_stream=row_stream)


def reasoned(rep: Replay, ptr: np.ndarray, task_w: torch.Tensor,
             dtype=torch.float32) -> torch.Tensor:
    """The score rows that pointers ``ptr`` [n] name: s[row] * w[stream]
    (in ``dtype``), zeros for -1. float32 [n, M]."""
    p = torch.as_tensor(np.maximum(ptr, 0), device=rep.s.device)
    st = torch.as_tensor(rep.row_stream[np.maximum(ptr, 0)],
                         device=rep.s.device)
    out = (rep.s[p].to(dtype) * task_w[st].to(dtype)).to(torch.float32)
    zero = torch.as_tensor(ptr < 0, device=rep.s.device)
    return torch.where(zero[:, None], 0.0, out)
