"""The comparison that decides ``correct``.

What the timed path produced (the packed words of each distinct window's
first submission and of a sample of the repeats drawn from the seed, on
the card; each delivered window's result; every slot's cache after the
last step) is judged against the plain reference (``reference.py``), which is
handed the run's inputs. Numbers compared, each against a limit that the
configuration file states:

  * ``missing``: windows submitted that never delivered a result (shed,
    failed, or not delivered within the drain's wait);
  * ``enc_margin``: the largest margin |y| / sum|R_i z_i| of a bit where
    the program's words differ from sign(y), y = R z in float64, over the
    encodes of a sample of the distinct windows drawn from the seed (all
    of them up to ``ENCODE_ROWS`` proposal rows); an all-zero padding row
    must encode to all ones;
  * ``mismatch``: per window, the path, |Delta| and rho of every proposal,
    the best class of every row, the proposal count, the bank choice and
    the load gate; and every field of every slot's cache at the end: the
    count of those that differ from the reference's walk over the same
    words and queue depths;
  * ``score_err``: the largest |score - reference| over every valid
    proposal's scores of every delivered window and every cached score
    row at the end, and the nonzero scores of padding rows.
"""
from __future__ import annotations

import numpy as np
import torch

from . import reference as ref

ENCODE_ROWS = 16384
NUMBERS = ("missing", "enc_margin", "mismatch", "score_err")


def _contents(windows, S: int, Wn: int, device):
    """Content ids of every submission: the first submission of a distinct
    window (s, j) names it; a later one whose words were kept and differ
    gets an id of its own, and one whose words were not kept takes the
    first's (its results are still judged against the reference's walk
    over those words). Returns (words [U, N_max, W], content ids per stream,
    (stream, j) per content)."""
    first, extra = {}, []
    pairs = []                                   # (window, canon key)
    for ws in windows:
        for w in ws:
            if w.words is None:
                continue
            key = (w.stream, w.j)
            if key not in first:
                first[key] = w.words
            else:
                pairs.append((w, key))
    keys = sorted(first)
    cid = {k: i for i, k in enumerate(keys)}
    origin = list(keys)
    words = [first[k] for k in keys]
    same = []
    for i in range(0, len(pairs), 256):
        chunk = pairs[i:i + 256]
        a = torch.stack([w.words for w, _ in chunk])
        b = torch.stack([first[k] for _, k in chunk])
        same.append((a == b).flatten(1).all(1))
    same = torch.cat(same).cpu().numpy() if same else np.zeros(0, bool)
    sub_cid = {}
    for (w, key), eq in zip(pairs, same):
        if eq:
            sub_cid[id(w)] = cid[key]
        else:
            sub_cid[id(w)] = len(origin)
            origin.append(key)
            words.append(w.words)
    ids = []
    for ws in windows:
        ids.append(np.array([
            sub_cid.get(id(w), cid.get((w.stream, w.j), -1)) for w in ws],
            np.int64))
    if not words:
        return None, ids, origin
    return torch.stack(words).to(device), ids, origin


def _count(a, b) -> int:
    """Elements where ``a`` and ``b`` differ (float32 compared bit for bit,
    so -inf equals -inf)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        a = np.asarray(a, np.float32).view(np.int32)
        b = np.asarray(b, np.float32).view(np.int32)
    return int(np.count_nonzero(a != b))


def check(inp, windows, cache_prog: dict, tc: dict, seed: int, device,
          dtype=torch.float32) -> dict:
    """The numbers compared, for a run's ``windows`` (per stream, in
    submission order) and its final cache; ``dtype`` is the reference's
    precision (float32; lower for a control's own outputs, which it never
    judges)."""
    dev = torch.device(device)
    S, Wn = inp.valid.shape[:2]
    words, ids, origin = _contents(windows, S, Wn, dev)
    out = {k: 0 for k in NUMBERS}
    out["windows"] = sum(len(ws) for ws in windows)
    missing = sum(1 for ws in windows for w in ws if not w.ok)
    out["missing"] = missing
    if words is None:
        out["mismatch"] = out["windows"]
        return out
    o_s = np.array([s for s, _j in origin])
    o_j = np.array([j for _s, j in origin])

    # encode: padding rows all ones; a sample of contents against float64
    vmask = torch.as_tensor(inp.valid[o_s, o_j], device=dev)
    pad_bad = int(((words != -1) & ~vmask[..., None]).sum())
    rng = np.random.default_rng(seed % 2 ** 63)
    order = rng.permutation(len(origin))
    nv = inp.valid[o_s, o_j].sum(1)
    take = order[np.cumsum(nv[order]) <= ENCODE_ROWS]
    if len(take) == 0:
        take = order[:1]
    sel_c = np.repeat(take, nv[take])
    sel_r = np.concatenate([np.flatnonzero(inp.valid[o_s[c], o_j[c]])
                            for c in take])
    feats = inp.feats[torch.as_tensor(o_s[sel_c], device=inp.feats.device),
                      torch.as_tensor(o_j[sel_c], device=inp.feats.device),
                      torch.as_tensor(sel_r, device=inp.feats.device)]
    enc = ref.encode_margins(feats.to(dev), inp.R.to(dev),
                             words[torch.as_tensor(sel_c, device=dev),
                                   torch.as_tensor(sel_r, device=dev)])
    out["enc_margin"] = float("inf") if pad_bad else enc["margin"]
    out["enc_bits"], out["enc_differ"] = enc["bits"], enc["differ"]

    # the step: the reference's walk over the same words and queue depths
    served = []
    for s, ws in enumerate(windows):
        served.append(ref.Served(
            content=np.maximum(ids[s], 0),
            valid=np.stack([inp.valid[s, w.j] for w in ws]) if ws else
            np.zeros((0, tc["N_max"]), bool),
            qd=np.array([w.qd if w.ok else 0 for w in ws], np.int64)))
    rep = ref.replay(tc, inp.codes.to(dev), words, served, o_s, dtype=dtype)
    task_w = inp.task_w.to(dev)
    mism, err = 0, 0.0
    prog_rows, ref_ptr = [], []
    for s, ws in enumerate(windows):
        ok = np.array([w.ok for w in ws], bool)
        if not ok.any():
            continue
        okw = [w for w in ws if w.ok]
        valid = served[s].valid[ok]
        for name, attr in (("path", "path"), ("d_count", "d_count"),
                           ("rho", "rho")):
            mism += _count(np.stack([getattr(w, attr) for w in okw]),
                           getattr(rep, name)[s][ok])
        mism += _count([w.n_valid for w in okw], valid.sum(1))
        mism += _count([w.banks for w in okw], rep.banks[s][ok])
        mism += _count([w.high for w in okw], rep.high[s][ok])
        mism += sum(w.pad_nonzero for w in okw)
        best = np.stack([w.best for w in okw])
        mism += int(np.count_nonzero(best[~valid]))
        prog_rows.append((np.concatenate([w.scores for w in okw]),
                          best[valid]))
        ref_ptr.append(rep.out_ptr[s][ok][valid])
    for (rows, best), ptr in zip(prog_rows, ref_ptr):
        for i in range(0, len(ptr), 8192):
            r = ref.reasoned(rep, ptr[i:i + 8192], task_w, dtype)
            p = torch.as_tensor(rows[i:i + 8192], device=dev)
            if p.shape != r.shape:
                mism += len(ptr)
                break
            err = max(err, float((p - r).abs().max()) if len(p) else 0.0)
            mism += _count(best[i:i + 8192],
                           torch.argmax(r, 1).cpu().numpy())

    # every slot's cache at the end (stream s holds slot s)
    c = rep.cache
    K = tc["K"]
    pc = {k: v[:S] for k, v in cache_prog.items()}
    for name in ("packed", "acc", "acc_tag", "topk_key", "margin", "age",
                 "valid"):
        mism += _count(pc[name], c[name])
    r = ref.reasoned(rep, c["out_ptr"].reshape(-1), task_w, dtype)
    p = torch.as_tensor(pc["out"].reshape(S * K, -1), device=dev)
    err = max(err, float((p - r).abs().max()))
    out["mismatch"] = mism
    out["score_err"] = err
    out["_rep"] = rep
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for the numbers compared."""
    shown = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in shown.values())
    return ok, shown
