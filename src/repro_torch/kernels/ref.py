"""Plain PyTorch versions of the port's kernels (shape/dtype-exact).

Each wrapper in ``kernels.fused_window`` takes these for tensors that lie on
the CPU, the tests hold them against ``repro.kernels.ref`` and the JAX
kernels, and ``chip_smoke.py`` holds each CUDA kernel against them on the
card. Packed words are int32 bit patterns (``core.hdc``).
"""
from __future__ import annotations

import torch

from ..core import hdc

# Rows of q per chunk are chosen so one chunk's [rows, M, W] xor stays near
# this many words: the plain versions never materialize the whole [N, M, W]
# intermediate (2^29 words at the edge config's hoisted batch).
_CHUNK_WORDS = 1 << 22


def _row_chunks(N: int, M: int, W: int):
    rows = max(1, _CHUNK_WORDS // max(1, M * W))
    for n0 in range(0, N, rows):
        yield n0, min(N, n0 + rows)


INT32_MIN = -(2 ** 31)


def packed_hamming_ref(q_packed: torch.Tensor,
                       im_packed: torch.Tensor) -> torch.Tensor:
    """int32 [N, M] hamming distances from packed words; with a leading
    batch axis on both ([S, N, W], [S, M, W]) int32 [S, N, M] —
    ``xnor_popcount_sim.packed_hamming_batched``."""
    if q_packed.dim() == 3:
        out = torch.empty((*q_packed.shape[:2], im_packed.shape[1]),
                          dtype=torch.int32, device=q_packed.device)
        for s in range(q_packed.shape[0]):
            out[s] = packed_hamming_ref(q_packed[s], im_packed[s])
        return out
    N, W = q_packed.shape
    M = im_packed.shape[0]
    out = torch.empty((N, M), dtype=torch.int32, device=q_packed.device)
    for n0, n1 in _row_chunks(N, M, W):
        x = q_packed[n0:n1, None, :] ^ im_packed[None, :, :]
        out[n0:n1] = torch.sum(hdc.popcount32(x), dim=-1, dtype=torch.int32)
    return out


def fused_scores_ref(q_packed: torch.Tensor, im_packed: torch.Tensor, *,
                     d_eff: int):
    """(acc [N, M], best [N], top2 [N, 2]) — ``fused_window.fused_scores``:
    ``acc = d_eff - 2*hamming``, ``best`` the first argmax, ``top2`` the two
    largest values (``lax.top_k(acc, 2)[0]``; INT32_MIN second when M < 2)."""
    acc = d_eff - 2 * packed_hamming_ref(q_packed, im_packed)
    best = torch.argmax(acc, dim=-1).to(torch.int32)
    if acc.shape[-1] < 2:
        top2 = torch.cat([acc, torch.full_like(acc, INT32_MIN)], dim=-1)
    else:
        top2 = torch.topk(acc, 2, dim=-1).values
    return acc, best, top2


def delta_update_ref(acc: torch.Tensor, dmajor: torch.Tensor,
                     idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """int32 [..., M]: acc + sum_k weight[..., k] * dmajor[idx[..., k], :] —
    ``delta_update.delta_update``. An index is taken as JAX's gather takes
    it: a negative one wraps from the end once (-1 reads row D - 1), then
    it clamps to [0, D) (-D - 3 reads row 0, D + 6 row D - 1)."""
    D = dmajor.shape[0]
    idx = idx.to(torch.int64)
    idx = torch.clamp(torch.where(idx < 0, idx + D, idx), 0, D - 1)
    rows = dmajor[idx].to(torch.int32)                    # [..., budget, M]
    return acc + torch.sum(weight[..., None] * rows, dim=-2,
                           dtype=torch.int32)


def bank_prefix_hamming_ref(q_packed: torch.Tensor, im_packed: torch.Tensor,
                            *, cap: int) -> torch.Tensor:
    """int32 [N, M, cap]: the cumulative hamming count of every query row
    against every class row at each of the ``cap`` bank boundaries of the
    (plan-capped, bank-major) word prefix — ``fused_window
    .bank_prefix_hamming``."""
    N, W = q_packed.shape
    M = im_packed.shape[0]
    if W % cap:
        raise ValueError(f"W={W} must be a multiple of cap={cap}")
    epw = W // cap
    out = torch.empty((N, M, cap), dtype=torch.int32, device=q_packed.device)
    for n0, n1 in _row_chunks(N, M, W):
        x = q_packed[n0:n1, None, :] ^ im_packed[None, :, :]
        pc = hdc.popcount32(x)                                    # [n, M, W]
        per_bank = pc.reshape(n1 - n0, M, cap, epw).sum(-1, dtype=torch.int32)
        out[n0:n1] = torch.cumsum(per_bank, dim=-1, dtype=torch.int32)
    return out


def sign_project_ref(z: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """int8 [N, D] = sign(z @ R.T), sign(0) -> +1."""
    y = z.to(torch.float32) @ R.to(torch.float32).T
    return torch.where(y >= 0.0, 1, -1).to(torch.int8)


def sign_project_pack_ref(z: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """int32 words [N, D//32] = pack(sign(z @ R.T)) — ``fused_window
    .sign_project_pack``."""
    return hdc.pack_bits(sign_project_ref(z, R))


def _int8_einsum(spec: str, a: torch.Tensor, c: torch.Tensor):
    """``einsum(spec)`` of int8 codes, exact: int32 on the CPU (as the
    reference's ``astype(int32)`` einsum), float64 products elsewhere
    (exact below 2^53; CUDA has no integer einsum)."""
    wide = torch.int32 if a.device.type == "cpu" else torch.float64
    return torch.einsum(spec, a.to(wide), c.to(wide)).to(torch.int32)


def int8_dot_rows_ref(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """int32 [B, Hk, G, S] = sum_k a[b,h,g,k] * c[b,s,h,k] over the first
    K = a.shape[-1] codes of each row of ``c`` [B, S, Hk, L >= K] —
    ``int8_dot.rows``."""
    return _int8_einsum("bhgk,bshk->bhgs", a, c[..., :a.shape[-1]])


def int8_dot_cols_ref(p: torch.Tensor, c: torch.Tensor,
                      k: int) -> torch.Tensor:
    """int32 [B, Hk, G, k] = sum_s p[b,h,g,s] * c[b,s,h,:k] —
    ``int8_dot.cols``."""
    return _int8_einsum("bhgs,bshk->bhgk", p, c[..., :k])


def sign_disagreement(z: torch.Tensor, R: torch.Tensor,
                      codes_a: torch.Tensor, codes_b: torch.Tensor) -> dict:
    """The agreement rule for two computations of sign(z @ R.T) as bipolar
    codes [N, D] (``sign_project``).

    Float32 products summed in different orders may differ in sign where
    |y| is within rounding of zero, so no two implementations are
    bit-equal. A code is *decided* where |y| > tau with
    tau = d * 2^-23 * sum_i |z_i * R_{D,i}| (the forward-error bound of a
    length-d float32 dot, taken on this function's float32 product y);
    decided codes must agree, and the undecided ones that differ must stay
    at most 1e-4 of all codes. Returns the counts (the caller asserts)."""
    z = z.to(torch.float32)
    R = R.to(torch.float32)
    d = z.shape[1]
    y = z @ R.T
    tau = d * 2.0 ** -23 * (z.abs().to(torch.float64)
                            @ R.abs().to(torch.float64).T)
    diff = codes_a != codes_b
    decided = y.abs().to(torch.float64) > tau
    n_bits = diff.numel()
    return {
        "bits": n_bits,
        "decided_differ": int(torch.sum(diff & decided)),
        "undecided_differ": int(torch.sum(diff & ~decided)),
        "ok": bool(torch.sum(diff & decided) == 0
                   and torch.sum(diff & ~decided) <= 1e-4 * n_bits),
    }


def sign_pack_disagreement(z: torch.Tensor, R: torch.Tensor,
                           words_a: torch.Tensor,
                           words_b: torch.Tensor) -> dict:
    """:func:`sign_disagreement` for two encodings of pack(sign(z @ R.T))
    (``sign_project_pack``): the rule over the unpacked bits."""
    D = R.shape[0]
    return sign_disagreement(z, R, hdc.unpack_bits(words_a, D),
                             hdc.unpack_bits(words_b, D))
