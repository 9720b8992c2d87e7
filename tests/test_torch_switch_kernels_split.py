"""The block decompositions of the switch lowering's two CUDA kernels
(``csrc/delta_update.cu``, ``csrc/fused_scores.cu``), emulated on the CPU
in plain torch and held against JAX's Pallas kernels in interpret mode on
adversarial inputs.

``delta_update``: the budget is dealt to a cluster of SPLIT blocks in
32-entry runs (block s takes runs s, s + SPLIT, ...), each block compacts
CHUNK entries of its runs at a time (weighted entries only, in budget
order), its warps gather the dense list in rounds of
GROUPS * U entries, and the cluster adds the blocks' partial sums to
``acc`` column by column; an index wraps from the end once if negative,
then clamps to [0, D), as JAX's gather takes it.

``fused_scores``: a word's nibbles are spread to 0/1 bytes by
``(nib * 0x204081) & 0x01010101`` into the m16n8k32 u8 fragments, one
word per k32 step; ``acc = d_eff - 2 * (pq + ph) + 4 * dot`` with pq, ph
the rows' set bits (each lane of a four-lane group counts one word of
four); every cluster rank owns a span of classes walked BM at a time over
KC-word stages whose 4-word runs are dealt to KS warp groups (their
shares added with d_eff in the epilogue); a lane folds its classes in rising order, a warp merges
its lanes by an xor butterfly, the block folds its sub-tiles and the
cluster its ranks in order under ``_fused_kernel``'s finalize rule. The
+-1 form of the same product, ``acc = dot_pm1 + d_eff - 32 W``, is held
too.

The tile sizes are parameters that mirror the ``.cu`` constants; the
tests also run the emulations at other sizes, so the decomposition, not
one size, is what is checked."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_window as jfw
from repro_torch.core import hdc

from _torch_parity import assert_same, bipolar, pack_np

INT32_MIN, INT32_MAX = -(2 ** 31), 2 ** 31 - 1

# csrc/delta_update.cu
DU = dict(split=8, cols=64, warps=4, chunk=256, groups=8, u=4, run=32)
# csrc/fused_scores.cu: CL, BM = WARPS_M * 16 * MT, KC and the KS of both
# instantiations (the query tile BQ does not change the arithmetic)
FS = dict(cl=8, bm=128, kc=16, ks=2)


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.from_numpy((a.view(np.int32) if a.dtype == np.uint32
                             else a).copy())


# --- delta_update ------------------------------------------------------------

def emulate_delta_update(acc, dmajor, idx, w, *, split, cols, warps, chunk,
                         groups, u, run=32):
    """acc + sum_k w * dmajor[idx] as the kernel's blocks compute it:
    int32 [L, M], a negative index wrapped once and every index clamped to
    [0, D). Block s of a cluster takes the run-entry runs s, s + split, ...
    of the budget, chunk // run runs a pass."""
    L, M = acc.shape
    D, K = dmajor.shape[0], idx.shape[1]
    runs, per_pass = -(-K // run), chunk // run
    round_ = warps * groups * u
    out = torch.empty_like(acc)
    for l in range(L):
        for c0 in range(0, M, cols):
            c1 = min(M, c0 + cols)
            part = torch.zeros((split, c1 - c0), dtype=torch.int32)
            for s in range(split):                       # cluster rank
                warp_sum = torch.zeros((warps, c1 - c0), dtype=torch.int32)
                for r0 in range(s, runs, split * per_pass):
                    ks = torch.tensor([run * (r0 + split * i) + j
                                       for i in range(per_pass)
                                       for j in range(run)])
                    ks = ks[ks < K]
                    keep = ks[w[l, ks] != 0]             # compaction, in order
                    ix = idx[l, keep]
                    dense_i = torch.clamp(torch.where(ix < 0, ix + D, ix),
                                          0, D - 1)
                    dense_w = w[l, keep]
                    for e in range(len(keep)):
                        # entry e = e0 + uu * groups + grp, e0 stepping by
                        # warps * groups * u from warp * groups * u
                        warp = (e % round_) // (groups * u)
                        rows = dmajor[dense_i[e], c0:c1].to(torch.int32)
                        warp_sum[warp] += dense_w[e] * rows
                part[s] = warp_sum.sum(0, dtype=torch.int32)
            # block s finishes columns [s * cols / split, ...) of every rank
            out[l, c0:c1] = acc[l, c0:c1] + part.sum(0, dtype=torch.int32)
    return out


def _delta_case(rng, L, M, K, D, nnz, oor=False):
    dmaj = np.ascontiguousarray(bipolar(rng, (M, D)).T)
    acc = rng.integers(-1000, 1000, (L, M)).astype(np.int32)
    idx = np.zeros((L, K), np.int32)
    w = np.zeros((L, K), np.int32)
    for r, n in enumerate(nnz):
        idx[r, :n] = np.sort(rng.choice(D, n, replace=False))
        w[r, :n] = np.where(rng.random(n) < 0.5, 2, -2)
    if oor:   # past the end with weight: clamped to D - 1, as JAX clamps
        idx[0, :2] = [D + 7, INT32_MAX]
        w[0, :2] = [2, -2]
        idx[-1, -1], w[-1, -1] = D, -2
    return acc, dmaj, idx, w


def _jax_delta(acc, dmaj, idx, w):
    """JAX's Pallas delta_update in interpret mode, one row at a time (the
    port's leading [L] batch is JAX's vmap over streams)."""
    interpret = True if acc.shape[1] % 8 == 0 else None   # else JAX's oracle
    return np.stack([np.asarray(jfw.delta_apply(
        jnp.asarray(acc[r]), jnp.asarray(dmaj), jnp.asarray(idx[r]),
        jnp.asarray(w[r]), interpret=interpret))
        for r in range(acc.shape[0])])


@pytest.mark.parametrize("label,L,M,K,nnz,oor", [
    ("whole budget weighted, L=1", 1, 128, 600, [600], False),
    ("one weighted entry, L=1", 1, 128, 600, [1], False),
    ("all padding + one entry", 2, 128, 600, [0, 1], False),
    ("K=1", 3, 64, 1, [1, 0, 1], False),
    ("K not a multiple of the split", 2, 128, 301, [301, 150], False),
    ("indices out of range, weighted", 2, 64, 40, [20, 40], True),
    ("ragged M", 2, 77, 100, [100, 33], False),
    ("mixed fills, L=16", 16, 64, 300,
     [300, 0, 1, 299, 150, 33, 300, 2, 0, 64, 65, 31, 32, 300, 7, 1], False),
])
def test_delta_update_split_matches_pallas(label, L, M, K, nnz, oor):
    rng = np.random.default_rng(L * 1000 + M + K)
    acc, dmaj, idx, w = _delta_case(rng, L, M, K, 1024, nnz, oor)
    got = emulate_delta_update(*(_t(a) for a in (acc, dmaj, idx, w)), **DU)
    assert_same(got, _jax_delta(acc, dmaj, idx, w), label)


@pytest.mark.parametrize("sizes", [
    dict(split=2, cols=16, warps=2, chunk=8, groups=2, u=3, run=4),
    dict(split=16, cols=128, warps=8, chunk=64, groups=8, u=1, run=8),
    dict(split=8, cols=128, warps=4, chunk=256, groups=4, u=4, run=32),
])
def test_delta_update_split_at_other_tile_sizes(sizes):
    """The decomposition is exact at any split, chunk and round (the last
    case is the kernel's instantiation above L = 8 rows, LANES = 8): every
    weighted entry lands in exactly one slice, chunk and warp."""
    rng = np.random.default_rng(5)
    acc, dmaj, idx, w = _delta_case(rng, 3, 96, 123, 256, [123, 7, 0], True)
    got = emulate_delta_update(*(_t(a) for a in (acc, dmaj, idx, w)), **sizes)
    assert_same(got, _jax_delta(acc, dmaj, idx, w))


def test_delta_update_wraps_negative_indices_as_jax():
    """Weighted indices -1, -5, -D, -D - 3 and D + 6: the port's plain
    version and the kernel's emulation read the rows JAX's Pallas kernel
    (interpret mode) and its reference gather read (a negative index wraps
    from the end once, then every index clamps to [0, D))."""
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref

    rng = np.random.default_rng(16)
    D, M = 256, 64
    acc, dmaj, idx, w = _delta_case(rng, 2, M, 40, D, [12, 40])
    bad = [-1, -5, -D, -D - 3, D + 6]
    idx[0, :5], w[0, :5] = bad, [2, -2, 2, -2, 2]
    idx[1, -5:], w[1, -5:] = bad, [-2, 2, -2, 2, -2]
    want = _jax_delta(acc, dmaj, idx, w)
    assert_same(want, np.stack([np.asarray(jref.delta_update_ref(
        jnp.asarray(acc[r]), jnp.asarray(dmaj), jnp.asarray(idx[r]),
        jnp.asarray(w[r]))) for r in range(2)]), "JAX kernel vs JAX ref")
    args = tuple(_t(a) for a in (acc, dmaj, idx, w))
    assert_same(ref.delta_update_ref(*args), want, "plain version")
    assert_same(emulate_delta_update(*args, **DU), want, "emulation")


# --- fused_scores ------------------------------------------------------------

def spread(x: torch.Tensor, sh) -> torch.Tensor:
    """((x >> sh) & 0xF) * 0x204081 & 0x01010101 on uint32 words (int64)."""
    return (((x >> sh) & 0xF) * 0x00204081) & 0x01010101


def _bytes(reg: torch.Tensor) -> torch.Tensor:
    """int64 registers [...] -> their four bytes [..., 4], low byte first."""
    return torch.stack([(reg >> (8 * i)) & 0xFF for i in range(4)], -1)


def fragments(rows16: torch.Tensor, cols8: torch.Tensor):
    """The m16n8k32 u8 A and B operands a warp builds from one word of 16
    class rows and 8 query rows (uint32 words as int64), lane (g, t):
    a0 = spread(row g, 4t), a1 = spread(row g + 8, 4t), a2, a3 the same at
    4t + 16; b0 = spread(query g, 4t), b1 at 4t + 16. Returned as the
    matrices the PTX fragment layout defines: A [16, 32], B [32, 8]."""
    A = torch.zeros((16, 32), dtype=torch.int64)
    B = torch.zeros((32, 8), dtype=torch.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        regs = (spread(rows16[g], 4 * t), spread(rows16[g + 8], 4 * t),
                spread(rows16[g], 4 * t + 16),
                spread(rows16[g + 8], 4 * t + 16))
        for r, reg in enumerate(regs):
            row = g + 8 * (r & 1)
            k = t * 4 + 16 * (r >> 1)
            A[row, k:k + 4] = _bytes(reg)
        for r, reg in enumerate((spread(cols8[g], 4 * t),
                                 spread(cols8[g], 4 * t + 16))):
            k = t * 4 + 16 * r
            B[k:k + 4, g] = _bytes(reg)
    return A, B


def _merge(a, b):
    """(max, first index, largest other) of two disjoint sets of classes."""
    v, i, s = a
    ov, oi, os = b
    if v > ov or (v == ov and i < oi):
        return v, i, max(s, ov)
    return ov, oi, max(os, v)


IDENTITY = (INT32_MIN, INT32_MAX, INT32_MIN)


def emulate_fused_scores(q, im, d_eff, *, cl, bm, kc, ks):
    """(acc [N, M], best [N], top2 [N, 2]) as the kernel's clusters compute
    them from int32 words q [N, W] and im [M, W]."""
    N, W = q.shape
    M = im.shape[0]
    u = lambda x: x.to(torch.int64) & 0xFFFFFFFF          # noqa: E731
    nk = -(-W // kc)
    Wp = nk * kc
    qz = torch.zeros((N, Wp), dtype=torch.int64)
    hz = torch.zeros((M, Wp), dtype=torch.int64)
    qz[:, :W], hz[:, :W] = u(q), u(im)                     # zero fill
    span = -(-(-(-M // cl)) // bm) * bm
    acc = torch.empty((N, M), dtype=torch.int32)
    trip = [[IDENTITY] * cl for _ in range(N)]
    for r in range(cl):
        m_lo, m_hi = r * span, min(M, r * span + span)
        for m0 in range(m_lo, m_hi, bm):
            width = min(bm, m_hi - m0)
            h = torch.zeros((bm, Wp), dtype=torch.int64)
            h[:width] = hz[m0:m0 + width]
            # dot over k32 steps: bytes of the spread nibbles, one word a
            # step; nibbles t and t + 4 for t < 4 cover the word's 32 bits
            hb = torch.cat([_bytes(spread(h, 4 * t)) for t in range(4)]
                           + [_bytes(spread(h, 4 * t + 16))
                              for t in range(4)], -1)      # [bm, Wp, 32]
            qb = torch.cat([_bytes(spread(qz, 4 * t)) for t in range(4)]
                           + [_bytes(spread(qz, 4 * t + 16))
                              for t in range(4)], -1)
            # warp group kg takes the 4-word runs j4 = kg, kg + ks, ... of
            # every kc-word stage; its share is 4 * dot - 2 * (pq + ph) over
            # its words, lane t of a four-lane group counting word 4 j4 + t
            j4 = (torch.arange(Wp) % kc) // 4
            tile = torch.full((N, bm), d_eff, dtype=torch.int64)
            for kg in range(ks):
                sel = (j4 % ks) == kg
                dot = torch.einsum("nwk,mwk->nm", qb[:, sel], hb[:, sel])

                def pop(x):
                    xs = x[:, sel]
                    return sum(hdc.popcount32(xs[:, t::4].to(torch.int32))
                               .sum(-1, dtype=torch.int64) for t in range(4))
                tile += 4 * dot - 2 * (pop(qz)[:, None] + pop(h)[None, :])
            acc[:, m0:m0 + width] = tile[:, :width].to(torch.int32)
            for n in range(N):
                lanes = []
                for lane in range(32):          # classes lane, lane + 32, ..
                    v, i, s = IDENTITY
                    for cc in range(lane, min(width, bm), 32):
                        x = int(tile[n, cc])
                        if x > v:
                            v, i, s = x, m0 + cc, v
                        else:
                            s = max(s, x)
                    lanes.append((v, i, s))
                off = 16
                while off:                      # xor butterfly
                    lanes = [_merge(lanes[ln], lanes[ln ^ off])
                             for ln in range(32)]
                    off >>= 1
                trip[n][r] = _merge(trip[n][r], lanes[0])
    best = torch.empty(N, dtype=torch.int32)
    top2 = torch.empty((N, 2), dtype=torch.int32)
    for n in range(N):
        t = IDENTITY
        for r in range(cl):                     # cluster ranks in order
            t = _merge(t, trip[n][r])
        best[n], top2[n, 0], top2[n, 1] = t[1], t[0], t[2]
    return acc, best, top2


def _jax_fused(qp, imp, d_eff):
    return jfw.fused_scores(jnp.asarray(qp), jnp.asarray(imp), d_eff=d_eff,
                            interpret=True)


def _fs_case(rng, label, N, M, W):
    qp = pack_np(bipolar(rng, (N, 32 * W)))
    imp = pack_np(bipolar(rng, (M, 32 * W)))
    if label == "ties in one tile":        # adjacent copies
        imp = np.repeat(imp[:M // 2], 2, axis=0)
    elif label == "ties across tiles":     # a copy in every span
        imp = np.tile(imp[:M // 4], (4, 1))
    elif label == "ties 512 apart":
        imp = np.concatenate([imp[:M // 2], imp[:M // 2]])
    elif label == "all-zero words":
        qp[:, ::3] = 0
        imp[:, 1::3] = 0
    return qp, imp


@pytest.mark.parametrize("label,N,M,W,sizes", [
    ("main", 8, 256, 8, {}),
    ("ties in one tile", 4, 64, 4, {}),
    ("ties across tiles", 4, 64, 4, dict(cl=4, bm=16, kc=4, ks=1)),
    ("ties 512 apart", 3, 1024, 1, {}),
    ("M=1", 5, 1, 4, {}),
    ("ragged M", 6, 37, 5, {}),
    ("ragged M and W, small tiles", 9, 45, 7, dict(cl=8, bm=4, kc=8, ks=2)),
    ("all-zero words", 4, 32, 6, dict(cl=2, bm=8, kc=16, ks=4)),
])
def test_fused_scores_split_matches_pallas(label, N, M, W, sizes):
    rng = np.random.default_rng(N * 100 + M + W)
    qp, imp = _fs_case(rng, label, N, M, W)
    d_eff = 32 * W - 5 * (label == "main")     # any d_eff: acc shifts
    got = emulate_fused_scores(_t(qp), _t(imp), d_eff, **{**FS, **sizes})
    want = _jax_fused(qp, imp, d_eff)
    for g, wv, name in zip(got, want, ("acc", "best", "top2")):
        assert_same(g, wv, f"{label}: {name}")
    if label.startswith("ties"):
        assert torch.equal(got[2][:, 0], got[2][:, 1])
    if label == "M=1":
        assert (got[2][:, 1] == INT32_MIN).all()


def test_spread_and_fragments_follow_the_ptx_layout():
    """Every nibble spreads to its four 0/1 bytes, and the fragments a warp
    builds from one word give A[m, k] = bit k of class m's word and
    B[k, n] = bit k of query n's word, so A @ B is the count of shared set
    bits."""
    nib = torch.arange(16, dtype=torch.int64)
    want = sum(((nib >> i) & 1) << (8 * i) for i in range(4))
    assert torch.equal(spread(nib, 0), want)
    rng = np.random.default_rng(1)
    rows = torch.from_numpy(rng.integers(0, 2 ** 32, 16, dtype=np.uint64)
                            .astype(np.int64))
    cols = torch.from_numpy(rng.integers(0, 2 ** 32, 8, dtype=np.uint64)
                            .astype(np.int64))
    A, B = fragments(rows, cols)
    bits = lambda x: torch.stack([(x >> k) & 1 for k in range(32)], -1)  # noqa
    assert torch.equal(A, bits(rows))
    assert torch.equal(B, bits(cols).T)
    pairs = hdc.popcount32((rows[:, None] & cols[None, :]).to(torch.int32))
    assert torch.equal(A @ B, pairs.to(torch.int64))


@pytest.mark.parametrize("N,M,W,d_eff", [(4, 16, 8, 256), (3, 5, 3, 90)])
def test_pm1_product_identity(N, M, W, d_eff):
    """The +-1 form: the int8 product of the unpacked codes is
    32 W - 2 * hamming, so acc = dot_pm1 + d_eff - 32 W, equal to the
    0/1 form the kernel runs and to JAX's acc."""
    rng = np.random.default_rng(N + M + W)
    qp, imp = (pack_np(bipolar(rng, (n, 32 * W))) for n in (N, M))
    q_pm1 = hdc.unpack_bits(_t(qp), 32 * W).to(torch.int32)
    h_pm1 = hdc.unpack_bits(_t(imp), 32 * W).to(torch.int32)
    acc = q_pm1 @ h_pm1.T + (d_eff - 32 * W)
    assert_same(acc, _jax_fused(qp, imp, d_eff)[0])
    assert_same(acc, emulate_fused_scores(_t(qp), _t(imp), d_eff, **FS)[0])
