"""The block decomposition of the two hamming kernels
(``csrc/hamming_mma.cuh``, shared by ``csrc/bank_prefix_hamming.cu`` and
``csrc/packed_hamming_batched.cu``), emulated on the CPU in plain torch and
held against JAX's Pallas kernels in interpret mode on adversarial inputs.

The kernel's arithmetic: over the words of a row pair,
hamming = pq + ph - 2 * dot with dot the count of bits set in both, all
three from the 1-bit tensor-core product
``mma.sync.m16n8k256.b1.and.popc`` (a k-step is 8 words): dot of the
queries and the classes, pq of the queries and all-ones words, ph of
all-ones words and the classes. Row words are
``cap`` banks of ``epw = W / cap`` words, each zero-padded to a multiple of
8 (at least 8), so no k-step straddles a bank; the padded words stream
through KC-word stages (zero fill past N, M and the padded width) into
warps of 16 queries x 8 NT classes, WQ x WC warps a block. At each bank
boundary pq + ph - 2 * dot of banks 0..b goes into a staging slot (a
16-bit one when 32 W < 65,536: no count exceeds 32 W); every
G = min(cap, 8) banks (and at the last) the staged slots are copied to
out [N, M, cap], rows past N and classes past M dropped.
``packed_hamming_batched`` is the cap = 1 case over a leading batch, and
there KW warps may share an output tile: warp w takes the k-steps j of
each KC-word stage with j % KW == w, counts pq + ph - 2 * dot over its own
words, and the KW partial counts are added in warp order after the loop
(the K split and its merge). No split crosses blocks.

The tile sizes are parameters that mirror the ``.cu`` constants; the tests
also run the emulation at other sizes, so the decomposition, not one size,
is what is checked."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_window as jfw
from repro.kernels import xnor_popcount_sim as jxps
from repro_torch.core import hdc
from repro_torch.kernels import ref
from repro_torch.kernels import xnor_popcount_sim as xps

from _torch_parity import assert_same

# csrc/bank_prefix_hamming.cu (Block) and csrc/packed_hamming_batched.cu
# (Snapshot: M <= 8, Table: M > 8), as (WQ, WC, NT, KC, KW) of ham::Tile
PREFIX_BLOCK = dict(wq=4, wc=2, nt=4, kc=32, kw=1)
BATCHED_SNAPSHOT = dict(wq=1, wc=1, nt=1, kc=64, kw=8)
BATCHED_TABLE = dict(wq=4, wc=2, nt=2, kc=64, kw=2)
G_MAX = 8   # banks a staging tile holds


def _u(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & 0xFFFFFFFF


def _popc(x: torch.Tensor) -> torch.Tensor:
    """Set bits of uint32 words held in int64."""
    return hdc.popcount32(x.to(torch.int32)).to(torch.int64)


def _padded(x: torch.Tensor, cap: int, kp: int) -> torch.Tensor:
    """Rows [R, W] laid out in the padded word space [R, kp]: bank b's
    word j at b * epw8 + j, zeros elsewhere."""
    W = x.shape[1]
    epw = W // cap
    epw8 = max(8, -(-epw // 8) * 8)
    p = torch.arange(kp)
    b, j = p // epw8, p % epw8
    ok = (b < cap) & (j < epw)
    out = torch.zeros((x.shape[0], kp), dtype=torch.int64)
    out[:, ok] = x[:, (b * epw + j)[ok]]
    return out


def emulate_prefix(q, h, cap, *, wq, wc, nt, kc, kw):
    """int32 [N, M, cap] as prefix_block's blocks compute it from int32
    words q [N, W] and h [M, W] (a cell no block writes stays -1); kw > 1
    only with cap == 1, as the launch requires."""
    assert kw == 1 or cap == 1
    N, W = q.shape
    M = h.shape[0]
    epw = W // cap
    kspb = max(8, -(-epw // 8) * 8) // 8
    nsteps = cap * kspb
    nk = -(-8 * nsteps // kc)
    qz, hz = _padded(_u(q), cap, nk * kc), _padded(_u(h), cap, nk * kc)
    BQ, BC = 16 * wq, 8 * nt * wc
    G = min(cap, G_MAX)
    out = torch.full((N, M, cap), -1, dtype=torch.int32)
    for q0 in range(0, N, BQ):
        for m0 in range(0, M, BC):
            # the block's stages: rows past N and M zero-filled
            qt = torch.zeros((BQ, nk * kc), dtype=torch.int64)
            ht = torch.zeros((BC, nk * kc), dtype=torch.int64)
            qt[:min(BQ, N - q0)] = qz[q0:q0 + BQ]
            ht[:min(BC, M - m0)] = hz[m0:m0 + BC]
            for wq_ in range(wq):
                for wc_ in range(wc):
                    A = qt[16 * wq_:16 * wq_ + 16]            # [16, Kp]
                    B = ht[8 * nt * wc_:8 * nt * (wc_ + 1)]   # [8 nt, Kp]
                    n_base, m_base = q0 + 16 * wq_, m0 + 8 * nt * wc_
                    if kw == 1:
                        _warp(A, B, out, n_base, m_base, cap, kspb, nsteps,
                              G)
                    else:
                        _split(A, B, out, n_base, m_base, nsteps, kc, kw)
    return out


ONES = 0xFFFFFFFF


def _and_popc(a, b):
    """One m16n8k256 b1 .and.popc step: [R, 8] x [C, 8] words -> [R, C]."""
    return _popc(a[:, None, :] & b[None, :, :]).sum(-1)


def _step(A, B, i):
    """(dot, pq, ph) products of k-step i: the queries against the
    classes, against an all-ones n8 tile, and an all-ones m16 tile against
    the classes; each [16, 8 NT] in the accumulators' layout."""
    wa, wb = A[:, 8 * i:8 * i + 8], B[:, 8 * i:8 * i + 8]
    return (_and_popc(wa, wb),
            _and_popc(wa, torch.full((8, 8), ONES)).repeat(1, wb.shape[0] // 8),
            _and_popc(torch.full((16, 8), ONES), wb))


def _counts(A, B, steps):
    """pq + ph - 2 * dot of a warp's 16 query and 8 NT class rows over the
    k-steps ``steps``."""
    acc = torch.zeros((3, A.shape[0], B.shape[0]), dtype=torch.int64)
    for i in steps:
        acc += torch.stack(_step(A, B, i))
    dot, pq, ph = acc
    return pq + ph - 2 * dot


def _store(out, vals, n_base, m_base, b0):
    """A warp's staged counts [16, 8 NT, g] into out[..., b0:b0 + g], rows
    past N and classes past M dropped."""
    N, M, _ = out.shape
    rows = max(0, min(vals.shape[0], N - n_base))
    cols = max(0, min(vals.shape[1], M - m_base))
    out[n_base:n_base + rows, m_base:m_base + cols,
        b0:b0 + vals.shape[2]] = vals[:rows, :cols].to(torch.int32)


def _split(A, B, out, n_base, m_base, nsteps, kc, kw):
    """cap == 1 with kw warps on one tile: warp w takes the k-steps whose
    place j in their kc-word stage has j % kw == w; the partial counts
    are added in warp order."""
    parts = [_counts(A, B, [i for i in range(nsteps)
                            if (i % (kc // 8)) % kw == w])
             for w in range(kw)]
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    _store(out, total[..., None], n_base, m_base, 0)


def _warp(A, B, out, n_base, m_base, cap, kspb, nsteps, G):
    """One warp's k-steps, emissions and staged copies."""
    acc = torch.zeros((3, A.shape[0], B.shape[0]), dtype=torch.int64)
    staged = torch.zeros((A.shape[0], B.shape[0], G), dtype=torch.int64)
    b0 = 0
    for i in range(nsteps):
        acc += torch.stack(_step(A, B, i))
        if (i + 1) % kspb:
            continue
        b = (i + 1) // kspb - 1            # the accumulators hold banks 0..b
        slot = b - b0
        dot, pq, ph = acc
        staged[:, :, slot] = pq + ph - 2 * dot
        if slot + 1 < G and b + 1 < cap:
            continue
        _store(out, staged[:, :, :slot + 1], n_base, m_base, b0)
        b0 = b + 1


def emulate_batched(q, h, **tile):
    """int32 [S, N, M] (or [N, M] for 2-D inputs): the cap = 1 case of
    :func:`emulate_prefix` per batch."""
    if q.dim() == 2:
        return emulate_batched(q[None], h[None], **tile)[0]
    return torch.stack([emulate_prefix(q[s], h[s], 1, **tile)[..., 0]
                        for s in range(q.shape[0])])


def _words(rng, *shape) -> np.ndarray:
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def _case(rng, label, N, M, W):
    """uint32 words q [N, W], h [M, W] for an input pattern."""
    q, h = _words(rng, N, W), _words(rng, M, W)
    if label == "all ones x all zeros":
        q[:] = 0xFFFFFFFF
        h[:] = 0
    elif label == "equal rows":
        h = np.resize(q, (M, W)).astype(np.uint32)
    elif label == "masked words zeroed on both sides":
        q[:, 1::3] = 0
        h[:, 1::3] = 0
    return q, h


def _jax_prefix(q, h, cap):
    return np.asarray(jfw.bank_prefix_hamming(jnp.asarray(q), jnp.asarray(h),
                                              cap=cap, interpret=True))


def _jax_batched(q, h):
    """JAX's kernel per batch (the port's leading axis is JAX's vmap)."""
    if q.ndim == 2:
        return np.asarray(jxps.packed_hamming_batched(
            jnp.asarray(q), jnp.asarray(h), interpret=True))
    return np.stack([_jax_batched(q[s], h[s]) for s in range(q.shape[0])])


PATTERNS = ("random", "all ones x all zeros", "equal rows",
            "masked words zeroed on both sides")


@pytest.mark.parametrize("W,cap", [(8, 1), (8, 8), (40, 1), (40, 5),
                                   (40, 8), (256, 1), (256, 8)])
def test_prefix_split_matches_pallas(W, cap):
    """The kernel's tile (8 warps, 64 x 64) over every pattern at ragged N
    and M, each W and cap: every count equals JAX's, and every bank
    boundary of the all-ones case reads 32 epw (b + 1)."""
    rng = np.random.default_rng(W * 10 + cap)
    N, M = (21, 19) if W == 256 else (37, 45)
    for label in PATTERNS:
        q, h = _case(rng, label, N, M, W)
        want = _jax_prefix(q, h, cap)
        got = emulate_prefix(_t(q), _t(h), cap, **PREFIX_BLOCK)
        assert_same(got, want, f"{label}, W={W}, cap={cap}")
        if label == "all ones x all zeros":
            epw = W // cap
            assert (got == torch.tensor([32 * epw * (b + 1)
                                         for b in range(cap)])).all()
        if label == "equal rows":
            assert (got[np.arange(min(N, M)), np.arange(min(N, M))]
                    == 0).all()


@pytest.mark.parametrize("label,N,M,W,cap,sizes", [
    ("kernel tile, ragged N and M", 37, 70, 40, 5, PREFIX_BLOCK),
    ("kernel tile, plan (8,1) widths", 33, 65, 64, 8, PREFIX_BLOCK),
    ("kernel tile, one bank", 17, 64, 8, 1, PREFIX_BLOCK),
    ("cap past the staging tile (two groups)", 9, 12, 40, 10,
     dict(wq=1, wc=1, nt=2, kc=32, kw=1)),
    ("cap past the staging tile, 20 banks", 5, 9, 40, 20,
     dict(wq=2, wc=1, nt=1, kc=64, kw=1)),
    ("stage of 32 words, banks of 12 padded to 16", 6, 10, 48, 4,
     dict(wq=1, wc=2, nt=2, kc=32, kw=1)),
    ("other tile: 3 x 1 warps, NT = 1", 50, 11, 16, 2,
     dict(wq=3, wc=1, nt=1, kc=32, kw=1)),
])
def test_prefix_split_at_other_tile_sizes(label, N, M, W, cap, sizes):
    rng = np.random.default_rng(N + M + W + cap)
    for pattern in ("random", "masked words zeroed on both sides"):
        q, h = _case(rng, pattern, N, M, W)
        assert_same(emulate_prefix(_t(q), _t(h), cap, **sizes),
                    _jax_prefix(q, h, cap), f"{label}: {pattern}")


@pytest.mark.parametrize("label,S,N,M,W,sizes", [
    ("snapshot tile, M = 1", 3, 37, 1, 40, BATCHED_SNAPSHOT),
    ("snapshot tile, M = 8", 2, 37, 8, 256, BATCHED_SNAPSHOT),
    ("snapshot tile, W = 8", 2, 20, 8, 8, BATCHED_SNAPSHOT),
    ("table tile, ragged M", 2, 37, 45, 40, BATCHED_TABLE),
    ("table tile, M = 8 rows of a 32-class tile", 2, 16, 8, 40,
     BATCHED_TABLE),
    ("8 warps a tile, one k-step each a stage", 2, 20, 9, 256,
     dict(wq=1, wc=1, nt=2, kc=64, kw=8)),
    ("2 warps a tile, stages of 32 words, W not a multiple of 8", 2,
     17, 12, 13, dict(wq=2, wc=2, nt=2, kc=32, kw=2)),
    ("2-D form", None, 19, 21, 40, BATCHED_TABLE),
])
def test_batched_split_matches_pallas(label, S, N, M, W, sizes):
    rng = np.random.default_rng(N * 7 + M + W)
    lead = () if S is None else (S,)
    for pattern in PATTERNS:
        parts = [_case(rng, pattern, N, M, W) for _ in range(S or 1)]
        q = np.stack([p[0] for p in parts]).reshape(*lead, N, W)
        h = np.stack([p[1] for p in parts]).reshape(*lead, M, W)
        want = _jax_batched(q, h)
        assert_same(emulate_batched(_t(q), _t(h), **sizes), want,
                    f"{label}: {pattern}")
        if pattern == "all ones x all zeros":
            assert (want == 32 * W).all()


@pytest.mark.parametrize("S,N,M,W", [(None, 37, 45, 40), (3, 37, 1, 40),
                                     (2, 16, 8, 256), (2, 20, 20, 8)])
def test_packed_hamming_batched_plain_matches_jax(S, N, M, W):
    """The port's packed_hamming_batched (its plain version on the CPU)
    against JAX's kernel, 2-D and batched, with every pattern."""
    rng = np.random.default_rng((S or 0) + N + M + W)
    lead = () if S is None else (S,)
    for pattern in PATTERNS:
        parts = [_case(rng, pattern, N, M, W) for _ in range(S or 1)]
        q = np.stack([p[0] for p in parts]).reshape(*lead, N, W)
        h = np.stack([p[1] for p in parts]).reshape(*lead, M, W)
        assert_same(xps.packed_hamming_batched(_t(q), _t(h)),
                    _jax_batched(q, h), pattern)
        assert_same(ref.packed_hamming_ref(_t(q), _t(h)),
                    _jax_batched(q, h), pattern)


# --- fragments -----------------------------------------------------------

def ldmatrix_x4(stage: torch.Tensor, offs) -> list:
    """ldmatrix.sync.m8n8.x4.b16 on a stage of 32-bit words (flat [R * SW])
    with lane l's row address ``offs[l]``: register i of lane l is word
    l % 4 of the row that lane 8 i + l // 4 points at."""
    return [[int(stage[offs[8 * i + l // 4] + l % 4]) for i in range(4)]
            for l in range(32)]


@pytest.mark.parametrize("sizes", [PREFIX_BLOCK, BATCHED_TABLE])
def test_ldmatrix_offsets_give_the_b1_fragments(sizes):
    """The kernel's ldmatrix lane offsets (a_off, b_off in
    hamming_mma.cuh) load, for every warp and k-step, the m16n8k256 b1
    fragments: a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4],
    a3 = A[g+8][t+4] (A the warp's 16 query rows), b0 = B[g][t],
    b1 = B[g][t+4] for each n8 tile of classes; and the product the PTX
    layout defines (bit i of a_r at k = 32 t + 128 (r >> 1) + i, the same
    for b) is the count of shared set bits over the eight words."""
    wq, wc, nt, kc = (sizes[k] for k in ("wq", "wc", "nt", "kc"))
    SW, BQ, BC = kc + 4, 16 * wq, 8 * nt * wc
    rows = BQ + BC
    rng = np.random.default_rng(3)
    stage = torch.from_numpy(rng.integers(0, 2 ** 32, rows * SW,
                                          dtype=np.uint64).astype(np.int64))
    word = lambda r, w: int(stage[r * SW + w])        # noqa: E731
    for warp in range(wq * wc):
        wq_, wc_ = warp % wq, warp // wq
        rq, rc = 16 * wq_, BQ + 8 * nt * wc_
        for j in range(kc // 8):
            a_offs = [(rq + (l & 7) + 8 * ((l >> 3) & 1)) * SW + 4 * (l >> 4)
                      + 8 * j for l in range(32)]
            A = ldmatrix_x4(stage, a_offs)
            for ntile in range(0, nt, 2):
                b_offs = [(rc + (l & 7) + 8 * (l >> 4)) * SW
                          + 4 * ((l >> 3) & 1) + ntile * 8 * SW + 8 * j
                          for l in range(32)]
                Bq = ldmatrix_x4(stage, b_offs)
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    k0 = 8 * j
                    assert A[lane] == [word(rq + g, k0 + t),
                                       word(rq + g + 8, k0 + t),
                                       word(rq + g, k0 + t + 4),
                                       word(rq + g + 8, k0 + t + 4)]
                    for half in range(2):
                        cls = rc + 8 * (ntile + half) + g
                        assert Bq[lane][2 * half:2 * half + 2] == [
                            word(cls, k0 + t), word(cls, k0 + t + 4)]
                # the product of tile ntile by the PTX layout: a_r of lane
                # (g, t) meets b_(r >> 1) of every lane (g', t)
                dot = torch.zeros((16, 8), dtype=torch.int64)
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    for r in range(4):
                        for gb in range(8):
                            b = Bq[4 * gb + t][r >> 1]
                            dot[g + 8 * (r & 1), gb] += \
                                bin(A[lane][r] & b).count("1")
                want = torch.tensor([[sum(
                    bin(word(rq + r, 8 * j + w)
                        & word(rc + 8 * ntile + c, 8 * j + w)).count("1")
                    for w in range(8)) for c in range(8)]
                    for r in range(16)])
                assert torch.equal(dot, want)
