"""The precision argument of the encode kernels (``csrc/sign_gemm.cuh``),
pinned on the CPU: their 3xTF32 arithmetic, emulated in torch, keeps
sign(z @ R.T) inside the agreement rule of ``ref.sign_disagreement`` with a
tenfold margin, where one TF32 product does not; and an all-zero row and a
NaN row code exactly as the plain version does.

The emulation follows the kernels: every operand element x is split into
big = rna(x) and small = rna(x - big), rna being cvt.rna.tf32.f32 (round
to nearest, ties away, to 10 mantissa bits, through the int32 bit
pattern); each k8 step adds the exact float64 sum of its eight
small*big, then big*small, then big*big products to a float32
accumulator, one rounding per mma."""
import numpy as np
import pytest
import torch

from repro_torch.core import hdc
from repro_torch.data import tood_synth as ts
from repro_torch.kernels import ref


def _rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: NaN and inf pass through."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def _split(x: torch.Tensor):
    big = _rna(x)
    return big, _rna(x - big)


def _emulate(z: torch.Tensor, R: torch.Tensor, terms=3) -> torch.Tensor:
    """float32 y = z @ R.T as the kernels compute it (``terms=3``), or as
    one TF32 product (``terms=1``)."""
    zb, zs = _split(z)
    rb, rs = _split(R)
    if terms == 1:
        pairs = ((zb, rb),)
    else:   # the small terms first, then big*big
        pairs = ((zs, rb), (zb, rs), (zb, rb))
    acc = torch.zeros((z.shape[0], R.shape[0]), dtype=torch.float32)
    for k in range(0, z.shape[1], 8):
        for a, b in pairs:
            part = a[:, k:k + 8].double() @ b[:, k:k + 8].double().T
            acc = (acc.double() + part).float()
    return acc


def _codes(y: torch.Tensor) -> torch.Tensor:
    return torch.where(y >= 0.0, 1, -1).to(torch.int8)


def _inputs(source, N, d, D, seed):
    rng = np.random.default_rng(seed)
    if source == "normal":
        z = rng.standard_normal((N, d)).astype(np.float32)
    else:   # proposal features of a TOOD sequence, padding rows included
        world = ts.make_world(seed, M=64, d=d, n_tasks=5)
        frames = ts.simulate_sequence(world, 1, -(-N // 16), seed, n_max=16)
        z = np.concatenate([f.feats for f in frames])[:N]
    R = (rng.standard_normal((D, d)) / np.sqrt(d)).astype(np.float32)
    return torch.from_numpy(z), torch.from_numpy(R)


@pytest.mark.parametrize("source", ["normal", "tood"])
@pytest.mark.parametrize("N,d,D", [(8, 512, 8192), (128, 512, 8192),
                                   (37, 512, 8160)])
def test_3xtf32_stays_inside_the_agreement_rule(source, N, d, D):
    z, R = _inputs(source, N, d, D, seed=N + D)
    codes = _codes(_emulate(z, R))
    rule = ref.sign_disagreement(z, R, codes, ref.sign_project_ref(z, R))
    assert rule["decided_differ"] == 0, rule
    # a tenfold margin on the rule's 1e-4 of undecided codes
    assert rule["undecided_differ"] <= max(1, 1e-5 * rule["bits"]), rule
    # the packed kernel's words are the same bits, bit i of word w = dim
    # 32w + i
    words = hdc.pack_bits(codes)
    assert ref.sign_pack_disagreement(
        z, R, words, ref.sign_project_pack_ref(z, R)) == rule


def test_one_tf32_product_breaks_the_margin():
    """Why the kernels pay for three products: one TF32 product flips
    more undecided codes than the tenfold margin allows."""
    z, R = _inputs("normal", 128, 512, 8192, seed=3)
    want = ref.sign_project_ref(z, R)
    one = ref.sign_disagreement(z, R, _codes(_emulate(z, R, terms=1)), want)
    three = ref.sign_disagreement(z, R, _codes(_emulate(z, R)), want)
    assert one["undecided_differ"] > 1e-5 * one["bits"], one
    assert three["undecided_differ"] < one["undecided_differ"] // 10, three


def test_zero_and_nan_rows_code_as_the_plain_version():
    z, R = _inputs("normal", 6, 40, 96, seed=5)
    z[1] = 0.0                      # every y is +-0: every code +1
    z[3, 7] = float("nan")          # one NaN makes the row's y NaN: -1
    z[4] = float("nan")
    got = _codes(_emulate(z, R))
    want = ref.sign_project_ref(z, R)
    for row in (1, 3, 4):
        assert torch.equal(got[row], want[row]), row
    assert bool((got[1] == 1).all()) and bool((got[3] == -1).all())
    assert torch.equal(hdc.pack_bits(got)[[1, 3, 4]],
                       ref.sign_project_pack_ref(z, R)[[1, 3, 4]])


def test_split_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10                # TF32's mantissa step at 1.0
    x = torch.tensor([1 + ulp / 2, 1 + ulp / 2 - 2 ** -23, -(1 + ulp / 2),
                      3.0, float("inf"), float("nan")])
    big = _rna(x)
    assert big[:4].tolist() == [1 + ulp, 1.0, -(1 + ulp), 3.0]
    assert big[4] == float("inf") and bool(torch.isnan(big[5]))
    # big + small keeps all but about 2^-22 of x
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32))
    b, s = _split(v)
    assert bool(((v.double() - b.double() - s.double()).abs()
                 <= 2.0 ** -22 * v.double().abs()).all())
    # both parts are TF32: the low 13 bits are zero
    assert not bool(((b.view(torch.int32) | s.view(torch.int32))
                     & 0x1FFF).any())
