"""Port parity: the plain versions of the port's CUDA kernels against the
JAX Pallas kernels in interpret mode, and the wrappers' routing (a CPU
tensor never reaches the kernel loader)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aligner as jal
from repro.core import item_memory as jim
from repro.core.types import TorrConfig as JCfg
from repro.kernels import fused_window as jfw
from repro_torch.core import aligner, item_memory
from repro_torch.core.types import TorrConfig
from repro_torch.kernels import build, fused_window, ops, ref

from _torch_parity import SMALL, assert_same, bipolar, pack_np, words


def _words(rng, n, W):
    w = rng.integers(0, 2 ** 32, (n, W), dtype=np.uint64).astype(np.uint32)
    w[::3, 0] |= np.uint32(1 << 31)
    return w


@pytest.mark.parametrize("N,M,W,cap", [(4, 8, 32, 8), (16, 64, 64, 8),
                                       (5, 64, 64, 4), (8, 32, 128, 1),
                                       (5, 37, 32, 4), (3, 13, 8, 8)])
def test_bank_prefix_hamming_matches_pallas(N, M, W, cap):
    """The plain version == the interpret-mode Pallas grid, over caps
    {1, 4, 8} and ragged N and M (the JAX grid clips its tiles to
    divisors)."""
    rng = np.random.default_rng(N * 1000 + M)
    q, h = _words(rng, N, W), _words(rng, M, W)
    want = jfw.bank_prefix_hamming(jnp.asarray(q), jnp.asarray(h), cap=cap,
                                   interpret=True)
    got = fused_window.bank_prefix_hamming(
        torch.from_numpy(q.view(np.int32)), torch.from_numpy(h.view(np.int32)),
        cap=cap)
    assert got.dtype == torch.int32 and got.shape == (N, M, cap)
    assert_same(got, want)


@pytest.mark.parametrize("kw", [dict(SMALL),
                                dict(D=4096, B=8, M=24, K=4, N_max=4,
                                     delta_budget=64)])
def test_plan_prefix_hamming_reduced_planes(kw):
    """Column selection + kernel for every (cap, planes) plan, including
    reduced bit-plane plans read from ``pmajor``, == JAX's."""
    tcfg, jcfg = TorrConfig(**kw), JCfg(**kw)
    rng = np.random.default_rng(5)
    bip = bipolar(rng, (tcfg.M, tcfg.D))
    q = pack_np(bipolar(rng, (11, tcfg.D)))
    im = item_memory.build_item_memory(torch.from_numpy(bip))
    jm = jim.build_item_memory(jnp.asarray(bip))
    qt = torch.from_numpy(q.view(np.int32))
    for cap in (1, 3, tcfg.B):
        for planes in (1, 2, tcfg.bit_planes):
            got = aligner.plan_prefix_hamming(qt, im, tcfg, planes=planes,
                                              cap=cap)
            want = jal.plan_prefix_hamming(jnp.asarray(q), jm, jcfg,
                                           planes=planes, cap=cap,
                                           interpret=True)
            assert_same(got, want, (cap, planes))


@pytest.mark.parametrize("N,d,D", [(8, 64, 512), (16, 512, 4096),
                                   (8, 100, 1024), (3, 33, 256)])
def test_sign_project_pack_agreement_with_pallas(N, d, D):
    rng = np.random.default_rng(d)
    z = rng.standard_normal((N, d)).astype(np.float32)
    R = rng.standard_normal((D, d)).astype(np.float32)
    zt, Rt = torch.from_numpy(z), torch.from_numpy(R)
    got = fused_window.sign_project_pack(zt, Rt)
    assert got.dtype == torch.int32 and got.shape == (N, D // 32)
    tn = 8 if N % 8 == 0 else N
    want = jfw.sign_project_pack(jnp.asarray(z), jnp.asarray(R), tn=tn,
                                 td=min(256, D), interpret=True)
    want = torch.from_numpy(words(want).view(np.int32).copy())
    rule = ref.sign_pack_disagreement(zt, Rt, got, want)
    assert rule["ok"], rule
    assert torch.equal(ops.encode_packed(z, R, device="cpu"), got)


def test_sign_pack_rule_counts_disagreements():
    """The rule flags a flipped decided bit and tolerates none of them."""
    rng = np.random.default_rng(7)
    z = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32))
    R = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    w = ref.sign_project_pack_ref(z, R)
    assert ref.sign_pack_disagreement(z, R, w, w)["ok"]
    bad = w.clone()
    bad[0, 0] ^= 1
    rule = ref.sign_pack_disagreement(z, R, w, bad)
    assert not rule["ok"] and rule["decided_differ"] == 1


def test_cpu_tensors_never_reach_the_kernel_loader(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("kernel loader reached from a CPU tensor")

    monkeypatch.setattr(build, "launch_fn", refuse)
    monkeypatch.setattr(build, "build_all", refuse)
    before = dict(fused_window.LAUNCHES)
    q = torch.zeros((4, 16), dtype=torch.int32)
    fused_window.bank_prefix_hamming(q, q, cap=4)
    z = torch.zeros((2, 8))
    fused_window.sign_project_pack(z, torch.ones((64, 8)))
    ops.encode_packed(z, torch.ones((64, 8)), device="cpu")
    assert fused_window.LAUNCHES == before   # plain versions launch nothing


def test_wrappers_reject_bad_inputs(monkeypatch):
    q = torch.zeros((4, 16), dtype=torch.int32)
    with pytest.raises(ValueError):
        fused_window.bank_prefix_hamming(q, q, cap=3)       # 16 % 3
    with pytest.raises(TypeError):
        fused_window.bank_prefix_hamming(q.float(), q, cap=4)
    with pytest.raises(ValueError):      # neither the CPU nor a CUDA device
        fused_window.bank_prefix_hamming(q.to("meta"), q.to("meta"), cap=4)
    with pytest.raises(ValueError):
        fused_window.sign_project_pack(torch.zeros((2, 8)),
                                       torch.zeros((48, 8)))
    with pytest.raises(TypeError):
        fused_window.sign_project_pack(torch.zeros((2, 8)),
                                       torch.zeros((64, 8), dtype=torch.float64))
    # the entry point defaults to the GPU and never falls back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.encode_packed(np.zeros((2, 8)), np.ones((64, 8)))


def test_build_tag_follows_every_shared_header(monkeypatch, tmp_path):
    """A library's tag hashes its source, every ``csrc/*.cuh`` (a source
    may include any of them) and the flags: an edited header never loads a
    stale library. Needs no nvcc: it computes tags only."""
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// v1\n")
    (tmp_path / "other.cuh").write_text("// v1\n")
    tags = [build._target("k")]
    (tmp_path / "shared.cuh").write_text("// v2\n")
    tags.append(build._target("k"))
    (tmp_path / "other.cuh").write_text("// v2\n")
    tags.append(build._target("k"))
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n// edited\n')
    tags.append(build._target("k"))
    assert len(set(tags)) == 4, tags
    assert all(t.parent == build.BUILD_DIR and t.name.startswith("k-")
               for t in tags)
    (tmp_path / "shared.cuh").write_text("// v1\n")   # back to the first
    (tmp_path / "other.cuh").write_text("// v1\n")
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    assert build._target("k") == tags[0]
