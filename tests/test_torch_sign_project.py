"""Port parity for ``ops.sign_project``, the int8 bipolar projection: the
port on the CPU (the kernel's plain version) against ``repro``'s
``ops.sign_project`` (the Pallas kernel in interpret mode, or its oracle
off-tile) under the agreement rule of ``ref.sign_disagreement``, plus the
wrapper's routing and input checks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import sign_project as sp


def _inputs(N, d, D, seed):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((N, d)).astype(np.float32)
    R = (rng.standard_normal((D, d)) / np.sqrt(d)).astype(np.float32)
    return z, R


@pytest.mark.parametrize("N,d,D", [(8, 512, 8192),    # the caller's shape
                                   (37, 512, 8160),   # ragged: JAX's oracle
                                   (16, 64, 1024)])
def test_sign_project_agrees_with_jax(N, d, D):
    z, R = _inputs(N, d, D, seed=N + D)
    z[3] = 0.0                       # an all-zero row: every code is +1
    got = ops.sign_project(z, R, device="cpu")
    assert got.dtype == torch.int8 and got.shape == (N, D)
    want = torch.from_numpy(np.array(
        jops.sign_project(jnp.asarray(z), jnp.asarray(R), interpret=True)))
    rule = ref.sign_disagreement(torch.from_numpy(z), torch.from_numpy(R),
                                 got, want)
    assert rule["ok"], rule
    assert bool((got[3] == 1).all()) and bool((want[3] == 1).all())
    assert set(torch.unique(got).tolist()) <= {-1, 1}
    # the int8 codes and the packed encode front-end are one function
    assert torch.equal(ops.encode_packed(z, R, device="cpu"),
                       ref.sign_project_pack_ref(torch.from_numpy(z),
                                                 torch.from_numpy(R)))


def test_sign_rule_counts_disagreements_and_matches_the_packed_rule():
    """A flipped decided code fails the rule; the packed rule is the same
    rule over unpacked bits."""
    z, R = (torch.from_numpy(a) for a in _inputs(4, 32, 64, seed=7))
    codes = ref.sign_project_ref(z, R)
    assert ref.sign_disagreement(z, R, codes, codes)["ok"]
    bad = codes.clone()
    bad[0, 5] = -bad[0, 5]
    rule = ref.sign_disagreement(z, R, codes, bad)
    assert not rule["ok"] and rule["decided_differ"] == 1
    words, bad_words = (ref.sign_project_pack_ref(z, R),
                        ref.sign_project_pack_ref(z, R).clone())
    bad_words[0, 0] ^= 1 << 5
    assert ref.sign_pack_disagreement(z, R, words, bad_words) == rule


def test_sign_project_nan_and_zero():
    """sign(0) -> +1 and NaN -> -1, as ``jnp.where(y >= 0, 1, -1)``."""
    z = torch.tensor([[0.0, 0.0], [float("nan"), 1.0], [-1.0, 0.0]])
    R = torch.tensor([[1.0, 2.0], [-3.0, 0.5]])
    got = ops.sign_project(z, R, device="cpu")
    assert got.tolist() == [[1, 1], [-1, -1], [-1, 1]]
    want = np.asarray(jops.sign_project(jnp.asarray(z.numpy()),
                                        jnp.asarray(R.numpy())))
    assert got.numpy().tolist() == want.tolist()


def test_sign_project_routes_and_rejects(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("kernel loader reached from a CPU tensor")

    monkeypatch.setattr(build, "launch_fn", refuse)
    monkeypatch.setattr(build, "build_all", refuse)
    before = dict(build.LAUNCHES)
    z, R = torch.zeros((2, 8)), torch.ones((48, 8))
    assert bool((sp.sign_project(z, R) == 1).all())      # any D, no tiling
    assert build.LAUNCHES == before and "sign_project" in build.LAUNCHES
    with pytest.raises(TypeError):
        sp.sign_project(z.double(), R)
    with pytest.raises(ValueError):
        sp.sign_project(z, torch.ones((48, 4)))
    with pytest.raises(ValueError):
        sp.sign_project(z[:, :0], R[:, :0])
    with pytest.raises(ValueError):      # neither the CPU nor a CUDA device
        sp.sign_project(z.to("meta"), R.to("meta"))
    # the entry point defaults to the GPU and never falls back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.sign_project(np.zeros((2, 8)), np.ones((48, 8)))
