"""Port parity: the recurrent blocks (``repro_torch.models.recurrent`` vs
``repro.models.recurrent``) in float32 at small widths, every leaf drawn
with numpy and handed to both packages.

Tolerances are those of the reference's own ``tests/test_recurrent.py``:
rtol 2e-4 / atol 2e-5 for mLSTM, atol 1e-4 (rtol 1e-4) for RG-LRU and
sLSTM, on each block's prefill output and final state and on each decode
step's output and state. The log-depth scan follows
``jax.lax.associative_scan``'s recursion, so it is held bit for bit to the
reference run op by op; compiled, XLA contracts its a2 * b1 + b2 into a
fused multiply-add, which torch's CPU kernels do not, so against the
jitted scan it is held to one float32 ulp of each value (rtol 2^-23).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import recurrent as jrec
from repro.models.config import ModelConfig as JConfig
from repro_torch.models import recurrent as trec
from repro_torch.models.config import ModelConfig

MLSTM_TOL = dict(rtol=2e-4, atol=2e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
B, S, STEPS = 2, 16, 4
HYB = dict(name="t", family="hybrid", d_model=16, lru_width=24)
SSM = dict(name="t", family="ssm", d_model=32, n_heads=2, mlstm_chunk=8)


def _draw(init, jcfg, seed, uniform=()):
    """numpy float32 leaves shaped as the reference block's parameters:
    a matrix ~ N(0, 1/fan_in) (fan_in its second-to-last dimension), a
    vector ~ N(0, 0.3^2), a leaf named in ``uniform`` ~ U(2, 5) (RG-LRU's
    Lambda, as the reference draws it)."""
    shapes = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), jcfg,
                                         jnp.float32))
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in shapes.items():
        if k in uniform:
            out[k] = rng.uniform(2.0, 5.0, s.shape).astype(np.float32)
        elif len(s.shape) >= 2:
            out[k] = (rng.standard_normal(s.shape)
                      / np.sqrt(s.shape[-2])).astype(np.float32)
        else:
            out[k] = (0.3 * rng.standard_normal(s.shape)).astype(np.float32)
    return out


def _port(init, cfg, tree):
    p = init(cfg, torch.float32, device="meta").to_empty(device="cpu")
    with torch.no_grad():
        for name, param in p.named_parameters():
            assert tuple(param.shape) == tree[name].shape, name
            param.copy_(torch.from_numpy(tree[name]))
    return p


def _pair(kind, seed=0):
    """(jcfg, jax params, cfg, port params) of one block."""
    over = HYB if kind == "rglru" else SSM
    jcfg, cfg = JConfig(**over), ModelConfig(**over)
    jinit = getattr(jrec, f"init_{kind}_params")
    tinit = getattr(trec, f"init_{kind}_params")
    tree = _draw(jinit, jcfg, seed, uniform=("lam",))
    jp = {k: jnp.asarray(v) for k, v in tree.items()}
    return jcfg, jp, cfg, _port(tinit, cfg, tree)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, what, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), err_msg=what, **tol)


def _state_close(got: dict, want: dict, what, tol):
    assert set(got) == set(want), what
    for k in want:
        _close(got[k], want[k], f"{what} {k}", tol)


JIT = {name: jax.jit(getattr(jrec, name), static_argnums=2) for name in (
    "rglru_prefill", "mlstm_prefill", "slstm_prefill", "rglru_train",
    "mlstm_train", "slstm_train")}
JDEC = {name: jax.jit(getattr(jrec, name), static_argnums=3) for name in (
    "rglru_decode", "mlstm_decode", "slstm_decode")}
TOLS = {"rglru": TOL, "mlstm": MLSTM_TOL, "slstm": TOL}


def test_softplus_and_log_sigmoid_match_jax():
    x = np.concatenate([np.linspace(-40, 40, 4001, dtype=np.float32),
                        np.float32([0.0, 19.99, 20.0, 20.01, 88.0, -88.0])])
    t = torch.from_numpy(x)
    # atol: XLA flushes float32 denormals to zero (softplus(-88))
    _close(trec.softplus(t), jax.nn.softplus(jnp.asarray(x)), "softplus",
           dict(rtol=1e-6, atol=1e-30))
    _close(F.logsigmoid(t), jax.nn.log_sigmoid(jnp.asarray(x)),
           "log_sigmoid", dict(rtol=1e-6, atol=1e-30))
    # above F.softplus's threshold of 20 both return x itself
    assert torch.equal(trec.softplus(t)[x > 20], t[x > 20])


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13, 16, 33])
def test_associative_scan_follows_jax_bit_for_bit(n):
    a = np.random.default_rng(n).uniform(0.1, 1.0, (2, n, 3)).astype(
        np.float32)
    b = _x((2, n, 3), n + 100)

    def combine(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]

    ja, jb = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                jnp.asarray(b)), axis=1)
    ta, tb = trec._associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    _, jb = jax.jit(lambda a, b: jax.lax.associative_scan(
        combine, (a, b), axis=1))(a, b)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=2.0 ** -23,
                               atol=2.0 ** -23)


@pytest.mark.parametrize("chunk", [1, 4, 8, 16])
def test_mlstm_chunk_scan_matches_reference(chunk):
    rng = np.random.default_rng(chunk)
    H, dh = 2, 4
    q, k, v = (rng.standard_normal((1, S, H, dh)).astype(np.float32)
               for _ in range(3))
    ig = (2 * rng.standard_normal((1, S, H))).astype(np.float32)
    fg = np.asarray(jax.nn.log_sigmoid(
        2 * rng.standard_normal((1, S, H)).astype(np.float32)))
    jh, jst = jax.jit(jrec._mlstm_chunk_scan, static_argnums=5)(
        q, k, v, ig, fg, chunk)
    th, tst = trec._mlstm_chunk_scan(*(torch.from_numpy(np.asarray(a))
                                       for a in (q, k, v, ig, fg)), chunk)
    _close(th, jh, "h", MLSTM_TOL)
    for name, g, w in zip("Cnm", tst, jst):
        _close(g, w, name, MLSTM_TOL)
    with pytest.raises(ValueError, match="chunk"):
        trec._mlstm_chunk_scan(*(torch.from_numpy(np.asarray(a))[:, :S - 1]
                                 for a in (q, k, v, ig, fg)), 4)


@pytest.mark.parametrize("kind", ["rglru", "mlstm", "slstm"])
def test_block_prefill_and_decode_match_reference(kind):
    """Prefill of S tokens (output and final state), then STEPS decode
    steps from that state (outputs and states), each against the
    reference fed the same inputs."""
    jcfg, jp, cfg, tp = _pair(kind)
    tol = TOLS[kind]
    x = _x((B, S + STEPS, cfg.d_model), 7)
    jy, jst = JIT[f"{kind}_prefill"](jp, jnp.asarray(x[:, :S]), jcfg)
    ty, tst = getattr(trec, f"{kind}_prefill")(tp, torch.from_numpy(
        x[:, :S]), cfg)
    _close(ty, jy, f"{kind} prefill y", tol)
    _state_close(tst, jst, f"{kind} prefill state", tol)
    tst = {k: v.clone() for k, v in tst.items()}
    for t in range(S, S + STEPS):
        xt = x[:, t:t + 1]
        jy, jst = JDEC[f"{kind}_decode"](jp, jnp.asarray(xt), jst, jcfg)
        ty, tst = getattr(trec, f"{kind}_decode")(tp, torch.from_numpy(xt),
                                                  tst, cfg)
        _close(ty, jy, f"{kind} decode {t}", tol)
        _state_close(tst, jst, f"{kind} decode state {t}", tol)


@pytest.mark.parametrize("kind", ["rglru", "mlstm", "slstm"])
def test_train_forwards_match_reference(kind):
    jcfg, jp, cfg, tp = _pair(kind, seed=1)
    x = _x((B, S, cfg.d_model), 8)
    _close(getattr(trec, f"{kind}_train")(tp, torch.from_numpy(x), cfg),
           JIT[f"{kind}_train"](jp, jnp.asarray(x), jcfg), f"{kind} train",
           TOLS[kind])


@pytest.mark.parametrize("kind", ["rglru", "mlstm", "slstm"])
def test_decode_from_init_state_updates_it_in_place(kind):
    """From the init state (mLSTM's and sLSTM's m at -1e30, so exp(m - g)
    is exactly 0): the decode writes every leaf in place, the addresses
    stay, and the step equals the reference's."""
    jcfg, jp, cfg, tp = _pair(kind, seed=2)
    if kind == "slstm":
        jst = jrec.slstm_init_state(jcfg, B)
        tst = trec.slstm_init_state(cfg, B)
    else:
        jst = getattr(jrec, f"{kind}_init_state")(jcfg, B, jnp.float32)
        tst = getattr(trec, f"{kind}_init_state")(cfg, B, torch.float32)
    if "m" in tst:
        assert bool((tst["m"] == -1e30).all()) and tst["m"].dtype == \
            torch.float32
    ptrs = {k: v.data_ptr() for k, v in tst.items()}
    before = {k: v.clone() for k, v in tst.items()}
    x = _x((B, 1, cfg.d_model), 9)
    jy, jst = JDEC[f"{kind}_decode"](jp, jnp.asarray(x), jst, jcfg)
    ty, out = getattr(trec, f"{kind}_decode")(tp, torch.from_numpy(x), tst,
                                              cfg)
    assert out is tst and {k: v.data_ptr() for k, v in tst.items()} == ptrs
    changed = [k for k in tst if not torch.equal(tst[k], before[k])]
    assert set(changed) == set(tst), changed
    _close(ty, jy, kind, TOLS[kind])
    _state_close(tst, jst, kind, TOLS[kind])
    if kind == "mlstm":
        # f_s = exp(fg + m - m_new) = 0 exactly: C is i_s * k v^T alone
        assert np.isfinite(tst["C"].numpy()).all()


def test_group_norm_is_the_population_variance():
    h = torch.from_numpy(_x((3, 5, 8), 10))
    scale = torch.ones(8)
    got = trec._group_norm(h, 2, scale, torch.float32)
    hg = np.asarray(h).reshape(3, 5, 2, 4)
    want = ((hg - hg.mean(-1, keepdims=True))
            / np.sqrt(hg.var(-1, keepdims=True) + 1e-6)).reshape(3, 5, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
