"""Port parity: the spiking encoder (``repro_torch.core.encoder`` vs
``repro.core.encoder``, paper Sec. 3.2).

Tolerances:

* ``z_e``: rtol = atol = 1e-5 per proposal. A proposal may miss it only
  where the reference's membrane potential at some bin lies within 1e-4 of
  the threshold (a spike two float computations may fire differently;
  recomputed here from ``repro.core.encoder._conv`` and ``spike``), and at
  most 1 % of the proposals may be so excused.
* Gradients through the surrogate: ||g_port - g_ref|| <= 1e-4 ||g_ref||
  per tensor.
* The surrogate's backward against its formula and the convolution's
  ``"SAME"`` padding against XLA's: 1e-6 relative (one float expression).
* ``query_hv``: ``kernels.ref.sign_disagreement``'s agreement rule.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import bridge as jb
from repro.core import encoder as je
from repro.core import hdc as jhdc
from repro_torch import convert
from repro_torch.core import bridge as tb
from repro_torch.core import encoder as te
from repro_torch.kernels import ref

ZE_TOL = 1e-5
EXCUSE_BAND = 1e-4
GRAD_TOL = 1e-4


def _cfgs(**kw):
    return je.EncoderConfig(**kw), te.EncoderConfig(**kw)


def _weights(cfg, seed=0):
    """He-scaled weights drawn with numpy (HWIO, as ``repro`` stores them),
    in both packages; the head bias is not zero, so it is exercised."""
    rng = np.random.default_rng(seed)

    def he(shape, fan_in):
        return (rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
                ).astype(np.float32)

    leaves = (he((3, 3, 2, cfg.c1), 18),
              he((3, 3, cfg.c1, cfg.c2), 9 * cfg.c1),
              he((cfg.c2, cfg.feat_dim), cfg.c2),
              0.1 * he((cfg.feat_dim,), 1))
    return (je.EncoderParams(*(jnp.asarray(a) for a in leaves)),
            convert.encoder_from_numpy(*leaves))


def _volumes(seed, n, t_bins, height, width, rate=0.4):
    """Event counts per (bin, pixel, polarity), as ``aggregate_window``
    makes them."""
    rng = np.random.default_rng(seed)
    return rng.poisson(rate, (n, t_bins, height, width, 2)).astype(np.float32)


@functools.partial(jax.jit, static_argnums=2)
def _ref_margins(p, vols, cfg):
    """Per proposal, the least |v - thresh| of any membrane potential at any
    bin in ``repro``'s encoder (its ``_conv`` and ``spike``, the scan's
    order)."""
    def one(vol):
        T, H, W, _ = vol.shape
        h1, w1 = -(-H // 2), -(-W // 2)
        h2, w2 = -(-h1 // 2), -(-w1 // 2)

        def step(carry, x_t):
            v1, v2, m = carry
            v1 = cfg.tau * v1 + je._conv(x_t[None], p.conv1, 2)[0]
            s1 = je.spike(v1 - cfg.thresh)
            m = jnp.minimum(m, jnp.min(jnp.abs(v1 - cfg.thresh)))
            v1 = v1 - s1 * cfg.thresh
            v2 = cfg.tau * v2 + je._conv(s1[None], p.conv2, 2)[0]
            s2 = je.spike(v2 - cfg.thresh)
            m = jnp.minimum(m, jnp.min(jnp.abs(v2 - cfg.thresh)))
            v2 = v2 - s2 * cfg.thresh
            return (v1, v2, m), None

        init = (jnp.zeros((h1, w1, p.conv1.shape[-1])),
                jnp.zeros((h2, w2, p.conv2.shape[-1])), jnp.float32(jnp.inf))
        (_, _, m), _ = jax.lax.scan(step, init, vol)
        return m

    return jax.vmap(one)(vols)


_ref_encode_batch = jax.jit(je.encode_batch, static_argnums=2)


def _hold_to_rule(z_port, z_ref, margins):
    """The z_e rule; returns the number of excused proposals."""
    ok = np.isclose(z_port, z_ref, rtol=ZE_TOL, atol=ZE_TOL).all(axis=1)
    missed = np.flatnonzero(~ok)
    unexcused = missed[margins[missed] >= EXCUSE_BAND]
    assert unexcused.size == 0, (
        f"proposals {unexcused.tolist()} miss the tolerance with no "
        f"potential within {EXCUSE_BAND} of the threshold")
    assert missed.size <= 0.01 * len(ok), f"{missed.size} of {len(ok)} excused"
    return missed.size


@pytest.mark.parametrize("height,width", [(16, 16), (15, 17)])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_same_pads_as_xla(height, width, stride):
    """``conv_same`` == ``repro``'s ``_conv`` (XLA ``"SAME"``). At 16x16,
    stride 2, XLA pads one row and column at the bottom and right only;
    symmetric ``padding=1`` would be off by far more than the tolerance
    there, which the second check pins."""
    rng = np.random.default_rng(height * width + stride)
    x = rng.standard_normal((3, height, width, 5)).astype(np.float32)
    w = rng.standard_normal((3, 3, 5, 4)).astype(np.float32)
    want = np.asarray(jax.jit(je._conv, static_argnums=2)(x, w, stride))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = torch.from_numpy(w).permute(3, 2, 0, 1)
    got = te.conv_same(xt, wt, stride).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    sym = F.conv2d(xt, wt, stride=stride, padding=1).permute(0, 2, 3, 1)
    if (height % 2 == 0 and stride == 2):
        assert np.abs(sym.numpy() - want).max() > 1.0


def test_same_pad_is_xla_s():
    for size in range(1, 40):
        for k, s in ((3, 1), (3, 2), (1, 2), (5, 3)):
            (lo, hi), = jax.lax.padtype_to_pads((size,), (k,), (s,), "SAME")
            assert te.same_pad(size, k, s) == (lo, hi), (size, k, s)


@pytest.mark.parametrize("height,width,n", [(16, 16, 100), (15, 17, 100)])
def test_encode_batch_matches_reference(height, width, n):
    cfg_j, cfg_t = _cfgs()                  # c1 16, c2 32, feat_dim 512
    p, enc = _weights(cfg_j)
    vols = _volumes(height + width, n, 4, height, width)
    z_ref = np.asarray(_ref_encode_batch(p, jnp.asarray(vols), cfg_j))
    margins = np.asarray(_ref_margins(p, jnp.asarray(vols), cfg_j))
    with torch.no_grad():
        z = te.encode_batch(enc, torch.from_numpy(vols), cfg_t)
    _hold_to_rule(z.numpy(), z_ref, margins)
    one = te.encode(enc, torch.from_numpy(vols[3]), cfg_t).detach()
    np.testing.assert_allclose(one.numpy(), z.numpy()[3], rtol=1e-6,
                               atol=1e-6)


def test_spike_forward_is_strict_and_backward_is_the_surrogate():
    v = torch.tensor([-2.0, -0.25, 0.0, 1e-7, 0.3, 3.0], requires_grad=True)
    g = torch.linspace(0.5, 2.0, v.numel())
    s = te.spike(v)
    assert s.tolist() == [0.0, 0.0, 0.0, 1.0, 1.0, 1.0]
    (gv,) = torch.autograd.grad(s, v, g)
    sig = torch.sigmoid(4.0 * v.detach())
    np.testing.assert_allclose(gv.numpy(), (g * 4.0 * sig * (1 - sig))
                               .numpy(), rtol=1e-6)
    want = jax.vjp(je.spike, jnp.asarray(v.detach().numpy()))[1](
        jnp.asarray(g.numpy()))[0]
    np.testing.assert_allclose(gv.numpy(), np.asarray(want), rtol=1e-6)


def test_conv_backward_is_autograd_s():
    """``_ConvFP32``'s hand-written backward == autograd through
    ``F.conv2d``."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((4, 3, 9, 8))
                         .astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((6, 3, 3, 3))
                         .astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((4, 6, 4, 3))
                         .astype(np.float32))
    got = torch.autograd.grad(te._ConvFP32.apply(x, w, 2), (x, w), g)
    want = torch.autograd.grad(F.conv2d(x, w, stride=2), (x, w), g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_bridge_gradients_match_reference():
    """The bridge loss's gradients through the encoder (the surrogate at
    every spike), per tensor, at the trainer's batch."""
    cfg_j, cfg_t = _cfgs(c1=8, c2=16, feat_dim=64)
    p, enc = _weights(cfg_j, seed=3)
    vols = _volumes(11, 16, 4, 16, 16, rate=0.6)
    rng = np.random.default_rng(12)
    img = rng.standard_normal((16, 64)).astype(np.float32)
    bank = rng.standard_normal((8, 64)).astype(np.float32)
    labels = rng.integers(0, 8, 16).astype(np.int32)

    def loss_j(p):
        ev = je.encode_batch(p, jnp.asarray(vols), cfg_j)
        return jb.bridge_loss(jnp.asarray(img), ev, jnp.asarray(bank),
                              jnp.asarray(labels))[0]

    (l_ref, g_ref) = jax.jit(jax.value_and_grad(loss_j))(p)
    loss, _ = tb.bridge_loss(
        torch.from_numpy(img),
        te.encode_batch(enc, torch.from_numpy(vols), cfg_t),
        torch.from_numpy(bank), torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(l_ref), rtol=1e-5)
    g_port = convert.encoder_to_numpy(
        {k: v.grad for k, v in enc.named_parameters()})
    for name in ("conv1", "conv2", "head", "head_b"):
        want = np.asarray(getattr(g_ref, name))
        assert np.linalg.norm(want) > 0, name
        err = np.linalg.norm(g_port[name] - want)
        assert err <= GRAD_TOL * np.linalg.norm(want), (name, err)


def test_query_hv_agrees_with_reference():
    cfg_j, cfg_t = _cfgs(c1=8, c2=16, feat_dim=64)
    p, enc = _weights(cfg_j, seed=1)
    R = (np.random.default_rng(2).standard_normal((1024, 64)) / 8.0
         ).astype(np.float32)
    vols = _volumes(4, 6, 4, 16, 16)
    q_ref = np.stack([np.asarray(je.query_hv(p, jnp.asarray(v), R, cfg_j))
                      for v in vols[:2]])
    q = te.query_hv(enc, torch.from_numpy(vols), torch.from_numpy(R),
                    cfg_t)
    assert q.dtype == torch.int8 and q.shape == (6, 1024)
    z = te.encode_batch(enc, torch.from_numpy(vols), cfg_t).detach()
    rule = ref.sign_disagreement(z[:2], torch.from_numpy(R), q[:2],
                                 torch.from_numpy(q_ref))
    assert rule["ok"], rule
    one = te.query_hv(enc, torch.from_numpy(vols[5]), torch.from_numpy(R),
                      cfg_t)
    assert torch.equal(one, q[5])
    # the reference's hdc.sign_project on the port's features: the rule
    want = np.array(jhdc.sign_project(jnp.asarray(z.numpy()),
                                      jnp.asarray(R)))
    assert ref.sign_disagreement(z, torch.from_numpy(R), q,
                                 torch.from_numpy(want))["ok"]


def test_init_encoder_shapes_and_scales():
    cfg = te.EncoderConfig()
    enc = te.init_encoder(cfg, torch.Generator().manual_seed(0))
    shapes = {k: tuple(v.shape) for k, v in enc.named_parameters()}
    assert shapes == {"conv1": (16, 2, 3, 3), "conv2": (32, 16, 3, 3),
                      "head": (32, 512), "head_b": (512,)}
    for name, fan_in in (("conv1", 18), ("conv2", 144), ("head", 32)):
        std = float(getattr(enc, name).detach().std())
        assert abs(std / np.sqrt(2.0 / fan_in) - 1) < 0.15, name
    assert not enc.head_b.any()
    R = te.make_projection(256, 64, torch.Generator().manual_seed(1))
    assert R.shape == (256, 64)
    assert abs(float(R.std()) * 8 - 1) < 0.05
