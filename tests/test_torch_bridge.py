"""Port parity: the contrastive bridge (Eq. 2-3) and AdamW
(``repro_torch.core.bridge`` and ``repro_torch.optim.adamw`` vs ``repro``'s).

Tolerances: losses and metrics rtol 1e-5; AdamW over 20 steps of fixed
gradients (warm-up and cosine, clipping on and off) rtol 1e-5 on every
parameter, moment and the learning rate; one trainer step (encoder, bridge
loss, AdamW) rtol 1e-5 on the updated parameters. Parameters and first
moments are O(1) sums of terms of either sign, so an entry near zero is held
to atol 1e-6 (an ulp of 1 is 1.2e-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bridge as jb
from repro.core import encoder as je
from repro.optim import adamw as jadam
from repro_torch import convert
from repro_torch.core import bridge as tb
from repro_torch.core import encoder as te
from repro_torch.optim import adamw as tadam

RTOL = 1e-5
PARAM_ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _emb(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("alpha,tau_c,tau_t", [(1.0, 0.07, 0.07),
                                               (0.3, 0.1, 0.05)])
def test_losses_and_metrics_match_reference(alpha, tau_c, tau_t):
    img, ev = _emb(0, (12, 32)), _emb(1, (12, 32))
    bank = _emb(2, (10, 32))
    labels = np.random.default_rng(3).integers(0, 10, 12).astype(np.int32)
    kw = dict(tau_c=tau_c, tau_t=tau_t, alpha=alpha)
    loss_j, m_j = jax.jit(lambda *a: jb.bridge_loss(*a, **kw))(
        img, ev, bank, labels)
    loss, m = tb.bridge_loss(_t(img), _t(ev), _t(bank), _t(labels), **kw)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=RTOL)
    for k in ("l_con", "l_zs", "zs_acc"):
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), rtol=RTOL)
    np.testing.assert_allclose(
        float(tb.info_nce(_t(img), _t(ev), tau_c)),
        float(jb.info_nce(img, ev, tau_c)), rtol=RTOL)
    np.testing.assert_allclose(
        float(tb.zero_shot_loss(_t(ev), _t(bank), _t(labels), tau_t)),
        float(jb.zero_shot_loss(ev, bank, labels, tau_t)), rtol=RTOL)


def test_zero_shot_accuracy_takes_the_first_maximum():
    """Duplicate text rows tie every event's logits: the first index wins,
    as ``jnp.argmax`` picks it."""
    bank = np.repeat(_emb(4, (3, 16)), 2, axis=0)        # rows 2k == 2k+1
    ev = bank[[1, 3, 5, 0]] * 2.0
    for labels in ([0, 2, 4, 0], [1, 3, 5, 1]):
        labels = np.array(labels, np.int32)
        _, m_j = jb.bridge_loss(ev, ev, bank, labels)
        _, m = tb.bridge_loss(_t(ev), _t(ev), _t(bank), _t(labels))
        assert float(m["zs_acc"]) == float(m_j["zs_acc"])
    assert float(m["zs_acc"]) == 0.0


def test_aligned_beats_shuffled():
    emb, bank = _emb(0, (8, 32)), _emb(1, (10, 32))
    labels = torch.arange(8) % 10
    l_same, _ = tb.bridge_loss(_t(emb), _t(emb), _t(bank), labels)
    l_diff, _ = tb.bridge_loss(_t(emb), _t(emb[::-1]), _t(bank), labels)
    assert float(l_same) < float(l_diff)


def test_frozen_proxy_is_frozen_and_matches_reference():
    w1, w2 = _emb(5, (6, 256)) / np.sqrt(6), _emb(6, (256, 24)) / 16.0
    proxy = convert.frozen_proxy_from_numpy(w1, w2)
    assert list(proxy.parameters()) == []
    assert sorted(dict(proxy.named_buffers())) == ["w1", "w2"]
    x = _t(_emb(7, (5, 6))).requires_grad_()
    out = proxy(x)
    assert not out.requires_grad
    want = jb.FrozenProxy(jnp.asarray(w1), jnp.asarray(w2))(jnp.asarray(
        x.detach().numpy()))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-6)
    made = tb.make_frozen_proxy(8, 16, hidden=32,
                                generator=torch.Generator().manual_seed(0))
    assert made.w1.shape == (8, 32) and made.w2.shape == (32, 16)


def _params():
    return {"w": _emb(10, (6, 5)), "v": _emb(11, (3, 2, 2)),
            "b": _emb(12, (5,))}


@pytest.mark.parametrize("clip_norm", [1.0, 1e6])
@pytest.mark.parametrize("warmup,total", [(5, 20), (0, 12)])
def test_adamw_twenty_steps_match_reference(clip_norm, warmup, total):
    """20 steps of fixed gradients: through the warm-up and the cosine (and
    past ``total_steps``, where it holds at the floor), clipped and not."""
    cfg_kw = dict(lr=1e-2, warmup_steps=warmup, total_steps=total,
                  weight_decay=0.05, clip_norm=clip_norm)
    grads = [{k: 3.0 * _emb(100 + 7 * s + i, v.shape)
              for i, (k, v) in enumerate(_params().items())}
             for s in range(20)]
    pj = {k: jnp.asarray(v) for k, v in _params().items()}
    pt = {k: _t(v) for k, v in _params().items()}
    cj, ct = jadam.OptimConfig(**cfg_kw), tadam.OptimConfig(**cfg_kw)
    sj, st = jadam.init_opt_state(pj), tadam.init_opt_state(pt)
    step_j = jax.jit(jadam.apply_updates, static_argnums=3)
    clipped = 0
    for g in grads:
        pj, sj, mj = step_j(pj, {k: jnp.asarray(v) for k, v in g.items()},
                            sj, cj)
        pt, st, mt = tadam.apply_updates(pt, {k: _t(v) for k, v in
                                              g.items()}, st, ct)
        for k in pj:
            np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                       rtol=RTOL, atol=PARAM_ATOL)
            for mom in ("mu", "nu"):
                np.testing.assert_allclose(st[mom][k].numpy(),
                                           np.asarray(sj[mom][k]),
                                           rtol=RTOL, atol=PARAM_ATOL)
        for name in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(mt[name]), float(mj[name]),
                                       rtol=RTOL)
        clipped += float(mt["grad_norm"]) > clip_norm
        assert int(st["step"]) == int(sj["step"])
    assert clipped == (20 if clip_norm == 1.0 else 0)


def test_schedule_matches_reference():
    cfg_kw = dict(lr=3e-3, warmup_steps=7, total_steps=50, min_lr_frac=0.2)
    steps = np.arange(0, 60, dtype=np.int32)
    want = jax.jit(jax.vmap(lambda s: jadam.schedule(
        s, jadam.OptimConfig(**cfg_kw))))(steps)
    got = torch.stack([tadam.schedule(torch.tensor(int(s)),
                                      tadam.OptimConfig(**cfg_kw))
                       for s in steps])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def test_one_trainer_step_matches_reference():
    """The trainer's step: encode, bridge loss, gradients through the
    surrogate, AdamW (a decayed matrix, the undecayed bias)."""
    kw = dict(c1=4, c2=8, feat_dim=32)
    cfg_j, cfg_t = je.EncoderConfig(**kw), te.EncoderConfig(**kw)
    rng = np.random.default_rng(0)
    leaves = [(rng.standard_normal(s) * sc).astype(np.float32) for s, sc in
              (((3, 3, 2, 4), 0.33), ((3, 3, 4, 8), 0.23), ((8, 32), 0.5),
               ((32,), 0.1))]
    pj = je.EncoderParams(*(jnp.asarray(a) for a in leaves))
    enc = convert.encoder_from_numpy(*leaves)
    vols = rng.poisson(0.5, (8, 2, 16, 16, 2)).astype(np.float32)
    img, bank = _emb(20, (8, 32)), _emb(21, (4, 32))
    labels = rng.integers(0, 4, 8).astype(np.int32)
    ocfg_kw = dict(lr=2e-3, warmup_steps=10, total_steps=150,
                   weight_decay=0.01)

    @jax.jit
    def step_j(p, opt):
        def loss_fn(p):
            ev = je.encode_batch(p, jnp.asarray(vols), cfg_j)
            return jb.bridge_loss(jnp.asarray(img), ev, jnp.asarray(bank),
                                  jnp.asarray(labels))
        (loss, m), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        p, opt, _ = jadam.apply_updates(p, g, opt,
                                        jadam.OptimConfig(**ocfg_kw))
        return p, loss

    pj2, loss_j = step_j(pj, jadam.init_opt_state(pj))
    loss, _ = tb.bridge_loss(_t(img), te.encode_batch(enc, _t(vols), cfg_t),
                             _t(bank), _t(labels))
    params = dict(enc.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(loss, list(
        params.values()))))
    new, _, _ = tadam.apply_updates(params, grads,
                                    tadam.init_opt_state(params),
                                    tadam.OptimConfig(**ocfg_kw))
    np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                               rtol=RTOL)
    got = convert.encoder_to_numpy(new)
    for name in ("conv1", "conv2", "head", "head_b"):
        np.testing.assert_allclose(got[name], np.asarray(getattr(pj2, name)),
                                   rtol=RTOL, atol=PARAM_ATOL)


def test_short_training_lowers_the_loss():
    """``repro``'s own short run (plain SGD, 30 steps) on the port alone."""
    cfg = te.EncoderConfig(c1=4, c2=8, feat_dim=32)
    gen = torch.Generator().manual_seed(0)
    enc = te.init_encoder(cfg, gen)
    f_img = tb.make_frozen_proxy(4, 32, generator=gen)
    bank = torch.randn((4, 32), generator=gen)
    centers = [(4, 4), (4, 12), (12, 4), (12, 12)]

    def batch(step):
        r = np.random.default_rng(step)
        labels = r.integers(0, 4, 8)
        vols = np.zeros((8, 2, 16, 16, 2), np.float32)
        for i, c in enumerate(labels):
            cy, cx = centers[c]
            ys = np.clip(r.normal(cy, 1.2, 40).astype(int), 0, 15)
            xs = np.clip(r.normal(cx, 1.2, 40).astype(int), 0, 15)
            np.add.at(vols[i], (r.integers(0, 2, 40), ys, xs,
                                r.integers(0, 2, 40)), 1.0)
        labels = torch.from_numpy(labels)
        img = f_img(torch.nn.functional.one_hot(labels, 4).float())
        return torch.from_numpy(vols), img, labels

    losses = []
    for s in range(30):
        vols, img, labels = batch(s)
        loss, _ = tb.bridge_loss(img, te.encode_batch(enc, vols, cfg), bank,
                                 labels)
        enc.zero_grad()
        loss.backward()
        with torch.no_grad():
            for p in enc.parameters():
                p -= 5e-3 * p.grad
        losses.append(float(loss.detach()))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
