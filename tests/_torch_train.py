"""Shared pieces of the LM training parity tests (``tests/test_torch_train*.py``).

Both packages start from the same numpy draws (``_torch_lm.draw_tree``
for the weights, :func:`draw_opt_state` for AdamW's moments) and take the
same ``TokenStream`` batches. The reference is jitted once per config:
:func:`ref_train_fn` is its ``make_train_step`` body with the gradients
returned as well (``jax.value_and_grad`` of ``forward_train``, then
``adamw.apply_updates``), so one compile serves the gradient check and the
steps.

Both packages round q and k to bfloat16 before every score product, and
the product's backward rounds the score gradients to bfloat16 as well, so
two float32 models agree there only to bfloat16's 2^-8 where their float32
inputs round apart. :func:`f32_scores` runs both with those products in
float32 (the reference's ``jnp.bfloat16`` and the port's ``BF16`` patched
to float32 for the duration), which is where the tight rules hold.
"""
from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.data.tokens import TokenStream as JTokenStream
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.data.tokens import TokenStream
from repro_torch.models import attention, mla
from repro_torch.optim import adamw
from repro_torch.runtime import steps

import _torch_lm as lm

B, S = 2, 64


@contextlib.contextmanager
def f32_scores():
    """Both packages' score products in float32 instead of bfloat16."""
    saved = jnp.bfloat16, attention.BF16, mla.BF16
    jnp.bfloat16 = jnp.float32
    attention.BF16 = mla.BF16 = torch.float32
    try:
        yield
    finally:
        jnp.bfloat16, attention.BF16, mla.BF16 = saved


@contextlib.contextmanager
def torch_threads(n: int = 1):
    """torch's CPU ops on ``n`` threads for the duration. The tests run
    beside other test processes, where torch's default of a thread per
    core oversubscribes the cores and its small ops wait on each other;
    alone one thread costs these tests nothing (their time is the
    reference's compile)."""
    was = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(was)


def ref_train_fn(jcfg, ocfg):
    """jit of (params, opt, batch) -> (loss, metrics, grads, params',
    opt', optimizer metrics): the reference's train step, its gradients
    returned too."""
    def step(params, opt, batch):
        (loss, metrics), grads = jax.value_and_grad(
            lambda p: jtf.forward_train(p, batch, jcfg), has_aux=True)(params)
        p2, o2, om = jadamw.apply_updates(params, grads, opt, ocfg)
        return loss, metrics, grads, p2, o2, om

    return jax.jit(step)


def ref_grad_fn(jcfg):
    """jit of (params, batch) -> ((loss, metrics), grads)."""
    return jax.jit(jax.value_and_grad(
        lambda p, b: jtf.forward_train(p, b, jcfg), has_aux=True))


def jax_batch(batch: dict, vision_dtype=jnp.float32) -> dict:
    out = {k: jnp.asarray(v) for k, v in batch.items()}
    if "vision" in out:
        out["vision"] = out["vision"].astype(vision_dtype)
    return out


def torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def draw_opt_state(tree: dict, seed: int, step: int = 5) -> dict:
    """A nonzero AdamW state shaped as ``tree`` (the reference's layout):
    mu ~ N(0, 1e-3^2), nu ~ 1e-6 |N(0, 1)|, ``step`` steps taken."""
    rng = np.random.default_rng(seed)

    def mu(a):
        return (rng.standard_normal(a.shape) * 1e-3).astype(np.float32)

    def nu(a):
        return (np.abs(rng.standard_normal(a.shape)) * 1e-6
                ).astype(np.float32)

    return {"mu": jax.tree.map(mu, tree), "nu": jax.tree.map(nu, tree),
            "step": np.int32(step)}


def leaves(tree) -> dict:
    """{"a/b/c": float32 numpy} of a nested tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(e.key) for e in path):
            np.asarray(jnp.asarray(leaf, jnp.float32)) for path, leaf in flat}


def assert_tree_close(port_flat: dict, ref_tree, what: str, *,
                      of_max: float | None = None,
                      of_norm: float | None = None,
                      overrides: dict | None = None) -> float:
    """Every leaf of the port's flat dict (stacked into the reference's
    layout) against the reference's tree: |port - ref| <= of_max *
    max|ref| elementwise, or ||port - ref|| <= of_norm * ||ref|| (a leaf
    named in ``overrides`` by its last key takes that norm bound). Returns
    the worst ratio of the chosen measure."""
    got = leaves(convert.lm_grads_to_numpy(port_flat))
    want = leaves(ref_tree)
    assert set(got) == set(want), (what, set(got) ^ set(want))
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        if of_max is not None:
            scale = float(np.abs(w).max())
            err = float(np.abs(g - w).max())
            bound = of_max
        else:
            scale = float(np.linalg.norm(w))
            err = float(np.linalg.norm(g - w))
            bound = (overrides or {}).get(k.split("/")[-1], of_norm)
        ratio = err / scale if scale else err
        worst = max(worst, ratio)
        assert err <= bound * scale or (scale == 0 and err == 0), (
            f"{what} {k}: {err:.3g} against {bound:g} x {scale:.3g}")
    return worst


def assert_metrics_close(port: dict, ref: dict, rtol: float):
    for k, v in ref.items():
        np.testing.assert_allclose(float(port[k]), float(v), rtol=rtol,
                                   err_msg=k)


OPT = dict(lr=3e-4, warmup_steps=2, total_steps=10)
N_STEPS = 3


def _port_state(cfg, pp, opt_tree):
    params = dict(pp.state_dict())
    return params, convert.lm_opt_state_from_numpy(cfg, opt_tree)


def run_parity(name: str, seed: int = 0):
    """The float32 rules with float32 score products: forward_train's
    loss, metrics and gradients, then 3 train steps."""
    jcfg, jp, cfg, pp = lm.models(name, seed=seed, dtype="float32")
    stream = TokenStream(cfg, B, S)
    jstream = JTokenStream(jcfg, B, S)
    opt_tree = draw_opt_state(lm.draw_tree(jcfg, seed), seed + 1)
    jopt = {"mu": lm.to_jax(opt_tree["mu"], jcfg),
            "nu": lm.to_jax(opt_tree["nu"], jcfg),
            "step": jnp.asarray(opt_tree["step"])}
    params, popt = _port_state(cfg, pp, opt_tree)
    step = steps.make_train_step(cfg, adamw.OptimConfig(**OPT), "cpu")
    with f32_scores():
        ref = ref_train_fn(jcfg, jadamw.OptimConfig(**OPT))
        jb = jax_batch(jstream.batch_at(0))
        loss, metrics, grads, jp, jopt, om = ref(jp, jopt, jb)
        ploss, pm, pg = steps.loss_and_grads(
            cfg, params, torch_batch(stream.batch_at(0)))
        assert_metrics_close(pm, metrics, 1e-5)
        np.testing.assert_allclose(float(ploss), float(loss), rtol=1e-5)
        assert_tree_close(pg, grads, f"{name} grads", of_max=1e-4)

        params, popt, pmet = step(params, popt, stream.batch_at(0))
        for i in range(1, N_STEPS):
            jb = jax_batch(jstream.batch_at(i))
            loss, metrics, _, jp, jopt, om = ref(jp, jopt, jb)
            params, popt, pmet = step(params, popt, stream.batch_at(i))
    assert_metrics_close(pmet, {**metrics, **om}, 1e-5)
    assert int(popt["step"]) == int(jopt["step"]) == 5 + N_STEPS
    assert_tree_close(params, jp, f"{name} params", of_max=1e-4)
    assert_tree_close(popt["mu"], jopt["mu"], f"{name} mu", of_max=1e-4)
    assert_tree_close(popt["nu"], jopt["nu"], f"{name} nu", of_max=1e-4)
