"""Port parity: LM training (``repro_torch.models.transformer.forward_train``
and ``repro_torch.runtime.steps.make_train_step`` against the reference's
``forward_train`` under ``jax.value_and_grad`` and its AdamW) for the dense,
audio, VLM and MoE-with-MTP families at smoke widths, every leaf drawn with
numpy, both packages fed the same ``TokenStream`` batches (B 2, S 64).

Rules (float32 models):
- with the score products in float32 in both packages
  (``_torch_train.f32_scores``): loss and metrics rtol 1e-5; every gradient
  leaf within 1e-4 of its largest magnitude; after 3 train steps from the
  same nonzero AdamW state (``convert.lm_opt_state_from_numpy``), the
  parameters, both moments and the optimizer's metrics by the same rules.
  Measured: gradients 1.1e-6 (gemma-7b), 3.1e-6 (deepseek-v3) of each
  leaf's maximum; parameters after 3 steps 5.2e-6 and 1.3e-5, moments
  1.2e-6 and 3.6e-6.
- as the models compute (q and k rounded to bfloat16 before the score
  product, whose backward rounds the score gradients to bfloat16): loss
  rtol 1e-5, gradients within 2e-3 of each leaf's maximum (about half a
  bfloat16 ulp; measured 4.3e-4 at gemma-7b's wq).
Rules (bfloat16 models, against the compiled reference, which keeps parts
of a bfloat16 model in float32):
- dense: loss and metrics rtol 1e-3, every gradient leaf within 5e-2 of
  its norm (measured: loss 2.8e-5, gradients 1.5e-2 at wq);
- MoE with MTP: loss and metrics rtol 5e-3, every gradient leaf within
  0.25 of its norm (measured: loss 1.9e-4, aux 2.0e-3, gradients up to
  9.7e-2 at the experts' w_down: in bfloat16 a near-tied routing choice
  can flip and shift the capacity drops);
- the VLM fed float32 ``vision`` (the port casts it to the model's dtype)
  against the reference fed bfloat16 ``vision`` (fed float32 it fails:
  ROADMAP Queue 3): loss rtol 1e-3, gradients within 5e-2 of each leaf's
  norm, the one-element cross gate within 0.25 (a sum over every token of
  cancelling terms; measured 0.14, the other leaves 2.4e-2).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.data.tokens import TokenStream
from repro_torch.models import transformer as tf
from repro_torch.runtime import steps

import _torch_lm as lm
import _torch_train as tr

ARCHS = ("gemma-7b", "musicgen-large", "llama-3.2-vision-90b",
         "deepseek-v3-671b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with tr.torch_threads(1):
        yield


@pytest.mark.parametrize("name", ARCHS)
def test_forward_train_and_steps_match_reference(name):
    tr.run_parity(name)


def test_bf16_score_products_float32_model():
    """The float32 model as it computes: bfloat16 score products."""
    jcfg, jp, cfg, pp = lm.models("gemma-7b", dtype="float32")
    batch = TokenStream(cfg, tr.B, tr.S).batch_at(0)
    (loss, metrics), grads = tr.ref_grad_fn(jcfg)(jp, tr.jax_batch(batch))
    ploss, pm, pg = steps.loss_and_grads(cfg, dict(pp.state_dict()),
                                         tr.torch_batch(batch))
    tr.assert_metrics_close(pm, metrics, 1e-5)
    tr.assert_tree_close(pg, grads, "grads", of_max=2e-3)


@pytest.mark.parametrize("name,rtol,of_norm", [
    ("gemma-7b", 1e-3, 5e-2), ("deepseek-v3-671b", 5e-3, 0.25)])
def test_bf16_model(name, rtol, of_norm):
    jcfg, jp, cfg, pp = lm.models(name, dtype="bfloat16")
    batch = TokenStream(cfg, tr.B, tr.S).batch_at(0)
    (loss, metrics), grads = tr.ref_grad_fn(jcfg)(jp, tr.jax_batch(batch))
    params = dict(pp.state_dict())
    ploss, pm, pg = steps.loss_and_grads(cfg, params, tr.torch_batch(batch))
    assert all(pg[k].dtype == p.dtype for k, p in params.items())
    tr.assert_metrics_close(pm, metrics, rtol)
    tr.assert_tree_close(pg, grads, f"{name} bf16 grads", of_norm=of_norm)


def test_vlm_bf16_vision_cast():
    jcfg, jp, cfg, pp = lm.models("llama-3.2-vision-90b", dtype="bfloat16")
    batch = TokenStream(cfg, tr.B, tr.S).batch_at(0)
    assert batch["vision"].dtype == np.float32
    fn = tr.ref_grad_fn(jcfg)
    with pytest.raises(TypeError):          # ROADMAP Queue 3
        fn(jp, tr.jax_batch(batch))
    (loss, metrics), grads = fn(jp, tr.jax_batch(batch, jnp.bfloat16))
    ploss, pm, pg = steps.loss_and_grads(cfg, dict(pp.state_dict()),
                                         tr.torch_batch(batch))
    tr.assert_metrics_close(pm, metrics, 1e-3)
    tr.assert_tree_close(pg, grads, "vlm bf16 grads", of_norm=5e-2,
                         overrides={"gate": 0.25})


@pytest.mark.parametrize("name", ("gemma-7b", "deepseek-v3-671b"))
def test_remat_policies_equal(name):
    """"nothing", "dots" and "full", and "nothing" with each attention
    chunk recomputed (``attn_remat``), recompute the same operations on
    the same inputs: losses and gradients bit-equal."""
    jcfg, cfg = lm.configs(name, dtype="float32", attn_chunk=16)
    params = dict(convert.lm_params_from_numpy(
        cfg, lm.draw_tree(jcfg, 0)).state_dict())
    batch = tr.torch_batch(TokenStream(cfg, tr.B, tr.S).batch_at(0))
    outs = {}
    for policy, attn_remat in (("full", False), ("nothing", False),
                               ("dots", False), ("nothing", True)):
        c = dataclasses.replace(cfg, remat_policy=policy,
                                attn_remat=attn_remat)
        outs[policy, attn_remat] = steps.loss_and_grads(c, params, batch)
    want_loss, want_m, want_g = outs.pop(("full", False))
    for policy, (loss, m, g) in outs.items():
        assert torch.equal(loss, want_loss), policy
        assert all(torch.equal(m[k], want_m[k]) for k in want_m), policy
        assert all(torch.equal(g[k], want_g[k]) for k in want_g), policy


def _chunk_inputs(S, seed=3):
    jcfg, cfg = lm.configs("deepseek-7b", dtype="float32")
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, S, cfg.d_model)).astype(np.float32)
    unembed = (rng.standard_normal((cfg.d_model, cfg.vocab))
               / 8).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (1, S)).astype(np.int32)
    return jcfg, cfg, x, unembed, labels


def test_logits_chunked_two_chunks():
    """S = 1024: two chunks of 512, against the reference's scan; the
    gradients of x and the unembedding too."""
    import jax

    jcfg, cfg, x, unembed, labels = _chunk_inputs(1024)
    (loss, (gx, gu)) = jax.jit(jax.value_and_grad(
        lambda x, u: jtf._logits_chunked({"unembed": u}, x, jcfg,
                                         jnp.asarray(labels)),
        argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(unembed))
    tx = torch.from_numpy(x).requires_grad_(True)
    tu = torch.from_numpy(unembed).requires_grad_(True)
    holder = type("P", (), {"unembed": tu,
                            "__contains__": lambda self, k: k == "unembed"})()
    ploss = tf._logits_chunked(holder, tx, cfg, torch.from_numpy(labels))
    ploss.backward()
    np.testing.assert_allclose(float(ploss.detach()), float(loss),
                               rtol=1e-5)
    for got, want in ((tx.grad, gx), (tu.grad, gu)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


def test_logits_chunked_rejects_a_ragged_length():
    """S = 768 is not a multiple of C = 512: the reference's reshape
    fails, and so does the port."""
    jcfg, cfg, x, unembed, labels = _chunk_inputs(768)
    with pytest.raises(TypeError):
        jtf._logits_chunked({"unembed": jnp.asarray(unembed)},
                            jnp.asarray(x), jcfg, jnp.asarray(labels))
    holder = type("P", (), {"unembed": torch.from_numpy(unembed),
                            "__contains__": lambda self, k: True})()
    with pytest.raises(ValueError, match="multiple of the loss chunk"):
        tf._logits_chunked(holder, torch.from_numpy(x), cfg,
                           torch.from_numpy(labels))
