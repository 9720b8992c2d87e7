"""Port parity: the steps over a mesh (``runtime/sharding.py``,
``runtime/spmd.py``, ``models/moe.py::moe_ffn_ep``, the checkpoint's
restore onto a mesh, ``optim/grad_compress.py`` over a mesh axis), on a
2x4 ("data", "model") mesh of 8 gloo ranks on the CPU, every check in one
spawn (``tests/_mesh_workers.py``).

Rules (readings of the last run on this CPU, torch 2.13, in brackets):
- every train step is AdamW's first with lr 1e-2 and one warm-up step
  (``_mesh_workers.OCFG``), so it moves a weight by about 1e-2, well
  above a float32 or bfloat16 ulp of it. The update is held through the
  moments: the mesh step's mu within a fraction of each leaf's largest of
  the plain step's, nu (a square) within twice that, and on each side
  every weight equal to the AdamW step of that side's own moments within
  one ulp of the weight's type plus 1e-5 of the step [0.5 of that at
  worst]. A step that drops the update, applies it to another shard or
  flips its sign fails (each shown on recorded outputs), and more than
  half of the weights must move by more than twice their tolerance [all
  of them in float32, 0.915 in bfloat16]. The weights' difference from
  the plain step's is not compared directly: a gradient within rounding
  of zero may take the other sign, and AdamW's first step moves it by lr
  either way [up to 0.12 of a leaf's largest update];
- the reference test's cell (qwen3-14b smoke, bfloat16, seq 64, batch 4,
  ``TokenStream`` batch 0, the reference's weights): the 2x4 step's loss
  within rtol 1e-3 of the plain step's and of the reference's (bfloat16
  partial sums added in another order); mu within 0.1 of each leaf's
  largest [the larger of mu's and nu's errors 0.097, at a norm scale's
  moments]: bfloat16 gradients summed over the ranks in another order;
- one arch per family in float32, the score products too (dense, audio,
  VLM, MoE, hybrid, ssm):
  the 2x4 train step's loss and metrics within rtol 1e-5 of the plain
  step's; mu within 1e-4 of each leaf's largest [the larger of mu's and
  nu's errors 4.2e-6, xlstm-1.3b 5.0e-5]; prefill (capacity S + 8) and one
  decode step, and for the dense and MoE families one
  ``serve_quant="int8"`` decode step from a zero int8 cache: logits and
  every cache leaf within 1e-4 of the leaf's largest magnitude;
- ``moe_ffn_ep`` at ``tests/test_beyond_paper.py:80-84``'s config within
  1e-4 of the reference's ``moe_ffn`` (that test's rule), its load-balance
  term rtol 1e-5, its gradients within 1e-4 of each leaf's largest of the
  plain ``moe_ffn``'s;
- the int8 decode's cores run on each rank's local tensors: every
  operand the mesh step hands ``int8_dot.rows`` / ``cols`` (qwen3-14b's
  and deepseek-v2-236b's) is a plain tensor, and a DTensor handed to
  ``int8_dot.rows`` raises ``TypeError``;
- the int8 compressed all-gather-sum over the data axis within half a
  quantization step per rank of the exact sum; the reference's multipod
  loop (``tests/test_distributed.py:79-113``: least squares, the
  compressed sum over 'pod', AdamW at lr 5e-2, 60 steps) on a (2, 2, 2)
  ("pod", "data", "model") mesh of the same 8 ranks ends below the
  reference's loss of 0.5;
- parameters saved on a 4x2 mesh and restored onto a 2x2 mesh equal the
  saved ones bit for bit, placed as the 2x2 mesh's rules say;
- on a 1x1 mesh xlstm-1.3b's train step, prefill and decode equal the
  plain steps bit for bit (``chip_smoke.py`` phase 18 holds the dense
  train step so on the card).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke as jget_smoke
from repro.models import moe as jmoe
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.configs import get_smoke
from repro_torch.data.tokens import TokenStream

import _mesh_workers as mw
import _torch_lm as lm
import _torch_train as tr

FAMILIES = ("qwen3-14b", "musicgen-large", "llama-3.2-vision-90b",
            "deepseek-v2-236b", "recurrentgemma-2b", "xlstm-1.3b")
EP_CFG = dict(name="t", family="moe", d_model=32, n_experts=8, moe_top_k=2,
              moe_d_ff=16, n_shared_experts=1, capacity_factor=8.0)


def _batch(cfg, B=4, S=64) -> dict:
    batch = TokenStream(cfg, B, S).batch_at(0)
    return {k: np.ascontiguousarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jcfg = jget_smoke("qwen3-14b")
    qwen_tree = lm.draw_tree(jcfg, 0)
    qwen_batch = _batch(get_smoke("qwen3-14b"))
    trees, batches = {}, {}
    for arch in FAMILIES:
        jc = dataclasses.replace(jget_smoke(arch), dtype="float32")
        trees[arch] = lm.draw_tree(jc, 1)
        batches[arch] = _batch(dataclasses.replace(get_smoke(arch),
                                                   dtype="float32"))
    jc = JModelConfig(**EP_CFG)
    p = jmoe.init_moe_params(jax.random.PRNGKey(3), jc, jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(4), (4, 8, 32))
    inputs = dict(qwen_tree=qwen_tree, qwen_batch=qwen_batch,
                  xlstm_tree=lm.draw_tree(jget_smoke("xlstm-1.3b"), 2),
                  xlstm_batch=_batch(get_smoke("xlstm-1.3b")),
                  families=FAMILIES, trees=trees, batches=batches,
                  ep_cfg=dict(EP_CFG, moe_groups=1),
                  ep_params={k: np.asarray(v) for k, v in p.items()},
                  ep_x=np.asarray(x),
                  ckpt_dir=str(tmp_path_factory.mktemp("ckpt")))

    def reference():        # while the ranks run
        (ref_loss, _), _ = tr.ref_grad_fn(jcfg)(lm.to_jax(qwen_tree, jcfg),
                                                tr.jax_batch(qwen_batch))
        y_ref, aux_ref = jmoe.moe_ffn(p, x, jc)
        return {"ref_loss": float(ref_loss),
                "ep_ref": (np.asarray(y_ref), float(aux_ref))}

    res = mw.spawn(mw.mesh_run_worker, 8, inputs, meanwhile=reference)
    print("rank 0 seconds:", res["seconds"])
    return res


def _close_of_max(got, want, frac, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= frac * scale, (what, err, scale)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _ulp(x: np.ndarray, dtype: str) -> np.ndarray:
    """The spacing of ``dtype`` (float32 or bfloat16) at ``|x|``."""
    f32 = np.spacing(np.abs(x).astype(np.float32)).astype(np.float64)
    return f32 * 2.0 ** 16 if dtype == "bfloat16" else f32


def _adamw_first(p0, mu, nu, lr, decayed):
    """The weights after AdamW's first step from the moments it wrote
    (bias corrections 1 - b1 and 1 - b2), in float64."""
    from repro_torch.optim.adamw import OptimConfig

    oc = OptimConfig(**mw.OCFG)
    mu, nu = np.asarray(mu, np.float64), np.asarray(nu, np.float64)
    u = (mu / (1 - oc.b1)) / (np.sqrt(nu / (1 - oc.b2)) + oc.eps)
    p0 = np.asarray(p0, np.float64)
    if decayed:
        u = u + oc.weight_decay * p0
    return p0 - float(lr) * u


def _check_train(pair, mu_frac):
    """The mesh step's AdamW moments against the plain step's: mu within
    ``mu_frac`` of each leaf's largest, nu (a square) within twice that;
    and each side's weights the AdamW step of its own moments within one
    ulp of the weight's type plus 1e-5 of the step, so a mesh step that
    drops the update, applies it to another shard or flips its sign
    fails. Returns (the largest relative moment error, the share of
    elements that moved by more than twice their tolerance)."""
    plain, on_mesh, (p_init, decayed, dtypes) = pair
    worst, moved, total = 0.0, 0, 0
    for k in p_init:
        for i, frac in ((1, mu_frac), (2, 2 * mu_frac)):
            want = np.asarray(plain[i][k], np.float64)
            err = float(np.abs(on_mesh[i][k] - want).max())
            scale = max(float(np.abs(want).max()), 1e-30)
            assert err <= frac * scale, (k, i, err, scale)
            worst = max(worst, err / scale)
        for p, mu, nu, m in (plain, on_mesh):
            want = _adamw_first(p_init[k], mu[k], nu[k], m["lr"],
                                k in decayed)
            step = np.abs(want - p_init[k])
            tol = _ulp(np.maximum(np.abs(want), np.abs(p[k])), dtypes[k]) \
                + 1e-5 * step
            assert np.all(np.abs(p[k] - want) <= tol), (
                k, float(np.abs(p[k] - want).max()))
        moved += int(np.sum(step > 2 * tol))
        total += step.size
    return worst, moved / total


def test_reference_cell_trains_on_2x4(run):
    plain, on_mesh, _ = run["qwen"]
    loss0, loss1 = plain[3]["loss"], on_mesh[3]["loss"]
    assert np.isfinite(loss1)
    np.testing.assert_allclose(loss1, loss0, rtol=1e-3)
    np.testing.assert_allclose(loss1, run["ref_loss"], rtol=1e-3)
    worst, moved = _check_train(run["qwen"], 1e-1)
    print("qwen3-14b bfloat16: moments", worst, "moved", moved)
    assert moved > 0.5, moved


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_train_step_on_2x4(run, arch):
    plain, on_mesh, _ = run[arch]["train"]
    for k in plain[3]:
        np.testing.assert_allclose(on_mesh[3][k], plain[3][k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    worst, moved = _check_train(run[arch]["train"], 1e-4)
    print(arch, "moments", worst, "moved", moved)
    assert moved > 0.5, moved


SERVING = [(a, s) for a in FAMILIES for s in ("prefill", "decode")] + [
    (a, "int8 decode") for a in ("qwen3-14b", "deepseek-v2-236b")]


@pytest.mark.parametrize("arch,step", SERVING)
def test_family_serving_step_on_2x4(run, arch, step):
    l0, c0 = run[arch][f"{step}_plain"]
    l1, c1 = run[arch][f"{step}_mesh"]
    _close_of_max(l1, l0, 1e-4, "logits")
    got = dict(_leaves(c1))
    for k, want in _leaves(c0):
        _close_of_max(got[k], want, 1e-4, k)


@pytest.mark.parametrize("arch", ("qwen3-14b", "deepseek-v2-236b"))
def test_int8_cores_take_local_tensors_on_2x4(run, arch):
    seen = run[arch]["int8 operands"]
    # two contractions a layer, on every rank's own rows and heads
    assert len(seen) >= 2, seen
    assert set(seen) == {("Tensor", "Tensor")}, set(seen)


def test_a_dtensor_reaching_int8_dot_raises(run):
    assert "DTensor" in run["int8_refused"], run["int8_refused"]


def test_multipod_compressed_loop_on_2x2x2(run):
    assert run["multipod"] < 0.5, run["multipod"]


def test_moe_ffn_ep_matches_reference(run):
    ep = run["ep"]
    y_ref, aux_ref = run["ep_ref"]
    np.testing.assert_allclose(ep["y_ep"], y_ref, atol=1e-4)
    np.testing.assert_allclose(ep["aux_ep"], aux_ref, rtol=1e-5)
    np.testing.assert_allclose(ep["y_plain"], y_ref, atol=1e-4)
    for k, g in ep["grads_plain"].items():
        _close_of_max(ep["grads_ep"][k], g, 1e-4, k)


def test_compressed_psum_over_data_axis(run):
    c = run["compressed"]
    assert c["err"] <= c["bound"], c
    assert c["residual"] < 1e-6, c


def test_elastic_restore_across_meshes(run):
    e = run["elastic"]
    assert e == {"step": 7, "equal": True, "placements": True}


def test_one_by_one_mesh_is_bit_equal(run):
    assert run["one_by_one"] == {"train": True, "prefill": True,
                                 "decode": True}
