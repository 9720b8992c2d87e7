"""Port parity: ``repro_torch.optim.grad_compress`` against
``repro.optim.grad_compress``: the int8 codes of ``ef_compress`` bit-equal,
the scales and residuals equal as float32; the k-shard compressed sum
(through an injected gather, k shards in one process) against the
reference's ``ef_compress`` + ``tensordot`` on the same shards (rtol 1e-6);
and the data-parallel step over a one-process gloo group from a
``FileStore`` against the reference's ``make_dp_compressed_train_step`` on
a one-device mesh (parameters and metrics rtol 1e-6 after 3 AdamW steps,
the error-feedback residuals within 1e-6 absolute)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jgc
from repro_torch.optim import adamw
from repro_torch.optim import grad_compress as gc

SHAPES = ((7,), (33, 65), (4, 8, 16))


def _draws(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(shape) * rng.choice([1e-3, 1.0, 50.0])
         ).astype(dtype)
    e = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
    return g, e


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", range(3))
def test_ef_compress_bit_equal(shape, seed):
    g, e = _draws(shape, seed)
    q, s, ne = gc.ef_compress(torch.from_numpy(g), torch.from_numpy(e))
    jq, js, jne = jgc.ef_compress(jnp.asarray(g), jnp.asarray(e))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    np.testing.assert_array_equal(ne.numpy(), np.asarray(jne))
    np.testing.assert_array_equal(gc.dequantize_int8(q, s).numpy(),
                                  np.asarray(jgc.dequantize_int8(jq, js)))


def test_ef_compress_bf16_and_zero():
    g, e = _draws((64, 9), 11)
    tg = torch.from_numpy(g).to(torch.bfloat16)
    jg = jnp.asarray(g).astype(jnp.bfloat16)
    q, s, ne = gc.ef_compress(tg, torch.from_numpy(e))
    jq, js, jne = jgc.ef_compress(jg, jnp.asarray(e))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ne.numpy(), np.asarray(jne))
    z = np.zeros((5,), np.float32)
    q, s = gc.quantize_int8(torch.from_numpy(z))
    assert not q.any() and float(s) == np.float32(1e-12)


@pytest.mark.parametrize("k", (2, 3))
def test_k_shard_sum(k):
    shards = [_draws((40, 24), 100 + i) for i in range(k)]
    parts = [gc.ef_compress(torch.from_numpy(g), torch.from_numpy(e))
             for g, e in shards]
    stacks = {torch.int8: torch.stack([p[0] for p in parts]),
              torch.float32: torch.stack([p[1].reshape(1) for p in parts])}
    got = []
    for i, (g, e) in enumerate(shards):
        summed, new_err = gc.compressed_psum(
            torch.from_numpy(g), torch.from_numpy(e),
            gather=lambda t: stacks[t.dtype])
        np.testing.assert_array_equal(new_err.numpy(), parts[i][2].numpy())
        got.append(summed.numpy())
    ref = [jgc.ef_compress(jnp.asarray(g), jnp.asarray(e)) for g, e in shards]
    qs = jnp.stack([r[0] for r in ref])
    ss = jnp.stack([r[1] for r in ref])
    want = np.asarray(jnp.tensordot(ss, qs.astype(jnp.float32),
                                    axes=([0], [0])))
    for g in got:       # every rank holds the same sum
        np.testing.assert_allclose(g, want, rtol=1e-6, atol=0)
    trees = gc.tree_compressed_psum(
        {"a": torch.from_numpy(shards[0][0])},
        gc.init_error_state({"a": torch.from_numpy(shards[0][1])}),
        gather=lambda t: stacks[t.dtype])
    assert set(trees[0]) == set(trees[1]) == {"a"}


def _quadratic():
    rng = np.random.default_rng(5)
    params = {"w": (rng.standard_normal((4, 3)) * 0.3).astype(np.float32),
              "b": (rng.standard_normal((3,)) * 0.3).astype(np.float32)}
    batches = [{"x": rng.standard_normal((8, 4)).astype(np.float32),
                "y": rng.standard_normal((8, 3)).astype(np.float32)}
               for _ in range(3)]
    return params, batches


def test_dp_step_over_a_gloo_group(tmp_path):
    params, batches = _quadratic()
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=10)

    def jloss(p, b):
        r = b["x"] @ p["w"] + p["b"] - b["y"]
        loss = jnp.mean(r * r)
        return loss, {"mse": loss}

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    jstep = jax.jit(jgc.make_dp_compressed_train_step(
        jloss, lambda p, g, o: jadamw.apply_updates(
            p, g, o, jadamw.OptimConfig(**ocfg)), mesh))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jerr, jopt = jgc.init_error_state(jp), jadamw.init_opt_state(jp)

    def loss(p, b):
        r = b["x"] @ p["w"] + p["b"] - b["y"]
        mse = torch.mean(r * r)
        return mse, {"mse": mse}

    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        step = gc.make_dp_compressed_train_step(
            loss, lambda p, g, o: adamw.apply_updates(
                p, g, o, adamw.OptimConfig(**ocfg)))
        tp = {k: torch.from_numpy(v) for k, v in params.items()}
        terr, topt = gc.init_error_state(tp), adamw.init_opt_state(tp)
        for b in batches:
            jp, jerr, jopt, jm = jstep(jp, jerr, jopt,
                                       {k: jnp.asarray(v) for k, v in
                                        b.items()})
            tp, terr, topt, tm = step(tp, terr, topt,
                                      {k: torch.from_numpy(v) for k, v in
                                       b.items()})
            for k in jm:
                np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                           rtol=1e-6, err_msg=k)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
            # a residual is a difference of nearly equal float32 values
            # of order 1: held to their ulp, absolutely
            np.testing.assert_allclose(terr[k].numpy(), np.asarray(jerr[k]),
                                       rtol=0, atol=1e-6)
    finally:
        dist.destroy_process_group()
