"""Port parity: GPipe pipeline parallelism over the 'pod' axis
(``repro_torch.runtime.pipeline_parallel`` against the reference test's
own comparison, ``tests/test_pipeline_parallel.py``): L = 4 tanh layers
of width 16 split into 2 stages on a ("pod", "data", "model") mesh of
2 x 1 x 1 (2 gloo ranks on the CPU), 4 microbatches of 2. The pipelined
forward is within 1e-5 of the reference's sequential model, and the
gradient of sum(out^2) through the pipeline within 1e-4 (atol and rtol)
of ``jax.grad`` of the sequential model, from the same numpy weights.
The reference's own pipeline (``shard_map`` over 8 devices) cannot run
here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch.runtime.pipeline_parallel import split_stages

import _mesh_workers as mw

L, D, N_MICRO, MB = 4, 16, 4, 2


def _sequential(W, xs):
    def full(x):
        h = x
        for i in range(L):
            h = jnp.tanh(h @ W[i])
        return h
    return jax.vmap(full)(xs)


@pytest.fixture(scope="module")
def run():
    rng = np.random.default_rng(0)
    W = (rng.standard_normal((L, D, D)) * 0.3).astype(np.float32)
    xs = rng.standard_normal((N_MICRO, MB, D)).astype(np.float32)
    res = mw.spawn(mw.pipeline_worker, 2, dict(W=W, xs=xs))
    res["seq"] = np.asarray(_sequential(jnp.asarray(W), jnp.asarray(xs)))
    res["seq_grad"] = np.asarray(jax.grad(
        lambda W: jnp.sum(_sequential(W, jnp.asarray(xs)) ** 2))(
            jnp.asarray(W)))
    return res


def test_pipeline_forward_matches_sequential(run):
    np.testing.assert_allclose(run["out"], run["seq"], atol=1e-5)


def test_pipeline_grads_match_sequential(run):
    np.testing.assert_allclose(run["grad"], run["seq_grad"], atol=1e-4,
                               rtol=1e-4)


def test_split_stages():
    import torch
    W = torch.arange(4 * 3 * 2.0).reshape(4, 3, 2)
    st = split_stages({"w": W}, 2)["w"]
    assert st.shape == (2, 2, 3, 2) and torch.equal(st[1, 0], W[2])
    with pytest.raises(ValueError):
        split_stages(W, 3)
