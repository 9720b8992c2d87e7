"""Shared fixtures of the LM parity tests (``tests/test_torch_lm*.py``).

The reference's parameter trees are built from ``jax.eval_shape`` of its
``init_params`` (no weights drawn by JAX: that costs seconds per
architecture) and every leaf is drawn with numpy, norm scales and the VLM
gate included: the reference's init sets those to zero, which would hide
the cross layer (tanh(0) = 0) and the norms' scales.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_smoke as jget_smoke
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import get_smoke

STACKED = ("groups", "dense_prefix")


def configs(name: str, **over):
    """The reference's and the port's smoke config, with ``over``."""
    return (dataclasses.replace(jget_smoke(name), **over),
            dataclasses.replace(get_smoke(name), **over))


def draw_tree(jcfg, seed: int) -> dict:
    """numpy float32 leaves shaped as the reference's parameter tree: a
    matrix (per layer) ~ N(0, 1/fan_in) with fan_in its second-to-last
    dimension, a vector (norm offsets, the gate) ~ N(0, 0.3^2)."""
    shapes = jax.eval_shape(lambda: jtf.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        shape = s.shape[1:] if path[0].key in STACKED else s.shape
        if len(shape) >= 2:
            scale = 1.0 / np.sqrt(shape[-2])
        else:
            scale = 0.3
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def to_jax(tree, jcfg):
    """The numpy tree as the reference's arrays, each leaf in its dtype."""
    shapes = jax.eval_shape(lambda: jtf.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    return jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype), tree, shapes)


def models(name: str, seed: int = 0, **over):
    """(jcfg, jax params, cfg, port params on the CPU) from one draw."""
    jcfg, cfg = configs(name, **over)
    tree = draw_tree(jcfg, seed)
    return jcfg, to_jax(tree, jcfg), cfg, convert.lm_params_from_numpy(
        cfg, tree)


def prompt(cfg, B: int, S: int, seed: int = 1) -> dict:
    """numpy tokens [B, S] (audio [B, S, ncb]) and, for the VLM, vision
    embeddings in the model's dtype's float32 values."""
    rng = np.random.default_rng(seed)
    shape = (B, S, cfg.n_codebooks) if cfg.family == "audio" else (B, S)
    batch = {"tokens": rng.integers(0, cfg.vocab, shape).astype(np.int32)}
    if cfg.family == "vlm":
        batch["vision"] = rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.vision_dim)).astype(np.float32)
    return batch


ref_prefill = jax.jit(jtf.prefill, static_argnames=("cfg", "s_max"))
ref_decode = jax.jit(jtf.decode_step, static_argnames=("cfg",
                                                       "return_hidden"))


@functools.cache
def _ref_cross_kv_fn():
    from repro.models import attention as jattn
    return jax.jit(jax.vmap(jattn.cross_attn_kv, in_axes=(0, None, None)),
                   static_argnums=2)


def ref_cross_kv(jparams, vision, jcfg):
    """The reference's ``cross_attn_kv`` of every group's cross layer,
    stacked [G, B, Nv, Hkv, dh] (what its prefill should store)."""
    _, pattern = jtf.group_layout(jcfg)
    name = f"cross_{len(pattern) - 1}"
    return _ref_cross_kv_fn()(jparams["groups"][name]["attn"], vision, jcfg)
