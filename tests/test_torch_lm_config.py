"""Port parity: the model config and the architecture registry
(``repro_torch.models.config``, ``repro_torch.configs.registry`` vs
``repro``'s), and every ported full config built on ``meta``.

Exact: every field, ``q_dim``, ``kv_dim``, ``mla_cache_dim``,
``param_count``, ``active_param_count`` and ``group_layout`` of all 10
architectures, full and smoke; ``shape_for`` and ``input_specs`` (shapes and dtypes) at every
shape. On ``meta`` the port's ``init_params`` of each of the 8 ported full
configs gives the reference's tree (paths, shapes, dtypes, with the port's
layers stacked back along the group axis) that ``jax.eval_shape`` gives,
and allocates nothing.
"""
import dataclasses

import jax
import pytest

from repro import configs as jconfigs
from repro.models import transformer as jtf
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import transformer as ttf

ARCHS = sorted(jconfigs.ARCHS)
PORTED = [a for a in ARCHS if jconfigs.get(a).family in ttf.PORTED_FAMILIES]


def _fields(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d.update(q_dim=cfg.q_dim, kv_dim=cfg.kv_dim,
             mla_cache_dim=cfg.mla_cache_dim, param_count=cfg.param_count(),
             active_param_count=cfg.active_param_count())
    return d


def test_registry_lists_the_same_architectures_and_shapes():
    assert list(tconfigs.ARCHS) == list(jconfigs.ARCHS)
    assert tconfigs.SHAPES == jconfigs.SHAPES
    assert tconfigs.registry.SUBQUADRATIC == jconfigs.registry.SUBQUADRATIC
    assert len(PORTED) == 10


@pytest.mark.parametrize("name", ARCHS)
def test_configs_equal_the_reference(name):
    for getter in ("get", "get_smoke"):
        port = getattr(tconfigs, getter)(name)
        ref = getattr(jconfigs, getter)(name)
        assert _fields(port) == _fields(ref), (name, getter)
        assert ttf.group_layout(port) == jtf.group_layout(ref), (name, getter)
    for shape in jconfigs.SHAPES:
        assert tconfigs.shape_for(name, shape) == jconfigs.shape_for(name,
                                                                    shape)


@pytest.mark.parametrize("name", ARCHS)
def test_input_specs_equal_the_reference(name):
    cfg, jcfg = tconfigs.get(name), jconfigs.get(name)
    for shape in jconfigs.SHAPES:
        sd = jconfigs.shape_for(name, shape)
        if sd is None:
            continue
        got, want = tconfigs.input_specs(cfg, sd), jconfigs.input_specs(
            jcfg, sd)
        assert set(got) == set(want), (name, shape)
        for k, spec in got.items():
            assert isinstance(spec, tconfigs.TensorSpec)
            assert tuple(spec.shape) == tuple(want[k].shape), (name, shape, k)
            assert str(spec.dtype).removeprefix("torch.") == \
                str(want[k].dtype), (name, shape, k)


def _ref_specs(jcfg) -> dict:
    tree = jax.eval_shape(lambda: jtf.init_params(jax.random.PRNGKey(0),
                                                  jcfg))
    return {"/".join(p.key for p in path): (tuple(s.shape), str(s.dtype))
            for path, s in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("name", PORTED)
def test_full_config_builds_on_meta_with_the_reference_tree(name):
    params = ttf.init_params(tconfigs.get(name), device="meta")
    assert all(p.is_meta for p in params.parameters())
    assert convert.lm_param_specs(params) == _ref_specs(jconfigs.get(name))
    n = sum(p.numel() for p in params.parameters())
    # the reference's count leaves out norm scales and the VLM gates
    assert n >= tconfigs.get(name).param_count()


def test_meta_cache_has_the_reference_layout():
    """``init_cache`` on ``meta`` at a full config: the reference's leaves
    (``jax.eval_shape`` of its ``init_cache``) in shape and dtype."""
    for name in ("qwen3-14b", "llama-3.2-vision-90b", "deepseek-v3-671b"):
        cfg, jcfg = tconfigs.get(name), jconfigs.get(name)
        got = ttf.init_cache(cfg, 4, 192, device="meta")
        want = jax.eval_shape(lambda c=jcfg: jtf.init_cache(c, 4, 192))
        flat_g = jax.tree_util.tree_leaves_with_path(got)
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in flat_g] == [p for p, _ in flat_w], name
        for (p, g), (_, w) in zip(flat_g, flat_w):
            assert tuple(g.shape) == tuple(w.shape), (name, p)
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
            assert g.is_meta
