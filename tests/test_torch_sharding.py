"""Port parity: the sharding rules (``repro_torch.runtime.sharding`` vs
``repro.runtime.sharding``).

Exact, spec for spec, on the 1x1, 2x4, 2x2x2, 16x16 and 2x16x16 meshes:
  * every parameter leaf of every architecture, smoke and full (the
    reference's tree from ``jax.eval_shape``, the port's on ``meta``): the
    port's per-layer leaf gets the reference's stacked leaf's spec with
    the stacked group axis removed; the AdamW moments get their
    parameter's;
  * every decode-cache leaf of every family, the int8 dicts of
    ``serve_quant="int8"`` included;
  * the batch specs of every mode.
The reference's rules read only ``mesh.shape`` and ``mesh.axis_names``,
and the port's ``mesh_dim_names`` and ``shape``, so stand-ins serve as
meshes. ``placements`` turns each spec into DTensor placements.
"""
import dataclasses

import jax
import pytest

from repro import configs as jconfigs
from repro.models import transformer as jtf
from repro.runtime import sharding as jshd
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import transformer as ttf
from repro_torch.optim import adamw
from repro_torch.runtime import sharding as tshd
from repro_torch.runtime import steps as tsteps

ARCHS = sorted(jconfigs.ARCHS)
MESHES = [((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


class RefMesh:
    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = axes


class PortMesh:
    def __init__(self, shape, axes):
        self.shape = tuple(shape)
        self.mesh_dim_names = axes


def _meshes():
    return [(RefMesh(s, a), PortMesh(s, a)) for s, a in MESHES]


def _ref_flat(tree) -> dict:
    """{"a/b/c": leaf} of a reference pytree (dict keys; tuple indices as
    numbers)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    out = {}
    for path, leaf in flat:
        keys = [str(e.key) if isinstance(e, jax.tree_util.DictKey)
                else str(e.idx) for e in path]
        out["/".join(keys)] = leaf
    return out


def _port_leaves(tree, path=()):
    """[(path, tensor)] of a port tree (dict keys, tuple indices)."""
    if isinstance(tree, dict):
        return [it for k, v in tree.items()
                for it in _port_leaves(v, path + (k,))]
    if isinstance(tree, (tuple, list)):
        return [it for i, v in enumerate(tree)
                for it in _port_leaves(v, path + (i,))]
    return [(path, tree)]


def _ref_params(cfg):
    return jax.eval_shape(lambda k: jtf.init_params(k, cfg),
                          jax.random.PRNGKey(0))


def _check_params(cfg):
    ref_abs = _ref_params(cfg)
    port_abs = tsteps.abstract_params(cfg)
    for rmesh, pmesh in _meshes():
        ref = _ref_flat(jshd.params_pspecs(ref_abs, rmesh))
        got = tshd.params_pspecs(port_abs, pmesh)
        assert len(got) == len(port_abs)
        for name, spec in got.items():
            path, idx = convert._lm_path(name)
            want = tuple(ref["/".join(path)])
            if idx is not None:
                assert want[:1] in ((), (None,)), (name, want)
                want = want[1:]
            assert tuple(spec) == want or (not want and not any(spec)), \
                (cfg.name, pmesh.shape, name, spec, want)
            # and the placements follow the spec
            pl = tshd.placements(spec, pmesh)
            assert len(pl) == len(pmesh.shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference_smoke(arch):
    _check_params(jconfigs.get_smoke(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference_full(arch):
    _check_params(jconfigs.get(arch))


def test_opt_state_specs_follow_their_parameters():
    cfg = tconfigs.get_smoke("deepseek-v3-671b")
    params = tsteps.abstract_params(cfg)
    opt = adamw.init_opt_state(params)
    for _, pmesh in _meshes():
        specs = tshd.params_pspecs(opt, pmesh)
        want = tshd.params_pspecs(params, pmesh)
        assert specs["mu"] == want and specs["nu"] == want
        assert specs["step"] == ()


CACHE_CASES = [(a, q) for a in ARCHS for q in ("none", "int8")]


@pytest.mark.parametrize("arch,quant", CACHE_CASES)
def test_cache_specs_match_reference(arch, quant):
    for build in (jconfigs.get_smoke, jconfigs.get):
        jcfg = dataclasses.replace(build(arch), serve_quant=quant)
        tcfg = dataclasses.replace(
            (tconfigs.get_smoke if build is jconfigs.get_smoke
             else tconfigs.get)(arch), serve_quant=quant)
        B, S = (8, 64) if build is jconfigs.get_smoke else (128, 32768)
        ref_cache = jax.eval_shape(lambda: jtf.init_cache(jcfg, B, S))
        port_cache = ttf.init_cache(tcfg, B, S, device="meta")
        for rmesh, pmesh in _meshes():
            ref = {k: tuple(v) for k, v in
                   _ref_flat(jshd.cache_pspecs(ref_cache, rmesh)).items()}
            got = {"/".join(map(str, p)): tshd.cache_spec(p, leaf, pmesh)
                   for p, leaf in _port_leaves(port_cache)}
            assert got.keys() == ref.keys(), (arch, quant)
            for k in ref:
                assert got[k] == ref[k] or (not ref[k] and not any(got[k])), \
                    (arch, quant, pmesh.shape, k, got[k], ref[k])


@pytest.mark.parametrize("shape", sorted(jconfigs.SHAPES))
def test_batch_specs_match_reference(shape):
    for arch in ARCHS:
        jspecs = jconfigs.registry.input_specs(jconfigs.get(arch),
                                               jconfigs.SHAPES[shape])
        tspecs = tconfigs.registry.input_specs(tconfigs.get(arch),
                                               tconfigs.SHAPES[shape])
        for rmesh, pmesh in _meshes():
            for k, leaf in jspecs.items():
                want = tuple(jshd.batch_spec(rmesh, leaf))
                got = tshd.batch_spec(pmesh, tspecs[k])
                assert got == want, (arch, shape, k, got, want)
