"""Step builders: train / prefill / decode, plain or over a mesh, and the
dry-run's lowering (port of ``repro.runtime.steps``).

The train step is functional, as the reference's jitted one is: it takes
the parameters as a flat dict of named tensors (the keys of the model's
``Params.state_dict()``, e.g. ``groups.0.self_0.attn.wq``), the AdamW state
and a batch, and returns new parameters, a new state and the metrics, all
tensors on the parameters' device. The forward and its backward
(``torch.autograd.grad``) run in one ``torch.func.functional_call`` on a
skeleton of the model built on the ``meta`` device, so no weights are held
twice, and the update is ``optim/adamw.py``'s. Nothing is written in
place, and nothing is read on the host.

With ``mesh=`` each step runs on DTensors placed by ``runtime/sharding.py``
(``runtime/spmd.py``). :func:`lower_cell` binds a cell's step to
abstract (``meta``) inputs placed on the mesh, the counterpart of the
reference's ``jit(...).lower``; its :meth:`Lowered.analyze` runs the step
once under ``perf/op_analyze.py`` where the reference compiles.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..data.tokens import to_device
from ..device import resolve_device
from ..models import transformer as tf
from ..models.config import ModelConfig
from ..optim import adamw
from . import sharding as shd
from . import spmd

# the reference stacks these subtrees' layers along a leading axis
STACKED = ("groups", "dense_prefix")


def decayed(params: dict[str, torch.Tensor]) -> frozenset[str]:
    """The names the reference's AdamW decays: a leaf whose stacked form
    (a layer axis in front under ``groups``/``dense_prefix``) has
    ``ndim >= 2``, so every per-layer tensor there, norm scales included."""
    return frozenset(k for k, p in params.items()
                     if p.dim() + (k.split(".")[0] in STACKED) >= 2)


class _LossAndGrads(nn.Module):
    """``forward_train`` and its gradients as one module call, for
    ``functional_call``: the backward runs inside the call, because a
    checkpointed region recomputes its forward there and must read the
    tensors the call binds, not the skeleton's."""

    def __init__(self, cfg: ModelConfig, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        self.params = tf.init_params(cfg, device="meta")

    def forward(self, batch: dict):
        loss, metrics = tf.forward_train(self.params, batch, self.cfg,
                                         mesh=self.mesh)
        named = list(self.params.named_parameters())
        grads = torch.autograd.grad(loss, [t for _, t in named],
                                    allow_unused=True)
        grads = {k: torch.zeros_like(t) if g is None else g
                 for (k, t), g in zip(named, grads)}
        return (loss.detach(), {k: m.detach() for k, m in metrics.items()},
                grads)


def loss_and_grads(cfg: ModelConfig, params: dict[str, torch.Tensor],
                   batch: dict, fn: nn.Module | None = None):
    """(loss, metrics, grads) of ``forward_train`` at ``params`` (a flat
    dict of tensors keyed as ``Params.state_dict()``); every gradient is a
    tensor (zeros where the loss does not depend on the parameter),
    metrics are detached."""
    fn = fn if fn is not None else _LossAndGrads(cfg)
    leaves = {f"params.{k}": v.detach().requires_grad_(True)
              for k, v in params.items()}
    with torch.enable_grad():
        return torch.func.functional_call(fn, leaves, (batch,))


def _batch_on(batch: dict, device: torch.device) -> dict:
    if any(isinstance(v, np.ndarray) for v in batch.values()):
        return to_device(batch, device)
    return {k: v if v.device.type == "meta" else v.to(device)
            for k, v in batch.items()}


def _on_mesh(mesh, rule, tree):
    """``tree`` with every plain tensor placed on ``mesh`` by ``rule`` (a
    ``sharding.*_sharding`` function); DTensors stay as they are."""
    from torch.distributed.tensor import DTensor

    return shd.tree_zip_map(
        lambda t, s: t if isinstance(t, DTensor) else shd.distribute(t, s),
        tree, rule(tree, mesh))


def _as_params(grads: dict, params: dict) -> dict:
    """Each DTensor gradient on its parameter's placements: a gradient
    left ``Partial`` (a sum over the batch shards still to take) is
    reduced once here, where AdamW would otherwise reduce g and g*g each
    on its own, in two orders (so a g*g near zero could come out
    negative)."""
    from torch.distributed.tensor import DTensor

    return {k: g.redistribute(params[k].device_mesh, params[k].placements)
            if isinstance(g, DTensor) else g for k, g in grads.items()}


def _mesh_device(mesh) -> torch.device:
    return torch.device(mesh.device_type)


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.OptimConfig,
                    device=None, mesh=None):
    """``train_step(params, opt_state, batch) -> (params', opt_state',
    metrics)`` on ``device`` (the card unless the caller names another;
    without a card this raises unless ``device="cpu"``). ``batch`` may be
    numpy arrays (``TokenStream.batch_at``) or tensors; it is moved to the
    device. Weight decay applies to what the reference decays
    (:func:`decayed`).

    With ``mesh`` (a ``DeviceMesh``; ``device`` is then its device type)
    the step runs on DTensors (``spmd.mesh_mode``): parameters, AdamW
    state and batch placed by ``runtime/sharding.py`` (a plain tensor is
    placed on the way in; placing the parameters and state once, with
    ``sharding.distribute``, saves that copy), and an MoE config with
    ``moe_groups`` routes expert-parallel (``moe.moe_ffn_ep``). The
    metrics come back whole (reduced, on every rank)."""
    device = _mesh_device(mesh) if mesh is not None \
        else resolve_device(device)
    fn = _LossAndGrads(cfg, mesh)

    def step(params, opt_state, batch):
        _, metrics, grads = loss_and_grads(cfg, params, batch, fn)
        grads = _as_params(grads, params)
        params, opt_state, om = adamw.apply_updates(
            {k: v.detach() for k, v in params.items()}, grads, opt_state,
            opt_cfg, decay=decayed(params))
        return params, opt_state, {**metrics, **om}

    def train_step(params, opt_state, batch):
        return step(params, opt_state, _batch_on(batch, device))

    if mesh is None:
        return train_step

    def mesh_step(params, opt_state, batch):
        params = _on_mesh(mesh, shd.params_sharding, params)
        opt_state = _on_mesh(mesh, shd.params_sharding, opt_state)
        batch = _on_mesh(mesh, shd.batch_sharding, _batch_on(batch, device))
        with spmd.mesh_mode():
            params, opt_state, metrics = step(params, opt_state, batch)
        return params, opt_state, shd.full_tensors(metrics)

    return mesh_step


def init_train_state(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """``{"params": flat dict, "opt": AdamW state}`` with weights drawn on
    ``device`` (the card unless named) from a generator seeded ``seed``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = dict(tf.init_params(cfg, generator=gen, device=device)
                  .state_dict())
    return {"params": params, "opt": adamw.init_opt_state(params)}


def make_decode_step(cfg: ModelConfig, mesh=None):
    """``decode_step(params, cache, tokens) -> (cache, logits)``; with
    ``mesh`` on DTensors (plain inputs placed on the way in: the cache by
    ``sharding.cache_sharding``, which the step then updates in place)."""
    def decode_step(params, cache, tokens):
        return tf.decode_step(_module(cfg, params), cache, tokens, cfg)

    if mesh is None:
        return decode_step

    def mesh_step(params, cache, tokens):
        params = _on_mesh(mesh, shd.params_sharding, _flat(params))
        cache = _on_mesh(mesh, shd.cache_sharding, cache)
        tokens = _on_mesh(mesh, shd.batch_sharding, {"tokens": tokens})
        with spmd.mesh_mode():
            return tf.decode_step(_module(cfg, params), cache,
                                  tokens["tokens"], cfg)

    return mesh_step


def make_prefill(cfg: ModelConfig, s_max: int | None = None, mesh=None):
    """``prefill_step(params, batch) -> (cache, last logits)``; with
    ``mesh`` on DTensors, the cache built on the mesh
    (``sharding.cache_sharding``)."""
    def prefill_step(params, batch):
        return tf.prefill(_module(cfg, params), batch, cfg, s_max=s_max)

    if mesh is None:
        return prefill_step

    def mesh_step(params, batch):
        params = _on_mesh(mesh, shd.params_sharding, _flat(params))
        batch = _on_mesh(mesh, shd.batch_sharding, batch)
        with spmd.mesh_mode():
            return tf.prefill(_module(cfg, params), batch, cfg, s_max=s_max,
                              mesh=mesh)

    return mesh_step


def _flat(params) -> dict:
    return params if isinstance(params, dict) else dict(params.state_dict())


def _module(cfg: ModelConfig, flat):
    """A ``Params`` tree on ``meta`` holding the tensors of ``flat`` (keyed
    as its state dict) in place of its own; a ``Params`` tree as it is."""
    if not isinstance(flat, dict):
        return flat
    params = tf.init_params(cfg, device="meta")
    for name, t in flat.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = params.get_submodule(mod_name) if mod_name else params
        mod._parameters[leaf] = t
    return params


# ---------------------------------------------------------------------------
# Lowering (the dry-run's cells)
# ---------------------------------------------------------------------------

def abstract_params(cfg: ModelConfig) -> dict:
    """The parameters as a flat dict of ``meta`` tensors: shapes and
    dtypes, nothing allocated."""
    return dict(tf.init_params(cfg, device="meta").state_dict())


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    return sum((t.to_local() if isinstance(t, DTensor) else t).numel()
               * t.element_size()
               for t in torch.utils._pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class Lowered:
    """A cell's step bound to its placed abstract inputs.

    ``argument_bytes``: one rank's shards of the inputs; ``output_bytes``:
    one rank's shards of the outputs that do not reuse a donated input
    (set by :meth:`analyze`)."""

    def __init__(self, fn, args: tuple, donated: tuple = ()):
        self.fn = fn
        self.args = args
        self.donated = donated
        self.argument_bytes = _local_bytes(args)
        self.output_bytes = 0
        self.analysis = None

    def analyze(self, sample_loops: bool = True):
        """Run the step once under ``op_analyze.OpAnalyzer`` (the Python
        loops that stand for ``lax.scan`` sampled and scaled); returns its
        ``Analysis``, also kept as ``self.analysis``."""
        from ..perf import op_analyze

        out, an = op_analyze.analyze(self.fn, *self.args,
                                     sample_loops=sample_loops)
        kept = [o for i, o in enumerate(out if isinstance(out, tuple)
                                        else (out,))
                if i not in self.donated]
        self.output_bytes = _local_bytes(kept)
        self.analysis = an
        return an


def _meta(spec) -> torch.Tensor:
    return torch.empty(spec.shape, dtype=spec.dtype, device="meta")


def lower_cell(cfg: ModelConfig, shape: dict, mesh, *,
               opt_cfg: adamw.OptimConfig | None = None,
               donate: bool = True) -> tuple[Lowered, dict]:
    """Build + bind the step of one (arch x shape x mesh) cell to abstract
    inputs on ``mesh``. Returns (lowered, {"mode": ...}).

    train: the train step on parameters, AdamW state and batch; prefill:
    with cache capacity == prompt length, so the terms measure exactly the
    assigned shape; decode: one token against an S-long cache. With
    ``donate`` the train step's parameters and state, and decode's cache,
    count as updated in place (their outputs reuse the inputs' memory)."""
    from ..configs.registry import input_specs  # local to avoid cycle

    mode = shape["mode"]
    params_abs = abstract_params(cfg)
    params = shd.distribute(params_abs,
                            shd.params_sharding(params_abs, mesh))
    batch_abs = {k: _meta(v) for k, v in input_specs(cfg, shape).items()}
    batch = shd.distribute(batch_abs, shd.batch_sharding(batch_abs, mesh))

    if mode == "train":
        opt_cfg = opt_cfg or adamw.OptimConfig()
        opt_abs = adamw.init_opt_state(params_abs)
        opt = shd.distribute(opt_abs, shd.params_sharding(opt_abs, mesh))
        step = make_train_step(cfg, opt_cfg, mesh=mesh)
        return Lowered(step, (params, opt, batch),
                       donated=(0, 1) if donate else ()), {"mode": mode}

    if mode == "prefill":
        step = make_prefill(cfg, s_max=shape["seq_len"], mesh=mesh)
        return Lowered(step, (params, batch)), {"mode": mode}

    B, S = shape["global_batch"], shape["seq_len"]
    cache_abs = tf.init_cache(cfg, B, S, device="meta")
    cache = shd.distribute(cache_abs, shd.cache_sharding(cache_abs, mesh))
    step = make_decode_step(cfg, mesh=mesh)
    return Lowered(step, (params, cache, batch["tokens"]),
                   donated=(0,) if donate else ()), {"mode": mode}
