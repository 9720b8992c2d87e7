"""Token-choice top-k MoE with capacity-based dispatch (DeepSeek V2/V3 style;
port of ``repro.models.moe``).

Routing: a float32 softmax router (float32 even in a bfloat16 model) ->
per-token top-k experts, renormalized gates. ``lax.top_k`` takes the lowest
index among equal probabilities; a stable descending sort does the same
(``torch.topk`` promises no order among ties on the card). Dispatch:
token-major priority over the k choices, a cumulative sum giving each
choice its position within its expert; each expert accepts up to
C = capacity(T) tokens and the rest are dropped: every dropped choice
scatters to one scratch slot E*C, the only slot written more than once,
which is discarded. One gather in, one gather out.

Shared experts (DeepSeek) are a dense gated MLP fused as one wide block.

Over a mesh (DTensors placed by ``runtime/sharding.py``) :func:`moe_ffn`
runs this global routing on the tokens gathered whole on every rank (the
dispatch indexes global token positions, which a shard cannot), each
rank running its own experts (:func:`_experts_global`), unless the config
sets ``moe_groups``: then
:func:`moe_ffn_ep` routes each rank's own tokens to its own experts and
one all-reduce over the 'model' axis combines them.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import torch
import torch.nn.functional as F

from ..runtime import spmd
from .config import ModelConfig
from .layers import Params, dense_init


def init_moe_params(cfg: ModelConfig, dtype,
                    generator: torch.Generator | None = None,
                    device=None) -> Params:
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff

    def w(shape, dt=dtype, fan_in=None):
        return dense_init(shape, dt, fan_in=fan_in, generator=generator,
                          device=device)

    p = dict(router=w((d, E), torch.float32),
             w_gate=w((E, d, f), fan_in=d), w_up=w((E, d, f), fan_in=d),
             w_down=w((E, f, d), fan_in=f))
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p.update(shared_gate=w((d, fs)), shared_up=w((d, fs)),
                 shared_down=w((fs, d), fan_in=fs))
    return Params(**p)


def capacity(tokens: int, cfg: ModelConfig) -> int:
    c = int(tokens * cfg.moe_top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)  # round up to 8


def moe_route(p: Params, xf: torch.Tensor, cfg: ModelConfig) -> dict:
    """Routing and capacity assignment of tokens xf [T, d]: the router's
    ``probs`` [T, E], the renormalized ``gate_vals`` and expert ``ids``
    [T, k], and per choice (t, j) at t*k + j its ``keep`` mask and
    dispatch slot ``dest`` (E*C when dropped), with the capacity ``C``."""
    T = xf.shape[0]
    E, k = cfg.n_experts, cfg.moe_top_k
    C = capacity(T, cfg)
    probs = torch.softmax(xf.float() @ p.router, dim=-1)          # [T, E]
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, ids = top[:, :k], order[:, :k]                      # [T, k]
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    # capacity assignment, token-major priority over the k choices (a
    # comparison, not F.one_hot, which reads the host on the CPU)
    experts = torch.arange(E, device=xf.device)
    ids_flat = ids.reshape(T * k)
    onehot = (ids_flat[:, None] == experts).to(torch.int32)        # [T*k, E]
    pos = torch.cumsum(onehot, dim=0) - onehot      # position within expert
    pos_flat = torch.sum(pos * onehot, dim=-1)                     # [T*k]
    keep = pos_flat < C
    dest = torch.where(keep, ids_flat * C + pos_flat, E * C)   # drop: scratch
    return dict(probs=probs, gate_vals=gate_vals, ids=ids, keep=keep,
                dest=dest, C=C)


def _experts(xf: torch.Tensor, rt: dict, w_gate, w_up, w_down,
             n_experts: int, k: int) -> torch.Tensor:
    """Dispatch tokens xf [T, d] by the routing ``rt`` to ``n_experts``
    experts of capacity C (weights [n_experts, ...]), run them and combine
    each token's kept choices weighted by its gates: y [T, d]. A dropped
    choice (``keep`` false) scatters to the scratch slot n_experts*C,
    which is discarded."""
    T, d = xf.shape
    C, keep, dest = rt["C"], rt["keep"], rt["dest"]
    n = n_experts * C
    token_of_choice = torch.arange(T * k, device=xf.device) // k
    slot_token = torch.zeros(n + 1, dtype=torch.long, device=xf.device
                             ).scatter_(0, dest, token_of_choice)[:-1]
    slot_used = torch.zeros(n + 1, dtype=xf.dtype, device=xf.device
                            ).scatter_(0, dest, torch.ones_like(
                                dest, dtype=xf.dtype))[:-1]

    x_disp = (xf[slot_token] * slot_used[:, None]).reshape(n_experts, C, d)
    h = F.silu(torch.einsum("ecd,edf->ecf", x_disp, w_gate)) * \
        torch.einsum("ecd,edf->ecf", x_disp, w_up)
    y_e = torch.einsum("ecf,efd->ecd", h, w_down).reshape(n, d)

    y_choice = y_e[torch.clamp(dest, max=n - 1)]                  # [T*k, d]
    y_choice = y_choice * (keep[:, None] * rt["gate_vals"].reshape(
        T * k)[:, None]).to(y_choice.dtype)
    return torch.sum(y_choice.reshape(T, k, d), dim=1)


def _experts_global(x_all, rt: dict, p: Params, E: int, k: int):
    """:func:`_experts` of the global routing. Over a mesh (``x_all`` and
    the routing whole on every rank) each rank runs its own experts (the
    stacks sharded over 'model') on its own local tensors: the choices
    routed to other ranks' experts are dropped there, and the ranks'
    partial outputs sum over 'model'."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(x_all, DTensor):
        return _experts(x_all, rt, p.w_gate, p.w_up, p.w_down, E, k)
    mesh = x_all.device_mesh
    names = tuple(mesh.mesh_dim_names)
    ours = [isinstance(q, Shard) for q in p.w_gate.placements]
    E_loc = E // math.prod(mesh.size(i) for i, s in enumerate(ours) if s)
    first = 0
    for i, s in enumerate(ours):      # this rank's first expert
        if s:
            first = first * mesh.size(i) + mesh.get_local_rank(names[i])
    first *= E_loc
    C = rt["C"]

    def local(xf, gate_vals, keep, dest, w_gate, w_up, w_down):
        mine = keep & (dest >= first * C) & (dest < (first + E_loc) * C)
        here = dict(C=C, gate_vals=gate_vals, keep=mine,
                    dest=torch.where(mine, dest - first * C, E_loc * C))
        return _experts(xf, here, w_gate, w_up, w_down, E_loc, k)

    whole = (Replicate(),) * mesh.ndim
    summed = tuple(Partial() if s else Replicate() for s in ours)
    stacks = tuple(p.w_gate.placements)
    return local_map(
        local, out_placements=list(summed),
        in_placements=(whole,) * 4 + (stacks,) * 3,
        in_grad_placements=(summed, summed, whole, whole) + (stacks,) * 3,
        device_mesh=mesh, redistribute_inputs=True)(
        x_all, rt["gate_vals"], rt["keep"], rt["dest"], p.w_gate, p.w_up,
        p.w_down)


def _aux(probs: torch.Tensor, ids: torch.Tensor, E: int) -> torch.Tensor:
    """The load-balance term's (mean router probability, top-1 fraction)
    per expert: f32 [E] each."""
    me = torch.mean(probs, dim=0)
    ce = torch.mean((ids[:, :1] == torch.arange(E, device=ids.device)
                     ).float(), dim=0)
    return me, ce


def moe_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig,
            mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y [B, S, d], aux_loss []). With ``mesh`` and
    ``cfg.moe_groups`` set: :func:`moe_ffn_ep`."""
    if cfg.moe_groups and mesh is not None:
        return moe_ffn_ep(p, x, cfg, mesh)
    B, S, d = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.moe_top_k
    # over a mesh xf's gradient comes back to xf's own placements before
    # the reshape's backward (summed from the paths below, it may come
    # sharded over two axes on the flattened dim, which a view cannot
    # split)
    xf = spmd.same_grad(x.reshape(T, d))
    x_all = spmd.replicate(xf)
    rt = moe_route(p, x_all, cfg)

    # load-balance aux (Switch-style): E * sum_e f_e * p_e
    me, ce = _aux(rt["probs"], rt["ids"], E)
    aux = E * torch.sum(me * ce)

    y = _experts_global(x_all, rt, p, E, k)
    if cfg.n_shared_experts:
        y = y + (F.silu(xf @ p.shared_gate) * (xf @ p.shared_up)) \
            @ p.shared_down
    y = spmd.placed_as(y, xf)      # over a mesh: the tokens' own rows
    return y.reshape(B, S, d).to(x.dtype), aux


def _grad_scaled(t: torch.Tensor, s: float) -> torch.Tensor:
    """``t``'s value, with its gradient scaled by ``s``."""
    return t * s + (t - t * s).detach()


def moe_ffn_ep(p: Params, x: torch.Tensor, cfg: ModelConfig,
               mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE over ``mesh`` (port of the reference's
    ``shard_map`` variant, ``src/repro/models/moe.py:48``).

    ``x`` and the parameters are DTensors on ``mesh``. Each (data x model)
    rank routes its local tokens (``x`` sharded over the batch axes,
    replicated over 'model'), with the local capacity C = capacity(local
    tokens), and runs only its E / msize local experts (the stacks sharded
    over 'model') and its column of the shared experts; one all-reduce
    over the 'model' axis's group combines the experts' and the shared
    partials: the same wire cost as the tensor-parallel all-reduce the
    layer already pays, and no dispatch collective. The gradients flow
    through DTensor's declared placements: each rank's local gradient of a
    weight replicated over an axis is a partial sum over that axis.

    ``aux`` is the global routing's load-balance term: the per-expert
    means all-reduced over the batch axes (the reference's ``out_specs
    P()`` returns one shard's own term). Top-k ties take the lowest
    expert index, as :func:`moe_route` does."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from ..runtime import sharding as shd
    from ..runtime.spmd import sum_over

    axes = tuple(mesh.mesh_dim_names)
    ba = shd.batch_axes(mesh)
    msize = shd.sizes(mesh)["model"]
    E, k = cfg.n_experts, cfg.moe_top_k
    if E % msize:
        raise ValueError(f"{E} experts do not divide over a model axis of "
                         f"{msize}")
    E_loc = E // msize

    def on(t, fwd, grad):
        """``t``'s local tensor under placements ``fwd`` (one per mesh
        axis), its gradient declared as ``grad``."""
        return t.redistribute(mesh, fwd).to_local(grad_placements=grad)

    def place(spec_of):
        return tuple(spec_of(a) for a in axes)

    # x: batch-sharded, replicated over model; its gradient partial there
    x_loc = on(x, place(lambda a: Shard(0) if a in ba else Replicate()),
               place(lambda a: Shard(0) if a in ba else Partial()))
    # a weight replicated over the batch axes has a partial gradient there
    def weight(t, dim):
        return on(t, place(lambda a: Shard(dim) if a == "model" and dim >= 0
                           else Replicate()),
                  place(lambda a: Partial() if a != "model" or dim < 0
                        else Shard(dim)))

    router = weight(p.router, -1)
    w_gate, w_up, w_down = (weight(p.w_gate, 0), weight(p.w_up, 0),
                            weight(p.w_down, 0))

    B, S, d = x_loc.shape
    T = B * S
    xf = x_loc.reshape(T, d)
    rt = moe_route(SimpleNamespace(router=router), xf, cfg)
    # aux: replicated over 'model', so its gradient counts once over it
    me, ce = _aux(_grad_scaled(rt["probs"], 1.0 / msize), rt["ids"], E)
    n_batch = 1
    for a in ba:
        me = sum_over(me, mesh.get_group(a))
        ce = sum_over(ce, mesh.get_group(a))
        n_batch *= shd.sizes(mesh)[a]
    aux = E * torch.sum((me / n_batch) * (ce / n_batch))

    my = mesh.get_local_rank("model")
    ids_flat = rt["ids"].reshape(T * k)
    mine = ids_flat // E_loc == my
    ids_local = torch.where(mine, ids_flat % E_loc, E_loc)
    experts = torch.arange(E_loc + 1, device=xf.device)
    onehot = (ids_local[:, None] == experts).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0) - onehot
    pos_flat = torch.sum(pos * onehot, dim=-1)
    C = rt["C"]
    keep = mine & (pos_flat < C)
    dest = torch.where(keep, ids_local * C + pos_flat, E_loc * C)
    y = _experts(xf, dict(rt, keep=keep, dest=dest), w_gate, w_up, w_down,
                 E_loc, k)
    if cfg.n_shared_experts:
        sg, su = weight(p.shared_gate, 1), weight(p.shared_up, 1)
        sd = weight(p.shared_down, 0)
        y = y + (F.silu(xf @ sg) * (xf @ su)) @ sd
    y = sum_over(y, mesh.get_group("model"))
    y = DTensor.from_local(
        y.reshape(B, S, d).to(x.dtype), mesh,
        place(lambda a: Shard(0) if a in ba else Replicate()),
        run_check=False)
    aux = DTensor.from_local(aux, mesh, place(lambda a: Replicate()),
                             run_check=False)
    return y, aux
