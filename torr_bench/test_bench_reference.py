"""The plain reference against the program's CPU path at a tiny
TorrConfig: the encode bit for bit (both float32 on the CPU), and the
compact step's every output and final cache against the reference's walk
over the same words."""
import numpy as np
import pytest
import torch

from tbench import inputs, reference as ref
from tbench.testing import TINY


def test_pack_unpack_round_trip_and_encode_margins():
    g = torch.Generator().manual_seed(0)
    bits = torch.randint(0, 2, (5, 1024), generator=g).bool()
    assert torch.equal(ref.unpack_bits(ref.pack_bits(bits)), bits)
    z = torch.randn(6, 32, generator=g)
    R = torch.randn(1024, 32, generator=g)
    words = ref.encode(z, R)
    good = ref.encode_margins(z, R, words)
    assert good["differ"] == 0 and good["margin"] == 0.0
    flipped = words.clone()
    flipped[2, 3] ^= 1 << 7                     # one bit, dimension 103
    bad = ref.encode_margins(z, R, flipped)
    y = (z[2].double() @ R[103].double()).abs()
    scale = z[2].double().abs() @ R[103].double().abs()
    assert bad["differ"] == 1
    assert bad["margin"] == pytest.approx(float(y / scale), rel=1e-12)


def _port_step_outputs(inp, n_win):
    from repro_torch.core import pipeline
    from repro_torch.core.item_memory import build_item_memory
    from repro_torch.kernels import ops
    from tbench.serving import torr_config

    cfg = torr_config(TINY)
    im = build_item_memory(inp.codes, plane_total=cfg.bit_planes)
    S = inp.valid.shape[0]
    state = pipeline.init_multi_stream_state(cfg, inp.task_w, "cpu")
    outs, words = [], []
    for t in range(n_win):
        z = inp.feats[:, t].reshape(-1, TINY["feat_dim"])
        q = ops.encode_packed(z, inp.R, device="cpu").reshape(
            S, TINY["N_max"], -1)
        words.append(q)
        state, out, tel = pipeline.torr_multi_stream_step(
            state, im, q, torch.as_tensor(inp.valid[:, t]),
            torch.as_tensor(inp.boxes[:, t]),
            torch.zeros(S, dtype=torch.int32), cfg, fused="compact")
        outs.append((out, tel))
    return state, outs, torch.stack(words, 1)


def test_reference_walk_equals_the_compact_step_on_the_cpu():
    S, n_win = 3, 6
    inp = inputs.make_inputs(TINY, S, n_win, TINY["K"], 5, "cpu")
    state, outs, words = _port_step_outputs(inp, n_win)
    enc = ref.encode(inp.feats.reshape(-1, TINY["feat_dim"]), inp.R)
    assert torch.equal(enc.reshape(words.shape), words)
    served = [ref.Served(content=s * n_win + np.arange(n_win),
                         valid=inp.valid[s], qd=np.zeros(n_win, np.int64))
              for s in range(S)]
    rep = ref.replay(TINY, inp.codes, words.reshape(S * n_win,
                                                    TINY["N_max"], -1),
                     served, np.repeat(np.arange(S), n_win))
    paths = set()
    for t, (out, tel) in enumerate(outs):
        for s in range(S):
            assert np.array_equal(tel.path[s].numpy(), rep.path[s][t])
            assert np.array_equal(tel.delta_count[s].numpy(),
                                  rep.d_count[s][t])
            assert np.array_equal(tel.rho[s].numpy().view(np.int32),
                                  rep.rho[s][t].view(np.int32))
            rows = ref.reasoned(rep, rep.out_ptr[s][t], inp.task_w)
            assert torch.equal(out.scores[s], rows)
            paths |= set(rep.path[s][t][inp.valid[s, t]].tolist())
    assert paths == {0, 1, 2}                 # bypass, delta and full ran
    c = rep.cache
    for name in ("acc", "acc_tag", "topk_key", "age", "valid", "packed"):
        assert np.array_equal(getattr(state.cache, name).numpy(), c[name])
    assert torch.equal(state.cache.out.reshape(-1, TINY["M"]),
                       ref.reasoned(rep, c["out_ptr"].reshape(-1),
                                    inp.task_w))
