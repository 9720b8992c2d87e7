"""The port's LM serving path (``repro_torch.launch.serve``'s ``--arch``
loop, ``run_lm``) on the CPU.

The counterpart of ``tests/test_system.py::test_serving_loop_generates``
(musicgen-large, smoke, in process); a reranked dense run whose reranker,
fed the port's decoded hidden states, is held to ``repro``'s reranker by
the agreement rule of ``kernels.ref.sign_pack_disagreement`` and bit for
bit wherever the two packed queries are equal (as
``tests/test_torch_reranker.py`` holds it); the decode step read nothing
on the host under the guard of ``tests/test_torch_capture.py``; the decode
loop through the graph family (its capture replaced by a CPU stand-in that
replays by rerunning the step) equal to the eager loop; the default device
raising without a card; the families not ported yet raising.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hdc as jhdc
from repro.core import item_memory as jim
from repro.core.types import TorrConfig as JCfg
from repro.serving import reranker as jrr
from repro_torch import convert
from repro_torch.core import capture
from repro_torch.core.types import TorrConfig
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models import transformer as tf
from repro_torch.serving import reranker as trr

import _torch_lm as lm
from _torch_parity import assert_same, bipolar, words
from test_torch_capture import no_host_reads


def test_cli_generates_audio_tokens(capsys):
    serve.main(["--arch", "musicgen-large", "--smoke", "--batch", "2",
                "--prompt-len", "16", "--gen", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "generated shape (2, 8, 4)" in out
    assert "[serve] arch=musicgen-large batch=2 prompt=16 gen=8" in out
    assert "bypass" not in out


def _jax_reranker(rcfg_kw, d_model, seed=0):
    """The same reranker in both packages from numpy draws (vocab == M:
    the identity concept map)."""
    cfg, jcfg = TorrConfig(**rcfg_kw), JCfg(**rcfg_kw)
    rng = np.random.default_rng(seed)
    codes = bipolar(rng, (cfg.M, cfg.D))
    R = (rng.standard_normal((cfg.D, d_model)) / np.sqrt(d_model)
         ).astype(np.float32)
    task_w = (1.0 + (codes.astype(np.int32) @ bipolar(rng, (cfg.D,)).astype(
        np.int32)).astype(np.float32) / cfg.D).astype(np.float32)
    jp = jrr.RerankerParams(jnp.asarray(R), jnp.asarray(task_w), None,
                            jnp.float32(0.5))
    jmem = jim.build_item_memory(jnp.asarray(codes),
                                 plane_total=jcfg.bit_planes)
    tp = convert.reranker_params_from_numpy(R, task_w, None,
                                            np.float32(0.5))
    return (cfg, tp, convert.item_memory_from_numpy(codes, cfg.bit_planes)), \
        (jcfg, jp, jmem)


def test_reranked_dense_run_agrees_with_the_reference_reranker(capsys):
    B, gen = 3, 10
    res = serve.run_lm("qwen3-14b", smoke=True, batch=B, prompt_len=16,
                       gen=gen, rerank=True, device="cpu", record=True)
    out = capsys.readouterr().out
    assert "[serve] reranker bypass rate: " in out
    assert 0.0 <= res["bypass_rate"] <= 1.0
    assert res["tokens"].shape == (B, gen)
    assert not any(res["launches"].values())     # plain versions on the CPU
    cfg = res["cfg"]
    kw = dict(D=2048, B=8, M=min(cfg.vocab, 256), K=8, N_max=B,
              feat_dim=cfg.d_model)
    (tcfg, tp, tmem), (jcfg, jp, jmem) = _jax_reranker(kw, cfg.d_model)
    ref_step = jax.jit(jrr.rerank_step, static_argnames=("cfg",))
    ref_pack = jax.jit(lambda h, R: jhdc.pack_bits(jhdc.sign_project(h, R)))
    st, sj = trr.init_state(tcfg, B, "cpu"), jrr.init_state(jcfg, B)
    equal = 0
    for logits, hidden in res["steps"]:
        h = hidden.float()
        assert h.shape == (B, cfg.d_model) and torch.isfinite(h).all()
        qp = ops.encode_packed(h, tp.R, device="cpu")
        qj = np.asarray(ref_pack(jnp.asarray(h.numpy()), jp.R))
        rule = ref.sign_pack_disagreement(h, tp.R, qp,
                                          convert.words_from_numpy(qj))
        assert rule["ok"], rule
        got = trr.rerank_step(tp, st, tmem, h, logits, tcfg)
        want = ref_step(jp, sj, jmem, jnp.asarray(h.numpy()),
                        jnp.asarray(logits.numpy()), jcfg)
        if np.array_equal(words(qp), qj):
            equal += 1
            assert_same(got[0], want[0], "logits")
            assert_same(got[2]["rho"], want[2]["rho"], "rho")
            assert_same(got[2]["bypassed"], want[2]["bypassed"], "bypassed")
            assert_same(words(got[1].prev_q), words(want[1].prev_q), "q")
            assert_same(got[1].prev_s, want[1].prev_s, "prev_s")
        st, sj = got[1], want[1]
    assert equal >= gen - 1


FAMILIES = ("qwen3-14b", "musicgen-large", "llama-3.2-vision-90b",
            "deepseek-v2-236b")


def _prefilled(name, B=2, S=16):
    _, cfg = lm.configs(name)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = lm.prompt(cfg, B, S + 4)
    toks = torch.from_numpy(batch["tokens"])
    prompt = {"tokens": toks[:, :S]}
    if "vision" in batch:
        prompt["vision"] = torch.from_numpy(batch["vision"]).to(
            torch.bfloat16)
    cache, _ = tf.prefill(params, prompt, cfg)
    return cfg, params, cache, toks[:, S:]


@pytest.mark.parametrize("name", FAMILIES)
def test_decode_step_reads_nothing_on_the_host(name):
    """The step a CUDA graph captures (``_decode_segment``) under the host
    read guard: no scalar read, no ``nonzero``, no boolean-mask indexing,
    no host data lifted into a tensor."""
    cfg, params, cache, nxt = _prefilled(name)
    names = tuple(cache)
    step = serve._decode_segment(params, cfg, names)
    leaves = tuple(cache[n] for n in names)
    for t in range(2):
        with no_host_reads():
            leaves, logits, hidden = step(leaves, nxt[:, t])
    assert int(dict(zip(names, leaves))["pos"]) == 18


class _ReplayOnCPU:
    """A captured graph's stand-in: a replay reruns the step on the static
    inputs (updating them in place, as the graph does) and writes the
    static outputs."""

    def __init__(self, fn, inputs, outputs):
        self.fn, self.inputs, self.outputs = fn, inputs, outputs

    def replay(self):
        new = self.fn(*self.inputs)
        for d, s in zip(capture.leaves(self.outputs), capture.leaves(new)):
            if d is not s:
                d.copy_(s)


def _fake_capture(fn, inputs):
    static_in = capture.tree_map(torch.clone, inputs)
    static_out = fn(*static_in)
    return capture.Entry(_ReplayOnCPU(fn, static_in, static_out), fn,
                         static_in, static_out, {}, 0)


@pytest.mark.parametrize("name", ["qwen3-14b", "deepseek-v2-236b"])
def test_decode_through_the_graph_family_equals_eager(monkeypatch, name):
    """The launcher's loop through ``GraphFamily`` (copy in, replay, clone
    out), every step equal to the eager ``decode_step``, and the caller's
    cache never written by a replay."""
    monkeypatch.setattr(capture.GraphFamily, "_capture",
                        staticmethod(_fake_capture))
    cfg, params, cache, nxt = _prefilled(name)
    eager = {k: capture.tree_map(torch.clone, v) for k, v in cache.items()}
    names = tuple(cache)
    step = serve._decode_segment(params, cfg, names)
    fam = capture.GraphFamily()
    key = (serve.LM_DECODE, cfg, 2, 16 + 64)
    for t in range(4):
        before = capture.tree_map(torch.clone, tuple(cache[n] for n in names))
        leaves, logits, hidden = fam.run(
            key, step, (tuple(cache[n] for n in names), nxt[:, t]))
        for a, b in zip(capture.leaves(before),
                        capture.leaves(tuple(cache[n] for n in names))):
            assert torch.equal(a, b)                  # the input untouched
        cache = dict(zip(names, leaves))
        eager, lg, h = tf.decode_step(params, eager, nxt[:, t], cfg,
                                      return_hidden=True)
        assert torch.equal(logits, lg) and torch.equal(hidden, h)
        for a, b in zip(capture.leaves(tuple(cache[n] for n in names)),
                        capture.leaves(tuple(eager[n] for n in names))):
            assert torch.equal(a, b)
    assert len(fam) == 1 and fam.replays == 4


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.run_lm("qwen3-14b", smoke=True, gen=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3-14b", "--smoke", "--gen", "2"])


def test_cli_refuses_a_full_config_on_the_cpu_and_unknown_archs():
    with pytest.raises(SystemExit):
        serve.main(["--arch", "qwen3-14b", "--device", "cpu"])
    with pytest.raises(SystemExit):
        serve.main(["--arch", "gpt-17", "--smoke", "--device", "cpu"])


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "xlstm-1.3b"])
def test_recurrent_families_raise(name):
    """Ported since: ``run_lm`` serves both recurrent families (they raised
    before; ``tests/test_torch_lm_recurrent.py`` holds them to
    ``repro``)."""
    res = serve.run_lm(name, smoke=True, gen=2, device="cpu")
    assert res["tokens"].shape == (4, 2)
