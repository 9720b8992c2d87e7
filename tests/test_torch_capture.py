"""The step's segments and its graph family (``core.capture``).

Every lowering is split at its host reads into segments run through a
``graphs`` runner. On the CPU a guarded runner stands in for the graph
family: it runs each segment under a dispatch mode that raises on every
host read (``aten._local_scalar_dense``, ``nonzero``, ``masked_select``,
boolean-mask indexing, host data lifted into a tensor) and on
``Tensor.tolist`` (which bypasses the dispatcher). Under it every segment
of every lowering runs at every level of the plan ladder, on both sides
of the compact overflow and at several bank choices; the segmented compact
and switch steps equal ``repro``'s, and each lowering makes the host reads
it should, between its segments. The family's own bookkeeping (copy in,
replay, clone out, launch counts, key hits) runs on the CPU with a graph
stand-in that replays by rerunning the segment. Capturing on the card is
tested by the ``cuda`` tests, which skip without one; JAX is imported only
by the tests that compare with it, so that the card's host, which has no
JAX, runs the ``cuda`` tests:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_capture.py
"""
import contextlib
import functools

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.control import build_ladder
from repro_torch.core import capture, item_memory, pipeline
from repro_torch.core.types import TorrConfig
from repro_torch.kernels import build
from repro_torch.serving.stream_engine import StreamEngine

from _torch_parity import SMALL, assert_dataclass_same, bipolar, pack_np

TCFG = TorrConfig(**SMALL)
# fps_target 40000 makes Alg. 1's bank choice vary with the queue depth
HET = dict(SMALL, fps_target=40000.0)


class HostRead(AssertionError):
    pass


_READS = {torch.ops.aten._local_scalar_dense, torch.ops.aten.nonzero,
          torch.ops.aten.masked_select, torch.ops.aten.lift_fresh}
_INDEXING = {torch.ops.aten.index, torch.ops.aten.index_put,
             torch.ops.aten.index_put_}


class _NoHostReads(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        packet = func.overloadpacket
        if packet in _READS:
            raise HostRead(f"{func} inside a segment")
        if packet in _INDEXING:
            for ix in args[1]:
                if ix is not None and ix.dtype in (torch.bool, torch.uint8):
                    raise HostRead(f"boolean-mask {func} inside a segment")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def no_host_reads():
    """Raise on any host read or host data inside the block."""
    tolist = torch.Tensor.tolist

    def banned(self):
        raise HostRead("Tensor.tolist inside a segment")

    torch.Tensor.tolist = banned
    try:
        with _NoHostReads():
            yield
    finally:
        torch.Tensor.tolist = tolist


class _CountReads(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func.overloadpacket is torch.ops.aten._local_scalar_dense
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def count_host_reads():
    """Count the scalar reads and ``tolist`` calls made in the block."""
    counter = _CountReads()
    tolist = torch.Tensor.tolist

    def counted(self):
        counter.n += 1
        return tolist(self)

    torch.Tensor.tolist = counted
    try:
        with counter:
            yield counter
    finally:
        torch.Tensor.tolist = tolist


class Guarded:
    """A ``graphs`` runner for the CPU: each segment runs eagerly under
    :func:`no_host_reads`; the keys are recorded."""

    def __init__(self):
        self.keys = []

    def run(self, key, fn, inputs):
        self.keys.append(key)
        with no_host_reads():
            return fn(*inputs)


def _t(q):
    return torch.from_numpy(np.ascontiguousarray(q).view(np.int32).copy())


def _steps(kw, S, T, seed=0, qd=None):
    """T steps of S temporally coherent windows (as
    ``tests/test_torch_engine.py``'s ``_make_inputs``): each proposal flips
    16 dims a step; valid counts and queue depths vary per stream, the
    depths pinned to ``qd`` when given."""
    cfg = TorrConfig(**kw)
    rng = np.random.default_rng(seed)
    base = bipolar(rng, (S, cfg.N_max, cfg.D))
    steps = []
    for _ in range(T):
        flips = rng.integers(0, cfg.D, (S, cfg.N_max, 16))
        for s in range(S):
            for n in range(cfg.N_max):
                base[s, n, flips[s, n]] *= -1
        valid = rng.random((S, cfg.N_max)) < rng.uniform(0.3, 1.0, (S, 1))
        boxes = rng.random((S, cfg.N_max, 4)).astype(np.float32)
        depth = rng.integers(0, 2 * cfg.q_hi, (S,)).astype(np.int32)
        if qd is not None:
            depth = np.asarray(qd, np.int32)
        steps.append((pack_np(base), valid, boxes, depth))
    return steps


def _im(cfg, seed=0):
    codes = bipolar(np.random.default_rng(seed), (cfg.M, cfg.D))
    return item_memory.build_item_memory(torch.from_numpy(codes)), codes


def _run(cfg, im, steps, S, graphs, **kw):
    """The multi-stream step over ``steps`` through ``graphs``; per-step
    (state, out, tel) and the host reads each step made."""
    task_w = np.random.default_rng(1).uniform(0, 1, (S, cfg.M))
    st = pipeline.init_multi_stream_state(cfg, task_w.astype(np.float32),
                                          device="cpu")
    res, reads = [], []
    for q, v, b, qd in steps:
        with count_host_reads() as c:
            st, out, tel = pipeline.torr_multi_stream_step(
                st, im, _t(q), v, b, qd, cfg, graphs=graphs, **kw)
        res.append((st, out, tel))
        reads.append(c.n)
    return res, reads


def _assert_runs_equal(a, b, what):
    for t, (x, y) in enumerate(zip(a, b)):
        for i in range(3):
            assert_dataclass_same(x[i], y[i], (what, t, i))


def test_the_guard_catches_every_host_read():
    x = torch.arange(6)
    reads = (lambda: int(x.sum()), lambda: x.tolist(), lambda: x[x > 2],
             lambda: torch.nonzero(x), lambda: x.masked_select(x > 1),
             lambda: torch.tensor(1.5), lambda: x[[0, 2]],
             lambda: x.index_put_((x > 3,), torch.tensor(0)))
    for read in reads:
        with pytest.raises(HostRead), no_host_reads():
            read()
    with no_host_reads():            # what the segments do instead
        torch.full((), 0.95, dtype=torch.float32)
        x[torch.arange(2)] = torch.full((), 0)
        torch.where(x > 2, x, 0)
    with count_host_reads() as c:
        int(x.sum())
        x.tolist()
    assert c.n == 2


# (name, step kwargs, config, S, host reads a step)
LOWERINGS = [
    ("prefix", dict(fused="prefix"), SMALL, 3, 0),
    ("off", dict(fused="off"), SMALL, 2, 0),
    ("compact batched, tier 1", dict(fused="compact", bucket_cap=1), SMALL,
     3, 1),
    ("compact batched, full tier", dict(fused="compact"), SMALL, 3, 1),
    ("compact scan, tier 2", dict(fused="compact", bucket_cap=2,
                                  decide="scan"), SMALL, 2, 1),
    ("compact serial", dict(fused="compact", serial=True, bucket_cap=4),
     SMALL, 2, 1),
    ("switch, 4 windows", dict(fused="switch"), HET, 4, 1),
    ("serial switch", dict(serial=True), HET, 3, 3),
]


@pytest.mark.parametrize("name,kw,cfg_kw,S,reads", LOWERINGS,
                         ids=[x[0] for x in LOWERINGS])
def test_segments_read_nothing_on_the_host_at_every_plan(name, kw, cfg_kw,
                                                         S, reads):
    """Every segment of the lowering at every level of the ladder (and no
    plan) runs under the guard, equals the eager step, and the step makes
    exactly its host reads between the segments: none on prefix and off,
    one a step on compact, one a step on the batched switch (all windows'
    bank choices) and one a window on serial switch."""
    cfg = TorrConfig(**cfg_kw)
    im, _ = _im(cfg)
    steps = _steps(cfg_kw, S, 2, seed=5, qd=[0, 2, 8, 30][:S])
    for plan in (None, *build_ladder(cfg)):
        g = Guarded()
        got, n = _run(cfg, im, steps, S, g, plan=plan, **kw)
        want, _ = _run(cfg, im, steps, S, None, plan=plan, **kw)
        _assert_runs_equal(got, want, (name, plan))
        assert n == [reads] * len(steps), (name, plan, n)
        assert g.keys and all(k[2] == plan for k in g.keys)


def _against_jax(cfg_kw, S, steps, graphs, **kw):
    """The port's step through ``graphs`` and repro's jitted step over the
    same windows: every output, telemetry field and state equal."""
    import jax
    import jax.numpy as jnp
    from repro.core import item_memory as jim
    from repro.core import pipeline as jpipe
    from repro.core.types import TorrConfig as JCfg

    jstep = jax.jit(functools.partial(jpipe.torr_multi_stream_step, **kw),
                    static_argnames="cfg")
    jcfg = JCfg(**cfg_kw)
    cfg = TorrConfig(**cfg_kw)
    im, codes = _im(cfg)
    jm = jim.build_item_memory(jnp.asarray(codes))
    task_w = np.random.default_rng(1).uniform(0, 1, (S, cfg.M)) \
        .astype(np.float32)
    jst = jpipe.init_multi_stream_state(jcfg, jnp.asarray(task_w))
    got, _ = _run(cfg, im, steps, S, graphs, **kw)
    for t, (q, v, b, qd) in enumerate(steps):
        jst, jout, jtel = jstep(jst, jm, jnp.asarray(q), jnp.asarray(v),
                                jnp.asarray(b), jnp.asarray(qd), jcfg)
        st, out, tel = got[t]
        assert_dataclass_same(out, jout, (kw, t))
        assert_dataclass_same(tel, jtel, (kw, t))
        assert_dataclass_same(st, jst, (kw, t))


@pytest.mark.parametrize("decide", ["batched", "scan"])
def test_segmented_compact_matches_jax_on_both_sides_of_overflow(decide):
    """Tier 4 overflows on the cold first step (16 full-path misses) and
    not on the warm steps after it (4, then 2); the guarded segmented step
    equals repro's on every step."""
    S, kw = 3, dict(SMALL, K=8)
    steps = _steps(kw, S, 3, seed=7)
    g = Guarded()
    _against_jax(kw, S, steps, g, fused="compact", bucket_cap=4,
                 decide=decide)
    overflow = [k[-1] for k in g.keys if k[0] == "finish"]
    assert overflow[0] and not all(overflow), overflow


@pytest.mark.parametrize("serial", [False, True])
def test_segmented_switch_matches_jax_at_several_bank_choices(serial):
    """The batched switch (one host read of every window's choice) and the
    serial switch (one a window) at queue depths 0, 2, 8 and 30, which
    give each window its own bank choice (8 down to 1, and they change
    between steps): the guarded segmented step equals repro's."""
    S = 4
    steps = _steps(HET, S, 2, seed=3, qd=[0, 2, 8, 30])
    g = Guarded()
    kw = dict(serial=True) if serial else dict(fused="switch")
    _against_jax(HET, S, steps, g, **kw)
    choices = [k[-1] for k in g.keys if k[0] == "switch"]
    seen = {c for cs in choices for c in cs}
    assert {1, 8} < seen and len(set(choices)) >= (4 if serial else 2), \
        choices


def test_graph_keys_differ_across_statics_and_repeat_on_a_hit():
    """Keys differ across plan, bucket tier, decide pass, overflow, bank
    choice and S, and the same step gives the same keys."""
    cfg = TorrConfig(**HET)
    ladder = build_ladder(cfg)
    im, _ = _memories_het()

    def keys(S=2, qd=(0, 0), **kw):
        g = Guarded()
        _run(cfg, im, _steps(HET, S, 1, seed=1, qd=list(qd)), S, g, **kw)
        return g.keys

    def only(ks, name):
        (k,) = [k for k in ks if k[0] == name]
        return k

    prefix = [only(keys(**kw), "prefix") for kw in (
        dict(fused="prefix"), dict(fused="prefix", plan=ladder[2]),
        dict(fused="prefix", S=3, qd=(0, 0, 0)))]
    compact = {(c, d): keys(fused="compact", bucket_cap=c, decide=d)
               for c in (1, 16) for d in ("batched", "scan")}
    finish = [only(ks, "finish") for ks in compact.values()]
    decide = {only(ks, "decide") for ks in compact.values()}
    switch = [only(keys(fused="switch", qd=qd), "switch")
              for qd in ((0, 30), (30, 30), (0, 0))]
    assert len(set(prefix)) == 3 and len(set(switch)) == 3
    assert [(k[5], *k[-2:]) for k in finish] == [
        ("batched", 1, True), ("scan", 1, True), ("batched", 16, False),
        ("scan", 16, False)]
    assert len(set(finish)) == 4 and len(decide) == 2  # tiers share decide
    assert [k[-1] for k in switch] == [(8, 1), (1, 1), (8, 8)]
    serial = keys(serial=True, qd=(0, 30))
    assert [k[-1] for k in serial] == [(8,), (1,)]
    assert all(k[4] == (1, cfg.N_max, cfg.words) for k in serial)
    assert keys(fused="compact", bucket_cap=1, decide="scan") \
        == compact[(1, "scan")]
    assert keys(serial=True, qd=(0, 30)) == serial
    every = prefix + finish + list(decide) + switch + serial
    assert len({hash(k) for k in every}) == len(set(every)) == len(every)


@functools.lru_cache(maxsize=None)
def _memories_het():
    return _im(TorrConfig(**HET))


class _ReplayOnCPU:
    """A captured graph's stand-in on the CPU: a replay reruns the segment
    on the static inputs and writes the static outputs in place."""

    def __init__(self, fn, inputs, outputs):
        self.fn, self.inputs, self.outputs = fn, inputs, outputs

    def replay(self):
        new = self.fn(*self.inputs)
        for d, s in zip(capture.leaves(self.outputs), capture.leaves(new)):
            d.copy_(s)


def _fake_capture(fn, inputs):
    static_in = capture.tree_map(torch.clone, inputs)
    static_out = fn(*static_in)
    return capture.Entry(_ReplayOnCPU(fn, static_in, static_out), fn,
                         static_in, static_out, {"bank_prefix_hamming": 2},
                         7)


@pytest.mark.parametrize("kw", [dict(fused="prefix"),
                                dict(fused="compact", bucket_cap=2),
                                dict(serial=True)],
                         ids=["prefix", "compact", "serial switch"])
def test_family_copies_in_replays_and_clones_out(monkeypatch, kw):
    """Through the family (its capture replaced by the stand-in): every
    step equals the eager step, results of earlier steps survive later
    replays, one entry per distinct key, and every replay adds the
    captured launch counts and kernel nodes."""
    monkeypatch.setattr(capture.GraphFamily, "_capture",
                        staticmethod(_fake_capture))
    cfg = TorrConfig(**HET)
    im, _ = _memories_het()
    steps = _steps(HET, 3, 4, seed=2, qd=[0, 8, 30])
    fam, rec = capture.GraphFamily(), Guarded()
    before = build.LAUNCHES["bank_prefix_hamming"]
    got, _ = _run(cfg, im, steps, 3, fam, **kw)
    want, _ = _run(cfg, im, steps, 3, None, **kw)
    _run(cfg, im, steps, 3, rec, **kw)
    _assert_runs_equal(got, want, kw)          # after every replay
    assert len(fam) == len(set(rec.keys)) < len(rec.keys)
    assert set(fam.keys()) == set(rec.keys)
    assert fam.replays == len(rec.keys)
    assert fam.nodes_replayed == 7 * len(rec.keys)
    assert build.LAUNCHES["bank_prefix_hamming"] - before \
        == 2 * len(rec.keys)
    entry = fam.entry(rec.keys[0])
    out = got[-1][1].scores
    assert all(out.data_ptr() != x.data_ptr()
               for x in capture.leaves(entry.outputs))


def test_family_rejects_inputs_unlike_the_captured_ones(monkeypatch):
    monkeypatch.setattr(capture.GraphFamily, "_capture",
                        staticmethod(_fake_capture))
    fam = capture.GraphFamily()

    def fn(x):
        return x + 1

    assert fam.run(("k",), fn, (torch.zeros(3),)).tolist() == [1, 1, 1]
    assert fam.run(("k",), fn, (torch.ones(3),)).tolist() == [2, 2, 2]
    for bad in ((torch.zeros(1),), (torch.zeros(3, dtype=torch.int32),),
                (torch.zeros(3), torch.zeros(3))):
        with pytest.raises(ValueError):
            fam.run(("k",), fn, bad)


@pytest.mark.parametrize("kw", [dict(), dict(fused="compact"),
                                dict(serial=True)],
                         ids=["prefix", "compact", "serial switch"])
def test_engine_jit_on_the_cpu_is_the_eager_step(kw):
    """``StreamEngine(jit=True, device="cpu")`` has no graphs and is
    bit-equal to ``jit=False``."""
    im, _ = _im(TCFG)
    steps = _steps(SMALL, 2, 3, seed=4)
    res = {}
    for jit in (True, False):
        eng = StreamEngine(TCFG, im, n_slots=2, jit=jit, device="cpu", **kw)
        assert eng.graphs is None
        eng.warmup()
        for s in range(2):
            eng.admit(s, np.full(TCFG.M, 0.5 + s, np.float32))
        out = []
        for q, v, b, _qd in steps:
            for s in range(2):
                eng.submit(s, q[s], v[s], b[s])
            out.append(eng.step())
        res[jit] = (out, eng.state)
    for t, (a, b) in enumerate(zip(res[True][0], res[False][0])):
        for s in a:
            assert_dataclass_same(a[s][0], b[s][0], (t, s))
            assert_dataclass_same(a[s][1], b[s][1], (t, s))
    assert_dataclass_same(res[True][1], res[False][1], "state")


# --- on the card -------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: graphs are captured only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(), dict(fused="compact", bucket_cap=2),
                                dict(fused="compact", decide="scan"),
                                dict(serial=True)],
                         ids=["prefix", "compact", "compact scan", "serial"])
def test_captured_engine_equals_eager_on_the_card(card, kw):
    im, _ = _memories_het()
    cfg = TorrConfig(**HET)
    steps = _steps(HET, 3, 4, seed=6)
    res = {}
    for jit in (True, False):
        eng = StreamEngine(cfg, im, n_slots=3, jit=jit, device=card, **kw)
        eng.warmup()
        for s in range(3):
            eng.admit(s, np.full(cfg.M, 0.25 * (s + 1), np.float32))
        out = []
        for q, v, b, _qd in steps:
            for s in range(3):
                eng.submit(s, q[s], v[s], b[s])
            out.append(eng.step())
        res[jit] = (out, eng.state, eng.graphs)
    assert len(res[True][2]) > 0 and res[False][2] is None
    for t, (a, b) in enumerate(zip(res[True][0], res[False][0])):
        for s in a:
            assert_dataclass_same(a[s][0], b[s][0], (t, s))
            assert_dataclass_same(a[s][1], b[s][1], (t, s))
    assert_dataclass_same(res[True][1], res[False][1], "state")


@pytest.mark.cuda
def test_a_capture_error_raises_on_the_card(card):
    fam = capture.GraphFamily()

    def reads_the_host(x):
        return x * int(x.sum())

    with pytest.raises(RuntimeError):
        fam.run(("bad",), reads_the_host, (torch.ones(4, device=card),))
    assert len(fam) == 0
    assert fam.run(("ok",), lambda x: x + 1,
                   (torch.ones(4, device=card),)).tolist() == [2.0] * 4
