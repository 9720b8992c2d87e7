"""Port parity: ``repro_torch.checkpoint.manager`` and the training half of
``repro_torch.runtime.fault``: every test of ``tests/test_checkpoint_fault.py``
restated for the port, a bfloat16 round trip, an async save, and the
on-disk protocol shared with ``repro``: a checkpoint the port writes is read
back by the reference's ``CheckpointManager`` (``_load_leaves`` and
``restore``) as the same arrays, and one the reference writes by the
port's."""
import pathlib
import warnings

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.runtime.fault import (StragglerWatchdog, SupervisorConfig,
                                       TrainSupervisor)


def test_roundtrip_and_keep_last(tmp_path):
    cm = CheckpointManager(tmp_path, keep_last=2)
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.int32)}}
    for s in (10, 20, 30):
        cm.save(s, tree)
    assert cm.all_steps() == [20, 30]
    restored, step = cm.restore(tree)
    assert step == 30
    assert torch.equal(restored["a"], tree["a"])
    assert restored["b"]["c"].dtype == torch.int32


def test_resave_same_step_is_idempotent(tmp_path):
    cm = CheckpointManager(tmp_path, keep_last=3)
    cm.save(5, {"x": torch.zeros(3)})
    cm.save(5, {"x": torch.ones(3)})
    restored, _ = cm.restore({"x": torch.zeros(3)})
    assert torch.equal(restored["x"], torch.ones(3))


def _float_stream(start, value=None):
    def gen():
        i = start
        while True:
            yield torch.tensor(float(i) if value is None else value)
            i += 1
    return gen()


def test_supervisor_resumes_identically(tmp_path):
    def step_fn(state, batch):
        return {"w": state["w"] + batch * batch, "n": state["n"] + 1}

    def run(fault_at, d):
        sup = TrainSupervisor(step_fn, CheckpointManager(d, keep_last=3),
                              SupervisorConfig(ckpt_every=7))
        st, step = sup.run({"w": torch.tensor(0.0),
                            "n": torch.tensor(0, dtype=torch.int32)},
                           _float_stream, 40, fault_at=fault_at)
        return float(st["w"]), int(st["n"]), sup.restarts

    w0, n0, r0 = run(None, tmp_path / "a")
    w1, n1, r1 = run(23, tmp_path / "b")
    assert (w0, n0) == (w1, n1)
    assert (r0, r1) == (0, 1)


def test_supervisor_survives_repeated_faults(tmp_path):
    def step_fn(state, batch):
        return {"w": state["w"] + batch}

    sup = TrainSupervisor(step_fn, CheckpointManager(tmp_path),
                          SupervisorConfig(ckpt_every=5, max_restarts=5))
    st, step = sup.run({"w": torch.tensor(0.0)},
                       lambda s: _float_stream(s, 1.0), 30, fault_at=12)
    # resume + run to completion despite mid-run failure
    assert step == 30 and float(st["w"]) == 30.0


def test_straggler_watchdog():
    cfg = SupervisorConfig(straggler_factor=3.0, max_consecutive_stragglers=2)
    wd = StragglerWatchdog(cfg)
    for i in range(8):
        assert wd.observe(i, 0.1) == "ok"
    assert wd.observe(8, 0.5) == "straggler"
    assert wd.observe(9, 0.5) == "evict"      # second consecutive
    assert len(wd.events) == 2
    assert wd.observe(10, 0.1) == "ok"        # recovers


def test_restore_falls_back_past_torn_latest(tmp_path):
    cm = CheckpointManager(tmp_path, keep_last=3)
    tree = {"a": torch.arange(6.0), "b": torch.ones((2,), dtype=torch.int32)}
    cm.save(1, tree)
    cm.save(2, {k: v * 2 for k, v in tree.items()})
    # truncate the newest payload mid-file: torn zip central directory
    leaves = pathlib.Path(tmp_path) / "step_00000002" / "leaves.npz"
    raw = leaves.read_bytes()
    leaves.write_bytes(raw[: len(raw) // 2])

    with pytest.warns(RuntimeWarning, match="torn"):
        restored, step = cm.restore(tree)
    assert step == 1
    assert torch.equal(restored["a"], tree["a"])
    # trusting an explicit step surfaces the damage loudly
    with pytest.raises(Exception):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            cm.restore(tree, step=2)


def test_restore_raises_when_no_readable_checkpoint(tmp_path):
    cm = CheckpointManager(tmp_path, keep_last=3)
    cm.save(1, {"x": torch.zeros(2)})
    leaves = pathlib.Path(tmp_path) / "step_00000001" / "leaves.npz"
    leaves.write_bytes(b"\x00" * 8)
    with pytest.raises(FileNotFoundError, match="no readable"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            cm.restore({"x": torch.zeros(2)})


def _mixed_tree():
    g = torch.Generator().manual_seed(0)
    return {
        "params": {"w": torch.randn(4, 3, generator=g).to(torch.bfloat16),
                   "b": torch.randn(3, generator=g)},
        "opt": {"mu": {"w": torch.randn(4, 3, generator=g)},
                "step": torch.tensor(7, dtype=torch.int32)},
        "flags": torch.tensor([True, False]),
    }


def test_bf16_round_trip_and_async_save(tmp_path):
    cm = CheckpointManager(tmp_path, keep_last=2, async_save=True)
    tree = _mixed_tree()
    cm.save(3, tree)
    tree_before = {k: v for k, v in tree["params"].items()}
    cm.wait()
    restored, step = cm.restore(tree)
    assert step == 3
    assert restored["params"]["w"].dtype == torch.bfloat16
    for a, b in ((restored["params"]["w"], tree_before["w"]),
                 (restored["params"]["b"], tree["params"]["b"]),
                 (restored["opt"]["mu"]["w"], tree["opt"]["mu"]["w"]),
                 (restored["opt"]["step"], tree["opt"]["step"]),
                 (restored["flags"], tree["flags"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert list(restored) == list(tree)


def _ref_leaf(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view(
            ml_dtypes.bfloat16)
    return t.numpy()


def test_reference_reads_the_ports_checkpoint(tmp_path):
    tree = _mixed_tree()
    CheckpointManager(tmp_path).save(9, tree)
    ref = JCheckpointManager(tmp_path)
    got = ref._load_leaves(9)
    # jax flattens a dict in sorted key order, as the port writes it
    want = [tree["flags"], tree["opt"]["mu"]["w"], tree["opt"]["step"],
            tree["params"]["b"], tree["params"]["w"]]
    assert len(got) == len(want)
    for a, t in zip(got, want):
        b = _ref_leaf(t)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    template = {"flags": jnp.zeros(2, bool),
                "opt": {"mu": {"w": jnp.zeros((4, 3))},
                        "step": jnp.zeros((), jnp.int32)},
                "params": {"b": jnp.zeros(3),
                           "w": jnp.zeros((4, 3), jnp.bfloat16)}}
    restored, step = ref.restore(template)
    assert step == 9
    np.testing.assert_array_equal(
        np.asarray(restored["params"]["w"]).view(np.uint16),
        _ref_leaf(tree["params"]["w"]).view(np.uint16))


def test_port_reads_the_references_checkpoint(tmp_path):
    rng = np.random.default_rng(1)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    jtree = {"params": {"w": jnp.asarray(w).astype(jnp.bfloat16),
                        "b": jnp.asarray(w[0])},
             "step": jnp.asarray(5, jnp.int32)}
    JCheckpointManager(tmp_path).save(2, jtree)
    template = {"params": {"w": torch.zeros(4, 3, dtype=torch.bfloat16),
                           "b": torch.zeros(3)},
                "step": torch.tensor(0, dtype=torch.int32)}
    restored, step = CheckpointManager(tmp_path).restore(template)
    assert step == 2
    np.testing.assert_array_equal(
        restored["params"]["w"].view(torch.int16).numpy().view(np.uint16),
        np.asarray(jtree["params"]["w"]).view(np.uint16))
    np.testing.assert_array_equal(restored["params"]["b"].numpy(), w[0])
    assert int(restored["step"]) == 5
