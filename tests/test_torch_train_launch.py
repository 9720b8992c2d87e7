"""The port's training launcher (``python -m repro_torch.launch.train``) on the
CPU: the reference's "loss improved" criterion at gemma-7b's smoke config
(``tests/test_system.py::test_training_loop_learns``'s command, whose
reference launcher fails: ROADMAP Queue 3), a run with a fault injected at
step 23 ending in a state bit-equal to the clean run's (the final
checkpoints compared leaf for leaf), ``--resume``, and the entry points'
refusal to fall back to the CPU without being asked."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_smoke
from repro_torch.data.tokens import TokenStream
from repro_torch.launch import train
from repro_torch.optim import adamw
from repro_torch.runtime import steps

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--arch", "gemma-7b", "--smoke", "--steps", "40", "--batch", "8",
        "--seq", "64", "--device", "cpu", "--ckpt-every", "10"]


def _train(*extra):
    # one thread a run: the steps are small, and tests run side by side
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *ARGS, *extra], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


def _final(path):
    cm = CheckpointManager(path)
    step = cm.latest_step()
    return step, cm._load_leaves(step)


def test_loss_improves_and_a_fault_changes_nothing(tmp_path):
    clean = _train("--ckpt", str(tmp_path / "clean"))
    assert "[train] arch=gemma-7b steps=40 restarts=0" in clean
    assert "loss improved" in clean
    faulty = _train("--ckpt", str(tmp_path / "fault"), "--fault-at", "23")
    assert "steps=40 restarts=1" in faulty
    (s0, a), (s1, b) = _final(tmp_path / "clean"), _final(tmp_path / "fault")
    assert s0 == s1 == 40 and len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_resume(tmp_path):
    out = _train("--ckpt", str(tmp_path), "--steps", "20")
    assert "steps=20" in out
    out = _train("--ckpt", str(tmp_path), "--resume")
    assert "[train] resumed from step 20" in out
    assert "steps=40 restarts=0" in out


def test_entry_points_need_the_card_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    cfg = get_smoke("gemma-7b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        steps.make_train_step(cfg, adamw.OptimConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(ARGS[:-4])
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
        train.main(ARGS + ["--data-axis", "2"])
    state = steps.init_train_state(cfg, device="cpu")
    step = steps.make_train_step(cfg, adamw.OptimConfig(), device="cpu")
    _, opt, metrics = step(state["params"], state["opt"],
                           TokenStream(cfg, 2, 16).batch_at(0))
    assert opt["step"].device.type == "cpu" and int(opt["step"]) == 1
    assert np.isfinite(float(metrics["loss"]))


def test_a_rank_takes_its_card_before_its_nccl_group(monkeypatch):
    """Under NCCL a rank binds its communicators (and a barrier) to its
    current card, so ``_mesh`` sets the card of ``LOCAL_RANK`` first and
    names it to ``init_process_group``."""
    import torch.distributed as dist

    calls = []
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.append(("set_device", str(d))))
    monkeypatch.setattr(dist, "init_process_group", lambda backend, **kw: (
        calls.append(("init_process_group", backend,
                      str(kw.get("device_id"))))))
    monkeypatch.setattr(train, "make_host_mesh",
                        lambda data, model, device: (data, model, device))
    mesh = train._mesh(2, 2, torch.device("cuda"))
    assert mesh == (2, 2, "cuda")
    assert calls == [("set_device", "cuda:1"),
                     ("init_process_group", "nccl", "cuda:1")], calls
