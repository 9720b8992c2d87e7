"""The port's launcher (``repro_torch.launch.serve``) on the CPU.

``run_torr_streams(device="cpu")`` at a few streams and frames, through the
async runtime with RT-60 admission control and the governor, and through
the sync engine: every submitted window is accounted for as served or
shed, and the three artifacts (metrics JSON, flight JSONL, Chrome trace)
parse and agree with the run. The fixtures come from the port's own
``build_system``, so these tests hold invariants; bit-equality with
``repro`` is held at the engine level (``tests/test_torch_async_engine.py``).
"""
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from repro_torch import obs
from repro_torch.launch import serve

SRC = str(Path(__file__).resolve().parents[1] / "src")


@pytest.mark.parametrize("n_streams,n_slots", [(3, 0), (4, 2)])
def test_async_governed_run_accounts_for_every_window(tmp_path, n_streams,
                                                      n_slots):
    m_json, f_jsonl, t_json = (tmp_path / "m.json", tmp_path / "f.jsonl",
                               tmp_path / "t.json")
    frames = 3
    res = serve.run_torr_streams(
        n_streams, frames, n_slots, use_async=True, rt="RT-60",
        governor=True, metrics_json=str(m_json), flight_jsonl=str(f_jsonl),
        trace_json=str(t_json), device="cpu")
    assert res["submitted"] == n_streams * frames
    assert res["served"] + res["shed"] == res["submitted"]
    assert res["lost"] == 0 and not res["interrupted"]
    summ = res["summary"]
    assert summ["windows"] == res["served"] and summ["shed"] == res["shed"]
    # the plain versions run on the CPU: no kernel launch, after the
    # warm-up as before it
    assert res["steps"] == summ["steps"]
    assert set(res["launches"]) >= {"sign_project_pack",
                                    "bank_prefix_hamming"}
    assert not any(res["launches"].values())
    assert summ["telemetry_dropped"] == 0
    # metrics JSON: the registry's snapshot, windows and sheds as counted
    snap = json.loads(m_json.read_text())
    assert snap["format"] == "torr-metrics-snapshot-v1"
    metrics = snap["metrics"]
    assert metrics["torr_windows_total"]["series"][0]["value"] == \
        res["served"]
    assert metrics["torr_windows_shed_total"]["series"][0]["value"] == \
        res["shed"]
    # flight JSONL: one record per step (plus SLO events), the governor's
    # plan timeline
    recs = obs.load_jsonl(str(f_jsonl))
    steps = [r for r in recs if "n_windows" in r]
    assert len(steps) == summ["steps"]
    assert sum(r["n_windows"] for r in steps) == res["served"]
    assert [(r["plan"]["banks"], r["plan"]["planes"],
             r["governor"]["level"]) for r in steps] == \
        [p for p in obs.plan_timeline(recs) if p[2] is not None]
    # Chrome trace: every window minted, served ones on both threads
    doc = json.loads(t_json.read_text())
    assert doc["otherData"]["producer"] == "repro_torch.obs.trace_export"
    assert res["tracer"].minted == res["submitted"]
    assert len(res["tracer"].completed()) == res["submitted"]
    traced = [w for r in steps for w in r["trace"]]
    assert len(traced) == res["served"]
    finishes = [e for e in doc["traceEvents"] if e["ph"] == "f"]
    assert len(finishes) == res["served"]


def test_sync_run_serves_every_window_with_metrics_endpoint(capsys):
    res = serve.run_torr_streams(2, 3, metrics_port=0, device="cpu")
    assert res["served"] == res["submitted"] == 6
    assert res["shed"] == res["lost"] == 0
    assert res["summary"]["windows"] == 6
    text = res["metrics_text"]
    assert "torr_windows_total 6" in text
    assert "# TYPE torr_path_total counter" in text
    out = capsys.readouterr().out
    assert "mode=sync" in out and "metrics endpoint http://127.0.0.1:" in out


def test_launcher_rejects_more_than_one_card(monkeypatch, capsys):
    """``--mesh N`` above the card count is refused (here one card is
    pretended present; the CLI exits before touching it)."""
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 2 devices, only 1"):
        serve.stream_mesh_for(2, torch.device("cuda"))
    with pytest.raises(SystemExit):
        serve.main(["--torr-streams", "2", "--mesh", "2"])
    assert "requested 2 devices, only 1 present" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        serve.main(["--torr-streams", "2", "--mesh", "-2", "--device",
                    "cpu"])
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu"])     # no --torr-streams


def test_cli_sigterm_flushes_artifacts(tmp_path):
    """SIGTERM mid-serve exits 0 and still writes every artifact."""
    m_json, f_jsonl, t_json = (tmp_path / "m.json", tmp_path / "f.jsonl",
                               tmp_path / "t.json")
    env = dict(os.environ, PYTHONPATH=SRC)
    # enough frames that the run cannot finish before the signal
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "repro_torch.launch.serve",
         "--device", "cpu", "--torr-streams", "2", "--torr-frames", "2000",
         "--async", "--governor", "--metrics-json", str(m_json),
         "--flight-jsonl", str(f_jsonl), "--trace-json", str(t_json)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        for line in proc.stdout:
            if "SIGINT/SIGTERM flushes artifacts" in line:
                break
        time.sleep(1.0)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode == 0, out[-3000:]
    assert "interrupted" in out
    assert json.loads(m_json.read_text())["metrics"]
    obs.load_jsonl(str(f_jsonl))
    assert "traceEvents" in json.loads(t_json.read_text())
