"""The port's dry-run (``python -m repro_torch.launch.dryrun``) in a
subprocess: a fake process group of 8 ranks, a 2x4 ("data", "model")
mesh, the smoke-size cells of qwen3-14b (train) and xlstm-1.3b (prefill)
bound on ``meta`` and analyzed: every record holds the reference's fields
with positive roofline terms, a skipped cell falls where ``shape_for``
skips, and xlstm's loops sampled once count as the whole loops do.
"""
import json
import os
import subprocess
import sys

import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

CODE = """
import dataclasses, json, sys
from repro_torch.configs import registry
from repro_torch.launch import dryrun

registry.SHAPES["tiny_train"] = dict(seq_len=64, global_batch=8,
                                     mode="train")
registry.SHAPES["tiny_prefill"] = dict(seq_len=32, global_batch=8,
                                       mode="prefill")
recs = [dryrun.run_cell(a, s, (2, 4), ("data", "model"), out_dir=sys.argv[1],
                        cfg_override=registry.get_smoke(a))
        for a, s in (("qwen3-14b", "tiny_train"),
                     ("xlstm-1.3b", "tiny_prefill"),
                     ("qwen3-14b", "long_500k"))]
from repro_torch.runtime import steps
mesh = dryrun.mesh_for((2, 4), ("data", "model"))
lowered, _ = steps.lower_cell(registry.get_smoke("xlstm-1.3b"),
                              registry.SHAPES["tiny_prefill"], mesh)
loops = {}
for s in (True, False):
    an = lowered.analyze(sample_loops=s)
    loops[str(s)] = [an.flops, an.bytes_traffic]
print(json.dumps([recs, loops]))
"""

FIELDS = ("cell", "status", "mode", "lower_s", "analyze_s", "params",
          "active_params", "arch", "shape", "mesh", "chips", "flops_global",
          "bytes_global", "coll_bytes_global", "coll_breakdown",
          "model_flops", "memory_per_device", "t_compute", "t_memory",
          "t_collective", "bottleneck", "useful_flops_frac", "roofline_frac")


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", CODE, str(out)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    recs, loops = json.loads(p.stdout.strip().splitlines()[-1])
    files = sorted(f.name for f in out.iterdir())
    return recs, files, loops


def test_cells_are_ok_with_the_reference_fields(records):
    recs, files, _ = records
    for rec in recs[:2]:
        assert rec["status"] == "OK", rec.get("error")
        assert set(FIELDS) <= set(rec), set(FIELDS) - set(rec)
        assert rec["chips"] == 8 and rec["mesh"] == "pod2x4"
        for k in ("t_compute", "t_memory", "t_collective"):
            assert rec[k] > 0, (rec["cell"], k)
        assert rec["flops_global"] >= rec["model_flops"] * 0.5
        mem = rec["memory_per_device"]
        assert mem["argument_bytes"] > 0
        assert mem["peak_bytes"] >= mem["argument_bytes"]
    assert len(files) == 3


def test_long_context_cell_skips_a_full_attention_arch(records):
    recs, _, _ = records
    assert recs[2]["status"] == "SKIP"
    assert recs[0]["mode"] == "train" and recs[1]["mode"] == "prefill"


def test_sampled_loops_count_as_the_whole_loop(records):
    # xlstm's prefill runs its sLSTM one token a step and its mLSTM a
    # chunk a step: sampled once and scaled, the cell counts the FLOPs of
    # every step, and the bytes to within the repeated outputs' stack
    _, _, loops = records
    (f_s, b_s), (f_u, b_u) = loops["True"], loops["False"]
    assert f_s == f_u > 0
    assert b_s == pytest.approx(b_u, rel=0.02)
