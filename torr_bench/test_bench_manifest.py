"""The manifest and the files it names: every cell's configuration and
traffic files and every metric's reader load by name, and the manifest
keeps to the benchmark's contract."""
import dataclasses
import json
import re
from pathlib import Path

import pytest

from tbench import manifest

ROOT = Path(__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def man():
    return manifest.load()


def test_manifest_keys_and_names(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["command"] == ["python3", "torr_bench/run.py"]
    assert man["paths"] == ["torr_bench"]
    assert 1 <= man["run_seconds"] <= 51
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in man[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    assert len(json.dumps(man)) < 64 * 1024


def test_metrics_keep_to_the_contract(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    cells = {w["name"] for w in man["workloads"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in man["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for c in m["workloads"]:
            assert c in cells
            assert c in e2e[m["moves"]].get("workloads", cells)
    for c in cells:
        reported = [m for m in manifest.metrics_of(man, c, "end_to_end")]
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert manifest.metrics_of(man, c, "per_layer")


def test_every_metric_reader_loads_by_name(man):
    for m in man["end_to_end"]:
        assert callable(manifest.reader("end_to_end", m["name"]))
    for m in man["per_layer"]:
        assert callable(manifest.reader("metrics", m["name"]))


@pytest.mark.parametrize("cell", ["edge-prefix-served", "edge-prefix-reuse"])
def test_cells_load_their_configuration_and_traffic(man, cell):
    w = manifest.cell(man, cell)
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    assert (ROOT / conf["file"]).is_file()
    assert w["config_file"]["name"] == w["config"]
    assert w["traffic_file"]["depth"] >= 1
    assert w["chips"] == w["config_file"]["deployment"]["cards"] == 1
    assert set(w["config_file"]["limits"]) == {
        "missing", "enc_margin", "mismatch", "score_err"}


def test_torr_edge_is_the_published_configuration(man):
    """The configuration file's sizes are ``torr_edge('RT-60')``'s, every
    one: nothing is cut (``reduced`` is empty)."""
    from repro_torch.configs.torr_edge import torr_edge

    ref = dataclasses.asdict(torr_edge("RT-60"))
    assert all(c["reduced"] == [] for c in man["configs"])
    for file in sorted({c["file"] for c in man["configs"]}):
        tc = json.loads((ROOT / file).read_text())["torr"]
        assert {k: tc[k] for k in ref} == ref
