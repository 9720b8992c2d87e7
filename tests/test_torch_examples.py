"""The port's examples (``python -m repro_torch.examples.<name>``) run end
to end on the CPU at small arguments, each keeping its reference's own
check (the bridge's convergence, the RT-60 deadline); without a card and
without ``--device cpu`` they raise rather than fall back."""
import pytest
import torch

from repro_torch.core.types import PATH_BYPASS, PATH_FULL
from repro_torch.examples import quickstart, serve_events, train_bridge


def test_train_bridge_converges_on_the_cpu(capsys):
    res = train_bridge.main(["--device", "cpu", "--steps", "40",
                             "--classes", "4"])
    assert res["last"] > res["first"] + 0.2
    assert len(res["accs"]) == 40 and res["s_per_step"] > 0
    assert "bridge converged" in capsys.readouterr().out


def test_quickstart_switches_paths_as_the_scene_changes(capsys):
    telems = quickstart.main(["--device", "cpu"])
    paths = [t.path[:4].tolist() for t in telems]
    assert paths[0] == [PATH_FULL] * 4              # cold cache
    assert paths[4] == paths[5] == [PATH_BYPASS] * 4   # load spike
    assert paths[8] == [PATH_FULL] * 4              # scene cut
    assert "scene cut" in capsys.readouterr().out


def test_serve_events_meets_rt60_on_a_short_stream(capsys):
    res = serve_events.main(["--device", "cpu", "--frames", "6"])
    assert res["p95_ms"] < 1e3 / 60
    assert 0.0 <= res["ap50"] <= 1.0
    assert abs(sum(res["path_mix"].values()) - 1.0) < 1e-9
    assert "RT-60 deadline met" in capsys.readouterr().out


@pytest.mark.parametrize("example", [train_bridge, quickstart, serve_events])
def test_examples_default_to_the_card(example):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main([])
