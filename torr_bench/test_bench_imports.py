"""Nothing the benchmark runs imports JAX or the JAX package: checked on
the sources (every import's top-level name, compared whole) and on what a
process that loads the harness holds."""
import ast
import subprocess
import sys
from pathlib import Path

from tbench import harness

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_tops(path: Path) -> set:
    tree = ast.parse(path.read_text(), str(path))
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_source_under_the_benchmark_imports_jax_or_repro():
    files = [p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts]
    assert len(files) > 10
    for p in files:
        assert not imported_tops(p) & FORBIDDEN, p


def test_the_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "check.py", "inputs.py", "world.py",
                 "counts.py"):
        tops = imported_tops(HERE / "tbench" / name)
        assert "repro_torch" not in tops, name


def test_loaded_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "reprox", sys)
    monkeypatch.setitem(sys.modules, "jax_free.core", sys)
    assert not set(harness.loaded_forbidden()) & FORBIDDEN - {"repro"} \
        or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro" in harness.loaded_forbidden()
    code = ("import sys; sys.path[:0] = [%r, %r]; "
            "from tbench import harness, check, serving, trace; "
            "import repro_torch.serving.async_engine; "
            "print(harness.loaded_forbidden())"
            % (str(HERE), str(HERE.parent / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "[]"


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    r = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload", "edge-prefix-served",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert r.stdout.strip() == ""
