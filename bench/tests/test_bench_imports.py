"""No run loads JAX or the JAX package (``repro``), by whole top-level
names: ``repro_torch`` is the port and allowed."""
import ast
import subprocess
import sys
import types
from pathlib import Path

from bench import harness

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.partition(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        bad = _top_level_imports(path) & set(harness.FORBIDDEN)
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_references_import_nothing_of_the_port():
    for path in (BENCH / "reference").glob("*.py"):
        assert not {n for n in _top_level_imports(path)
                    if n.startswith("repro")}, path.name


def test_forbidden_modules_compares_whole_names():
    saved = dict(sys.modules)
    try:
        sys.modules.pop("repro", None)
        sys.modules["repro_torch_probe"] = sys
        assert "repro" not in harness.forbidden_modules()
        sys.modules["repro.core"] = sys
        assert "repro" in harness.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


RUN = """
import sys, torch
sys.path[:0] = [{src!r}, {root!r}, {tests!r}]
torch.set_num_threads(2)
from bench import harness
from fixtures import CELLS, tiny_cell
from hostcard import HostCard
for name in CELLS:
    res = harness.run_cell(tiny_cell(name), 5, 0.01, True, HostCard(torch))
    assert res["correct"], res
print(sorted({{m.partition('.')[0] for m in sys.modules}}))
"""


def test_a_run_loads_neither_jax_nor_repro():
    code = RUN.format(src=str(ROOT / "src"), root=str(ROOT),
                      tests=str(BENCH / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN), loaded & set(harness.FORBIDDEN)


class _JudgeLoadsJax:
    """A cell's adapter whose judging loads ``jax``, after the window."""

    def __init__(self, adapter):
        self._adapter = adapter

    def __getattr__(self, name):
        return getattr(self._adapter, name)

    def check(self, *args, **kwargs):
        sys.modules["jax"] = types.ModuleType("jax")
        return self._adapter.check(*args, **kwargs)


def test_jax_loaded_after_the_window_gives_no_result(monkeypatch, capsys):
    from bench import card
    from fixtures import tiny_cell
    from hostcard import HostCard
    cell = tiny_cell("pagerank-zipf.chromatic")
    cell.adapter = _JudgeLoadsJax(cell.adapter)
    run = harness.load_module(BENCH / "run.py")
    monkeypatch.setattr(harness, "load_cell", lambda name: cell)
    monkeypatch.setattr(card, "CudaCard", lambda torch_, chips: HostCard(
        torch_))
    had = sys.modules.pop("jax", None)
    try:
        rc = run.main(["--workload", "any", "--seed", "5", "--seconds",
                       "0.01", "--trace", "0"])
    finally:
        sys.modules.pop("jax", None)
        if had is not None:
            sys.modules["jax"] = had
    out = capsys.readouterr()
    assert rc == 3 and out.out == ""
    assert "jax" in out.err
