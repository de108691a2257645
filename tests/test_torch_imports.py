"""The port stands alone: no module of ``src/repro_torch``, not
``chip_smoke.py`` and no ``examples/*_torch.py`` imports JAX or the
reference package, so all run on a GPU host that has neither.  Checked
by parsing, not importing."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("*_torch.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported(tree):
    """Top-level package names of every import in a module, including
    imports inside functions."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and isinstance(node.func,
                                                        ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_neither_jax_nor_the_reference(path):
    bad = [(line, name) for line, name in
           _imported(ast.parse(path.read_text(), str(path)))
           if name in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_guard_sees_every_import_form():
    src = ("import jax.numpy as jnp\nfrom repro.core import exec\n"
           "def f():\n    import repro\n    from jax import lax\n"
           "importlib.import_module('repro.apps')\nfrom . import x\n"
           "import repro_torch\n")
    names = [n for _, n in sorted(_imported(ast.parse(src)))]
    assert names == ["jax", "repro", "repro", "jax", "repro", "repro_torch"]


def test_every_subpackage_is_scanned():
    """The guard reads every subpackage of the port, ``profile/``
    included, and the calibration CLI."""
    pkg = ROOT / "src" / "repro_torch"
    scanned = {p.relative_to(pkg).parts[0] for p in FILES
               if p.is_relative_to(pkg) and len(p.relative_to(pkg).parts) > 1}
    subpackages = {p.name for p in pkg.iterdir()
                   if p.is_dir() and (p / "__init__.py").exists()}
    assert "profile" in subpackages and subpackages <= scanned
    assert pkg / "profile" / "calibrate.py" in FILES


def test_the_distributed_modules_are_scanned():
    """The distributed engines' modules (mesh, partition, plan and
    engines, MPI-style ALS) stand alone too."""
    pkg = ROOT / "src" / "repro_torch"
    for rel in ("core/mesh.py", "core/partition.py", "core/distributed.py",
                "core/engine_locking.py", "baselines/mpi_als.py"):
        assert pkg / rel in FILES, rel


def test_the_training_modules_are_scanned():
    """The training path (forward and loss, batches, AdamW, the step,
    the trainer, its launcher and example) stands alone too."""
    pkg = ROOT / "src" / "repro_torch"
    for rel in ("models/model.py", "data/pipeline.py", "optim/adamw.py",
                "train/steps.py", "train/trainer.py", "launch/train.py",
                "interop.py"):
        assert pkg / rel in FILES, rel
    assert ROOT / "examples" / "train_lm_torch.py" in FILES


def test_the_tooling_modules_are_scanned():
    """The dry run and its parts (meshes, sharding rules, the op walker,
    the roofline, reanalysis) and the graph dry run stand alone too."""
    pkg = ROOT / "src" / "repro_torch"
    for rel in ("launch/mesh.py", "launch/shardctx.py", "launch/sharding.py",
                "launch/dryrun.py", "launch/graph_dryrun.py",
                "roofline/op_walk.py", "roofline/analysis.py",
                "roofline/reanalyze.py", "data/pipeline.py"):
        assert pkg / rel in FILES, rel


def test_the_spmd_modules_are_scanned():
    """The partitioned dry run's modules (the torch mesh, the hand-written
    sharding rules, the sharded B4) stand alone too; the one import from
    ``torch.testing._internal`` (the fake process group) sits in
    ``launch/mesh.py``'s ``torch_mesh`` and nowhere else; and the gloo
    ranks' job module imports no JAX."""
    pkg = ROOT / "src" / "repro_torch"
    for rel in ("launch/mesh.py", "launch/local_rules.py",
                "launch/shardctx.py", "kernels/window_attention_spmd.py"):
        assert pkg / rel in FILES, rel
    internal = []
    for path in FILES:
        tree = ast.parse(path.read_text(), str(path))
        spans = [(f.name, f.lineno, f.end_lineno) for f in ast.walk(tree)
                 if isinstance(f, ast.FunctionDef)]
        for node in ast.walk(tree):
            if (isinstance(node, ast.ImportFrom) and node.module
                    and node.module.startswith("torch.testing")):
                inside = [n for n, a, b in spans if a <= node.lineno <= b]
                internal.append((path.relative_to(ROOT).as_posix(),
                                 tuple(inside)))
    assert internal == [("src/repro_torch/launch/mesh.py", ("torch_mesh",))]
    jobs = ROOT / "tests" / "torch_spmd_jobs.py"
    assert not [n for _, n in _imported(ast.parse(jobs.read_text()))
                if n in FORBIDDEN]
