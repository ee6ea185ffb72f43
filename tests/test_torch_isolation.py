"""The port stands alone: no file of src/repro_torch/ and not
chip_smoke.py imports `jax` or the JAX package `repro`."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]
BANNED = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


def test_port_files_exist():
    assert len(PORT_FILES) > 20
    assert all(p.exists() for p in PORT_FILES)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = sorted(set(_imported_roots(path)) & set(BANNED))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_dry_run_and_counter_are_scanned():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"src/repro_torch/launch/dryrun.py", "src/repro_torch/roofline/op_count.py",
            "src/repro_torch/roofline/__init__.py"} <= names


def test_twins_of_examples_and_tools_are_scanned():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {f"src/repro_torch/examples/{n}.py" for n in
            ("__init__", "quickstart", "serve_paged", "train_tiny_lm", "elastic_restart")} <= names
    assert {"src/repro_torch/tools/__init__.py", "src/repro_torch/tools/obsdump.py",
            "src/repro_torch/launch/ranks.py"} <= names


def test_port_dynamic_imports_stay_in_port():
    """registry.get_config builds module names at run time: they must
    name the port's configs package."""
    src = (ROOT / "src" / "repro_torch" / "configs" / "registry.py").read_text()
    assert 'import_module(f"repro_torch.configs.' in src
