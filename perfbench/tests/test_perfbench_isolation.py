"""No module under perfbench/ imports JAX or the JAX package (`repro`),
and the plain references import nothing of the port (`repro_torch`):
top-level module names compared whole."""
import ast
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def _modules(sub=""):
    return sorted((HERE / sub).rglob("*.py"))


def test_nothing_imports_jax_or_the_jax_package():
    bad = {str(p.relative_to(HERE)): top for p in _modules()
           for top in _imports(p) if top in ("jax", "jaxlib", "flax",
                                             "repro")}
    assert bad == {}


def test_the_references_import_nothing_of_the_port():
    refs = _modules("reference")
    assert len(refs) >= 3
    bad = {str(p.relative_to(HERE)): top for p in refs
           for top in _imports(p) if top == "repro_torch"}
    assert bad == {}


def test_the_scan_sees_a_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nfrom jax import numpy\nimport repro.models\n"
                 "import repro_torch\n")
    assert list(_imports(f)) == ["os", "jax", "repro", "repro_torch"]
