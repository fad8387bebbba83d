"""Nothing the harness runs imports JAX, flax or the JAX package, compared by
whole top-level names (``repro_torch`` starts with ``repro`` and is not
it); the reference imports nothing of the program; nothing reads the JAX
package's benchmark folder."""
import ast

from perfbench import harness
from perfbench.tests.conftest import ROOT

PB = ROOT / "perfbench"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(PB.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in harness.FORBIDDEN, (f, name)


def test_reference_imports_nothing_of_the_program():
    for f in sorted((PB / "reference").glob("*.py")):
        for name in _imports(f):
            assert name.split(".")[0] not in ("repro_torch", "perfbench"), (f, name)


def test_nothing_reads_the_jax_benchmarks():
    for f in sorted(PB.rglob("*.py")):
        if f.parent.name != "tests":
            assert "benchmarks/" not in f.read_text(), f


def test_forbidden_modules_compares_whole_names():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.models", "jaxtyping"]) == []
    assert harness.forbidden_modules(["repro.core.vbr", "jax", "flax.linen"]) == [
        "flax", "jax", "repro"]
