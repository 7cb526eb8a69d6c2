"""No module under bench/ imports JAX or the JAX package (top-level
names compared whole: the port's name, repro_torch, begins with the JAX
package's), and the plain reference imports nothing of the port."""
import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(BENCH)
               for f in fs if f.endswith(".py"))


def _imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_or_jax_package(path):
    assert not _imports(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    ref = [p for p in FILES if os.sep + "reference" + os.sep in p]
    assert ref
    for p in ref:
        assert not _imports(p) & {"repro_torch", "torch"}, p
        assert _imports(p) <= {"__future__", "dataclasses", "math", "zlib",
                               "numpy"}, p


def test_the_guard_catches_a_whole_name(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import repro.sim\nfrom repro_torch import obs\n")
    assert _imports(str(p)) & FORBIDDEN == {"repro"}
    p.write_text("import repro_torch.sim\n")
    assert not _imports(str(p)) & FORBIDDEN
