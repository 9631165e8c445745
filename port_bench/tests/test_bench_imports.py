"""Nothing of the benchmark imports JAX or the JAX package, and the plain
references import nothing of the program. Top-level module names are
compared whole: the program's name begins with the JAX package's."""

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)
BLOCKER = r'''
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def __init__(self, names): self.names = names
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.names:
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block(set(sys.argv[1].split(","))))
sys.path[:0] = [sys.argv[2], sys.argv[3]]
from harness.spec import load_module
for i, path in enumerate(sys.argv[4:]):
    load_module(path, f"m{i}")
print("imported", len(sys.argv) - 4)
'''


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _import_all(blocked, paths):
    return subprocess.run([sys.executable, "-c", BLOCKER, ",".join(blocked), str(BENCH), str(BENCH.parent),
                           *map(str, paths)], capture_output=True, text=True, timeout=300)


def test_no_source_names_jax_or_the_jax_package():
    for path in SOURCES:
        assert not _top_level_imports(path) & {"jax", "jaxlib", "flax", "beta_recsys_tpu"}, path


def test_every_module_imports_with_jax_and_the_jax_package_blocked():
    proc = _import_all(["jax", "jaxlib", "flax", "beta_recsys_tpu"], SOURCES)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_the_references_and_the_arithmetic_import_nothing_of_the_program():
    paths = sorted((BENCH / "reference").glob("*.py")) + sorted((BENCH / "arith").glob("*.py"))
    for path in paths:
        assert "beta_recsys_tpu_torch" not in _top_level_imports(path), path
    proc = _import_all(["jax", "jaxlib", "flax", "beta_recsys_tpu", "beta_recsys_tpu_torch"], paths)
    assert proc.returncode == 0, proc.stderr[-3000:]
