"""Nothing of the benchmark imports JAX, Flax or the JAX package, and its
reference imports nothing of the program: checked on every module's
imports by whole top-level name (the port's name begins with the JAX
package's), and on ``sys.modules`` after a run."""
import ast
import os
import subprocess
import sys

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "multimodal_gar_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".")[0]


def _modules(sub=""):
    for dirpath, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_module_imports_jax_or_the_jax_package():
    found = {(p, m) for p in _modules() for m in _imports(p)
             if m in FORBIDDEN}
    assert not found


def test_the_reference_imports_nothing_of_the_program():
    found = {(p, m) for p in _modules("reference") for m in _imports(p)
             if m == "multimodal_gar_tpu_torch" or m in FORBIDDEN}
    assert not found


def test_no_forbidden_module_after_a_run():
    code = """
import sys
sys.path[:0] = ['h100_bench/tests', 'h100_bench', '.']
import conftest, run, harness
spec = conftest.tiny_spec('mgar-eval-b1', 3, pool=2)
result, checks = run.run_cell(spec, 0.5, False)
assert result is not None, checks
print(sorted({m.split('.')[0] for m in sys.modules}
             & {'jax', 'jaxlib', 'flax', 'multimodal_gar_tpu'}))
print('multimodal_gar_tpu_torch' in sys.modules)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[:2] == ["[]", "True"]


def test_a_run_with_jax_loaded_prints_no_result(monkeypatch):
    """The harness looks at ``sys.modules`` once the window has closed and
    gives no result where a forbidden top-level name is loaded."""
    import types

    import run
    from conftest import tiny_spec
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    result, message = run.run_cell(tiny_spec("mgar-eval-b1", 3, pool=2),
                                   0.5, False)
    assert result is None and "jax" in message
