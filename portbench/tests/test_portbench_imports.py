"""Nothing the benchmark loads is JAX, flax or the JAX package (compared by
whole top-level module name: the port's name begins with the JAX
package's), and the reference loads nothing of the port."""
import ast
import os
import subprocess
import sys

import pytest

import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "multimodalrouting_tpu"}
PB = os.path.join(tiny.REPO, "portbench")


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(PB, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_source_imports_jax():
    for path in sources():
        found = set(top_level_imports(path)) & FORBIDDEN
        assert not found, (path, found)


def test_reference_imports_nothing_of_the_port():
    for path in sources("reference"):
        found = {m for m in top_level_imports(path) if m.startswith("multimodalrouting_tpu")}
        assert not found, (path, found)


def run_python(code):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=tiny.REPO, env=env,
                          timeout=600)


def test_reference_loads_nothing_of_the_port():
    out = run_python("import sys; sys.path.insert(0, '.'); import portbench.reference.model, "
                     "portbench.reference.train, portbench.reference.serve; "
                     "print(sorted({m.split('.')[0] for m in sys.modules if m.startswith('multimodalrouting')}))")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("workload", ["pheno.train_finetune", "mort.ward_requests"])
def test_a_run_loads_no_jax(workload):
    code = ("import sys, torch; sys.path.insert(0, 'portbench/tests'); torch.set_num_threads(2); import tiny; "
            f"line = tiny.run_tiny({workload!r}, seconds=0.3); "
            "from portbench.run import forbidden_modules; print(forbidden_modules())")
    out = run_python(code)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    code = ("import sys, torch; torch.cuda.is_available = lambda: False; sys.path.insert(0, 'portbench'); "
            "sys.argv = ['run.py', '--workload', 'pheno.train_finetune', '--seed', '1', '--seconds', '1']; "
            "import runpy; runpy.run_path('portbench/run.py', run_name='__main__')")
    out = run_python(code)
    assert out.returncode != 0 and out.stdout.strip() == ""
