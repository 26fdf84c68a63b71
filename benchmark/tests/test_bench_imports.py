"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port. Names are compared by their top-level
part (before the first dot), whole: the port's name begins with the JAX
package's."""

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

from benchmark import spec

JAX_SIDE = {"jax", "jaxlib", "flax", "sc_sfmlearner_release_tpu"}
PORT = "sc_sfmlearner_release_tpu_torch"
HERE = os.path.join(spec.ROOT, "benchmark")
# The reference's side: the shared files it runs and each family's
# reference, FLOP count and kernel bytes. Their imports from the benchmark
# stay among these modules.
SHARED_REFERENCE = ("follow", "weights", "dataset", "check", "flops", "yardstick", "spec")
FAMILY_REFERENCE = ("reference", "flops", "kernels")
REFERENCE_FILES = [os.path.join(HERE, f"{m}.py") for m in SHARED_REFERENCE] + sorted(
    os.path.join(d, f"{m}.py") for d in glob.glob(os.path.join(HERE, "families", "*"))
    for m in FAMILY_REFERENCE)
FILES = sorted(glob.glob(os.path.join(HERE, "*.py")) + glob.glob(os.path.join(HERE, "metrics", "*.py"))
               + glob.glob(os.path.join(HERE, "families", "*", "*.py")))


def _imports(path):
    tree = ast.parse(open(path).read())
    names, local = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                local |= {node.module.split(".")[0]} if node.module else \
                    {a.name for a in node.names}
            else:
                names.add(node.module.split(".")[0])
                if node.module == "benchmark":
                    local |= {a.name for a in node.names}
                elif node.module.startswith("benchmark."):
                    local.add(node.module.split(".")[1])
    return names, local


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, HERE))
def test_no_file_imports_jax(path):
    names, _ = _imports(path)
    assert not names & JAX_SIDE


@pytest.mark.parametrize("path", REFERENCE_FILES, ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_port(path):
    names, local = _imports(path)
    allowed = set(SHARED_REFERENCE) | set(FAMILY_REFERENCE)
    assert PORT not in names and not names & JAX_SIDE
    assert local <= allowed, local - allowed


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=600, env=dict(os.environ, PYTHONPATH=spec.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


PRELUDE = """
import json, sys, tempfile, torch
from benchmark.tests import tiny
pool = tiny.tiny_pool(tempfile.mkdtemp())
cell = tiny.tiny_cell("r18_kitti.packed", pool)
"""


def test_a_run_loads_no_jax():
    loaded = _loaded(PRELUDE + """
from benchmark import run
out = run.measure(cell, 5, 0.3, True, torch.device("cpu"))
assert out["correct"], out
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
""")
    assert not loaded & JAX_SIDE
    assert PORT in loaded


def test_the_reference_loads_nothing_of_the_port():
    loaded = _loaded(PRELUDE + """
from benchmark import follow
follow.follow(cell.config, cell.traffic, 5, 3, torch.device("cpu"))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
""")
    assert not loaded & (JAX_SIDE | {PORT})
