"""The port's colormaps (``utils/viz.py``): ``bone`` and ``rainbow`` are
built in numpy and equal matplotlib's ``LinearSegmentedColormap`` lookup
within 1e-6, ``magma`` equals matplotlib's resampled ``ListedColormap``
exactly (and all equal the JAX package's tables); they need no matplotlib,
and without it ``plasma`` raises instead of being replaced by another map."""

import os
import subprocess
import sys

import numpy as np
import pytest
from matplotlib import _cm
from matplotlib.colors import LinearSegmentedColormap

from sc_sfmlearner_release_tpu.utils import viz as jviz
from sc_sfmlearner_release_tpu_torch.utils import viz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 1024
TOL = 1e-6


def _mpl_lookup(cmap):
    return cmap(np.linspace(0, 1, N))[:, :3]


def test_bone_equals_matplotlib_segments():
    want = _mpl_lookup(LinearSegmentedColormap("bone", _cm.datad["bone"], N))
    assert np.abs(viz._bone() - want).max() <= TOL


def test_rainbow_equals_matplotlib_from_list():
    want = _mpl_lookup(LinearSegmentedColormap.from_list("opencv_rainbow", viz._RAINBOW, N))
    assert np.abs(viz._opencv_rainbow() - want).max() <= TOL


@pytest.mark.parametrize("name", ["bone", "rainbow", "magma", "plasma"])
def test_tables_equal_the_jax_package(name):
    np.testing.assert_array_equal(viz._get_cmap(name), jviz._get_cmap(name))


def test_tensor2array_and_depth_visualizer_equal_the_jax_package():
    rng = np.random.RandomState(0)
    disp = rng.rand(20, 30).astype(np.float32) + 0.1
    for kw in ({"max_value": None, "colormap": "bone"}, {"max_value": 10, "colormap": "rainbow"}):
        np.testing.assert_array_equal(viz.tensor2array(disp, **kw), jviz.tensor2array(disp, **kw))
    np.testing.assert_array_equal(viz.depth_visualizer(1 / disp, "magma"),
                                  jviz.depth_visualizer(1 / disp, "magma"))


def test_without_matplotlib_bone_and_rainbow_build_and_magma_raises(tmp_path):
    # magma too builds without matplotlib (eval_depth --vis_dir, as
    # test_nyu.sh runs it, on a machine without matplotlib); plasma raises.
    code = """
import sys
sys.modules["matplotlib"] = None
from sc_sfmlearner_release_tpu_torch.utils import viz
import numpy as np
bone, rainbow = viz._get_cmap("bone"), viz._get_cmap("rainbow")
magma = viz._get_cmap("magma")
assert bone.shape == rainbow.shape == magma.shape == (1024, 3)
assert viz.tensor2array(np.ones((4, 5)), colormap="bone").shape == (4, 5, 3)
assert viz.depth_visualizer(np.ones((4, 5)), "magma").shape == (4, 5, 3)
try:
    viz._get_cmap("plasma")
except ImportError as exc:
    assert "matplotlib" in str(exc), exc
    print("plasma raised")
np.save(sys.argv[1], np.stack([bone, rainbow, magma]))
"""
    out = str(tmp_path / "tables.npy")
    res = subprocess.run([sys.executable, "-c", code, out], capture_output=True, text=True,
                         cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "plasma raised" in res.stdout
    tables = np.load(out)
    np.testing.assert_array_equal(tables[0], viz._bone())
    np.testing.assert_array_equal(tables[1], viz._opencv_rainbow())
    np.testing.assert_array_equal(tables[2], jviz._get_cmap("magma"))
