"""The port's C++ graph library (native.py, csrc/graph_ops.cpp) on the CPU.

- it builds, also when two processes build a fresh copy at once;
- proximity_select, dedup_edges and bucket_tables equal the port's numpy
  plain versions on seeded inputs without ties (stereo and mono, with and
  without existing edges and max_factors);
- on tied distances (all-zero matrices, and matrices quantised to 5
  values) the port's proximity_select equals the JAX package's C++ path,
  edge for edge and in order, where the numpy version keeps other edges;
- FactorGraph.add_proximity_factors goes through the library, and on a still
  camera (every distance 0) selects the JAX package's C++ edges.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu import native as jnative
from droid_slam_reserch_tpu_torch import native
from droid_slam_reserch_tpu_torch.engine.factor_graph import FactorGraph
from droid_slam_reserch_tpu_torch.engine.video import Video
from droid_slam_reserch_tpu_torch.utils import DroidConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NONE = np.zeros(0, np.int32)


def _edges(sel):
    return list(zip(sel[0].tolist(), sel[1].tolist()))


def test_library_builds():
    assert native.have_native()
    assert os.path.exists(native.LIB_PATH)
    assert native.LIB_PATH.startswith(os.path.join(ROOT, "build", "torch_host"))


def test_two_processes_build_at_once(tmp_path):
    """Two processes build into one empty directory together: both load a
    whole library and select edges with it."""
    script = (
        "import sys, numpy as np\n"
        "from droid_slam_reserch_tpu_torch import native\n"
        f"native.BUILD_DIR = {str(tmp_path)!r}\n"
        f"native.LIB_PATH = {str(tmp_path / 'libgraphops.so')!r}\n"
        "d = np.random.RandomState(0).rand(12, 12) * 20\n"
        "ii, jj = native.proximity_select(d, 0, 0, 12, 2, 2, 16.0, 0, np.zeros(0, np.int32),"
        " np.zeros(0, np.int32), False)\n"
        "print(len(ii))\n")
    procs = [subprocess.Popen([sys.executable, "-c", script], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert outs[0][0] == outs[1][0] and int(outs[0][0]) > 0
    assert os.listdir(tmp_path) == ["libgraphops.so"]


def test_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "graph_ops.cpp"
    bad.write_text("int broken(\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(native, "LIB_PATH", str(tmp_path / "out" / "libgraphops.so"))
    with pytest.raises(RuntimeError, match="building the graph library failed"):
        native.build()
    assert os.listdir(tmp_path / "out") == []


@pytest.mark.parametrize("stereo", [False, True], ids=["mono", "stereo"])
@pytest.mark.parametrize("existing", [False, True], ids=["fresh", "existing"])
@pytest.mark.parametrize("max_factors", [0, 48, 200])
def test_proximity_select_matches_plain(stereo, existing, max_factors):
    rng = np.random.RandomState(10 + max_factors + 2 * existing + stereo)
    for n in (8, 25, 60):
        for t0, t1 in ((0, 0), (n - 5, max(n - 25, 0))):
            d = 30.0 * rng.rand(n - t0, n - t1)
            k = rng.randint(0, 12) if existing else 0
            ex_i = rng.randint(0, n, k).astype(np.int32)
            ex_j = rng.randint(0, n, k).astype(np.int32)
            args = (t0, t1, n, 2, 2, 16.0, max_factors, ex_i, ex_j, stereo)
            lib = native.proximity_select(d, *args)
            plain = native.proximity_select_plain(d, *args)
            assert _edges(lib) == _edges(plain)


def test_dedup_and_bucket_tables_match_plain():
    rng = np.random.RandomState(3)
    for n, m in ((50, 30), (200, 0), (0, 10)):
        ii, jj = rng.randint(0, 12, n), rng.randint(0, 12, n)
        ex_i, ex_j = rng.randint(0, 12, m), rng.randint(0, 12, m)
        np.testing.assert_array_equal(native.dedup_edges(ii, jj, ex_i, ex_j),
                                      native.dedup_edges_plain(ii, jj, ex_i, ex_j))
    for n, M in ((100, 16), (7, 40), (300, 8)):
        ii = rng.randint(-1, M + 1, n)
        for round_to in (1, 4):
            for a, b in zip(native.bucket_tables(ii, M, round_to),
                            native.bucket_tables_plain(ii, M, round_to)):
                np.testing.assert_array_equal(a, b)


def _tied(kind, rng, n):
    if kind == "zero":
        return np.zeros((n, n))
    return rng.randint(0, 5, (n, n)) * 4.0


@pytest.mark.parametrize("kind", ["zero", "quantised"])
def test_tied_distances_match_jax_cpp(kind):
    """Edge for edge and in order, the JAX package's C++ path (its default
    host path) over 200 seeded cases of 8-60 frames each."""
    assert jnative.have_native(), "the JAX package's C++ graph library did not build"
    rng = np.random.RandomState(0 if kind == "zero" else 1)
    differs_from_plain = 0
    for case in range(200):
        n = rng.randint(8, 61)
        d = _tied(kind, rng, n)
        max_factors = (0, 48, 200)[case % 3]
        args = (0, 0, n, 2, 2, 16.0, max_factors, NONE, NONE, False)
        port = native.proximity_select(d, *args)
        ref = jnative.proximity_select(d.copy(), *args)
        assert _edges(port) == _edges(ref), f"case {case}: {n} frames, max_factors {max_factors}"
        differs_from_plain += _edges(native.proximity_select_plain(d, *args)) != _edges(ref)
    assert differs_from_plain > 0        # the ties do reorder numpy's selection


def test_factor_graph_selects_through_the_library():
    """A still camera: every frame distance is 0.  The graph's proximity
    edges are the JAX package's C++ selection on the same matrix."""
    cfg = DroidConfig(image_size=(32, 48), buffer=32)
    video = Video(cfg, device="cpu")
    video.counter = 24
    video.intrinsics[:] = torch.tensor([40.0, 40.0, 24.0, 16.0])
    graph = FactorGraph(video, None, None, max_factors=48)
    native.reset_counts()
    graph.add_proximity_factors(t0=0, t1=0, rad=2, nms=2, thresh=16.0)
    c = native.counts()
    assert c["proximity_select"] == (1, 0) and c["dedup_edges"][0] >= 1
    assert c["dedup_edges"][1] == 0 and c["bucket_tables"][1] == 0
    d = video.distance_matrix(0, 0, 24, beta=0.25)
    assert np.all(d == 0)
    ref = jnative.proximity_select(d.copy(), 0, 0, 24, 2, 2, 16.0, 48, NONE, NONE, False)
    assert list(zip(graph.ii.tolist(), graph.jj.tolist())) == _edges(ref)
