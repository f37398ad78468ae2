"""The port and chip_smoke.py never import JAX, Flax or the JAX package,
nor OpenCV or PIL (the card's machine has neither), and name no path of the
JAX package's tree: walk the AST of every module (imports inside functions
included)."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "droid_slam_reserch_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "droid_slam_reserch_tpu")
ABSENT_ON_THE_CARD = ("cv2", "PIL")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_cv2_or_pil_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in ABSENT_ON_THE_CARD]
    assert not bad, f"{path.name} imports {bad}"


def test_walk_sees_the_whole_port():
    names = {p.name for p in FILES}
    assert {"chip_smoke.py", "cuda_corr.py", "cuda_ba.py", "factor_graph.py",
            "profile_frontend.py", "cli.py", "imageio.py", "alignment.py",
            "group_sequence.py", "pipeline.py", "live.py", "pointcloud.py", "sim3.py",
            "losses.py", "chol.py", "dense.py", "system.py", "step.py", "checkpoint.py",
            "logger.py", "rgbd_utils.py", "augmentation.py", "base.py", "factory.py",
            "jpeg.py", "mesh.py", "distributed.py", "dist_ba.py", "train_parallel.py",
            "native.py", "timing.py", "extractor.py", "corr.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_reads_of_the_jax_package_tree(path):
    """No module builds or loads anything from the JAX package's native/ or
    droid_slam_reserch_tpu/ directories (the port has its own graph
    library source, csrc/graph_ops.cpp)."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert node.value.rstrip("/") not in ("native", "droid_slam_reserch_tpu"), \
                f"{path.name} names {node.value!r}"
