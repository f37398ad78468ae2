"""The import check, and the reference's independence of the program."""
import os
import subprocess
import sys

from port_bench.harness import forbidden_modules

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_forbidden_modules_compares_top_level_names_whole():
    assert forbidden_modules(["jax", "numpy"]) == ["jax"]
    assert forbidden_modules(["jaxlib.xla_client", "flax.linen"]) == ["flax", "jaxlib"]
    assert forbidden_modules(["droid_slam_reserch_tpu.engine"]) == ["droid_slam_reserch_tpu"]
    assert forbidden_modules(["droid_slam_reserch_tpu_torch", "droid_slam_reserch_tpu_torch.ops",
                              "jaxtyping", "torch"]) == []


def _loaded_after(stmt):
    code = (f"import sys; {stmt}; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": ROOT}, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_reference_imports_nothing_of_the_program_or_jax():
    tops = _loaded_after("import port_bench.reference, port_bench.reference.engine")
    assert not tops & {"droid_slam_reserch_tpu_torch", "droid_slam_reserch_tpu", "jax",
                       "jaxlib", "flax"}


def test_the_harness_loads_no_jax_with_the_program():
    tops = _loaded_after("import port_bench.harness.check, port_bench.harness.runner; "
                         "from port_bench.harness.cells import find_cell, load_benchmark; "
                         "[find_cell(w['name']) for w in load_benchmark()['workloads']]; "
                         "import droid_slam_reserch_tpu_torch.engine")
    assert "droid_slam_reserch_tpu_torch" in tops
    assert not tops & {"droid_slam_reserch_tpu", "jax", "jaxlib", "flax"}


def test_run_fails_without_a_card():
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                          "euroc_stereo_fp32.stream", "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True)
    import torch

    if not torch.cuda.is_available():
        assert out.returncode != 0 and out.stdout.strip() == ""
