"""Each roofline function's operations and bytes at one shape worked by
hand, and the reduction of a profiler trace."""
import json

import pytest
import torch

from port_bench.harness import probes, roofline


def test_k1_ba_blocks():
    # reads: 4 * (target+weight 4*2*10 + disps 3*10 + poses 21 + intrinsics 4) + ii/jj 16*2
    # writes: 4 * (Hii, Hij, Hjj 3*36*2 + vi, vj 12*2 + Ei, Ej 12*2*10 + Ck, wk 2*2*10)
    assert roofline.ba_blocks(2, 10, 3) == (0.0, 444.0 * 20, 572.0 + 2080.0)


def test_k2_corr_build():
    # P = 16, Q = 32, levels 4x8, 2x4, 1x2, 0x4: 32 + 8 + 2 + 0 cells a pixel
    assert roofline.corr_build(2, 4, 4, 4, 8, 3, 4, 4) == (6144.0, 1280.0, 1152.0 + 5376.0)


def test_span_cells_and_k3():
    coords = torch.tensor([[[0.0, 0.0], [3.5, 3.5]]])
    # (0, 0): 5x5 + 4x4 + 2x2 + 1x1; (3.5, 3.5): 8x8 + 4x4 + 2x2 + 1x1
    assert roofline.span_cells(coords, 8, 8) == 46 + 85
    assert roofline.corr_lookup(1, 2, 85, 4, 4) == (0.0, 2352.0, 340.0 + 16.0 + 1568.0)


def test_window_cells_and_k4_k5():
    bases = torch.full((1, 8, 1), 8, dtype=torch.int32)   # windows at the levels' origin
    assert roofline.window_cells(bases, 8, 8) == 64 + 16 + 4 + 1
    assert roofline.window_shape(8, 8) == (24 + 20 + 18 + 17, 24)
    assert roofline.corr_build_windows(1, 1, 1, 8, 8, 2, 85, 4) == (
        340.0, 168.0, 520.0 + 8.0 + 79 * 24 * 4 + 32.0)
    assert roofline.corr_lookup_windows(1, 1, 4) == (0.0, 1176.0, 1024.0 + 32.0 + 8.0 + 784.0)


def test_conv_flops():
    conv = torch.nn.Conv2d(3, 5, 3, padding=1)
    x = torch.zeros(2, 3, 6, 6)
    assert roofline.conv_flops(conv, x, conv(x)) == 2.0 * 2 * 5 * 36 * 3 * 9


def test_kernel_names():
    assert probes.kernel_of("void corr_build_kernel<float>(float const*)") == "K2"
    assert probes.kernel_of("windows_build_bf16_kernel") == "K4"
    assert probes.kernel_of("corr_lookup_kernel") == "K3"
    assert probes.kernel_of("windows_lookup_kernel") == "K5"
    assert probes.kernel_of("pmajor_lookup_kernel") is None
    assert probes.kernel_of("ba_blocks_kernel") == "K1"


def test_trace_reduction(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "port_bench.window", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "port_bench.frontend", "ts": 10, "dur": 80},
        {"ph": "X", "cat": "user_annotation", "name": "port_bench.update_op", "ts": 20, "dur": 10},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 21, "dur": 1,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel", "ts": 40, "dur": 1,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "void corr_build_kernel<float>()", "ts": 30,
         "dur": 20, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "cudnn_conv", "ts": 45, "dur": 25,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 95, "dur": 10},
    ]
    ev += [  # the check's copy: launched inside a capture range, so out of the stretch
        {"ph": "X", "cat": "user_annotation", "name": "port_bench.capture", "ts": 92, "dur": 4},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 93, "dur": 1,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 80, "dur": 5,
         "args": {"correlation": 3}}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    s = probes.summarize(*probes.read_trace(str(path)))
    assert s["window_s"] == pytest.approx(96e-6)           # less the capture's 4
    assert s["busy_s"] == pytest.approx(45e-6)          # [30, 70) and [95, 100)
    assert s["by_kernel"]["K2"] == pytest.approx(20e-6) and s["count_kernel"]["K2"] == 1
    assert s["in_range"]["update_op"] == pytest.approx(20e-6)   # launched at 21, inside it
    # a gap goes to the host span open at its start: [0, 30) to none, [70, 95) to "frontend"
    assert s["idle"]["harness"] == pytest.approx(30e-6)
    assert s["idle"]["frontend"] == pytest.approx(25e-6)
