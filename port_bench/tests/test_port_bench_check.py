"""The check at a tiny size on the CPU: the program and the plain reference
agree, and each fault a cell can have, planted in the timed path during
the window, makes ``correct`` false; so does the control, the program in
bf16.  One card has no exchange between chips to leave out."""
import pytest
import torch

from port_bench.harness.runner import Runner
from port_bench.harness.cells import load_benchmark
from port_bench.tests.conftest import run_tiny

CELLS = [w["name"] for w in load_benchmark()["workloads"]]


@pytest.fixture
def in_window(monkeypatch):
    """A switch that turns on when the window starts."""
    on = [False]
    start = Runner.open_window

    def flip(self):
        on[0] = True
        return start(self)

    monkeypatch.setattr(Runner, "open_window", flip)
    return on


@pytest.mark.parametrize("name", CELLS)
def test_program_agrees_with_the_reference(name):
    res = run_tiny(name)
    assert res["correct"], res["compared"]
    assert res["failed"] == 0 and res["attempted"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_control_in_bf16_fails(name):
    res = run_tiny(name, dtype="bfloat16")
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("name", CELLS)
def test_step_that_leaves_the_state_unchanged_fails(name, monkeypatch, in_window):
    from droid_slam_reserch_tpu_torch.engine import backend, droid

    track, run = droid.Droid.track, backend.Backend._run
    monkeypatch.setattr(droid.Droid, "track",
                        lambda self, *a, **k: None if in_window[0] else track(self, *a, **k))
    monkeypatch.setattr(droid.Droid, "frontend_cls", droid.Frontend)
    monkeypatch.setattr(backend.Backend, "_run",
                        lambda self, steps: None if in_window[0] else run(self, steps))
    res = run_tiny(name)
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("name", CELLS)
def test_half_of_the_edges_left_out_fails(name, monkeypatch, in_window):
    from droid_slam_reserch_tpu_torch.engine import droid

    apply = droid.update_apply

    def half(update, net, inp, corr, motn, kk=None, num_segments=None, emask=None):
        if not in_window[0]:
            return apply(update, net, inp, corr, motn, kk, num_segments, emask)
        E = net.shape[1]
        keep = (torch.arange(E, device=net.device) < (E + 1) // 2).to(net.dtype)
        out = apply(update, net, inp, corr, motn, kk, num_segments,
                    keep if emask is None else emask * keep)
        return (out[0], out[1], out[2] * keep[None, :, None, None, None]) + tuple(out[3:])

    monkeypatch.setattr(droid, "update_apply", half)
    res = run_tiny(name)
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("name", CELLS)
def test_answer_altered_where_produced_fails(name, monkeypatch, in_window):
    from droid_slam_reserch_tpu_torch.engine import factor_graph, video

    for mod in (factor_graph, video):
        ba = mod.ba_iterations

        def nudged(*a, _ba=ba, **k):
            poses, disps = _ba(*a, **k)
            if in_window[0]:
                poses = poses.clone()
                poses[:, :3] += 1e-3
            return poses, disps

        monkeypatch.setattr(mod, "ba_iterations", nudged)
    res = run_tiny(name)
    assert not res["correct"], res["compared"]
