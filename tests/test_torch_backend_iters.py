"""The port's global BA backend runs as many Gauss-Newton iterations a step as
the JAX backend, whatever ``DroidConfig.ba_iters`` says: the JAX backend
calls ``FactorGraph.update_lowmem(steps=steps)`` and so always takes that
method's default ``itrs``, and reads ``ba_iters`` nowhere.

The port's ``FactorGraph.update_lowmem`` is replaced by a recorder of its
arguments, so the backend builds its graph over a 4-frame video on the CPU
and no update operator runs."""
import inspect

import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu.engine.factor_graph import FactorGraph as JFactorGraph
from droid_slam_reserch_tpu_torch.engine import factor_graph as tfg
from droid_slam_reserch_tpu_torch.engine.backend import Backend
from droid_slam_reserch_tpu_torch.engine.video import Video
from droid_slam_reserch_tpu_torch.utils import DroidConfig

JAX_ITRS = inspect.signature(JFactorGraph.update_lowmem).parameters["itrs"].default


@pytest.mark.parametrize("ba_iters", [1, 2, 3])
def test_backend_runs_the_jax_backends_ba_iterations(ba_iters, monkeypatch):
    calls = []

    def record(self, steps=8, itrs=2):
        calls.append({"steps": steps, "itrs": itrs})
        self.chunks = (0, 0)

    monkeypatch.setattr(tfg.FactorGraph, "update_lowmem", record)
    cfg = DroidConfig(image_size=(64, 96), buffer=8, ba_iters=ba_iters)
    video = Video(cfg, device="cpu")
    for t in range(4):
        pose = np.array([0.05 * t, 0, 0, 0, 0, 0, 1], np.float32)
        video.append(float(t), None, pose, 1.0, None, [60.0, 60.0, 48.0, 32.0],
                     torch.zeros(1, 8, 12, 128))
    backend = Backend(None, None, video, cfg)
    backend(steps=5)
    assert JAX_ITRS == 2
    assert calls == [{"steps": 5, "itrs": JAX_ITRS}]
    assert backend.runs[0]["edges"] > 0
