"""One typed, central configuration (copy of the JAX package's DroidConfig).

Every tunable lives in one dataclass, with the per-dataset presets of the
reference's evaluation scripts.  ``ba_shards`` and ``refresh_shards`` (-1:
auto, by the JAX package's rules over ``torch.cuda.device_count()``) place
shard k on card k mod the card count: on one card or the CPU an explicit
count runs every shard there, one after the other.
"""
import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class DroidConfig:
    # model
    weights: Optional[str] = None          # droid.pth-style checkpoint, or .npz of JAX params
    vis_path: str = ""
    image_size: Tuple[int, int] = (240, 320)
    buffer: int = 512                      # keyframe ring buffer capacity
    stereo: bool = False
    rgbd: bool = False
    upsample: bool = False

    # motion filter (reference demo.py:114, motion_filter.py:15)
    filter_thresh: float = 2.4
    warmup: int = 8

    # frontend (reference demo.py:113-120, droid_frontend.py:23-35)
    beta: float = 0.3
    keyframe_thresh: float = 4.0
    frontend_thresh: float = 16.0
    frontend_window: int = 25
    frontend_radius: int = 2
    frontend_nms: int = 1
    max_factors: int = 48                  # droid_frontend.py:13
    max_age: int = 25                      # droid_frontend.py:23
    iters1: int = 4                        # droid_frontend.py:24
    iters2: int = 2                        # droid_frontend.py:25
    init_iters: int = 8                    # droid_frontend.py:87,92

    # backend (reference demo.py:122-124, droid.py:121-125)
    backend_thresh: float = 22.0
    backend_radius: int = 2
    backend_nms: int = 3
    backend_steps_first: int = 7
    backend_steps_second: int = 12

    # BA numerics (reference factor_graph.py:240-241,297-298, ba.py:43)
    ba_iters: int = 2
    frontend_lm: float = 1e-4
    frontend_ep: float = 0.1
    backend_lm: float = 1e-5
    backend_ep: float = 1e-2
    damping_eps: float = 1e-7              # EP in factor_graph.update
    min_depth: float = 0.25                # droid_kernels.cu:26 (inference BA)
    rgbd_alpha: float = 0.05               # droid_kernels.cu:1396

    # multisession quality gating (reference s_droid_frontend.py:114-177)
    good: bool = True
    quality_mean_thresh: float = 200.0
    quality_min_thresh: float = 10.0

    # execution
    use_altcorr_backend: bool = True
    ba_shards: int = -1
    refresh_shards: int = -1
    edge_bucket: int = 16                  # pad edge counts to multiples
    window_bucket: int = 8                 # pad BA window sizes to multiples
    compute_dtype: str = "float32"

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


# per-dataset presets (reference evaluation_scripts/*)
EUROC_CONFIG = DroidConfig(
    image_size=(320, 512), warmup=15, keyframe_thresh=3.5,
    frontend_thresh=17.5, frontend_window=20, backend_thresh=24.0,
    backend_nms=2,
)
TUM_CONFIG = DroidConfig(
    image_size=(240, 320), buffer=512, frontend_window=16, frontend_thresh=16.0,
)
TARTANAIR_CONFIG = DroidConfig(
    image_size=(384, 512), buffer=1000, warmup=12, frontend_thresh=15.0,
    frontend_window=20, frontend_radius=1, frontend_nms=1, beta=0.5,
    backend_thresh=20.0, backend_nms=2,
)
ETH3D_CONFIG = DroidConfig(
    image_size=(480, 640), buffer=1024, warmup=20, rgbd=True,
)
