"""Training hyperparameters (defaults = reference train.py:146-171)."""
import dataclasses


@dataclasses.dataclass
class TrainConfig:
    name: str = "droid"
    lr: float = 2.5e-4
    steps: int = 250000
    clip: float = 2.5
    batch: int = 1
    n_frames: int = 7
    iters: int = 15                # unrolled update iterations
    w1: float = 10.0               # geodesic
    w2: float = 0.01               # residual
    w3: float = 0.05               # flow
    fmin: float = 8.0
    fmax: float = 96.0
    edges: int = 24
    restart_prob: float = 0.2
    weight_decay: float = 1e-5
    pct_start: float = 0.01
    ckpt_every: int = 10000
    image_size: tuple = (384, 512)
