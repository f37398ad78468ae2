"""The benchmark's plain reference of DROID-SLAM (fp32, plain PyTorch and
numpy).  It imports nothing of the program under test, of its JAX
original or of JAX."""
from .engine import RefDroid
from .nets import load_networks

__all__ = ["RefDroid", "load_networks"]
