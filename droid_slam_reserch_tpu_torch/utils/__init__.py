from .config import (
    DroidConfig,
    EUROC_CONFIG,
    TUM_CONFIG,
    TARTANAIR_CONFIG,
    ETH3D_CONFIG,
)
from .timing import Timer

__all__ = [k for k in dir() if not k.startswith("_")]
