"""Trajectory metrics and the oracle frontend gate."""
from .metrics import ate_rmse, umeyama_alignment

__all__ = [k for k in dir() if not k.startswith("_")]
