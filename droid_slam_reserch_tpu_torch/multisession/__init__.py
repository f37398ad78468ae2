"""Multisession map fusion (mirror of the JAX package's multisession/):
only stage 1's keyframe image export is ported so far."""
from .pipeline import extract_images_by_timestamp

__all__ = [k for k in dir() if not k.startswith("_")]
