"""SLAM runtime of this slice: keyframe buffer, motion filter, factor graph,
frontend and the Droid facade.  Host Python owns the data-dependent
decisions (admission, edge selection, culling); the numeric steps run on
the engine's device."""
from .droid import Droid
from .factor_graph import FactorGraph
from .frontend import Frontend
from .motion_filter import MotionFilter
from .video import Video

__all__ = [k for k in dir() if not k.startswith("_")]
