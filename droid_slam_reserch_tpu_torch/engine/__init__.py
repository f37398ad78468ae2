"""SLAM runtime of the port: keyframe buffer, motion filter, factor graph,
frontend, backend, trajectory filler, the Droid facade and the multisession
SDroid with its session motion filter and quality-gated frontend.  Host Python
owns the data-dependent decisions (admission, edge selection, culling, the
drift fallback); the numeric steps run on the engine's device."""
from .backend import Backend
from .droid import Droid, SDroid
from .factor_graph import FactorGraph
from .frontend import Frontend, SessionFrontend
from .motion_filter import MotionFilter, SessionMotionFilter
from .trajectory_filler import TrajectoryFiller
from .video import Video

__all__ = [k for k in dir() if not k.startswith("_")]
