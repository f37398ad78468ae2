"""droid_slam_reserch_tpu_torch — the PyTorch/CUDA port of droid_slam_reserch_tpu.

Mirrors the JAX package's module names so each counterpart is easy to find:

- ``lie``      quaternion SO3/SE3 functions on tensors
- ``geom``     projective geometry with analytic Jacobians, graph helpers
- ``models``   BasicEncoder, ConvGRU, UpdateModule/GraphAgg as ``nn.Module``s
- ``ops``      correlation and BA-block functions: hand-written CUDA kernels
               for CUDA tensors, plain PyTorch versions for CPU tensors
- ``ba``       windowed dense bundle adjustment (Gauss-Newton + Schur)
- ``engine``   keyframe buffer, motion filter, factor graph, frontend, Droid
- ``eval``     ATE with Umeyama alignment and the oracle frontend driver
- ``utils``    configuration

The package imports torch, numpy and scipy; it never imports JAX or the JAX
package.  Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
