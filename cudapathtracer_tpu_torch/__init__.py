"""cudapathtracer_tpu_torch — the path tracer on PyTorch and CUDA.

A port of ``cudapathtracer_tpu`` (JAX and Pallas on a TPU), which stays the
reference every part of this package is tested against. The port renders
the PT+NEE integrator through the packet engine, whose dense cluster kernel
is written in CUDA C++ for the H100 (csrc/dense_resident.cu). It imports
torch and numpy, never jax.

Every constructor takes an explicit ``device``; the packet engine runs the
CUDA kernel on CUDA tensors and its plain PyTorch version on CPU tensors.
Importing the package builds nothing: the native BVH builder and the CUDA
kernel are compiled into ``build/`` at their first use.
"""

__version__ = "0.1.0"

from .models.scene import Scene, make_scene                # noqa: F401
from .render.camera import Camera, make_camera             # noqa: F401
from .render.renderer import (                             # noqa: F401
    AccumState,
    finalize_image,
    init_accum,
    render,
    render_batch,
    write_render,
)
from .utils.config import RenderConfig                     # noqa: F401
