"""cudapathtracer_tpu_torch — the PyTorch + CUDA port of cudapathtracer_tpu.

The JAX package `cudapathtracer_tpu` is the reference; this package
reproduces its behaviour on an NVIDIA Hopper GPU, module for module (the
module names mirror the reference's). It keeps its own copies of the
reference's host-only code (the `.rendertron` parser, OBJ loader, metrics,
builtin scenes, SAH/SBVH and BVH8 builders and their C++ in
`scene/csrc/`) and imports neither JAX nor the reference package.

The hot loops run as hand-written CUDA kernels (`kernels/csrc/*.cu`); each
has a plain PyTorch version beside it in the Python module that calls it.
A CPU tensor takes the plain version, a CUDA tensor the kernel.

Covered: every integrator of the reference (UNIDIRECTIONAL, BIDIRECTIONAL,
VCM, SPPM and NAIVE_UNIDIRECTIONAL) with both engines, the default mega
and classic, driven through `driver.Renderer` and
`python -m cudapathtracer_tpu_torch`.
"""

__version__ = "0.1.0"
