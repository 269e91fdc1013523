"""The benchmark's plain reference renderer.

`tpt/` is a frozen copy of the port's plain PyTorch path: the scene
builders (SAH/SBVH, the BVH8 collapse and their C++ helpers, built by g++
into build/perfbench_ref/ of the checkout), the camera, the Threefry
draws, the BSDFs, the BVH8 traversal and the unidirectional and VCM
integrators. Every dispatch to a CUDA kernel was taken out of the copy, so
it runs the plain operators on any device, the card included. It imports
nothing of the program (cudapathtracer_tpu_torch) or of the JAX package,
and later changes to the program do not move it.

`render.Reference` builds its own scene from the mesh, materials and atlas
the benchmark made, and renders the samples of one dispatch.
"""
