"""The system under test: the PyTorch and CUDA port, driven as its users
drive it. This is the one module of the harness that imports the program.
"""

from __future__ import annotations

import dataclasses


def renderer(settings: str, mesh, materials, textures, device):
    """The program's Renderer over the benchmark's inputs, converted to the
    program's own input types field by field."""
    from cudapathtracer_tpu_torch.driver import Renderer
    from cudapathtracer_tpu_torch.scene.materials import Material
    from cudapathtracer_tpu_torch.utils.config import parse_config
    from cudapathtracer_tpu_torch.utils.obj import MeshData
    pmesh = MeshData(**{f.name: getattr(mesh, f.name)
                        for f in dataclasses.fields(mesh)})
    pmats = [Material(**dataclasses.asdict(m)) for m in materials]
    return Renderer(parse_config(settings), mesh=pmesh, materials=pmats,
                    textures=textures, device=device)


def samples_per_dispatch(r) -> int:
    from cudapathtracer_tpu_torch.driver import resolve_samples_per_dispatch
    return resolve_samples_per_dispatch(r.cfg, r.device)


def launches() -> dict:
    """A copy of the program's launch counters (kernel name -> launches)."""
    from cudapathtracer_tpu_torch import kernels
    return dict(kernels.launches)
