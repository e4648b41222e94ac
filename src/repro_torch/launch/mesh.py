"""Mesh construction over ``torch.distributed`` (port of ``repro.launch.mesh``).

Each builder is a FUNCTION: importing this module touches no process group.
A builder needs an initialized default process group of at least as many
ranks as its mesh (``torchrun --nproc-per-node N`` starts N ranks on one
host) and returns a :class:`torch.distributed.device_mesh.DeviceMesh` over
the first ranks, row-major.  The single-pod mesh is 16 x 16 = 256 ranks
(``("data", "model")``); the multi-pod mesh adds a leading ``pod`` axis (2 x
16 x 16 = 512).  The ``pod`` axis composes with ``data`` for gradient
reduction; tensor-parallel collectives stay inside the ``model`` axis.

The mesh is on ``cuda`` (each rank's card: NCCL) unless ``device="cpu"``
(gloo: the CPU tests' worlds).
"""

from __future__ import annotations

import math


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 0


def _mesh(shape: tuple, axes: tuple, device: str):
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    need = math.prod(shape)
    return DeviceMesh(device, torch.arange(need).reshape(shape), mesh_dim_names=axes)


def _refuse(need: int, what: str, world: int):
    have = f"{world} ranks" if world else "no initialized process group"
    raise RuntimeError(
        f"need {need} devices for {what}; have {have} (start {need} processes, e.g. "
        f"torchrun --nproc-per-node {need} on one host, and init_process_group in each)"
    )


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    world = _world()
    if world < need:
        _refuse(need, f"mesh {shape}", world)
    return _mesh(shape, axes, device)


def make_smoke_mesh(n: int = 8, *, device: str = "cuda"):
    """Small ``(data=n/2, model=2)`` mesh."""
    if n < 2 or n % 2:
        raise ValueError(
            f"make_smoke_mesh needs an even n >= 2 to form a (n//2, 2) "
            f"(data, model) mesh; got n={n}"
        )
    world = _world()
    if world < n:
        _refuse(n, "the smoke mesh", world)
    return _mesh((n // 2, 2), ("data", "model"), device)


def make_stage_mesh(n_stages: int, *, device: str = "cuda"):
    """1-D ``("stage",)`` mesh for :func:`repro_torch.dist.pipeline.pipeline_apply`."""
    if n_stages < 1:
        raise ValueError(f"make_stage_mesh needs n_stages >= 1, got {n_stages}")
    world = _world()
    if world < n_stages:
        _refuse(n_stages, f"a {n_stages}-stage pipeline mesh", world)
    return _mesh((n_stages,), ("stage",), device)
