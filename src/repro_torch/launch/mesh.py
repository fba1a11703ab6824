"""Device meshes: the (nx, ny) mesh of the distributed stencil step, and
the host mesh a training run holds.

Counterpart of `repro.launch.mesh`'s stencil helpers, `make_host_mesh`
and `tp_degree`. The training path runs on one card so far: its host
mesh is ("data", "model") = (1, 1), tp = 1; wider meshes, and the rules
that shard a model over them, wait for slice G2b (ROADMAP Queue 1).

The reference runs one controller: `shard_map` over a mesh, in one
process. The port keeps that design: one process holds a `StencilMesh`,
a shape and the `torch.device` of each shard, and drives every shard from
the host. A mesh whose shards lie on distinct cards moves bands between
them over NVLink; a loopback mesh, whose shards share one device (asked
for with `devices=["cuda:0"] * 4`, or `["cpu"] * 4` in the tests), moves
them within that device's memory through the same code.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

AXES = ("x", "y")


@dataclasses.dataclass(frozen=True)
class StencilMesh:
    """Shape `(nx, ny)` over the axes ("x", "y"); `devices` holds the
    device of each shard in row-major `(ix, iy)` order, shard `ix * ny +
    iy` owning the (X/nx, Y/ny, Z) slab at (ix, iy)."""
    shape: Tuple[int, int]
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, str] = AXES

    def __post_init__(self):
        nx, ny = self.shape
        if nx < 1 or ny < 1:
            raise ValueError(f"mesh shape must be >= 1, got ({nx}, {ny})")
        if len(self.devices) != nx * ny:
            raise ValueError(f"a ({nx}, {ny}) mesh needs {nx * ny} devices, "
                             f"got {len(self.devices)}")

    def axis_size(self, axis: str) -> int:
        return self.shape[_axis_index(self, axis)]

    def coords(self, shard: int) -> Tuple[int, int]:
        return divmod(shard, self.shape[1])

    def index(self, coords) -> int:
        return coords[0] * self.shape[1] + coords[1]

    @property
    def is_cuda(self) -> bool:
        return self.devices[0].type == "cuda"


def _axis_index(mesh: StencilMesh, axis: str) -> int:
    if axis not in mesh.axis_names:
        raise ValueError(f"axis {axis!r} not in mesh axes "
                         f"{tuple(mesh.axis_names)}")
    return mesh.axis_names.index(axis)


def _visible_cuda_devices() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def make_stencil_mesh(nx: int, ny: int, *,
                      devices: Optional[Sequence] = None,
                      device: str = "cuda") -> StencilMesh:
    """(nx, ny) mesh for the 2D-decomposed stencil step.

    By default it takes `nx * ny` distinct devices of type `device`
    (cards 0 .. nx*ny-1) and raises, naming the count, when fewer are
    visible. A loopback mesh is asked for explicitly, by passing
    `devices`: one entry per shard, repeats allowed."""
    if nx < 1 or ny < 1:
        raise ValueError(f"mesh shape must be >= 1, got ({nx}, {ny})")
    if devices is None:
        n = nx * ny
        if device == "cpu":
            raise ValueError("CPU shards share one device: pass "
                             "devices=['cpu'] * n for a loopback mesh")
        avail = _visible_cuda_devices()
        if n > avail:
            raise ValueError(
                f"cannot build a ({nx}, {ny}) stencil mesh: needs {n} "
                f"devices, {avail} available to this process (pass "
                f"devices=['cuda:0'] * {n} for a loopback mesh)")
        devices = [f"{device}:{i}" for i in range(n)]
    devs = tuple(torch.device(d) for d in devices)
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"a mesh's shards lie on one device type, got "
                         f"{sorted({d.type for d in devs})}")
    if devs[0].type == "cuda":
        devs = tuple(torch.device("cuda", d.index or 0) for d in devs)
    else:
        devs = tuple(torch.device(d.type) for d in devs)
    return StencilMesh((nx, ny), devs)


def ring_neighbor(idx, n: int, delta: int):
    """Ring coordinate of the `delta`-away neighbour on an n-shard mesh
    axis, wrapping periodically (Python's % takes the divisor's sign, so
    delta=-1 at coordinate 0 wraps to n-1). Wrapped halo data is frozen
    by the caller's global-interior mask."""
    if n < 1:
        raise ValueError(f"axis size must be >= 1, got {n}")
    return (idx + delta) % n


def dma_neighbor_coords(mesh_axes, my_coords, axis: str, delta: int,
                        n: int):
    """Mesh coordinates of the `delta`-away ring neighbour along `axis`
    (an n-shard ring), every other coordinate held: the shard the band
    exchange kernel (K7) stores its boundary bands into."""
    if axis not in mesh_axes:
        raise ValueError(f"axis {axis!r} not in mesh axes {tuple(mesh_axes)}")
    return tuple(
        ring_neighbor(c, n, delta) if a == axis else c
        for a, c in zip(mesh_axes, my_coords))


def resize_stencil_mesh(nx: int, ny: int, *,
                        devices: Optional[Sequence] = None,
                        device: str = "cuda") -> StencilMesh:
    """Rebuild the stencil mesh at another shape: `make_stencil_mesh`'s
    contract, with a clear error when the requested shape exceeds the
    cards this process can see."""
    return make_stencil_mesh(nx, ny, devices=devices, device=device)


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """The devices a training run holds, with the reference's mesh axes:
    `shape` maps "data" and "model" to their sizes."""
    shape: dict
    devices: Tuple[torch.device, ...]


def make_host_mesh(*, model: int = 1, device: str = "cuda") -> HostMesh:
    """One device of type `device` (card 0 for "cuda") as a (1, 1) mesh.
    A model axis wider than 1 (tensor parallelism) raises
    NotImplementedError naming slice G2b."""
    if model != 1:
        raise NotImplementedError(f"a host mesh with model={model} (tensor "
                                  f"parallelism) waits for slice G2b")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return HostMesh({"data": 1, "model": 1}, (dev,))


def tp_degree(mesh) -> int:
    return mesh.shape.get("model", 1)
