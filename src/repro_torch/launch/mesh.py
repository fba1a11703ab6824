"""Device meshes: the (nx, ny) mesh of the distributed stencil step, and
the ("data", "model") meshes a model runs on.

Counterpart of `repro.launch.mesh`'s stencil helpers, `make_host_mesh`,
`make_production_mesh` and `tp_degree`. A model's mesh is a
`torch.distributed` `DeviceMesh`, one rank per card (SPMD; see
`distributed.sharding`): `make_host_mesh` spreads the initialised
process group's world over ("data", "model"), and without a process
group returns the single-device `HostMesh` (1, 1) a one-card run holds.

For the stencil the reference runs one controller: `shard_map` over a
mesh, in one process. The port keeps that design there: one process
holds a `StencilMesh`,
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


def make_host_mesh(*, model: int = 1, device: str = "cuda"):
    """The mesh a model runs on.

    With a `torch.distributed` process group initialised, a `DeviceMesh`
    of shape (world // model, model) named ("data", "model") on devices of
    type `device`, each rank on its own card (rank % the cards visible,
    made the current device). Raises ValueError where `model` does not
    divide the world size. The group is the caller's to start:
    `launch.ranks.launch` starts one rank a card (or joins `torchrun`'s),
    as `python -m repro_torch.launch.train` does, so that the default
    (model=1) is the reference's host mesh (n, 1) over every card.

    Without a process group, one device of type `device` (card 0 for
    "cuda") as the (1, 1) `HostMesh`; a model axis wider than 1 then
    raises ValueError (tensor parallelism needs one rank a card)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if model < 1 or world % model:
            raise ValueError(f"model={model} does not divide the world "
                             f"size {world}")
        return _device_mesh((world // model, model), ("data", "model"),
                            device)
    if model != 1:
        raise ValueError(f"a host mesh with model={model} needs one rank a "
                         f"card: initialise a process group of a multiple "
                         f"of {model} ranks first")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return HostMesh({"data": 1, "model": 1}, (dev,))


PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """The production mesh: (16, 16) over ("data", "model"), 256 ranks, or
    (2, 16, 16) over ("pod", "data", "model"), 512. Needs a process group
    of exactly that world size, and raises ValueError naming it
    otherwise."""
    import torch.distributed as dist
    shape, names = PRODUCTION_SHAPES[multi_pod]
    n = 1
    for d in shape:
        n *= d
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(f"the {'two-pod' if multi_pod else 'single-pod'} "
                         f"production mesh {shape} needs a world of {n} "
                         f"ranks, got {world}")
    return _device_mesh(shape, names, device)


def _device_mesh(shape, names, device: str):
    """A DeviceMesh over the process group's world. Under a `"fake"` group
    (the dry run's, `launch.dryrun.fake_group`) no card is made current:
    a fake group touches none."""
    from torch.distributed.device_mesh import init_device_mesh
    dev_type = torch.device(device).type
    import torch.distributed as dist
    if dev_type == "cuda" and dist.get_backend() != "fake":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dev_type, tuple(shape), mesh_dim_names=names)


def tp_degree(mesh) -> int:
    """The size of the mesh's "model" axis (1 where it has none): a
    `HostMesh`, a `DeviceMesh` or any mesh whose `.shape` maps names to
    sizes."""
    from repro_torch.distributed.sharding import axis_sizes
    return axis_sizes(mesh).get("model", 1)
