"""Public wrapper of the selective-scan kernel and block-size guidance (the
port of `repro.kernels.ssm.ops`).

PyTorch runs eagerly, so `mamba_scan` has nothing to jit and no
`interpret` switch: the device of the tensors picks the CUDA kernel or its
plain version.
"""
from __future__ import annotations

from repro_torch.kernels import refuse_grad
from repro_torch.kernels.ssm.ssm import selective_scan, vmem_bytes


def mamba_scan(xc, dt, Bmat, Cmat, A, h0, *, chunk: int = 128):
    """K9 over the mamba block's tensors; forward-only, as the
    reference's route: raises RuntimeError under grad. On DTensors each
    rank launches it on its own block (`_scan_local`)."""
    refuse_grad("mamba_scan (K9)", xc, dt, Bmat, Cmat, A, h0)
    from repro_torch.distributed.sharding import is_dtensor
    if is_dtensor(xc):
        return _scan_local(xc, dt, Bmat, Cmat, A, h0, chunk)
    return selective_scan(xc, dt, Bmat, Cmat, A, h0, chunk=chunk)


def _scan_local(xc, dt, Bmat, Cmat, A, h0, chunk: int):
    """`mamba_scan` of DTensors (the model under a `DeviceMesh`), rank by
    rank through `local_map` (the kernel's op has no DTensor rule): each
    rank scans its own batch rows and d_inner channels, as `xc` (B, S,
    Di) holds them (sharded on dims 0 and 2 only; the others are
    redistributed to match). Returns (y, h) placed as xc and h0 are."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = xc.device_mesh
    xc, dt, Bmat, Cmat, A, h0 = (
        t if isinstance(t, DTensor) else DTensor.from_local(
            t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        for t in (xc, dt, Bmat, Cmat, A, h0))
    xpl = list(xc.placements)
    if any(not (p.is_replicate() or (isinstance(p, Shard) and p.dim in
                                     (0, 2))) for p in xpl):
        raise ValueError(f"mamba_scan on a mesh takes xc (B, S, Di) "
                         f"sharded on the batch and channel dims only; got "
                         f"{tuple(xpl)}")

    def like(dims):   # xc's batch dim -> dims[0], its channel dim -> dims[1]
        return [Shard(dims[p.dim // 2]) if isinstance(p, Shard)
                and dims[p.dim // 2] is not None else Replicate()
                for p in xpl]
    fn = local_map(
        lambda *a: selective_scan(*a, chunk=chunk),
        out_placements=(xpl, like((0, 1))),
        in_placements=(xpl, xpl, like((0, None)), like((0, None)),
                       like((None, 0)), like((0, 1))),
        device_mesh=mesh, redistribute_inputs=True)
    return fn(xc, dt, Bmat, Cmat, A, h0)


def pick_chunk(D: int, N: int, budget: int = 12 * 2**20) -> int:
    """The reference's choice: the largest power-of-two chunk whose Pallas
    working set (`vmem_bytes`) fits the budget. The CUDA kernel stages a
    tile of its own launch plan (`scan_launch_plan`), whatever the chunk."""
    c = 1024
    while c > 8 and vmem_bytes(c, D, N) > budget:
        c //= 2
    return c
