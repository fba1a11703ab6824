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
    reference's route: raises RuntimeError under grad."""
    refuse_grad("mamba_scan (K9)", xc, dt, Bmat, Cmat, A, h0)
    return selective_scan(xc, dt, Bmat, Cmat, A, h0, chunk=chunk)


def pick_chunk(D: int, N: int, budget: int = 12 * 2**20) -> int:
    """The reference's choice: the largest power-of-two chunk whose Pallas
    working set (`vmem_bytes`) fits the budget. The CUDA kernel stages a
    tile of its own launch plan (`scan_launch_plan`), whatever the chunk."""
    c = 1024
    while c > 8 and vmem_bytes(c, D, N) > budget:
        c //= 2
    return c
