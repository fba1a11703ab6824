"""Selective scan on Hopper (K9, Mamba-1): the port of the reference's
Pallas `repro.kernels.ssm.ssm.selective_scan` / `_kernel`.

`selective_scan` dispatches on where its tensors lie. On CUDA tensors it
launches the hand-written kernel `csrc/selective_scan.cu`: a thread per
(b, d, n) walks the sequence with its state h in a register, `chunk` steps
of x, dt, B and C at a time staged through shared memory, and y is summed
over n by warp shuffles. On CPU tensors it runs `_selective_scan_plain`,
the same recurrence in plain PyTorch. There is no fallback from one to the
other, and `LAUNCHES` counts the kernel's launches.
"""
from __future__ import annotations

import torch

from repro_torch import _build
from repro_torch.core.roofline import SMEM_PER_BLOCK

D_TILE = 16          # d per block of the CUDA kernel
MAX_STATES = 4       # states per thread: N <= 32 * MAX_STATES
DTYPES = (torch.float32, torch.bfloat16)

LAUNCHES = {"selective_scan": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def smem_bytes(chunk: int, N: int, x_itemsize: int = 4,
               dt_itemsize: int = 4) -> int:
    """Shared memory of one block of the CUDA kernel: one chunk of x and dt
    for the block's D_TILE values of d, and of B and C, each staged in its
    own type."""
    return chunk * (D_TILE * (x_itemsize + dt_itemsize) + 2 * N * x_itemsize)


def vmem_bytes(chunk: int, D: int, N: int, itemsize: int = 2) -> int:
    """The reference's VMEM working set of one Pallas program: chunk IO +
    (chunk, D, N) scan tensors (its formula, pinned by the tests). The CUDA
    kernel's budget is `smem_bytes`."""
    io = (2 * chunk * D + 2 * chunk * N) * itemsize + chunk * D * 4
    scan = 2 * chunk * D * N * 4          # a, bu in f32
    state = D * N * 4
    return 2 * io + scan + state


def _selective_scan_plain(xc, dt, Bmat, Cmat, A, h0):
    """Plain version: the sequential recurrence in the kernel's order, in
    f32. Returns (y (B, S, D), h_final (B, D, N))."""
    xc, dt, Bmat, Cmat, A, h = (t.float()
                                for t in (xc, dt, Bmat, Cmat, A, h0))
    y = torch.empty(xc.shape, dtype=torch.float32, device=xc.device)
    for t in range(xc.shape[1]):
        dtv = dt[:, t, :, None]
        a = torch.exp(dtv * A)
        h = a * h + (dtv * xc[:, t, :, None]) * Bmat[:, t, None, :]
        y[:, t] = (h * Cmat[:, t, None, :]).sum(-1)
    return y, h


def _kernel_dtypes(xc, dt, Bmat, Cmat):
    """The types the kernel takes: x, B and C f32 or bf16, all three the
    same (else all promoted to f32), dt f32 or x's type (else f32)."""
    if xc.dtype in DTYPES and Bmat.dtype == Cmat.dtype == xc.dtype:
        x_type = xc.dtype
    else:
        x_type = torch.float32
    dt_type = dt.dtype if dt.dtype in (torch.float32, x_type) else \
        torch.float32
    return x_type, dt_type


def _selective_scan_cuda(xc, dt, Bmat, Cmat, A, h0, chunk: int):
    """Launch K9 on (B, S, D) / (B, S, N) tensors of the kernel's types."""
    lib = _build.load()
    tensors = (xc, dt, Bmat, Cmat, A, h0)
    if not all(t.is_cuda and t.device == xc.device for t in tensors):
        raise ValueError("selective_scan: every input must lie on one CUDA "
                         "device")
    x_type, dt_type = _kernel_dtypes(xc, dt, Bmat, Cmat)
    xc, Bmat, Cmat = (t.to(x_type).contiguous() for t in (xc, Bmat, Cmat))
    dt = dt.to(dt_type).contiguous()
    A, h0 = A.float().contiguous(), h0.float().contiguous()
    B, S, D = xc.shape
    N = Bmat.shape[-1]
    y = torch.empty((B, S, D), dtype=torch.float32, device=xc.device)
    hout = torch.empty((B, D, N), dtype=torch.float32, device=xc.device)
    with torch.cuda.device(xc.device):
        stream = torch.cuda.current_stream(xc.device).cuda_stream
        err = lib.selective_scan_fwd(
            int(x_type == torch.bfloat16), int(dt_type == torch.bfloat16),
            xc.data_ptr(), dt.data_ptr(), Bmat.data_ptr(), Cmat.data_ptr(),
            A.data_ptr(), h0.data_ptr(), y.data_ptr(), hout.data_ptr(),
            B, S, D, N, chunk,
            smem_bytes(chunk, N, xc.element_size(), dt.element_size()), stream)
    _build.check(err, "selective_scan_fwd")
    LAUNCHES["selective_scan"] += 1
    return y, hout


def selective_scan(xc, dt, Bmat, Cmat, A, h0, *, chunk: int = 128):
    """xc/dt (B,S,D); Bmat/Cmat (B,S,N); A (D,N); h0 (B,D,N).

    Returns (y (B,S,D) f32, h_final (B,D,N) f32).

    Raises ValueError, on either device, where the shapes disagree, where
    S is not a multiple of `chunk` (after `min(chunk, S)`, as the reference
    asserts), where N exceeds 32 * MAX_STATES, and where one chunk would
    need more shared memory than one block may use (`smem_bytes` >
    `SMEM_PER_BLOCK`)."""
    if xc.ndim != 3 or dt.shape != xc.shape or Bmat.ndim != 3 \
            or Cmat.shape != Bmat.shape or Bmat.shape[:2] != xc.shape[:2]:
        raise ValueError(f"selective_scan takes xc, dt (B,S,D) and Bmat, "
                         f"Cmat (B,S,N); got {tuple(xc.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(Bmat.shape)}, "
                         f"{tuple(Cmat.shape)}")
    B, S, D = xc.shape
    N = Bmat.shape[-1]
    if A.shape != (D, N) or h0.shape != (B, D, N):
        raise ValueError(f"A must be (D, N) = {(D, N)} and h0 (B, D, N) = "
                         f"{(B, D, N)}; got {tuple(A.shape)}, "
                         f"{tuple(h0.shape)}")
    chunk = min(chunk, S)
    if chunk < 1 or S % chunk:
        raise ValueError(f"S={S} must be a multiple of chunk={chunk}")
    if N > 32 * MAX_STATES:
        raise ValueError(f"selective_scan holds at most {32 * MAX_STATES} "
                         f"states per d (N = {N})")
    x_type, dt_type = _kernel_dtypes(xc, dt, Bmat, Cmat)
    need = smem_bytes(chunk, N, x_type.itemsize, dt_type.itemsize)
    if need > SMEM_PER_BLOCK:
        raise ValueError(f"selective_scan chunk={chunk} at N={N} needs {need}"
                         f" B of shared memory, over the {SMEM_PER_BLOCK} B "
                         f"one block may use; use a smaller chunk")
    if not xc.is_cuda:
        return _selective_scan_plain(xc, dt, Bmat, Cmat, A, h0)
    return _selective_scan_cuda(xc, dt, Bmat, Cmat, A, h0, chunk)
