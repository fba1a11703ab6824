"""Plain-torch oracle for the selective scan (Mamba-1): the port's copy of
`repro.kernels.ssm.ref.selective_scan_ref`."""
from __future__ import annotations

import torch


def selective_scan_ref(xc, dt, Bmat, Cmat, A, h0):
    """Sequential oracle.

    xc   (B, S, D)   post-conv activations
    dt   (B, S, D)   softplus'd timestep
    Bmat (B, S, N)   input projection
    Cmat (B, S, N)   output projection
    A    (D, N)      negative state matrix
    h0   (B, D, N)   initial state
    Returns (y (B, S, D), h_final (B, D, N)), all f32.
    """
    xc, dt, Bmat, Cmat, A, h0 = (t.float()
                                 for t in (xc, dt, Bmat, Cmat, A, h0))
    h = h0
    ys = []
    for t in range(xc.shape[1]):
        a = torch.exp(dt[:, t, :, None] * A)                        # (B,D,N)
        bu = (dt[:, t] * xc[:, t])[..., None] * Bmat[:, t, None, :]  # (B,D,N)
        h = a * h + bu
        ys.append(torch.einsum("bdn,bn->bd", h, Cmat[:, t]))
    return torch.stack(ys, 1), h
