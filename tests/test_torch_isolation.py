"""The port stands alone: no module of `repro_torch`, and not
`chip_smoke.py`, imports JAX, the reference package `repro` or
`ml_dtypes` (numpy's bf16, which the card's machine lacks); and the
CUDA dispatch raises what the kernel loader raises instead of falling back
to a plain version."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import _build
from repro_torch.kernels.advection import advection as TK
from repro_torch.kernels.advection import ref as TREF

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

IMPORT_ALL = r"""
import importlib, importlib.abc, importlib.util, pkgutil, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes"):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Refuse())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
assert hasattr(smoke, "main")
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "repro", "ml_dtypes")]
assert not bad, bad
print(len(names), "modules")
"""


def test_port_and_smoke_import_without_jax_or_reference():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL,
                          str(ROOT / "chip_smoke.py")], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[0]) >= 8


def test_no_source_line_imports_jax_or_reference():
    pattern = re.compile(r"^\s*(import|from) (jax|repro|ml_dtypes)\b")
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{f}:{n}" for f in files
            for n, line in enumerate(f.read_text().splitlines(), 1)
            if pattern.match(line)]
    assert not hits, hits


def _refuse(*args, **kwargs):
    raise RuntimeError("kernel loader unavailable")


def test_cuda_dispatch_propagates_loader_errors(monkeypatch):
    monkeypatch.setattr(_build, "load", _refuse)
    before = dict(TK.LAUNCHES)
    u, v, w = (torch.zeros((1, 4, 8, 8)) for _ in range(3))
    p = TK._slot_params(TREF.default_params(8, device="cpu"), 1, 8, "cpu")
    with pytest.raises(RuntimeError, match="kernel loader unavailable"):
        TK._advect_fused_cuda(u, v, w, p, 2, 0.01, torch.ones(4),
                              torch.ones(8), None)
    with pytest.raises(RuntimeError, match="kernel loader unavailable"):
        TK._finite_guard_cuda(u, v, w)
    p1 = TK._slot_params(TREF.default_params(8, device="cpu"), None, 8, "cpu")
    for name in ("advect_blocked", "advect_dataflow", "advect_wide"):
        with pytest.raises(RuntimeError, match="kernel loader unavailable"):
            TK._advect_rung_cuda(name, u[0], v[0], w[0], p1, None, True, 0.01)
    assert TK.LAUNCHES == before


def test_cpu_tensors_take_the_plain_version_without_launching(monkeypatch):
    monkeypatch.setattr(_build, "load", _refuse)
    before = dict(TK.LAUNCHES)
    u, v, w = (torch.ones((4, 8, 8)) for _ in range(3))
    p = TREF.default_params(8, device="cpu")
    TK.advect_fused(u, v, w, p, T=2, guard=True)
    TK.advect_fused(u, v, w, p, T=2, y_tile=3, tiling="host")
    for fn in (TK.advect_blocked, TK.advect_dataflow, TK.advect_wide):
        fn(u, v, w, p, fuse_update=True)
    TK.advect_dataflow(u, v, w, p, y_tile=3, tiling="host")
    assert TK.LAUNCHES == before


def test_build_key_follows_sources_and_flags(monkeypatch):
    key = _build._digest()
    assert re.fullmatch(r"[0-9a-f]{16}", key)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build._digest() != key
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "--fmad=false" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_nonzero_cuda_error_raises():
    _build.check(0, "fn")
    with pytest.raises(RuntimeError, match="fn: CUDA error 700"):
        _build.check(700, "fn")


def test_build_key_follows_the_shared_header(monkeypatch, tmp_path):
    """The rung kernels include `pw_source.cuh`: editing it rebuilds."""
    key = _build._digest()
    for name in _build.SOURCES + _build.HEADERS:
        (tmp_path / name).write_bytes((_build.CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build._digest() == key
    header = tmp_path / "pw_source.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build._digest() != key


def test_every_op_cuda_route_raises_the_loader_error(monkeypatch):
    """Each `repro_torch` op's CUDA implementation loads the kernels before
    it launches, and raises what the loader raises: no op falls back to
    its plain version."""
    from repro_torch.kernels import library as L
    from repro_torch.kernels.attention import attention as TA
    from repro_torch.kernels.ssm import ssm as TS
    from repro_torch.launch.mesh import make_stencil_mesh
    from repro_torch.stencil import spec as TSP

    monkeypatch.setattr(_build, "load", _refuse)
    before = dict(TK.LAUNCHES)
    u, v, w = (torch.zeros((1, 4, 8, 8)) for _ in range(3))
    p = TREF.default_params(8, device="cpu")
    xm, ym = torch.ones(4), torch.ones(8)
    spec = TSP.pw_advection_spec()
    pv = list(TK._spec_param_vectors(spec, p, "cpu"))
    mesh = make_stencil_mesh(2, 1, devices=["cpu"] * 2)
    shards = [tuple(f[0] for f in (u, v, w)) for _ in range(2)]
    slabs = TK.BandSlabs(mesh, (4, 8, 8), 1, 0)
    table = slabs.table("x", 0, shards)
    q = torch.zeros(1, 2, 16, 32)
    routes = {
        "advect_fused": lambda: TK._k1_cuda(u, v, w, *p, xm, ym, 2, 0.01,
                                            0),
        "advect_blocked": lambda: TK._k3_cuda(u[0], v[0], w[0], *p, 0,
                                              True, 0.01),
        "advect_dataflow": lambda: TK._k2_cuda(u[0], v[0], w[0], *p, 0,
                                               True, True, 0.01),
        "finite_guard": lambda: TK._k4_cuda(u, v, w),
        "stencil_fused": lambda: TK._k6_cuda([u, v, w], pv, xm, ym,
                                             TK.spec_handle(spec), 2, 0.01,
                                             0),
        "band_exchange": lambda: TK._k7_cuda(
            [f for trio in shards for f in trio],
            [f for trio in slabs.extended(0) for f in trio], slabs.words,
            table.handle, -1, False),
        "flash_attention": lambda: TA._k8_cuda(q, q, q, torch.empty_like(q),
                                               True, 0.2, 16, 16),
        "selective_scan": lambda: TS._k9_cuda(
            torch.zeros(1, 16, 32), torch.zeros(1, 16, 32),
            torch.zeros(1, 16, 8), torch.zeros(1, 16, 8),
            torch.zeros(32, 8), torch.zeros(1, 32, 8)),
    }
    assert set(routes) == set(L.OPS) - {"band_send"}
    for name, route in routes.items():
        with pytest.raises(RuntimeError, match="kernel loader unavailable"):
            route()
    assert TK.LAUNCHES == before
