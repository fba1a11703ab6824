"""Build and load the port's CUDA kernels.

`load()` compiles every `csrc/*.cu` with `nvcc` for `sm_90a` (one process
per source, all started together), links them into one shared library with
a plain C interface and opens it with `ctypes`. The library lands in
`build/<hash>/` beside this file, keyed by a hash of the sources and the
flags, so an edited source rebuilds and an unchanged one is reused. Only a
call that launches a kernel builds; importing the package never does.

Build needs `nvcc` (on PATH, or under `$CUDA_HOME/bin`). Never add
`--use_fast_math`: it changes the arithmetic and can compile `isfinite`
away. `--fmad=false` keeps every product and sum rounded on its own, as the
plain PyTorch versions round them; the f32 flash-attention kernel, held to
its plain version within a tolerance, writes its products as explicit
`fmaf`, and the bf16 one runs them on the tensor cores.

The library carries its own CUDA runtime, which launches on the calling
thread's current device: each wrapper makes its tensors' card current
(`torch.cuda.device`) around its launch and passes that card's current
stream.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "build"
SOURCES = ("advect_fused.cu", "advect_fused_bf16.cu",
           "advect_fused_bf16_coef.cu", "finite_guard.cu",
           "advect_blocked.cu",
           "advect_dataflow.cu", "stencil_fused.cu", "stencil_fused_bf16.cu",
           "stencil_fused_bf16_coef.cu", "flash_attention.cu",
           "flash_attention_tc.cu", "selective_scan.cu", "band_exchange.cu")
HEADERS = ("advect_fused.cuh", "cells.cuh", "pw_source.cuh",
           "stencil_fused.cuh", "stencil_ops.cuh")
# K6 of one user-written spec (`stencil.spec_cuda`): its entry source, built
# apart with the generated functor as `K6_GENERATED_HEADER`
GENERATED_SOURCE = "stencil_generated.cu"
K6_GENERATED_HEADER = "k6_generated_op.cuh"
# K1 (`csrc/advect_fused.cuh`) is built for T in 1..K1_MAX_T, by cells per
# thread: the threads per block each build runs (its launch bound). The
# flags below hand both to the source; its launch planner reads them here.
K1_MAX_T = 8
K1_BUILDS = {2: 512, 4: 384, 8: 256}
# K6 (`csrc/stencil_fused.cuh`) is built for 1..K6_MAX_LEVELS ring levels a
# pass (stages * T), and by (functor id, stages) for 2 and 4 cells per
# thread, each at the threads per block given here (its launch bound). Its
# register ring holds 2 * fields * levels * C floats a thread, so the
# tracer's four fields take fewer threads than PW's three. PW has no 4-cell
# build: at 256 threads (where its ring fits without spilling) it holds no
# slab that the 2-cell build at 512 does not. K6_COEF_VECTORS are the
# z-coefficient vectors of `spec.pack_params` each functor reads, by
# functor id: PW and tracer [tcx, tcy, tzc1(Z)] and [tcx, tcy, tzc2(Z)],
# diffusion [kx, ky, kz(Z)]. All three reach the source as the header
# `k6_table()` writes into the build, whose static_asserts hold the
# vectors to each functor's kVectors; the spec launch planner reads them
# here. Each storage build (f32; bf16 fields with f32 coefficients; both
# bf16) has its own entry source, compiled in parallel.
K6_MAX_LEVELS = 4
K6_BUILDS = {(0, 1): {2: 512}, (0, 2): {2: 512},
             (1, 1): {2: 384, 4: 256}, (1, 2): {2: 384, 4: 256},
             (2, 1): {2: 512, 4: 512}, (2, 2): {2: 512, 4: 512}}
K6_COEF_VECTORS = (2, 2, 1)
K6_HEADER = "k6_table.cuh"
NVCC_FLAGS = (("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               f"-DK1_MAX_T={K1_MAX_T}")
              + tuple(f"-DK1_THREADS_C{c}={n}" for c, n in K1_BUILDS.items()))
LIB_NAME = "librepro_torch_kernels.so"
LOG_NAME = "nvcc.log"

_P, _I, _F, _LL, _ULL, _SZ = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_float, ctypes.c_longlong,
                              ctypes.c_ulonglong, ctypes.c_size_t)
SIGNATURES = {
    "advect_fused_f32": [_P] * 9 + [_I] * 19 + [_F, _SZ, _P],
    "advect_fused_attrs": [_I, _I, _I, _SZ, _P],
    "advect_fused_bf16": [_P] * 9 + [_I] * 19 + [_F, _SZ, _P],
    "advect_fused_bf16_attrs": [_I, _I, _I, _SZ, _P],
    "advect_fused_bf16_coef": [_P] * 9 + [_I] * 19 + [_F, _SZ, _P],
    "advect_fused_bf16_coef_attrs": [_I, _I, _I, _SZ, _P],
    "finite_guard_f32": [_P] * 4 + [_I, _I, _LL, _I, _P],
    "finite_guard_bf16": [_P] * 4 + [_I, _I, _LL, _I, _P],
    "advect_blocked_f32": [_P] * 7 + [_I] * 9 + [_F, _SZ, _P],
    "advect_blocked_attrs": [_I, _SZ, _P],
    "advect_blocked_bf16": [_P] * 7 + [_I] * 10 + [_F, _SZ, _P],
    "advect_blocked_bf16_attrs": [_I, _I, _SZ, _P],
    "advect_dataflow_f32": [_P] * 7 + [_I] * 11 + [_F, _SZ, _P],
    "advect_dataflow_attrs": [_I, _I, _SZ, _P],
    "advect_dataflow_bf16": [_P] * 7 + [_I] * 12 + [_F, _SZ, _P],
    "advect_dataflow_bf16_attrs": [_I, _I, _I, _SZ, _P],
    "stencil_fused_f32": ([_I] * 2 + [_P] * 9 + [_I, _P, _P] + [_I] * 18
                          + [_F, _SZ, _P]),
    "stencil_fused_attrs": [_I] * 5 + [_SZ, _P],
    "stencil_fused_bf16": ([_I] * 2 + [_P] * 9 + [_I, _P, _P] + [_I] * 18
                           + [_F, _SZ, _P]),
    "stencil_fused_bf16_attrs": [_I] * 5 + [_SZ, _P],
    "stencil_fused_bf16_coef": ([_I] * 2 + [_P] * 9 + [_I, _P, _P]
                                + [_I] * 18 + [_F, _SZ, _P]),
    "stencil_fused_bf16_coef_attrs": [_I] * 5 + [_SZ, _P],
    "flash_attention_fwd": [_P] * 4 + [_LL] * 12 + [_I] * 9 + [_F, _SZ, _P],
    "flash_attention_tc_fwd": [_P] * 4 + [_LL] * 12 + [_I] * 7 + [_F, _P],
    "flash_attention_tc_attrs": [_I, _P],
    "selective_scan_fwd": [_I] * 2 + [_P] * 8 + [_I] * 6 + [_SZ, _P],
    "selective_scan_attrs": [_I] * 5 + [_SZ, _P],
    "band_exchange_enter": [_P, _I, _P],
    "band_exchange_put": [_P, _I, _LL, _I, _P, _I, _I, _P, _ULL, _LL, _P],
    "band_exchange_wait": [_P, _ULL, _LL, _P],
    "band_exchange_attrs": [_P],
    "band_exchange_enable_peer": [_I, _I],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; the "
                       "port's CUDA kernels are built by nvcc at first use")


def k6_table() -> str:
    """K6's build table as the header `csrc/stencil_fused.cuh` includes
    (`K6_HEADER`): K6_MAX_LEVELS, one X(op, stages, C, threads) of
    K6_BUILDS(X) per build and one X(op, vectors) of K6_COEF_VECTORS(X)
    per functor."""
    builds = " ".join(f"X({op}, {stages}, {c}, {n})"
                      for (op, stages), table in K6_BUILDS.items()
                      for c, n in table.items())
    vectors = " ".join(f"X({op}, {n})" for op, n in enumerate(K6_COEF_VECTORS))
    return (f"// K6's build table, written by _build.py\n"
            f"#define K6_MAX_LEVELS {K6_MAX_LEVELS}\n"
            f"#define K6_BUILDS(X) {builds}\n"
            f"#define K6_COEF_VECTORS(X) {vectors}\n")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(k6_table().encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (in parallel) and link the library; return its
    path. Reuses a library already built from the same sources."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        (Path(tmp) / K6_HEADER).write_text(k6_table())
        objs = [Path(tmp) / (name + ".o") for name in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", tmp, "-c",
                                   str(CSRC / name), "-o", str(obj)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for name, obj in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        log = "".join(f"== {n}\n{text}" for n, text in zip(SOURCES, logs))
        (out_dir / LOG_NAME).write_text(log)
        failed = [n for n, p in zip(SOURCES, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run([nvcc, "-shared", *map(str, objs), "-o",
                               str(tmp_lib)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        os.replace(tmp_lib, lib)
    return lib


def build_log() -> str:
    """The compiler's output (ptxas registers/shared memory per kernel) of
    the current build, or "" when none was made yet."""
    path = BUILD_ROOT / _digest() / LOG_NAME
    return path.read_text() if path.exists() else ""


@functools.cache
def load() -> ctypes.CDLL:
    """The built library with every C entry point's signature declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise when a C entry point returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


# --- K6 for user-written specs ------------------------------------------------

GENERATED_SIGNATURES = {
    "k6_generated": SIGNATURES["stencil_fused_f32"],
    "k6_generated_attrs": SIGNATURES["stencil_fused_attrs"],
}


def generated_flags(stages: int, bf16: bool, coef: bool,
                    threads: dict) -> Tuple[str, ...]:
    """The nvcc flags of one generated K6 build: the library's, its
    integrator's stages, its storage (bf16 fields, bf16 coefficients) and
    the launch bound of its 2- and 4-cell builds (0: none)."""
    return NVCC_FLAGS + (f"-DK6G_STAGES={stages}", f"-DK6G_BF16={int(bf16)}",
                         f"-DK6G_COEF_BF16={int(bf16 and coef)}",
                         f"-DK6G_THREADS_C2={threads.get(2, 0)}",
                         f"-DK6G_THREADS_C4={threads.get(4, 0)}")


def generated_digest(text: str, flags) -> str:
    """The key of a generated build: its functor's text, its flags, the
    K6 table and every source and header it compiles."""
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(text.encode())
    h.update(k6_table().encode())
    for name in (GENERATED_SOURCE,) + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _generated_dir(text: str, flags) -> Path:
    return BUILD_ROOT / f"k6g-{generated_digest(text, flags)}"


def build_generated(jobs) -> List[Path]:
    """Compile generated K6 builds, each ``(functor text, flags)``, all at
    once (one nvcc each, started together), each into
    `build/k6g-<digest>/`; reuses a build made before. Returns the
    libraries' paths in the order of `jobs`."""
    libs = [_generated_dir(text, flags) / LIB_NAME for text, flags in jobs]
    todo = [(job, lib) for job, lib in zip(jobs, libs) if not lib.exists()]
    if not todo:
        return libs
    nvcc = _nvcc()
    running = []
    for (text, flags), lib in todo:
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = Path(tempfile.mkdtemp(dir=lib.parent))
        (tmp / K6_HEADER).write_text(k6_table())
        (tmp / K6_GENERATED_HEADER).write_text(text)
        out = tmp / LIB_NAME
        running.append((lib, tmp, out, subprocess.Popen(
            [nvcc, *flags, "-I", str(tmp), "-shared",
             str(CSRC / GENERATED_SOURCE), "-o", str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for lib, tmp, out, proc in running:
        log = proc.communicate()[0]
        (lib.parent / LOG_NAME).write_text(log)
        if proc.returncode != 0:
            failed.append(f"{lib.parent.name}:\n{log}")
        else:
            os.replace(out, lib)
        shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        raise RuntimeError("nvcc failed on generated K6 builds:\n"
                           + "\n".join(failed))
    return libs


@functools.lru_cache(maxsize=None)
def load_generated(text: str, flags: Tuple[str, ...]) -> ctypes.CDLL:
    """The generated K6 build of `text` at `flags` (`generated_flags`),
    built at first use, with its entry points' signatures declared."""
    lib = ctypes.CDLL(str(build_generated([(text, flags)])[0]))
    for name, argtypes in GENERATED_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
