"""The port's GPipe pipeline (`distributed.pipeline`) on gloo ranks, on
the CPU: `pipeline_apply` over 2 and 4 stages equals the sequential
layer stack bitwise (each layer runs the same operations on the same
inputs, whichever stage runs it), over the whole world and over one axis
of a `DeviceMesh`; `bubble_fraction` equals the reference's.

`run_ranks` (also used by the sharded-step and compression tests) starts
one interpreter a rank, each on a `FileStore` under the test's tmp_path,
so that concurrent test workers never share a port."""
import os
import subprocess
import sys
import textwrap

import pytest

from repro.distributed.pipeline import bubble_fraction as j_bubble
from repro_torch.distributed.pipeline import bubble_fraction

RANK_PRELUDE = textwrap.dedent("""
    import os
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD"])
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.environ["STORE"], WORLD),
        rank=RANK, world_size=WORLD)
    OUT = {}
""")
RANK_EPILOGUE = textwrap.dedent("""
    torch.save(OUT, os.environ["OUT"])
    dist.destroy_process_group()
""")


def start_ranks(code: str, world: int, tmp_path, tag: str,
                env: dict = None) -> tuple:
    """Start `code` in `world` gloo ranks at once (`RANK`, `WORLD`, a
    process group and a dict `OUT` are set up; `OUT` is saved with
    `torch.save` at the end; `env` adds variables). Returns a handle for
    `collect_ranks`."""
    src = RANK_PRELUDE + textwrap.dedent(code) + RANK_EPILOGUE
    base = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1",
                WORLD=str(world), STORE=str(tmp_path / f"store_{tag}"),
                **(env or {}))
    procs = []
    for r in range(world):
        out = tmp_path / f"out_{tag}_{r}.pt"
        procs.append((subprocess.Popen(
            [sys.executable, "-c", src], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
            env=dict(base, RANK=str(r), OUT=str(out))), out))
    return tag, procs


def collect_ranks(handle, timeout: int = 300) -> list:
    """Each rank's `OUT` of a `start_ranks` handle; a rank that fails or
    outlives `timeout` seconds raises with its stderr."""
    import torch
    tag, procs = handle
    results, errors = [], []
    for r, (p, out) in enumerate(procs):
        try:
            _, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q, _ in procs:
                q.kill()
            raise AssertionError(f"rank {r} of {tag} timed out")
        if p.returncode != 0:
            errors.append(f"rank {r} of {tag} exited {p.returncode}:\n"
                          f"{err[-3000:]}")
        else:
            results.append(torch.load(out, weights_only=False))
    assert not errors, "\n".join(errors)
    return results


def run_ranks(code: str, world: int, tmp_path, tag: str, env: dict = None,
              timeout: int = 300) -> list:
    """`start_ranks` then `collect_ranks`."""
    return collect_ranks(start_ranks(code, world, tmp_path, tag, env),
                         timeout)


PIPELINE = """
    from repro_torch.distributed.pipeline import pipeline_apply
    rng = np.random.default_rng(0)
    L, D, n_micro, B = 8, 16, 6, 4
    params = {"w": torch.as_tensor(rng.normal(size=(L, D, D)) * 0.3,
                                   dtype=torch.float32),
              "b": torch.as_tensor(rng.normal(size=(L, D)) * 0.1,
                                   dtype=torch.float32)}
    block = lambda p, x: torch.tanh(x @ p["w"] + p["b"])
    xs = torch.as_tensor(rng.normal(size=(n_micro, B, D)),
                         dtype=torch.float32)

    def seq(x):
        for i in range(L):
            x = block({k: v[i] for k, v in params.items()}, x)
        return x
    ref = torch.stack([seq(xs[i]) for i in range(n_micro)])
    out = pipeline_apply(params, xs, block)
    OUT["world_equal"] = torch.equal(out, ref)
    OUT["world_max_err"] = float((out - ref).abs().max())
    if WORLD == 4:
        # two stages over the "pod" axis of a (2, 2) mesh, one pipeline a
        # "data" coordinate
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("pod", "data"))
        out = pipeline_apply(params, xs, block, mesh, axis="pod")
        OUT["mesh_equal"] = torch.equal(out, ref)
        try:
            pipeline_apply({"w": params["w"][:6]}, xs, block)
        except ValueError:
            OUT["refused"] = True
"""


@pytest.mark.parametrize("world", [2, 4])
def test_pipeline_equals_sequential_stack_bitwise(tmp_path, world):
    outs = run_ranks(PIPELINE, world, tmp_path, f"pipe{world}")
    for r, o in enumerate(outs):
        assert o["world_equal"], (r, o["world_max_err"])
        if world == 4:
            assert o["mesh_equal"], r
            assert o["refused"], r    # 6 layers do not split into 4 stages


@pytest.mark.parametrize("n_stage,n_micro", [(1, 4), (2, 6), (4, 6),
                                             (4, 16), (16, 64)])
def test_bubble_fraction_equals_reference(n_stage, n_micro):
    assert bubble_fraction(n_stage, n_micro) == j_bubble(n_stage, n_micro)
