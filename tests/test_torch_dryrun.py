"""The port's dry run (`launch.dryrun`) and its report (`launch.report`) on
the CPU: `run_cell` on the smoke configs of a dense, a MoE and an ssm model
(train, prefill and decode at small shapes) over a (2, 2) fake mesh, in
child processes (one an arch) that hold the fake process group. Each record has the
reference's keys (with `trace_s` for `compile_s` and `fits_80g` for
`fits_16g`); one cell's argument bytes equal a count by hand; the report's
three tables render the records."""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch import pspec
from repro_torch.config import RunShape
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.sharding import make_rules, spec_for
from repro_torch.launch import dryrun as TDR
from repro_torch.launch import report as RP
from repro_torch.launch import specs as TSP
from repro_torch.models import model as TM

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen3-32b", "arctic-480b", "falcon-mamba-7b")
KINDS = ("train", "prefill", "decode")
MESH = (2, 2)
SMALL = {k: RunShape(f"{k}_small", k, 32, 4) for k in KINDS}

CHILD = r"""
import json, sys
from pathlib import Path
from repro_torch.config import RunShape
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun as D
out, arch = Path(sys.argv[1]), sys.argv[2]
for kind in %(kinds)r:
    shape = RunShape(kind + "_small", kind, 32, 4)
    rec = D.run_cell(arch, kind + "_small", multi_pod=False,
                     get_cfg=get_smoke_config, mesh_shape=%(mesh)r,
                     shape=shape, tag="smoke")
    (out / f"{arch}__{kind}.json").write_text(json.dumps(rec))
print("done")
""" % {"kinds": KINDS, "mesh": MESH}

RECORD_KEYS = {"arch", "shape", "mesh", "multi_pod", "n_chips", "tag",
               "exec", "trace_s", "memory", "census_full",
               "collectives_full_unscaled", "cost", "roofline",
               "core_io_bytes", "roofline_kernel_adjusted",
               "roofline_streaming"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "alias_size_in_bytes",
               "generated_code_size_in_bytes", "resident_bytes_per_dev",
               "fits_80g"}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The cells' records, one child interpreter an arch, the three at
    once (each holds its own fake group)."""
    out = tmp_path_factory.mktemp("dryrun_torch")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    kids = [subprocess.Popen([sys.executable, "-c", CHILD, str(out), arch],
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for arch in ARCHS]
    for kid in kids:
        _, err = kid.communicate(timeout=600)
        assert kid.returncode == 0, err[-4000:]
    return out, {(r["arch"], r["shape"].split("_")[0]): r
                 for r in (json.loads(f.read_text())
                           for f in sorted(out.glob("*.json")))}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", KINDS)
def test_record_has_the_reference_keys(records, arch, kind):
    rec = records[1][(arch, kind)]
    assert set(rec) == RECORD_KEYS
    assert set(rec["memory"]) == MEMORY_KEYS
    assert rec["mesh"] == "2x2" and rec["n_chips"] == 4
    assert rec["memory"]["fits_80g"] is True
    cost = rec["cost"]
    assert set(cost) == {"flops", "bytes", "pod", "cross_pod", "per_layer",
                         "const", "census_2l", "core"}
    assert cost["flops"] > 0 and cost["bytes"] > 0
    assert cost["core"]["flops"] >= 0 and cost["cross_pod"] == 0
    assert rec["census_full"].get("dot", 0) > 0
    for key in ("roofline", "roofline_kernel_adjusted",
                "roofline_streaming"):
        assert rec[key]["flops_per_dev"] == cost["flops"]
        assert rec[key]["bound"] in ("compute", "memory", "collective")
    if kind == "train":
        # the state is updated in place and returned
        assert rec["memory"]["alias_size_in_bytes"] > 0
    if kind != "prefill" or arch != "falcon-mamba-7b":
        # data is split over 2 ranks and the model over 2: collectives run
        assert rec["collectives_full_unscaled"]


def _local_bytes(spec, rules, mesh) -> int:
    """One rank's bytes of a (shape, logical axes) leaf, counted from the
    PartitionSpec: each dimension divided by its mesh axes' sizes."""
    part = spec_for(spec.shape, spec.axes, rules, mesh)
    n = 1
    for dim, entry in zip(spec.shape, part):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        n *= dim // math.prod(mesh.shape[a] for a in axes)
    size = {"float32": 4, "bfloat16": 2, "int32": 4}[spec.dtype]
    return n * size


class _Mesh:
    shape = {"data": MESH[0], "model": MESH[1]}


@pytest.mark.parametrize("arch", ["qwen3-32b", "falcon-mamba-7b"])
def test_argument_bytes_equal_a_count_by_hand(records, arch):
    """The prefill cell's arguments: every parameter's block and the
    token batch's (4 x 32 int32 split over "data")."""
    rec = records[1][(arch, "prefill")]
    cfg = TDR.exec_policy(get_smoke_config(arch), SMALL["prefill"])
    rules = make_rules(multi_pod=False, shape_kind="prefill",
                       seq_parallel=cfg.seq_parallel)
    layout = TM.make_layout(cfg, MESH[1])
    by_hand = sum(_local_bytes(s, rules, _Mesh)
                  for s in pspec.tree_leaves(TM.param_specs(cfg, layout)))
    specs, _ = TSP.input_specs(cfg, SMALL["prefill"])
    by_hand += sum(_local_bytes(pspec.ParamSpec(
        s.shape, ("batch",) + (None,) * (len(s.shape) - 1), s.dtype),
        rules, _Mesh) for s in specs.values())
    assert rec["memory"]["argument_size_in_bytes"] == by_hand
    assert rec["memory"]["resident_bytes_per_dev"] >= by_hand
    assert rec["memory"]["temp_size_in_bytes"] == \
        rec["memory"]["resident_bytes_per_dev"] - by_hand


def test_decode_aliases_its_caches(records):
    rec = records[1][("qwen3-32b", "decode")]
    cfg = TDR.exec_policy(get_smoke_config("qwen3-32b"), SMALL["decode"])
    rules = make_rules(multi_pod=False, shape_kind="decode")
    layout = TM.make_layout(cfg, MESH[1])
    caches = TSP.decode_cache_abstract(cfg, layout, SMALL["decode"])
    assert rec["memory"]["alias_size_in_bytes"] == sum(
        _local_bytes(s, rules, _Mesh) for s in pspec.tree_leaves(caches))


def test_report_renders_the_records(records):
    out, _ = records
    recs = RP.load("smoke", out)
    assert len(recs) == len(ARCHS) * len(KINDS)
    md = RP.render(recs, "smoke")
    assert "fit in 80 GB/dev: 9/9" in md
    for arch in ARCHS:
        assert md.count(f"| {arch} |") == 2 * len(KINDS)
    table = RP.roofline_table(recs)
    assert "fake trace" in table and "nan" not in table.split("\n")[2]
    assert "ERROR" not in RP.dryrun_table(recs)
