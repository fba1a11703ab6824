"""The port's movement ledger (`repro_torch.analysis.ledger`) against the
analytic models, its own counters, the JAX ledger and the reference's
coverage gate.

Every program of `analysis.programs` at probe sizes, traced on fake CUDA
tensors (no card, no kernel) and run live on the CPU (the ops' plain
versions): each category equals its model exactly, per shard and block on
the distributed runs, the coverage gate passes, and the two ledgers agree.
On the jnp `collective` exchange the JAX ledger (a child interpreter on 4
forced host devices) and the port's count the same wire and checksum
bytes per shard and block."""
import json
import textwrap

import pytest
import torch

from _subproc import run_ok
from repro.analysis import ledger as JL
from repro_torch.analysis import ledger as LG
from repro_torch.analysis import programs as PR
from repro_torch.analysis import trace as TR
from repro_torch.core import roofline as R
from repro_torch.kernels import library as L
from repro_torch.kernels.advection import advection as TK
from repro_torch.kernels.advection.ref import default_params
from repro_torch.launch import mesh as TM
from repro_torch.stencil import advection as TSA
from repro_torch.stencil import distributed as TD

DT = 0.01
PROGRAMS = {p.name: p for p in PR.programs(small=True)}


def ledger_of(prog, records):
    led = LG.MovementLedger.from_ops(records)
    if prog.per_block:
        return led.per_shard_block_totals(prog.n_shards)
    return led.totals()


def fake_records(prog):
    with TR.fake_mode():
        fn, args = prog.build("cuda")
        return TR.record_ops(fn, *args)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_fake_cuda_ledger_equals_models(name):
    prog = PROGRAMS[name]
    records = fake_records(prog)
    got = ledger_of(prog, records)
    for cat, want in prog.claims.items():
        assert got[cat] == want, (cat, got)
    report = LG.check_model_coverage(got, prog.claims)
    assert report.ok, [str(f) for f in report.failures]
    devices = {m.device for r in records if r.op for _, m in r.operands()}
    assert devices == {"cuda:0"}, devices
    ops = {}
    for r in records:
        if r.op not in (None, "band_send"):
            ops[r.op] = ops.get(r.op, 0) + 1
    assert ops == prog.launches


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_live_cpu_ledger_equals_fake_cuda_ledger(name):
    prog = PROGRAMS[name]
    fn, args = prog.build("cpu")
    live = ledger_of(prog, TR.record_ops(fn, *args, execute=True))
    assert live == ledger_of(prog, fake_records(prog))


def test_fake_trace_runs_no_kernel_and_needs_no_card(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a fake trace touched the kernel loader")
    monkeypatch.setattr(TK._build, "load", refuse)
    before = dict(TK.LAUNCHES)
    for prog in PROGRAMS.values():
        fake_records(prog)
    assert TK.LAUNCHES == before
    assert not torch.cuda.is_available()


def loopback(nx, ny):
    return TM.make_stencil_mesh(nx, ny, devices=["cpu"] * (nx * ny))


def step_and_shards(nx, ny, T, **kw):
    u, v, w = TSA.stratus_fields(8, 12, 8, seed=3, device="cpu")
    mesh = loopback(nx, ny)
    p = default_params(8, device="cpu")
    run = TD.make_distributed_run(mesh, p, n_blocks=3, T=T, dt=DT, **kw)
    return run, TD.shard(mesh, u, v, w)


# the counters' values on these configs, (wire, integrity) bytes per shard
# and block on the (8, 12, 8) grid, as the engines' own tallies counted
# them before the ledger did (either engine, a 3-block verified run)
COUNTED = {(2, 2, 2): (5376, 48), (1, 4, 4): (6144, 48),
           (4, 1, 3): (6912, 48)}


@pytest.mark.parametrize("nx,ny,T", sorted(COUNTED))
@pytest.mark.parametrize("exchange", TD.EXCHANGES)
def test_counters_keep_their_values(nx, ny, T, exchange):
    wire, words = COUNTED[nx, ny, T]
    assert wire == R.halo_wire_bytes_model(8, 12, 8, 4, nx=nx, ny=ny, T=T)
    assert words == R.integrity_bytes_model(8, 12, 8, nx=nx, ny=ny, T=T)
    run, shards = step_and_shards(nx, ny, T, exchange=exchange,
                                  verify_integrity=True)
    assert TD.count_exchange_wire_bytes(run, shards) == wire
    assert TD.count_integrity_bytes(run, shards) == words
    plain, _ = step_and_shards(nx, ny, T, exchange=exchange)
    assert TD.count_exchange_wire_bytes(plain, shards) == wire
    assert TD.count_integrity_bytes(plain, shards) == 0


@pytest.mark.parametrize("exchange", TD.EXCHANGES)
def test_pallas_and_guard_counters(exchange):
    run, shards = step_and_shards(2, 2, 2, exchange=exchange,
                                  local_kernel="fused")
    Xl, Yl = 4, 6
    want = TK.hbm_bytes_model(Xl + 4, Yl + 4, 8, 4, "fused", T=2)
    if exchange == "remote_dma":
        want += R.band_slab_bytes_model(8, 12, 8, 4, nx=2, ny=2, T=2)
    assert TD.count_pallas_hbm_bytes(run, shards) == want
    assert TD.count_guard_bytes(run, shards) == 0
    serve = PROGRAMS["serving"]
    fn, args = serve.build("cpu")
    parts = R.guard_bytes_model_parts(8, 16, 32, batch=4)
    assert TD.count_guard_bytes(fn, *args) == sum(parts.values())
    assert TD.count_pallas_hbm_bytes(fn, *args) == (
        serve.claims["pallas_hbm"] + parts["field_reads"])


def test_unequal_blocks_raise_not_average():
    """A driver that moves more in one block than another is refused."""
    fields = [torch.ones(2, 3, 4)]

    def drift(shards):
        for k in range(2):
            with L.scope(block=True):
                for _ in range(k + 1):
                    L.band_send(shards[0], "cpu", 0)

    led = LG.MovementLedger.record(drift, fields)
    assert led.total("ppermute_wire") == 3 * 96
    with pytest.raises(RuntimeError, match="different ppermute_wire"):
        led.per_shard_block("ppermute_wire", n_shards=1)
    with pytest.raises(RuntimeError, match="no substep-block scope"):
        LG.MovementLedger.record(lambda s: L.band_send(s[0], "cpu", 0),
                                 fields).per_shard_block("ppermute_wire",
                                                         n_shards=1)


def test_host_transfer_and_rejects_unknown_category():
    with TR.fake_mode():
        x = torch.empty(4, 5, 6, device="cuda")
        led = LG.MovementLedger.of(lambda t: t.cpu() * 2, x)
    assert led.totals()["host_transfer"] == 4 * 5 * 6 * 4
    report = LG.check_model_coverage(led, {})
    assert not report.ok and "unclaimed movement" in report.failures[0].reason
    with pytest.raises(KeyError, match="unknown movement category"):
        led.total("hbm")
    assert LG.CATEGORIES == JL.CATEGORIES


class _Totals:
    def __init__(self, counted):
        self.counted = counted

    def totals(self):
        return {c: self.counted.get(c, 0) for c in LG.CATEGORIES}


COVERAGE_CASES = [
    ({"pallas_hbm": 96, "pallas_control": 8}, {"pallas_hbm": 96}, None),
    ({"pallas_hbm": 96}, {"pallas_hbm": 95}, None),
    ({}, {"ppermute_wire": 10}, None),
    ({"psum": 4, "host_transfer": 8}, {}, None),
    ({"pallas_control": 8}, {"pallas_control": 8}, None),
    ({"pallas_hbm": 1}, {"pallas_hbm": 1, "vmem": 3}, None),
    ({"pallas_hbm": 1, "guard_flag_words": 4}, {"pallas_hbm": 1},
     ("pallas_control", "guard_flag_words")),
]


@pytest.mark.parametrize("counted,claims,unpriced", COVERAGE_CASES)
def test_coverage_report_equals_the_reference(counted, claims, unpriced):
    kw = {} if unpriced is None else {"unpriced": unpriced}
    want = JL.check_model_coverage(_Totals(counted), claims, **kw)
    got = LG.check_model_coverage(_Totals(counted), claims, **kw)
    assert got.ok == want.ok
    assert [(f.category, f.counted, f.claimed, f.reason)
            for f in got.failures] == [(f.category, f.counted, f.claimed,
                                        f.reason) for f in want.failures]
    assert got.counted == want.counted
    if not want.ok:
        with pytest.raises(LG.ModelCoverageError) as e_got:
            got.raise_if_failed()
        with pytest.raises(JL.ModelCoverageError) as e_want:
            want.raise_if_failed()
        assert str(e_got.value) == str(e_want.value)


JAX_LEDGER = textwrap.dedent("""
    import json, os
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.extend.core as xc
    # the pinned jax (0.4.37) keeps these in jax.core, where the walker
    # looks for them; later releases moved them to jax.extend.core
    for name in ("ClosedJaxpr", "Jaxpr", "Literal"):
        if not hasattr(jax.core, name):
            setattr(jax.core, name, getattr(xc, name))
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.analysis.ledger import MovementLedger
    from repro.stencil.distributed import make_distributed_run
    from repro.stencil.advection import stratus_fields
    from repro.kernels.advection.ref import default_params
    from repro.launch.mesh import make_stencil_mesh

    u, v, w = stratus_fields(8, 12, 8, seed=3)
    p = default_params(8)
    out = {}
    for nx, ny, T in MESHES:
        mesh = make_stencil_mesh(nx, ny)
        sh = NamedSharding(mesh, P("x", "y", None))
        args = [jax.device_put(t, sh) for t in (u, v, w)]
        for verify in (False, True):
            fn = make_distributed_run(
                mesh, p, n_blocks=3, axis="y", x_axis="x", T=T, dt=DT,
                local_kernel="reference", exchange="collective",
                interpret=True, verify_integrity=verify)
            t = MovementLedger.of(fn, *args).totals()
            out[f"{nx}x{ny}x{T}/{int(verify)}"] = [t["ppermute_wire"],
                                                   t["integrity_words"]]
    with open(OUT, "w") as f:
        json.dump(out, f)
    print("OK")
""")


def test_collective_ledger_equals_jax_ledger_per_shard_and_block(tmp_path):
    meshes = tuple(sorted(COUNTED))
    out = tmp_path / "ledger.json"
    run_ok(f"MESHES = {meshes!r}\nDT = {DT}\nOUT = {str(out)!r}\n"
           + JAX_LEDGER, timeout=300)
    jax_counts = json.loads(out.read_text())
    for nx, ny, T in meshes:
        for verify in (False, True):
            run, shards = step_and_shards(nx, ny, T, exchange="collective",
                                          verify_integrity=verify)
            led = LG.MovementLedger.record(run, shards)
            port = [led.per_shard_block(c, n_shards=nx * ny)
                    for c in ("ppermute_wire", "integrity_words")]
            assert port == jax_counts[f"{nx}x{ny}x{T}/{int(verify)}"], \
                (nx, ny, T, verify)
