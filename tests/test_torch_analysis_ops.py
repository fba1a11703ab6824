"""Every hand kernel is a `repro_torch` op (`kernels.library`): defined with
a flat schema and CPU, CUDA and fake implementations. On CPU tensors the op
runs the kernel's plain version (the same values the wrappers returned
before they called ops); under `FakeTensorMode` its fake implementation
gives outputs of the real ones' shape, dtype, device and strides, on CPU
tensors and on fake CUDA ones, touching no card; the mutating ops declare
what they write."""
import pytest
import torch

from repro_torch.analysis import programs as PR
from repro_torch.analysis import trace as TR
from repro_torch.kernels import library as L
from repro_torch.kernels.advection import advection as TK
from repro_torch.kernels.advection.ref import default_params
from repro_torch.kernels.attention import attention as TA
from repro_torch.kernels.ssm import ssm as TS
from repro_torch.launch import mesh as TM
from repro_torch.stencil import spec as TSP

DT = 0.01
KERNEL_OPS = ("advect_fused", "advect_blocked", "advect_dataflow",
              "finite_guard", "stencil_fused", "band_exchange",
              "flash_attention", "selective_scan")


def test_the_nine_kernels_are_ops():
    assert set(L.OPS) == set(KERNEL_OPS) | {"band_send"}
    for name in L.OPS:
        op = getattr(torch.ops.repro_torch, name).default
        assert L.op_name(op) == name
        for key in ("CPU", "CUDA", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(
                f"repro_torch::{name}", key), (name, key)
    writes = {name: [a.name for a in getattr(torch.ops.repro_torch, name)
                     .default._schema.arguments
                     if a.alias_info is not None and a.alias_info.is_write]
              for name in L.OPS}
    assert writes == {**{n: [] for n in L.OPS},
                      "band_exchange": ["regions", "words"],
                      "flash_attention": ["out"]}
    with pytest.raises(ValueError, match="already defined"):
        L.define("advect_fused", "(Tensor u) -> Tensor", kind="field",
                 cpu=None, cuda=None, fake=None)


def cases():
    """(name, call(device)) of every kernel op at a probe shape."""
    shape = (6, 10, 16)
    p = default_params(16, device="cpu")

    def fields(device, n=3, shape=shape, dtype=torch.float32):
        return PR.place(PR._fields(shape, n), device)

    def k1(device):
        ps = PR.place(p, device)
        xm, ym = PR.place((torch.ones(6), torch.ones(10)), device)
        u, v, w = (f[None] for f in fields(device))
        return TK._OP_K1(u, v, w, *ps, xm, ym, 2, DT, 0)

    def rung(op, *flags):
        def call(device):
            return op(*fields(device), *PR.place(p, device), 0, *flags,
                      True, DT)
        return call

    def k4(device):
        return TK._OP_K4(*(f[None] for f in fields(device)))

    def k6(device):
        spec = TSP.tracer_advection_spec("rk2")
        pv = list(PR.place(tuple(spec.pack_params(p)), device))
        xm, ym = PR.place((torch.ones(6), torch.ones(10)), device)
        return TK._OP_K6([f[None] for f in fields(device, 4)], pv, xm, ym,
                         TK.spec_handle(spec), 2, DT, 0)

    def k8(device):
        q, k, v = (f.to(torch.bfloat16) for f in
                   fields(device, 1, (1, 4, 128, 32)) + fields(
                       device, 2, (1, 2, 128, 32)))
        out = torch.empty_like(q)
        TA._OP_K8(q, k, v, out, True, 32 ** -0.5, 128, 128)
        return out

    def k9(device):
        xc, dt = fields(device, 2, (1, 16, 32))
        Bm, Cm = fields(device, 2, (1, 16, 8))
        return TS._OP_K9(xc, dt.abs() * 0.1, Bm, Cm,
                         -PR.place(torch.ones(32, 8), device),
                         PR.place(torch.zeros(1, 32, 8), device))

    def send(device):
        return L.band_send(fields(device, 1)[0], device, 0)

    return [("advect_fused", k1),
            ("advect_blocked", rung(TK._OP_K3)),
            ("advect_dataflow", rung(TK._OP_K2, False)),
            ("advect_dataflow_wide", rung(TK._OP_K2, True)),
            ("finite_guard", k4), ("stencil_fused", k6),
            ("flash_attention", k8), ("selective_scan", k9),
            ("band_send", send)]


def metas(out):
    return [(m.shape, m.dtype, m.device, m.stride)
            for m in TR._results(out)]


@pytest.mark.parametrize("name,call", cases(), ids=[c[0] for c in cases()])
def test_fake_outputs_have_the_real_ones_metadata(name, call):
    real = call("cpu")
    with TR.fake_mode():
        fake_cpu = call("cpu")
        fake_cuda = call("cuda")
    assert metas(fake_cpu) == metas(real)
    assert [m[:2] + (m[3],) for m in metas(fake_cuda)] == \
        [m[:2] + (m[3],) for m in metas(real)]
    assert {m[2] for m in metas(fake_cuda)} == {"cuda:0"}


def test_cpu_ops_equal_the_plain_versions_bitwise():
    shape = (6, 10, 16)
    p = default_params(16, device="cpu")
    u, v, w = PR._fields(shape)
    ones = (torch.ones(6), torch.ones(10))
    got = TK.advect_fused(u, v, w, p, T=3, dt=DT)
    want = TK._advect_fused_plain(u[None], v[None], w[None], p, 3, DT, *ones)
    assert all(torch.equal(a, b[0]) for a, b in zip(got, want))
    deep = TK.advect_fused(u, v, w, p, T=11, dt=DT)   # two passes
    want = TK._advect_fused_plain(u[None], v[None], w[None], p, 11, DT,
                                  *ones)
    assert all(torch.equal(a, b[0]) for a, b in zip(deep, want))
    spec = TSP.pw_advection_spec("rk2")
    got = TK.stencil_fused((u, v, w), p, spec, T=5, dt=DT)   # three passes
    pv = TK._spec_param_vectors(spec, p, "cpu")
    want = TK._stencil_fused_plain([f[None] for f in (u, v, w)], pv, spec, 5,
                                   DT, *ones)
    assert all(torch.equal(a, b[0]) for a, b in zip(got, want))
    q = torch.randn(1, 4, 64, 32)
    k, vv = torch.randn(2, 1, 2, 64, 32)
    assert torch.equal(TA.flash_attention(q, k, vv, block_q=32, block_k=32),
                       TA._flash_attention_plain(q, k, vv, True, 32 ** -0.5))


def test_k7_op_writes_the_slabs_and_sends_through_band_send():
    mesh = TM.make_stencil_mesh(2, 1, devices=["cpu"] * 2)
    shards = [PR._fields((4, 6, 8), seed=s) for s in range(2)]
    slabs = TK.BandSlabs(mesh, (4, 6, 8), 2, 0)
    records = TR.record_ops(TK.halo_band_exchange_dma, shards, mesh=mesh,
                            axis="x", depth=2, dim=0, slabs=slabs,
                            execute=True)
    ops = [r for r in records if r.op]
    assert [r.op for r in ops] == ["band_exchange"]
    assert ops[0].mutated == ("regions", "words")
    assert ops[0].extra["in_place"] is False
    assert len(ops[0].extra["messages"]) == 2 * 3 * 2
    assert TK.BAND_TABLES[ops[0].arg("table")].slabs is slabs
    for s, trio in enumerate(shards):
        for f, own in zip(trio, slabs.interior(0)[s]):
            assert torch.equal(f, own)
    # the plain version alone sends each band through band_send
    sends = TR.record_ops(TK._band_exchange_plain, shards, slabs,
                          slabs.table("x", 1, shards), execute=True)
    assert sum(r.op == "band_send" for r in sends) == 12


def test_refuse_grad_stays_in_front_of_k8_and_k9():
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="flash_attention \\(K8\\) is "
                       "forward-only"):
        TA.flash_attention(q, q, q)
    x = torch.randn(1, 8, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="selective_scan \\(K9\\) is "
                       "forward-only"):
        TS.selective_scan(x, x, torch.randn(1, 8, 4), torch.randn(1, 8, 4),
                          torch.randn(16, 4), torch.zeros(1, 16, 4))


def test_a_runs_k7_buffers_go_with_it():
    """A `remote_dma` run's extended buffers are freed when the run is
    dropped, with no help from the cycle collector: K7's tables hold
    their slabs weakly (they once held them back, a cycle)."""
    import gc
    import weakref

    from repro_torch.stencil import distributed as TD
    mesh = TM.make_stencil_mesh(2, 2, devices=["cpu"] * 4)
    run = TD.make_distributed_run(mesh, default_params(32, device="cpu"),
                                  n_blocks=3, T=2, dt=DT,
                                  local_kernel="fused", exchange="remote_dma")
    shards = TD.shard(mesh, *PR._fields((16, 16, 32)))
    enabled = gc.isenabled()
    gc.disable()
    try:
        run(shards)
        block = next(c.cell_contents for c in run.__closure__
                     if isinstance(c.cell_contents, TD._LocalBlock))
        buf = weakref.ref(block.buffers.bufs[0])
        table = next(iter(block.slabs["x"]._tables.values()))
        assert table.slabs is block.slabs["x"]
        del block, run
        assert buf() is None
        with pytest.raises(ReferenceError, match="are gone"):
            table.slabs
    finally:
        if enabled:
            gc.enable()
