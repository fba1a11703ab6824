"""The retrace detector (`repro_torch.analysis.retrace`) and the pass
registry: the fixture pair red and green, an inert knob, perturbation
validation, fingerprints blind to scalar values, and the port's
distributed drivers free of retrace on fake CUDA tensors (the block index
and `n_blocks` sharing one block's op stream, no launch cache growing per
block, `y_tile` changing K1's launch)."""
import pytest
import torch

from repro_torch import analysis as AN
from repro_torch.analysis import programs as PR
from repro_torch.analysis import trace as TR
from repro_torch.kernels.advection.ref import default_params
from repro_torch.launch import mesh as TM
from repro_torch.stencil import distributed as TD

DT = 0.01
BLOCKS = AN.Perturbation("block_index", (0, 1, 2, 3))


def test_static_parity_fixture_flagged_red():
    tables = {}
    report = AN.detect_retrace(
        lambda block_index: AN.make_static_parity_driver(block_index,
                                                         tables=tables),
        [BLOCKS], caches=lambda: {"tables": len(tables)}, execute=True)
    assert not report.ok
    assert [f.kind for f in report.findings] == ["leak"]
    assert "'tables' grew at each of the last two values" in \
        report.findings[0].detail
    with pytest.raises(AssertionError, match="retrace detector failed"):
        report.raise_if_failed()


def test_traced_parity_fixture_green():
    tables = {}
    report = AN.detect_retrace(
        lambda block_index: AN.make_traced_parity_driver(block_index,
                                                         tables=tables),
        [BLOCKS], caches=lambda: {"tables": len(tables)}, execute=True)
    assert report.ok, [str(f) for f in report.findings]
    assert len(set(report.fingerprints.values())) == 1


def test_static_value_in_the_stream_is_a_leak():
    """A knob that changes which ops run is named at the first op where
    the streams diverge."""
    def factory(parity):
        def step(u):
            return (u.roll(1, 1) if parity else u) * 0.5
        return step, (torch.zeros(4, 6, 8),)

    report = AN.detect_retrace(factory, [AN.Perturbation("parity", (0, 1))])
    assert [f.kind for f in report.findings] == ["leak"]
    assert "first divergence at op #0" in report.findings[0].detail


def test_inert_knob_detected():
    def factory(y_tile):
        return (lambda u: u * 2.0), (torch.zeros(4, 6, 8),)

    report = AN.detect_retrace(
        factory, [AN.Perturbation("y_tile", (None, 8), "distinct")])
    assert [f.kind for f in report.findings] == ["inert"]


def test_perturbation_validation():
    with pytest.raises(ValueError, match="expect must be"):
        AN.Perturbation("k", (1, 2), "maybe")
    with pytest.raises(ValueError, match=">= 2 values"):
        AN.Perturbation("k", (1,))


def test_driver_fingerprint_deterministic_and_scalar_insensitive():
    u = torch.zeros(4, 6, 8)
    a = AN.driver_fingerprint(lambda t: t * 0.5 + 1.0, u)
    assert a == AN.driver_fingerprint(lambda t: t * 0.5 + 1.0, u)
    assert a == AN.driver_fingerprint(lambda t: t * 3.0 + 7.0, u)
    assert a != AN.driver_fingerprint(lambda t: t * 0.5, u)
    assert a != AN.driver_fingerprint(lambda t: t * 0.5 + 1.0,
                                      torch.zeros(4, 6, 9))
    # a kernel op's launch configuration is part of the structure
    k1 = PR.grid_tiled_program(8, 16, 32, y_tile=4)
    k1_other = PR.grid_tiled_program(8, 16, 32, y_tile=8)
    prints = []
    with TR.fake_mode():
        for prog in (k1, k1, k1_other):
            fn, args = prog.build("cuda")
            prints.append(AN.driver_fingerprint(fn, *args))
    assert prints[0] == prints[1] != prints[2]


def cuda_mesh():
    return TM.make_stencil_mesh(2, 2, devices=["cuda:0"] * 4)


@pytest.mark.parametrize("exchange", TD.EXCHANGES)
def test_distributed_block_retrace_free(exchange):
    mesh = cuda_mesh()
    with TR.fake_mode():
        p = PR.place(default_params(32, device="cpu"), "cuda")
        shards = TD.shard(mesh, *PR.place(PR._fields((16, 16, 32)), "cuda"))
        block = TD._build_block(mesh, p, T=2, dt=DT, local_kernel="fused",
                                y_tile=None, overlap=False,
                                exchange=exchange, verify_integrity=False,
                                corrupt_halo=None, spec=None,
                                spec_params=None)
        for k in (0, 1):
            block(shards, k)
        report = AN.detect_retrace(
            lambda dma_block_index: ((lambda sh: block(sh, dma_block_index)),
                                     (shards,)),
            [AN.Perturbation("dma_block_index", (2, 3, 4, 5))],
            caches=lambda: AN.launch_cache_sizes(block))
    assert report.ok, [str(f) for f in report.findings]
    sizes = AN.launch_cache_sizes(block)
    assert sizes["block0.shard_masks"] == 4
    assert sizes["block0.band_tables"] == (4 if exchange == "remote_dma"
                                           else 0)


@pytest.mark.parametrize("exchange", TD.EXCHANGES)
def test_distributed_run_knobs(exchange):
    mesh = cuda_mesh()

    def factory(n_blocks=3, y_tile=None):
        p = PR.place(default_params(32, device="cpu"), "cuda")
        shards = TD.shard(mesh, *PR.place(PR._fields((16, 16, 32)), "cuda"))
        run = TD.make_distributed_run(mesh, p, n_blocks=n_blocks, T=2,
                                      dt=DT, local_kernel="fused",
                                      y_tile=y_tile, exchange=exchange)
        return run, (shards,)

    with TR.fake_mode():
        report = AN.detect_retrace(
            factory, [AN.Perturbation("n_blocks", (3, 5)),
                      AN.Perturbation("y_tile", (None, 4), "distinct")])
    assert report.ok, [str(f) for f in report.findings]


def test_a_block_rebuilding_its_tables_is_flagged():
    """The real driver with its K7 tables rebuilt at every block, not once
    per slot: the count of tables built grows every block, and the
    detector says so."""
    mesh = cuda_mesh()
    with TR.fake_mode():
        p = PR.place(default_params(32, device="cpu"), "cuda")
        shards = TD.shard(mesh, *PR.place(PR._fields((16, 16, 32)), "cuda"))
        block = TD._build_block(mesh, p, T=2, dt=DT, local_kernel="fused",
                                y_tile=None, overlap=False,
                                exchange="remote_dma",
                                verify_integrity=False, corrupt_halo=None,
                                spec=None, spec_params=None)

        def leaky(sh, k):
            for slabs in block.slabs.values():
                slabs._tables.clear()     # the bug: rebuilt per block
            return block(sh, k)

        for k in (0, 1):
            block(shards, k)
        report = AN.detect_retrace(
            lambda dma_block_index: ((lambda sh: leaky(sh, dma_block_index)),
                                     (shards,)),
            [AN.Perturbation("dma_block_index", (2, 3, 4, 5))],
            caches=lambda: AN.launch_cache_sizes(block))
    assert not report.ok
    assert any("'band_tables_built' grew" in f.detail
               for f in report.findings)


def test_pass_registry_surfaces_the_passes():
    names = [n for n, _ in AN.available()]
    assert names == ["movement-ledger", "model-coverage", "retrace",
                     "smem-budget", "tiling-contract"]
    assert "vmem-budget" in AN.get_pass("smem-budget").summary
    with pytest.raises(KeyError, match="no analysis pass"):
        AN.get_pass("vmem-budget")
    with pytest.raises(ValueError, match="already registered"):
        AN.register_pass("retrace", "again")(lambda: None)
    prog = PR.grid_tiled_program(8, 16, 32, y_tile=4)
    with TR.fake_mode():
        fn, args = prog.build("cuda")
        ledger = AN.get_pass("movement-ledger").run(fn, *args)
        cover = AN.get_pass("model-coverage").run(fn, *args,
                                                  claims=prog.claims)
        tiling = AN.get_pass("tiling-contract").run(fn, *args)
    assert ledger.total("pallas_hbm") == prog.claims["pallas_hbm"]
    assert cover.ok and not tiling.errors
    plan = AN.fused_ring_plan(8, 16, 32, T=4)
    assert AN.get_pass("smem-budget").run(plan) is plan
