"""The port's vocab-parallel loss (`models.model.lm_loss` on logits split
over "model" on the vocab axis), on the CPU:

  * without a mesh, `lm_loss` and its gradient are the formula it had
    before (logsumexp, a gather of the target logit), bitwise;
  * on gloo ranks at (data, model) = (1, 2) and (2, 2), the loss and the
    gradient of the logits (gathered whole) equal the single-process ones
    within TOL_REL_F32, the tolerance the sharded train steps are held to
    (`tests/test_torch_sharded_step.py`), and no tensor the loss computes
    on a rank is wider than V / 2 on the vocab axis;
  * on torch's "fake" group at (2, 2), one train step of the `qwen3-32b`
    smoke config runs `lm_loss` without a tensor wider than V / 2 on the
    vocab axis (the shapes are real; the fake group moves no data)."""
import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_pipeline import run_ranks

from repro_torch.models import model as TM

TOL_REL_F32 = 2e-5           # the reference's TOL_REL["float32"]
SHAPE = (4, 6, 64)           # batch, sequence, vocab of the gloo cases
MESHES = ((1, 2), (2, 2))


def old_lm_loss(logits, targets, z_loss: float = 1e-4):
    """`lm_loss` as it was before the vocab-parallel route, on plain
    tensors."""
    logits = logits.float()
    mask = (targets >= 0).float()
    tgt = torch.clamp_min(targets, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, tgt[..., None])[..., 0]
    nll = (logz - ll) * mask
    z = torch.square(logz) * mask
    denom = torch.clamp_min(mask.sum(), 1.0)
    return nll.sum() / denom + z_loss * z.sum() / denom


def inputs(seed: int, shape=SHAPE):
    rng = np.random.default_rng(seed)
    logits = torch.tensor(3.0 * rng.normal(size=shape), dtype=torch.float32)
    targets = torch.tensor(rng.integers(-1, shape[-1], size=shape[:2]))
    return logits, targets


@pytest.mark.parametrize("seed,shape", [(0, SHAPE), (1, (2, 3, 17)),
                                        (2, (1, 1, 5))])
def test_without_a_mesh_the_loss_is_bitwise_unchanged(seed, shape):
    logits, targets = inputs(seed, shape)
    a = logits.clone().requires_grad_()
    b = logits.clone().requires_grad_()
    la, lb = TM.lm_loss(a, targets), old_lm_loss(b, targets)
    la.backward()
    lb.backward()
    assert torch.equal(la, lb) and torch.equal(a.grad, b.grad)


RANK_CODE = """
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.distributed.sharding import (make_rules, place,
                                                  sharding_for)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as TM
    data, model = (int(v) for v in os.environ["MESH"].split(","))
    mesh = make_host_mesh(model=model, device="cpu")
    rules = make_rules(multi_pod=False)
    logits, targets = torch.load(os.environ["INPUTS"])
    lg = place(logits, sharding_for(logits.shape, ("batch", None,
                                                   "act_vocab"), rules, mesh))
    tg = place(targets, sharding_for(targets.shape, ("batch", None), rules,
                                     mesh))
    lg.requires_grad_()

    class Widths(TorchDispatchMode):
        widest = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                # a rank's own tensors (a DTensor wrapper is not data)
                if isinstance(t, torch.Tensor) and t.ndim == 3 and \
                        not isinstance(t, DTensor):
                    Widths.widest = max(Widths.widest, t.shape[-1])
            return out

    with Widths():
        loss = TM.lm_loss(lg, tg)
        loss.backward()
    loss = loss.detach()
    OUT["placements"] = str(lg.placements)
    OUT["loss"] = loss.full_tensor()
    OUT["grad"] = lg.grad.full_tensor()
    OUT["widest"] = Widths.widest
"""


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vocab")
    logits, targets = inputs(7)
    torch.save((logits, targets), tmp / "inputs.pt")
    out = {}
    for d, m in MESHES:
        out[d, m] = run_ranks(RANK_CODE, d * m, tmp, f"v{d}{m}",
                              env={"MESH": f"{d},{m}",
                                   "INPUTS": str(tmp / "inputs.pt")})
    a = logits.clone().requires_grad_()
    want = TM.lm_loss(a, targets)
    want.backward()
    return out, want.detach(), a.grad


def rel(a, b) -> float:
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_loss_and_gradient_equal_single_process(sharded, mesh):
    out, want, grad = sharded
    for r in out[mesh]:
        assert "Shard(dim=2)" in r["placements"], r["placements"]
        assert rel(r["loss"], want) <= TOL_REL_F32
        assert rel(r["grad"], grad) <= TOL_REL_F32


@pytest.mark.parametrize("mesh", MESHES)
def test_no_rank_holds_the_vocab_whole(sharded, mesh):
    out, _, _ = sharded
    V, tp = SHAPE[-1], mesh[1]
    assert all(r["widest"] == V // tp for r in out[mesh]), \
        [r["widest"] for r in out[mesh]]


def test_fake_mesh_train_step_keeps_logits_split(monkeypatch):
    """One `qwen3-32b` smoke train step on rank 0 of a fake (2, 2) world:
    every tensor `lm_loss` makes or reads, forward and backward, is at
    most V / 2 wide on the vocab axis."""
    from torch.distributed.tensor import DTensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training import step as TS

    widths = []

    class Widths(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor) and t.ndim == 3 and \
                        not isinstance(t, DTensor):
                    widths.append(t.shape[-1])
            return out

    def watched(*args, **kw):
        with Widths():
            return loss_of(*args, **kw)

    loss_of = TM.lm_loss
    monkeypatch.setattr(TM, "lm_loss", watched)
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        cfg = get_smoke_config("qwen3-32b").replace(
            compute_dtype="float32")
        lo = TM.make_layout(cfg, 2)
        mesh = make_host_mesh(model=2, device="cpu")
        rules = make_rules(multi_pod=False)
        state = TS.init_state(cfg, lo, torch.Generator().manual_seed(0))
        state = TS.place_state(state, cfg, lo, rules, mesh)
        toks = torch.as_tensor(np.random.default_rng(3).integers(
            0, cfg.vocab_size, (4, 17)))
        batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
        TS.make_train_step(cfg, lo, rules, mesh)(state, batch)
    finally:
        dist.destroy_process_group()
    V = TM.param_specs(cfg, lo)["lm_head"].shape[-1]
    assert widths and max(widths) <= V // 2, (max(widths), V)
