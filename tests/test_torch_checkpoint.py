"""The port's checkpoint (`repro_torch.training.checkpoint`, the array half)
against the reference's (`repro.training.checkpoint`): the same on-disk
format, so each restores what the other saved, key for key and byte for
byte; keep-last GC, torn archives and partial directories as the
reference handles them."""
import json
from collections import namedtuple

import numpy as np
import pytest
import torch

from repro.training import checkpoint as JC
from repro_torch.training import checkpoint as TC

Pair = namedtuple("Pair", "lo hi")


def state(seed=0):
    """A nested state: dicts in unsorted order, a list, a tuple, a
    NamedTuple, None, scalars and arrays of several dtypes and ranks."""
    rng = np.random.default_rng(seed)
    return {
        "u": rng.normal(size=(3, 4, 5)).astype(np.float32),
        "b": {"z": np.arange(6, dtype=np.int64).reshape(2, 3),
              "a": [rng.normal(size=(2,)), (np.float32(1.5), None)]},
        "p": Pair(np.int32(7), {"q": rng.normal(size=(4,)).astype(np.float16)}),
        "flags": np.array([True, False]),
        "step": np.int64(12),
        "none": None,
    }


def leaves(tree):
    return [(k, np.asarray(v)) for k, v in JC._flatten_with_paths(tree)]


def assert_same_leaves(got, want):
    g, w = leaves(got), leaves(want)
    assert [k for k, _ in g] == [k for k, _ in w]
    for (k, a), (_, b) in zip(g, w):
        assert a.shape == b.shape and a.dtype == b.dtype, k
        assert a.tobytes() == b.tobytes(), k


def test_keys_are_joined_as_the_reference_joins_them():
    s = state()
    assert [k for k, _ in TC._flatten_with_paths(s)] == \
        [k for k, _ in JC._flatten_with_paths(s)]


@pytest.mark.parametrize("writer,reader", [(TC, JC), (JC, TC), (TC, TC)])
def test_one_package_restores_what_the_other_saved(tmp_path, writer,
                                                   reader):
    s = state(1)
    writer.save(tmp_path, s, 5)
    got, step = reader.restore(tmp_path, state(2))
    assert step == 5
    assert_same_leaves(got, s)
    assert type(got["p"]) is Pair and got["none"] is None


def test_manifest_equals_the_references(tmp_path):
    s = state(3)
    TC.save(tmp_path / "port", s, 9)
    JC.save(tmp_path / "ref", s, 9)
    mine = json.loads((tmp_path / "port" / "step_000000009" /
                       "manifest.json").read_text())
    ref = json.loads((tmp_path / "ref" / "step_000000009" /
                      "manifest.json").read_text())
    for m in (mine, ref):
        m.pop("time")
    assert mine == ref
    assert (tmp_path / "port" / "LATEST").read_text() == "step_000000009"


def test_tensors_are_saved_from_any_device_and_restored_as_arrays(tmp_path):
    t = {"u": torch.arange(24, dtype=torch.float32).reshape(2, 3, 4),
         "p": [torch.tensor(0.25), torch.ones(3, dtype=torch.float64)]}
    TC.save(tmp_path, t, 1)
    got, _ = JC.restore(tmp_path, {"u": 0, "p": [0, 0]})
    assert np.array_equal(got["u"], t["u"].numpy())
    mine, _ = TC.restore(tmp_path, t)
    assert isinstance(mine["u"], np.ndarray)
    assert mine["p"][1].dtype == np.float64 and mine["p"][0].shape == ()


def test_keep_last_gc(tmp_path):
    for step in range(6):
        TC.save(tmp_path, state(step), step, keep_last=2)
    kept = sorted(p.name for p in tmp_path.glob("step_*"))
    assert kept == ["step_000000004", "step_000000005"]
    assert TC.latest_step(tmp_path) == JC.latest_step(tmp_path) == 5
    got, step = TC.restore(tmp_path, state())
    assert step == 5
    assert_same_leaves(got, state(5))


def test_torn_archive_raises_checkpoint_corrupted_naming_the_path(tmp_path):
    TC.save(tmp_path, state(), 3)
    npz = tmp_path / "step_000000003" / "arrays.npz"
    npz.write_bytes(npz.read_bytes()[:40])
    with pytest.raises(TC.CheckpointCorrupted) as e:
        TC.restore(tmp_path, state())
    assert str(npz) in str(e.value)
    with pytest.raises(JC.CheckpointCorrupted):
        JC.restore(tmp_path, state())


def test_missing_leaf_and_missing_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        TC.restore(tmp_path, state())
    TC.save(tmp_path, {"a": np.zeros(2)}, 0)
    with pytest.raises(KeyError, match="missing leaf b"):
        TC.restore(tmp_path, {"a": 0, "b": 0})
    with pytest.raises(FileNotFoundError, match="no arrays file"):
        TC.restore(tmp_path, {"a": 0}, step=4)


def test_latest_step_ignores_partial_and_staging_dirs(tmp_path):
    TC.save(tmp_path, state(), 2)
    (tmp_path / "step_000000007").mkdir()          # no arrays, no manifest
    (tmp_path / "step_000000007" / "manifest.json").write_text("{}")
    (tmp_path / ".tmp_step_000000009_1").mkdir()
    (tmp_path / ".tmp_step_000000009_1" / "arrays.npz").write_bytes(b"")
    (tmp_path / "LATEST").write_text("step_000000007")   # a stale pointer
    assert TC.latest_step(tmp_path) == JC.latest_step(tmp_path) == 2
    assert TC.latest_step(tmp_path / "nothing") is None


def test_async_checkpointer_snapshots_at_call_time(tmp_path):
    ck = TC.AsyncCheckpointer(tmp_path, keep_last=2)
    t = {"x": torch.zeros(4)}
    ck.save(t, 1)
    t["x"] += 1.0                  # the save holds the value at the call
    ck.save(t, 2)
    ck.wait()
    first, _ = JC.restore(tmp_path, {"x": 0}, step=1)
    last, step = TC.restore(tmp_path, {"x": 0})
    assert step == 2
    assert np.array_equal(first["x"], np.zeros(4, np.float32))
    assert np.array_equal(last["x"], np.ones(4, np.float32))


def test_relayout_branch_names_its_slice(tmp_path):
    """The relayout branch (cfg= with layout=), ported with slice G2a: a
    train state saved under tp=4 by `save` and by `AsyncCheckpointer` is
    stored in the logical layout (the reference restores it at tp=1 to
    the tp=1 state) and restored at tp=4 to the saved state, bitwise."""
    from repro_torch import pspec as TP
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as TM
    from repro_torch.models import relayout as TR
    from repro_torch.training import step as TS
    cfg = get_smoke_config("qwen3-32b")
    lo1, lo4 = TM.make_layout(cfg, 1), TM.make_layout(cfg, 4)
    s1 = TS.init_state(cfg, lo1, torch.Generator().manual_seed(0))
    s4 = {**s1, "params": TR.from_logical(s1["params"], cfg, lo4)}
    TC.save(tmp_path / "a", s4, 5, cfg=cfg, layout=lo4)
    ck = TC.AsyncCheckpointer(tmp_path / "b")
    ck.save(s4, 5, cfg=cfg, layout=lo4)
    ck.wait()
    flat = lambda t: TP.tree_leaves(t, is_leaf=lambda x: isinstance(  # noqa
        x, (np.ndarray, torch.Tensor)))
    for d in ("a", "b"):
        back, step = TC.restore(tmp_path / d, s4, cfg=cfg, layout=lo4)
        assert step == 5
        assert all(np.array_equal(a, b.numpy())
                   for a, b in zip(flat(back), flat(s4)))
        logical = JC.restore(tmp_path / d, TP.tree_map(
            lambda t: t.numpy(), s1, is_leaf=torch.is_tensor))[0]
        assert all(np.array_equal(a, b.numpy())
                   for a, b in zip(flat(logical), flat(s1)))
