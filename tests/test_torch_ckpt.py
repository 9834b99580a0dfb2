"""The port's checkpoints (``ckpt/checkpoint.py``) on the CPU, mirroring
the six cases of tests/test_ckpt_safety.py (tmp + fsync + atomic rename,
torn-state tolerance in readers and the retention sweep, the PS-shard row
snapshots), plus what the torch-native format adds: the tree description
beside the leaves, ``restore(like=)`` rebuilding the port's NamedTuple
optimizer states, and ``rows_N.npz`` snapshots read across both ways with
the JAX package."""

import json
import os

import numpy as np
import pytest
import torch

from lightctr_tpu.ckpt import checkpoint as jck
from lightctr_tpu_torch import ckpt
from lightctr_tpu_torch.ckpt import checkpoint as ck
from lightctr_tpu_torch.models.ctr_trainer import CompressedRingState
from lightctr_tpu_torch.optim.updaters import AdagradState, AdamState


# -- row snapshots (the migration source) ------------------------------------


def test_save_arrays_round_trips_and_is_atomic(tmp_path):
    rng = np.random.default_rng(0)
    d = str(tmp_path)
    keys = np.arange(50, dtype=np.int64)
    rows = rng.normal(size=(50, 3)).astype(np.float32)
    path = ck.save_arrays(d, 7, keys, rows)
    assert os.path.basename(path) == "rows_7.npz"
    assert not [f for f in os.listdir(d) if ".tmp-" in f]
    step, k, r = ck.load_latest_arrays(d)
    assert step == 7
    np.testing.assert_array_equal(k, keys)
    np.testing.assert_array_equal(r, rows)
    with pytest.raises(ValueError):
        ck.save_arrays(d, 8, keys, rows[:10])


def test_load_latest_arrays_skips_torn_snapshots(tmp_path):
    rng = np.random.default_rng(1)
    d = str(tmp_path)
    ck.save_arrays(d, 1, np.arange(5, dtype=np.int64),
                   rng.normal(size=(5, 2)).astype(np.float32))
    with open(os.path.join(d, "rows_2.npz"), "wb") as f:
        f.write(b"PK\x03\x04 definitely not a full zip")
    step, k, _ = ck.load_latest_arrays(d)
    assert step == 1 and len(k) == 5
    assert ck.load_latest_arrays(str(tmp_path / "nope")) is None


def test_gc_array_snapshots_keeps_newest_and_sweeps_turds(tmp_path):
    d = str(tmp_path)
    for s in range(5):
        ck.save_arrays(d, s, np.arange(3, dtype=np.int64),
                       np.zeros((3, 2), np.float32))
    open(os.path.join(d, ".rows_9.tmp-123.npz"), "wb").close()
    ck.gc_array_snapshots(d, keep=2)
    assert sorted(os.listdir(d)) == ["rows_3.npz", "rows_4.npz"]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_row_snapshots_cross_load_with_the_jax_package(tmp_path, writer):
    """``rows_N.npz`` is the JAX package's npz: a snapshot either package
    writes (accumulators included) the other reads bit for bit, and the
    row-only reader skips the accumulators alike."""
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 1 << 40, 30).astype(np.int64)
    rows = rng.normal(size=(30, 4)).astype(np.float32)
    acc = rng.random((30, 4)).astype(np.float32)
    w, r = (ck, jck) if writer == "port" else (jck, ck)
    w.save_arrays(str(tmp_path), 11, keys, rows, accums=acc)
    step, k, rr, a = r.load_latest_state(str(tmp_path))
    assert step == 11
    np.testing.assert_array_equal(k, keys)
    np.testing.assert_array_equal(rr, rows)
    np.testing.assert_array_equal(a, acc)
    step, k, rr = r.load_latest_arrays(str(tmp_path))
    np.testing.assert_array_equal(rr, rows)


# -- tree checkpoints ----------------------------------------------------------


def test_save_is_staged_then_renamed(tmp_path):
    """A save stages into a tmp dir and renames: a reader listing the
    directory mid-save sees nothing or a complete step_N, never a
    half-written one.  The step holds the leaves and the tree's
    description."""
    d = str(tmp_path)
    state = {"w": torch.arange(6.0), "b": torch.tensor(2.0)}
    path = ck.save(d, 3, state)
    assert os.path.isdir(path)
    assert sorted(os.listdir(path)) == ["leaves.pt", "tree.json"]
    assert not [f for f in os.listdir(d) if ".tmp-" in f]
    with open(os.path.join(path, "tree.json")) as f:
        assert json.load(f)["format"] == ck.FORMAT
    out = ck.restore(d, like=state)
    assert torch.equal(out["w"], state["w"])
    # overwrite of an existing step (save force semantics) still works
    ck.save(d, 3, {"w": torch.zeros(6), "b": torch.tensor(0.0)})
    out = ck.restore(d, step=3, like=state)
    assert float(out["b"]) == 0.0


def test_latest_step_and_restore_ignore_torn_directories(tmp_path):
    d = str(tmp_path)
    state = {"w": torch.arange(4.0)}
    ck.save(d, 1, state)
    ck.save(d, 2, state)
    os.makedirs(os.path.join(d, "step_9"))  # torn: empty (made, then killed)
    os.makedirs(os.path.join(d, "step_5.orbax-checkpoint-tmp-42"))
    assert ck.latest_step(d) == 2
    out = ck.restore(d, like=state)
    assert torch.equal(out["w"], state["w"])
    assert ck.latest_step(str(tmp_path / "missing")) is None
    with pytest.raises(FileNotFoundError):
        ck.restore(str(tmp_path / "missing"))


def test_checkpointer_gc_ignores_torn_dirs_and_keeps_retention(tmp_path):
    d = str(tmp_path)
    c = ck.Checkpointer(d, keep=2, every=1)
    state = {"w": torch.arange(3.0)}
    for s in (1, 2, 3):
        c.maybe_save(s, state)
    assert c.maybe_save(5, state) is not None
    c2 = ck.Checkpointer(d, keep=2, every=2)
    assert c2.maybe_save(7, state) is None
    os.makedirs(os.path.join(d, "step_9"), exist_ok=True)  # torn
    os.makedirs(os.path.join(d, ".step_7.tmp-999999999"))
    os.makedirs(os.path.join(d, f".step_8.tmp-{os.getpid()}"))
    c._gc()
    kept = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert kept == ["step_3", "step_5", "step_9"]
    assert not os.path.isdir(os.path.join(d, ".step_7.tmp-999999999"))
    assert os.path.isdir(os.path.join(d, f".step_8.tmp-{os.getpid()}"))
    out = c.restore_latest(like=state)
    assert torch.equal(out["w"], state["w"])
    ck.Checkpointer(str(tmp_path / "gone"), keep=1)._gc()


def trainer_state():
    """A CLI checkpoint's tree: nested params with a list of blocks, and
    the port's NamedTuple optimizer states (Adagrad, Adam, the compressed
    ring's) with a step count and a numpy array beside."""
    g = torch.Generator().manual_seed(0)

    def t(*shape):
        return torch.randn(shape, generator=g)

    params = {"w": t(10), "fc1": {"w": t(3, 4), "b": t(3)},
              "blocks": [{"ln1": t(4)}, {"ln1": t(4)}]}
    return {
        "params": params,
        "opt_state": AdagradState(accum={"w": t(10),
                                         "fc1": {"w": t(3, 4), "b": t(3)},
                                         "blocks": [{"ln1": t(4)},
                                                    {"ln1": t(4)}]}),
        "adam": AdamState(count=torch.tensor(3, dtype=torch.int32),
                          mu={"w": t(10)}, nu={"w": t(10)}),
        "ring": CompressedRingState(inner=AdagradState(accum={"w": t(10)}),
                                    residual=t(12)),
        "cursor": 17, "rate": 0.5, "host": np.arange(5, dtype=np.int64),
    }


def _assert_same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    else:
        assert a == b


def test_restore_rebuilds_the_ports_namedtuple_states(tmp_path):
    """Without a template the saved tree comes back as it was saved: the
    port's NamedTuples by class, lists of blocks, numbers and numpy
    arrays; with ``like=`` the template's structure and each template
    leaf's dtype."""
    state = trainer_state()
    ckpt.save(str(tmp_path), 4, state)
    _assert_same(ckpt.restore(str(tmp_path)), state)
    like = trainer_state()
    like["params"]["w"] = like["params"]["w"].double()
    out = ckpt.restore(str(tmp_path), like=like)
    assert isinstance(out["ring"], CompressedRingState)
    assert isinstance(out["ring"].inner, AdagradState)
    assert out["params"]["w"].dtype == torch.float64
    np.testing.assert_array_equal(out["params"]["w"].numpy(),
                                  state["params"]["w"].double().numpy())
    _assert_same(out["opt_state"], state["opt_state"])


def test_restore_refuses_a_template_of_another_tree(tmp_path):
    state = trainer_state()
    ckpt.save(str(tmp_path), 1, state)
    bad = trainer_state()
    bad["params"]["fc2"] = bad["params"].pop("fc1")
    with pytest.raises(ValueError, match="keys"):
        ckpt.restore(str(tmp_path), like=bad)
    bad = trainer_state()
    bad["params"]["w"] = torch.zeros(11)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), like=bad)


def test_restore_of_a_trainer_state_steps_on_alike(tmp_path):
    """A CTRTrainer's params and Adagrad state saved mid-run and restored
    into a fresh trainer (``like=`` its own state) step on exactly as the
    original."""
    from lightctr_tpu_torch.core.config import TrainConfig
    from lightctr_tpu_torch.models import nfm
    from lightctr_tpu_torch.models.ctr_trainer import CTRTrainer

    rng = np.random.default_rng(3)
    n, p = 32, 4
    batch = {"fids": rng.integers(0, 50, (n, p)).astype(np.int32),
             "vals": np.ones((n, p), np.float32),
             "mask": np.ones((n, p), np.float32),
             "labels": (rng.random(n) > 0.5).astype(np.float32)}

    def trainer():
        tr = CTRTrainer(nfm.init(torch.Generator().manual_seed(0), 50, 4, 6),
                        nfm.logits, TrainConfig(), fused_fn=nfm.logits_with_l2,
                        device="cpu")
        tr.health = None
        return tr

    a = trainer()
    a.train_step(batch)
    ckpt.save(str(tmp_path), 1, {"params": a.params,
                                 "opt_state": a.opt_state})
    b = trainer()
    got = ckpt.restore(str(tmp_path), like={"params": b.params,
                                            "opt_state": b.opt_state})
    b.params, b.opt_state = got["params"], got["opt_state"]
    assert isinstance(b.opt_state, AdagradState)
    assert float(a.train_step(batch)) == float(b.train_step(batch))
    _assert_same(a.params, b.params)
