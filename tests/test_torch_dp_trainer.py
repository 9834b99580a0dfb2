"""The port's data-parallel trainers against the JAX package's: worlds of 2
and 4 gloo ranks on the CPU (spawned once for the module through the
port's launcher, each rank running ``tests/torch_dp_worlds.py``) against
the JAX trainers on the conftest's 8-device CPU mesh, from the same numpy
init and batches.

  - ``SparseTableCTRTrainer`` with a mesh (the hybrid exchange): exact on
    the sparse pick (vocab 4096) and the dense pick (vocab 32) — losses,
    ``w`` and ``v`` at the JAX sparse trainer's interpret-vs-reference
    bound (rtol 2e-5 / atol 2e-6) over 3 steps; 8-bit with a dynamic range
    and 8-bit with its defaults (range 1.0, error feedback) — losses
    within rtol 1e-4;
  - ``CTRTrainer`` with a mesh: the plain gradient mean (optimizer
    transform and fused Adagrad), and the coded ring; prediction and
    evaluation on a mesh;
  - the weight carry-over: each rank restarts from the JAX trainer's
    params and mesh optimizer state (its slice of the EF residuals).

Every rank must end bit-identical to rank 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_worlds as worlds
from lightctr_tpu import TrainConfig as JConfig
from lightctr_tpu.core.mesh import MeshSpec as JMeshSpec
from lightctr_tpu.core.mesh import make_mesh as jmake_mesh
from lightctr_tpu.dist import collectives as jcoll
from lightctr_tpu.models import fm as jfm
from lightctr_tpu.models.ctr_trainer import CTRTrainer as JCTRTrainer
from lightctr_tpu.models.sparse_trainer import \
    SparseTableCTRTrainer as JSparseTrainer
from lightctr_tpu_torch.core.mesh import spawn_world

RTOL, ATOL = 2e-5, 2e-6   # tests/test_torch_trainer.py's bound
CODED_RTOL = 1e-4         # the coded trainers' loss bound
CARRY_KW = {"compress_bits": 8, "compress_mode": "uniform"}


def jparams(f):
    return {k: jnp.asarray(v) for k, v in worlds.fm_params(f, 4).items()}


def jsparse(f, jmesh, **kw):
    tr = JSparseTrainer(jparams(f), jfm.logits, JConfig(**worlds.CFG),
                        sparse_tables=worlds.TABLES,
                        fused_fn=jfm.logits_with_l2, mesh=jmesh, **kw)
    tr.health = None
    return tr


def jax_carry(jmesh, path):
    """The JAX trainer 2 steps in (8-bit uniform, fixed range, EF on), its
    params and mesh state saved for the ranks to restart from, then the
    one step both packages take from there."""
    tr = jsparse(4096, jmesh, **CARRY_KW)
    for b in worlds.trainer_batches(4096)[:2]:
        tr.train_step(b)
    batch = worlds.fm_batch(30)
    torch.save({"params": {k: np.asarray(v) for k, v in tr.params.items()},
                "state": jax.tree_util.tree_map(np.asarray, tr.opt_state),
                "batch": batch, "kw": CARRY_KW}, path)
    loss = float(tr.train_step(batch))
    return {"loss": loss, "w": np.asarray(tr.params["w"]),
            "v": np.asarray(tr.params["v"]),
            "sres_v": np.asarray(tr.opt_state["sres"]["v"])}


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, tmp_path_factory):
    """(W, the JAX mesh, the JAX carry-over result, each rank's results)
    of one spawned world."""
    w = request.param
    out = tmp_path_factory.mktemp(f"trainers{w}")
    jmesh = jmake_mesh(JMeshSpec(data=w))
    carry = jax_carry(jmesh, out / "carry.pt")
    spawn_world(worlds.trainers_rank, w, "gloo",
                args=(str(out), str(out / "carry.pt")),
                deadline_s=worlds.DEADLINE_S)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(w)]
    return w, jmesh, carry, ranks


def _assert_ranks_identical(ranks, name, keys=("w", "v")):
    for out in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(out[name][k], ranks[0][name][k])


@pytest.mark.parametrize("name, policy", [("sparse_exact", "sparse"),
                                          ("dense_pick", "dense")])
def test_hybrid_trainer_exact_matches_jax(world, name, policy):
    w, jmesh, _, ranks = world
    f, kw = worlds.TRAINER_CASES[name]
    jt = jsparse(f, jmesh, **kw)
    lj = [float(jt.train_step(b)) for b in worlds.trainer_batches(f)]
    got = ranks[0][name]
    assert got["policy"] == jt.exchange_policy == {"w": policy, "v": policy}
    assert got["bytes"] == jt.exchange_bytes_per_step
    np.testing.assert_allclose(got["loss"], lj, rtol=RTOL, atol=ATOL)
    for k in ("w", "v"):
        np.testing.assert_allclose(got[k], np.asarray(jt.params[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(got["accum_v"],
                               np.asarray(jt.opt_state["accum"]["v"]),
                               rtol=RTOL, atol=ATOL)
    _assert_ranks_identical(ranks, name, ("w", "v", "accum_v"))


@pytest.mark.parametrize("name", ["coded_dynamic", "coded_ef"])
def test_hybrid_trainer_coded_matches_jax(world, name):
    """8-bit normal tables differ between the packages by a few ulp, so a
    code may flip at a boundary: the losses agree within rtol 1e-4."""
    w, jmesh, _, ranks = world
    f, kw = worlds.TRAINER_CASES[name]
    jt = jsparse(f, jmesh, **kw)
    lj = [float(jt.train_step(b)) for b in worlds.trainer_batches(f)]
    got = ranks[0][name]
    assert got["policy"] == jt.exchange_policy == {"w": "sparse",
                                                   "v": "sparse"}
    assert got["bytes"] == jt.exchange_bytes_per_step
    np.testing.assert_allclose(got["loss"], lj, rtol=CODED_RTOL)
    _assert_ranks_identical(ranks, name)


@pytest.mark.parametrize("name", sorted(worlds.DENSE_CASES))
def test_ctr_trainer_on_a_mesh_matches_jax(world, name):
    """CTRTrainer(mesh=...): the plain gradient mean (the JAX parity
    oracle of the hybrid exchange), the same with the fused Adagrad
    kernel's plain version, and the coded ring with EF; then
    ``predict_proba`` and ``evaluate`` on every rank."""
    w, jmesh, _, ranks = world
    kw = worlds.DENSE_CASES[name]
    jt = JCTRTrainer(jparams(512), jfm.logits, JConfig(**worlds.CFG),
                     fused_fn=jfm.logits_with_l2, mesh=jmesh, **kw)
    jt.health = None
    lj = jt.fit_fullbatch_scan(worlds.fm_batch(20, f=512), 4)
    got = ranks[0][name]
    coded = "compress_bits" in kw
    np.testing.assert_allclose(got["loss"], lj,
                               rtol=CODED_RTOL if coded else RTOL, atol=ATOL)
    if not coded:
        for k in ("w", "v"):
            np.testing.assert_allclose(got[k], np.asarray(jt.params[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
        held = worlds.fm_batch(21, n=40, f=512)
        np.testing.assert_allclose(got["proba"], jt.predict_proba(held),
                                   rtol=RTOL, atol=ATOL)
        want = jt.evaluate(held)
        for k in ("logloss", "accuracy", "auc"):
            assert got["eval"][k] == pytest.approx(want[k], abs=1e-4), k
    _assert_ranks_identical(ranks, name, ("w", "v", "proba"))


def test_weight_carry_over_from_the_jax_mesh_state(world):
    """Each rank loads the JAX trainer's params and its slice of the mesh
    state (dense residual, per-table sparse EF residuals) and steps once:
    uniform tables are bit-identical between the packages, so the step
    matches the JAX trainer's at the exact bound, EF carries included."""
    w, _, carry, ranks = world
    for r, out in enumerate(ranks):
        got = out["carry"]
        np.testing.assert_allclose(got["loss"], carry["loss"], rtol=RTOL)
        for k in ("w", "v"):
            np.testing.assert_allclose(got[k], carry[k], rtol=RTOL,
                                       atol=ATOL, err_msg=k)
        np.testing.assert_allclose(got["sres_v"], carry["sres_v"][r],
                                   rtol=RTOL, atol=ATOL)
    assert np.abs(carry["sres_v"]).max() > 0


def test_reduce_scatter_pick_raises_until_ported(world):
    """Where the JAX pick is the reduce-scatter exchange (v at vocab 1024,
    dim 32, 384 ids a rank, 4 ranks) the port's step raises, naming it;
    elsewhere the same shapes take a ported exchange and step."""
    w, _, _, ranks = world
    algo, _ = jcoll.pick_exchange_algo(w, 64 * 6, 1024, 32)
    for out in ranks:
        got = out["rs_pick"]
        if algo == "sparse_rs":
            assert "reduce_scatter_exchange not yet ported" in got["error"]
        else:
            assert got["error"] is None and np.isfinite(got["loss"])
    assert (algo == "sparse_rs") == (w == 4)
