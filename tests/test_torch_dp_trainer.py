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
  - the reduce-scatter exchange (``test_sparse_rs.py``'s trainer cases):
    its pick, the overflow fallback to the allgather (train steps and a
    full-batch scan), and the stage-1 EF carry, at the exact bound;
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
    dim 32, 384 ids a rank, 4 ranks) the port's step now takes it and
    matches the JAX trainer over two steps (losses, tables, v's
    accumulator, the policy and its bytes, which
    ``trainer_sparse_rs_bytes_total`` counts); elsewhere both take the
    allgather."""
    w, jmesh, _, ranks = world
    algo, _ = jcoll.pick_exchange_algo(w, 64 * 6, 1024, 32)
    assert (algo == "sparse_rs") == (w == 4)
    jt = JSparseTrainer(
        {k: jnp.asarray(v) for k, v in worlds.fm_params(1024, 32).items()},
        jfm.logits, JConfig(**worlds.CFG), sparse_tables=worlds.TABLES,
        fused_fn=jfm.logits_with_l2, mesh=jmesh)
    jt.health = None
    lj = [float(jt.train_step(b)) for b in worlds.rs_pick_batches(w)]
    got = ranks[0]["rs_pick"]
    assert got["policy"] == jt.exchange_policy
    assert got["policy"]["v"] == algo
    assert got["bytes"] == jt.exchange_bytes_per_step
    np.testing.assert_allclose(got["loss"], lj, rtol=RTOL, atol=ATOL)
    for k, want in (("w", jt.params["w"]), ("v", jt.params["v"]),
                    ("accum_v", jt.opt_state["accum"]["v"])):
        np.testing.assert_allclose(got[k], np.asarray(want), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    if algo == "sparse_rs":
        assert got["counters"]["trainer_sparse_rs_bytes_total"] == \
            2 * got["bytes"]["v"]
    _assert_ranks_identical(ranks, "rs_pick", ("w", "v", "accum_v"))


def rs_jsparse(jmesh, params, **kw):
    tr = JSparseTrainer({k: jnp.asarray(v) for k, v in params.items()},
                        jfm.logits, JConfig(learning_rate=kw.pop("lr", 0.1)),
                        sparse_tables=worlds.TABLES, mesh=jmesh, **kw)
    tr.health = None
    return tr


def test_hybrid_rs_trainer_world4(world):
    """``test_sparse_rs.py``'s reduce-scatter trainer (vocab 2048, dim 16,
    512 rows of 8 ids, 6 full-batch epochs): at 4 ranks v takes the
    reduce-scatter, the batch fits its capacities, and the port follows
    the JAX trainer at the exact bound; at 2 ranks both take the dense
    pick."""
    w, jmesh, _, ranks = world
    f, dim, rows, nnz = worlds.RS_TRAINER
    batch = worlds.rs_fm_batch(60, rows, f, nnz)
    jt = rs_jsparse(jmesh, worlds.fm_params(f, dim, seed=1))
    plan = jt._exchange_plan(batch)
    lj = jt.fit_fullbatch_scan(batch, worlds.RS_SCAN_STEPS)
    got = ranks[0]["rs_scan"]
    assert got["plan"] == {k: v[1] for k, v in plan.items()}
    assert (got["plan"]["v"] == "sparse_rs") == (w == 4)
    assert got["fits"] and jt._rs_batch_fits(batch, plan)
    assert got["policy"] == jt.exchange_policy
    np.testing.assert_allclose(got["loss"], lj, rtol=RTOL, atol=ATOL)
    for k in ("w", "v"):
        np.testing.assert_allclose(got[k], np.asarray(jt.params[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    _assert_ranks_identical(ranks, "rs_scan")


def test_hybrid_rs_overflow_falls_back_to_allgather(world):
    """A batch whose ids are all multiples of the world lands on one
    owner: at 4 ranks the host check refuses it, and each of the 3 steps
    runs the allgather in place of the reduce-scatter — counted in
    ``trainer_rs_fallback_total``, recorded in the fallback's own policy,
    and at the JAX trainer's exact bound."""
    w, jmesh, _, ranks = world
    f, dim, _, _ = worlds.RS_TRAINER
    batch = worlds.rs_skewed_batch(w)
    jt = rs_jsparse(jmesh, worlds.fm_params(f, dim, seed=1))
    plan = jt._exchange_plan(batch)
    lj = [float(jt.train_step(batch))
          for _ in range(worlds.RS_FALLBACK_STEPS)]
    got = ranks[0]["rs_fallback"]
    assert got["plan"] == {k: v[1] for k, v in plan.items()}
    assert got["fits"] == jt._rs_batch_fits(batch, plan)
    assert got["last_fallback"] == jt._last_step_fallback
    assert got["fallback_policy"] == jt._fallback_policy
    assert got["policy"] == jt.exchange_policy
    if w == 4:
        assert got["plan"]["v"] == "sparse_rs" and not got["fits"]
        assert got["last_fallback"]
        assert got["fallback_policy"]["v"] == "sparse"
        assert got["counters"]["trainer_rs_fallback_total"] == \
            worlds.RS_FALLBACK_STEPS
    else:
        assert "trainer_rs_fallback_total" not in got["counters"]
    np.testing.assert_allclose(got["loss"], lj, rtol=RTOL, atol=ATOL)
    for k in ("w", "v"):
        np.testing.assert_allclose(got[k], np.asarray(jt.params[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    _assert_ranks_identical(ranks, "rs_fallback")


def test_hybrid_rs_overflow_falls_back_in_a_full_batch_scan(world):
    """``fit_fullbatch_scan`` on the same batch checks it once: at 4 ranks
    every epoch runs the fallback, counted once, at the JAX trainer's
    exact bound."""
    w, jmesh, _, ranks = world
    f, dim, _, _ = worlds.RS_TRAINER
    batch = worlds.rs_skewed_batch(w)
    jt = rs_jsparse(jmesh, worlds.fm_params(f, dim, seed=1))
    lj = jt.fit_fullbatch_scan(batch, worlds.RS_FALLBACK_STEPS)
    got = ranks[0]["rs_fallback_scan"]
    assert got["counters"].get("trainer_rs_fallback_total", 0) == \
        (1 if w == 4 else 0)
    np.testing.assert_allclose(got["loss"], lj, rtol=RTOL, atol=ATOL)
    for k in ("w", "v"):
        np.testing.assert_allclose(got[k], np.asarray(jt.params[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    _assert_ranks_identical(ranks, "rs_fallback_scan")


def test_hybrid_rs_fixed_range_ef_delivers_clipped_mass(world):
    """``test_sparse_rs.py``'s EF trainer: a fixed range of 0.05 at 8
    bits, a spike step past it (values x20, labels 1), then 8 normal
    steps, with the sparse carry and without.  At 4 ranks (v on the
    reduce-scatter) the spike's clipped mass lands in v's stage-1 carry
    and the touched rows move further than without it.  The first loss
    is the JAX trainer's; the later ones are not held to it: the spike's
    gradients cancel terms of ~1e3, so their codes follow the summation
    order, and the JAX program's table at 0.05 is not its eager table
    (:func:`test_jax_program_table_at_a_fixed_range_of_0_05_is_not_eager`);
    :func:`test_hybrid_rs_ef_carry_matches_jax` holds the path to it."""
    w, jmesh, _, ranks = world
    f, dim, _, _ = worlds.RS_EF_TRAINER
    params = worlds.fm_params(f, dim)
    spike, normal = worlds.rs_ef_batches()
    for ef in (1, 0):
        jt = rs_jsparse(jmesh, params, lr=0.05, error_feedback=bool(ef),
                        **worlds.RS_EF_TRAINER_KW)
        got = ranks[0][f"rs_ef{ef}"]
        assert got["plan"] == {k: v[1] for k, v in
                               jt._exchange_plan(spike).items()}
        assert got["fits"]
        np.testing.assert_allclose(got["loss"][0], float(
            jt.train_step(spike)), rtol=RTOL)
        assert got["policy"] == jt.exchange_policy
        assert all(np.isfinite(got["loss"]))
        _assert_ranks_identical(ranks, f"rs_ef{ef}", ("v",))
    if w == 4:
        assert ranks[0]["rs_ef1"]["policy"]["v"] == "sparse_rs"
        assert ranks[0]["rs_ef1"]["res_after_spike"] > 0.05
        touched = np.unique(spike["fids"])
        v0 = params["v"]
        dv_ef = np.abs(ranks[0]["rs_ef1"]["v"] - v0)[touched]
        dv_no = np.abs(ranks[0]["rs_ef0"]["v"] - v0)[touched]
        assert dv_ef.mean() > 1.2 * dv_no.mean(), (dv_ef.mean(),
                                                   dv_no.mean())


def test_hybrid_rs_ef_carry_matches_jax(world):
    """The EF trainer's path held to the JAX trainer's: 8 bits uniform
    with the sparse carry at a fixed range of 1.0, 4 normal steps (v on
    the reduce-scatter's stage-1 carry at 4 ranks, the dense ring at 2):
    losses, tables and every rank's carry at the exact bound."""
    w, jmesh, _, ranks = world
    f, dim, _, _ = worlds.RS_EF_TRAINER
    _, normal = worlds.rs_ef_batches()
    jt = rs_jsparse(jmesh, worlds.fm_params(f, dim), lr=0.05,
                    error_feedback=True, **worlds.RS_EF_PARITY_KW)
    lj = [float(jt.train_step(normal))
          for _ in range(worlds.RS_EF_STEPS // 2)]
    got = ranks[0]["rs_ef_parity"]
    assert got["policy"] == jt.exchange_policy
    assert (got["policy"]["v"] == "sparse_rs") == (w == 4)
    np.testing.assert_allclose(got["loss"], lj, rtol=RTOL, atol=ATOL)
    for k in ("w", "v"):
        np.testing.assert_allclose(got[k], np.asarray(jt.params[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    sres = np.asarray(jt.opt_state["sres"]["v"])
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["rs_ef_parity"]["sres_v"], sres[r],
                                   rtol=RTOL, atol=ATOL)
    if w == 4:
        assert np.abs(sres).max() > 0


def test_jax_program_table_at_a_fixed_range_of_0_05_is_not_eager():
    """Why the EF trainer's parity runs at a range of 1.0: inside a jitted
    program XLA folds ``build_table(-0.05, 0.05, 8, "uniform")`` to a
    table whose boundaries and values differ from the eager table's in
    the last ulp, and a merged sum of decoded values sits on a boundary
    often, so a code there follows the ulp.  The port builds the eager
    table bit for bit; at 1.0 all three agree."""
    from lightctr_tpu.ops import quantize as jquant
    from lightctr_tpu_torch.ops import quantize as tquant

    for rng, folded_differs in ((0.05, True), (1.0, False)):
        eager = jquant.build_table(-rng, rng, 8, "uniform")
        folded = jax.jit(lambda: jquant.build_table(-rng, rng, 8,
                                                    "uniform"))()
        port = tquant.build_table(-rng, rng, 8, "uniform")
        for part in ("boundaries", "values"):
            e = np.asarray(getattr(eager, part))
            np.testing.assert_array_equal(getattr(port, part).numpy(), e)
            differs = bool((np.asarray(getattr(folded, part)) != e).any())
            assert differs == folded_differs, (rng, part)
