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
    params and mesh optimizer state (its slice of the EF residuals);
  - the quality sketch on a mesh (``quality_bins``) in every step variant:
    armed runs train bit for bit as the unarmed ones, and every rank's
    tracker covers the global batch as the JAX trainer's does;
  - the resources and device planes on a mesh
    (``resources=True, device_telemetry=True``) in every step variant:
    armed runs train bit for bit as the unarmed ones.

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
from lightctr_tpu.models import deepfm as jdeepfm
from lightctr_tpu.models import fm as jfm
from lightctr_tpu.models import widedeep as jwidedeep
from lightctr_tpu.models.ctr_trainer import CTRTrainer as JCTRTrainer
from lightctr_tpu.models.sparse_trainer import \
    SparseTableCTRTrainer as JSparseTrainer
from lightctr_tpu_torch.core.mesh import spawn_world

RTOL, ATOL = 2e-5, 2e-6   # tests/test_torch_trainer.py's bound
CODED_RTOL = 1e-4         # the coded trainers' loss bound
#: the Wide&Deep family's bound (the tanh of fc1, ROADMAP §C), and its
#: coded runs' loss bound
FAMILY_TOL = dict(rtol=1e-4, atol=2e-5)
FAMILY_CODED_RTOL = 1e-3
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


def _arrays(rec, keys=None, prefix=""):
    """{path: array} of every numpy array in a rank's record (nested
    dicts walked), or of the named top-level ``keys``."""
    out = {}
    for k, v in rec.items():
        if keys is not None and not prefix and k not in keys:
            continue
        if isinstance(v, dict):
            out.update(_arrays(v, None, f"{prefix}{k}/"))
        elif isinstance(v, np.ndarray):
            out[prefix + k] = v
    return out


def _assert_ranks_identical(ranks, name, keys=("w", "v")):
    """Every rank's arrays of run ``name`` equal rank 0's bit for bit:
    the named ``keys``, or with ``keys=None`` every array of the record
    (a model's nested parameters and accumulators)."""
    want = _arrays(ranks[0][name], keys)
    assert want, name
    for out in ranks[1:]:
        got = _arrays(out[name], keys)
        assert sorted(got) == sorted(want), name
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=f"{name} {k}")


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


#: the field-reorder case: 4 ranks, vocab 16,384, 39 fields, dim 32, 1024
#: rows a step, 6 steps (chip_smoke.py's JAX_REORDER_GAP records what it
#: measured)
REORDER_CASE = dict(world=4, vocab=16384, fields=39, dim=32, rows=1024,
                    steps=6)


def _reorder_run(jmesh, params, batches, **kw):
    tr = JSparseTrainer({k: jnp.asarray(v) for k, v in params.items()},
                        jfm.logits, JConfig(**worlds.CFG),
                        sparse_tables=worlds.TABLES,
                        fused_fn=jfm.logits_with_l2, mesh=jmesh, **kw)
    tr.health = None
    return (np.asarray([float(tr.train_step(b)) for b in batches]),
            {k: np.asarray(v) for k, v in tr.params.items()})


def test_jax_coded_dynamic_range_parts_under_a_field_reorder():
    """Why ``dp_rs`` (b) on the card parts from the CPU (ROADMAP §C, "In
    the reference"): the JAX package parts from ITSELF by the same order
    when only the summation order of FM's forward changes.  The same
    batches with the fields' columns permuted (fids, vals and mask
    together) are the same function, an ulp-level reorder of the sums
    over fields: the exact exchange stays within 1e-6 of the unpermuted
    run, but the 8-bit exchange with a measured range (its table follows
    the largest |g|, and the codes flip at boundaries) parts by more than
    1e-4 within 6 steps, and its tables part."""
    c = REORDER_CASE
    jmesh = jmake_mesh(JMeshSpec(data=c["world"]))
    params = worlds.fm_params(c["vocab"], c["dim"])
    batches = [worlds.fm_batch(10 + i, n=c["rows"], f=c["vocab"],
                               nnz=c["fields"]) for i in range(c["steps"])]
    perm = np.random.default_rng(99).permutation(c["fields"])
    permuted = [{k: v[:, perm] if v.ndim == 2 else v for k, v in b.items()}
                for b in batches]
    gaps = {}
    for name, kw in (("exact", {}),
                     ("coded", {"compress_bits": 8,
                                "compress_range": "dynamic"})):
        la, pa = _reorder_run(jmesh, params, batches, **kw)
        lb, pb = _reorder_run(jmesh, params, permuted, **kw)
        gaps[name] = (np.abs(la - lb) / np.abs(la),
                      max(float(np.abs(pa[k] - pb[k]).max())
                          for k in ("w", "v")))
    exact_loss, exact_table = gaps["exact"]
    coded_loss, coded_table = gaps["coded"]
    assert exact_loss.max() < 1e-6 and exact_table < 5e-5, gaps
    # the first step's forward is the same function in both runs
    assert coded_loss[0] < 1e-6, coded_loss
    assert coded_loss.max() >= 1e-4, coded_loss
    assert coded_table > 1e-3, coded_table


# -- the Wide&Deep family on a mesh --------------------------------------------

#: kind -> the JAX (logits, logits_with_l2 or None)
JFAMILY = {"widedeep": (jwidedeep.logits, None),
           "deepfm": (jdeepfm.logits, jdeepfm.logits_with_l2),
           "dcn": (jdeepfm.dcn_logits, jdeepfm.dcn_logits_with_l2)}


def jflat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(jflat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def jfamily_run(name, jmesh):
    """The JAX trainer of family case ``name`` on the sub-mesh, stepped
    over the worlds' batches: (losses, trainer)."""
    kind, trainer, kw = worlds.FAMILY_CASES[name]
    jl, jl2 = JFAMILY[kind]
    jp = jax.tree_util.tree_map(jnp.asarray, worlds.family_params(kind))
    extra = {} if jl2 is None else {"fused_fn": jl2}
    if trainer == "sparse":
        tr = JSparseTrainer(jp, jl, JConfig(**worlds.CFG),
                            sparse_tables=worlds.FAMILY_TABLES[kind],
                            mesh=jmesh, **extra, **kw)
    else:
        tr = JCTRTrainer(jp, jl, JConfig(**worlds.CFG), mesh=jmesh,
                         **extra, **kw)
    tr.health = None
    return [float(tr.train_step(b)) for b in worlds.family_batches()], tr


def _family_names(trainer, coded):
    return sorted(n for n, (_, t, kw) in worlds.FAMILY_CASES.items()
                  if t == trainer and bool(kw) == coded)


@pytest.mark.parametrize("name", _family_names("sparse", False))
def test_family_hybrid_trainer_exact_matches_jax(world, name):
    """``SparseTableCTRTrainer(mesh=...)`` over Wide&Deep, DeepFM and DCN:
    two id streams (``w`` over fids, ``embed`` over rep_fids; DCN's embed
    alone) on the hybrid exchange, the nested dense leaves on the mean.
    The pick, its bytes per table, the losses, every parameter and the
    table accumulators follow the JAX trainer on a sub-mesh at the
    family's bound; every rank is identical."""
    w, jmesh, _, ranks = world
    lj, jt = jfamily_run(name, jmesh)
    got = ranks[0]["family_" + name]
    assert got["policy"] == jt.exchange_policy
    assert got["bytes"] == jt.exchange_bytes_per_step
    np.testing.assert_allclose(got["loss"], lj, **FAMILY_TOL)
    want = jflat(jt.params)
    assert sorted(got["params"]) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got["params"][k], v, err_msg=k,
                                   **FAMILY_TOL)
    for k, v in jflat(jt.opt_state["accum"]).items():
        np.testing.assert_allclose(got["accum"][k], v, err_msg=k,
                                   **FAMILY_TOL)
    _assert_ranks_identical(ranks, "family_" + name, keys=None)


@pytest.mark.parametrize("name", _family_names("sparse", True))
def test_family_hybrid_trainer_coded_matches_jax(world, name):
    """The same over the 8-bit exchange with a measured range: the dense
    leaves ride the coded ring and both tables' rows are coded; the
    losses agree within rtol 1e-3 (a code may flip at a boundary) and
    every rank is identical."""
    w, jmesh, _, ranks = world
    lj, jt = jfamily_run(name, jmesh)
    got = ranks[0]["family_" + name]
    assert got["policy"] == jt.exchange_policy
    assert got["bytes"] == jt.exchange_bytes_per_step
    np.testing.assert_allclose(got["loss"], lj, rtol=FAMILY_CODED_RTOL)
    _assert_ranks_identical(ranks, "family_" + name, keys=None)


@pytest.mark.parametrize("name", _family_names("dense", False)
                         + _family_names("dense", True))
def test_family_ctr_trainer_on_a_mesh_matches_jax(world, name):
    """``CTRTrainer(mesh=...)`` over the family (the CLI's ``--dp``): the
    whole nested tree's gradient on the plain mean (every parameter at the
    family's bound) or on the 8-bit coded ring with EF (losses within rtol
    1e-3); every rank identical."""
    w, jmesh, _, ranks = world
    lj, jt = jfamily_run(name, jmesh)
    got = ranks[0]["family_" + name]
    coded = bool(worlds.FAMILY_CASES[name][2])
    if coded:
        np.testing.assert_allclose(got["loss"], lj, rtol=FAMILY_CODED_RTOL)
    else:
        np.testing.assert_allclose(got["loss"], lj, **FAMILY_TOL)
        for k, v in jflat(jt.params).items():
            np.testing.assert_allclose(got["params"][k], v, err_msg=k,
                                       **FAMILY_TOL)
    _assert_ranks_identical(ranks, "family_" + name, keys=None)


# -- the resources and device planes on a mesh --------------------------------


@pytest.mark.parametrize("name", sorted(worlds.QUALITY_CASES))
def test_planes_armed_on_a_mesh_train_bit_for_bit_as_unarmed(world, name):
    """Each mesh step variant (the hybrid exchange exact and 8-bit
    dynamic, the reduce-scatter pick and its overflow fallback,
    CTRTrainer's mean and coded ring) with ``resources=True,
    device_telemetry=True``: losses and tables bit for bit the unarmed
    run's on every rank, one input signature over the steps, and the
    step's analysis recorded."""
    w, _, _, ranks = world
    for r in ranks:
        got, base = r["planes_" + name], r[name]
        if name.startswith("dense"):
            assert got["loss"] == [float(x) for x in base["loss"]]
        else:
            assert got["loss"] == base["loss"]
        for k in ("w", "v"):
            np.testing.assert_array_equal(got[k], base[k], err_msg=k)
        # the tracked step is the primary one: a run whose every step
        # fell back to the allgather (rs_fallback at 4 ranks) leaves it
        # uncalled, as the JAX trainer tracks no fallback program
        assert got["signatures"] == (0 if got["fallback"] else 1)
        assert got["analyzed"] is True
    if name == "rs_fallback":
        assert ranks[0]["planes_" + name]["fallback"] == (w == 4)


# -- the quality sketch on a mesh ---------------------------------------------

#: the armed trackers against the JAX trainers': the example and positive
#: totals exactly; AUC within 1e-3 and logloss and the calibration ratio
#: within rtol 1e-4 (a probability within an ulp of a bin edge may land in
#: the next bin, and the coded runs' trajectories part by up to 1e-4)
QUALITY_AUC_ATOL = 1e-3
QUALITY_RTOL = 1e-4


def jquality(name, w, jmesh):
    """The JAX trainer of ``worlds.QUALITY_CASES[name]``, armed, and the
    case's global batches."""
    kind, f, dim, kw, batches = worlds.QUALITY_CASES[name]
    qb = {"quality_bins": worlds.QUALITY_BINS}
    if kind == "sparse_rs":
        return rs_jsparse(jmesh, worlds.fm_params(f, dim, seed=1),
                          **qb), batches(w)
    params = {k: jnp.asarray(v) for k, v in worlds.fm_params(f, dim).items()}
    if kind == "dense":
        jt = JCTRTrainer(params, jfm.logits, JConfig(**worlds.CFG),
                         fused_fn=jfm.logits_with_l2, mesh=jmesh, **kw, **qb)
    else:
        jt = JSparseTrainer(params, jfm.logits, JConfig(**worlds.CFG),
                            sparse_tables=worlds.TABLES,
                            fused_fn=jfm.logits_with_l2, mesh=jmesh,
                            **kw, **qb)
    jt.health = None
    return jt, batches(w)


@pytest.mark.parametrize("name", sorted(worlds.QUALITY_CASES))
def test_armed_trainers_on_a_mesh_match_the_jax_trackers(world, name):
    """Each armed run (the hybrid exchange exact and 8-bit dynamic, the
    reduce-scatter pick and its overflow fallback, CTRTrainer's mean and
    coded ring), the health feed off: losses and tables bit for bit the
    unarmed run's, every rank's tracker the same sketch rows (the ranks'
    sketches summed over the mesh), covering every example of the global
    batches, and within the stated tolerances of the JAX trainer's
    tracker."""
    w, jmesh, _, ranks = world
    got = ranks[0]["quality_" + name]
    base = ranks[0][name]
    if name.startswith("dense"):
        # the unarmed run is a full-batch scan over the same batch
        assert got["loss"] == [float(x) for x in base["loss"]]
    else:
        assert got["loss"] == base["loss"]
    for k in ("w", "v"):
        np.testing.assert_array_equal(got[k], base[k], err_msg=k)
    if name == "rs_pick":
        assert got["policy"]["v"] == ("sparse_rs" if w == 4 else "sparse")
    if name == "rs_fallback":
        assert got["fallback"] == (w == 4)
    _assert_ranks_identical(ranks, "quality_" + name, ("rows",))
    jt, batches = jquality(name, w, jmesh)
    try:
        for b in batches:
            jt.train_step(b)
        jt.flush_health()
        want = jt.quality.total
        rows = got["rows"]
        assert got["updates"] == want.updates == len(batches)
        n = sum(len(b["labels"]) for b in batches)
        assert rows[0].sum() == want.count == n
        assert rows[1].sum() == want.pos_hist.sum() == sum(
            float(b["labels"].sum()) for b in batches)
        from lightctr_tpu_torch.obs import quality as tquality

        acc = tquality.QualityAccumulator(worlds.QUALITY_BINS)
        acc.update(rows.reshape(-1))
        assert acc.auc() == pytest.approx(want.auc(), abs=QUALITY_AUC_ATOL)
        assert acc.logloss() == pytest.approx(want.logloss(),
                                              rel=QUALITY_RTOL)
        assert acc.calibration_ratio() == pytest.approx(
            want.calibration_ratio(), rel=QUALITY_RTOL)
    finally:
        jt.quality.close()
