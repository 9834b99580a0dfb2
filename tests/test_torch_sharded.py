"""Parameters sharded over ranks: the port against the JAX package.

One world of 4 gloo ranks on the CPU (spawned once for the module through
the port's launcher, every rank running ``tests/torch_sharded_worlds.py``)
builds ``MeshSpec(data=2, embed=2)``, ``MeshSpec(data=4)`` and
``MeshSpec(data=2, seq=2)`` over the same ranks.  Each case is held against
the JAX package on a 4-device mesh of the conftest's CPU platform, from the
same numpy inputs:

  - the rank layout and each axis' group, ``shard_batch``, and
    ``init_table(mesh=)`` against the JAX sharded table's shards (an F that
    the embed axis does not divide refused by both);
  - ``tests/test_all_to_all.py``'s six cases and ``ring_broadcast``;
  - the sharded lookup and its gradient against ``jnp.take``'s;
  - ``tests/test_sharded_trainer.py``, ``test_sharded_ckpt.py``, the four
    cases of ``test_zero_sharded.py`` and ``test_sparse_trainer.py:103-149``
    against the JAX trainers at the same layout, at the Wide&Deep family's
    bound (rtol 1e-4 / atol 2e-5, XLA's CPU ``tanh``), and against the
    port's own one-device trainers at the JAX tests' bound;
  - the weight carry-over of the JAX sharded state through the placements;
  - ring attention over the seq view of a data x seq mesh;
  - ``tests/test_compressed_ring.py``'s cases that
    ``tests/test_torch_collectives.py`` does not hold, and its batched
    ``evaluate`` on ``data/synth.py`` rows.

Every data replica of a block ends bit-identical, and each rank holds F/2
rows of every sharded table."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_sharded_worlds as sw
from lightctr_tpu import TrainConfig as JConfig
from lightctr_tpu.core.mesh import MeshSpec as JMeshSpec
from lightctr_tpu.core.mesh import make_mesh as jmake_mesh
from lightctr_tpu.core.mesh import shard_batch as jshard_batch
from lightctr_tpu.dist import collectives as jcoll
from lightctr_tpu.embed import table as jtable
from lightctr_tpu.models import fm as jfm
from lightctr_tpu.models import widedeep as jwidedeep
from lightctr_tpu.models.ctr_trainer import CTRTrainer as JCTRTrainer
from lightctr_tpu.models.sparse_trainer import \
    SparseTableCTRTrainer as JSparseTrainer
from lightctr_tpu.nn import ring_attention as jring
from lightctr_tpu_torch.core.config import TrainConfig
from lightctr_tpu_torch.core.mesh import spawn_world
from lightctr_tpu_torch.models import _common
from lightctr_tpu_torch.models import fm as tfm
from lightctr_tpu_torch.models import widedeep as twidedeep
from lightctr_tpu_torch.models.ctr_trainer import CTRTrainer
from lightctr_tpu_torch.models.sparse_trainer import SparseTableCTRTrainer

#: the Wide&Deep family's bound against the JAX package (ROADMAP §C)
FAMILY_TOL = dict(rtol=1e-4, atol=2e-5)
#: the JAX tests' own bound (sharded against replicated)
JAX_TOL = dict(rtol=1e-4, atol=1e-5)
#: tests/test_ring_attention.py's tolerance
FLASH_RTOL, FLASH_ATOL = 1e-5, 1e-5
HALF = sw.TABLE_ROWS // 2


def jparams(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def jshardings(jmesh, names):
    """The JAX tests' shardings: tables row-sharded over ``embed``, dense
    leaves replicated."""
    spec = {"w": P("embed"), "v": P("embed", None),
            "embed": P("embed", None)}
    out = {}
    for k in names:
        if k in spec:
            out[k] = NamedSharding(jmesh, spec[k])
        else:
            out[k] = {"w": NamedSharding(jmesh, P()),
                      "b": NamedSharding(jmesh, P())}
    return out


def jax_carry(jmesh, path):
    """The JAX sparse trainer with its tables row-sharded, CARRY_STEPS steps
    in; its params and state saved for the ranks, then the step both
    packages take from there."""
    tr = JSparseTrainer(jparams(sw.wd_params()), jwidedeep.logits,
                        JConfig(**sw.WD_CFG), sparse_tables=sw.WD_TABLES,
                        mesh=jmesh,
                        param_shardings=jshardings(jmesh, sw.wd_params()))
    tr.health = None
    batch = sw.wd_batch()
    for _ in range(sw.CARRY_STEPS):
        tr.train_step(batch)
    torch.save({"params": jax.tree_util.tree_map(np.asarray, tr.params),
                "state": jax.tree_util.tree_map(np.asarray, tr.opt_state),
                "batch": batch}, path)
    loss = float(tr.train_step(batch))
    return {"loss": loss,
            "params": jax.tree_util.tree_map(np.asarray, tr.params),
            "accum": jax.tree_util.tree_map(np.asarray,
                                            tr.opt_state["accum"])}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the JAX data x embed mesh, the JAX data mesh, the JAX carry-over,
    each rank's results)."""
    out = tmp_path_factory.mktemp("sharded")
    jse = jmake_mesh(JMeshSpec(data=2, embed=2))
    jdm = jmake_mesh(JMeshSpec(data=sw.WORLD))
    carry = jax_carry(jse, out / "carry.pt")
    spawn_world(sw.sharded_rank, sw.WORLD, "gloo",
                args=(str(out), str(out / "carry.pt")),
                deadline_s=sw.DEADLINE_S)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(sw.WORLD)]
    return jse, jdm, carry, ranks


def _coords(r):
    """(data, embed) of rank r on the data x embed mesh."""
    return r // 2, r % 2


def _whole(ranks, key_fn):
    """A sharded table put end to end from the blocks of data index 0."""
    blocks = sorted((key_fn(ranks[r]) for r in (0, 1)),
                    key=lambda b: b[1])
    return np.concatenate([b[0] for b in blocks])


def _assert_blocks(ranks, key_fn, rows):
    """Every rank holds ``rows`` rows at its block's offset, and every
    data replica of a block is bit-identical."""
    for r, rec in enumerate(ranks):
        block, offset = key_fn(rec)
        assert block.shape[0] == rows and offset == _coords(r)[1] * rows
        twin = key_fn(ranks[r ^ 2])
        np.testing.assert_array_equal(block, twin[0])


# -- the mesh ------------------------------------------------------------------


def test_rank_layout_and_axis_groups_match_jax(world):
    jse, _, _, ranks = world
    ids = np.vectorize(lambda d: d.id)(jse.devices)
    for r, rec in enumerate(ranks):
        lay = rec["layout"]
        where = [int(i[0]) for i in np.nonzero(ids == r)]
        assert [lay["coords"][a] for a in jse.axis_names] == where
        for ai, a in enumerate(jse.axis_names):
            idx = list(where)
            idx[ai] = slice(None)
            assert lay["groups"][a] == ids[tuple(idx)].reshape(-1).tolist()
        assert lay["axis"] == "data x embed"


def test_shard_batch_matches_jax(world):
    jse, _, _, ranks = world
    got = jshard_batch(jse, {k: jnp.asarray(v)
                             for k, v in sw.layout_batch().items()})
    for r, rec in enumerate(ranks):
        for k, arr in got.items():
            want = [np.asarray(s.data) for s in arr.addressable_shards
                    if s.device.id == r]
            np.testing.assert_array_equal(rec["layout"]["shard_batch"][k],
                                          want[0])


def test_init_table_on_a_mesh_matches_jax_shards(world):
    """Each rank's block sits where the JAX sharded table's shard on that
    device sits, and holds the unsharded table's numbers there; a table
    the embed axis does not divide is refused by both packages."""
    jse, _, _, ranks = world
    t = jtable.init_table(jax.random.PRNGKey(5), sw.TABLE_ROWS, sw.TABLE_DIM,
                          mesh=jse)
    for r, rec in enumerate(ranks):
        init = rec["layout"]["init"]
        (shard,) = [s for s in t.addressable_shards if s.device.id == r]
        rows = shard.index[0]
        assert (rows.start, rows.stop) == (init["offset"],
                                           init["offset"] + HALF)
        assert init["num_rows"] == sw.TABLE_ROWS
        np.testing.assert_array_equal(
            init["block"], init["whole"][rows.start:rows.stop])
        np.testing.assert_array_equal(init["gathered"], init["whole"])
        assert "should be divisible by 2" in rec["layout"]["uneven"]
    with pytest.raises(ValueError, match="should be divisible by 2"):
        jtable.init_table(jax.random.PRNGKey(5), sw.UNEVEN_ROWS,
                          sw.TABLE_DIM, mesh=jse)


# -- the exchanges ---------------------------------------------------------------


def test_all_to_all_is_the_jax_block_transpose(world):
    _, jdm, _, ranks = world
    x = sw.a2a_inputs()["transpose"]
    want = np.asarray(jcoll.all_to_all_exchange(jdm, jnp.asarray(x)))
    np.testing.assert_array_equal(want, np.swapaxes(x, 0, 1))
    for r, rec in enumerate(ranks):
        np.testing.assert_array_equal(rec["exchanges"]["transpose"], want[r])


def test_all_to_all_roundtrip_identity(world):
    _, _, _, ranks = world
    x = sw.a2a_inputs()["roundtrip"]
    for r, rec in enumerate(ranks):
        np.testing.assert_array_equal(rec["exchanges"]["roundtrip"], x[r])


def test_all_to_all_rejects_bad_shape(world):
    _, jdm, _, ranks = world
    with pytest.raises(ValueError, match="leading dims"):
        jcoll.all_to_all_exchange(jdm, jnp.zeros((4, 3, 2)))
    for rec in ranks:
        assert "leading dims" in rec["exchanges"]["bad_shape"]


def test_all_to_all_sharded_lookup_roundtrip(world):
    """test_all_to_all.py's PS pull: requests routed to their shard, rows
    served and routed back equal the gather of the whole table."""
    _, _, _, ranks = world
    inp = sw.a2a_inputs()
    want = inp["table"][inp["reqs"]]
    for r, rec in enumerate(ranks):
        np.testing.assert_array_equal(rec["exchanges"]["lookup"], want[r])


def test_all_to_all_wire_compressed_matches_jax(world):
    """16 and 8 bits within test_all_to_all.py's bounds of the exact
    transpose and equal to the JAX coded exchange (one uniform table, bit
    for bit the JAX one); an integer payload refused by both."""
    _, jdm, _, ranks = world
    x = sw.a2a_inputs()["coded"]
    want = np.swapaxes(x, 0, 1)
    for bits, bound in ((16, 2 * 2.0 / (1 << 16)), (8, 2 * 2.0 / (1 << 8))):
        jout = np.asarray(jcoll.all_to_all_exchange(
            jdm, jnp.asarray(x), compress_bits=bits))
        for r, rec in enumerate(ranks):
            got = rec["exchanges"][f"coded{bits}"]
            np.testing.assert_allclose(got, want[r], atol=bound)
            np.testing.assert_array_equal(got, jout[r])
    with pytest.raises(ValueError, match="float payload"):
        jcoll.all_to_all_exchange(jdm, jnp.zeros((4, 4, 2), jnp.int32),
                                  compress_bits=8)
    for rec in ranks:
        assert "float payload" in rec["exchanges"]["int_payload"]


def test_all_to_all_dynamic_range_tracks_block_scale(world):
    _, jdm, _, ranks = world
    x = sw.a2a_inputs()["tiny"]
    want = np.swapaxes(x, 0, 1)
    scale = np.abs(want).max()
    jdyn = np.asarray(jcoll.all_to_all_exchange(
        jdm, jnp.asarray(x), compress_bits=8, compress_range="dynamic"))
    step = 2 * 1.05 * np.abs(x).max() / 256
    for r, rec in enumerate(ranks):
        dyn = rec["exchanges"]["tiny_dynamic"]
        fixed = rec["exchanges"]["tiny_fixed"]
        assert np.abs(dyn - want[r]).max() / scale < 0.02
        assert np.abs(dyn - want[r]).max() < np.abs(fixed - want[r]).max() / 10
        np.testing.assert_allclose(dyn, jdyn[r], rtol=0, atol=step)


def test_ring_broadcast_matches_jax(world):
    """Rank 0's tree on every rank, bit for bit, as the JAX ring gives."""
    _, jdm, _, ranks = world
    stacks = sw.broadcast_tree()
    want = jcoll.ring_broadcast(jdm, {"a": jnp.asarray(stacks["a"]),
                                      "c": jnp.asarray(stacks["b"]["c"])})
    for r, rec in enumerate(ranks):
        for k, src in (("a", stacks["a"]), ("c", stacks["b"]["c"])):
            np.testing.assert_array_equal(rec["exchanges"]["broadcast"][k],
                                          src[0])
            np.testing.assert_array_equal(rec["exchanges"]["broadcast"][k],
                                          np.asarray(want[k])[r])


# -- the sharded lookup -----------------------------------------------------------


@pytest.mark.parametrize("name, dim", [("rows", sw.TABLE_DIM), ("flat", 0)])
def test_sharded_lookup_and_its_gradient_match_jax_take(world, name, dim):
    """The pulled rows are ``jnp.take``'s bit for bit; each rank's block
    gradient is its rows of ``jax.grad`` of the same loss (its data
    index's ids, repeats and the real row 0 among them)."""
    _, _, _, ranks = world
    table = jnp.asarray(sw.lookup_table(dim))
    for r, rec in enumerate(ranks):
        d_idx, e_idx = _coords(r)
        ids = jnp.asarray(sw.lookup_ids(d_idx))
        w = jnp.asarray(sw.lookup_weights(d_idx, dim))
        got = rec["lookup"][name]
        assert got["offset"] == e_idx * HALF
        np.testing.assert_array_equal(got["out"],
                                      np.asarray(jtable.lookup(table, ids)))
        g = jax.grad(lambda t: jnp.sum(jtable.lookup(t, ids) * w))(table)
        np.testing.assert_array_equal(
            got["grad"], np.asarray(g)[got["offset"]:got["offset"] + HALF])


# -- the trainers -----------------------------------------------------------------


def _blocks(rec_key, leaf):
    return lambda rec: rec[rec_key]["params"][leaf]


def test_sharded_widedeep_matches_jax_and_one_device(world):
    """test_sharded_trainer.py: CTRTrainer with Wide&Deep's tables
    row-sharded, 10 full-batch steps, against the JAX trainer at the same
    layout and the port's one-device trainer; ``evaluate``'s AUC within
    1e-4."""
    jse, _, _, ranks = world
    batch = sw.wd_batch()
    jt = JCTRTrainer(jparams(sw.wd_params()), jwidedeep.logits,
                     JConfig(**sw.WD_CFG), mesh=jse,
                     param_shardings=jshardings(jse, sw.wd_params()))
    jt.health = None
    lj = jt.fit_fullbatch_scan(batch, sw.SHARDED_STEPS)
    one = CTRTrainer(_common.params_from_numpy(sw.wd_params(), "cpu"),
                     twidedeep.logits, TrainConfig(**sw.WD_CFG), device="cpu")
    one.health = None
    lo = one.fit_fullbatch_scan(batch, sw.SHARDED_STEPS)
    got = ranks[0]["wd_sharded"]
    np.testing.assert_allclose(got["loss"], lj, **FAMILY_TOL)
    np.testing.assert_allclose(got["loss"], lo, **JAX_TOL)
    for k in ("w", "embed"):
        whole = _whole(ranks, _blocks("wd_sharded", k))
        np.testing.assert_allclose(whole, np.asarray(jt.params[k]),
                                   **FAMILY_TOL, err_msg=k)
        np.testing.assert_allclose(whole, one.params[k].numpy(), **JAX_TOL,
                                   err_msg=k)
        _assert_blocks(ranks, _blocks("wd_sharded", k), 64)
        _assert_blocks(ranks, lambda rec: rec["wd_sharded"]["state"][
            f"accum/{k}"], 64)
    for k in ("fc1/w", "fc2/b"):
        for rec in ranks:
            np.testing.assert_array_equal(rec["wd_sharded"]["params"][k][0],
                                          got["params"][k][0])
    assert abs(got["eval"]["auc"] - jt.evaluate(batch)["auc"]) < 1e-4
    assert got["eval"]["logloss"] == pytest.approx(
        jt.evaluate(batch)["logloss"], rel=1e-4)
    for rec in ranks[1:]:
        assert rec["wd_sharded"]["eval"] == got["eval"]
        np.testing.assert_array_equal(rec["wd_sharded"]["proba"],
                                      got["proba"])
    # reset puts each rank's blocks of the init and a fresh (zero Adagrad)
    # state back
    init = sw.wd_params()
    for rec in ranks:
        reset = rec["wd_sharded"]["reset"]
        for k in ("w", "embed"):
            block, offset = reset["params"][k]
            np.testing.assert_array_equal(block, init[k][offset:offset + 64])
            acc, acc_offset = reset["state"][f"accum/{k}"]
            assert acc_offset == offset and acc.shape[0] == 64
            assert not acc.any()


def test_sharded_checkpoint_roundtrip_and_across_layouts(world):
    """test_sharded_ckpt.py: the sharded state saved and restored into a
    fresh sharded trainer keeps its AUC (within 1e-6) and trains on; the
    same files restore into a one-device trainer, and a one-device
    checkpoint into a sharded one.  The JAX run of the same layout gives
    the same AUC and resumed losses."""
    jse, _, _, ranks = world
    got = ranks[0]["ckpt"]
    assert abs(got["before"]["auc"] - got["after"]["auc"]) < 1e-6
    assert got["resumed"][-1] <= got["resumed"][0]
    assert got["is_sharded"]
    assert abs(got["one_device_eval"]["auc"] - got["before"]["auc"]) < 1e-6
    assert got["one_device_eval"]["logloss"] == pytest.approx(
        got["before"]["logloss"], rel=1e-6)
    assert got["back_eval"] == got["one_device_eval"]
    v = _whole(ranks, lambda rec: rec["ckpt"]["restored_v"])
    np.testing.assert_array_equal(v, got["one_device_v"])
    np.testing.assert_array_equal(
        _whole(ranks, lambda rec: rec["ckpt"]["back_v"]), got["one_device_v"])
    _assert_blocks(ranks, lambda rec: rec["ckpt"]["restored_v"], 64)
    # the JAX package at the same layout
    batch = sw.ckpt_batch()
    sh = jshardings(jse, ("w", "v"))
    jt = JCTRTrainer(jparams(sw.ckpt_params()), jfm.logits,
                     JConfig(learning_rate=0.1), mesh=jse, param_shardings=sh)
    jt.health = None
    jt.fit_fullbatch_scan(batch, sw.CKPT_STEPS)
    assert abs(jt.evaluate(batch)["auc"] - got["before"]["auc"]) < 1e-4
    np.testing.assert_allclose(v, np.asarray(jt.params["v"]), **FAMILY_TOL)
    resumed = jt.fit_fullbatch_scan(batch, sw.RESUME_STEPS)
    np.testing.assert_allclose(got["resumed"], resumed, **FAMILY_TOL)


def test_zero_sharded_matches_replicated_and_jax(world):
    """test_zero_sharded.py::test_zero_sharded_matches_replicated at data
    4, f = 513 (the flat length padded to a multiple of 4): the zero step
    against the replicated mesh trainer at the JAX test's bound, and
    against the JAX zero trainer on a 4-device mesh."""
    _, jdm, _, ranks = world
    batch = sw.zero_batch()
    z = ranks[0]["zero"]
    np.testing.assert_allclose(z["zero_loss"], z["plain_loss"], **JAX_TOL)
    for k in ("w", "v"):
        np.testing.assert_allclose(z[f"zero_{k}"], z[f"plain_{k}"],
                                   **JAX_TOL)
    jz = JCTRTrainer(jparams(sw.zero_params()), jfm.logits,
                     JConfig(**sw.ZERO_CFG), fused_fn=jfm.logits_with_l2,
                     mesh=jdm, zero_sharded=True)
    jz.health = None
    lj = jz.fit_fullbatch_scan(batch, sw.ZERO_STEPS)
    np.testing.assert_allclose(z["zero_loss"], lj, **FAMILY_TOL)
    for k in ("w", "v"):
        np.testing.assert_allclose(z[f"zero_{k}"], np.asarray(jz.params[k]),
                                   **FAMILY_TOL)
    for rec in ranks[1:]:
        for k in ("zero_w", "zero_v", "zero_loss"):
            np.testing.assert_array_equal(rec["zero"][k], z[k])


def test_zero_state_is_actually_sharded(world):
    """Each rank holds 1/4 of the padded flat state, its own slice; the
    replicated trainer holds the whole unpadded state on every rank."""
    _, jdm, _, ranks = world
    pad = ranks[0]["zero"]["zero_pad"]
    length = sw.ZERO_F * 5
    assert pad == 2568 and pad % sw.WORLD == 0 and pad >= length
    for rec in ranks:
        z = rec["zero"]
        assert z["zero_accum"].shape == (pad // sw.WORLD,)
        assert z["zero_accum"].nbytes * sw.WORLD == pad * 4
        assert z["plain_state_bytes"] == length * 4
    jz = JCTRTrainer(jparams(sw.zero_params()), jfm.logits,
                     JConfig(**sw.ZERO_CFG), fused_fn=jfm.logits_with_l2,
                     mesh=jdm, zero_sharded=True)
    jz.health = None
    jz.train_step(sw.zero_batch())
    accum = jz.opt_state.accum
    assert accum.sharding.spec[0] == "data"
    assert accum.nbytes == pad * 4


def test_zero_sharded_validates_composition(world):
    _, jdm, _, ranks = world
    p = _common.params_from_numpy(sw.zero_params(), "cpu")
    with pytest.raises(ValueError, match="requires a mesh"):
        CTRTrainer(p, tfm.logits, TrainConfig(), zero_sharded=True,
                   device="cpu")
    with pytest.raises(ValueError, match="requires a mesh"):
        JCTRTrainer(jparams(sw.zero_params()), jfm.logits, JConfig(),
                    zero_sharded=True)
    ref = ranks[0]["zero"]["refusals"]
    assert "composes with replicated" in ref["compress_bits"]
    with pytest.raises(ValueError, match="composes with replicated"):
        JCTRTrainer(jparams(sw.zero_params()), jfm.logits, JConfig(),
                    mesh=jdm, zero_sharded=True, compress_bits=8)
    # the JAX message for an optimizer whose state is not elementwise
    assert "elementwise over the parameters" in ref["adam"]


def test_zero_sharded_widedeep_trains(world):
    """A mixed tree (tables + MLP) through the flat-shard update, against
    the one-device trainer (the JAX test's pair) and the JAX zero trainer
    at data 4."""
    _, jdm, _, ranks = world
    batch = sw.wd_batch()
    one = CTRTrainer(_common.params_from_numpy(sw.wd_params(), "cpu"),
                     twidedeep.logits, TrainConfig(**sw.WD_CFG), device="cpu")
    one.health = None
    lo = one.fit_fullbatch_scan(batch, sw.ZERO_WD_STEPS)
    got = ranks[0]["zero"]["wd_loss"]
    np.testing.assert_allclose(got, lo, **JAX_TOL)
    jz = JCTRTrainer(jparams(sw.wd_params()), jwidedeep.logits,
                     JConfig(**sw.WD_CFG), mesh=jdm, zero_sharded=True)
    jz.health = None
    np.testing.assert_allclose(
        got, jz.fit_fullbatch_scan(batch, sw.ZERO_WD_STEPS), **FAMILY_TOL)


def test_sparse_trainer_on_embed_sharded_tables_matches_jax(world):
    """test_sparse_trainer.py:103-149: O(touched) steps on row-sharded
    tables against the JAX sparse trainer at the same layout and the
    port's one-device dense trainer; tables and accumulators F/2 rows a
    rank, every data replica bit-identical."""
    jse, _, _, ranks = world
    batch = sw.wd_batch()
    js = JSparseTrainer(jparams(sw.wd_params()), jwidedeep.logits,
                        JConfig(**sw.WD_CFG), sparse_tables=sw.WD_TABLES,
                        mesh=jse,
                        param_shardings=jshardings(jse, sw.wd_params()))
    js.health = None
    lj = js.fit_fullbatch_scan(batch, sw.SPARSE_STEPS)
    one = CTRTrainer(_common.params_from_numpy(sw.wd_params(), "cpu"),
                     twidedeep.logits, TrainConfig(**sw.WD_CFG), device="cpu")
    one.health = None
    lo = one.fit_fullbatch_scan(batch, sw.SPARSE_STEPS)
    got = ranks[0]["sparse"]
    np.testing.assert_allclose(got["loss"], lj, **FAMILY_TOL)
    np.testing.assert_allclose(got["loss"], lo, **JAX_TOL)
    for k in ("w", "embed"):
        whole = _whole(ranks, _blocks("sparse", k))
        np.testing.assert_allclose(whole, np.asarray(js.params[k]),
                                   **FAMILY_TOL, err_msg=k)
        np.testing.assert_allclose(whole, one.params[k].numpy(), **JAX_TOL,
                                   err_msg=k)
        acc = _whole(ranks, lambda rec: rec["sparse"]["accum"][k])
        np.testing.assert_allclose(acc, np.asarray(js.opt_state["accum"][k]),
                                   **FAMILY_TOL, err_msg=k)
        _assert_blocks(ranks, _blocks("sparse", k), 64)
        _assert_blocks(ranks, lambda rec: rec["sparse"]["accum"][k], 64)
    assert js.params["embed"].sharding.spec[0] == "embed"
    assert abs(got["eval"]["auc"] - js.evaluate(batch)["auc"]) < 1e-4


def test_weight_carry_over_of_the_jax_sharded_state(world):
    """Each rank takes its blocks of the JAX sharded sparse trainer's
    params and state through the placements and steps once: the loss,
    the tables and the accumulators at the family's bound."""
    _, _, carry, ranks = world
    for rec in ranks:
        got = rec["carry"]
        assert got["sharded"]
        assert got["loss"] == pytest.approx(carry["loss"], rel=1e-4)
    for k in ("w", "embed"):
        np.testing.assert_allclose(
            _whole(ranks, lambda rec: rec["carry"]["params"][k]),
            carry["params"][k], **FAMILY_TOL)
        np.testing.assert_allclose(
            _whole(ranks, lambda rec: rec["carry"]["accum"][k]),
            carry["accum"][k], **FAMILY_TOL)
        _assert_blocks(ranks, lambda rec: rec["carry"]["params"][k], 64)


# -- ring attention over the seq view ------------------------------------------------


def test_ring_attention_over_the_seq_view_of_data_x_seq(world):
    """Each data line of ``MeshSpec(data=2, seq=2)`` runs the ring over its
    two seq ranks: every rank equals the JAX ring on a seq mesh of 2."""
    _, _, _, ranks = world
    jmesh = jmake_mesh(JMeshSpec(seq=2))
    fn = jax.jit(functools.partial(jring.ring_self_attention, jmesh,
                                   axis="seq", causal=True))
    want = np.asarray(fn(*map(jnp.asarray, sw.dpw.attention_inputs())))
    for r, rec in enumerate(ranks):
        assert rec["ring"]["seq_group"] == [2 * (r // 2), 2 * (r // 2) + 1]
        np.testing.assert_allclose(rec["ring"]["causal"], want,
                                   rtol=FLASH_RTOL, atol=FLASH_ATOL)
        np.testing.assert_array_equal(rec["ring"]["causal"],
                                      ranks[0]["ring"]["causal"])


# -- test_compressed_ring.py's cases ------------------------------------------------


def test_int8_compressed_ring_bounded_error(world):
    _, jdm, _, ranks = world
    tree = {"g": jnp.asarray(sw.ring_tree(0.1)["g"])}
    exact = np.asarray(jcoll.ring_all_reduce(jdm, tree)["g"])
    j8 = np.asarray(jcoll.ring_all_reduce(jdm, tree, compress_bits=8,
                                          compress_range=1.0)["g"])
    for r, rec in enumerate(ranks):
        got = rec["ring_reduce"]
        np.testing.assert_allclose(got["exact"], exact[r], rtol=1e-6,
                                   atol=1e-7)
        err = np.abs(got["int8"] - exact[r]).max()
        assert err < 8 * (2.0 / 256), err
        err16 = np.abs(got["int16"] - exact[r]).max()
        assert err16 < err / 10
        np.testing.assert_allclose(got["int8"], j8[r], rtol=0, atol=1e-6)


def test_error_feedback_recovers_quantization_bias(world):
    _, jdm, _, ranks = world
    exact = np.asarray(jcoll.ring_all_reduce(
        jdm, {"g": jnp.asarray(sw.ring_tree(0.1)["g"])})["g"])
    for r, rec in enumerate(ranks):
        got = rec["ring_reduce"]
        plain = np.mean(got["plain_steps"], axis=0)
        ef = np.mean(got["ef_steps"], axis=0)
        plain_err = np.abs(plain - exact[r]).max()
        ef_err = np.abs(ef - exact[r]).max()
        assert ef_err < plain_err / 3, (ef_err, plain_err)
        assert np.abs(got["ef_one"] - exact[r]).max() < 8 * (2.0 / 256)


def test_dynamic_range_tracks_gradient_scale(world):
    _, _, _, ranks = world
    for rec in ranks:
        got = rec["ring_reduce"]
        exact = got["tiny_exact"]
        scale = np.abs(exact).max()
        fixed_err = np.abs(got["tiny_fixed"] - exact).max() / scale
        dyn_err = np.abs(got["tiny_dynamic"] - exact).max() / scale
        assert dyn_err < 0.15, dyn_err
        assert dyn_err < fixed_err / 10, (dyn_err, fixed_err)
        assert np.abs(got["tiny_normal"] - exact).max() / scale < 0.15


def test_batched_evaluate_matches_oneshot(tmp_path):
    """The batched evaluate of test_compressed_ring.py on data/synth.py
    rows (its reference file is absent): 1,000 rows in chunks of 250 and
    of 300 (a 100-row tail) give the one-shot report, in both
    packages, and the two packages agree."""
    from lightctr_tpu.data import load_libffm as jload
    from lightctr_tpu_torch.data import load_libffm as tload
    from lightctr_tpu_torch.data.synth import write_synthetic_libffm

    path = write_synthetic_libffm(str(tmp_path / "rows.ffm"), n_rows=1000)
    tds, _ = tload(path).compact()
    jds, _ = jload(path).compact()
    p = sw.dpw.fm_params(tds.feature_cnt, 4, seed=0)
    cfg = dict(learning_rate=0.1, lambda_l2=0.001)
    tr = CTRTrainer(_common.params_from_numpy(p, "cpu"), tfm.logits,
                    TrainConfig(**cfg), fused_fn=tfm.logits_with_l2,
                    device="cpu")
    jt = JCTRTrainer(jparams(p), jfm.logits, JConfig(**cfg),
                     fused_fn=jfm.logits_with_l2)
    tr.health = jt.health = None
    tr.fit_fullbatch_scan(tds.batch_dict(), 20)
    jt.fit_fullbatch_scan(jds.batch_dict(), 20)
    for t in (tr, jt):
        one = t.evaluate(tds.batch_dict())
        chunked = t.evaluate(tds.batch_dict(), batch_size=250)
        assert abs(one["auc"] - chunked["auc"]) < 1e-6
        assert abs(one["logloss"] - chunked["logloss"]) < 1e-5
        assert abs(one["accuracy"] - chunked["accuracy"]) < 1e-6
        tail = t.evaluate(tds.batch_dict(), batch_size=300)
        assert abs(one["auc"] - tail["auc"]) < 1e-6
        assert abs(one["accuracy"] - tail["accuracy"]) < 1e-6
    want = jt.evaluate(jds.batch_dict(), batch_size=300)
    got = tr.evaluate(tds.batch_dict(), batch_size=300)
    for k in ("logloss", "accuracy", "auc"):
        assert got[k] == pytest.approx(want[k], abs=1e-4), k


def test_sharded_trainer_refusals_hold_the_jax_messages(world):
    """The JAX trainers' refusals of sharded params, with their messages."""
    jse, _, _, _ = world
    p = _common.params_from_numpy(sw.wd_params(), "cpu")
    cases = [(dict(param_shardings={}), "param_shardings requires a mesh"),
             (dict(param_shardings={}, fused_adagrad=True),
              "fused_adagrad is not supported with param_shardings"),
             (dict(zero_sharded=True, param_shardings={}),
              "zero_sharded requires a mesh")]
    for kw, msg in cases:
        with pytest.raises(ValueError, match=msg):
            CTRTrainer(p, twidedeep.logits, TrainConfig(), device="cpu", **kw)
    jp = jparams(sw.wd_params())
    with pytest.raises(ValueError, match="fused_adagrad is not supported "
                                         "with param_shardings"):
        JCTRTrainer(jp, jwidedeep.logits, JConfig(), mesh=jse,
                    param_shardings=jshardings(jse, jp), fused_adagrad=True)
    with pytest.raises(ValueError, match="param_shardings requires a mesh"):
        JCTRTrainer(jp, jwidedeep.logits, JConfig(), param_shardings={})
    with pytest.raises(ValueError, match="hier_exchange needs a mesh"):
        SparseTableCTRTrainer(p, twidedeep.logits, TrainConfig(),
                              sparse_tables=sw.WD_TABLES, device="cpu",
                              param_shardings={}, hier_exchange=object())
