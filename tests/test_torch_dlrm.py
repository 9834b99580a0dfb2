"""DLRM-DCNv2 in the port (``models/dlrm.py``, ``embed.table.
pooled_lookup``, ``nn.dense``'s stacks) against the plain reference
(``tests/dlrm_reference.py``) on the CPU, at a small size: MLPerf's 26
features with their published bag sizes (214 ids a row), embedding dim 8,
cross rank 4, narrow MLPs, on seeded random weights.

Tolerances.  The port and the reference compute the same float32
operations in different orders (the pool's sums, the products' blocking,
autograd's accumulation of the table's slot gradients), so they differ
by float32 round-off through about ten layers: the loss's relative error
and each leaf gradient's relative error norm (``||port - ref|| /
||ref||``) stay under ``REL`` = 2e-5, about 170 float32 epsilons (the
largest over 20 seeds: 5.2e-6, the table's, whose rows sum up to 160 slot
gradients of both signs), and every logit within ``ATOL`` = 1e-5 of the
reference's (they are of order 0.1; the largest gap 3e-8).  After two
Adagrad steps each leaf's change and accumulator stay under ``STEP_REL``
= 2e-4 (the largest over 20 seeds: 4.2e-5 and 2.3e-5): the first step
divides by sqrt(g^2 + 1e-7), which carries a gradient's relative
round-off into the change at full strength where |g| is near 3e-4.  A
planted fault (a bag cut to its first id, a cross layer's W left out)
moves the logits past ``ATOL`` and some leaf past a hundred times
``REL`` and ten times ``STEP_REL``."""

import numpy as np
import pytest
import torch

import dlrm_reference as ref

from lightctr_tpu_torch import obs
from lightctr_tpu_torch.core.config import TrainConfig
from lightctr_tpu_torch.embed import table as table_mod
from lightctr_tpu_torch.models import dlrm
from lightctr_tpu_torch.models.sparse_trainer import SparseTableCTRTrainer
from lightctr_tpu_torch.nn import dense

#: MLPerf's bag sizes (``--multi_hot_sizes``) and row counts
#: (``--num_embeddings_per_feature``)
BAGS = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100,
        27, 10, 3, 1, 1)
COUNTS = (40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63, 40000000,
          3067956, 405282, 10, 2209, 11938, 155, 4, 976, 14, 40000000,
          40000000, 40000000, 590152, 12973, 108, 36)
#: the small size: each feature's rows capped at 40, dim 8, rank 4
ROWS = tuple(min(c, 40) for c in COUNTS)
DIM, RANK, BOTTOM, TOP = 8, 4, (16,), (32, 16)
REL, ATOL, STEP_REL = 2e-5, 1e-5, 2e-4
LR = 0.05


def make_params(seed=0):
    return ref.init_params(torch.Generator().manual_seed(seed), ROWS, DIM,
                           bottom=BOTTOM, top=TOP, rank=RANK,
                           num_embeddings=COUNTS)


def nest(flat):
    out = {}
    for name, v in flat.items():
        *path, leaf = name.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.clone()
    return out


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def make_batch(seed, n=64):
    """Each feature's bag drawn from its own range of rows, skewed to the
    low rows so rows repeat within and across bags."""
    rng = np.random.default_rng(seed)
    base = np.concatenate([[0], np.cumsum(ROWS)[:-1]])
    cols = []
    for f, size in enumerate(BAGS):
        r = (rng.random((n, size)) ** 3 * ROWS[f]).astype(np.int64)
        cols.append(base[f] + r)
    return {"bag_ids": torch.from_numpy(np.concatenate(cols, 1).astype(
                np.int32)),
            "dense": torch.from_numpy(np.log1p(rng.exponential(
                size=(n, 13))).astype(np.float32)),
            "labels": torch.from_numpy((rng.random(n) < 0.3).astype(
                np.float32))}


def rel(a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


def port_loss_grads(flat_params, batch):
    """The port's loss, logits and every leaf's gradient (the table's
    whole, through ``lookup``'s backward) on the same weights."""
    params = nest(flat_params)
    leaves = {k: v.requires_grad_(True) for k, v in flat(params).items()}
    z = dlrm.make_logits(BAGS)(params, batch)
    y = batch["labels"]
    loss = (torch.nn.functional.softplus(z) - y * z).mean()
    # a planted fault may leave a leaf out: its gradient is then zero
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True, materialize_grads=True)
    return loss.detach(), z.detach(), dict(zip(leaves, grads))


def gaps(flat_params, batch):
    """{what: relative error} of the port against the reference."""
    loss, z, g = port_loss_grads(flat_params, batch)
    r_loss, r_z, r_g, uids = ref.loss_and_grads(flat_params, batch, BAGS)
    out = {"loss": abs(float(loss) - float(r_loss)) / abs(float(r_loss)),
           "logits": float((z - r_z).abs().max())}
    for k, v in r_g.items():
        if k == "embed":
            whole = torch.zeros_like(flat_params["embed"])
            whole[uids] = v
            v = whole
        out[k] = rel(g[k], v)
    return out


def test_pooled_lookup_sums_each_bag_and_merges_in_slot_order():
    """Forward: each feature's slots summed in slot order; backward: each
    slot handed its feature's gradient and merged into the table in slot
    order, as ``index_add_`` of the slots in order gives it."""
    gen = torch.Generator().manual_seed(3)
    t = torch.randn((sum(ROWS), DIM), generator=gen).requires_grad_(True)
    ids = make_batch(4, n=16)["bag_ids"]
    got = table_mod.pooled_lookup(t, ids, table_mod.Bags(BAGS))
    rows = t.detach()[ids.long()]
    s, want = 0, []
    for size in BAGS:
        acc = rows[:, s]
        for j in range(s + 1, s + size):
            acc = acc + rows[:, j]
        want.append(acc)
        s += size
    assert got.shape == (16, len(BAGS), DIM)
    assert torch.equal(got.detach(), torch.stack(want, 1))
    g = torch.randn(got.shape, generator=gen)
    got.backward(g)
    feature = torch.repeat_interleave(torch.arange(len(BAGS)),
                                      torch.tensor(BAGS))
    slot_g = g.index_select(1, feature).reshape(-1, DIM)
    merged = torch.zeros_like(t).index_add_(0, ids.reshape(-1).long(),
                                            slot_g)
    assert torch.equal(t.grad, merged)
    with pytest.raises(ValueError, match="slots"):
        table_mod.pooled_lookup(t, ids[:, :-1], table_mod.Bags(BAGS))
    with pytest.raises(ValueError, match="at least one slot"):
        table_mod.Bags((3, 0, 1))


def test_mlp_stack_is_its_layers_in_order():
    gen = torch.Generator().manual_seed(5)
    p = dense.init_stack(gen, [6, 5, 4, 1], scale="linear")
    assert list(p) == ["l0", "l1", "l2"]
    for k, (n_in, n_out) in zip(p, [(6, 5), (5, 4), (4, 1)]):
        bound = 1.0 / n_in ** 0.5
        assert p[k]["w"].shape == (n_out, n_in)
        assert p[k]["w"].abs().max() <= bound
        assert p[k]["b"].abs().max() <= bound and p[k]["b"].abs().sum() > 0
    x = torch.randn((3, 6), generator=gen)
    h = x
    for k in ("l0", "l1"):
        h = torch.relu(h @ p[k]["w"].T + p[k]["b"])
    want = h @ p["l2"]["w"].T + p["l2"]["b"]
    assert torch.equal(dense.apply_stack(p, x, activate_last=False), want)
    assert torch.equal(dense.apply_stack(p, x), torch.relu(want))


def test_init_draws_torchrec_shapes_and_ranges():
    """The port's initialiser: the reference's shapes, each feature's rows
    within sqrt(1 / its count), the crosses' bias zero and V, W at
    xavier-normal's spread."""
    p = flat(dlrm.init(torch.Generator().manual_seed(1), ROWS, DIM,
                       bottom=BOTTOM, top=TOP, rank=RANK,
                       num_embeddings=COUNTS))
    r = make_params()
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in r.items()}
    s = 0
    for rows, n in zip(ROWS, COUNTS):
        block = p["embed"][s:s + rows]
        assert block.abs().max() <= (1.0 / n) ** 0.5 + 1e-9
        s += rows
    n = (len(BAGS) + 1) * DIM
    big = flat(dlrm.init(torch.Generator().manual_seed(2), ROWS, DIM,
                         rank=64, top=(8,), bottom=(8,)))
    std = (2.0 / (n + 64)) ** 0.5
    for k in ("cross/l0/V", "cross/l2/W"):
        assert abs(float(big[k].std()) / std - 1) < 0.05, k
    assert not big["cross/l1/b"].any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_logits_loss_and_every_gradient_match_the_reference(seed):
    params = make_params(seed)
    got = gaps(params, make_batch(seed + 10))
    assert set(got) == {"loss", "logits"} | set(params)
    assert got["logits"] < ATOL, got["logits"]
    for k, v in got.items():
        if k != "logits":
            assert v < REL, (k, v)


def train_two_steps(params, batches):
    tr = SparseTableCTRTrainer(
        nest(params), dlrm.make_logits(BAGS),
        TrainConfig(learning_rate=LR, lambda_l2=0.0),
        sparse_tables={"embed": ["bag_ids"]}, eps=1e-7, device="cpu")
    tr.health = None
    losses = [float(tr.train_step(b)) for b in batches]
    st = tr.opt_state
    accum = {"embed": st["accum"]["embed"], **flat(st["dense"].accum)}
    return tr, losses, flat(tr.params), accum


def test_two_trainer_steps_match_the_reference():
    """Two ``SparseTableCTRTrainer`` steps against the reference's Adagrad
    steps: the losses, every parameter and every accumulator."""
    params = make_params(4)
    batches = [make_batch(20), make_batch(21)]
    _, losses, got, accum = train_two_steps(params, batches)
    want = ref.steps(params, batches, BAGS, LR)
    for a, b in zip(losses, want["losses"]):
        assert abs(a - b) / abs(b) < REL
    for k in params:
        assert not torch.equal(want["params"][k], params[k]), k
        assert rel(got[k] - params[k],
                   want["params"][k] - params[k]) < STEP_REL, k
        assert rel(accum[k], want["accum"][k]) < STEP_REL, k


def _first_id_only(pooled_lookup):
    def cut(table, ids, bags):
        starts = np.concatenate([[0], np.cumsum(bags.sizes)[:-1]])
        return pooled_lookup(table, ids[:, torch.from_numpy(starts)],
                             table_mod.Bags([1] * len(bags.sizes)))
    return cut


def _cross_without_w(cross_network):
    def no_w(x0, cross):
        first = cross["l0"]
        x = x0 * first["b"] + x0
        rest = {f"l{i - 1}": cross[f"l{i}"] for i in range(1, len(cross))}
        return cross_network(x, rest) if rest else x
    return no_w


@pytest.mark.parametrize("fault", ["bag_first_id", "cross_w_left_out"])
def test_planted_faults_fail_the_tolerances(fault, monkeypatch):
    """The same comparisons with the port broken underneath: a bag cut to
    its first id, or the first cross layer's W (and its V) left out."""
    if fault == "bag_first_id":
        monkeypatch.setattr(dlrm, "pooled_lookup",
                            _first_id_only(dlrm.pooled_lookup))
    else:
        monkeypatch.setattr(dlrm, "cross_network",
                            _cross_without_w(dlrm.cross_network))
    params = make_params(0)
    got = gaps(params, make_batch(10))
    assert got["logits"] > ATOL
    assert max(v for k, v in got.items() if k != "logits") > 100 * REL
    batches = [make_batch(20), make_batch(21)]
    _, _, moved, _ = train_two_steps(params, batches)
    want = ref.steps(params, batches, BAGS, LR)
    assert max(rel(moved[k] - params[k], want["params"][k] - params[k])
               for k in params) > 10 * STEP_REL


def test_tf32_products_fail_the_tolerances():
    """The reference with its products in TF32 (10 mantissa bits) is off
    the float32 reference by more than the tolerances allow."""
    params = make_params(1)
    batch = make_batch(11)
    exact = ref.loss_and_grads(params, batch, BAGS)
    tf32 = ref.loss_and_grads(params, batch, BAGS, mode="tf32")
    assert max(rel(tf32[2][k], exact[2][k]) for k in exact[2]) > 10 * REL


def test_counters_of_the_pool_and_the_touched_rows():
    """``embed_bag_slots_total`` counts the slots pooled a forward; the
    trainer's touched-row total is B2's distinct count summed over the
    steps, published to its registry by ``flush_health``."""
    params = make_params(5)
    batches = [make_batch(30), make_batch(31)]
    reg = obs.MetricsRegistry()
    with obs.override(True):
        before = obs.default_registry().snapshot()["counters"].get(
            "embed_bag_slots_total", 0)
        tr, _, _, _ = train_two_steps(params, batches)
        after = obs.default_registry().snapshot()["counters"][
            "embed_bag_slots_total"]
        tr.telemetry = reg
        tr.flush_health()
    assert after - before == 2 * 64 * sum(BAGS)
    distinct = sum(int(torch.unique(b["bag_ids"]).numel()) for b in batches)
    assert tr.touched_rows() == {"embed": distinct}
    assert reg.snapshot()["counters"][
        obs.labeled("embed_touched_rows_total", table="embed")] == distinct
