"""The port's word2vec (``models/embedding.py``) against the JAX package on
the CPU; mirrors tests/test_algos.py's word2vec cases.

  - the host preparation is the JAX module's numpy code, so its outputs
    are *equal*: ``load_vocab``, ``subsample_mask``, ``cbow_pairs`` (with
    and without subsampling), ``build_huffman``, ``negative_table_logits``;
  - both losses and their gradients given the same batch and negatives:
    rtol 1e-5;
  - the trainers from the JAX init carried across: hierarchical softmax
    step by step within 1e-4 (rtol and atol, W2V_TOL), and negative
    sampling fed the JAX trainer's ``jax.random.categorical`` draws
    likewise (the port draws with ``torch.multinomial``);
  - each table gather is ``embed.table.lookup`` (so ``merge_rows`` is the
    backward: ``GATHERS`` launches a step), the PQ and GMM hooks, and the
    JAX tests' behaviour (communities learned, the loss falling)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightctr_tpu import TrainConfig as JTrainConfig
from lightctr_tpu.models import embedding as jemb
from lightctr_tpu_torch.core.config import TrainConfig
from lightctr_tpu_torch.models import _common
from lightctr_tpu_torch.models import embedding as temb

W2V_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


def make_corpus(rng, vocab=60, n_docs=80, doc_len=30):
    """tests/test_algos.py's corpus: two word communities."""
    docs = []
    for d in range(n_docs):
        base = 0 if d % 2 == 0 else vocab // 2
        docs.append(rng.integers(base, base + vocab // 2,
                                 size=doc_len).astype(np.int32))
    counts = np.bincount(np.concatenate(docs), minlength=vocab) + 1
    return docs, counts


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def test_host_preparation_is_equal(rng, tmp_path):
    docs, counts = make_corpus(rng)
    for kw in ({}, {"counts": counts, "seed": 3}):
        for a, b in zip(temb.cbow_pairs(docs, 3, **kw),
                        jemb.cbow_pairs(docs, 3, **kw)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for a, b in zip(temb.build_huffman(counts), jemb.build_huffman(counts)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(temb.negative_table_logits(counts),
                                  jemb.negative_table_logits(counts))
    np.testing.assert_array_equal(
        temb.subsample_mask(counts, docs[0], t=1e-2, seed=4),
        jemb.subsample_mask(counts, docs[0], t=1e-2, seed=4))
    path = tmp_path / "vocab.txt"
    path.write_text("0 a 12\n1 b 7\nbad\n2 c 3\n")
    got, want = temb.load_vocab(str(path)), jemb.load_vocab(str(path))
    assert got[0] == want[0] == ["a", "b", "c"]
    np.testing.assert_array_equal(got[1], want[1])


def test_huffman_paths_prefix_free():
    counts = np.asarray([100, 50, 20, 10, 5])
    paths, signs, mask = temb.build_huffman(counts)
    lens = mask.sum(axis=1)
    assert lens[0] <= lens[-1]
    codes = {tuple((paths[w, j], signs[w, j]) for j in range(int(lens[w])))
             for w in range(5)}
    assert len(codes) == 5


def _batch(rng, vocab=60, b=16, k=5):
    docs, counts = make_corpus(rng, vocab)
    centers, contexts, mask = jemb.cbow_pairs(docs, 3)
    sel = rng.choice(len(centers), b, replace=False)
    negs = rng.integers(0, vocab, (b, k)).astype(np.int32)
    return counts, centers[sel], contexts[sel], mask[sel], negs


def _jparams(rng, vocab=60, dim=8):
    p = jemb.init(jax.random.PRNGKey(0), vocab, dim)
    out = jnp.asarray(rng.normal(size=(vocab, dim)).astype(np.float32) * 0.1)
    return p._replace(out=out)


@pytest.mark.parametrize("mode", ["negative", "hierarchical"])
def test_losses_and_gradients_match_jax(rng, mode):
    counts, c, x, m, negs = _batch(rng)
    jp = _jparams(rng)
    if mode == "negative":
        def jloss(p):
            return jemb.neg_sampling_loss(p, c, x, m, negs)

        def tloss(p):
            return temb.neg_sampling_loss(p, _t(c), _t(x), _t(m), _t(negs))
    else:
        huff = jemb.build_huffman(counts)

        def jloss(p):
            return jemb.hierarchical_loss(p, c, x, m, *huff)

        def tloss(p):
            return temb.hierarchical_loss(p, _t(c), _t(x), _t(m),
                                          *(_t(a) for a in huff))
    want, wg = jax.value_and_grad(jloss)(jp)
    tp = _common.params_from_numpy(
        jemb.Word2VecParams(*(np.asarray(a) for a in jp)), "cpu")
    leaves = temb.Word2VecParams(*(a.requires_grad_() for a in tp))
    got = tloss(leaves)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)
    for a, b in zip(leaves, wg):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), **LOSS_TOL)


def _trainers(mode, counts, seed=0):
    cfg = dict(learning_rate=0.3, seed=seed)
    jt = jemb.Word2VecTrainer(60, 8, JTrainConfig(**cfg), counts, mode=mode)
    tt = temb.Word2VecTrainer(60, 8, TrainConfig(**cfg), counts, mode=mode,
                              device="cpu")
    tt.params = _common.params_from_numpy(
        jemb.Word2VecParams(*(np.asarray(a) for a in jt.params)), "cpu")
    tt.opt_state = tt.tx.init(tt.params)
    return jt, tt


def test_hierarchical_trainer_matches_jax_from_carried_weights(rng):
    docs, counts = make_corpus(rng, n_docs=40)
    pairs = jemb.cbow_pairs(docs, window=3)
    jt, tt = _trainers("hierarchical", counts)
    jh = jt.fit(*pairs, epochs=3, batch_size=128)
    th = tt.fit(*pairs, epochs=3, batch_size=128)
    np.testing.assert_allclose(th, jh, **W2V_TOL)
    for a, b in zip(tt.params, jt.params):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **W2V_TOL)
    assert th[-1] < th[0]


def test_negative_trainer_matches_jax_fed_its_draws(rng, monkeypatch):
    """The JAX trainer's negatives (``jax.random.categorical`` from one
    split key a step) fed to the port's trainer step by step."""
    docs, counts = make_corpus(rng, n_docs=40)
    pairs = jemb.cbow_pairs(docs, window=3)
    n, b, epochs = len(pairs[0]), 128, 2
    jt, tt = _trainers("negative", counts)
    key, draws = jax.random.PRNGKey(1), []
    logits = jnp.asarray(jemb.negative_table_logits(counts))
    for _ in range(epochs * (n // b)):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.categorical(sub, logits,
                                                       shape=(b, 5))))
    monkeypatch.setattr(tt, "_negatives", lambda rows: _t(draws.pop(0)))
    jh = jt.fit(*pairs, epochs=epochs, batch_size=b)
    th = tt.fit(*pairs, epochs=epochs, batch_size=b)
    assert not draws
    np.testing.assert_allclose(th, jh, **W2V_TOL)
    for a, bb in zip(tt.params, jt.params):
        np.testing.assert_allclose(a.numpy(), np.asarray(bb), **W2V_TOL)


def test_negatives_follow_the_unigram_table(rng):
    counts = np.asarray([1000, 10, 10, 1], np.int64)
    tr = temb.Word2VecTrainer(4, 4, TrainConfig(), counts, device="cpu")
    draws = tr._negatives(4000).reshape(-1).numpy()
    share = np.bincount(draws, minlength=4) / draws.size
    want = np.exp(temb.negative_table_logits(counts))
    np.testing.assert_allclose(share, want, atol=0.01)


def test_word2vec_negative_sampling_learns_communities(rng):
    docs, counts = make_corpus(rng)
    centers, contexts, mask = temb.cbow_pairs(docs, window=3)
    tr = temb.Word2VecTrainer(60, 16, TrainConfig(learning_rate=0.3, seed=0),
                              counts, mode="negative", device="cpu")
    hist = tr.fit(centers, contexts, mask, epochs=4, batch_size=128)
    assert hist[-1] < hist[0]
    emb = tr.normalized_embeddings()
    same = np.mean([emb[i] @ emb[j] for i in range(10) for j in range(10, 20)])
    cross = np.mean([emb[i] @ emb[j] for i in range(10)
                     for j in range(40, 50)])
    assert same > cross, (same, cross)


@pytest.mark.parametrize("mode", ["negative", "hierarchical"])
def test_each_table_gather_is_a_merge_rows_backward(rng, monkeypatch, mode):
    from lightctr_tpu_torch.ops import sparse_kernels

    calls = []
    real = sparse_kernels.merge_rows
    monkeypatch.setattr(sparse_kernels, "merge_rows",
                        lambda *a: calls.append(a[2]) or real(*a))
    docs, counts = make_corpus(rng, n_docs=10)
    pairs = temb.cbow_pairs(docs, window=3)
    tr = temb.Word2VecTrainer(60, 8, TrainConfig(), counts, mode=mode,
                              device="cpu")
    tr.fit(*pairs, epochs=1, batch_size=64)
    steps = len(pairs[0]) // 64
    assert len(calls) == temb.GATHERS[mode] * steps
    assert set(calls) == {60}


def test_quantize_and_cluster_hooks(rng):
    docs, counts = make_corpus(rng, n_docs=20)
    tr = temb.Word2VecTrainer(60, 12, TrainConfig(seed=0), counts,
                              device="cpu")
    tr.fit(*temb.cbow_pairs(docs, window=3), epochs=1, batch_size=64)
    norms = np.linalg.norm(tr.normalized_embeddings(), axis=1)
    np.testing.assert_allclose(norms, 1.0, rtol=1e-5)
    cb, codes = tr.quantize(cluster_cnt=8)
    assert codes.shape == (60, 6) and codes.max() < 8
    assert cb.centroids.shape == (6, 8, 2)
    labels = tr.cluster(n_clusters=3, epochs=5)
    assert labels.shape == (60,) and labels.max() < 3


def test_word2vec_trainer_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        temb.Word2VecTrainer(4, 4, TrainConfig(), np.ones(4, np.int64))
    with pytest.raises(ValueError, match="unknown mode"):
        temb.Word2VecTrainer(4, 4, TrainConfig(), np.ones(4, np.int64),
                             mode="skipgram", device="cpu")
