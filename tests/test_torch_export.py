"""The port's model export (``models/export.py``) and product quantizer
(``ops/pq.py``) against the JAX package's on the CPU: the reference's
text formats, the compressed serving artifact written by either package
and loaded by the other (int8 codes and decoded leaves bit for bit), the
PQ k-means loop from shared initial centroids, its encode and decode, the
refusals, and the AUC of compressed serving (tests/test_serve.py's
compressed-export case) through the port's own trainer and loader."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightctr_tpu.models import deepfm as jdeepfm
from lightctr_tpu.models import export as jexport
from lightctr_tpu.ops import pq as jpq
from lightctr_tpu.serve import model as jserve_model
from lightctr_tpu_torch import serve as tserve
from lightctr_tpu_torch.core.config import TrainConfig
from lightctr_tpu_torch.models import export as texport
from lightctr_tpu_torch.models import fm as tfm
from lightctr_tpu_torch.models.ctr_trainer import CTRTrainer
from lightctr_tpu_torch.ops import pq as tpq
from lightctr_tpu_torch.ops.metrics import auc_exact


def nested_params(seed=0, f=24, k=8):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.normal(size=f).astype(np.float32),
        "v": rng.normal(size=(f, k)).astype(np.float32),
        "fc1": {"w": rng.normal(size=(8, 4)).astype(np.float32),
                "b": np.zeros((4,), np.float32)},
        "s": np.asarray([1.5], np.float32),
    }


def flat(tree):
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in jexport._flatten_params(
                jax.tree_util.tree_map(
                    lambda a: a.cpu().numpy() if isinstance(
                        a, torch.Tensor) else np.asarray(a), tree)).items()}


# -- text formats ----------------------------------------------------------------


def test_fm_text_roundtrip_and_files_identical_to_jax(tmp_path):
    rng = np.random.default_rng(0)
    params = {"w": np.zeros(30, np.float32),
              "v": (rng.standard_normal((30, 4)) / 2).astype(np.float32)}
    params["w"][[2, 7]] = [1.5, -0.25]
    tp, jp = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    texport.save_fm_text(tp, {k: torch.from_numpy(v)
                              for k, v in params.items()})
    jexport.save_fm_text(jp, params)
    assert open(tp).read() == open(jp).read()
    assert open(tp).readline().split() == ["2:1.5", "7:-0.25"]
    out = texport.load_fm_text(jp)
    want = jexport.load_fm_text(tp)
    for k in ("w", "v"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(want[k]))
        np.testing.assert_allclose(out[k].numpy(), params[k], rtol=1e-4,
                                   atol=1e-6)


def test_fm_text_all_zero_w_and_degenerate_files(tmp_path):
    rng = np.random.default_rng(1)
    params = {"w": np.zeros(6, np.float32),
              "v": rng.normal(size=(6, 3)).astype(np.float32)}
    path = str(tmp_path / "zero_w.txt")
    texport.save_fm_text(path, params)
    assert open(path).readline() == "\n"
    with open(path, "a") as f:
        f.write("\n\n")
    out = texport.load_fm_text(path)
    assert out["w"].shape == (6,) and out["v"].shape == (6, 3)
    assert not out["w"].any()
    p1 = str(tmp_path / "no_rows.txt")
    with open(p1, "w") as f:
        f.write("\n\n")
    with pytest.raises(ValueError, match="zero-row"):
        texport.load_fm_text(p1)
    p2 = str(tmp_path / "empty.txt")
    open(p2, "w").close()
    with pytest.raises(ValueError, match="empty"):
        texport.load_fm_text(p2)
    p3 = str(tmp_path / "out_of_order.txt")
    with open(p3, "w") as f:
        f.write("0:1.5\n1:0.1 0.2\n0:0.3 0.4\n")
    with pytest.raises(ValueError, match="out of order"):
        texport.load_fm_text(p3)
    with pytest.raises(ValueError, match="FM layout"):
        texport.save_fm_text(str(tmp_path / "x.txt"),
                             {"w": np.zeros(2), "v": np.zeros(2)})


def test_embeddings_text_roundtrip_across_packages(tmp_path):
    words = ["alpha", "beta", "gamma"]
    emb = np.random.default_rng(2).normal(size=(3, 5)).astype(np.float32)
    tp, jp = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    texport.save_embeddings_text(tp, words, torch.from_numpy(emb))
    jexport.save_embeddings_text(jp, words, emb)
    assert open(tp).read() == open(jp).read()
    w2, e2 = texport.load_embeddings_text(jp)
    assert w2 == words
    np.testing.assert_allclose(e2, emb, rtol=1e-4, atol=1e-6)


# -- compressed artifacts ----------------------------------------------------------


def test_flatten_unflatten_match_jax():
    p = nested_params()
    tf = texport._flatten_params(p)
    jf = jexport._flatten_params(p)
    assert list(tf) == list(jf) == ["w", "v", "fc1/w", "fc1/b", "s"]
    back = texport._unflatten_params(tf)
    jback = jexport._unflatten_params(jf)
    assert set(back) == set(jback) == {"w", "v", "fc1", "s"}
    assert set(back["fc1"]) == set(jback["fc1"]) == {"w", "b"}
    np.testing.assert_array_equal(back["fc1"]["w"], p["fc1"]["w"])
    assert texport.COMPRESSED_FORMAT == jexport.COMPRESSED_FORMAT
    assert texport.COMPRESSED_VERSION == jexport.COMPRESSED_VERSION


def _both_payloads(tmp_path, p, **kw):
    tp, jp = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tm = texport.save_compressed_npz(tp, p, model="deepfm", device="cpu",
                                     **kw)
    jm = jexport.save_compressed_npz(jp, p, model="deepfm", **kw)
    assert tm == jm
    with np.load(tp) as zt, np.load(jp) as zj:
        assert sorted(zt.files) == sorted(zj.files)
        for k in zj.files:
            assert zt[k].dtype == zj[k].dtype, k
        return tm, {k: zt[k] for k in zt.files}, {k: zj[k] for k in zj.files}


def test_int8_codes_and_meta_equal_jax_bit_for_bit(tmp_path):
    """The port writes the JAX package's payload with the default codec
    (int8, uniform tables): the same codes, tables, raw leaves and
    ``__meta__`` bytes (the tables are the eager JAX tables, built on the
    host)."""
    p = nested_params(3)
    p["v"][0, 0] = 0.0
    tm, zt, zj = _both_payloads(tmp_path, p, fp32_leaves=("fc1/b",))
    for k in zj:
        np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
    assert tm["leaves"]["s"]["codec"] == "fp32"       # one value: raw
    assert tm["leaves"]["fc1/b"]["codec"] == "fp32"
    assert tm["leaves"]["v"]["codec"] == "int8"


def test_int8_log_tables_within_ulps_of_jax(tmp_path):
    """Log tables go through ``pow``, which differs by an ulp between the
    two libraries (ops/quantize.py): the tables agree within rtol 1e-6
    and at most 1 % of the codes differ (values that lie between the two
    packages' boundaries).  The default codec's uniform tables are
    bit-identical (above)."""
    p = nested_params(3)
    _, zt, zj = _both_payloads(tmp_path, p, mode="log")
    for name in ("w", "v", "fc1/w", "fc1/b"):
        np.testing.assert_allclose(zt[name + "__values"],
                                   zj[name + "__values"], rtol=1e-6)
        apart = zt[name + "__codes"] != zj[name + "__codes"]
        assert apart.mean() <= 0.01, name


def test_artifacts_cross_load_bit_for_bit(tmp_path):
    """An artifact of either package (int8, PQ and fp32 leaves) loads in
    the other with every decoded leaf equal bit for bit to the writer's
    own load."""
    p = nested_params(4, f=64)
    kw = dict(model="deepfm", pq_leaves=("v",), pq_parts=4, pq_clusters=8,
              fp32_leaves=("fc1/b",))
    tp, jp = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    texport.save_compressed_npz(tp, p, device="cpu", **kw)
    jexport.save_compressed_npz(jp, p, **kw)
    for path in (tp, jp):
        tparams, tmeta = texport.load_compressed_npz(path, device="cpu")
        jparams, jmeta = jexport.load_compressed_npz(path)
        assert tmeta == jmeta and tmeta["model"] == "deepfm"
        assert tmeta["leaves"]["v"]["codec"] == "pq"
        tf, jf = flat(tparams), flat(jparams)
        assert list(tf) == list(jf)
        for k in jf:
            assert tf[k].shape == tuple(tmeta["leaves"][k]["shape"])
            np.testing.assert_array_equal(tf[k], jf[k], err_msg=k)
        np.testing.assert_array_equal(tf["fc1/b"], p["fc1"]["b"])
        rng_w = float(np.abs(p["w"]).max())
        np.testing.assert_allclose(tf["w"], p["w"], atol=2 * 2 * rng_w / 256)
    with np.load(tp) as z:
        assert z["v__codes"].shape == (64, 4) and z["v__codes"].dtype == \
            np.uint8


def test_refusals(tmp_path):
    with pytest.raises(ValueError, match="unknown leaf"):
        texport.save_compressed_npz(
            str(tmp_path / "x.npz"), {"w": np.zeros(4, np.float32)},
            model="fm", pq_leaves=("nope",), device="cpu")
    with pytest.raises(ValueError, match="unknown default codec"):
        texport.save_compressed_npz(
            str(tmp_path / "x.npz"), {"w": np.zeros(4, np.float32)},
            model="fm", codec="int4", device="cpu")
    with pytest.raises(ValueError, match="must be"):
        texport.save_compressed_npz(
            str(tmp_path / "x.npz"), {"v": np.zeros((4, 6), np.float32)},
            model="fm", pq_leaves=("v",), pq_parts=4, device="cpu")
    bogus = str(tmp_path / "bogus.npz")
    np.savez(bogus, x=np.zeros(3))
    with pytest.raises(ValueError, match="__meta__"):
        texport.load_compressed_npz(bogus, device="cpu")
    other = str(tmp_path / "other.npz")
    np.savez(other, __meta__=np.frombuffer(
        json.dumps({"format": "else", "leaves": {}}).encode(), np.uint8))
    with pytest.raises(ValueError, match="is not"):
        texport.load_compressed_npz(other, device="cpu")


def test_export_entry_points_default_to_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "m.npz")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        texport.save_compressed_npz(path, {"w": np.ones(4, np.float32)},
                                    model="fm")
    texport.save_compressed_npz(path, {"w": np.ones(4, np.float32)},
                                model="fm", device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        texport.load_compressed_npz(path)


# -- product quantizer ------------------------------------------------------------


def pq_points(seed=5, n=240, d=16):
    """Points with duplicated rows, so that two initial centroids can
    coincide: argmin ties and an empty cluster's re-seeding both run."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[n // 2:n // 2 + 20] = x[:20]
    return x


def jax_kmeans(parts, centroids, iters):
    def body(c, _):
        return jax.vmap(lambda xs, cs: jpq._kmeans_step(xs, cs)[0])(
            parts, c), None

    c, _ = jax.lax.scan(body, centroids, None, length=iters)
    return c


def test_kmeans_loop_from_shared_initial_centroids_matches_jax():
    """``pq.train`` draws its initial rows with jax.random.choice, which no
    torch generator reproduces; from the same initial centroids (with two
    equal ones) the port's loop follows the JAX loop."""
    x = pq_points()
    parts = x.reshape(240, 4, 4).transpose(1, 0, 2)
    init_idx = np.r_[np.arange(8), np.arange(120, 128)]   # 120.. == 0..
    c0 = parts[:, init_idx, :]
    assert np.array_equal(c0[:, 0], c0[:, 8])
    step_t, assign_t = tpq._kmeans_step(torch.from_numpy(parts),
                                        torch.from_numpy(c0))
    for p in range(4):
        step_j, assign_j = jpq._kmeans_step(jnp.asarray(parts[p]),
                                            jnp.asarray(c0[p]))
        np.testing.assert_array_equal(assign_t[p].numpy(),
                                      np.asarray(assign_j))
        np.testing.assert_allclose(step_t[p].numpy(), np.asarray(step_j),
                                   rtol=1e-5, atol=1e-6)
    # the tie went to the first index: centroid 8 is empty and re-seeded
    counts = np.bincount(assign_t[0].numpy(), minlength=16)
    assert counts[8] == 0
    got = tpq._kmeans(torch.from_numpy(parts), torch.from_numpy(c0), 10)
    want = jax_kmeans(jnp.asarray(parts), jnp.asarray(c0), 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_encode_decode_and_error_on_one_codebook_match_jax():
    x = pq_points(6)
    book = jpq.train(jax.random.PRNGKey(0), jnp.asarray(x), part_cnt=4,
                     cluster_cnt=16, iters=5)
    c = np.array(book.centroids)
    tbook = tpq.PQCodebook(centroids=torch.from_numpy(c))
    codes = tpq.encode(tbook, torch.from_numpy(x))
    jcodes = np.asarray(jpq.encode(book, jnp.asarray(x)))
    assert codes.dtype == torch.uint8 and codes.shape == (240, 4)
    np.testing.assert_array_equal(codes.numpy(), jcodes)
    np.testing.assert_array_equal(
        tpq.decode(tbook, codes).numpy(),
        np.asarray(jpq.decode(book, jnp.asarray(jcodes))))
    assert tpq.quantization_error(tbook, torch.from_numpy(x)) == \
        pytest.approx(jpq.quantization_error(book, jnp.asarray(x)),
                      rel=1e-5)
    wide = tpq.PQCodebook(centroids=torch.zeros(2, 300, 3))
    assert tpq.encode(wide, torch.zeros(5, 6)).dtype == torch.int32


def test_train_draws_from_the_generator_and_lowers_the_error():
    x = torch.from_numpy(pq_points(7))
    a = tpq.train(torch.Generator().manual_seed(0), x, part_cnt=4,
                  cluster_cnt=16, iters=8)
    b = tpq.train(torch.Generator().manual_seed(0), x, part_cnt=4,
                  cluster_cnt=16, iters=8)
    torch.testing.assert_close(a.centroids, b.centroids, rtol=0, atol=0)
    assert a.centroids.shape == (4, 16, 4)
    once = tpq.train(torch.Generator().manual_seed(0), x, part_cnt=4,
                     cluster_cnt=16, iters=0)
    assert tpq.quantization_error(a, x) < tpq.quantization_error(once, x)
    few = tpq.train(torch.Generator().manual_seed(0), x[:5], part_cnt=4,
                    cluster_cnt=16, iters=2)
    assert few.centroids.shape == (4, 16, 4)
    with pytest.raises(ValueError, match="not divisible"):
        tpq.train(torch.Generator(), x, part_cnt=5)


# -- compressed serving: AUC ------------------------------------------------------


def test_compressed_export_int8_and_pq_auc_parity(tmp_path):
    """tests/test_serve.py's compressed-export case through the port: int8
    and PQ codes of a trained FM (the port's CTRTrainer) score within the
    JAX test's AUC margins of the fp32 model, through ``load_model``."""
    rng = np.random.default_rng(0)
    f, k, n, nnz = 256, 8, 512, 4
    fids = rng.integers(1, f, size=(n, nnz)).astype(np.int32)
    w_true = rng.normal(size=f).astype(np.float32)
    labels = (1 / (1 + np.exp(-w_true[fids].sum(1))) >
              rng.random(n)).astype(np.float32)
    batch = {"fids": fids, "vals": np.ones((n, nnz), np.float32),
             "mask": np.ones((n, nnz), np.float32), "labels": labels}
    init = {"w": np.zeros(f, np.float32),
            "v": (rng.standard_normal((f, k)) / np.sqrt(k)).astype(
                np.float32)}
    tr = CTRTrainer(tfm.params_from_numpy(init, "cpu"), tfm.logits,
                    TrainConfig(learning_rate=0.3),
                    fused_fn=tfm.logits_with_l2, device="cpu")
    tr.health = None
    tr.fit_fullbatch_scan(batch, 40)
    params = {kk: v.numpy() for kk, v in tr.params.items()}
    fp32 = tserve.ServingModel("fm", params, device="cpu").score(batch)
    auc_fp32 = auc_exact(fp32, labels)
    assert auc_fp32 > 0.8
    p_int8, p_pq = str(tmp_path / "int8.npz"), str(tmp_path / "pq.npz")
    texport.save_compressed_npz(p_int8, params, model="fm", device="cpu")
    texport.save_compressed_npz(p_pq, params, model="fm", pq_leaves=("v",),
                                pq_parts=4, pq_clusters=64, device="cpu")
    auc_int8 = auc_exact(tserve.load_model(p_int8, device="cpu").score(
        batch), labels)
    auc_pq = auc_exact(tserve.load_model(p_pq, device="cpu").score(batch),
                       labels)
    assert auc_int8 >= auc_fp32 - 0.01, (auc_int8, auc_fp32)
    assert auc_pq >= auc_fp32 - 0.03, (auc_pq, auc_fp32)
    with np.load(p_int8) as z:
        assert z["v__codes"].dtype == np.uint8 and z["v__codes"].size == \
            params["v"].size
    with np.load(p_pq) as z:
        assert z["v__codes"].shape == (f, 4) and \
            z["v__codes"].dtype == np.uint8
    # the JAX server scores the port's artifact alike
    np.testing.assert_allclose(
        jserve_model.load_model(p_pq).score(batch),
        tserve.load_model(p_pq, device="cpu").score(batch),
        rtol=1e-5, atol=1e-5)


def test_deepfm_artifact_scores_alike_in_both_packages(tmp_path):
    """A DeepFM written by the port scores the same through either
    package's ``load_model`` (tanh tolerance)."""
    p = jax.tree_util.tree_map(np.asarray, jdeepfm.init(
        jax.random.PRNGKey(2), 128, 3, 4, hidden=8))
    rng = np.random.default_rng(9)
    p["w"] = rng.normal(0, 0.1, 128).astype(np.float32)
    path = str(tmp_path / "d.npz")
    texport.save_compressed_npz(path, p, model="deepfm", device="cpu")
    b = {"fids": rng.integers(0, 128, (10, 5)).astype(np.int32),
         "vals": np.ones((10, 5), np.float32),
         "rep_fids": rng.integers(0, 128, (10, 3)).astype(np.int32),
         "rep_mask": np.ones((10, 3), np.float32)}
    np.testing.assert_allclose(
        tserve.load_model(path, device="cpu").score(b),
        jserve_model.load_model(path).score(b), rtol=1e-4, atol=2e-4)
