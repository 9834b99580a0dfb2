"""The port's CLI (``python -m lightctr_tpu_torch.cli``) against the JAX
package's on the CPU, mirroring tests/test_cli_zoo.py's CTR and seqctr
cases and tests/test_harness.py::test_cli_fm_end_to_end.

  - the parser: the JAX parser's subcommands, and on each its flags with
    their defaults, types and choices, plus ``--device``;
  - every ported subcommand run in-process with ``--device cpu`` beside
    the JAX CLI on one tiny file, the port's ``init`` replaced by the JAX
    init carried across: the same report keys, ``final_loss`` and the
    train AUC within rtol 1e-4 (the Wide&Deep family's tanh bound);
    ``--dp`` (a one-rank group) against the JAX mesh over the 8 CPU
    devices, on a batch they split evenly;
  - ``--ckpt-dir`` and ``--dump-scores``: the checkpoint restores to
    params whose scores equal the dumped file within 1e-6;
  - the rest of the zoo (cnn, rnn, vae, gbm, stack, gmm, plsa, embed)
    beside the JAX CLI on tests/test_cli_zoo.py's tiny files, the port's
    inits replaced by the JAX inits carried across and its draws (the
    VAE's noise, word2vec's negatives) by the JAX CLI's: the same report
    keys and numbers, at each model's tolerance (``ZOO_TOL``);
  - the default device is CUDA, which raises here."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightctr_tpu.cli import __main__ as jcli
from lightctr_tpu_torch import ckpt
from lightctr_tpu_torch.cli import __main__ as tcli
from lightctr_tpu_torch.models import _common
from lightctr_tpu_torch.models import attention_ctr as tattn
from lightctr_tpu_torch.models import deepfm as tdeepfm
from lightctr_tpu_torch.models import ffm as tffm
from lightctr_tpu_torch.models import fm as tfm
from lightctr_tpu_torch.models import nfm as tnfm
from lightctr_tpu_torch.models import widedeep as twidedeep

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI_TOL = dict(rtol=1e-4)


def _actions(parser):
    """{subcommand: {dest: (option strings, default, type name, choices,
    required, action)}} of a parser built by ``build_parser``."""
    sub = next(a for a in parser._actions
               if a.__class__.__name__ == "_SubParsersAction")
    out = {}
    for name, sp in sub.choices.items():
        out[name] = {
            a.dest: (tuple(a.option_strings), a.default,
                     getattr(a.type, "__name__", None), a.choices,
                     a.required, a.__class__.__name__)
            for a in sp._actions if a.dest != "help"}
    return out


def test_parser_has_the_jax_subcommands_flags_and_defaults():
    want, got = _actions(jcli.build_parser()), _actions(tcli.build_parser())
    assert sorted(got) == sorted(want)
    for name, flags in want.items():
        extra = dict(got[name])
        dev = extra.pop("device")
        assert dev[:2] == (("--device",), "cuda"), name
        assert extra == flags, name
    assert sorted(tcli.CTR_MODELS + tuple(tcli.BRANCHES)) == sorted(want)


@pytest.fixture(scope="module")
def libffm_file(tmp_path_factory):
    """tests/test_cli_zoo.py's file: 80 rows of 4 fields, a parity label."""
    path = tmp_path_factory.mktemp("cli") / "train.ffm"
    rng = np.random.default_rng(0)
    with open(path, "w") as f:
        for _ in range(80):
            fids = rng.integers(1, 60, size=4)
            label = int(fids.sum() % 2)
            f.write(f"{label} " + " ".join(
                f"{fd}:{fid}:1" for fd, fid in zip(range(4), fids)) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def seq_file(tmp_path_factory):
    """tests/test_cli_zoo.py's sequence file."""
    path = tmp_path_factory.mktemp("cli") / "seq.txt"
    rng = np.random.default_rng(3)
    with open(path, "w") as f:
        for _ in range(60):
            ids = rng.integers(1, 40, size=rng.integers(3, 8))
            f.write(f"{int(ids[0] % 2)} " + " ".join(map(str, ids)) + "\n")
    return str(path)


def _carry_init(monkeypatch, model):
    """Replace the port's init of ``model`` by the JAX init (the JAX CLI's
    key, ``PRNGKey(seed)``) carried across as tensors."""
    from lightctr_tpu.models import attention_ctr as jattn
    from lightctr_tpu.models import deepfm as jdeepfm
    from lightctr_tpu.models import ffm as jffm
    from lightctr_tpu.models import fm as jfm
    from lightctr_tpu.models import nfm as jnfm
    from lightctr_tpu.models import widedeep as jwidedeep

    def carried(jinit):
        def init(gen, *args, device="cpu", **kw):
            p = jinit(jax.random.PRNGKey(0), *args, **kw)
            return _common.params_from_numpy(
                jax.tree_util.tree_map(np.asarray, p), device)
        return init

    mod, attr, jinit = {
        "fm": (tfm, "init", jfm.init), "ffm": (tffm, "init", jffm.init),
        "nfm": (tnfm, "init", jnfm.init),
        "widedeep": (twidedeep, "init", jwidedeep.init),
        "deepfm": (tdeepfm, "init", jdeepfm.init),
        "dcn": (tdeepfm, "dcn_init", jdeepfm.dcn_init),
        "seqctr": (tattn, "init", jattn.init),
    }[model]
    monkeypatch.setattr(mod, attr, carried(jinit))


def run(capsys, main, argv):
    assert main(list(argv)) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _keys(rep):
    return {k: sorted(v) if isinstance(v, dict) else None
            for k, v in rep.items() if k != "wall_time_s"}


def _assert_reports_agree(rt, rj):
    assert _keys(rt) == _keys(rj)
    np.testing.assert_allclose(rt["final_loss"], rj["final_loss"],
                               **CLI_TOL)
    np.testing.assert_allclose(rt["train"]["auc"], rj["train"]["auc"],
                               **CLI_TOL)
    assert np.isfinite(rt["final_loss"])


@pytest.mark.parametrize("model", ["fm", "ffm", "nfm", "widedeep",
                                   "deepfm", "dcn"])
@pytest.mark.parametrize("mode", ["full", "minibatch"])
def test_ctr_subcommand_matches_the_jax_cli(monkeypatch, capsys,
                                            libffm_file, model, mode):
    """Three epochs, full-batch or minibatches of 16 (shuffled alike: the
    port's ``minibatches`` is the JAX package's), with ``--eval-data``."""
    _carry_init(monkeypatch, model)
    argv = [model, "--data", libffm_file, "--epochs", "3",
            "--eval-data", libffm_file, "--factor", "4"]
    argv += ["--full-batch"] if mode == "full" else ["--batch-size", "16"]
    rj = run(capsys, jcli.main, argv)
    rt = run(capsys, tcli.main, argv + ["--device", "cpu"])
    _assert_reports_agree(rt, rj)
    np.testing.assert_allclose(rt["eval"]["auc"], rj["eval"]["auc"],
                               **CLI_TOL)


@pytest.mark.parametrize("model", ["deepfm", "dcn"])
def test_dp_matches_the_jax_cli(monkeypatch, capsys, libffm_file, model):
    """``--dp``: the port's one-rank group over the CPU against the JAX
    mesh over the 8 CPU devices; 80 rows split evenly, so the global
    batch and its mean loss are the same."""
    _carry_init(monkeypatch, model)
    argv = [model, "--data", libffm_file, "--epochs", "3", "--dp",
            "--factor", "4"]
    rj = run(capsys, jcli.main, argv)
    rt = run(capsys, tcli.main, argv + ["--device", "cpu"])
    assert rj["parallel"]["devices"] == 8 and rt["parallel"] == {
        "devices": 1, "compress_bits": None}
    rt["parallel"] = rj["parallel"]
    _assert_reports_agree(rt, rj)


def test_compress_bits_implies_dp_and_trains(capsys, libffm_file):
    rep = run(capsys, tcli.main, ["deepfm", "--data", libffm_file,
                                  "--epochs", "3", "--compress-bits", "8",
                                  "--device", "cpu"])
    assert rep["parallel"] == {"devices": 1, "compress_bits": 8}
    assert np.isfinite(rep["final_loss"])


def test_seqctr_matches_the_jax_cli(monkeypatch, capsys, seq_file):
    """tests/test_cli_zoo.py's seqctr case (Adam, full batch) with
    minibatches of 16 and a held-out pass beside it."""
    _carry_init(monkeypatch, "seqctr")
    argv = ["seqctr", "--data", seq_file, "--epochs", "2", "--dim", "16",
            "--heads", "2", "--batch-size", "16", "--eval-data", seq_file]
    rj = run(capsys, jcli.main, argv)
    rt = run(capsys, tcli.main, argv + ["--device", "cpu"])
    _assert_reports_agree(rt, rj)
    assert rt["vocab"] == rj["vocab"] > 1


@pytest.mark.parametrize("model", ["ffm", "deepfm", "seqctr"])
def test_checkpoint_restores_to_the_dumped_scores(capsys, tmp_path,
                                                  libffm_file, seq_file,
                                                  model):
    """``--ckpt-dir`` writes step ``epochs`` with the params and the
    optimizer state; restoring it gives params whose scores equal the
    ``--dump-scores`` file (6 significant digits) within 1e-6."""
    from lightctr_tpu_torch.data import load_libffm
    from lightctr_tpu_torch.optim.updaters import AdagradState, AdamState

    data = seq_file if model == "seqctr" else libffm_file
    scores = tmp_path / "scores.txt"
    rep = run(capsys, tcli.main, [
        model, "--data", data, "--epochs", "2", "--batch-size", "16",
        "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck"), "--dump-scores", str(scores)])
    assert rep["checkpoint"] == str(tmp_path / "ck" / "step_2")
    assert rep["scores"] == str(scores)
    assert ckpt.latest_step(str(tmp_path / "ck")) == 2
    state = ckpt.restore(str(tmp_path / "ck"))
    dumped = np.loadtxt(scores)
    with torch.no_grad():
        if model == "seqctr":
            assert isinstance(state["opt_state"], AdamState)
            batch, _ = tcli.parse_seq_file(data, 128)
            z = tattn.make_logits(4)(state["params"], {
                k: torch.from_numpy(v) for k, v in batch.items()})
        else:
            assert isinstance(state["opt_state"], AdagradState)
            ds = load_libffm(data)
            b = ds.batch_dict()
            if model == "deepfm":
                b = twidedeep.make_batch(ds, *twidedeep.field_representatives(
                    ds.fids, ds.fields, ds.mask, ds.field_cnt))
            fn = tdeepfm.logits if model == "deepfm" else tffm.logits
            z = fn(state["params"], {k: torch.from_numpy(v)
                                     for k, v in b.items()})
    np.testing.assert_allclose(torch.sigmoid(z).numpy(), dumped, atol=1e-6)


#: per subcommand: the relative tolerance of its numbers against the JAX
#: CLI's (the tanh paths' trajectory bound, the GBM's, word2vec's, the
#: EM steps')
ZOO_TOL = {"cnn": 1e-4, "rnn": 1e-4, "vae": 1e-4, "gbm": 1e-5,
           "gbm10": 1e-5, "stack": 1e-4, "gmm": 1e-5, "plsa": 1e-5,
           "embed": 1e-4, "embed_hs": 1e-4}


@pytest.fixture(scope="module")
def zoo_files(tmp_path_factory):
    """tests/test_cli_zoo.py's files: 30 dense rows of 784 random pixels
    with a 0/1 label, 16 lines of two topics, 60 points in two blobs."""
    root = tmp_path_factory.mktemp("zoo")
    rng = np.random.default_rng(1)
    rows = [",".join([str(rng.integers(0, 2))]
                     + [str(p) for p in rng.integers(0, 255, size=784)])
            for _ in range(30)]
    (root / "train.csv").write_text("\n".join(rows) + "\n")
    docs = ["tpu mesh shard collective matmul",
            "mesh shard pjit collective tpu",
            "gradient descent loss curve adagrad",
            "loss gradient optimizer descent step"] * 4
    (root / "docs.txt").write_text("\n".join(docs) + "\n")
    rng = np.random.default_rng(2)
    pts = np.concatenate([rng.normal(0, 0.3, size=(30, 2)),
                          rng.normal(4, 0.3, size=(30, 2))])
    np.savetxt(root / "pts.csv", pts, delimiter=",", fmt="%.4f")
    return {k: str(root / f) for k, f in (("dense", "train.csv"),
                                          ("text", "docs.txt"),
                                          ("pts", "pts.csv"))}


ZOO_ARGV = {
    "cnn": ["cnn", "--data", "dense", "--epochs", "2", "--n-classes", "2",
            "--hidden", "16"],
    "rnn": ["rnn", "--data", "dense", "--epochs", "2", "--n-classes", "2",
            "--hidden", "12"],
    "vae": ["vae", "--data", "dense", "--epochs", "2", "--hidden", "12",
            "--gauss", "4"],
    "gbm": ["gbm", "--data", "dense", "--n-trees", "3", "--max-depth", "3"],
    "gbm10": ["gbm", "--data", "dense", "--n-trees", "1", "--max-depth", "3",
              "--n-classes", "2"],
    "stack": ["stack", "--data", "dense", "--n-trees", "3", "--max-depth",
              "3", "--lr-steps", "20"],
    "gmm": ["gmm", "--data", "pts", "--clusters", "2", "--epochs", "10"],
    "plsa": ["plsa", "--data", "text", "--topics", "2", "--epochs", "10"],
    "embed": ["embed", "--data", "text", "--epochs", "2", "--dim", "8",
              "--quantize", "--cluster", "2"],
    "embed_hs": ["embed", "--data", "text", "--epochs", "3", "--dim", "8",
                 "--mode", "hierarchical", "--batch-size", "2"],
}


def _carry_zoo(monkeypatch, case, argv):
    """The port's inits -> the JAX CLI's (``PRNGKey(seed)``) carried
    across; the VAE's noise and word2vec's negatives -> the JAX CLI's
    draws, in its order."""
    from lightctr_tpu.models import cnn as jcnn
    from lightctr_tpu.models import embedding as jemb
    from lightctr_tpu.models import gmm as jgmm
    from lightctr_tpu.models import plsa as jplsa
    from lightctr_tpu.models import rnn as jrnn
    from lightctr_tpu.models import vae as jvae
    from lightctr_tpu_torch.models import cnn as tcnn
    from lightctr_tpu_torch.models import embedding as temb
    from lightctr_tpu_torch.models import gmm as tgmm
    from lightctr_tpu_torch.models import plsa as tplsa
    from lightctr_tpu_torch.models import rnn as trnn
    from lightctr_tpu_torch.models import vae as tvae

    def carried(jinit, key=jax.random.PRNGKey(0)):
        def init(gen, *args, device="cpu", **kw):
            p = jinit(key, *args, **kw)
            if isinstance(p, tuple):
                p = type(p)(*(np.asarray(a) for a in p))
            return _common.params_from_numpy(
                jax.tree_util.tree_map(np.asarray, p), device)
        return init

    model = argv[0]
    for mod, jmod in ((tcnn, jcnn), (trnn, jrnn), (tvae, jvae),
                      (tplsa, jplsa), (temb, jemb)):
        if mod.__name__.rsplit(".", 1)[1] in (model, "embedding") and \
                (model != "embed" or mod is temb):
            monkeypatch.setattr(mod, "init", carried(jmod.init))
    if model == "gmm":
        monkeypatch.setattr(tgmm, "init_from_data",
                            carried(jgmm.init_from_data))
    draws = []
    if model == "vae":
        key = jax.random.PRNGKey(0)
        for _ in range(2 * 3):
            key, sub = jax.random.split(key)
            draws.append(np.asarray(jax.random.normal(sub, (10, 4))))
        monkeypatch.setattr(tvae.VAETrainer, "_noise",
                            lambda self, rows: torch.from_numpy(draws.pop(0).copy()))
    if case == "embed":
        # the JAX trainer's categorical draws from PRNGKey(seed + 1), one
        # split a step, for as many steps as the run takes
        from lightctr_tpu.data import text as jtext

        docs = [jtext.tokenize(line) for line in open(argv[2])
                if line.strip()]
        words, counts, w2i = jtext.build_vocab(docs, max_size=5000)
        n = len(jemb.cbow_pairs(jtext.docs_to_ids(docs, w2i), 6,
                                counts=counts, seed=0)[0])
        b = min(256, n)
        key = jax.random.PRNGKey(1)
        logits = jnp.asarray(jemb.negative_table_logits(counts))
        for _ in range(2 * (n // b)):
            key, sub = jax.random.split(key)
            draws.append(np.asarray(jax.random.categorical(
                sub, logits, shape=(b, 5))))
        monkeypatch.setattr(temb.Word2VecTrainer, "_negatives",
                            lambda self, rows: torch.from_numpy(draws.pop(0).copy()))
    return draws


def _close(got, want, rtol, path=""):
    """Report values equal (strings, lists of ints, shapes) or within
    ``rtol`` (floats), key by key."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _close(got[k], want[k], rtol, f"{path}.{k}")
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-7,
                                   err_msg=path)
    else:
        assert got == want, path


@pytest.mark.parametrize("case", sorted(ZOO_ARGV))
def test_zoo_subcommand_matches_the_jax_cli(monkeypatch, capsys, zoo_files,
                                           case):
    argv = [zoo_files.get(a, a) for a in ZOO_ARGV[case]]
    draws = _carry_zoo(monkeypatch, case, argv)
    rj = run(capsys, jcli.main, argv)
    rt = run(capsys, tcli.main, argv + ["--device", "cpu"])
    assert not draws
    assert _keys(rt) == _keys(rj)
    rj.pop("wall_time_s", None), rt.pop("wall_time_s", None)
    if case == "embed":
        # the GMM over the embeddings draws its init in either package
        assert sum(rt.pop("cluster_sizes")) == sum(rj.pop("cluster_sizes"))
    if case == "plsa":
        # words of equal counts tie in P(w|t) up to the last place, so
        # their order within a topic may differ
        assert [set(t) for t in rt.pop("topics")] == \
            [set(t) for t in rj.pop("topics")]
    _close(rt, rj, ZOO_TOL[case])


def test_the_cli_defaults_to_cuda(monkeypatch, libffm_file):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["fm", "--data", libffm_file])


def test_cli_fm_end_to_end(tmp_path):
    """Drive the CLI like a user, in a process of its own (the JAX
    package's tests/test_harness.py case, with ``--device cpu``)."""
    data = str(tmp_path / "train.csv")
    rng = np.random.default_rng(0)
    with open(data, "w") as f:
        for _ in range(120):
            fids = rng.integers(1, 50, size=5)
            label = int(fids.sum() % 2)
            f.write(f"{label} " + " ".join(f"0:{fid}:1" for fid in fids)
                    + "\n")
    out = subprocess.run(
        [sys.executable, "-m", "lightctr_tpu_torch.cli", "fm", "--data",
         data, "--epochs", "5", "--full-batch", "--factor", "4",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=REPO_ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["model"] == "fm" and "train" in report
    assert np.isfinite(report["final_loss"])
    pts = str(tmp_path / "pts.csv")
    np.savetxt(pts, np.concatenate([rng.normal(0, 0.3, size=(30, 2)),
                                    rng.normal(4, 0.3, size=(30, 2))]),
               delimiter=",", fmt="%.4f")
    out = subprocess.run(
        [sys.executable, "-m", "lightctr_tpu_torch.cli", "gmm", "--data",
         pts, "--clusters", "2", "--device", "cpu"], capture_output=True,
        text=True, timeout=300, cwd=REPO_ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert sum(report["cluster_sizes"]) == 60
    assert np.isfinite(report["final_loglik"])


def test_dcn_reads_no_feature_value_in_either_package():
    """Why chip_smoke.py's cli phase holds DCN's train AUC and not its
    held-out AUC (``CLI_VALUE_BLIND``): DCN's logits read only the
    per-field embeddings of ``rep_fids``, in the JAX package as in the
    port, so scaling every feature value leaves them unchanged, where
    DeepFM's (whose wide term reads the values) move.  The Criteo proxy's
    label is a logistic in two numeric fields' values."""
    import jax.numpy as jnp

    from lightctr_tpu.models import deepfm as jdeepfm
    from test_torch_models_deep import family_batch

    b = family_batch(5)
    scaled = dict(b, vals=3.0 * b["vals"])
    for kind, jinit, jfn, tfn in (
            ("dcn", lambda k: jdeepfm.dcn_init(k, 256, 4, 8, hidden=16),
             jdeepfm.dcn_logits, tdeepfm.dcn_logits),
            ("deepfm", lambda k: jdeepfm.init(k, 256, 4, 8, hidden=16),
             jdeepfm.logits, tdeepfm.logits)):
        jp = jinit(jax.random.PRNGKey(0))
        tp = _common.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jp), "cpu")
        if "w" in jp:
            jp = dict(jp, w=jnp.full_like(jp["w"], 0.1))
            tp = dict(tp, w=torch.full_like(tp["w"], 0.1))
        zj = [np.asarray(jfn(jp, {k: jnp.asarray(v) for k, v in x.items()}))
              for x in (b, scaled)]
        with torch.no_grad():
            zt = [tfn(tp, {k: torch.from_numpy(v) for k, v in x.items()})
                  .numpy() for x in (b, scaled)]
        for z in (zj, zt):
            moved = float(np.abs(z[0] - z[1]).max())
            assert (moved == 0.0) == (kind == "dcn"), (kind, moved)
