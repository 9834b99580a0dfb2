"""The port stands alone: ``lightctr_tpu_torch``, ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` import neither ``jax``, ``optax`` nor
``lightctr_tpu`` (an AST walk of every file),
importing the serving, training and attention slices and the kernel
benches leaves them out of ``sys.modules``, the copied native
sources match the JAX package's, and ``chip_smoke.py`` refuses to run
without CUDA or alone in a directory."""

import ast
import glob
import os
import shutil
import subprocess
import sys

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO_ROOT, "lightctr_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "optax", "lightctr_tpu")


def _port_sources():
    files = sorted(glob.glob(os.path.join(PORT, "**", "*.py"),
                             recursive=True))
    # the card's tests run where JAX is not installed, and spawned ranks
    # re-import the module of the program they run
    return files + [os.path.join(REPO_ROOT, "chip_smoke.py"),
                    os.path.join(REPO_ROOT, "tests", "test_torch_cuda.py"),
                    os.path.join(REPO_ROOT, "tests", "torch_dp_worlds.py")]


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], node.lineno


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_sources()
    assert len(files) > 20
    bad = [f"{os.path.relpath(p, REPO_ROOT)}:{line} imports {root}"
           for p in files for root, line in _imported_roots(p)
           if root in FORBIDDEN]
    assert not bad, bad


def test_importing_the_serving_slice_loads_no_jax():
    code = ("import sys; import lightctr_tpu_torch.serve, "
            "lightctr_tpu_torch.ops.sparse_kernels, "
            "lightctr_tpu_torch.models.sparse_trainer, "
            "lightctr_tpu_torch.optim.fused_adagrad, "
            "lightctr_tpu_torch.dist.collectives, "
            "lightctr_tpu_torch.core.mesh, "
            "lightctr_tpu_torch.nn.flash_attention, "
            "lightctr_tpu_torch.nn.ring_attention, "
            "lightctr_tpu_torch.tools.sparse_kernel_bench, "
            "lightctr_tpu_torch.tools.kernel_bench, "
            "lightctr_tpu_torch.tools.path_ab, "
            "lightctr_tpu_torch.tools.kernel_ab, "
            "lightctr_tpu_torch.tools.ab_roots, "
            "lightctr_tpu_torch.tools.world_stress, "
            "lightctr_tpu_torch.data.streaming, "
            "lightctr_tpu_torch.data.synth, "
            "lightctr_tpu_torch.data.ingest, "
            "lightctr_tpu_torch.data.text, "
            "lightctr_tpu_torch.optim, "
            "lightctr_tpu_torch.ops.activations, "
            "lightctr_tpu_torch.core.rng, "
            "lightctr_tpu_torch.core.precision, "
            "lightctr_tpu_torch.models.widedeep, "
            "lightctr_tpu_torch.models.deepfm, "
            "lightctr_tpu_torch.models.export, "
            "lightctr_tpu_torch.ops.pq, "
            "lightctr_tpu_torch.nn.dense, "
            "lightctr_tpu_torch.models.ffm, "
            "lightctr_tpu_torch.models.nfm, "
            "lightctr_tpu_torch.models.attention_ctr, "
            "lightctr_tpu_torch.ckpt, "
            "lightctr_tpu_torch.ckpt.checkpoint, "
            "lightctr_tpu_torch.cli, "
            "lightctr_tpu_torch.cli.__main__, "
            "lightctr_tpu_torch.nn.conv, lightctr_tpu_torch.nn.pool, "
            "lightctr_tpu_torch.nn.lstm, lightctr_tpu_torch.nn.attention, "
            "lightctr_tpu_torch.nn.sample, "
            "lightctr_tpu_torch.models.dl_trainer, "
            "lightctr_tpu_torch.models.cnn, lightctr_tpu_torch.models.rnn, "
            "lightctr_tpu_torch.models.vae, lightctr_tpu_torch.models.gbm, "
            "lightctr_tpu_torch.models.stacking, "
            "lightctr_tpu_torch.models.em, lightctr_tpu_torch.models.gmm, "
            "lightctr_tpu_torch.models.plsa, "
            "lightctr_tpu_torch.models.embedding, "
            "lightctr_tpu_torch.obs.quality, "
            "lightctr_tpu_torch.tools.ingest_compile, "
            "lightctr_tpu_torch.models.ann, lightctr_tpu_torch.ops.pca, "
            "lightctr_tpu_torch.ops.ensembling, "
            "lightctr_tpu_torch.graph, lightctr_tpu_torch.graph.dag, "
            "lightctr_tpu_torch.obs.device, "
            "lightctr_tpu_torch.obs.resources, "
            "lightctr_tpu_torch.utils, lightctr_tpu_torch.utils.profiling, "
            "lightctr_tpu_torch.online, lightctr_tpu_torch.online.trainer, "
            "lightctr_tpu_torch.online.swap, "
            "lightctr_tpu_torch.online.freshness; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}); print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("name", sorted(
    os.path.basename(p) for p in glob.glob(
        os.path.join(REPO_ROOT, "lightctr_tpu", "native", "*.cpp"))))
def test_native_sources_are_copies(name):
    with open(os.path.join(REPO_ROOT, "lightctr_tpu", "native", name),
              "rb") as a, open(os.path.join(PORT, "native", name), "rb") as b:
        assert a.read() == b.read()


def test_chip_smoke_refuses_without_cuda_and_alone(tmp_path):
    """No CUDA here: the script exits non-zero and prints no result.  The
    same holds for a directory with the script and nothing else of the
    repo."""
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(REPO_ROOT, "chip_smoke.py"), alone)
    for cwd in (REPO_ROOT, str(alone)):
        proc = subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
            text=True, timeout=120,
            env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
        assert proc.returncode != 0, cwd
        assert proc.stdout == "", proc.stdout
