"""The port's kernel benches (``lightctr_tpu_torch.tools.sparse_kernel_bench``
and ``lightctr_tpu_torch.tools.kernel_bench``) on the CPU, where they run
the plain versions at small shapes: every cell carries its keys, says
from the launch counts that the plain version ran, and nothing is written
without ``--out``.  On the card ``chip_smoke.py``'s ``bench`` phase runs
them at full size."""

import json
import os
import subprocess
import sys

import pytest

from lightctr_tpu_torch.tools import kernel_bench, sparse_kernel_bench

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPARSE_KEYS = {"phase", "kernel", "shape", "impl_plain", "impl_kernel",
               "kernel_is_plain", "kernel_launches", "t_plain_ms",
               "t_kernel_ms", "speedup_x", "timing"}
ADAGRAD_KEYS = {"kernel", "n", "impl", "launches", "kernel_us", "plain_us",
                "kernel_gbps", "plain_gbps", "speedup"}
FLASH_KEYS = {"kernel", "shape", "dtype", "causal", "impl", "launches",
              "kernel_ms", "plain_ms", "sdpa_ms", "kernel_tflops",
              "plain_tflops", "sdpa_tflops", "speedup_vs_plain"}


def test_sparse_kernel_bench_cells_on_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rep = sparse_kernel_bench.run(device="cpu", steps=2)
    assert os.listdir(tmp_path) == []
    assert rep["device"] == "cpu"
    kernels = [c["kernel"] for c in rep["cells"]]
    assert kernels == ["dedup_ids", "gather_rows", "merge_rows",
                       "merge_apply", "quantize_pack", "quantize_pack_ef"]
    assert [c["phase"] for c in rep["cells"]] == [
        "dedup", "gather", "merge", "merge_apply", "pack", "pack"]
    for c in rep["cells"]:
        assert set(c) == SPARSE_KEYS
        assert c["impl_kernel"] == "plain" and c["kernel_is_plain"]
        assert c["kernel_launches"] == 0
        assert c["t_plain_ms"] > 0 and c["t_kernel_ms"] > 0


def test_kernel_bench_cells_on_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rep = kernel_bench.run(device="cpu", steps=2)
    assert os.listdir(tmp_path) == []
    assert [c["n"] for c in rep["adagrad"]] == list(
        kernel_bench.SHAPES["cpu"][0])
    assert [tuple(c["shape"]) for c in rep["flash"]] == list(
        kernel_bench.SHAPES["cpu"][1])
    for c in rep["adagrad"]:
        assert set(c) == ADAGRAD_KEYS and c["impl"] == "plain"
        assert c["launches"] == 0 and c["kernel_gbps"] > 0
    for c in rep["flash"]:
        assert set(c) == FLASH_KEYS and c["impl"] == "plain"
        assert c["causal"] and c["dtype"] == "bfloat16"
        assert c["launches"] == 0 and c["kernel_tflops"] > 0


def test_the_card_shapes_are_the_jax_tools():
    sh = sparse_kernel_bench.SHAPES["cuda"]
    assert (sh["k"], sh["gather_rows"], sh["gather_n"]) == (16384, 65536,
                                                            8192)
    assert (sh["s"], sh["table_rows"], sh["payload"]) == (8192, 1 << 18,
                                                          16384)
    assert kernel_bench.SHAPES["cuda"] == (
        (1 << 20, 1 << 24),
        ((4, 1024, 8, 64), (2, 4096, 8, 64), (1, 8192, 8, 64)))


@pytest.mark.parametrize("tool, out", [
    ("sparse_kernel_bench", "TORCH_SPARSE_KERNEL_BENCH.json"),
    ("kernel_bench", "TORCH_KERNEL_BENCH.json"),
])
def test_cli_writes_only_with_out(tmp_path, tool, out):
    """``python -m``: without ``--out`` nothing is written; with it the
    report lands there; the JAX artifact's name is refused; without CUDA
    the default device raises."""
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    mod = f"lightctr_tpu_torch.tools.{tool}"
    run = lambda *a: subprocess.run(  # noqa: E731
        [sys.executable, "-m", mod, *a], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    proc = run("--device", "cpu", "--steps", "1")
    assert proc.returncode == 0, proc.stderr
    assert os.listdir(tmp_path) == []
    assert "cells" in json.loads(proc.stdout) or "flash" in json.loads(
        proc.stdout)
    proc = run("--device", "cpu", "--steps", "1", "--out", out)
    assert proc.returncode == 0, proc.stderr
    with open(tmp_path / out) as f:
        assert json.load(f)["device"] == "cpu"
    jax_name = ("SPARSE_KERNEL_BENCH.json" if tool == "sparse_kernel_bench"
                else "PALLAS_BENCH.json")
    proc = run("--device", "cpu", "--out", jax_name)
    assert proc.returncode != 0 and "JAX package's artifact" in proc.stderr
    assert not (tmp_path / jax_name).exists()
    proc = run("--steps", "1")
    if not __import__("torch").cuda.is_available():
        assert proc.returncode != 0
        assert "CUDA is not available" in proc.stderr


def test_path_ab_refuses_a_root_without_the_script_or_the_card(tmp_path):
    """The A/B tool times a checkout through its own chip_smoke.py: a
    directory without it is refused before any process starts, and
    without CUDA the checkout's process fails instead of printing a
    result."""
    from lightctr_tpu_torch.tools import path_ab

    with pytest.raises(FileNotFoundError, match="no chip_smoke.py"):
        path_ab.main([str(tmp_path)])
    if not __import__("torch").cuda.is_available():
        with pytest.raises(subprocess.CalledProcessError):
            path_ab.run_root(REPO_ROOT)


def test_kernel_ab_refuses_a_root_without_the_script_or_the_card(tmp_path):
    """The kernel A/B builds and times a checkout's kernels through its
    own chip_smoke.py: a directory without it is refused before any
    process starts, and without CUDA the checkout's process fails instead
    of printing a result."""
    from lightctr_tpu_torch.tools import kernel_ab

    with pytest.raises(FileNotFoundError, match="no chip_smoke.py"):
        kernel_ab.main([str(tmp_path)])
    if not __import__("torch").cuda.is_available():
        with pytest.raises(subprocess.CalledProcessError):
            kernel_ab.run_root(REPO_ROOT)
