"""The long-context attention path of the port (``lightctr_tpu_torch.nn``)
against the JAX package on the same numpy inputs: ``full_attention``,
``flash_attention`` (its plain version, on CPU tensors) against the
interpreted Pallas kernel and, differentiated, against ``jax.grad``, the
CUDA route's refusal of inputs that require grad, ``validate_blocks``, and
``ring_self_attention`` and its gradients in worlds of 2 and 4 gloo ranks
on the CPU (spawned once per module, the ranks running
``tests/torch_dp_worlds.py``) against the JAX function on a ``seq`` mesh of
the conftest's CPU devices.  Also the mesh's ``seq`` axis
and ``make_mesh``'s device default.  The CUDA kernel is held to the plain
version on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import datetime
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dp_worlds as worlds
from lightctr_tpu.core.mesh import MeshSpec as JMeshSpec
from lightctr_tpu.core.mesh import make_mesh as jmake_mesh
from lightctr_tpu.nn import flash_attention as jflash
from lightctr_tpu.nn import ring_attention as jring
from lightctr_tpu_torch.core.mesh import (Mesh, MeshSpec, local_mesh,
                                          make_mesh, spawn_world)
from lightctr_tpu_torch.models import fm as tfm
from lightctr_tpu_torch.models.ctr_trainer import CTRTrainer
from lightctr_tpu_torch.core.config import TrainConfig
from lightctr_tpu_torch.nn import flash_attention as tflash
from lightctr_tpu_torch.nn import ring_attention as tring
from lightctr_tpu_torch.ops import sparse_kernels as tsk

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: float32 against float32 on the CPU, one formula in both packages: only
#: the order of the sums differs
FULL_RTOL, FULL_ATOL = 1e-5, 1e-6
#: the JAX flash and ring tests' own tolerance (tiled online softmax
#: against the one-shot softmax)
FLASH_RTOL, FLASH_ATOL = 2e-4, 2e-5
#: bfloat16 outputs: one bf16 ulp at |o| < 2 is 2^-7
BF16_ATOL = 2e-2


def qkv(seed, b=2, t=64, h=2, d=16):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, t, h, d)).astype(np.float32)
            for _ in range(3)]


# -- full_attention -----------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("key_mask", [False, True])
def test_full_attention_matches_jax(causal, key_mask):
    q, k, v = qkv(1, t=24, d=8)
    km = None
    if key_mask:
        km = (np.random.default_rng(2).random((2, 24)) > 0.3).astype(
            np.float32)
        km[:, 0] = 1.0
    want = jring.full_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal,
        key_mask=None if km is None else jnp.asarray(km))
    got = tring.full_attention(
        *map(torch.from_numpy, (q, k, v)), causal=causal,
        key_mask=None if km is None else torch.from_numpy(km))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=FULL_RTOL, atol=FULL_ATOL)


# -- flash_attention ----------------------------------------------------------


@pytest.mark.parametrize("shape, causal, blocks", [
    ((2, 64, 2, 16), False, (16, 16)),
    ((2, 32, 2, 16), True, (8, 8)),
])
def test_flash_attention_plain_matches_interpreted_tpu_kernel(shape, causal,
                                                               blocks):
    """tests/test_flash_attention.py's two cases: the Pallas kernel under
    the interpreter against the port's plain version (what a CPU tensor
    runs); no launch is counted."""
    b, t, h, d = shape
    q, k, v = qkv(3 + causal, b, t, h, d)
    want = jflash.flash_attention(*map(jnp.asarray, (q, k, v)),
                                  causal=causal, block_q=blocks[0],
                                  block_k=blocks[1], interpret=True)
    before = tsk.launches("flash_attention")
    got = tflash.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                 causal=causal, block_q=blocks[0],
                                 block_k=blocks[1])
    assert tsk.launches("flash_attention") == before
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=FLASH_RTOL, atol=FLASH_ATOL)


@pytest.mark.parametrize("d", [192, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_plain_matches_interpreted_tpu_kernel_wide_heads(
        d, causal):
    """Head widths past the mma.sync kernel's 128, which the JAX kernel
    takes (VMEM tiles of (block, D)) and the port's kernels now take too:
    the plain version against the interpreted Pallas kernel."""
    t = 32 if causal else 64
    q, k, v = qkv(7 + d + causal, 1, t, 2, d)
    want = jflash.flash_attention(*map(jnp.asarray, (q, k, v)),
                                  causal=causal, block_q=16, block_k=16,
                                  interpret=True)
    got = tflash.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                 causal=causal, block_q=16, block_k=16)
    assert got.dtype == torch.float32 and got.shape == (1, t, 2, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=FLASH_RTOL, atol=FLASH_ATOL)


def _shifted(shape, dtype, elems):
    """A contiguous tensor of ``shape`` whose data starts ``elems`` elements
    into its storage (2 bytes an element for 16-bit types)."""
    n = int(np.prod(shape))
    return torch.zeros(n + elems, dtype=dtype)[elems:].view(shape)


@pytest.mark.parametrize("dtype, shape, shift, route", [
    # 16-bit with TMA-able strides and bases: the wgmma design to D = 256
    (torch.bfloat16, (2, 4096, 8, 64), 0, "wgmma"),
    (torch.float16, (1, 100, 3, 72), 0, "wgmma"),
    (torch.bfloat16, (1, 32, 2, 8), 0, "wgmma"),
    (torch.bfloat16, (1, 64, 2, 256), 0, "wgmma"),
    (torch.float16, (1, 64, 2, 160), 0, "wgmma"),
    # D % 8 != 0 (a row stride TMA refuses) or a base off 16 bytes: PR 4's
    # mma.sync kernel to D = 128
    (torch.bfloat16, (1, 70, 2, 20), 0, "mma_sync"),
    (torch.float16, (1, 64, 1, 128), 4, "mma_sync"),
    (torch.bfloat16, (2, 64, 2, 64), 1, "mma_sync"),
    # float32 at any width, and 16-bit that neither tensor-core kernel
    # takes: the FMA kernel (128-column output slices past D = 128)
    (torch.float32, (2, 256, 4, 32), 0, "fma"),
    (torch.float32, (1, 64, 2, 256), 0, "fma"),
    (torch.bfloat16, (1, 64, 1, 129), 0, "fma"),
    (torch.bfloat16, (1, 64, 2, 320), 0, "fma"),
    (torch.float16, (1, 64, 2, 136), 4, "fma"),
])
def test_flash_route_rule(dtype, shape, shift, route):
    """The one rule that picks a design from (dtype, shape, alignment),
    decided on the tensors before any launch; every design is a kernel of
    csrc/flash_attention.cu with its code in ``ROUTES``."""
    q = _shifted(shape, dtype, shift)
    k, v = torch.zeros(shape, dtype=dtype), torch.zeros(shape, dtype=dtype)
    assert tflash.flash_route(q, k, v) == route
    assert tflash.ROUTES[route] in (0, 1, 2)
    # an aligned q with a misaligned k or v takes the same route as a
    # misaligned q
    if shift:
        assert tflash.flash_route(k, q, v) == route
        assert tflash.flash_route(k, v, q) == route


def test_flash_attention_plain_keeps_the_input_dtype():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in qkv(5))
    got = tflash.flash_attention(q, k, v, causal=True)
    assert got.dtype == torch.bfloat16
    want = tring.full_attention(q.float(), k.float(), v.float(), causal=True)
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=0,
                               atol=BF16_ATOL)


@pytest.mark.parametrize("t, blocks", [(30, (16, 16)), (30, (256, 512)),
                                       (48, (64, 40)), (1000, (256, 512))])
def test_validate_blocks_matches_jax(t, blocks):
    """The same shrunk blocks, or the same ValueError (T = 30 with blocks
    of 16 has no divisor >= 8)."""
    try:
        want = jflash._validate_blocks(t, *blocks)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tflash.validate_blocks(t, *blocks)
        assert str(got.value) == str(e)
        q = torch.zeros((1, t, 1, 8))
        with pytest.raises(ValueError, match="must divide"):
            tflash.flash_attention(q, q, q, block_q=blocks[0],
                                   block_k=blocks[1])
        return
    assert tflash.validate_blocks(t, *blocks) == want


def test_flash_attention_kernel_is_registered_and_refuses_bad_inputs():
    kd = tsk.KERNELS["flash_attention"]
    assert kd.phase == "attention" and kd.source == "flash_attention.cu"
    assert os.path.isfile(os.path.join(tsk.CSRC_DIR, kd.source))
    path, line = kd.replaces.rsplit(":", 1)
    with open(os.path.join(REPO_ROOT, path)) as f:
        assert f.read().splitlines()[int(line) - 1].startswith(
            "def _flash_pallas(")
    assert tsk.dispatch("flash_attention", torch.device("cpu")) is kd.plain
    assert tflash.NEG_INF == jflash.NEG_INF
    assert tring.NEG_INF == jring.NEG_INF
    x = torch.zeros((1, 8, 2, 16))
    with pytest.raises(TypeError, match="one dtype"):
        kd.cuda(x, x.half(), x)
    with pytest.raises(TypeError, match="one dtype"):
        kd.cuda(x.double(), x.double(), x.double())
    with pytest.raises(ValueError, match="one .B, T, H, D. shape"):
        kd.cuda(x, x[:, :4], x)
    # no width or head-count limit: a D = 129 head, a D = 320 head and
    # B*H past 65,535 reach the device check like any other shape
    for shape in ((1, 8, 1, 129), (1, 8, 2, 320), (65600, 2, 1, 8)):
        wide = torch.zeros(shape, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="CUDA device"):
            kd.cuda(wide, wide, wide)
    with pytest.raises(ValueError, match="CUDA device"):
        kd.cuda(x, x, x)


def test_flash_attention_kernel_refuses_grads_first():
    """The CUDA route has no backward (nor has the JAX Pallas kernel):
    with grad mode on, inputs that require grad are refused before the
    device check, naming ``full_attention``; under ``no_grad`` the same
    CPU tensors reach the device refusal."""
    cuda = tsk.KERNELS["flash_attention"].cuda
    x = torch.zeros((1, 8, 2, 16))
    before = tsk.launches("flash_attention")
    for which in range(3):
        qkv_ = [x.clone() for _ in range(3)]
        qkv_[which].requires_grad_(True)
        with pytest.raises(RuntimeError, match="full_attention"):
            cuda(*qkv_)
        with torch.no_grad(), pytest.raises(ValueError, match="CUDA device"):
            cuda(*qkv_)
    with pytest.raises(RuntimeError, match="no backward"):
        cuda(x.half().requires_grad_(True), x.float(), x)
    assert tsk.launches("flash_attention") == before


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_plain_is_differentiable_as_jax(causal):
    """A CPU tensor runs the plain version, which autograd differentiates:
    its gradients of sum(out ** 2) match ``jax.grad`` of the JAX package's
    ``full_attention`` (its differentiable ``xla`` route)."""
    inputs = qkv(11 + causal, 2, 32, 2, 8)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    out = tflash.flash_attention(*leaves, causal=causal)
    assert out.grad_fn is not None
    (out ** 2).sum().backward()
    want = jax.grad(lambda q, k, v: jnp.sum(jring.full_attention(
        q, k, v, causal=causal) ** 2), argnums=(0, 1, 2))(
        *map(jnp.asarray, inputs))
    for leaf, jg in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jg),
                                   rtol=FULL_RTOL, atol=FULL_ATOL)


# -- the mesh's seq axis and device default -----------------------------------


@pytest.fixture
def one_rank_world(monkeypatch):
    """A gloo process group of one rank in this process, its rendezvous
    an in-process store (no port)."""
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        "gloo", store=dist.HashStore(), world_size=1, rank=0,
        timeout=datetime.timedelta(seconds=60))
    yield
    dist.destroy_process_group()


def test_make_mesh_defaults_to_cuda(one_rank_world):
    """Without ``device``, ``make_mesh`` takes CUDA and raises where there
    is none, as every entry point of the port does; ``device="cpu"`` runs
    on the CPU."""
    if torch.cuda.is_available():
        assert make_mesh(MeshSpec(data=1)).device.type == "cuda"
        assert local_mesh().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh(MeshSpec(data=1))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            local_mesh()
    mesh = make_mesh(MeshSpec(data=1), device="cpu")
    assert mesh.device == torch.device("cpu") and mesh.axis == "data"


def test_make_mesh_axes_and_refusals(one_rank_world):
    with pytest.raises(ValueError, match="seq=2 but the process group has 1"):
        make_mesh(MeshSpec(seq=2), device="cpu")
    for spec in (MeshSpec(data=2, seq=2), MeshSpec(model=2),
                 MeshSpec(embed=2)):
        with pytest.raises(ValueError, match="not yet ported"):
            make_mesh(spec, device="cpu")
    cpu = torch.device("cpu")
    seq = Mesh(group=dist.group.WORLD, rank=0, device=cpu, axis="seq")
    data = make_mesh(MeshSpec(data=1), device="cpu")
    params = tfm.params_from_numpy(worlds.fm_params(16, 2), "cpu")
    with pytest.raises(ValueError, match="'data' axis, got one over 'seq'"):
        CTRTrainer(params, tfm.logits, TrainConfig(), mesh=seq, device="cpu")
    q = torch.zeros((1, 4, 1, 8))
    with pytest.raises(ValueError, match="'seq' axis, got one over 'data'"):
        tring.ring_self_attention(data, q, q, q)
    # a ring of one is full attention
    q, k, v = (torch.from_numpy(x) for x in qkv(6, t=16, d=8))
    np.testing.assert_allclose(
        tring.ring_self_attention(seq, q, k, v, causal=True).numpy(),
        tring.full_attention(q, k, v, causal=True).numpy(),
        rtol=FLASH_RTOL, atol=FLASH_ATOL)


# -- ring_self_attention in spawned worlds ------------------------------------


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ring_world(request, tmp_path_factory):
    """(W, the JAX seq mesh, each rank's results) of one spawned world."""
    w = request.param
    out = tmp_path_factory.mktemp(f"ring{w}")
    spawn_world(worlds.attention_rank, w, "gloo", args=(str(out),),
                deadline_s=worlds.DEADLINE_S)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(w)]
    return w, jmake_mesh(JMeshSpec(seq=w)), ranks


def _jax_ring(jmesh, causal, dtype=jnp.float32):
    fn = jax.jit(functools.partial(jring.ring_self_attention, jmesh,
                                   axis="seq", causal=causal))
    return np.asarray(fn(*(jnp.asarray(x, dtype)
                           for x in worlds.attention_inputs()))
                      .astype(jnp.float32))


@pytest.mark.parametrize("causal", [False, True])
def test_ring_self_attention_matches_jax(ring_world, causal):
    """Every rank returns the whole [B, T, H, D], bit-identical across
    ranks, within the JAX ring test's tolerance of JAX's ring."""
    w, jmesh, ranks = ring_world
    want = _jax_ring(jmesh, causal)
    key = f"causal{int(causal)}"
    for res in ranks:
        assert res[key].shape == worlds.ATTN_SHAPE
        np.testing.assert_array_equal(res[key], ranks[0][key])
    np.testing.assert_allclose(ranks[0][key], want, rtol=FLASH_RTOL,
                               atol=FLASH_ATOL)
    # and both equal single-device attention
    q, k, v = (torch.from_numpy(x) for x in worlds.attention_inputs())
    np.testing.assert_allclose(
        ranks[0][key], tring.full_attention(q, k, v, causal=causal).numpy(),
        rtol=FLASH_RTOL, atol=FLASH_ATOL)


#: tests/test_ring_attention.py::test_ring_grad_flows's tolerance of the
#: ring's gradients against full attention's
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4


@pytest.mark.parametrize("causal", [False, True])
def test_ring_self_attention_grads_match_jax(ring_world, causal):
    """The gradients of sum(out ** 2) in q, k and v: bit-identical across
    ranks, and on every rank within test_ring_grad_flows' tolerance of
    ``jax.grad`` of the JAX ring on a ``seq`` mesh and of autograd through
    the port's ``full_attention``.  The differentiable call's output is
    the no-grad call's, bit for bit."""
    w, jmesh, ranks = ring_world
    key = f"causal{int(causal)}"
    inputs = worlds.attention_inputs()

    def loss(q, k, v):
        return jnp.sum(jring.ring_self_attention(
            jmesh, q, k, v, axis="seq", causal=causal) ** 2)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, inputs))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    (tring.full_attention(*leaves, causal=causal) ** 2).sum().backward()
    for res in ranks:
        np.testing.assert_array_equal(res[f"grad_out_{key}"], res[key])
        for got, first, jg, tl in zip(res[f"grads_{key}"],
                                      ranks[0][f"grads_{key}"], want,
                                      leaves):
            assert got.shape == worlds.ATTN_SHAPE
            np.testing.assert_array_equal(got, first)
            np.testing.assert_allclose(got, np.asarray(jg), rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL)
            np.testing.assert_allclose(got, tl.grad.numpy(), rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL)


def test_ring_self_attention_bf16_matches_jax(ring_world):
    """bfloat16 blocks cross gloo as their bytes; the result keeps the
    dtype and is within a bf16 ulp or two of JAX's bf16 ring."""
    w, jmesh, ranks = ring_world
    want = _jax_ring(jmesh, True, jnp.bfloat16)
    for res in ranks:
        assert res["bf16_dtype"] == "torch.bfloat16"
        np.testing.assert_array_equal(res["bf16_causal"],
                                      ranks[0]["bf16_causal"])
    np.testing.assert_allclose(ranks[0]["bf16_causal"], want, rtol=0,
                               atol=BF16_ATOL)


def test_ring_rejects_indivisible_seq_as_jax_does(ring_world):
    w, jmesh, ranks = ring_world
    bad = jnp.zeros((2, worlds.ATTN_BAD_T, 2, 8))
    with pytest.raises(ValueError) as e:
        jring.ring_self_attention(jmesh, bad, bad, bad, axis="seq")
    for res in ranks:
        assert res["axis"] == "seq"
        assert res["indivisible"] == str(e.value)
        assert "needs a mesh over the 'data' axis" in res["data_axis"]
