"""The port's attention kernels on the CPU: the plain PyTorch versions
against the JAX oracles and the Pallas kernels (interpret mode), device
dispatch, and the ``valid_len = 0`` contract.  The CUDA kernels themselves
run in tests/test_torch_cuda.py and chip_smoke.py, on the card."""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import \
    decode_attention as j_decode_pallas  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as j_flash_pallas  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402

TOL = dict(rtol=3e-5, atol=3e-5)    # f32, as tests/test_kernels.py

# a subset of tests/test_kernels.py FA_CASES / DEC_CASES:
# (B, Sq, Sk, Hq, Hkv, hd, causal, window) and (B, L, Hq, Hkv, hd)
FA_CASES = [
    (2, 64, 192, 4, 4, 64, True, 0),       # q aligned to the kv suffix
    (1, 128, 128, 8, 2, 64, True, 32),     # sliding window + GQA
    (1, 96, 96, 2, 2, 32, False, 0),       # bidirectional
    (2, 1, 96, 6, 3, 64, True, 32),        # Sq=1 + window + GQA
    (1, 17, 17, 2, 1, 32, True, 8),        # S < block
]
DEC_CASES = [
    (2, 300, 6, 3, 64),
    (2, 33, 4, 2, 64),
    (1, 64, 1, 1, 32),
]


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("case", FA_CASES, ids=str)
def test_flash_attention_plain_matches_jax(case):
    B, Sq, Sk, Hq, Hkv, hd, causal, w = case
    rng = np.random.default_rng(0)
    q, k, v = _rand(rng, B, Sq, Hq, hd), _rand(rng, B, Sk, Hkv, hd), \
        _rand(rng, B, Sk, Hkv, hd)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_ref = np.asarray(jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                                   window=w))
    want_pallas = np.asarray(j_flash_pallas(jq, jk, jv, causal=causal,
                                            window=w, interpret=True,
                                            block_q=64, block_k=64))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got_ref = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=w)
    got = flash_attention(tq, tk, tv, causal=causal, window=w)
    np.testing.assert_allclose(got_ref.numpy(), want_ref, **TOL)
    np.testing.assert_allclose(got.numpy(), want_pallas, **TOL)


@pytest.mark.parametrize("case", DEC_CASES, ids=str)
def test_decode_attention_plain_matches_jax(case):
    B, L, Hq, Hkv, hd = case
    rng = np.random.default_rng(1)
    q, k, v = _rand(rng, B, Hq, hd), _rand(rng, B, L, Hkv, hd), \
        _rand(rng, B, L, Hkv, hd)
    vlen = rng.integers(1, L + 1, (B,)).astype(np.int32)
    jargs = tuple(map(jnp.asarray, (q, k, v, vlen)))
    want_ref = np.asarray(jref.decode_attention_ref(*jargs))
    want_pallas = np.asarray(j_decode_pallas(*jargs, block_k=64,
                                             interpret=True))
    targs = tuple(map(torch.from_numpy, (q, k, v, vlen)))
    np.testing.assert_allclose(ref.decode_attention_ref(*targs).numpy(),
                               want_ref, **TOL)
    np.testing.assert_allclose(decode_attention(*targs).numpy(),
                               want_pallas, **TOL)


def test_valid_len_zero_gives_zeros_like_the_pallas_kernel():
    """The Pallas kernel (and so the CUDA kernel and its plain version)
    returns zeros for a row with valid_len = 0; the JAX oracle returns the
    mean of V there, and the port's oracle keeps that divergence."""
    B, L, Hq, Hkv, hd = 3, 64, 4, 2, 64
    rng = np.random.default_rng(2)
    q, k, v = _rand(rng, B, Hq, hd), _rand(rng, B, L, Hkv, hd), \
        _rand(rng, B, L, Hkv, hd)
    vlen = np.array([0, 5, L], np.int32)
    jargs = tuple(map(jnp.asarray, (q, k, v, vlen)))
    pallas = np.asarray(j_decode_pallas(*jargs, block_k=64, interpret=True))
    targs = tuple(map(torch.from_numpy, (q, k, v, vlen)))
    got = decode_attention(*targs).numpy()
    assert not got[0].any() and not pallas[0].any()
    np.testing.assert_allclose(got, pallas, **TOL)
    oracle = ref.decode_attention_ref(*targs).numpy()
    np.testing.assert_allclose(oracle, np.asarray(
        jref.decode_attention_ref(*jargs)), **TOL)
    np.testing.assert_allclose(
        oracle[0], v[0].mean(0).repeat(Hq // Hkv, axis=0), **TOL)


def test_ops_take_the_plain_path_on_cpu_without_launching():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(_rand(rng, 1, 16, 4, 64)) for _ in range(3))
    before = ops.launch_counts()
    np.testing.assert_array_equal(
        ops.attention(q, k, v, causal=True, window=4).numpy(),
        flash_attention_plain(q, k, v, causal=True, window=4).numpy())
    vlen = torch.tensor([9], dtype=torch.int32)
    np.testing.assert_array_equal(
        ops.decode_attention(q[:, 0], k, v, vlen).numpy(),
        decode_attention_plain(q[:, 0], k, v, vlen).numpy())
    assert ops.launch_counts() == before
    assert ops.KERNEL_TABLE == {"attention": flash_attention,
                                "decode_attention": decode_attention,
                                "ssd": ssd_scan}


def test_wrappers_refuse_devices_without_a_path(monkeypatch):
    """A device that is neither plain (``ref.PLAIN_DEVICES``: the CPU, and
    meta for the dry-run) nor CUDA raises.  This build has no such device,
    so meta stands for one, dropped from the plain devices."""
    for name in ("flash_attention", "decode_attention"):
        monkeypatch.setattr(sys.modules[f"repro_torch.kernels.{name}"],
                            "PLAIN_DEVICES", ("cpu",))
    q = torch.empty((1, 4, 2, 64), device="meta")
    with pytest.raises(ValueError, match="cpu, meta or cuda"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="cpu, meta or cuda"):
        decode_attention(q[:, 0], q, q, torch.empty((1,), device="meta"))


def test_kernel_modules_import_without_building():
    """Importing the kernel modules neither needs nvcc nor builds: the build
    happens at the first launch on a CUDA tensor."""
    assert _build.SOURCES == ("flash_attention", "decode_attention",
                              "ssd_scan")
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
        assert name not in _build._loaded
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
