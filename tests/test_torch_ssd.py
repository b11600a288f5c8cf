"""The port's SSD scan on the CPU: the plain PyTorch version (what the CUDA
kernel ``csrc/ssd_scan.cu`` computes) and the port's oracles against the
JAX package's Pallas kernel in interpret mode, its chunked reference and its
sequential recurrence; the dt = 0 padding of a ragged S; the seeded initial
state; the single-token step.  The kernel itself runs in
tests/test_torch_cuda.py and chip_smoke.py, on the card."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as j_ssd_pallas  # noqa: E402
from repro.models.layers import ssd_decode_step as j_step  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain  # noqa: E402
from repro_torch.models.layers import ssd_decode_step  # noqa: E402

# the module, which the package's ``ssd_scan`` function shadows
ssd_mod = importlib.import_module("repro_torch.kernels.ssd_scan")

# (B, S, H, P, N, chunk): tests/test_kernels.py SSD_CASES
SSD_CASES = [
    (2, 128, 4, 64, 32, 64),
    (1, 64, 2, 32, 16, 16),
    (2, 256, 3, 64, 64, 64),
    (1, 192, 2, 32, 128, 64),
]
F32_TOL = dict(rtol=1e-4, atol=1e-4)     # as tests/test_kernels.py
BF16_Y_TOL = dict(rtol=6e-2, atol=6e-2)
BF16_STATE_TOL = dict(rtol=1e-2, atol=1e-2)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, B, S, H, P, N, init=False):
    """x, dt (softplus of a normal), A (negative), Bm, Cm [, init_state],
    all float32 numpy."""
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal((B, S, H, P)),
           np.logaddexp(rng.standard_normal((B, S, H)), 0.0),
           -np.exp(rng.standard_normal(H) * 0.5),
           rng.standard_normal((B, S, N)), rng.standard_normal((B, S, N))]
    if init:
        out.append(rng.standard_normal((B, H, P, N)))
    return [a.astype(np.float32) for a in out]


def _both(arrs, dtype_name):
    """The same numbers on both sides: A (and init_state) float32, the
    rest in the working dtype, rounded identically from float32."""
    jdt, tdt = DTYPES[dtype_name]
    j = [jnp.asarray(a).astype(jdt) for a in arrs[:5]]
    t = [torch.from_numpy(a).to(tdt) for a in arrs[:5]]
    j[2], t[2] = jnp.asarray(arrs[2]), torch.from_numpy(arrs[2])
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype_name, what):
    if dtype_name == "float32":
        tol = F32_TOL
    else:
        tol = BF16_Y_TOL if what == "y" else BF16_STATE_TOL
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_plain_and_ops_match_the_pallas_kernel(case, dtype_name):
    B, S, H, P, N, Q = case
    (jx, jdt, jA, jB, jC), t = _both(_inputs(0, B, S, H, P, N), dtype_name)
    yj, sj = j_ssd_pallas(jx, jdt, jA, jB, jC, chunk=Q, interpret=True)
    y, st = ssd_scan_plain(*t, chunk=Q)
    assert y.dtype == t[0].dtype and st.dtype == torch.float32
    _close(y, yj, dtype_name, "y")
    _close(st, sj, dtype_name, "state")
    before = ops.launch_counts()
    yo, so = ops.ssd(*t, chunk=Q)
    assert ops.launch_counts() == before          # plain path, no launch
    assert torch.equal(yo, y) and torch.equal(so, st)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_chunked_oracle_matches_the_jax_oracle(case, dtype_name):
    B, S, H, P, N, Q = case
    j, t = _both(_inputs(1, B, S, H, P, N), dtype_name)
    yj, sj = jref.ssd_scan_ref(*j, Q)
    y, st = ref.ssd_scan_ref(*t, Q)
    _close(y, yj, dtype_name, "y")
    _close(st, sj, dtype_name, "state")
    yp, sp = ssd_scan_plain(*t, chunk=Q)        # the kernel's function too
    _close(yp, yj, dtype_name, "y")
    _close(sp, sj, dtype_name, "state")


@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_plain_matches_the_sequential_recurrence(case):
    """The chunked math against the independent token-by-token oracle, the
    port's and the JAX package's, in float32."""
    B, S, H, P, N, Q = case
    j, t = _both(_inputs(2, B, S, H, P, N), "float32")
    y, st = ssd_scan_plain(*t, chunk=Q)
    ys, ss = ref.ssd_scan_sequential_ref(*t)
    yj, sj = jref.ssd_scan_sequential_ref(*j)
    for got, want in ((y, ys), (st, ss), (ys, yj), (ss, sj)):
        np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_init_state_seeds_the_carry(dtype_name):
    """tests/test_kernels.py's init-state case: the seeded carry against
    the Pallas kernel and both oracles."""
    B, S, H, P, N, Q = 2, 128, 2, 32, 16, 64
    arrs = _inputs(3, B, S, H, P, N, init=True)
    j, t = _both(arrs, dtype_name)
    js0, ts0 = jnp.asarray(arrs[5]), torch.from_numpy(arrs[5])
    yj, sj = j_ssd_pallas(*j, chunk=Q, init_state=js0, interpret=True)
    y, st = ops.ssd(*t, chunk=Q, init_state=ts0)
    _close(y, yj, dtype_name, "y")
    _close(st, sj, dtype_name, "state")
    yr, sr = ref.ssd_scan_ref(*t, Q, init_state=ts0)
    ys, ss = ref.ssd_scan_sequential_ref(*t, init_state=ts0)
    for got, want in ((y, yr), (st, sr), (y, ys), (st, ss)):
        _close(got, want, dtype_name, "y" if got is y else "state")
    y0, _ = ops.ssd(*t, chunk=Q)
    assert not torch.allclose(y0.float(), y.float())   # the seed matters


@pytest.mark.parametrize("init", [False, True], ids=["zero", "seeded"])
@pytest.mark.parametrize("S", [100, 1, 63])
def test_ragged_sequence_is_padded_with_dt_zero(S, init):
    """S not a multiple of the chunk: the dt = 0 padding of ``ops.ssd``
    leaves the state untouched and y is cut back to S."""
    B, H, P, N, Q = 1, 2, 32, 16, 64
    arrs = _inputs(4, B, S, H, P, N, init=init)
    j, t = _both(arrs, "float32")
    s0 = dict(init_state=jnp.asarray(arrs[5])) if init else {}
    ts0 = dict(init_state=torch.from_numpy(arrs[5])) if init else {}
    yj, sj = jops.ssd(*j, chunk=Q, backend="pallas_interpret", **s0)
    y, st = ops.ssd(*t, chunk=Q, **ts0)
    assert y.shape == (B, S, H, P)
    np.testing.assert_allclose(_np(y), _np(yj), **F32_TOL)
    np.testing.assert_allclose(_np(st), _np(sj), **F32_TOL)
    ys, ss = ref.ssd_scan_sequential_ref(*t, **ts0)
    np.testing.assert_allclose(_np(y), _np(ys), **F32_TOL)
    np.testing.assert_allclose(_np(st), _np(ss), **F32_TOL)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_decode_step_matches_jax(dtype_name):
    B, H, P, N = 3, 4, 32, 16
    rng = np.random.default_rng(5)
    state = rng.standard_normal((B, H, P, N)).astype(np.float32)
    x, Bm, Cm = (rng.standard_normal(s).astype(np.float32)
                 for s in ((B, H, P), (B, N), (B, N)))
    dt = np.logaddexp(rng.standard_normal((B, H)), 0.0).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    jdt, tdt = DTYPES[dtype_name]
    yj, sj = j_step(jnp.asarray(state), jnp.asarray(x).astype(jdt),
                    jnp.asarray(dt), jnp.asarray(A),
                    jnp.asarray(Bm).astype(jdt), jnp.asarray(Cm).astype(jdt))
    tt = [torch.from_numpy(a) for a in (state, x, dt, A, Bm, Cm)]
    for i in (1, 4, 5):
        tt[i] = tt[i].to(tdt)
    y, st = ssd_decode_step(*tt)
    before = ops.launch_counts()
    yo, so = ops.ssd_step(*tt)
    assert ops.launch_counts() == before
    assert torch.equal(yo, y) and torch.equal(so, st)
    assert y.dtype == tdt and st.dtype == torch.float32
    _close(y, yj, dtype_name, "y")
    _close(st, sj, dtype_name, "state")


def test_one_token_step_continues_the_scan():
    """A scan over S tokens then the recurrent step on token S+1 gives the
    scan over S+1 tokens: the two halves of the Mamba2 path agree."""
    B, S, H, P, N, Q = 2, 33, 2, 32, 16, 16
    _, t = _both(_inputs(6, B, S + 1, H, P, N), "float32")
    x, dt, A, Bm, Cm = t
    y_all, s_all = ops.ssd(*t, chunk=Q)
    _, s_pre = ops.ssd(x[:, :S], dt[:, :S], A, Bm[:, :S], Cm[:, :S],
                       chunk=Q)
    y1, s1 = ops.ssd_step(s_pre, x[:, S], dt[:, S], A, Bm[:, S], Cm[:, S])
    np.testing.assert_allclose(_np(y1), _np(y_all[:, S]), **F32_TOL)
    np.testing.assert_allclose(_np(s1), _np(s_all), **F32_TOL)


def test_kernel_checks_refuse_what_it_does_not_take():
    """The wrapper's checks, run on CPU tensors (the kernel itself only
    runs on the card)."""
    _, t = _both(_inputs(7, 1, 64, 2, 32, 16), "float32")
    ssd_mod._check(*t, 64, None)                       # accepted
    with pytest.raises(ValueError, match="head dims"):
        ssd_mod._check(*t, 48, None)                   # chunk
    x, dt, A, Bm, Cm = t
    with pytest.raises(ValueError, match="head dims"):
        ssd_mod._check(torch.zeros(1, 64, 2, 16), dt, A, Bm, Cm, 64, None)
    with pytest.raises(ValueError, match="share device and dtype"):
        ssd_mod._check(x, dt.to(torch.bfloat16), A, Bm, Cm, 64, None)
    with pytest.raises(ValueError, match="A must be a float32"):
        ssd_mod._check(x, dt, A.double(), Bm, Cm, 64, None)
    with pytest.raises(ValueError, match="init_state"):
        ssd_mod._check(*t, 64, torch.zeros(1, 2, 32, 8))
    with pytest.raises(ValueError, match="contiguous"):
        ssd_mod._check(x.transpose(2, 3).contiguous().transpose(2, 3), dt,
                       A, Bm, Cm, 64, None)
    with pytest.raises(ValueError, match="takes"):
        ssd_mod._check(*(a.half() for a in (x, dt)), A,
                       *(a.half() for a in (Bm, Cm)), 64, None)
    m = torch.empty((1, 4, 2, 32), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ssd_scan(m, m[..., 0], m[0, 0, :, 0], m[..., 0, :16],
                 m[..., 0, :16], chunk=16)
