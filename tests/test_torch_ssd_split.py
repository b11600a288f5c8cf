"""The bf16 SSD kernel's split of the chunk axis, on the CPU: the plan's
invariants (``kernels/ssd_scan.py::ssd_plan``) and a plain PyTorch model of
what the kernel computes over that plan (each rank's local state from zero,
the fold of the earlier ranks' states into each rank's entering state, then
y over the rank's run), held against ``ssd_scan_plain`` and the Pallas
kernel (interpret mode).  The model runs once in float32 and once with the
kernel's bf16 rounding points: the three operands that carry an f32 factor
(W, x * w and the state) go into the tensor cores as hi + lo bf16 pairs,
and C, B and x as the bf16 inputs.  Each of the three needs its pair: one
rounding of any one of them misses the bf16 tolerance at the serving
width."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as j_ssd_pallas  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    KERNEL_CHUNK, MAX_RANKS, ssd_plan, ssd_scan_plain)

F32_TOL = dict(rtol=1e-4, atol=1e-4)         # as tests/test_kernels.py
SSD_TOL = {"y": 6e-2, "state": 1e-2}         # bf16, as tests/test_torch_cuda.py
H100_SMS = 132
f32 = torch.float32

# (B, H, S, chunk, SM count): the mamba2-370m join at buckets 1 and 8, more
# chunks than ranks (S 4096), S < chunk, one chunk, an empty sequence, a
# card with fewer SMs, many (b, h)
PLANS = [(1, 32, 512, 64, 132), (8, 32, 512, 64, 132), (1, 32, 4096, 64, 132),
         (2, 4, 40, 64, 132), (1, 1, 64, 64, 132), (1, 32, 0, 64, 132),
         (3, 5, 1100, 64, 78), (64, 32, 512, 64, 132), (1, 1, 100000, 64, 132),
         (2, 24, 4096, 64, 132)]


def _runs(S, chunk, R, per):
    n_chunks = -(-S // chunk)
    return [(r * per, min((r + 1) * per, n_chunks)) for r in range(R)]


@pytest.mark.parametrize("plan", PLANS, ids=str)
def test_ssd_plan_covers_the_chunks(plan):
    B, H, S, chunk, sms = plan
    R, per = ssd_plan(B, H, S, chunk, sms)
    assert 1 <= R <= MAX_RANKS and per >= 1
    runs = _runs(S, chunk, R, per)
    n_chunks = -(-S // chunk)
    assert runs[0][0] == 0 and runs[-1][1] == n_chunks
    for (a, b), (c, _) in zip(runs, runs[1:]):
        assert b == c                          # contiguous
    if n_chunks:
        assert all(b > a for a, b in runs)     # no run is empty
    else:
        assert R == 1


@pytest.mark.parametrize("plan", PLANS, ids=str)
def test_ssd_plan_is_deterministic(plan):
    assert ssd_plan(*plan) == ssd_plan(*plan)
    assert ssd_plan(*plan) == ssd_plan(*[int(x) for x in plan])


def test_ssd_plan_loops_inside_the_cta_past_eight_ranks():
    """S 4096 is 64 chunks: 5 ranks of 13 give batch 1 one CTA per SM, and
    each CTA walks its 13 chunks in a loop; 8 ranks is the most a cluster
    takes."""
    assert ssd_plan(1, 32, 4096, 64, H100_SMS) == (5, 13)
    assert ssd_plan(1, 1, 4096, 64, H100_SMS) == (8, 8)
    assert ssd_plan(2, 4, 40, 64, H100_SMS) == (1, 1)     # S < chunk


@pytest.mark.parametrize("bucket", range(1, 9))
def test_ssd_plan_fills_the_card_on_the_mamba2_path(bucket):
    """mamba2-370m's join (prompt 512, chunk 64, 32 heads) at every bucket:
    the CTAs fill the 132 SMs of an H100 to within one (b, h), the shortfall
    that runs of equal length leave (bucket 1: 4 runs of 2 chunks, 128
    CTAs; 5 ranks would still give runs of 2)."""
    cfg = get_config("mamba2-370m")
    H, chunk = cfg.n_ssm_heads, cfg.ssm_chunk
    assert (H, chunk) == (32, KERNEL_CHUNK)
    R, per = ssd_plan(bucket, H, 512, chunk, H100_SMS)
    assert bucket * H * (R + 1) > H100_SMS
    n_chunks = 512 // chunk
    # no plan with shorter runs fits in one cluster of at most 8 ranks and
    # stays at one CTA per SM or fewer
    shorter = -(-n_chunks // (per - 1)) if per > 1 else None
    assert shorter is None or bucket * H * shorter > H100_SMS \
        or shorter > MAX_RANKS


def test_ssd_plan_at_the_serving_buckets():
    """The plans the mamba2-370m join takes on an H100: 4 ranks of 2 chunks
    at bucket 1, 3 of 3 at bucket 2, 2 of 4 at buckets 3-4, no split from
    5; at bucket 8 the fastest split of chip_smoke.py's sweep, at bucket 1
    within 2 % of the fastest (4 x 2 and 3 x 3 trade places)."""
    got = [ssd_plan(b, 32, 512, 64, H100_SMS) for b in range(1, 9)]
    assert got == [(4, 2), (3, 3), (2, 4), (2, 4)] + [(1, 8)] * 4


OPERANDS = ("W", "xw", "state")     # the operands that carry an f32 factor


def _split(v, rounding):
    """The terms the tensor cores see of an operand that carries an f32
    factor: the value itself (f32 model), one bf16 rounding, or a hi + lo
    pair of bf16 values (the kernel)."""
    if rounding == "none":
        return [v]
    hi = v.to(torch.bfloat16).to(f32)
    if rounding == "bf16":
        return [hi]
    return [hi, (v - hi).to(torch.bfloat16).to(f32)]


def split_scan(x, dt, A, Bm, Cm, init_state, R, per, rounding="none"):
    """The kernel's arithmetic in plain PyTorch over ``R`` ranks of ``per``
    64-row chunks: phase 1, each rank but the last forms its run's local
    state from zero and its summed decay; phase 2, rank r's entering state
    is init * exp(T_0 + .. + T_{r-1}) + sum_k local_k * exp(T_{k+1} + .. +
    T_{r-1}), folded nearest rank first; phase 3, y over the run from that
    state.  x, dt, Bm, Cm are widened to float32; ``rounding`` applies to W,
    x * w and the state where they meet the tensor cores: one of
    :func:`_split`'s roundings for all three, or a dict with one for each
    of ``"W"``, ``"xw"`` and ``"state"``."""
    if isinstance(rounding, str):
        rounding = dict.fromkeys(OPERANDS, rounding)
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = KERNEL_CHUNK
    pad = (-S) % Q
    pad_rows = lambda t: torch.nn.functional.pad(  # noqa: E731
        t.to(f32), (0, 0) * (t.dim() - 2) + (0, pad))
    xf, dtf, Bf, Cf = pad_rows(x), pad_rows(dt), pad_rows(Bm), pad_rows(Cm)
    nc = xf.shape[1] // Q
    xf = xf.reshape(Bsz, nc, Q, H, P).permute(0, 3, 1, 2, 4)   # b h c q p
    dtf = dtf.reshape(Bsz, nc, Q, H).permute(0, 3, 1, 2)        # b h c q
    Bf = Bf.reshape(Bsz, nc, Q, N)
    Cf = Cf.reshape(Bsz, nc, Q, N)
    cum = torch.cumsum(dtf * A.to(f32)[None, :, None, None], -1)
    total = cum[..., -1]                                        # b h c
    live = torch.ones(Q, Q, dtype=torch.bool).tril()

    def update(s, c):
        w = dtf[:, :, c] * torch.exp(total[:, :, c, None] - cum[:, :, c])
        s = s * torch.exp(total[:, :, c])[..., None, None]
        for part in _split(xf[:, :, c] * w[..., None], rounding["xw"]):
            s = s + torch.einsum("bhqp,bqn->bhpn", part, Bf[:, c])
        return s

    runs = [range(r * per, min((r + 1) * per, nc)) for r in range(R)]
    zero = torch.zeros(Bsz, H, P, N)
    local, decay = [], []
    for r in range(R - 1):
        s = zero
        for c in runs[r]:
            s = update(s, c)
        local.append(s)
        decay.append(total[:, :, list(runs[r])].sum(-1))
    ys = []
    for r in range(R):
        s, d = zero, torch.ones(Bsz, H)
        for k in range(r - 1, -1, -1):
            s = s + local[k] * d[..., None, None]
            d = d * torch.exp(decay[k])
        if init_state is not None:
            s = s + init_state.to(f32) * d[..., None, None]
        for c in runs[r]:
            scores = torch.einsum("bin,bjn->bij", Cf[:, c], Bf[:, c])
            seg = cum[:, :, c, :, None] - cum[:, :, c, None, :]
            W = torch.where(live, torch.exp(torch.where(live, seg, 0.0))
                            * scores[:, None] * dtf[:, :, c, None, :], 0.0)
            y = torch.zeros(Bsz, H, Q, P)
            for part in _split(s, rounding["state"]):
                y = y + torch.einsum("bin,bhpn->bhip", Cf[:, c], part)
            y = y * torch.exp(cum[:, :, c])[..., None]
            for part in _split(W, rounding["W"]):
                y = y + torch.einsum("bhij,bhjp->bhip", part, xf[:, :, c])
            ys.append(y)
            s = update(s, c)
    y = torch.stack(ys, 2).permute(0, 2, 3, 1, 4).reshape(Bsz, nc * Q, H, P)
    return y[:, :S].to(x.dtype), s


def _inputs(seed, B, S, H, P, N, init):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal((B, S, H, P)),
           np.logaddexp(rng.standard_normal((B, S, H)), 0.0),
           -np.exp(rng.standard_normal(H) * 0.5),
           rng.standard_normal((B, S, N)), rng.standard_normal((B, S, N))]
    out.append(rng.standard_normal((B, H, P, N)) if init else None)
    return [None if a is None else a.astype(np.float32) for a in out]


# (B, S, H, P, N, init_state, SM count): SM counts small enough that the
# plan splits; S 200 and 330 are ragged; S 1100 gives several chunks a rank
SPLIT_CASES = [
    (2, 256, 3, 32, 16, False, 8),
    (1, 200, 2, 64, 32, True, 4),
    (2, 330, 2, 32, 128, True, 12),
    (1, 1100, 2, 32, 16, True, 8),
    (2, 64, 2, 32, 16, True, 132),
]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_split_scan_matches_the_plain_version(case):
    B, S, H, P, N, init, sms = case
    arrs = _inputs(10, B, S, H, P, N, init)
    t = [None if a is None else torch.from_numpy(a) for a in arrs]
    R, per = ssd_plan(B, H, S, KERNEL_CHUNK, sms)
    if S > KERNEL_CHUNK:
        assert R > 1
    y, st = split_scan(*t, R, per)
    yp, sp = ssd_scan_plain(*t[:5], chunk=64, init_state=t[5])
    np.testing.assert_allclose(y.numpy(), yp.numpy(), **F32_TOL)
    np.testing.assert_allclose(st.numpy(), sp.numpy(), **F32_TOL)


@pytest.mark.parametrize("case", SPLIT_CASES[:4], ids=str)
def test_split_scan_matches_the_pallas_kernel(case):
    """The same split against the Pallas kernel in interpret mode (the
    ops.ssd wrapper pads a ragged S with dt = 0, as the port's does)."""
    B, S, H, P, N, init, sms = case
    arrs = _inputs(11, B, S, H, P, N, init)
    t = [None if a is None else torch.from_numpy(a) for a in arrs]
    j = [jnp.asarray(a) for a in arrs[:5]]
    s0 = {} if arrs[5] is None else {"init_state": jnp.asarray(arrs[5])}
    if S % 64:
        yj, sj = jops.ssd(*j, chunk=64, backend="pallas_interpret", **s0)
    else:
        yj, sj = j_ssd_pallas(*j, chunk=64, interpret=True, **s0)
    R, per = ssd_plan(B, H, S, KERNEL_CHUNK, sms)
    y, st = split_scan(*t, R, per)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **F32_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), **F32_TOL)


def _bf16_inputs(seed, B, S, H, P, N, init):
    arrs = _inputs(seed, B, S, H, P, N, init)
    t = [None if a is None else torch.from_numpy(a) for a in arrs]
    for i in (0, 1, 3, 4):
        t[i] = t[i].to(torch.bfloat16)
    return t


def _worst(got, want, tol):
    """The largest |got - want| / (tol + tol |want|): at most 1 passes."""
    got, want = got.float(), want.float()
    return ((got - want).abs() / (tol + tol * want.abs())).max().item()


@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_rounded_split_scan_is_within_the_bf16_tolerance(case):
    """The kernel's rounding points (hi + lo pairs for W, x * w and the
    state) against the float32 plain version on the same bf16 inputs, under
    the bf16 tolerance the card checks hold the kernel to."""
    B, S, H, P, N, init, sms = case
    t = _bf16_inputs(12, B, S, H, P, N, init)
    R, per = ssd_plan(B, H, S, KERNEL_CHUNK, sms)
    y, st = split_scan(*t, R, per, rounding="hilo")
    yp, sp = ssd_scan_plain(*t[:5], chunk=64, init_state=t[5])
    assert y.dtype == torch.bfloat16
    assert _worst(y, yp, SSD_TOL["y"]) <= 1.0
    assert _worst(st, sp, SSD_TOL["state"]) <= 1.0


def test_one_bf16_rounding_misses_the_tolerance_at_the_serving_width():
    """Why the kernel pays for hi + lo pairs: at mamba2-370m's width (bucket
    1: 32 heads, P 64, N 128, prompt 512, 4 ranks) a single bf16 rounding of
    W, x * w and the state puts y outside the bf16 tolerance of the plain
    version, and the pairs bring it well inside."""
    t = _bf16_inputs(0, 1, 512, 32, 64, 128, False)
    R, per = ssd_plan(1, 32, 512, KERNEL_CHUNK, H100_SMS)
    yp, sp = ssd_scan_plain(*t[:5], chunk=64)
    y1, s1 = split_scan(*t, R, per, rounding="bf16")
    y2, s2 = split_scan(*t, R, per, rounding="hilo")
    assert max(_worst(y1, yp, SSD_TOL["y"]),
               _worst(s1, sp, SSD_TOL["state"])) > 1.0
    assert _worst(y2, yp, SSD_TOL["y"]) <= 0.5
    assert _worst(s2, sp, SSD_TOL["state"]) <= 0.5


@functools.lru_cache(maxsize=None)
def _serving_join(seed):
    """mamba2-370m's bucket-8 join (32 heads, P 64, N 128, prompt 512) in
    bf16, and the plain version's y and state on it."""
    t = _bf16_inputs(seed, 8, 512, 32, 64, 128, False)
    return t, ssd_scan_plain(*t[:5], chunk=64)


def _worst_at_the_join(rounding):
    """The larger of y's and the state's :func:`_worst` over two draws of
    the bucket-8 join."""
    worst = 0.0
    for seed in (0, 1):
        t, (yp, sp) = _serving_join(seed)
        R, per = ssd_plan(8, 32, 512, KERNEL_CHUNK, H100_SMS)
        y, s = split_scan(*t, R, per, rounding=rounding)
        worst = max(worst, _worst(y, yp, SSD_TOL["y"]),
                    _worst(s, sp, SSD_TOL["state"]))
    return worst


@pytest.mark.parametrize("operand", OPERANDS)
def test_each_operand_needs_its_pair(operand):
    """Which operands need the hi + lo pair: rounding any one of W, x * w
    and the state once, with the other two kept as pairs, puts y or the
    state outside the bf16 tolerance at the bucket-8 join in at least one
    of two draws of the inputs (W by the most, on y; x * w on the state,
    whose errors the scan carries; the state on y, by the least)."""
    rounding = dict.fromkeys(OPERANDS, "hilo")
    rounding[operand] = "bf16"
    assert _worst_at_the_join(rounding) > 1.0


def test_the_pairs_hold_the_serving_join():
    assert _worst_at_the_join("hilo") <= 0.5
