"""The decode kernel's split over the cache, on the CPU: the plan's
invariants (``kernels/decode_attention.py::split_plan``) and a plain
PyTorch model of what the kernel computes over that plan (each split's
online-softmax partial, then a log-sum-exp combine), held against
``decode_attention_plain`` and the Pallas kernel (interpret mode)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import \
    decode_attention as j_decode_pallas  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    MAX_SPLIT, SPLIT_TILE, decode_attention_plain, split_plan)

TOL = dict(rtol=3e-5, atol=3e-5)    # f32, as tests/test_kernels.py
NEG_INF = -1e30
H100_SMS = 132

# (B, Hkv, L, SM count)
PLANS = [(1, 36, 544, 132), (8, 36, 544, 132), (4, 36, 544, 132),
         (1, 1, 1, 132), (1, 4, 33, 132), (2, 2, 512, 132),
         (1, 8, 4096, 132), (64, 36, 544, 132), (1, 36, 0, 132),
         (3, 5, 1000, 78), (1, 1, 100000, 132), (16, 8, 65, 132)]


def _ranges(L, n_split, chunk):
    return [(s * chunk, min((s + 1) * chunk, L)) for s in range(n_split)]


@pytest.mark.parametrize("plan", PLANS, ids=str)
def test_split_plan_covers_the_cache(plan):
    B, Hkv, L, sms = plan
    n_split, chunk = split_plan(B, Hkv, L, sms)
    assert 1 <= n_split <= MAX_SPLIT
    assert chunk >= SPLIT_TILE and chunk % SPLIT_TILE == 0
    rng = _ranges(L, n_split, chunk)
    assert rng[0][0] == 0 and rng[-1][1] == max(L, 0)
    for (a, b), (c, _) in zip(rng, rng[1:]):
        assert b == c                          # contiguous
    if L > 0:
        assert all(b > a for a, b in rng)      # no split is empty


@pytest.mark.parametrize("plan", PLANS, ids=str)
def test_split_plan_is_deterministic(plan):
    assert split_plan(*plan) == split_plan(*plan)
    assert split_plan(*plan) == split_plan(*[int(x) for x in plan])


@pytest.mark.parametrize("bucket", [1, 2, 4, 8])
def test_split_plan_fills_the_card_on_the_minicpm_path(bucket):
    """minicpm-2b's decode: every bucket of the serving path (prompt 512 +
    32 generated tokens) gives at least one CTA per SM of an H100."""
    cfg = get_config("minicpm-2b")
    L = 512 + 32
    n_split, _ = split_plan(bucket, cfg.n_kv_heads, L, H100_SMS)
    assert bucket * cfg.n_kv_heads * n_split >= H100_SMS


def test_split_plan_at_the_serving_buckets():
    """The plans the minicpm-2b step takes on an H100: 6 splits of 96 keys
    at bucket 1 (216 CTAs), 2 of 288 at bucket 8 (576)."""
    assert split_plan(1, 36, 544, H100_SMS) == (6, 96)
    assert split_plan(8, 36, 544, H100_SMS) == (2, 288)


def split_combine(q, k, v, valid_len, n_split, chunk):
    """The kernel's arithmetic in plain PyTorch (float32): per split, the
    max score m, the sum of exponentials l and the weighted sum of V acc
    (an empty split gives m = -1e30, l = 0, acc = 0); then per row the
    log-sum-exp combine o = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30)
    with w_s = exp(m_s - max_s m_s)."""
    B, Hq, hd = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, hd).double() / math.sqrt(hd)
    out = torch.zeros(B, Hkv, G, hd, dtype=torch.float64)
    for b in range(B):
        n = max(0, min(int(valid_len[b]), L))
        ms, ls, accs = [], [], []
        for s in range(n_split):
            lo, hi = s * chunk, min((s + 1) * chunk, n)
            if hi <= lo:
                ms.append(torch.full((Hkv, G), NEG_INF, dtype=torch.float64))
                ls.append(torch.zeros(Hkv, G, dtype=torch.float64))
                accs.append(torch.zeros(Hkv, G, hd, dtype=torch.float64))
                continue
            sc = torch.einsum("kgd,skd->kgs", qg[b], k[b, lo:hi].double())
            m = sc.amax(-1)
            p = torch.exp(sc - m[..., None])
            ms.append(m)
            ls.append(p.sum(-1))
            accs.append(torch.einsum("kgs,skd->kgd", p, v[b, lo:hi].double()))
        M = torch.stack(ms).amax(0)
        w = [torch.exp(m - M) for m in ms]
        den = sum(wi * li for wi, li in zip(w, ls)).clamp_min(1e-30)
        out[b] = sum(wi[..., None] * a for wi, a in zip(w, accs)) \
            / den[..., None]
    return out.reshape(B, Hq, hd).to(q.dtype)


# (B, L, Hq, Hkv, hd, valid_len, SM count): ragged rows, a row that ends
# inside the first split, splits past valid_len with no live key, and rows
# with valid_len = 0
COMBINE_CASES = [
    (3, 544, 4, 4, 64, [544, 300, 7], 132),
    (1, 544, 8, 2, 64, [100], 132),
    (2, 200, 6, 3, 32, [0, 200], 132),
    (4, 130, 8, 1, 72, [1, 64, 65, 0], 132),
    (2, 1000, 4, 4, 128, [999, 129], 132),
    (2, 64, 4, 4, 96, [0, 0], 132),
]


@pytest.mark.parametrize("case", COMBINE_CASES, ids=str)
def test_split_combine_matches_the_plain_version(case):
    B, L, Hq, Hkv, hd, vl, sms = case
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((B, Hq, hd)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, L, Hkv, hd))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, L, Hkv, hd))
                         .astype(np.float32))
    valid_len = torch.tensor(vl, dtype=torch.int32)
    n_split, chunk = split_plan(B, Hkv, L, sms)
    got = split_combine(q, k, v, valid_len, n_split, chunk)
    want = decode_attention_plain(q, k, v, valid_len)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    for b in range(B):
        if vl[b] == 0:
            assert not got[b].any()
    # at least one case has a split that holds no live key
    if any(0 < x <= (n_split - 1) * chunk for x in vl):
        assert n_split > 1


def test_split_combine_matches_the_pallas_kernel():
    """One ragged case against the Pallas kernel in interpret mode, whose
    tile loop the split replaces."""
    B, L, Hq, Hkv, hd = 2, 320, 4, 2, 64
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, L, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, L, Hkv, hd)).astype(np.float32)
    vl = np.array([320, 70], np.int32)
    want = np.asarray(j_decode_pallas(*map(jnp.asarray, (q, k, v, vl)),
                                      block_k=64, interpret=True))
    n_split, chunk = split_plan(B, Hkv, L, H100_SMS)
    assert n_split > 1
    got = split_combine(*map(torch.from_numpy, (q, k, v, vl)), n_split, chunk)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
