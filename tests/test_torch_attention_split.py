"""The decode kernel's split over the cache, on the CPU: the plan's
invariants (``kernels/decode_attention.py::split_plan`` and
``split_groups``) and a plain PyTorch model of what the kernel computes
over that plan (each split's online-softmax partial, then a log-sum-exp
combine per group of splits and over the groups), held against
``decode_attention_plain`` and the Pallas kernel (interpret mode); and
the flash kernel's tile height (``flash_block_q``)."""
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
    MAX_CTAS, MAX_GROUP, MAX_SPLIT, MIN_CHUNK, SPLIT_TILE, TC96_MIN_CHUNK,
    TC_MIN_CHUNK, decode_attention_plain, decode_instance, decode_plan,
    split_groups, split_plan, split_plan_tc)
from repro_torch.kernels.flash_attention import flash_block_q  # noqa: E402

TOL = dict(rtol=3e-5, atol=3e-5)    # f32, as tests/test_kernels.py
NEG_INF = -1e30
H100_SMS = 132

# (B, Hkv, L, SM count)
PLANS = [(1, 36, 544, 132), (8, 36, 544, 132), (4, 36, 544, 132),
         (1, 1, 1, 132), (1, 4, 33, 132), (2, 2, 512, 132),
         (1, 8, 4096, 132), (64, 36, 544, 132), (1, 36, 0, 132),
         (3, 5, 1000, 78), (1, 1, 100000, 132), (16, 8, 65, 132),
         # gemma3-1b's global decode (one KV head) at buckets 1 and 8 of
         # the serving path, and at batch 1 over a 32k and a 128k cache
         (1, 1, 544, 132), (8, 1, 544, 132), (1, 1, 32768, 132),
         (1, 1, 131072, 132),
         # the grouped-query decode at hd 128 (8 KV heads: minitron-8b,
         # llama4-scout, mixtral-8x22b) at buckets 8 and 1 over the serving
         # cache, mixtral's window and a 32k cache
         (8, 8, 544, 132), (1, 8, 544, 132), (8, 8, 4096, 132),
         (8, 8, 32768, 132), (1, 8, 32768, 132)]


def _ranges(L, n_split, chunk):
    return [(s * chunk, min((s + 1) * chunk, L)) for s in range(n_split)]


@pytest.mark.parametrize("plan", PLANS, ids=str)
def test_split_plan_covers_the_cache(plan):
    """Up to MAX_SPLIT ranges of whole tiles (one cluster), or, past that,
    at most MAX_CTAS ranges of at least MIN_CHUNK keys each."""
    B, Hkv, L, sms = plan
    n_split, chunk = split_plan(B, Hkv, L, sms)
    assert 1 <= n_split <= MAX_CTAS
    if n_split <= MAX_SPLIT:
        assert chunk >= SPLIT_TILE and chunk % SPLIT_TILE == 0
    else:
        assert chunk >= MIN_CHUNK
        assert B * Hkv * n_split <= sms      # one CTA per SM: one wave
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


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("plan", PLANS, ids=str)
def test_split_groups_cover_the_splits(plan, hd):
    """The combine of every plan that a bf16 decode at G 4 makes (the CUDA
    cores at hd 64, the tensor cores at hd 128 and 256): the cluster one
    (group 0) only for hd <= 128 within one cluster; else groups of
    consecutive splits, none empty, each and their number within what one
    combine reads, more than one past one cluster."""
    B, Hkv, L, sms = plan
    _, n_split, _, group = decode_plan(B, 4 * Hkv, Hkv, L, hd,
                                       torch.bfloat16, sms)
    assert group == split_groups(n_split, hd)
    if group == 0:
        assert hd != 256 and n_split <= MAX_SPLIT
        return
    assert hd == 256 or n_split > MAX_SPLIT
    groups = -(-n_split // group)
    assert 1 <= group <= MAX_GROUP and groups <= MAX_GROUP
    assert (groups - 1) * group < n_split <= groups * group
    if n_split > MAX_SPLIT:
        assert groups > 1


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("L", [32768, 65536, 131072])
def test_split_plan_fills_the_card_at_long_context(L, sms):
    """gemma3-1b's global decode at batch 1 (one KV head, 128k context):
    at least one CTA per SM, in one wave, and no range shorter than
    MIN_CHUNK."""
    n_split, chunk = split_plan(1, 1, L, sms)
    assert n_split >= sms
    assert n_split == sms                 # exactly one wave
    assert chunk >= MIN_CHUNK


@pytest.mark.parametrize("bucket", [1, 2, 4, 8])
def test_split_plan_fills_the_card_on_the_minicpm_path(bucket):
    """minicpm-2b's decode: every bucket of the serving path (prompt 512 +
    32 generated tokens) gives at least one CTA per SM of an H100."""
    cfg = get_config("minicpm-2b")
    L = 512 + 32
    n_split, _ = split_plan(bucket, cfg.n_kv_heads, L, H100_SMS)
    assert bucket * cfg.n_kv_heads * n_split >= H100_SMS


def test_split_plan_at_the_serving_buckets():
    """The plans the minicpm-2b step takes on an H100 (bf16 at hd 64, G 1:
    the tensor cores, ``split_plan_tc``): 3 splits of 192 keys at bucket 1
    (108 CTAs), 1 of 544 at bucket 8 (288, three an SM)."""
    assert split_plan_tc(1, 36, 544, H100_SMS) == (3, 192)
    assert split_plan_tc(8, 36, 544, H100_SMS) == (1, 544)


@pytest.mark.parametrize("plan", PLANS, ids=str)
def test_split_plan_tc_covers_the_cache(plan):
    """The hd 128 tensor-core plan: at most one cluster of whole tiles, at
    most one CTA per SM (but one range where B * Hkv alone passes the SMs),
    and each of several ranges more than TC_MIN_CHUNK / 2 keys."""
    B, Hkv, L, sms = plan
    n_split, chunk = split_plan_tc(B, Hkv, L, sms)
    assert split_plan_tc(B, Hkv, L, sms) == (n_split, chunk)
    assert 1 <= n_split <= MAX_SPLIT and split_groups(n_split, 128) == 0
    assert chunk >= SPLIT_TILE and chunk % SPLIT_TILE == 0
    assert B * Hkv * n_split <= max(sms, B * Hkv)
    if n_split > 1:
        assert chunk > TC_MIN_CHUNK // 2
    rng = _ranges(L, n_split, chunk)
    assert rng[0][0] == 0 and rng[-1][1] == max(L, 0)
    for (a, b), (c, _) in zip(rng, rng[1:]):
        assert b == c
    if L > 0:
        assert all(b > a for a, b in rng)


@pytest.mark.parametrize("case", [
    # (B, L): (n_split, chunk, group) over 8 KV heads at hd 128 on an H100,
    # as split_plan_tc gives them to the tensor-core body: at most one CTA
    # per SM, one cluster, no range much under TC_MIN_CHUNK keys
    ((8, 544), (2, 288, 0)), ((1, 544), (3, 192, 0)),
    ((8, 4096), (2, 2048, 0)), ((1, 4096), (8, 512, 0)),
    ((8, 32768), (2, 16384, 0)), ((1, 32768), (8, 4096, 0))], ids=str)
def test_split_plan_at_the_hd128_grouped_shapes(case):
    (B, L), want = case
    n_split, chunk = split_plan_tc(B, 8, L, H100_SMS)
    assert (n_split, chunk, split_groups(n_split, 128)) == want


@pytest.mark.parametrize("plan", PLANS, ids=str)
def test_split_plan_tc_covers_the_cache_at_hd96(plan):
    """The hd 96 tensor-core plan: at most one cluster of whole tiles, at
    most one CTA per two SMs (but one range where B * Hkv alone passes
    that), and each of several ranges more than TC96_MIN_CHUNK / 2 keys."""
    B, Hkv, L, sms = plan
    n_split, chunk = split_plan_tc(B, Hkv, L, sms, 96)
    assert split_plan_tc(B, Hkv, L, sms, 96) == (n_split, chunk)
    assert 1 <= n_split <= MAX_SPLIT and split_groups(n_split, 96) == 0
    assert chunk >= SPLIT_TILE and chunk % SPLIT_TILE == 0
    assert B * Hkv * n_split <= max(sms // 2, B * Hkv)
    if n_split > 1:
        assert chunk > TC96_MIN_CHUNK // 2
    rng = _ranges(L, n_split, chunk)
    assert rng[0][0] == 0 and rng[-1][1] == max(L, 0)
    for (a, b), (c, _) in zip(rng, rng[1:]):
        assert b == c
    if L > 0:
        assert all(b > a for a, b in rng)


@pytest.mark.parametrize("case", [
    # (hd, G, dtype, instance): bf16 on the tensor cores at hd 256, at hd
    # 128 with 2 <= G <= 8 and at hd 64 and 96 (phi-3) with G <= 8; hd 128
    # at G 1, hd 64 and 96 past 8 heads a KV head, float32 and hd 32 and 72
    # on the CUDA cores
    *[(128, G, torch.bfloat16, "tensor_cores") for G in range(2, 9)],
    *[(256, G, torch.bfloat16, "tensor_cores") for G in (1, 2, 4)],
    *[(64, G, torch.bfloat16, "tensor_cores") for G in (1, 4, 8)],
    *[(96, G, torch.bfloat16, "tensor_cores") for G in (1, 4, 8)],
    (128, 1, torch.bfloat16, "cuda_cores"),
    (64, 16, torch.bfloat16, "cuda_cores"),
    (96, 10, torch.bfloat16, "cuda_cores"),
    *[(hd, G, torch.float32, "cuda_cores")
      for hd, G in ((128, 1), (128, 4), (128, 6), (128, 8), (256, 4))],
    *[(hd, G, torch.float32, "cuda_cores") for hd in (32, 64, 72, 96)
      for G in (1, 4, 8)],
    *[(hd, G, torch.bfloat16, "cuda_cores") for hd in (32, 72)
      for G in (1, 4, 8)]],
    ids=str)
def test_decode_instance_picks_the_body(case):
    hd, G, dtype, want = case
    assert decode_instance(hd, G, dtype) == want


@pytest.mark.parametrize("case", [
    # (B, Hq, Hkv, L, hd, dtype): (instance, n_split, chunk, group) on an
    # H100 at the serving paths' decodes: minicpm-2b (hd 64, G 1) on the
    # tensor cores, one range at bucket 8 and three over a cluster at 1,
    # and over 32768 keys at batch 1; gemma3-1b (hd 256, one KV head) in
    # one ticket group, at buckets 8 and 1 over 544 keys; gemma3-1b in
    # float32; minitron-8b (hd 128, G 4) over a cluster; gemma3-1b's global
    # layer at batch 1 over 32768 keys, by tickets in groups; phi-3 (hd 96,
    # G 1) on the tensor cores (split_plan_tc at hd 96), one range at bucket 8
    # (256 CTAs, two an SM) and at batch 1, two over a cluster at batch 1
    # over 4096 and 32768 keys
    ((8, 36, 36, 544, 64, torch.bfloat16), ("tensor_cores", 1, 544, 0)),
    ((1, 36, 36, 544, 64, torch.bfloat16), ("tensor_cores", 3, 192, 0)),
    ((1, 36, 36, 32768, 64, torch.bfloat16),
     ("tensor_cores", 3, 10944, 0)),
    ((8, 36, 36, 544, 64, torch.float32), ("cuda_cores", 2, 288, 0)),
    ((8, 4, 1, 544, 256, torch.bfloat16), ("tensor_cores", 6, 96, 6)),
    ((1, 4, 1, 544, 256, torch.bfloat16), ("tensor_cores", 6, 96, 6)),
    ((8, 4, 1, 544, 256, torch.float32), ("cuda_cores", 6, 96, 6)),
    ((8, 32, 8, 544, 128, torch.bfloat16), ("tensor_cores", 2, 288, 0)),
    ((1, 4, 1, 32768, 256, torch.bfloat16),
     ("tensor_cores", 132, 249, 12)),
    ((8, 32, 32, 544, 96, torch.bfloat16), ("tensor_cores", 1, 544, 0)),
    ((1, 32, 32, 544, 96, torch.bfloat16), ("tensor_cores", 1, 544, 0)),
    ((1, 32, 32, 4096, 96, torch.bfloat16), ("tensor_cores", 2, 2048, 0)),
    ((1, 32, 32, 32768, 96, torch.bfloat16),
     ("tensor_cores", 2, 16384, 0))], ids=str)
def test_decode_plan_at_the_serving_shapes(case):
    shape, want = case
    assert decode_plan(*shape, H100_SMS) == want


def _lse(parts):
    """(m, l, acc) of partials combined by log-sum-exp, in their order:
    m = max_s m_s, l = sum_s w_s l_s, acc = sum_s w_s acc_s with w_s =
    exp(m_s - m)."""
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.exp(m - M) for m, _, _ in parts]
    return (M, sum(wi * li for wi, (_, li, _) in zip(w, parts)),
            sum(wi[..., None] * a for wi, (_, _, a) in zip(w, parts)))


def split_combine(q, k, v, valid_len, n_split, chunk, group=0):
    """The kernel's arithmetic in plain PyTorch (float64): per split, the
    max score m, the sum of exponentials l and the weighted sum of V acc
    (an empty split gives m = -1e30, l = 0, acc = 0); then, as the kernel
    combines (``split_groups``), the partials of each group of ``group``
    consecutive splits by log-sum-exp (all of them where ``group`` is 0,
    the cluster combine), then the groups' partials the same way; per row
    o = acc / max(l, 1e-30)."""
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
        parts = list(zip(ms, ls, accs))
        size = group or n_split
        groups = [_lse(parts[i:i + size]) for i in range(0, n_split, size)]
        _, den, acc = _lse(groups) if len(groups) > 1 else groups[0]
        out[b] = acc / den.clamp_min(1e-30)[..., None]
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
    # past one cluster: the ticket combine's groups (one KV head at batch
    # 1 and 2, hd 64 and gemma3-1b's 256, a row past which whole groups
    # hold no live key, and valid_len = 0), and gemma3-1b's one-group plan
    (1, 4096, 4, 1, 64, [4096], 132),
    (2, 3000, 4, 1, 256, [2999, 700], 132),
    (1, 9000, 4, 1, 256, [8001], 60),
    (3, 2048, 8, 2, 128, [0, 2048, 129], 132),
    (8, 544, 4, 1, 256, [544, 0, 1, 300, 64, 65, 543, 128], 132),
    # the grouped-query decode at hd 128 over 8 KV heads: one cluster at
    # bucket 2 with a row at 0 (G 6), tickets in groups at batch 1 over
    # mixtral's window (G 5)
    (2, 544, 48, 8, 128, [544, 0], 132),
    (1, 4096, 40, 8, 128, [3001], 132),
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
    got = split_combine(q, k, v, valid_len, n_split, chunk,
                        split_groups(n_split, hd))
    want = decode_attention_plain(q, k, v, valid_len)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    for b in range(B):
        if vl[b] == 0:
            assert not got[b].any()
    # at least one case has a split that holds no live key
    if any(0 < x <= (n_split - 1) * chunk for x in vl):
        assert n_split > 1


@pytest.mark.parametrize("case", [(8, 544, 32, 8, 128, [544, 0, 1, 300,
                                                     64, 65, 543, 128]),
                                  (1, 4096, 48, 8, 128, [3001]),
                                  (2, 1001, 40, 8, 128, [17, 1001]),
                                  # minicpm-2b's batch 1 at hd 64, G 1,
                                  # ending in the first range; hd 64, G 4
                                  (1, 544, 36, 36, 64, [150]),
                                  (2, 333, 16, 4, 64, [333, 0])],
                         ids=str)
def test_split_combine_at_the_tensor_core_plan_matches_the_plain_version(
        case):
    """The tensor-core decode's split (``split_plan_tc``: the grouped
    queries at hd 128, and hd 64) and its cluster combine, ragged, with a
    row at 0 and ranges past valid_len."""
    B, L, Hq, Hkv, hd, vl = case
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((B, Hq, hd), (B, L, Hkv, hd), (B, L, Hkv, hd)))
    valid_len = torch.tensor(vl, dtype=torch.int32)
    n_split, chunk = split_plan_tc(B, Hkv, L, H100_SMS)
    assert n_split > 1
    got = split_combine(q, k, v, valid_len, n_split, chunk,
                        split_groups(n_split, hd))
    want = decode_attention_plain(q, k, v, valid_len)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


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


def test_split_combine_in_groups_matches_the_pallas_kernel():
    """A plan past one cluster (one KV head at batch 1: 16 splits of 128
    keys in groups of 4), ragged, against the Pallas kernel in interpret
    mode."""
    B, L, Hq, Hkv, hd = 1, 2048, 4, 1, 64
    rng = np.random.default_rng(6)
    q = rng.standard_normal((B, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, L, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, L, Hkv, hd)).astype(np.float32)
    vl = np.array([1900], np.int32)
    want = np.asarray(j_decode_pallas(*map(jnp.asarray, (q, k, v, vl)),
                                      block_k=64, interpret=True))
    n_split, chunk = split_plan(B, Hkv, L, H100_SMS)
    group = split_groups(n_split, hd)
    assert (n_split, chunk, group) == (16, 128, 4)
    got = split_combine(*map(torch.from_numpy, (q, k, v, vl)), n_split,
                        chunk, group)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("case", [
    # (B, Sq, Hq, hd, SM count, rows): every head dim but 256 takes 128;
    # gemma3-1b's join (4 q heads, hd 256) at buckets 1, 2 and 4 fits one
    # 64-row CTA per SM, at bucket 8 not; the boundary
    (8, 512, 36, 64, 132, 128), (1, 512, 36, 64, 132, 128),
    (1, 300, 8, 128, 132, 128), (1, 512, 4, 256, 132, 64),
    (2, 512, 4, 256, 132, 64), (4, 512, 4, 256, 132, 64),
    (8, 512, 4, 256, 132, 128), (3, 704, 4, 256, 132, 64),
    (3, 705, 4, 256, 132, 128), (1, 1, 4, 256, 132, 64)], ids=str)
def test_flash_block_q_picks_by_the_grid(case):
    B, Sq, Hq, hd, sms, rows = case
    assert flash_block_q(B, Sq, Hq, hd, sms) == rows


@pytest.mark.parametrize("case", [
    # (B, L, Hq, Hkv, valid_len): minicpm-2b's decode at hd 64, G 1, cut to
    # 6 heads: full rows, ragged rows, a row at 0 (zeros, as the Pallas
    # kernel gives)
    (2, 300, 6, 6, [300, 77]),
    (3, 544, 6, 6, [544, 0, 129]),
    (1, 1000, 4, 4, [999])], ids=str)
def test_decode_plain_matches_jax_at_hd64_multi_head(case):
    """The plain version, and the split-and-combine model at the plan
    minicpm-2b's decode takes at batch 1 over L keys (two or three
    ranges), against the Pallas kernel in interpret mode at hd 64, one
    query head a KV head."""
    B, L, Hq, Hkv, vl = case
    hd = 64
    rng = np.random.default_rng(8)
    q = rng.standard_normal((B, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, L, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, L, Hkv, hd)).astype(np.float32)
    vl = np.array(vl, np.int32)
    want = np.asarray(j_decode_pallas(*map(jnp.asarray, (q, k, v, vl)),
                                      block_k=64, interpret=True))
    tq, tk, tv, tvl = map(torch.from_numpy, (q, k, v, vl))
    got = decode_attention_plain(tq, tk, tv, tvl)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    n_split, chunk = split_plan_tc(1, 36, L, H100_SMS)
    assert n_split > 1
    model = split_combine(tq, tk, tv, tvl, n_split, chunk,
                          split_groups(n_split, hd))
    np.testing.assert_allclose(model.numpy(), want, **TOL)


@pytest.mark.parametrize("case", [
    # (B, L, Hq, Hkv, valid_len): phi-3's decode at hd 96, G 1, cut to 4
    # heads, and G 4 (8 heads over 2 KV heads): full rows, ragged rows
    # (ending in the first range), rows at 0 (zeros, as the Pallas kernel
    # gives)
    (2, 1100, 4, 4, [1100, 0]),
    (3, 1100, 4, 4, [300, 17, 1100]),
    (2, 1100, 8, 2, [0, 1090]),
    (1, 2100, 8, 2, [2001])], ids=str)
def test_decode_plain_matches_jax_at_hd96(case):
    """The plain version, and the split-and-combine model at the plan
    phi-3's decode takes at batch 1 over L keys (32 heads: two ranges over
    a cluster), against the Pallas kernel in interpret mode at hd 96."""
    B, L, Hq, Hkv, vl = case
    hd = 96
    rng = np.random.default_rng(9)
    q = rng.standard_normal((B, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, L, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, L, Hkv, hd)).astype(np.float32)
    vl = np.array(vl, np.int32)
    want = np.asarray(j_decode_pallas(*map(jnp.asarray, (q, k, v, vl)),
                                      block_k=64, interpret=True))
    tq, tk, tv, tvl = map(torch.from_numpy, (q, k, v, vl))
    got = decode_attention_plain(tq, tk, tv, tvl)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    _, n_split, chunk, group = decode_plan(1, 32, 32, L, hd, torch.bfloat16,
                                           H100_SMS)
    assert n_split > 1 and group == 0
    model = split_combine(tq, tk, tv, tvl, n_split, chunk, group)
    np.testing.assert_allclose(model.numpy(), want, **TOL)
