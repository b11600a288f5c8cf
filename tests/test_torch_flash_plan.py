"""The flash kernel's choice of body and its persistent grid, on the CPU:
``flash_body`` (which of the three bodies runs a head dim and dtype on the
card), ``flash_ctas`` (the persistent body's grid) and ``flash_order``
(its walk); a plain model of what the persistent body computes (each CTA
walks its work tiles of 128 q rows heaviest first, forwards and backwards
through the grid's rounds, and runs the online softmax over each tile's
live 128-key tiles), held against the Pallas kernel (interpret mode); and
the plain version against the JAX reference at the shapes that the
persistent body serves: the grouped-query ones of hd 128, hd 96, and
minicpm-2b's multi-head attention at hd 64 cut small."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as j_flash_pallas  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    BLOCK_Q, BODIES, HEAD_DIMS, flash_attention, flash_body, flash_ctas,
    flash_order, walk_loads)

TOL = dict(rtol=3e-5, atol=3e-5)    # f32, as tests/test_kernels.py
NEG_INF = -1e30
BK = 128                            # keys per K/V tile of the body
H100_SMS = 132
H100_L2 = 50 * 2 ** 20


@pytest.mark.parametrize("hd,dtype,body", [
    (32, torch.bfloat16, "persistent"), (64, torch.bfloat16, "persistent"),
    (72, torch.bfloat16, "persistent"), (96, torch.bfloat16, "persistent"),
    (128, torch.bfloat16, "persistent"), (256, torch.bfloat16, "hd256"),
    *[(hd, torch.float32, "f32") for hd in HEAD_DIMS]], ids=str)
def test_flash_body_picks_by_head_dim_and_dtype(hd, dtype, body):
    assert flash_body(hd, dtype) == body
    assert body in BODIES


def _tiles(B, Sq, Hq):
    return B * Hq * -(-Sq // BLOCK_Q)


@pytest.mark.parametrize("case", [
    # (B, Sq, Hq, hd, SM count): the serving buckets of minitron-8b,
    # llama4-scout, mixtral-8x22b (8 KV heads, G 4, 5, 6) and phi-3 (32
    # heads) over 512 tokens, batch 1 over 4096, ragged and tiny shapes,
    # another SM count; minicpm-2b (36 heads of hd 64) at buckets 8 and 1
    # and over 4096 tokens, zamba2-1.2b (32 heads), whisper-tiny's encoder
    # (6 heads over 1500 frames), hd 32
    (8, 512, 36, 64, 132), (1, 512, 36, 64, 132), (1, 4096, 36, 64, 132),
    (8, 512, 32, 64, 132), (1, 1500, 6, 64, 132), (8, 512, 16, 32, 132),
    (8, 512, 32, 128, 132), (8, 512, 40, 128, 132), (8, 512, 48, 128, 132),
    (8, 512, 32, 96, 132), (4, 512, 32, 128, 132), (2, 512, 48, 128, 132),
    (1, 512, 32, 128, 132), (1, 512, 48, 128, 132), (1, 4096, 32, 128, 132),
    (1, 4096, 32, 96, 132), (3, 1, 8, 72, 132), (1, 1, 1, 128, 132),
    (2, 129, 2, 96, 132), (5, 300, 12, 128, 78)], ids=str)
def test_flash_ctas_never_exceeds_the_tiles_and_fills_what_it_can(case):
    """At most one CTA a work tile and one an SM; every SM busy where the
    tiles outnumber the SMs; one CTA a tile where they do not."""
    B, Sq, Hq, hd, sms = case
    tiles, ctas = _tiles(B, Sq, Hq), flash_ctas(B, Sq, Hq, hd, sms)
    assert 1 <= ctas <= tiles and ctas <= sms
    assert ctas == min(tiles, sms)


@pytest.mark.parametrize("Hq,hd", [(32, 128), (40, 128), (48, 128),
                                   (32, 96), (36, 64), (32, 64)], ids=str)
def test_flash_ctas_fills_the_sms_at_bucket_8(Hq, hd):
    assert _tiles(8, 512, Hq) > H100_SMS
    assert flash_ctas(8, 512, Hq, hd, H100_SMS) == H100_SMS


@pytest.mark.parametrize("hd", [16, 48, 256])
def test_flash_ctas_refuses_the_head_dims_of_other_bodies(hd):
    with pytest.raises(ValueError, match="persistent"):
        flash_ctas(8, 512, 32, hd, H100_SMS)


@pytest.mark.parametrize("hd", [32, 64])
def test_flash_ctas_accepts_the_narrow_head_dims(hd):
    """hd 32 and 64 run the persistent body: one CTA an SM at bucket 8."""
    assert flash_ctas(8, 512, 36, hd, H100_SMS) == H100_SMS
    assert flash_ctas(1, 100, 2, hd, H100_SMS) == 2


def tile_range(first_q, rows, Sk, causal, window):
    """The kernel's ``TileRange``: the live 128-key tiles [lo, hi) of the
    q rows first_q .. first_q + rows - 1 (positions aligned to the end of
    K), _fa_kernel's tile test."""
    last_q = first_q + rows - 1
    nk = -(-Sk // BK)
    hi = nk
    if causal:
        hi = 0 if last_q < 0 else min(nk, last_q // BK + 1)
    lo = 0
    if window > 0:
        while lo < hi and first_q - (lo * BK + BK - 1) >= window:
            lo += 1
    return lo, hi


def work_tile(w, B, nq, Hq, Hkv, order):
    """Work tile w's (q tile, head, batch row): ``"heads"``, the head
    fastest, then the batch row, then the q tile reversed (heaviest
    first); ``"groups"``, each KV head's G x nq tiles together, the G heads
    fastest, then the q tile reversed."""
    G = Hq // Hkv
    if order == "groups":
        t = w // G
        return (nq - 1 - t % nq, (t // nq) % Hkv * G + w % G,
                t // (nq * Hkv))
    return nq - 1 - w // (Hq * B), w % Hq, (w // Hq) % B


def persistent_walk(B, Sq, Hq, ctas, Hkv=None, order="heads"):
    """Each CTA's work tiles (q tile, head, batch row) in the order it runs
    them: round j of the grid holds tiles j * ctas to (j + 1) * ctas - 1,
    and CTA c takes the c-th of them in even rounds, the c-th from the end
    in odd ones."""
    nq = -(-Sq // BLOCK_Q)
    tiles = nq * Hq * B
    walks = []
    for c in range(ctas):
        ws = [j * ctas + (ctas - 1 - c if j % 2 else c)
              for j in range(-(-tiles // ctas))]
        walks.append([work_tile(w, B, nq, Hq, Hkv or Hq, order)
                      for w in ws if w < tiles])
    return walks


def persistent_model(q, k, v, *, causal, window, ctas, order="heads"):
    """What the persistent body computes, in float32, CTA by CTA: each
    work tile's 128 rows over its live K/V tiles, masked where a tile
    straddles Sk, the diagonal or the window, with the online softmax
    (finite mask value, l floored at 1e-30)."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    scale = hd ** -0.5
    out = torch.full_like(q, float("nan"))
    for cta in persistent_walk(B, Sq, Hq, ctas, Hkv, order):
        for iq, h, b in cta:
            q0 = iq * BLOCK_Q
            first_q = q0 + Sk - Sq
            lo, hi = tile_range(first_q, BLOCK_Q, Sk, causal, window)
            rows = q[b, q0:q0 + BLOCK_Q, h] * scale
            qpos = first_q + torch.arange(rows.shape[0])[:, None]
            m = torch.full((rows.shape[0],), NEG_INF)
            l = torch.zeros(rows.shape[0])
            acc = torch.zeros(rows.shape[0], hd)
            for ik in range(lo, hi):
                keys = k[b, ik * BK:(ik + 1) * BK, h // (Hq // Hkv)]
                vals = v[b, ik * BK:(ik + 1) * BK, h // (Hq // Hkv)]
                s = rows @ keys.T
                kpos = ik * BK + torch.arange(keys.shape[0])[None, :]
                live = torch.ones_like(s, dtype=torch.bool)
                if causal:
                    live &= qpos >= kpos
                if window > 0:
                    live &= qpos - kpos < window
                s = torch.where(live, s, torch.tensor(NEG_INF))
                m_new = torch.maximum(m, s.max(dim=1).values)
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[:, None])
                l = l * alpha + p.sum(dim=1)
                acc = acc * alpha[:, None] + p @ vals
                m = m_new
            out[b, q0:q0 + BLOCK_Q, h] = acc / l.clamp_min(1e-30)[:, None]
    return out


@pytest.mark.parametrize("order", ["heads", "groups"])
@pytest.mark.parametrize("case", [
    # (B, Sq, Sk, Hq, Hkv, hd, causal, window, ctas): more work tiles than
    # CTAs (a CTA walks several, heaviest first), fewer (one each), a
    # window that cuts tiles mid-way, Sq < Sk, Sq no multiple of 128, Sq = 1,
    # non-causal, G 4 / 5 / 6 at hd 128 and G 1 at hd 96 and 72
    (2, 200, 200, 8, 2, 128, True, 48, 3),
    (1, 130, 300, 12, 2, 128, True, 100, 5),
    (2, 160, 160, 10, 2, 128, True, 0, 132),
    (1, 130, 130, 4, 4, 96, False, 0, 7),
    (3, 1, 200, 8, 2, 128, True, 0, 4),
    (2, 77, 77, 2, 2, 72, True, 0, 1),
    # hd 64 multi-head (minicpm-2b's G 1), a window inside a tile, and hd
    # 32 non-causal
    (2, 300, 300, 6, 6, 64, True, 0, 5),
    (1, 200, 260, 4, 4, 64, True, 16, 3),
    (1, 150, 150, 2, 2, 32, False, 0, 2)], ids=str)
def test_the_persistent_walk_computes_the_pallas_kernels_function(case,
                                                                  order):
    B, Sq, Sk, Hq, Hkv, hd, causal, w, ctas = case
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, Sq, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32)
    want = np.asarray(j_flash_pallas(*map(jnp.asarray, (q, k, v)),
                                     causal=causal, window=w, interpret=True,
                                     block_q=64, block_k=64))
    got = persistent_model(*map(torch.from_numpy, (q, k, v)),
                           causal=causal, window=w, ctas=ctas, order=order)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("order", ["heads", "groups"])
@pytest.mark.parametrize("B,Sq,Hq,Hkv", [(8, 512, 32, 8), (8, 512, 48, 8),
                                         (1, 4096, 32, 32), (3, 300, 12, 4),
                                         (2, 129, 6, 6), (8, 512, 36, 36),
                                         (1, 4096, 36, 36), (1, 1500, 6, 6)],
                         ids=str)
def test_each_order_walks_every_tile_once(B, Sq, Hq, Hkv, order):
    ctas = min(B * Hq * -(-Sq // BLOCK_Q), H100_SMS)
    walks = persistent_walk(B, Sq, Hq, ctas, Hkv, order)
    nq = -(-Sq // BLOCK_Q)
    assert sorted(t for walk in walks for t in walk) == sorted(
        (iq, h, b) for iq in range(nq) for h in range(Hq) for b in range(B))
    # the groups order keeps a KV head's tiles together
    if order == "groups":
        flat = [work_tile(w, B, nq, Hq, Hkv, order)
                for w in range(B * Hq * nq)]
        G = Hq // Hkv
        for i in range(0, len(flat), G * nq):
            assert len({(b, h // G) for _, h, b in flat[i:i + G * nq]}) == 1


@pytest.mark.parametrize("B,Sk,Hkv,hd,order", [
    # phi-3's join at bucket 8 (32 KV heads of hd 96: 50 MB of K/V) walks
    # by groups; at batch 1 over 4096 tokens by heads (its K/V outgrows
    # half the L2, but the groups order would hold a CTA to 132 live K/V
    # tiles where the heads order holds it to 128); at bucket 4 (25 MB,
    # just under half the L2), 2 and 1 by heads, as the grouped-query joins
    # (8 KV heads of hd 128, G 4: 17 MB at bucket 8 over 512 tokens) do
    (8, 512, 32, 96, "groups"), (8, 512, 8, 128, "heads"),
    (1, 512, 32, 96, "heads"), (1, 4096, 8, 128, "heads"),
    (1, 4096, 32, 96, "heads"), (4, 512, 32, 96, "heads"),
    (2, 512, 32, 96, "heads"),
    # minicpm-2b (36 KV heads of hd 64: 38 MB at bucket 8, 19 MB at 4; at
    # batch 1 over 4096 tokens 38 MB, but groups 164 tiles a CTA, heads 146)
    (8, 512, 36, 64, "groups"), (4, 512, 36, 64, "heads"),
    (1, 512, 36, 64, "heads"), (1, 4096, 36, 64, "heads")], ids=str)
def test_flash_order_walks_by_groups_where_the_kv_outgrows_half_the_l2(
        B, Sk, Hkv, hd, order):
    Hq = 4 * Hkv if hd == 128 else Hkv
    ctas = flash_ctas(B, Sk, Hq, hd, H100_SMS)
    assert flash_order(B, Sk, Sk, Hq, Hkv, hd, ctas, H100_L2) == order


@pytest.mark.parametrize("order", ["heads", "groups"])
@pytest.mark.parametrize("case", [
    # (B, Sq, Sk, Hq, Hkv, causal, window, ctas): the serving buckets and
    # long prompts of minicpm-2b and phi-3, G 4, a window, Sq < Sk, Sq no
    # multiple of 128, non-causal, fewer tiles than CTAs
    (8, 512, 512, 36, 36, True, 0, 132), (1, 4096, 4096, 36, 36, True, 0, 132),
    (1, 4096, 4096, 32, 32, True, 0, 132), (8, 512, 512, 32, 8, True, 0, 132),
    (2, 700, 700, 8, 2, True, 200, 13), (1, 130, 300, 12, 2, True, 100, 5),
    (3, 300, 300, 6, 3, False, 0, 7), (1, 1, 200, 8, 2, True, 0, 4)],
    ids=str)
def test_walk_loads_counts_each_ctas_live_tiles(case, order):
    """``walk_loads`` (what ``flash_order`` weighs) against the plain model
    of the walk: every CTA's live 128-key tiles, summed over its work
    tiles."""
    B, Sq, Sk, Hq, Hkv, causal, window, ctas = case
    walks = persistent_walk(B, Sq, Hq, ctas, Hkv, order)
    want = [sum(tile_range(iq * BLOCK_Q + Sk - Sq, BLOCK_Q, Sk, causal,
                           window)[1]
                - tile_range(iq * BLOCK_Q + Sk - Sq, BLOCK_Q, Sk, causal,
                             window)[0] for iq, _, _ in walk)
            for walk in walks]
    assert walk_loads(order, B, Sq, Sk, Hq, Hkv, ctas, causal, window) == want


@pytest.mark.parametrize("Hq,hd", [(32, 128), (40, 128), (48, 128),
                                   (32, 96)], ids=str)
def test_the_persistent_walk_is_balanced_at_bucket_8(Hq, hd):
    """Causal over 512 tokens, bucket 8: work tiles hold 1, 2, 3 or 4 live
    K/V tiles of 128 keys; taken heaviest first, forwards and backwards in
    turn, every tile once, and no CTA holds more than 5 % over the mean."""
    ctas = flash_ctas(8, 512, Hq, hd, H100_SMS)
    walks = persistent_walk(8, 512, Hq, ctas)
    assert sorted(t for walk in walks for t in walk) == sorted(
        (iq, h, b) for iq in range(4) for h in range(Hq) for b in range(8))
    load = [sum(tile_range(iq * BLOCK_Q, BLOCK_Q, 512, True, 0)[1]
                - tile_range(iq * BLOCK_Q, BLOCK_Q, 512, True, 0)[0]
                for iq, _, _ in walk)
            for walk in walks]
    assert sum(load) == 8 * Hq * (1 + 2 + 3 + 4)
    assert max(load) <= 1.05 * sum(load) / len(load)


@pytest.mark.parametrize("case", [
    # (B, Sq, Sk, Hq, Hkv, hd, causal, window): hd 128 with G 4 and 6
    # under a window that cuts a tile, hd 96 (G 1) causal and not
    (2, 150, 150, 8, 2, 128, True, 48),
    (1, 130, 200, 12, 2, 128, True, 70),
    (2, 129, 129, 4, 4, 96, True, 0),
    (1, 100, 100, 2, 2, 96, False, 0),
    # minicpm-2b's attention (hd 64, G 1) cut to 6 heads: a causal join,
    # a ragged Sq < Sk, non-causal (whisper's encoder), a window
    (2, 130, 130, 6, 6, 64, True, 0),
    (1, 70, 200, 6, 6, 64, True, 0),
    (1, 150, 150, 6, 6, 64, False, 0),
    (2, 140, 140, 4, 4, 64, True, 40)], ids=str)
def test_flash_plain_matches_jax_at_the_persistent_head_dims(case):
    B, Sq, Sk, Hq, Hkv, hd, causal, w = case
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, Sq, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_ref = np.asarray(jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                                   window=w))
    want_pallas = np.asarray(j_flash_pallas(jq, jk, jv, causal=causal,
                                            window=w, interpret=True,
                                            block_q=64, block_k=64))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                          window=w)
    np.testing.assert_allclose(got.numpy(), want_ref, **TOL)
    np.testing.assert_allclose(got.numpy(), want_pallas, **TOL)


@pytest.mark.parametrize("Hq", [36, 32], ids=str)
def test_the_hd64_walk_is_balanced_in_the_order_flash_order_names(Hq):
    """minicpm-2b's (36 heads) and zamba2-1.2b's (32) joins at bucket 8 over
    512 tokens, hd 64, G 1: their K/V outgrow half the L2, so the CTAs
    walk each head's four q tiles together; every tile once, and no CTA
    holds more than one heaviest work tile (4 live 128-key tiles) over the
    mean: 36 heads give 8.7 work tiles a CTA, so the last round's 96 fall
    on some CTAs and not others."""
    ctas = flash_ctas(8, 512, Hq, 64, H100_SMS)
    order = flash_order(8, 512, 512, Hq, Hq, 64, ctas, H100_L2)
    assert order == "groups"
    walks = persistent_walk(8, 512, Hq, ctas, Hq, order)
    assert sorted(t for walk in walks for t in walk) == sorted(
        (iq, h, b) for iq in range(4) for h in range(Hq) for b in range(8))
    load = [sum(tile_range(iq * BLOCK_Q, BLOCK_Q, 512, True, 0)[1]
                - tile_range(iq * BLOCK_Q, BLOCK_Q, 512, True, 0)[0]
                for iq, _, _ in walk)
            for walk in walks]
    assert sum(load) == 8 * Hq * (1 + 2 + 3 + 4)
    assert max(load) <= sum(load) / len(load) + 4
