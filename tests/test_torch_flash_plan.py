"""The flash kernel's choice of body and its persistent grid, on the CPU:
``flash_body`` (which of the four bodies runs a head dim and dtype on the
card), ``flash_ctas`` (the persistent body's grid) and ``flash_order``
(its walk); a plain model of what the persistent body computes (each CTA
walks its work tiles of 128 q rows heaviest first, forwards and backwards
through the grid's rounds, and runs the online softmax over each tile's
live 128-key tiles), held against the Pallas kernel (interpret mode); and
the plain version against the JAX reference at the grouped-query shapes
of hd 128 and 96 that the persistent body serves."""
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
    flash_order)

TOL = dict(rtol=3e-5, atol=3e-5)    # f32, as tests/test_kernels.py
NEG_INF = -1e30
BK = 128                            # keys per K/V tile of the body
H100_SMS = 132
H100_L2 = 50 * 2 ** 20


@pytest.mark.parametrize("hd,dtype,body", [
    (32, torch.bfloat16, "narrow"), (64, torch.bfloat16, "narrow"),
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
    # another SM count
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
                                   (32, 96)], ids=str)
def test_flash_ctas_fills_the_sms_at_bucket_8(Hq, hd):
    assert _tiles(8, 512, Hq) > H100_SMS
    assert flash_ctas(8, 512, Hq, hd, H100_SMS) == H100_SMS


@pytest.mark.parametrize("hd", [32, 64, 256])
def test_flash_ctas_refuses_the_head_dims_of_other_bodies(hd):
    with pytest.raises(ValueError, match="persistent"):
        flash_ctas(8, 512, 32, hd, H100_SMS)


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
    (2, 77, 77, 2, 2, 72, True, 0, 1)], ids=str)
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
                                         (2, 129, 6, 6)], ids=str)
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
    # phi-3's join at bucket 8 (32 KV heads of hd 96: 50 MB of K/V) and at
    # batch 1 over 4096 tokens walks by groups; at bucket 4 (25 MB, just
    # under half the L2), 2 and 1 by heads, as the grouped-query joins (8 KV
    # heads of hd 128: 17 MB at bucket 8 over 512 tokens) do
    (8, 512, 32, 96, "groups"), (8, 512, 8, 128, "heads"),
    (1, 512, 32, 96, "heads"), (1, 4096, 8, 128, "heads"),
    (1, 4096, 32, 96, "groups"), (4, 512, 32, 96, "heads"),
    (2, 512, 32, 96, "heads")], ids=str)
def test_flash_order_walks_by_groups_where_the_kv_outgrows_half_the_l2(
        B, Sk, Hkv, hd, order):
    assert flash_order(B, Sk, Hkv, hd, H100_L2) == order


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
    (1, 100, 100, 2, 2, 96, False, 0)], ids=str)
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
