"""Time the port's three CUDA kernels of a checkout on the card.

    python3 tools/time_kernels.py ROOT [TAG] [--hd256 | --hd128 | --hd128-plans
                                              | --flash [--sdpa] [--clean]
                                              | --hd64 | --hd64-plans
                                              | --hd96 | --hd96-plans]

imports ``repro_torch`` from ``ROOT/src`` (building its kernels into
``ROOT/build``) and times, bf16, at the serving shapes that
``chip_smoke.py`` phase 4 uses: ``flash_attention`` (minicpm-2b's join,
S 512, 36 heads, hd 64, causal) and ``decode_attention`` (its step, L 544)
at buckets 8 and 1, ``ssd_scan`` (mamba2-370m's join, S 512, 32 heads,
P 64, N 128, chunk 64) and its plain version at buckets 8 and 1 (the plain
one as phase 4 times it, then behind a sleep that outlasts the host's
enqueue, with the host's time per call beside), and flash's one-CTA fit
(36 q tiles of 128 rows, not causal, over 64 and 2048 keys: the fixed cost
of a CTA and the cost of each further 64-key tile); where the checkout
has ``split_groups``, decode also with the ticket combine in place of the
cluster combine (``decode_ticket_ms_bucket*``, between two timings of the
cluster's).  With ``--hd256`` it times instead gemma3-1b's attention at hd
256 (4 q heads over 1 KV head): flash at buckets 8, 4, 2 and 1 (S 512,
causal) and at batch 1 over 8192 and 32768 tokens, and decode at buckets
8 and 1 (L 544) and at batch 1 over 32768 and 131072 keys, each beside
SDPA on the same inputs (``*_sdpa_*``), the long decodes also beside a
plain read of K and V and with a clean L2, and each decode's error
against its plain version (``hd256_times``).  With ``--hd128`` it times
the grouped-query attention at hd 128 (8 KV heads; G = 4, 5, 6 query
heads each: minitron-8b, llama4-scout, mixtral-8x22b): decode at buckets
8 and 1 over 544 keys and at batch 1 over 4096 and 32768 keys, flash at
buckets 8, 4, 2 and 1 (S 512, causal) and at batch 1 over 4096 tokens
(G 4, and G 6 under mixtral's window), flash at phi-3's hd 96 (32 heads,
G = 1) at the same cases, and flash's one-CTA fit at hd 128, each beside
SDPA and its bound, at bucket 8 beside its plain version, each decode's
and each bucket-8 flash's error against its plain version, and the hd
128 and hd 96 instances' registers and spills from the compiler's reports
(``hd128_times``); with ``--hd128-plans`` that decode at other splits of
the cache than the wrapper's plan (``hd128_plans``); with ``--flash``
flash at hd 128 and 96 at the cases the persistent body was designed on,
beside SDPA with ``--sdpa``, with a clean L2 with ``--clean``
(``flash_times``).  With ``--hd64`` it times minicpm-2b's attention
at hd 64 (36 heads, G 1) and the other hd 64 joins (whisper-tiny's
encoder, zamba2-1.2b), each beside SDPA and its bound, and both kernels'
one-CTA fits (``hd64_times``); with ``--hd64-plans`` that decode on each
body and at other splits of the cache (``hd64_plans``).  With ``--hd96``
it times phi-3's decode at hd 96 (32 heads, G 1) likewise, with its
one-CTA fit and its ptxas lines (``hd96_times``); with ``--hd96-plans``
that decode on each body and at other splits (``hd96_plans``).  Each time is the
median of 25 CUDA-event timings, L2 flushed, a device-side sleep ahead of
each.  It prints one JSON line.  Run it on several checkouts in turns
(A, B, B, A) in one call to compare them on one card.
"""
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

import torch


def time_ms(fn, flush, runs=25, warmup=3, sleep=1_000_000, host=None,
            clean=False):
    """Median CUDA-event time of ``fn``; ``sleep`` cycles of device-side
    sleep ahead of each run (about 0.5 ms by default, as chip_smoke.py
    phase 4).  ``host``, a list, gets the median host time of each call.
    The L2 is emptied before each run by writing the flush buffer, as
    phase 4 does, or with ``clean`` by reading it."""
    for _ in range(warmup):
        fn()
    ts, hs = [], []
    for _ in range(runs):
        if clean:
            flush.max()
        else:
            flush.zero_()
        torch.cuda._sleep(sleep)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        fn()
        hs.append((time.perf_counter() - t0) * 1e3)
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    if host is not None:
        host.append(sorted(hs)[len(hs) // 2])
    return sorted(ts)[len(ts) // 2]


def hd256_times(flash_attention, dec_mod, rnd, flush):
    """gemma3-1b's hd 256 attention, the kernels beside SDPA: flash at
    buckets 8, 4, 2, 1 (S 512) and at batch 1 over 8192 and 32768 tokens
    (``flash256_*_B1_S*``), and its one-wave fit (128 CTAs of 128 and of
    64 q rows, not causal, over 1 and 32 K/V tiles of 64 keys: the fixed
    cost and the cost of each further tile); decode at buckets 8 and 1 (L
    544) and at batch 1 over 32768 and 131072 keys, there also beside a
    plain read of the same K and V (``k.amax(), v.amax()``), and again
    with the L2 emptied by a read of the flush buffer in place of a write
    (so that no dirty line is written back during the timing); at L 544,
    where the checkout has ``decode_plan`` (whose tensor-core body can
    combine over a cluster), also over a cluster and in one ticket group
    whatever the wrapper picks, then the wrapper's combine again
    (``decode256_cluster_ms_*``, ``decode256_ticket_ms_*``,
    ``decode256_again_ms_*``); and each
    decode's largest error against its plain version, absolute and as a
    share of the row's norm (``decode256_err_*``, ``decode256_row_err_*``).
    """
    F = torch.nn.functional
    decode_attention = dec_mod.decode_attention
    decode_attention_plain = dec_mod.decode_attention_plain
    groups = dec_mod.split_groups
    both = hasattr(dec_mod, "decode_plan")
    out = {}
    for B, S in ((8, 512), (4, 512), (2, 512), (1, 512), (1, 8192),
                 (1, 32768)):
        name = f"bucket{B}" if S == 512 else f"B{B}_S{S}"
        q = rnd(B, S, 4, 256).bfloat16()
        k, v = rnd(B, S, 1, 256).bfloat16(), rnd(B, S, 1, 256).bfloat16()
        out[f"flash256_ms_{name}"] = time_ms(
            lambda: flash_attention(q, k, v, causal=True), flush)
        out[f"flash256_sdpa_ms_{name}"] = time_ms(
            lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True), flush)
    for rows in (128, 64):
        fit = {}
        for Sk in (64, 2048):
            q = rnd(32, rows, 4, 256).bfloat16()
            k, v = (rnd(32, Sk, 1, 256).bfloat16() for _ in range(2))
            fit[Sk] = time_ms(lambda: flash_attention(q, k, v, causal=False),
                              flush)
        per_tile = (fit[2048] - fit[64]) / 31
        out[f"flash256_fit{rows}_fixed_ms"] = fit[64] - per_tile
        out[f"flash256_fit{rows}_per_tile_ms"] = per_tile
    for B, L in ((8, 544), (1, 544), (1, 32768), (1, 131072)):
        q = rnd(B, 4, 256).bfloat16()
        k, v = rnd(B, L, 1, 256).bfloat16(), rnd(B, L, 1, 256).bfloat16()
        vlen = torch.full((B,), L, dtype=torch.int32, device="cuda")
        got = decode_attention(q, k, v, vlen).float()
        want = decode_attention_plain(q, k, v, vlen).float()
        d = got - want
        out[f"decode256_err_B{B}_L{L}"] = d.abs().max().item()
        out[f"decode256_row_err_B{B}_L{L}"] = (
            d.norm(dim=-1) / want.norm(dim=-1)).max().item()
        runs = {"": lambda: decode_attention(q, k, v, vlen),
                "sdpa_": lambda: F.scaled_dot_product_attention(
                    q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                    enable_gqa=True)}
        if L > 544:
            runs["read_"] = lambda: (k.amax(), v.amax())
        for name, fn in runs.items():
            out[f"decode256_{name}ms_B{B}_L{L}"] = time_ms(fn, flush)
            if L > 544:
                out[f"decode256_{name}ms_B{B}_L{L}_clean"] = time_ms(
                    fn, flush, clean=True)
        if L == 544 and both:
            for name, forced in (("cluster_", lambda n_split, hd: 0),
                                 ("ticket_", lambda n_split, hd: n_split)):
                dec_mod.split_groups = forced
                try:
                    out[f"decode256_{name}ms_B{B}_L{L}"] = time_ms(
                        runs[""], flush)
                finally:
                    dec_mod.split_groups = groups
            out[f"decode256_again_ms_B{B}_L{L}"] = time_ms(runs[""], flush)
    return out


HBM_BYTES_PER_S, BF16_FLOPS = 3.35e12, 989e12   # H100 SXM, data sheet


def bound_ms(nbytes, flops):
    """The least time of the card: bytes at its memory rate or operations at
    its bf16 tensor-core rate, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3


def hd128_times(flash_attention, flash_attention_plain, decode_attention,
                decode_attention_plain, rnd, flush, ptxas):
    """The grouped-query attention at hd 128 over 8 KV heads, G = 4, 5, 6
    (minitron-8b, llama4-scout, mixtral-8x22b), beside SDPA: decode at
    buckets 8 and 1 over 544 keys and at batch 1 over 4096 (mixtral's
    window) and 32768 keys (``decode128_G*``), its plain version at bucket
    8 (behind a 25 ms device sleep, as phase 4), its error against the
    plain version, absolute and as a share of the row's norm; flash at
    buckets 8, 4, 2 and 1 (S 512, causal; ``flash128_G*_B*``) and at batch
    1 over 4096 tokens (G 4, and G 6 under mixtral's window of 4096;
    ``*_B1_S4096``), and the same at phi-3's hd 96 with 32 heads, G = 1
    (``flash96``), at bucket 8 also its plain version and its largest error
    against it (``*_plain_ms``, ``*_err``); flash's one-CTA fit at hd 128
    (``flash128_fit_*``, SDPA's ``flash128_fit_sdpa_*``); each case's bound
    (bytes at 3.35 TB/s or operations at 989 TFLOP/s); and the registers
    and spills that ``ptxas`` reports for the decode kernel's and the flash
    kernel's hd 128 and hd 96 instances (``*_ptxas``)."""
    F = torch.nn.functional
    out = {}
    for G in (4, 5, 6):
        Hq = 8 * G
        for B, L in ((8, 544), (1, 544), (1, 4096), (1, 32768)):
            key = f"decode128_G{G}_B{B}_L{L}"
            q = rnd(B, Hq, 128).bfloat16()
            k, v = rnd(B, L, 8, 128).bfloat16(), rnd(B, L, 8, 128).bfloat16()
            vlen = torch.full((B,), L, dtype=torch.int32, device=q.device)
            got = decode_attention(q, k, v, vlen).float()
            want = decode_attention_plain(q, k, v, vlen).float()
            d = got - want
            out[f"{key}_err"] = d.abs().max().item()
            out[f"{key}_row_err"] = (d.norm(dim=-1)
                                     / want.norm(dim=-1)).max().item()
            out[f"{key}_ms"] = time_ms(
                lambda: decode_attention(q, k, v, vlen), flush)
            out[f"{key}_sdpa_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(
                    q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                    enable_gqa=True), flush)
            if B == 8:
                out[f"{key}_plain_ms"] = time_ms(
                    lambda: decode_attention_plain(q, k, v, vlen), flush,
                    sleep=50_000_000)
            # q read and o written once, every live K/V row once, valid_len
            out[f"{key}_bound_ms"] = bound_ms(
                4 * q.numel() + 2 * 2 * B * L * 8 * 128 + 4 * B,
                4 * 128 * Hq * B * L)
    # flash at the serving buckets over 512 tokens and at batch 1 over 4096
    # (mixtral-8x22b's windowed layers slide 4096 keys, so its case runs
    # the window's code path; a window of 4096 over 4096 tokens masks
    # nothing that causality does not, so SDPA's causal call computes the
    # same function)
    for name, Hq, Hkv, hd in (("flash128_G4", 32, 8, 128),
                              ("flash128_G5", 40, 8, 128),
                              ("flash128_G6", 48, 8, 128),
                              ("flash96", 32, 32, 96)):
        for B, S in ((8, 512), (4, 512), (2, 512), (1, 512), (1, 4096)):
            if S == 4096 and name == "flash128_G5":
                continue
            window = 4096 if S == 4096 and name == "flash128_G6" else 0
            key = f"{name}_B{B}" + ("" if S == 512 else f"_S{S}")
            q = rnd(B, S, Hq, hd).bfloat16()
            k, v = (rnd(B, S, Hkv, hd).bfloat16() for _ in range(2))
            out[f"{key}_ms"] = time_ms(
                lambda: flash_attention(q, k, v, causal=True, window=window),
                flush)
            out[f"{key}_sdpa_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=True, enable_gqa=Hkv != Hq), flush)
            out[f"{key}_bound_ms"] = bound_ms(
                2 * (2 * q.numel() + 2 * k.numel()),
                4 * hd * B * Hq * S * (S + 1) // 2)
            if B == 8:
                out[f"{key}_plain_ms"] = time_ms(
                    lambda: flash_attention_plain(q, k, v, causal=True),
                    flush, sleep=50_000_000)
                out[f"{key}_err"] = (
                    flash_attention(q, k, v, causal=True).float()
                    - flash_attention_plain(q, k, v, causal=True).float()
                ).abs().max().item()
    # what one CTA pays at hd 128: 32 q tiles of 128 rows (G 4 over 8 KV
    # heads, fewer CTAs than SMs), not causal, over 1 and 32 K/V tiles of
    # 64 keys; the fit gives the fixed cost of a CTA and the cost of each
    # further tile, beside SDPA's
    fit = {}
    for Sk in (64, 2048):
        q = rnd(1, 128, 32, 128).bfloat16()
        k, v = (rnd(1, Sk, 8, 128).bfloat16() for _ in range(2))
        fit[Sk] = (time_ms(lambda: flash_attention(q, k, v, causal=False),
                           flush),
                   time_ms(lambda: F.scaled_dot_product_attention(
                       q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2), enable_gqa=True), flush))
    for i, who in enumerate(("", "_sdpa")):
        per_tile = (fit[2048][i] - fit[64][i]) / 31
        out[f"flash128_fit{who}_fixed_ms"] = fit[64][i] - per_tile
        out[f"flash128_fit{who}_per_tile_ms"] = per_tile
    # "Function properties for <mangled name>", then its register line and
    # its spill line
    for src, text in ptxas.items():
        regs, fn = {}, None
        for ln in text.splitlines():
            if "Function properties for" in ln:
                fn = ln.split("Function properties for")[1].strip()
            elif fn and ("Li128E" in fn or "Li96E" in fn) \
                    and ("Used " in ln or "spill" in ln):
                regs.setdefault(fn, []).append(ln.strip())
        out[f"{src}_ptxas"] = regs
    return out


def flash_times(flash_attention, rnd, flush, sdpa=False, clean=False):
    """Flash at hd 128 and 96 at the cases that the persistent body's
    design was weighed on: G 4 and G 6 (8 KV heads) and hd 96 (32 heads,
    G 1) at bucket 8 and batch 1 over 512 tokens and at batch 1 over 4096
    (causal), G 4 non-causal and G 5 at bucket 8, G 4 at batch 2 over 2048
    tokens (``flash_<case>``), and the one-CTA fit at hd 128
    (``flash_fit_fixed`` / ``flash_fit_tile``: 32 CTAs, not causal, over
    64 and 2048 keys); with ``sdpa`` each case also beside SDPA
    (``*_sdpa``); with ``clean`` the L2 emptied by a read of the flush
    buffer in place of a write.  Quick enough to run several variants of a
    checkout (copies under ``build/``, edited by ``sed``) in turns."""
    F = torch.nn.functional
    out = {"clean": clean}

    def tm(fn):
        return time_ms(fn, flush, clean=clean)

    cases = [(f"{name}_B{B}_S{S}", B, S, Hq, Hkv, hd, True)
             for name, Hq, Hkv, hd in (("G4", 32, 8, 128), ("G6", 48, 8, 128),
                                       ("hd96", 32, 32, 96))
             for B, S in ((8, 512), (1, 512), (1, 4096))]
    cases += [("G4nc_B8_S512", 8, 512, 32, 8, 128, False),
              ("G5_B8_S512", 8, 512, 40, 8, 128, True),
              ("G4_B2_S2048", 2, 2048, 32, 8, 128, True)]
    for key, B, S, Hq, Hkv, hd, causal in cases:
        q = rnd(B, S, Hq, hd).bfloat16()
        k, v = (rnd(B, S, Hkv, hd).bfloat16() for _ in range(2))
        out[key] = tm(lambda: flash_attention(q, k, v, causal=causal))
        if sdpa:
            out[f"{key}_sdpa"] = tm(lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, enable_gqa=Hq != Hkv))
    fit = {}
    for Sk in (64, 2048):
        q = rnd(1, 128, 32, 128).bfloat16()
        k, v = (rnd(1, Sk, 8, 128).bfloat16() for _ in range(2))
        fit[Sk] = tm(lambda: flash_attention(q, k, v, causal=False))
    per_tile = (fit[2048] - fit[64]) / 31
    out.update(flash_fit_fixed=fit[64] - per_tile, flash_fit_tile=per_tile)
    return out


def hd128_plans(dec_mod, rnd, flush):
    """The grouped-query decode at hd 128 (8 KV heads) at other plans than
    the wrapper's (``split_plan_tc``, or ``split_plan`` in a checkout
    without it): at buckets 8 (G 4 and 6) and 1 (G 6) over 544 keys
    and at batch 1 (G 6) over 4096 and 32768 keys, every ``n_split`` of 1,
    2, 3, 4, 6, 8 (one cluster, whole 32-key tiles), 16, 32 and 64 (the
    ticket combine) that cuts the cache into that many ranges
    (``plan_G*_B*_L*_{n_split}x{chunk}``), the plan swapped for a fixed
    one, which changes nothing but the ranges the wrapper passes."""
    out = {}
    planners = (dec_mod.split_plan, getattr(dec_mod, "split_plan_tc", None))
    try:
        for B, L, G in ((8, 544, 4), (8, 544, 6), (1, 544, 6), (1, 4096, 6),
                        (1, 32768, 6)):
            q = rnd(B, 8 * G, 128).bfloat16()
            k, v = rnd(B, L, 8, 128).bfloat16(), rnd(B, L, 8, 128).bfloat16()
            vlen = torch.full((B,), L, dtype=torch.int32, device=q.device)
            for n in (1, 2, 3, 4, 6, 8, 16, 32, 64):
                chunk = -(-L // n)
                if n <= 8:
                    chunk = -(-chunk // 32) * 32
                if -(-L // chunk) != n:
                    continue
                dec_mod.split_plan = dec_mod.split_plan_tc = \
                    lambda *_, p=(n, chunk): p
                out[f"plan_G{G}_B{B}_L{L}_{n}x{chunk}"] = time_ms(
                    lambda: dec_mod.decode_attention(q, k, v, vlen), flush)
    finally:
        dec_mod.split_plan = planners[0]
        if planners[1] is None:
            del dec_mod.split_plan_tc
        else:
            dec_mod.split_plan_tc = planners[1]
    return out


DECODE_CASES = ((8, 544), (4, 544), (2, 544), (1, 544), (1, 4096),
                (1, 32768))
# the decode wrapper's planners, each swapped for a fixed plan where a
# timing fixes it (a checkout may lack the later ones)
PLANNERS = ("split_plan", "split_plan_tc")


def restore(dec_mod, saved):
    """Put back the module attributes ``saved`` holds (None: absent)."""
    for n, f in saved.items():
        if f is None:
            if hasattr(dec_mod, n):
                delattr(dec_mod, n)
        else:
            setattr(dec_mod, n, f)


def decode_rows(dec_mod, rnd, flush, H, hd, plain=False):
    """The decode of ``H`` heads, G 1, at head dim ``hd`` at buckets 8, 4,
    2 and 1 over 544 keys and at batch 1 over 4096 and 32768 keys
    (``decode<hd>_B*_L*``), each beside SDPA and its bound, with its error
    against the plain version (absolute and as a share of the row's norm)
    and the plan the wrapper took; with ``plain`` also the plain version at
    bucket 8 (behind a 25 ms device sleep, as phase 4)."""
    F = torch.nn.functional
    decode_attention = dec_mod.decode_attention
    out = {}
    for B, L in DECODE_CASES:
        key = f"decode{hd}_B{B}_L{L}"
        q = rnd(B, H, hd).bfloat16()
        k, v = rnd(B, L, H, hd).bfloat16(), rnd(B, L, H, hd).bfloat16()
        vlen = torch.full((B,), L, dtype=torch.int32, device=q.device)
        got = decode_attention(q, k, v, vlen).float()
        want = dec_mod.decode_attention_plain(q, k, v, vlen).float()
        d = got - want
        out[f"{key}_err"] = d.abs().max().item()
        out[f"{key}_row_err"] = (d.norm(dim=-1)
                                 / want.norm(dim=-1)).max().item()
        out[f"{key}_ms"] = time_ms(lambda: decode_attention(q, k, v, vlen),
                                   flush)
        out[f"{key}_sdpa_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)), flush)
        if plain and B == 8:
            out[f"{key}_plain_ms"] = time_ms(
                lambda: dec_mod.decode_attention_plain(q, k, v, vlen), flush,
                sleep=50_000_000)
        out[f"{key}_bound_ms"] = bound_ms(
            4 * q.numel() + 2 * 2 * B * L * H * hd + 4 * B,
            4 * hd * H * B * L)
        if hasattr(dec_mod, "decode_plan"):
            out[f"{key}_plan"] = list(dec_mod.decode_plan(
                B, H, H, L, hd, torch.bfloat16,
                torch.cuda.get_device_properties(0).multi_processor_count))
    return out


def decode_fit(dec_mod, rnd, flush, H, hd):
    """The decode's one-CTA fit: ``H`` CTAs (batch 1, ``H`` heads), each one
    range of the cache (the plan fixed), over 1 and 32 tiles of 32 keys:
    the fixed cost of a CTA and the cost of each further 32 keys
    (``decode<hd>_fit_*``)."""
    saved = {n: getattr(dec_mod, n, None) for n in PLANNERS}
    fit = {}
    try:
        for L in (32, 1024):
            for n in PLANNERS:
                setattr(dec_mod, n, lambda *_, L=L: (1, L))
            q = rnd(1, H, hd).bfloat16()
            k, v = rnd(1, L, H, hd).bfloat16(), rnd(1, L, H, hd).bfloat16()
            vlen = torch.full((1,), L, dtype=torch.int32, device=q.device)
            fit[L] = time_ms(
                lambda: dec_mod.decode_attention(q, k, v, vlen), flush)
    finally:
        restore(dec_mod, saved)
    per_tile = (fit[1024] - fit[32]) / 31
    return {f"decode{hd}_fit_fixed_ms": fit[32] - per_tile,
            f"decode{hd}_fit_per_tile_ms": per_tile}


def hd64_times(flash_attention, flash_attention_plain, dec_mod, rnd,
               flush, ptxas):
    """Attention at hd 64 (minicpm-2b: 36 heads, G 1), beside SDPA and the
    bound: flash at buckets 8, 4, 2 and 1 over 512 tokens and at batch 1
    over 4096 (causal; ``flash64_B*``), whisper-tiny's encoder (1 x 1500, 6
    heads, not causal; ``flash64_whisper``), zamba2-1.2b's join (32 heads)
    at buckets 8 and 1 (``flash64_zamba2_B*``) and at hd 32 (16 heads,
    bucket 8; ``flash32_B8``); the decode at buckets 8, 4, 2 and 1 over 544
    keys and at batch 1 over 4096 and 32768 keys (``decode64_B*_L*``) with
    its error against the plain version (absolute and as a share of the
    row's norm) and the plan the wrapper took; the one-CTA fits: flash over
    36 q tiles of 128 rows, not causal, over 64 and 2048 keys (fixed cost
    and cost per 64 keys; SDPA's beside), the decode over 36 CTAs (batch 1,
    36 heads, one range each) over 1 and 32 tiles of 32 keys (fixed cost
    and cost per 32 keys); where hd 64 runs the persistent flash body, its
    cost per work tile (36 CTAs, the grid fixed, walking 1 and 8 work tiles
    of one 128-key K/V tile each; ``flash64_walk_*``); and the hd 64 and
    hd 32 instances' registers and spills from the compiler's reports
    (``*_ptxas``)."""
    F = torch.nn.functional
    out = {}
    for name, B, S, Hq, hd, causal in (
            ("flash64_B8", 8, 512, 36, 64, True),
            ("flash64_B4", 4, 512, 36, 64, True),
            ("flash64_B2", 2, 512, 36, 64, True),
            ("flash64_B1", 1, 512, 36, 64, True),
            ("flash64_B1_S4096", 1, 4096, 36, 64, True),
            ("flash64_whisper", 1, 1500, 6, 64, False),
            ("flash64_zamba2_B8", 8, 512, 32, 64, True),
            ("flash64_zamba2_B1", 1, 512, 32, 64, True),
            ("flash32_B8", 8, 512, 16, 32, True)):
        q, k, v = (rnd(B, S, Hq, hd).bfloat16() for _ in range(3))
        out[f"{name}_ms"] = time_ms(
            lambda: flash_attention(q, k, v, causal=causal), flush)
        out[f"{name}_sdpa_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal), flush)
        pairs = S * (S + 1) // 2 if causal else S * S
        out[f"{name}_bound_ms"] = bound_ms(4 * 2 * q.numel(),
                                           4 * hd * B * Hq * pairs)
        if name == "flash64_B8":
            out[f"{name}_err"] = (
                flash_attention(q, k, v, causal=True).float()
                - flash_attention_plain(q, k, v, causal=True).float()
            ).abs().max().item()
    fit = {}
    for Sk in (64, 2048):
        q = rnd(1, 128, 36, 64).bfloat16()
        k, v = (rnd(1, Sk, 36, 64).bfloat16() for _ in range(2))
        fit[Sk] = (time_ms(lambda: flash_attention(q, k, v, causal=False),
                           flush),
                   time_ms(lambda: F.scaled_dot_product_attention(
                       q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2)), flush))
    for i, who in enumerate(("", "_sdpa")):
        per_tile = (fit[2048][i] - fit[64][i]) / 31
        out[f"flash64_fit{who}_fixed_ms"] = fit[64][i] - per_tile
        out[f"flash64_fit{who}_per_tile_ms"] = per_tile
    # what a work tile costs on the persistent body: 36 CTAs (the grid
    # fixed) walking 1 and 8 work tiles each of one 128-key K/V tile (not
    # causal, 128 q rows over 128 keys)
    fa_mod = sys.modules[flash_attention.__module__]
    if getattr(fa_mod, "flash_body", lambda *_: "")(64, torch.bfloat16) \
            == "persistent":
        ctas, walk = fa_mod.flash_ctas, {}
        try:
            fa_mod.flash_ctas = lambda *_: 36
            for B in (1, 8):
                q, k, v = (rnd(B, 128, 36, 64).bfloat16() for _ in range(3))
                walk[B] = time_ms(
                    lambda: flash_attention(q, k, v, causal=False), flush)
        finally:
            fa_mod.flash_ctas = ctas
        per_work = (walk[8] - walk[1]) / 7
        out.update(flash64_walk_fixed_ms=walk[1] - per_work,
                   flash64_walk_per_work_tile_ms=per_work)
    out.update(decode_rows(dec_mod, rnd, flush, 36, 64))
    out.update(decode_fit(dec_mod, rnd, flush, 36, 64))
    for src, text in ptxas.items():
        regs, fn = {}, None
        for ln in text.splitlines():
            if "Function properties for" in ln:
                fn = ln.split("Function properties for")[1].strip()
            elif fn and ("Li64E" in fn or "Li32E" in fn) \
                    and "f32" not in fn and "IfLi" not in fn \
                    and ("Used " in ln or "spill" in ln):
                regs.setdefault(fn, []).append(ln.strip())
        out[f"{src}_ptxas"] = regs
    return out


def decode_plans(dec_mod, rnd, flush, H, hd, cases):
    """The decode of ``H`` heads, G 1, at head dim ``hd`` on each body the
    checkout's C launcher takes there (``decode_instance`` forced to
    ``cuda_cores`` and to ``tensor_cores``; a body it refuses is skipped)
    and at other splits of the cache than the wrapper's plan: at each (B, L)
    of ``cases`` every ``n_split`` of 1 to 8 (one cluster, whole 32-key
    tiles) that cuts the cache into that many ranges, and past 544 keys 16,
    32 and 64 (the ticket combine) too
    (``plan<hd>_<body>_B*_L*_{n_split}x{chunk}``)."""
    out = {}
    saved = {n: getattr(dec_mod, n, None)
             for n in (*PLANNERS, "decode_instance")}
    try:
        for inst in ("cuda_cores", "tensor_cores"):
            dec_mod.decode_instance = lambda *_, i=inst: i
            for B, L in cases:
                q = rnd(B, H, hd).bfloat16()
                k = rnd(B, L, H, hd).bfloat16()
                v = rnd(B, L, H, hd).bfloat16()
                vlen = torch.full((B,), L, dtype=torch.int32,
                                  device=q.device)
                for n in (1, 2, 3, 4, 5, 6, 7, 8, 16, 32, 64):
                    if n > 8 and L <= 544:
                        continue
                    chunk = -(-L // n)
                    if n <= 8:
                        chunk = -(-chunk // 32) * 32
                    if -(-L // chunk) != n:
                        continue
                    for name in PLANNERS:
                        setattr(dec_mod, name, lambda *_, p=(n, chunk): p)
                    key = f"plan{hd}_{inst}_B{B}_L{L}_{n}x{chunk}"
                    try:
                        out[key] = time_ms(
                            lambda: dec_mod.decode_attention(q, k, v, vlen),
                            flush)
                    except RuntimeError as e:
                        out[key] = f"refused: {e}"[:120]
                        break
    finally:
        restore(dec_mod, saved)
    return out


def hd64_plans(dec_mod, rnd, flush):
    """The decode at hd 64 (36 heads, G 1) on each body and at every split
    of 1 to 8 ranges at buckets 8 and 1 over 544 keys, and at
    batch 1 over 32768 keys those and 16, 32 and 64 (:func:`decode_plans`;
    ``plan64_<body>_B*_L*_{n_split}x{chunk}``)."""
    return decode_plans(dec_mod, rnd, flush, 36, 64,
                        ((8, 544), (1, 544), (1, 32768)))


def hd96_times(dec_mod, rnd, flush, ptxas):
    """phi-3's decode at hd 96 (phi3-mini and phi-3-vision: 32 heads over 32
    KV heads, G 1) at buckets 8, 4, 2 and 1 over 544 keys and at batch 1
    over 4096 and 32768 keys, each beside SDPA and its bound, with its error
    against the plain version, the plan the wrapper took and, at bucket 8,
    the plain version's time (``decode96_B*_L*``); its one-CTA fit (32
    CTAs, one range each; ``decode96_fit_*``); and the decode kernel's bf16
    hd 96 instances' registers and spills from the compiler's report
    (``decode_attention_ptxas``)."""
    out = decode_rows(dec_mod, rnd, flush, 32, 96, plain=True)
    out.update(decode_fit(dec_mod, rnd, flush, 32, 96))
    regs, fn = {}, None
    for ln in ptxas.splitlines():
        if "Function properties for" in ln:
            fn = ln.split("Function properties for")[1].strip()
        elif fn and "Li96E" in fn and "IfLi" not in fn \
                and ("Used " in ln or "spill" in ln):
            regs.setdefault(fn, []).append(ln.strip())
    out["decode_attention_ptxas"] = regs
    return out


def hd96_plans(dec_mod, rnd, flush):
    """phi-3's decode at hd 96 (32 heads, G 1) on each body and at every
    split of 1 to 8 ranges at buckets 8, 4, 2 and 1 over 544 keys and at
    batch 1 over 4096 and 32768 keys, and 16, 32 and 64 past 544 keys
    (:func:`decode_plans`; ``plan96_<body>_B*_L*_{n_split}x{chunk}``)."""
    return decode_plans(dec_mod, rnd, flush, 32, 96, DECODE_CASES)


def main(root: Path, tag: str, hd256: bool = False,
         hd128: bool = False, plans: bool = False, flash: bool = False,
         sdpa: bool = False, clean: bool = False, hd64: bool = False,
         plans64: bool = False, hd96: bool = False,
         plans96: bool = False) -> int:
    if not torch.cuda.is_available():
        print("time_kernels: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root.resolve() / "src"))
    dec_mod = importlib.import_module("repro_torch.kernels.decode_attention")
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    out = {"root": str(root), "tag": tag, "device": smi}

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    if plans:
        out.update(hd128_plans(dec_mod, rnd, flush))
        print(json.dumps(out), flush=True)
        return 0
    if plans64:
        out.update(hd64_plans(dec_mod, rnd, flush))
        print(json.dumps(out), flush=True)
        return 0
    if plans96:
        out.update(hd96_plans(dec_mod, rnd, flush))
        print(json.dumps(out), flush=True)
        return 0
    if hd96:
        from repro_torch.kernels import _build
        _build.build(("decode_attention",))
        out.update(hd96_times(dec_mod, rnd, flush,
                              _build.ptxas_log("decode_attention").read_text()))
        print(json.dumps(out), flush=True)
        return 0
    if hd64:
        from repro_torch.kernels import _build
        _build.build(("decode_attention", "flash_attention"))
        out.update(hd64_times(
            flash_attention, flash_attention_plain, dec_mod, rnd, flush,
            {src: _build.ptxas_log(src).read_text()
             for src in ("decode_attention", "flash_attention")}))
        print(json.dumps(out), flush=True)
        return 0
    if flash:
        out.update(flash_times(flash_attention, rnd, flush, sdpa, clean))
        print(json.dumps(out), flush=True)
        return 0
    if hd128:
        from repro_torch.kernels import _build
        # one launch each builds the decode and flash kernels, whose
        # compiler reports are read
        decode_attention(*(rnd(1, 8, 128).bfloat16(),
                           rnd(1, 16, 8, 128).bfloat16(),
                           rnd(1, 16, 8, 128).bfloat16()),
                         torch.full((1,), 16, dtype=torch.int32,
                                    device="cuda"))
        flash_attention(*(rnd(1, 16, 8, 128).bfloat16() for _ in range(3)))
        out.update(hd128_times(
            flash_attention, flash_attention_plain, decode_attention,
            decode_attention_plain, rnd, flush,
            {src: _build.ptxas_log(src).read_text()
             for src in ("decode_attention", "flash_attention")}))
        print(json.dumps(out), flush=True)
        return 0
    if hd256:
        out.update(hd256_times(flash_attention, dec_mod, rnd, flush))
        print(json.dumps(out), flush=True)
        return 0
    for B in (8, 1):
        q, k, v = (rnd(B, 512, 36, 64).bfloat16() for _ in range(3))
        out[f"flash_ms_bucket{B}"] = time_ms(
            lambda: flash_attention(q, k, v, causal=True), flush)
        qd = rnd(B, 36, 64).bfloat16()
        kd, vd = rnd(B, 544, 36, 64).bfloat16(), rnd(B, 544, 36, 64).bfloat16()
        vlen = torch.full((B,), 544, dtype=torch.int32, device="cuda")
        out[f"decode_ms_bucket{B}"] = time_ms(
            lambda: decode_attention(qd, kd, vd, vlen), flush)
        groups = getattr(dec_mod, "split_groups", None)
        if groups is not None:
            # every range of a (b, KV head) in one ticket group, then the
            # cluster combine again
            dec_mod.split_groups = lambda n_split, hd: n_split
            try:
                out[f"decode_ticket_ms_bucket{B}"] = time_ms(
                    lambda: decode_attention(qd, kd, vd, vlen), flush)
            finally:
                dec_mod.split_groups = groups
            out[f"decode_again_ms_bucket{B}"] = time_ms(
                lambda: decode_attention(qd, kd, vd, vlen), flush)
        x = rnd(B, 512, 32, 64).bfloat16()
        dt = torch.nn.functional.softplus(rnd(B, 512, 32)).bfloat16()
        A = -torch.exp(0.5 * rnd(32))
        Bm, Cm = rnd(B, 512, 128).bfloat16(), rnd(B, 512, 128).bfloat16()
        out[f"ssd_ms_bucket{B}"] = time_ms(
            lambda: ssd_scan(x, dt, A, Bm, Cm, chunk=64), flush)
        # the plain scan as phase 4 times it, then behind a sleep of about
        # 25 ms, which outlasts the host's enqueue of its launches, so that
        # the events hold the device's time alone
        host = []
        out[f"ssd_plain_ms_bucket{B}"] = time_ms(
            lambda: ssd_scan_plain(x, dt, A, Bm, Cm, chunk=64), flush)
        out[f"ssd_plain_device_ms_bucket{B}"] = time_ms(
            lambda: ssd_scan_plain(x, dt, A, Bm, Cm, chunk=64), flush,
            sleep=50_000_000, host=host)
        out[f"ssd_plain_host_ms_bucket{B}"] = host[0]
    fit = {}
    for Sk in (64, 2048):
        q1 = rnd(1, 128, 36, 64).bfloat16()
        k1, v1 = rnd(1, Sk, 36, 64).bfloat16(), rnd(1, Sk, 36, 64).bfloat16()
        fit[Sk] = time_ms(lambda: flash_attention(q1, k1, v1, causal=False),
                          flush)
    per_tile = (fit[2048] - fit[64]) / 31
    out.update(flash_fit_fixed_ms=fit[64] - per_tile,
               flash_fit_per_tile_ms=per_tile)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    flags = ("--hd256", "--hd128", "--hd128-plans", "--flash", "--sdpa",
             "--clean", "--hd64", "--hd64-plans", "--hd96", "--hd96-plans")
    args = [a for a in sys.argv[1:] if a not in flags]
    if len(args) not in (1, 2):
        sys.exit(__doc__)
    sys.exit(main(Path(args[0]), args[1] if len(args) == 2 else "",
                  hd256="--hd256" in sys.argv[1:],
                  hd128="--hd128" in sys.argv[1:],
                  plans="--hd128-plans" in sys.argv[1:],
                  flash="--flash" in sys.argv[1:],
                  sdpa="--sdpa" in sys.argv[1:],
                  clean="--clean" in sys.argv[1:],
                  hd64="--hd64" in sys.argv[1:],
                  plans64="--hd64-plans" in sys.argv[1:],
                  hd96="--hd96" in sys.argv[1:],
                  plans96="--hd96-plans" in sys.argv[1:]))
