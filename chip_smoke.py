#!/usr/bin/env python3
"""On-chip smoke test of the PyTorch port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/csrc``, holds
each against its plain PyTorch version on the card, checks that the bf16
flash-attention and SSD kernels run on the tensor cores (HGMMA in their
SASS), times them at the main paths' shapes (every kernel at buckets 8 and
1, the attention kernels beside SDPA, the SSD scan at every split of its
chunks), and then, for each of the two main paths (the dense decoder
minicpm-2b with the two attention kernels, the Mamba2 decoder mamba2-370m
with the SSD scan): checks the model at full width (two layers) on the card
against the same weights on the CPU, serves 16 full-width, full-depth
requests through continuous batching, asserting that every decoder layer's
hot spot went through its kernel, and profiles one full-bucket join and
decode step to show how much of their time the card is busy.  Any failed
phase raises and the script exits non-zero.  The
second-to-last line of output is a JSON object ``{"kernels": [...]}``
(times, bounds, launches); the last line is ``{"ok": true, "device":
{...}}``.  A full report is written to
``build/chip_smoke.json`` (``.gitignore`` lists ``build/``).

It exits non-zero, printing no result, where CUDA is not available.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and bf16 flop/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

# Kernel vs plain tolerances (|kernel - plain| <= tol + tol * |plain|).
# bf16: inputs and outputs round to 8 bits of mantissa, as in
# tests/test_kernels.py.  f32: both sides compute in float32 and differ only
# in summation order (tiled online softmax and fused multiply-adds against
# one softmax over the whole row), well inside the repo's f32 kernel bound.
TOL = {"bfloat16": 2e-2, "float32": 3e-5}
# ssd_scan, (y, final state), as tests/test_kernels.py: its sums run over a
# whole chunk and, through the carried state, the whole sequence
SSD_TOL = {"bfloat16": (6e-2, 1e-2), "float32": (1e-4, 1e-4)}

# (B, Sq, Sk, Hq, Hkv, hd, causal, window): tests/test_kernels.py FA_CASES,
# then the minicpm-2b prefill shape and the other head dims the kernel takes
FA_CASES = [
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 256, 256, 4, 1, 128, True, 0),
    (2, 64, 192, 4, 4, 64, True, 0),
    (1, 256, 256, 8, 2, 64, True, 64),
    (1, 96, 96, 2, 2, 32, False, 0),
    (2, 100, 228, 6, 3, 64, True, 100),
    (2, 1, 128, 4, 2, 64, True, 0),
    (1, 64, 64, 4, 2, 64, True, 128),
    (2, 1, 96, 6, 3, 64, True, 32),
    (1, 17, 17, 2, 1, 32, True, 8),
    (8, 512, 512, 36, 36, 64, True, 0),
    (2, 80, 80, 4, 4, 72, True, 0),
    (1, 130, 130, 4, 2, 96, False, 0),
    (2, 200, 200, 8, 2, 128, True, 64),
    (1, 512, 512, 36, 36, 64, True, 0),     # the minicpm-2b join, bucket 1
    (3, 1, 200, 8, 2, 64, True, 0),
    (2, 70, 300, 4, 4, 64, True, 0),
    (1, 256, 256, 4, 2, 64, True, 16),      # a window inside one tile
    (2, 77, 77, 4, 4, 64, False, 0),
]
# (B, L, Hq, Hkv, hd, zero_row): tests/test_kernels.py DEC_CASES (block
# sizes dropped), the minicpm-2b decode shape at buckets 8 and 1 (the most
# splits), other head dims and groups, and rows with valid_len = 0
DEC_CASES = [
    (2, 512, 8, 2, 64, False),
    (1, 1000, 4, 4, 128, False),
    (3, 256, 4, 1, 32, False),
    (2, 300, 6, 3, 64, False),
    (2, 33, 4, 2, 64, False),
    (1, 64, 1, 1, 32, False),
    (8, 544, 36, 36, 64, False),
    (2, 100, 4, 4, 72, False),
    (3, 200, 8, 2, 96, False),
    (4, 128, 8, 8, 64, True),
    (1, 544, 36, 36, 64, False),
    (4, 544, 16, 4, 64, True),
    (2, 1000, 32, 4, 128, False),
    (2, 130, 64, 8, 32, True),
]
# (B, S, H, P, N, chunk, init_state): tests/test_kernels.py SSD_CASES, its
# init-state case, S no multiple of the chunk (130 is the model-parity
# prompt below), the mamba2-370m serving join at buckets 8 and 1, and a
# ragged S of more than 8 chunks with an initial state (several chunks a
# CTA)
SSD_CASES = [
    (2, 128, 4, 64, 32, 64, False),
    (1, 64, 2, 32, 16, 16, False),
    (2, 256, 3, 64, 64, 64, False),
    (1, 192, 2, 32, 128, 64, False),
    (2, 128, 2, 32, 16, 64, True),
    (2, 130, 32, 64, 128, 64, False),
    (1, 100, 2, 32, 32, 16, True),
    (8, 512, 32, 64, 128, 64, False),
    (1, 512, 32, 64, 128, 64, False),
    (2, 1100, 4, 64, 128, 64, True),
]


def log(*a) -> None:
    print(*a, flush=True)


def device_profile(call, runs: int) -> dict:
    """Run ``call`` ``runs`` times under ``torch.profiler`` and return, per
    run, the host milliseconds (profiler on), the kernel launch calls, the
    milliseconds the card was busy (the union of every device-side event's
    interval), the five
    kernels that took the most device time and the eight host ops that
    took the most host time of their own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        host_s = sum(call() for _ in range(runs))
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us, end = 0.0, None
    for s, t in sorted(spans):
        if end is None or s > end:
            busy_us += t - s
            end = t
        elif t > end:
            busy_us += t - end
            end = t
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    # cudaLaunchKernel, and cudaLaunchKernelExC for a cluster launch
    launches = sum(a.count for a in host
                   if a.key.startswith("cudaLaunchKernel")) / runs
    return {"host_ms": host_s * 1e3 / runs, "launch_calls": launches,
            "device_busy_ms": busy_us / 1e3 / runs,
            "top": [(n, us / 1e3 / runs) for n, us in top],
            "top_host": [(a.key, a.count // runs,
                          a.self_cpu_time_total / 1e3 / runs)
                         for a in host[:8]]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    ssd_mod = sys.modules["repro_torch.kernels.ssd_scan"]
    from repro_torch.launch.serve import serve
    from repro_torch.models import (decode_step_ragged, init_cache,
                                    init_params, prefill)
    from repro_torch.serving import ContinuousTorchExecutor, ServedModel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    report = {}

    # -- 1. device ------------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"[device] {name}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; count {torch.cuda.device_count()}")
    log(smi)
    report["device"] = {"name": name, "nvidia_smi": smi}

    # -- 2. build ---------------------------------------------------------------
    build_s = _build.build()
    log(f"[build] {len(_build.SOURCES)} kernels built in {build_s:.1f} s "
        f"into {_build.BUILD_DIR}")
    for src in _build.SOURCES:
        regs = [ln.split("Used ")[1].split(",")[0]
                for ln in _build.ptxas_log(src).read_text().splitlines()
                if "Used " in ln]
        spills = sum("0 bytes spill stores" not in ln
                     for ln in _build.ptxas_log(src).read_text().splitlines()
                     if "spill stores" in ln)
        log(f"[build] {src}: {len(regs)} instantiations, ptxas: "
            f"{sorted(set(regs))}, {spills} with spills")
    report["build_s"] = build_s
    # the bf16 flash and SSD kernels must run their products on the tensor
    # cores
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    report["hgmma"] = {}
    for src, kern in (("flash_attention", "fa_kernel_wgmma"),
                      ("ssd_scan", "ssd_kernel_wgmma")):
        sass = subprocess.run(
            [cuobjdump, "-sass", str(_build.library_path(src))],
            capture_output=True, text=True, check=True).stdout
        hgmma, fn = {}, None
        for ln in sass.splitlines():
            if "Function :" in ln:
                fn = ln.split("Function :")[1].strip()
            elif fn and kern in fn and "HGMMA" in ln:
                hgmma[fn] = hgmma.get(fn, 0) + 1
        log(f"[build] {src} bf16: {sum(hgmma.values())} HGMMA instructions "
            f"in {len(hgmma)} kernels (cuobjdump -sass)")
        if not hgmma:
            raise AssertionError(f"the bf16 {src} kernels hold no HGMMA "
                                 f"instruction")
        report["hgmma"][src] = hgmma

    # -- 3. kernel vs plain on the card ----------------------------------------
    F = torch.nn.functional
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rnd(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def check(tag, out, ref, dtype_name, tol=None):
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        tol = TOL[dtype_name] if tol is None else tol
        bad = (err > tol + tol * ref.float().abs()).sum().item()
        log(f"[parity] {tag} {dtype_name}: max_abs_err {err.max().item():.3g}"
            f" at max |plain| {ref.float().abs().max().item():.3g} (tol "
            f"{tol} + {tol} * |plain|)")
        if bad:
            raise AssertionError(f"{tag} {dtype_name}: {bad} elements "
                                 f"outside tolerance")
        return err.max().item()

    errs = {"flash_attention": {}, "decode_attention": {}, "ssd_scan": {}}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        for c in FA_CASES:
            B, Sq, Sk, Hq, Hkv, hd, causal, w = c
            q, k, v = (rnd(B, Sq, Hq, hd, dtype=dtype),
                       rnd(B, Sk, Hkv, hd, dtype=dtype),
                       rnd(B, Sk, Hkv, hd, dtype=dtype))
            errs["flash_attention"][(c, dn)] = check(
                f"flash_attention {c}",
                flash_attention(q, k, v, causal=causal, window=w),
                flash_attention_plain(q, k, v, causal=causal, window=w), dn)
        for c in DEC_CASES:
            B, L, Hq, Hkv, hd, zero_row = c
            q, k, v = (rnd(B, Hq, hd, dtype=dtype),
                       rnd(B, L, Hkv, hd, dtype=dtype),
                       rnd(B, L, Hkv, hd, dtype=dtype))
            vlen = torch.randint(1, L + 1, (B,), generator=gen, device=dev,
                                 dtype=torch.int32)
            if zero_row:
                vlen[0] = 0
            out = decode_attention(q, k, v, vlen)
            errs["decode_attention"][(c, dn)] = check(
                f"decode_attention {c} valid_len {vlen.tolist()}", out,
                decode_attention_plain(q, k, v, vlen), dn)
            if zero_row and out[0].abs().max().item() != 0.0:
                raise AssertionError("valid_len = 0 must give zeros")
        for c in SSD_CASES:
            B, S, H, P, N, Q, init = c
            x = rnd(B, S, H, P, dtype=dtype)
            dt = F.softplus(rnd(B, S, H, dtype=torch.float32)).to(dtype)
            A = -torch.exp(0.5 * rnd(H, dtype=torch.float32))
            Bm, Cm = rnd(B, S, N, dtype=dtype), rnd(B, S, N, dtype=dtype)
            s0 = rnd(B, H, P, N, dtype=torch.float32) if init else None
            y, st = ssd_scan(x, dt, A, Bm, Cm, chunk=Q, init_state=s0)
            yp, sp = ssd_scan_plain(x, dt, A, Bm, Cm, chunk=Q,
                                    init_state=s0)
            ty, ts = SSD_TOL[dn]
            errs["ssd_scan"][(c, dn)] = check(f"ssd_scan y {c}", y, yp, dn,
                                              ty)
            check(f"ssd_scan state {c}", st, sp, dn, ts)
    # the last cases' tensors would otherwise count in the serves' peaks
    del q, k, v, out, x, dt, Bm, Cm, s0, y, st, yp, sp

    # -- 4. kernel timing at the main path's shapes (bf16) ---------------------
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def time_ms(fn, runs=25, warmup=3):
        """Median of ``runs`` CUDA-event timings, L2 flushed before each
        (the serving path meets every layer's tensors cold).  A device-side
        sleep of about half a millisecond after the flush keeps the card busy
        while the host enqueues ``fn``, so the interval between the events
        holds the device's time for ``fn`` and not the host's time to reach
        its launch."""
        for _ in range(warmup):
            fn()
        ts = []
        for _ in range(runs):
            flush.zero_()
            torch.cuda._sleep(1_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return sorted(ts)[len(ts) // 2]

    bf = torch.bfloat16

    def bound(nbytes, flops):
        b_ms, f_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
        return {"bound_ms": max(b_ms, f_ms),
                "bound_by": "bytes" if b_ms >= f_ms else "operations"}

    def time_fa(B, plain=True, S=512, H=36, hd=64):
        """The minicpm-2b join's attention at bucket B: kernel, plain
        version and SDPA in turn, on the same inputs."""
        q, k, v = (rnd(B, S, H, hd, dtype=bf) for _ in range(3))
        t = {"ms": time_ms(lambda: flash_attention(q, k, v, causal=True)),
             "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                 q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                 is_causal=True))}
        if plain:
            t["plain_ms"] = time_ms(lambda: flash_attention_plain(
                q, k, v, causal=True))
        # q, k, v read once and o (q's shape) written once; causal pairs
        t.update(bound((2 * q.numel() + k.numel() + v.numel())
                       * q.element_size(),
                       4 * hd * B * H * S * (S + 1) // 2))
        return t

    def time_dec(B, plain=True, L=544, H=36, hd=64):
        """The minicpm-2b step's attention at bucket B, every row at
        valid_len L."""
        qd = rnd(B, H, hd, dtype=bf)
        kd, vd = rnd(B, L, H, hd, dtype=bf), rnd(B, L, H, hd, dtype=bf)
        vlen = torch.full((B,), L, dtype=torch.int32, device=dev)
        t = {"ms": time_ms(lambda: decode_attention(qd, kd, vd, vlen)),
             "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                 qd[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2)))}
        if plain:
            t["plain_ms"] = time_ms(lambda: decode_attention_plain(
                qd, kd, vd, vlen))
        live = int(vlen.sum().item())
        t.update(bound(2 * qd.numel() * qd.element_size()
                       + 2 * live * H * hd * kd.element_size()
                       + vlen.numel() * 4, 4 * hd * H * live))
        return t

    fa, dec = time_fa(8), time_dec(8)
    fa1, dec1 = time_fa(1, plain=False), time_dec(1, plain=False)
    for nm, t in (("flash_attention (1,512,512,36,36,64) causal", fa1),
                  ("decode_attention (1,544,36,36,64) valid_len 544", dec1)):
        log(f"[timing] {nm}: kernel {t['ms']:.4f} ms, library "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms'] * 1e3:.2f} us "
            f"({t['bound_by']}); {smi}")
    for t, t1 in ((fa, fa1), (dec, dec1)):
        t.update(ms_bucket1=t1["ms"], library_ms_bucket1=t1["library_ms"],
                 bound_ms_bucket1=t1["bound_ms"])

    # What one CTA pays: 36 q tiles of 128 rows (one CTA per SM), not
    # causal, over 1 and 32 K/V tiles of 64 keys; the fit gives the fixed
    # cost of a CTA and the cost of each further tile, beside SDPA's.
    fit = {}
    for Sk in (64, 2048):
        q1 = rnd(1, 128, 36, 64, dtype=bf)
        k1, v1 = rnd(1, Sk, 36, 64, dtype=bf), rnd(1, Sk, 36, 64, dtype=bf)
        fit[Sk] = (time_ms(lambda: flash_attention(q1, k1, v1, causal=False)),
                   time_ms(lambda: F.scaled_dot_product_attention(
                       q1.transpose(1, 2), k1.transpose(1, 2),
                       v1.transpose(1, 2))))
    per_tile = [(fit[2048][i] - fit[64][i]) / 31 for i in (0, 1)]
    report["flash_cta_fit"] = {"fixed_ms": [fit[64][0] - per_tile[0],
                                            fit[64][1] - per_tile[1]],
                               "per_tile_ms": per_tile}
    log(f"[timing] flash_attention, one CTA per SM: fixed "
        f"{fit[64][0] - per_tile[0]:.4f} ms + {per_tile[0]:.5f} ms per "
        f"64-key tile; SDPA {fit[64][1] - per_tile[1]:.4f} ms + "
        f"{per_tile[1]:.5f} ms; {smi}")

    def time_ssd(B, plain=True, S=512, H=32, P=64, N=128, Q=64):
        """The mamba2-370m join's SSD scan at bucket B; then the kernel at
        every split of the chunks that the plan could take, on the same
        inputs (the plan swapped for a fixed one, which changes nothing but
        R and the run length the wrapper passes)."""
        x = rnd(B, S, H, P, dtype=bf)
        dt = F.softplus(rnd(B, S, H, dtype=torch.float32)).to(bf)
        A = -torch.exp(0.5 * rnd(H, dtype=torch.float32))
        Bm, Cm = rnd(B, S, N, dtype=bf), rnd(B, S, N, dtype=bf)
        t = {"ms": time_ms(lambda: ssd_scan(x, dt, A, Bm, Cm, chunk=Q)),
             "library_ms": None,     # no single PyTorch call computes it
             "plan": ssd_mod.ssd_plan(B, H, S, ssd_mod.KERNEL_CHUNK,
                                      torch.cuda.get_device_properties(
                                          0).multi_processor_count)}
        if plain:
            t["plain_ms"] = time_ms(lambda: ssd_scan_plain(x, dt, A, Bm, Cm,
                                                           chunk=Q))
        planner, n_chunks = ssd_mod.ssd_plan, S // ssd_mod.KERNEL_CHUNK
        t["splits_ms"] = {}
        try:
            for per in sorted({-(-n_chunks // r) for r in range(1, 9)}):
                R = -(-n_chunks // per)
                ssd_mod.ssd_plan = lambda *_, R=R, per=per: (R, per)
                t["splits_ms"][f"{R}x{per}"] = time_ms(
                    lambda: ssd_scan(x, dt, A, Bm, Cm, chunk=Q))
        finally:
            ssd_mod.ssd_plan = planner
        # x, dt, A, B, C read once; y (x's shape) and the f32 state written
        # once; per (b, h, chunk): C.B^T, its product with x dt, C.state^T,
        # the state update
        t.update(bound(
            (2 * x.numel() + dt.numel() + Bm.numel() + Cm.numel())
            * x.element_size() + A.numel() * 4 + B * H * P * N * 4,
            B * H * (S // Q) * (2 * Q * Q * N + 2 * Q * Q * P + 2 * Q * N * P
                                + 2 * P * N * Q)))
        return t

    ssd, ssd1 = time_ssd(8), time_ssd(1)
    ssd.update(ms_bucket1=ssd1["ms"], plain_ms_bucket1=ssd1["plain_ms"],
               bound_ms_bucket1=ssd1["bound_ms"])
    for b, t in ((8, ssd), (1, ssd1)):
        log(f"[timing] ssd_scan ({b},512,32,64) N 128: plan {t['plan']} "
            f"(ranks, chunks each) {t['ms']:.4f} ms; every split: "
            + ", ".join(f"{k} {v:.4f}" for k, v in t["splits_ms"].items())
            + f" ms; {smi}")
    report["ssd_splits_ms"] = {8: ssd["splits_ms"], 1: ssd1["splits_ms"]}
    # What one CTA pays: one CTA per (b, h) (the plan fixed to one rank),
    # 32 of them, over 1 and 16 chunks; the fit gives the fixed cost of a
    # CTA and the cost of each further chunk
    fit, planner = {}, ssd_mod.ssd_plan
    try:
        ssd_mod.ssd_plan = lambda B, H, S, chunk, sms: (1, -(-S // chunk))
        for S_fit in (64, 1024):
            x1 = rnd(1, S_fit, 32, 64, dtype=bf)
            dt1 = F.softplus(rnd(1, S_fit, 32, dtype=torch.float32)).to(bf)
            A1 = -torch.exp(0.5 * rnd(32, dtype=torch.float32))
            B1, C1 = rnd(1, S_fit, 128, dtype=bf), rnd(1, S_fit, 128, dtype=bf)
            fit[S_fit] = time_ms(lambda: ssd_scan(x1, dt1, A1, B1, C1,
                                                  chunk=64))
    finally:
        ssd_mod.ssd_plan = planner
    per_chunk = (fit[1024] - fit[64]) / 15
    report["ssd_cta_fit"] = {"fixed_ms": fit[64] - per_chunk,
                             "per_chunk_ms": per_chunk}
    log(f"[timing] ssd_scan, one CTA per (b, h), 32 CTAs: fixed "
        f"{fit[64] - per_chunk:.4f} ms + {per_chunk:.5f} ms per 64-row "
        f"chunk; {smi}")
    del flush
    for nm, t in (("flash_attention (8,512,512,36,36,64) causal", fa),
                  ("decode_attention (8,544,36,36,64) valid_len 544", dec),
                  ("ssd_scan (8,512,32,64) N 128 Q 64", ssd),
                  ("ssd_scan (1,512,32,64) N 128 Q 64", ssd1)):
        lib = ("none" if t["library_ms"] is None
               else f"{t['library_ms']:.4f} ms")
        log(f"[timing] {nm}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, library {lib}, bound "
            f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}); {smi}")
    for nm, t in (("flash_attention", fa), ("decode_attention", dec)):
        log(f"[timing] {nm}: kernel / library "
            + ", ".join(f"bucket {b} {t[m] / t[lm]:.2f}x, bound share "
                        f"{t[bm] / t[m]:.2f}"
                        for b, m, lm, bm in (
                            (8, "ms", "library_ms", "bound_ms"),
                            (1, "ms_bucket1", "library_ms_bucket1",
                             "bound_ms_bucket1"))))

    # The two main paths: the model, its parity prompt length (130 is no
    # multiple of mamba2's chunk of 64, so the SSD padding runs on the
    # card), and where each hot spot of its layers launches: once per layer
    # in every join ("join") or in every decode step ("step").
    paths = (("minicpm-2b", 128, {"attention": "join",
                                  "decode_attention": "step"}),
             ("mamba2-370m", 130, {"ssd": "join"}))
    report["model_parity"], report["serve"], report["profile"] = {}, {}, {}
    path_launches = {}
    for model, S_par, where in paths:
        # -- 5. model parity at full width: card (kernels) vs CPU (plain) -----
        cfg2 = get_config(model).with_(n_layers=2)
        p_cpu = init_params(cfg2, seed=0, device="cpu")
        p_gpu = {"embed": p_cpu["embed"].to(dev),
                 "final_norm": p_cpu["final_norm"].to(dev),
                 "groups": [{n: t.to(dev) for n, t in g.items()}
                            for g in p_cpu["groups"]]}
        rng = torch.Generator().manual_seed(1)
        toks = torch.randint(0, cfg2.vocab_size, (2, S_par), generator=rng)
        caches = {"cpu": init_cache(cfg2, 2, S_par + 8, "cpu"),
                  "cuda": init_cache(cfg2, 2, S_par + 8, dev)}
        params = {"cpu": p_cpu, "cuda": p_gpu}
        lg = {d: prefill(cfg2, params[d], toks.to(d),
                         caches[d])[0].float().cpu()
              for d in ("cpu", "cuda")}
        worst, agree, n_tok = 0.0, 0, 0
        # rows at other depths
        t = torch.tensor([S_par, S_par - 8], dtype=torch.int32)
        for step in range(5):
            if step:
                lg = {d: decode_step_ragged(cfg2, params[d], caches[d],
                                            tok.to(d),
                                            t.to(d))[0].float().cpu()
                      for d in ("cpu", "cuda")}
                t = t + 1
            rel = ((lg["cuda"] - lg["cpu"]).abs().max()
                   / lg["cpu"].abs().max()).item()
            worst = max(worst, rel)
            tok = lg["cpu"].argmax(-1)                     # teacher-forced
            agree += int((lg["cuda"].argmax(-1) == tok).sum())
            n_tok += tok.numel()
            if not torch.isfinite(lg["cuda"]).all():
                raise AssertionError(f"{model}: non-finite logits on the "
                                     f"card")
        log(f"[model] {model} full width, 2 layers, prefill B=2 S={S_par} + "
            f"4 ragged steps: max |logit diff| / max |logit| = {worst:.3g} "
            f"(bound 2e-2); greedy agreement {agree}/{n_tok}")
        if worst > 2e-2:
            raise AssertionError(f"{model}: card vs CPU logits differ by "
                                 f"{worst:.3g}")
        report["model_parity"][model] = {"max_rel_logit_diff": worst,
                                         "greedy_agree": [agree, n_tok]}
        del p_cpu, p_gpu, params, caches
        torch.cuda.empty_cache()

        # -- 6. serve: full-width, full-depth -----------------------------------
        cfg = get_config(model)
        kops.reset_launch_counts()
        rep = serve(cfg, n_requests=16, rps=None, prompt_len=512,
                    gen_len=32, max_batch=8, device=dev, seed=0)
        total = kops.launch_counts()
        path_launches[model] = total
        bc = rep["batcher"]
        n_buckets = len(rep["bucket_admit_ms"])
        log(f"[serve] {model}: {rep['completed']}/{rep['n_requests']} "
            f"requests, {bc['n_prefill_batches']} prefill batches, "
            f"{bc['n_decode_ticks']} decode ticks, mean occupancy "
            f"{rep['mean_decode_occupancy']:.2f}, rps {rep['rps']:.3f}")
        log(f"[serve] {model}: latency p50 {rep['latency_p50_s'] * 1e3:.1f} "
            f"ms, p99 {rep['latency_p99_s'] * 1e3:.1f} ms; time to first "
            f"token p50 {rep['ttft_p50_s'] * 1e3:.1f} ms, p99 "
            f"{rep['ttft_p99_s'] * 1e3:.1f} ms; token gap p50 "
            f"{rep['token_gap_p50_s'] * 1e3:.2f} ms, p99 "
            f"{rep['token_gap_p99_s'] * 1e3:.2f} ms; "
            f"{rep['tokens_per_s']:.1f} tokens/s; max memory "
            f"{rep['max_memory_allocated'] / 2**30:.2f} GiB; {smi}")
        for b in rep["bucket_admit_ms"]:
            log(f"[serve] {model} bucket {b}: admit "
                f"{rep['bucket_admit_ms'][b]:.2f} ms, step "
                f"{rep['bucket_step_ms'][b]:.2f} ms")
        log(f"[serve] {model}: launches in the serving loop "
            f"{rep['kernel_launches']}; in all of serve() {total} (setup "
            f"runs every bucket once, then calibration)")
        if rep["completed"] != 16:
            raise AssertionError(f"{model}: {rep['completed']}/16 requests "
                                 f"completed")
        for toks_i in rep["tokens"]:
            if len(toks_i) != 33 or not all(0 <= x < cfg.vocab_padded
                                            for x in toks_i):
                raise AssertionError(f"{model}: bad generation {toks_i}")
        if not rep["logits_finite"]:
            raise AssertionError(f"{model}: non-finite logits while serving")
        nl = cfg.n_layers
        ex = rep["executor"]
        loop_runs = {"join": bc["n_prefill_batches"],
                     "step": bc["n_decode_ticks"]}
        all_runs = {"join": ex["n_admits"] + n_buckets,
                    "step": ex["n_steps"] + n_buckets}
        want_loop = {op: nl * loop_runs[where[op]] if op in where else 0
                     for op in kops.KERNEL_TABLE}
        want_total = {op: nl * all_runs[where[op]] if op in where else 0
                      for op in kops.KERNEL_TABLE}
        if rep["kernel_launches"] != want_loop or total != want_total:
            raise AssertionError(f"{model}: kernel launches "
                                 f"{rep['kernel_launches']} / {total}, "
                                 f"expected {want_loop} / {want_total}")
        if rep["mean_decode_occupancy"] <= 2:
            raise AssertionError(f"{model}: mean decode occupancy not "
                                 f"above 2")
        report["serve"][model] = rep

        # -- 7. where the time of a full-bucket join and step goes -------------
        # On one executor: the median wall time of five calls without the
        # profiler (each ends in a sync), then three calls under it; the
        # idle share divides the second's device-busy time by the first.
        ex = ContinuousTorchExecutor(
            {"generate": ServedModel(cfg, prompt_len=512, gen_len=32)},
            max_batch=8, device=dev, seed=0)
        slots = list(range(8))
        report["profile"][model] = {}
        for what, call in (
                ("join", lambda: ex._admit_seeded("generate", slots, slots)),
                ("step", lambda: ex.step("generate", slots))):
            wall_ms = sorted(call() for _ in range(5))[2] * 1e3
            prof = device_profile(call, runs=3)
            idle = (1 - prof["device_busy_ms"] / wall_ms
                    if prof["device_busy_ms"] else None)
            prof.update(unprofiled_ms=wall_ms, idle_share=idle)
            report["profile"][model][what] = prof
            log(f"[profile] {model} bucket-8 {what}: device busy "
                f"{prof['device_busy_ms']:.2f} ms of {wall_ms:.2f} ms "
                f"measured without the profiler (idle share "
                f"{'not measured' if idle is None else f'{idle:.2f}'}); "
                f"{prof['host_ms']:.2f} ms with it; "
                f"{prof['launch_calls']:.0f} kernel launch calls; top "
                f"kernels (ms): "
                + ", ".join(f"{n[:40]} {t:.2f}" for n, t in prof["top"]))
            log(f"[profile] {model} bucket-8 {what}: top host ops (calls, "
                f"self ms): "
                + ", ".join(f"{n[:40]} {c} {t:.2f}"
                            for n, c, t in prof["top_host"]))
        del ex
        torch.cuda.empty_cache()

    # -- result -------------------------------------------------------------------
    # each kernel: its launches over all of serve() on its own path, and the
    # error and times at its serving shape
    kernels = []
    for kname, tm, op, model, case, src, tpu, pr, design in (
            ("flash_attention", fa, "attention", "minicpm-2b",
             (8, 512, 512, 36, 36, 64, True, 0),
             "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:98", 13,
             "bf16: wgmma for both products, TMA loads and store, "
             "heaviest q tiles first; f32: CUDA cores"),
            ("decode_attention", dec, "decode_attention", "minicpm-2b",
             (8, 544, 36, 36, 64, False),
             "src/repro_torch/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention.py:69", 13,
             "split over the cache, one cluster per (b, KV head), "
             "combine through distributed shared memory, cp.async ring"),
            ("ssd_scan", ssd, "ssd", "mamba2-370m",
             (8, 512, 32, 64, 128, 64, False),
             "src/repro_torch/csrc/ssd_scan.cu",
             "src/repro/kernels/ssd_scan.py:77", 14,
             "bf16: chunks split over a cluster per (b, head), carried "
             "state through distributed shared memory, all four products "
             "on wgmma with hi + lo bf16 operands, TMA loads and store; "
             "f32: CUDA cores")):
        kernels.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": tpu, "pr": pr, "design": design,
                        "launches": path_launches[model][op],
                        "max_abs_err": errs[kname][(case, "bfloat16")],
                        "ms": tm["ms"], "plain_ms": tm["plain_ms"],
                        "bound_ms": tm["bound_ms"],
                        "bound_by": tm["bound_by"],
                        "library_ms": tm["library_ms"],
                        **{key: tm[key] for key in (
                            "ms_bucket1", "library_ms_bucket1",
                            "plain_ms_bucket1", "bound_ms_bucket1")
                           if key in tm}})
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1,
                                                    default=str))
    log(f"[done] {report['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
