"""Time the port's three CUDA kernels of a checkout on the card.

    python3 tools/time_kernels.py ROOT [TAG]

imports ``repro_torch`` from ``ROOT/src`` (building its kernels into
``ROOT/build``) and times, bf16, at the serving shapes that
``chip_smoke.py`` phase 4 uses: ``flash_attention`` (minicpm-2b's join,
S 512, 36 heads, hd 64, causal) and ``decode_attention`` (its step, L 544)
at buckets 8 and 1, ``ssd_scan`` (mamba2-370m's join, S 512, 32 heads,
P 64, N 128, chunk 64) at buckets 8 and 1, and flash's one-CTA fit (36
q tiles of 128 rows, not causal, over 64 and 2048 keys: the fixed cost
of a CTA and the cost of each further 64-key tile).  Each time is the
median of 25 CUDA-event timings, L2 flushed, a device-side sleep ahead of
each.  It prints one JSON line.  Run it on several checkouts in turns
(A, B, B, A) in one call to compare them on one card.
"""
import json
import subprocess
import sys
from pathlib import Path

import torch


def time_ms(fn, flush, runs=25, warmup=3):
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


def main(root: Path, tag: str) -> int:
    if not torch.cuda.is_available():
        print("time_kernels: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root.resolve() / "src"))
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    out = {"root": str(root), "tag": tag, "device": smi}

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    for B in (8, 1):
        q, k, v = (rnd(B, 512, 36, 64).bfloat16() for _ in range(3))
        out[f"flash_ms_bucket{B}"] = time_ms(
            lambda: flash_attention(q, k, v, causal=True), flush)
        qd = rnd(B, 36, 64).bfloat16()
        kd, vd = rnd(B, 544, 36, 64).bfloat16(), rnd(B, 544, 36, 64).bfloat16()
        vlen = torch.full((B,), 544, dtype=torch.int32, device="cuda")
        out[f"decode_ms_bucket{B}"] = time_ms(
            lambda: decode_attention(qd, kd, vd, vlen), flush)
        x = rnd(B, 512, 32, 64).bfloat16()
        dt = torch.nn.functional.softplus(rnd(B, 512, 32)).bfloat16()
        A = -torch.exp(0.5 * rnd(32))
        Bm, Cm = rnd(B, 512, 128).bfloat16(), rnd(B, 512, 128).bfloat16()
        out[f"ssd_ms_bucket{B}"] = time_ms(
            lambda: ssd_scan(x, dt, A, Bm, Cm, chunk=64), flush)
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
    if len(sys.argv) not in (2, 3):
        sys.exit(__doc__)
    sys.exit(main(Path(sys.argv[1]), sys.argv[2] if len(sys.argv) == 3
                  else ""))
