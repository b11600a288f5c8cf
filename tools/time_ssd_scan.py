"""Time the port's SSD scan of another checkout on the card.

    python3 tools/time_ssd_scan.py ROOT

imports ``repro_torch`` from ``ROOT/src`` and times its ``ssd_scan`` at the
mamba2-370m join's shape (S 512, 32 heads, P 64, N 128, chunk 64, bf16) at
buckets 8 and 1, as ``chip_smoke.py`` times the kernel of its own checkout
(median of 25 CUDA-event timings, L2 flushed, a device-side sleep ahead of
each).  It prints one JSON line.  It exists to compare a commit whose
``chip_smoke.py`` times the scan at bucket 8 only with one that times both.
"""
import json
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


def main(root: Path) -> int:
    if not torch.cuda.is_available():
        print("time_ssd_scan: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root.resolve() / "src"))
    from repro_torch.kernels.ssd_scan import ssd_scan
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    out = {"root": str(root), "device": torch.cuda.get_device_name(0)}
    for B in (8, 1):
        S, H, P, N = 512, 32, 64, 128
        rnd = lambda *shape: torch.randn(shape, generator=gen,  # noqa: E731
                                         device="cuda")
        x = rnd(B, S, H, P).bfloat16()
        dt = torch.nn.functional.softplus(rnd(B, S, H)).bfloat16()
        A = -torch.exp(0.5 * rnd(H))
        Bm, Cm = rnd(B, S, N).bfloat16(), rnd(B, S, N).bfloat16()
        out[f"ms_bucket{B}"] = time_ms(
            lambda: ssd_scan(x, dt, A, Bm, Cm, chunk=64), flush)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(Path(sys.argv[1])))
