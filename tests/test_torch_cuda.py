"""The port's CUDA kernels on the card: each against its plain PyTorch
version, and the decoder on the card against the CPU.  Marked ``cuda``;
every test skips, with its reason, where no CUDA device is present.  Run on
a machine with an NVIDIA H100 with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain  # noqa: E402
from repro_torch.models import (decode_step_ragged, init_cache,  # noqa: E402
                                init_params, prefill)

pytestmark = pytest.mark.cuda
TOL = {torch.bfloat16: 2e-2, torch.float32: 3e-5}   # as chip_smoke.py
# ssd_scan, as tests/test_kernels.py: (y, state) per dtype
SSD_TOL = {torch.bfloat16: (6e-2, 1e-2), torch.float32: (1e-4, 1e-4)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return gen


def _close(got, want, dtype):
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", [(2, 100, 228, 6, 3, 64, True, 100),
                                  (2, 1, 96, 6, 3, 72, True, 32),
                                  (1, 130, 130, 4, 2, 96, False, 0),
                                  (1, 64, 64, 2, 1, 128, True, 0),
                                  # the minicpm-2b join at buckets 1 and 8
                                  (1, 512, 512, 36, 36, 64, True, 0),
                                  (8, 512, 512, 36, 36, 64, True, 0),
                                  (3, 1, 200, 8, 2, 64, True, 0),   # Sq = 1
                                  (2, 70, 300, 4, 4, 64, True, 0),  # Sq < Sk
                                  (1, 256, 256, 4, 2, 64, True, 16),  # window
                                  (2, 150, 150, 4, 2, 32, True, 0),
                                  (1, 190, 250, 4, 1, 72, True, 0),
                                  (2, 129, 129, 2, 2, 96, True, 40),
                                  (1, 300, 300, 8, 4, 128, False, 0),
                                  (2, 77, 77, 4, 4, 64, False, 0),  # Sk ragged
                                  ], ids=str)
def test_flash_attention_kernel_matches_plain(cuda, case, dtype):
    B, Sq, Sk, Hq, Hkv, hd, causal, w = case
    q = torch.randn(B, Sq, Hq, hd, generator=cuda, device="cuda").to(dtype)
    k = torch.randn(B, Sk, Hkv, hd, generator=cuda, device="cuda").to(dtype)
    v = torch.randn(B, Sk, Hkv, hd, generator=cuda, device="cuda").to(dtype)
    n = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=w)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    _close(out, flash_attention_plain(q, k, v, causal=causal, window=w),
           dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", [(3, 300, 6, 3, 64), (2, 33, 4, 4, 72),
                                  (2, 200, 8, 1, 128)], ids=str)
def test_decode_attention_kernel_matches_plain(cuda, case, dtype):
    B, L, Hq, Hkv, hd = case
    q = torch.randn(B, Hq, hd, generator=cuda, device="cuda").to(dtype)
    k = torch.randn(B, L, Hkv, hd, generator=cuda, device="cuda").to(dtype)
    v = torch.randn(B, L, Hkv, hd, generator=cuda, device="cuda").to(dtype)
    vlen = torch.randint(1, L + 1, (B,), generator=cuda, device="cuda",
                         dtype=torch.int32)
    vlen[0] = 0
    n = decode_attention.launches
    out = decode_attention(q, k, v, vlen)
    torch.cuda.synchronize()
    assert decode_attention.launches == n + 1
    assert not out[0].any()
    _close(out, decode_attention_plain(q, k, v, vlen), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", [
    # (B, L, Hq, Hkv, hd, valid_len): batch 1 of minicpm-2b (the most
    # splits), full and ending inside the first split; rows that end inside
    # the first split beside full rows and a row with valid_len = 0; Hq/Hkv
    # of 1, 4 and 8
    (1, 544, 36, 36, 64, [544]),
    (1, 544, 36, 36, 64, [37]),
    (8, 544, 36, 36, 64, [544, 1, 0, 300, 64, 65, 543, 128]),
    (4, 544, 16, 4, 64, [0, 20, 544, 200]),
    (2, 1000, 32, 4, 128, [999, 3]),
    (3, 257, 8, 8, 64, [257, 0, 129]),
    (2, 300, 8, 1, 128, [300, 10]),
    (2, 130, 64, 8, 32, [130, 66]),
    (1, 200, 8, 1, 96, [0]),
    (2, 100, 32, 1, 32, [100, 51]),
], ids=str)
def test_decode_attention_split_kernel_matches_plain(cuda, case, dtype):
    B, L, Hq, Hkv, hd, vl = case
    q = torch.randn(B, Hq, hd, generator=cuda, device="cuda").to(dtype)
    k = torch.randn(B, L, Hkv, hd, generator=cuda, device="cuda").to(dtype)
    v = torch.randn(B, L, Hkv, hd, generator=cuda, device="cuda").to(dtype)
    vlen = torch.tensor(vl, dtype=torch.int32, device="cuda")
    n = decode_attention.launches
    out = decode_attention(q, k, v, vlen)
    torch.cuda.synchronize()
    assert decode_attention.launches == n + 1
    assert torch.isfinite(out).all()
    for b in range(B):
        if vl[b] == 0:
            assert not out[b].any()
    _close(out, decode_attention_plain(q, k, v, vlen), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", [(2, 128, 4, 64, 32, 64, False),
                                  (1, 64, 2, 32, 16, 16, False),
                                  (2, 128, 2, 32, 16, 64, True),
                                  (1, 100, 2, 32, 16, 64, True),
                                  (2, 130, 8, 64, 128, 64, False),
                                  (1, 40, 3, 32, 64, 32, True),
                                  # the mamba2-370m join at buckets 1 and 8
                                  (1, 512, 32, 64, 128, 64, False),
                                  (8, 512, 32, 64, 128, 64, False),
                                  # more than 8 chunks, several a CTA
                                  (2, 1100, 4, 64, 128, 64, True)], ids=str)
def test_ssd_scan_kernel_matches_plain(cuda, case, dtype):
    """(B, S, H, P, N, chunk, init_state); S 100, 130, 40 and 1100 are no
    multiple of the chunk."""
    B, S, H, P, N, Q, init = case
    x = torch.randn(B, S, H, P, generator=cuda, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, H, generator=cuda, device="cuda")).to(dtype)
    A = -torch.exp(0.5 * torch.randn(H, generator=cuda, device="cuda"))
    Bm = torch.randn(B, S, N, generator=cuda, device="cuda").to(dtype)
    Cm = torch.randn(B, S, N, generator=cuda, device="cuda").to(dtype)
    s0 = (torch.randn(B, H, P, N, generator=cuda, device="cuda")
          if init else None)
    n = ssd_scan.launches
    y, st = ssd_scan(x, dt, A, Bm, Cm, chunk=Q, init_state=s0)
    torch.cuda.synchronize()
    assert ssd_scan.launches == n + 1
    assert y.shape == x.shape and y.dtype == dtype
    assert st.shape == (B, H, P, N) and st.dtype == torch.float32
    yp, sp = ssd_scan_plain(x, dt, A, Bm, Cm, chunk=Q, init_state=s0)
    ty, ts = SSD_TOL[dtype]
    torch.testing.assert_close(y.float(), yp.float(), rtol=ty, atol=ty)
    torch.testing.assert_close(st, sp, rtol=ts, atol=ts)


@pytest.mark.parametrize("split", [(1, 8), (2, 4), (3, 3), (4, 2), (8, 1)],
                         ids=str)
def test_ssd_scan_kernel_matches_plain_at_every_split(cuda, split,
                                                      monkeypatch):
    """The bf16 kernel with its plan fixed to (ranks, chunks each), at a
    ragged S of 8 chunks with an initial state: every split the plan can
    take at 8 chunks gives the plain version's result, in one launch."""
    import importlib
    ssd_mod = importlib.import_module("repro_torch.kernels.ssd_scan")
    monkeypatch.setattr(ssd_mod, "ssd_plan", lambda *_: split)
    B, S, H, P, N = 2, 500, 8, 64, 128
    bf = torch.bfloat16
    x = torch.randn(B, S, H, P, generator=cuda, device="cuda").to(bf)
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, H, generator=cuda, device="cuda")).to(bf)
    A = -torch.exp(0.5 * torch.randn(H, generator=cuda, device="cuda"))
    Bm = torch.randn(B, S, N, generator=cuda, device="cuda").to(bf)
    Cm = torch.randn(B, S, N, generator=cuda, device="cuda").to(bf)
    s0 = torch.randn(B, H, P, N, generator=cuda, device="cuda")
    n = ssd_scan.launches
    y, st = ssd_scan(x, dt, A, Bm, Cm, chunk=64, init_state=s0)
    torch.cuda.synchronize()
    assert ssd_scan.launches == n + 1
    yp, sp = ssd_scan_plain(x, dt, A, Bm, Cm, chunk=64, init_state=s0)
    ty, ts = SSD_TOL[bf]
    torch.testing.assert_close(y.float(), yp.float(), rtol=ty, atol=ty)
    torch.testing.assert_close(st, sp, rtol=ts, atol=ts)


def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(1, 8, 2, 80, device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, q, q)
    q = torch.zeros(1, 8, 2, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="takes"):
        flash_attention(q, q, q)
    q = torch.zeros(1, 2, 8, 64, device="cuda").transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, q, q)
    x = torch.zeros(1, 64, 2, 32, device="cuda")
    dt, A = torch.zeros(1, 64, 2, device="cuda"), torch.zeros(2,
                                                              device="cuda")
    Bm = torch.zeros(1, 64, 16, device="cuda")
    with pytest.raises(ValueError, match="chunks"):
        ssd_scan(x, dt, A, Bm, Bm, chunk=128)
    with pytest.raises(ValueError, match="takes"):
        ssd_scan(x.half(), dt.half(), A, Bm.half(), Bm.half(), chunk=64)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(x, dt, A, Bm.transpose(1, 2).contiguous().transpose(1, 2),
                 Bm, chunk=64)


def test_decoder_on_the_card_matches_the_cpu(cuda):
    cfg = get_config("minicpm-2b", reduced=True).with_(
        compute_dtype="float32", param_dtype="float32")
    p_cpu = init_params(cfg, seed=0, device="cpu")
    p_gpu = {"embed": p_cpu["embed"].cuda(),
             "final_norm": p_cpu["final_norm"].cuda(),
             "groups": [{n: t.cuda() for n, t in g.items()}
                        for g in p_cpu["groups"]]}
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(0))
    before = ops.launch_counts()
    out = {}
    for dev, p in (("cpu", p_cpu), ("cuda", p_gpu)):
        lg, cache = prefill(cfg, p, toks.to(dev),
                            init_cache(cfg, 2, 20, dev))
        t = torch.tensor([16, 11], dtype=torch.int32, device=dev)
        l1, _ = decode_step_ragged(cfg, p, cache, lg.argmax(-1), t)
        out[dev] = (lg.cpu(), l1.cpu())
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)
    after = ops.launch_counts()
    assert after["attention"] - before["attention"] == cfg.n_layers
    assert after["decode_attention"] - before["decode_attention"] \
        == cfg.n_layers


def test_mamba_decoder_on_the_card_matches_the_cpu(cuda):
    """mamba2-370m reduced in float32: a prefill whose S (20) is no
    multiple of the chunk (16), then a ragged decode step."""
    cfg = get_config("mamba2-370m", reduced=True).with_(
        compute_dtype="float32", param_dtype="float32")
    p_cpu = init_params(cfg, seed=0, device="cpu")
    p_gpu = {"embed": p_cpu["embed"].cuda(),
             "final_norm": p_cpu["final_norm"].cuda(),
             "groups": [{n: t.cuda() for n, t in g.items()}
                        for g in p_cpu["groups"]]}
    toks = torch.randint(0, cfg.vocab_size, (2, 20),
                         generator=torch.Generator().manual_seed(0))
    before = ops.launch_counts()
    out = {}
    for dev, p in (("cpu", p_cpu), ("cuda", p_gpu)):
        lg, cache = prefill(cfg, p, toks.to(dev),
                            init_cache(cfg, 2, 24, dev))
        t = torch.tensor([20, 13], dtype=torch.int32, device=dev)
        l1, cache = decode_step_ragged(cfg, p, cache, lg.argmax(-1), t)
        out[dev] = (lg.cpu(), l1.cpu(), cache["layers"][0]["state"].cpu())
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)
    after = ops.launch_counts()
    assert after["ssd"] - before["ssd"] == cfg.n_layers
    assert after["attention"] == before["attention"]


@pytest.mark.parametrize("src,kernel", [("flash_attention", "fa_kernel_wgmma"),
                                        ("ssd_scan", "ssd_kernel_wgmma")])
def test_bf16_kernels_run_their_products_on_the_tensor_cores(cuda, src,
                                                              kernel):
    """The bf16 flash and SSD kernels, built from csrc with the shared
    ``hopper.cuh`` helpers, hold HGMMA instructions in their SASS."""
    import shutil
    import subprocess

    from repro_torch.kernels import _build
    _build.build([src])
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_build.library_path(src))],
                          capture_output=True, text=True, check=True).stdout
    fn, hgmma = None, 0
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1]
        elif fn and kernel in fn and "HGMMA" in line:
            hgmma += 1
    assert hgmma > 0


@pytest.mark.parametrize("arch", ["minicpm-2b", "mamba2-370m"])
def test_simulate_torch_batched_on_the_card(cuda, arch):
    """Archipelago over the card: the reduced model served through
    ``simulate`` with continuous ``torch-batched``; every request completes
    once, and each kernel launched once per layer in every join (flash,
    SSD) or decode tick (decode), set-up and calibration included."""
    from repro_torch.core import BatchedTorchBackend, ClusterConfig
    from repro_torch.serving import ServedModel, ServingApp
    from repro_torch.sim import Experiment, simulate
    cfg = get_config(arch, reduced=True)
    backend = BatchedTorchBackend(max_batch=4, batching="continuous")
    ops.reset_launch_counts()
    r = simulate(Experiment(
        stack="archipelago", backend=backend,
        workload_factory="serving_apps",
        workload_kwargs=dict(apps=[ServingApp("app", {"gen": ServedModel(
            cfg, prompt_len=32, gen_len=4)})], duration=1.0, rps=40.0),
        cluster=ClusterConfig(n_sgs=1, workers_per_sgs=2, cores_per_worker=4,
                              pool_mem_mb=2048.0), drain=20.0))
    got = ops.launch_counts()
    acc = r.accounting
    assert r.n_completed == r.n_requests > 0
    assert acc["lost"] == 0 and acc["duplicate_completions"] == 0
    assert r.data_plane == {"device": "cuda", "batching": "continuous"}
    bc = r.backend_counters
    assert bc["n_joins"] == r.n_requests
    # every bucket once in set-up and calib_runs times in calibration
    pre = len(backend.executor.buckets()) * (1 + backend.calib_runs)
    joins = cfg.n_layers * (pre + bc["n_prefill_batches"])
    ticks = cfg.n_layers * (pre + bc["n_decode_ticks"])
    want = ({"attention": joins, "decode_attention": ticks, "ssd": 0}
            if arch == "minicpm-2b"
            else {"attention": 0, "decode_attention": 0, "ssd": joins})
    assert got == want
