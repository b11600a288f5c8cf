"""The port's CUDA kernels on the card: each against its plain PyTorch
version, and the decoder on the card against the CPU.  Marked ``cuda``;
every test skips, with its reason, where no CUDA device is present.  Run on
a machine with an NVIDIA H100 with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import importlib.util
from pathlib import Path

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


def _smoke_module():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


SMOKE = _smoke_module()


def _smoke_tolerances():
    """chip_smoke.py's tolerances, keyed by torch dtype: kernel vs plain
    (``TOL``; ``SSD_TOL``, (y, state)) and Function gradients vs plain
    (``GRAD_TOL``)."""
    smoke = SMOKE

    def by_dtype(table):
        return {getattr(torch, name): tol for name, tol in table.items()}
    return (by_dtype(smoke.TOL), by_dtype(smoke.SSD_TOL),
            {kind: by_dtype(smoke.GRAD_TOL[name]) for kind, name in
             (("flash", "flash_attention"), ("ssd", "ssd_scan"))})


TOL, SSD_TOL, GRAD_TOL = _smoke_tolerances()


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


def _close_rows(got, want, dtype):
    """``_close``, then each row within TOL of its norm (chip_smoke.py's
    decode check: over a long cache the elements are small)."""
    _close(got, want, dtype)
    rel = SMOKE.row_rel_err(got, want)
    assert rel <= TOL[dtype], f"a row's error is {rel:.3g} of its norm"


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
@pytest.mark.parametrize("case", [
    # (B, Sq, Sk, Hq, Hkv, hd, causal, window) at hd 256: gemma3-1b's join
    # at bucket 8 (4 heads over 1 KV head), its local window of 512 on a
    # prompt past it, a non-causal one, one query over 1500 keys, Sq < Sk
    (8, 512, 512, 4, 1, 256, True, 0),
    (1, 1100, 1100, 4, 1, 256, True, 512),
    (2, 300, 300, 4, 1, 256, False, 0),
    (2, 1, 1500, 4, 1, 256, False, 0),
    (1, 77, 200, 4, 1, 256, True, 0),
    # each q-tile height the wrapper picks (flash_block_q): 64 at batch 1,
    # 128 at bucket 8 (above), a ragged Sq < Sk, a window, non-causal
    (1, 512, 512, 4, 1, 256, True, 0),
    (9, 200, 333, 4, 1, 256, True, 0),
    (8, 600, 600, 4, 1, 256, True, 256),
    (5, 450, 450, 4, 1, 256, False, 0),
    (1, 8192, 8192, 4, 1, 256, True, 0),    # a long prompt
], ids=str)
def test_flash_attention_kernel_matches_plain_at_hd256(cuda, case, dtype):
    """The hd 256 instances: bf16 gives each warpgroup 64 q rows and all
    256 output columns, in CTAs of 64 or 128 rows; f32 is the CUDA-core
    kernel."""
    test_flash_attention_kernel_matches_plain(cuda, case, dtype)


# (B, Sq, Sk, Hq, Hkv, hd, causal, window) for the persistent body (bf16 at
# hd 72, 96 and 128): G 1, 4, 5, 6 and 8; more work tiles than CTAs (bucket
# 8 of minitron-8b, llama4-scout, mixtral-8x22b and phi-3, a long prompt)
# and fewer; Sq no multiple of 128, Sq < Sk, Sq = 1; windows that cut a
# tile; non-causal
PERSISTENT_CASES = [
    (8, 512, 512, 32, 8, 128, True, 0),
    (8, 512, 512, 40, 8, 128, True, 0),
    (8, 512, 512, 48, 8, 128, True, 0),
    (8, 512, 512, 32, 32, 96, True, 0),
    (1, 512, 512, 64, 8, 128, True, 0),
    (1, 200, 200, 8, 8, 96, True, 0),
    (3, 300, 300, 40, 8, 128, True, 0),
    (2, 190, 450, 48, 8, 128, True, 0),
    (4, 1, 333, 32, 8, 128, True, 0),
    (2, 1, 1500, 32, 32, 96, False, 0),
    (2, 700, 700, 32, 8, 128, True, 100),
    (1, 2100, 2100, 48, 8, 128, True, 1000),
    (3, 257, 257, 24, 4, 72, True, 33),
    (2, 400, 400, 20, 4, 96, False, 0),
    (5, 129, 129, 16, 16, 72, False, 0),
    (1, 4096, 4096, 48, 8, 128, True, 4096),
    # hd 64 and 32 (minicpm-2b's G 1, the reduced GQA configs' G 2 and 4):
    # more work tiles than CTAs (bucket 8, a long prompt) and fewer (batch
    # 1, a short prompt), Sq no multiple of 128, Sq < Sk, Sq = 1, a window
    # inside a tile, non-causal (whisper's encoder), hd 32
    (8, 512, 512, 36, 36, 64, True, 0),
    (4, 512, 512, 36, 36, 64, True, 0),
    (1, 4096, 4096, 36, 36, 64, True, 0),
    (1, 1500, 1500, 6, 6, 64, False, 0),
    (2, 333, 333, 8, 4, 64, True, 0),
    (3, 190, 450, 16, 4, 64, True, 0),
    (2, 1, 700, 12, 6, 64, True, 0),
    (1, 300, 300, 4, 4, 64, True, 16),
    (2, 129, 129, 8, 2, 64, False, 0),
    (8, 512, 512, 16, 16, 32, True, 0),
    (2, 77, 200, 4, 2, 32, True, 50),
]


@pytest.mark.parametrize("case", PERSISTENT_CASES, ids=str)
def test_flash_attention_persistent_body_matches_plain(cuda, case):
    """bf16 at hd 32 to 128 runs the persistent body (a grid of at most
    one CTA an SM, each walking its work tiles): against the plain version
    in the cases above."""
    test_flash_attention_kernel_matches_plain(cuda, case, torch.bfloat16)


@pytest.mark.parametrize("case", [(8, 512, 512, 40, 8, 128, True, 0),
                                  (2, 300, 500, 32, 32, 96, True, 64),
                                  (1, 128, 128, 4, 4, 72, False, 0),
                                  (8, 512, 512, 36, 36, 64, True, 0),
                                  (1, 700, 700, 8, 2, 32, True, 100)],
                         ids=str)
def test_flash_attention_persistent_replays_equal_bit_for_bit(cuda, case):
    """Two eager launches, two replays of a captured launch and an eager
    launch after them are equal bit for bit: each work tile is computed
    whole by one CTA, in one order."""
    B, Sq, Sk, Hq, Hkv, hd, causal, w = case
    dt = torch.bfloat16
    q = torch.randn(B, Sq, Hq, hd, generator=cuda, device="cuda").to(dt)
    k = torch.randn(B, Sk, Hkv, hd, generator=cuda, device="cuda").to(dt)
    v = torch.randn(B, Sk, Hkv, hd, generator=cuda, device="cuda").to(dt)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = [flash_attention(q, k, v, causal=causal, window=w)
                 for _ in range(2)]
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_attention(q, k, v, causal=causal, window=w)
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append(out.clone())
    after = flash_attention(q, k, v, causal=causal, window=w)
    torch.cuda.synchronize()
    assert torch.equal(eager[0], eager[1])
    assert all(torch.equal(r, eager[0]) for r in replays)
    assert torch.equal(after, eager[0])
    _close(eager[0], flash_attention_plain(q, k, v, causal=causal, window=w),
           dt)


@pytest.mark.parametrize("case", [(8, 512, 512, 48, 8, 128, True, 0),
                                  (1, 512, 512, 32, 32, 96, True, 0)],
                         ids=str)
def test_flash_attention_persistent_on_two_streams_at_once(cuda, case):
    """Persistent launches of two inputs in turns on two streams, so that
    their CTAs share the card: each output equals its own eager launch bit
    for bit."""
    B, Sq, Sk, Hq, Hkv, hd, causal, w = case
    dt = torch.bfloat16
    ins = [tuple(torch.randn(*shape, generator=cuda, device="cuda").to(dt)
                 for shape in ((B, Sq, Hq, hd), (B, Sk, Hkv, hd),
                               (B, Sk, Hkv, hd)))
           for _ in range(2)]
    want = [flash_attention(q, k, v, causal=causal, window=w)
            for q, k, v in ins]
    streams = [torch.cuda.Stream() for _ in ins]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(10):
        for i, (s, (q, k, v)) in enumerate(zip(streams, ins)):
            with torch.cuda.stream(s):
                outs[i].append(flash_attention(q, k, v, causal=causal,
                                               window=w))
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(o, want[i]) for o in outs[i])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [32, 64, 72, 96, 128, 256])
def test_flash_attention_runs_the_body_flash_body_names(cuda, tmp_path, hd,
                                                        dtype):
    """The kernel a launch runs on the card is the body ``flash_body``
    names: ``fa_kernel_persist`` for ``persistent``, ``fa_kernel_wgmma``
    for ``hd256``, ``fa_kernel_f32`` for ``f32``, at this
    head dim; read from the kernel node of a captured graph (the
    profiler, run many times in one process, stops seeing kernels)."""
    import re

    from repro_torch.kernels.flash_attention import flash_body
    q = torch.randn(2, 300, 8, hd, generator=cuda, device="cuda").to(dtype)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash_attention(q, q, q)
    torch.cuda.current_stream().wait_stream(side)
    # kept, so that its kernel nodes can be printed
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.enable_debug_mode()
    with torch.cuda.graph(graph):
        flash_attention(q, q, q)
    dot = tmp_path / "flash.dot"
    graph.debug_dump(str(dot))
    found = set(re.findall(r"fa_kernel_(persist|wgmma|f32)(?:ILi|<)(\d+)",
                           dot.read_text()))
    want = {"persistent": "persist", "hd256": "wgmma",
            "f32": "f32"}[flash_body(hd, dtype)]
    assert found == {(want, str(hd))}, found


@pytest.mark.parametrize("hd", [32, 64, 72, 96, 128])
def test_the_persistent_flash_body_holds_unserialised_hgmma(cuda, hd):
    """The persistent instances (both walk orders) hold HGMMA in their
    SASS, spill nothing, have no wgmma that ptxas serialises (its
    "Potential Performance Loss" reports: C7520 followed a role branch the
    compiler could not see was warp-uniform, C7512 a register budget too
    small for 128-key tiles) and enter with the 168 registers a thread
    that setmaxnreg's exchange is reckoned on."""
    import shutil
    import subprocess

    from repro_torch.kernels import _build
    _build.build(["flash_attention"])
    inst = f"fa_kernel_persistILi{hd}E"
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass",
                           str(_build.library_path("flash_attention"))],
                          capture_output=True, text=True, check=True).stdout
    fn, hgmma = None, 0
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1]
        elif fn and inst in fn and "HGMMA" in line:
            hgmma += 1
    assert hgmma > 0
    log = _build.ptxas_log("flash_attention").read_text()
    spills = SMOKE.ptxas_spills(log)
    assert not [f for f in spills if inst in f], spills
    assert not [ln for ln in log.splitlines()
                if "serialized" in ln and inst in ln]
    # setmaxnreg's exchange (128 x 40 + 256 x 232) adds up to 384 x 168
    used, fn = [], None
    for line in log.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for")[1]
        elif fn and inst in fn and "Used " in line:
            used.append(int(line.split("Used ")[1].split()[0]))
            fn = None
    assert used == [168, 168], used


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", [
    # (B, L, Hq, Hkv, hd, valid_len): gemma3-1b's decode (G = 4 at hd 256,
    # G * hd = 1024) at buckets 8 and 1, and rows with valid_len = 0
    (8, 544, 4, 1, 256, [544, 0, 1, 300, 64, 65, 543, 128]),
    (1, 544, 4, 1, 256, [544]),
    (2, 1100, 4, 1, 256, [0, 1100]),
    (3, 200, 8, 2, 256, [200, 7, 0]),
    # batch 1 over a 32k and a 128k cache (132 CTAs, the ticket combine in
    # groups): full, empty, and ending inside a tile and inside a group;
    # batch 2 with a row at 0
    (1, 32768, 4, 1, 256, [32768]),
    (1, 32768, 4, 1, 256, [0]),
    (1, 32768, 4, 1, 256, [20001]),
    (1, 131072, 4, 1, 256, [131072]),
    (1, 131072, 4, 1, 256, [100001]),
    (2, 32768, 4, 1, 256, [0, 30001]),
], ids=str)
def test_decode_attention_kernel_matches_plain_at_hd256(cuda, case, dtype):
    test_decode_attention_split_kernel_matches_plain(cuda, case, dtype)


@pytest.mark.parametrize("case", [(1, 32768, 4, 1, 256, 30001),
                                  (8, 544, 4, 1, 256, 500),
                                  (1, 4096, 8, 1, 128, 4000),
                                  (1, 32768, 48, 8, 128, 30001),
                                  (8, 544, 40, 8, 128, 500),
                                  (8, 544, 36, 36, 64, 500),
                                  (1, 32768, 36, 36, 64, 30001),
                                  (8, 544, 32, 32, 96, 500),
                                  (1, 32768, 32, 32, 96, 30001)], ids=str)
def test_decode_attention_replays_equal_bit_for_bit(cuda, case):
    """A decode captured in a CUDA graph at a plan that combines by tickets
    (132 CTAs in groups at a 32k cache; one group at bucket 8; hd 128 past
    one cluster, on the CUDA cores) or over a cluster (the tensor cores at
    hd 128: G 6 over 8 ranges of 4096 keys, G 5 at bucket 8): two replays
    and an eager launch after them equal the eager launch before the
    capture bit for bit, so every launch and replay finds its tickets at
    zero and no sum depends on arrival order."""
    B, L, Hq, Hkv, hd, n = case
    dt = torch.bfloat16
    q = torch.randn(B, Hq, hd, generator=cuda, device="cuda").to(dt)
    k = torch.randn(B, L, Hkv, hd, generator=cuda, device="cuda").to(dt)
    v = torch.randn(B, L, Hkv, hd, generator=cuda, device="cuda").to(dt)
    vlen = torch.full((B,), n, dtype=torch.int32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = decode_attention(q, k, v, vlen)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention(q, k, v, vlen)
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append(out.clone())
    after = decode_attention(q, k, v, vlen)
    torch.cuda.synchronize()
    assert all(torch.equal(r, eager) for r in replays)
    assert torch.equal(after, eager)
    _close_rows(eager, decode_attention_plain(q, k, v, vlen), dt)


@pytest.mark.parametrize("case", [(1, 32768, 4, 1, 256, 30001),
                                  (1, 4096, 8, 1, 128, 4000),
                                  (1, 4096, 48, 8, 128, 4000),
                                  (2, 544, 32, 8, 128, 500),
                                  (1, 4096, 32, 32, 96, 4000),
                                  (8, 544, 32, 32, 96, 500)], ids=str)
def test_decode_attention_on_two_streams_at_once(cuda, case):
    """Ticket-combined decodes of two inputs launched in turns on two
    streams, so that they overlap on the card: each output equals its own
    eager launch bit for bit (each launch counts on its own tickets)."""
    B, L, Hq, Hkv, hd, n = case
    dt = torch.bfloat16
    ins = [tuple(torch.randn(*shape, generator=cuda, device="cuda").to(dt)
                 for shape in ((B, Hq, hd), (B, L, Hkv, hd), (B, L, Hkv, hd)))
           for _ in range(2)]
    vlen = torch.full((B,), n, dtype=torch.int32, device="cuda")
    want = [decode_attention(q, k, v, vlen) for q, k, v in ins]
    streams = [torch.cuda.Stream() for _ in ins]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(20):
        for i, (s, (q, k, v)) in enumerate(zip(streams, ins)):
            with torch.cuda.stream(s):
                outs[i].append(decode_attention(q, k, v, vlen))
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(o, want[i]) for o in outs[i])


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
    _close_rows(out, decode_attention_plain(q, k, v, vlen), dtype)


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
    # past one cluster (the ticket combine): one KV head at batch 1, and
    # a long cache at batch 2 with a row of 3 keys
    (1, 4096, 8, 1, 128, [4000]),
    (2, 20000, 32, 8, 128, [19999, 3]),
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
    _close_rows(out, decode_attention_plain(q, k, v, vlen), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", [
    # (B, L, Hq, Hkv, hd, valid_len): the grouped-query decode at hd 128
    # (8 KV heads; G 2, 4 minitron-8b, 5 llama4-scout, 6 mixtral-8x22b, 7,
    # 8), which bf16 runs on the tensor cores at split_plan_tc's plans (one
    # cluster of 1 to 8 ranges; two stages a warp where a warp has more
    # than one 16-key block): the serving buckets 8 and 1 over 544 keys,
    # ragged rows and rows at 0, L no multiple of 16, one range (B 64),
    # mixtral's window and a 32k cache at batch 1
    (2, 544, 16, 8, 128, [544, 0]),
    (8, 544, 32, 8, 128, [544, 0, 1, 300, 64, 65, 543, 128]),
    (1, 544, 40, 8, 128, [544]),
    (3, 1001, 48, 8, 128, [1001, 17, 0]),
    (2, 333, 56, 8, 128, [333, 200]),
    (2, 9000, 64, 8, 128, [0, 8999]),
    (1, 4096, 48, 8, 128, [4096]),
    (1, 4096, 16, 8, 128, [0]),
    (1, 32768, 32, 8, 128, [30001]),
    (1, 32768, 64, 8, 128, [32768]),
    (64, 100, 16, 8, 128, [100] * 63 + [0]),
], ids=str)
def test_decode_attention_kernel_matches_plain_at_hd128_grouped(cuda, case,
                                                                dtype):
    test_decode_attention_split_kernel_matches_plain(cuda, case, dtype)


@pytest.mark.parametrize("case", [
    # (B, L, Hq, Hkv, hd, valid_len): the decode at hd 64, which bf16 runs
    # on the tensor cores at G <= 8 (minicpm-2b's G 1, the reduced GQA
    # configs' G 2 and 4): the serving buckets 8 and 1 over 544 keys,
    # ragged rows, rows at 0, valid_len no multiple of 16, one key, a
    # long cache at batch 1, G 8 (the mma's last column)
    (8, 544, 36, 36, 64, [544, 0, 1, 300, 64, 65, 543, 17]),
    (1, 544, 36, 36, 64, [544]),
    (1, 544, 36, 36, 64, [37]),
    (4, 1000, 16, 8, 64, [999, 0, 15, 500]),
    (3, 333, 16, 4, 64, [333, 1, 0]),
    (2, 100, 32, 4, 64, [100, 51]),
    (1, 4096, 36, 36, 64, [4001]),
    (1, 32768, 36, 36, 64, [32768]),
    (1, 32768, 36, 36, 64, [20001]),
    (2, 9000, 8, 1, 64, [0, 8999])], ids=str)
def test_decode_attention_kernel_matches_plain_at_hd64(cuda, case):
    test_decode_attention_split_kernel_matches_plain(cuda, case,
                                                     torch.bfloat16)


@pytest.mark.parametrize("plan", [(16, 2048), (40, 100), (1, 544),
                                  (8, 96)], ids=str)
@pytest.mark.parametrize("case", [(1, 32768, 36, 36, 64, [32768]),
                                  (2, 544, 36, 36, 64, [0, 543])], ids=str)
def test_decode_attention_tensor_cores_at_other_plans_at_hd64(
        cuda, monkeypatch, case, plan):
    """The hd 64 tensor-core body at plans its planner does not give:
    ranges past the cache (some empty), ranges no whole number of tiles,
    one range, and past one cluster (tickets), against the plain
    version."""
    import importlib
    dm = importlib.import_module("repro_torch.kernels.decode_attention")
    B, L, Hq, Hkv, hd, vl = case
    n_split, chunk = plan
    if n_split * chunk < L:
        chunk = -(-L // n_split)
    monkeypatch.setattr(dm, "split_plan_tc", lambda *_: (n_split, chunk))
    monkeypatch.setattr(dm, "split_plan", lambda *_: (n_split, chunk))
    assert dm.decode_instance(hd, Hq // Hkv, torch.bfloat16) == \
        "tensor_cores"
    test_decode_attention_split_kernel_matches_plain(cuda, case,
                                                     torch.bfloat16)


@pytest.mark.parametrize("case", [
    # (B, L, Hq, Hkv, hd, valid_len): phi-3's decode at hd 96 (32 heads, G
    # 1: phi3-mini, phi-3-vision), which bf16 runs on the tensor cores on
    # three 32-column panels, at split_plan_tc's plans: the serving buckets
    # 8, 4, 2 and 1 over 544 keys with ragged rows, rows at 0 and
    # valid_len no multiple of 16, batch 1 over 4096 and 32768 keys; G 4
    # and 8 (the mma's last column)
    (8, 544, 32, 32, 96, [544, 0, 1, 300, 64, 65, 543, 17]),
    (4, 544, 32, 32, 96, [544, 200, 0, 31]),
    (2, 544, 32, 32, 96, [543, 544]),
    (1, 544, 32, 32, 96, [544]),
    (1, 544, 32, 32, 96, [37]),
    (1, 4096, 32, 32, 96, [4001]),
    (1, 32768, 32, 32, 96, [32768]),
    (1, 32768, 32, 32, 96, [20001]),
    (4, 1000, 32, 8, 96, [999, 0, 15, 500]),
    (3, 333, 64, 8, 96, [333, 1, 0]),
    (2, 9000, 8, 1, 96, [0, 8999])], ids=str)
def test_decode_attention_kernel_matches_plain_at_hd96(cuda, case):
    test_decode_attention_split_kernel_matches_plain(cuda, case,
                                                     torch.bfloat16)


@pytest.mark.parametrize("n_split", range(2, 9))
@pytest.mark.parametrize("case", [(1, 4096, 32, 32, 96, [4001]),
                                  (2, 544, 32, 8, 96, [0, 543]),
                                  (1, 544, 64, 8, 96, [300])], ids=str)
def test_decode_attention_tensor_cores_at_2_to_8_ranges_at_hd96(
        cuda, monkeypatch, case, n_split):
    """The hd 96 tensor-core body at every plan of one cluster (2 to 8
    ranges of whole 32-key tiles, the last ones past valid_len), most of
    which its planner (``split_plan_tc``) does not give at these shapes,
    G 1, 4 and 8, against the plain version."""
    import importlib
    dm = importlib.import_module("repro_torch.kernels.decode_attention")
    B, L, Hq, Hkv, hd, vl = case
    chunk = -(-L // n_split // 32) * 32
    plan = (-(-L // chunk), chunk)
    monkeypatch.setattr(dm, "split_plan_tc", lambda *_: plan)
    assert dm.decode_plan(B, Hq, Hkv, L, hd, torch.bfloat16, 132) == \
        ("tensor_cores", *plan, 0)
    test_decode_attention_split_kernel_matches_plain(cuda, case,
                                                     torch.bfloat16)


@pytest.mark.parametrize("plan", [(16, 256), (12, 350), (40, 103)], ids=str)
@pytest.mark.parametrize("case", [(1, 4096, 48, 8, 128, [4096]),
                                  (2, 4001, 32, 8, 128, [0, 3999])], ids=str)
def test_decode_attention_tensor_cores_past_one_cluster_at_hd128(
        cuda, monkeypatch, case, plan):
    """The hd 128 tensor-core body at plans past one cluster, which
    ``split_plan_tc`` does not give but the body takes (the ticket combine
    in groups, as at hd 256), ranges no whole number of tiles among them,
    against the plain version."""
    import importlib
    dm = importlib.import_module("repro_torch.kernels.decode_attention")
    monkeypatch.setattr(dm, "split_plan_tc", lambda *_: plan)
    B, L, Hq, Hkv, hd, vl = case
    assert plan[0] * plan[1] >= L and dm.split_groups(plan[0], hd) > 0
    test_decode_attention_split_kernel_matches_plain(cuda, case,
                                                     torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", [(64, 1), (128, 1), (128, 2), (128, 6),
                                  (128, 8), (256, 4), (96, 4), (64, 4),
                                  (64, 8), (64, 16), (96, 1), (96, 8),
                                  (96, 10)], ids=str)
def test_decode_attention_runs_the_instance_decode_instance_names(cuda, case,
                                                                 dtype):
    """The body that a launch runs on the card, by the profiler's kernel
    name, is the one ``decode_instance`` names: ``dec_kernel_tc`` for bf16
    at hd 256, at hd 128 with 2 <= G <= 8 and at hd 64 and 96 with G <= 8,
    ``dec_kernel`` else."""
    from repro_torch.kernels.decode_attention import decode_instance
    hd, G = case
    Hkv = 8 if hd == 128 else 1
    q = torch.randn(2, G * Hkv, hd, generator=cuda, device="cuda").to(dtype)
    k = torch.randn(2, 300, Hkv, hd, generator=cuda, device="cuda").to(dtype)
    vlen = torch.full((2,), 300, dtype=torch.int32, device="cuda")
    decode_attention(q, k, k, vlen)
    torch.cuda.synchronize()
    names = SMOKE.profiled_kernel_names(
        lambda: decode_attention(q, k, k, vlen), "dec_kernel")
    assert names, "the profiler saw no decode kernel"
    on_tc = all("dec_kernel_tc" in n for n in names)
    assert on_tc == (decode_instance(hd, G, dtype) == "tensor_cores"), names


@pytest.mark.parametrize("hd", [64, 96, 128, 256])
def test_bf16_decode_runs_its_grouped_products_on_the_tensor_cores(cuda, hd):
    """``dec_kernel_tc`` at hd 64, 96, 128 and 256 holds HMMA
    (``mma.sync``) instructions in its SASS and spills nothing (ptxas)."""
    import shutil
    import subprocess

    from repro_torch.kernels import _build
    _build.build(["decode_attention"])
    inst = f"dec_kernel_tcILi{hd}E"
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass",
                           str(_build.library_path("decode_attention"))],
                          capture_output=True, text=True, check=True).stdout
    fn, hmma = None, 0
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1]
        elif fn and inst in fn and "HMMA" in line:
            hmma += 1
    assert hmma > 0
    spills = SMOKE.ptxas_spills(
        _build.ptxas_log("decode_attention").read_text())
    assert not [f for f in spills if inst in f], spills


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


@pytest.mark.parametrize("src,kernel", [
    ("flash_attention", "fa_kernel_wgmma"),
    ("flash_attention", "fa_kernel_wgmmaILi256E"),    # the hd 256 instance
    ("flash_attention", "fa_kernel_persist"),         # hd 72, 96, 128
    ("ssd_scan", "ssd_kernel_wgmma")])
def test_bf16_kernels_run_their_products_on_the_tensor_cores(cuda, src,
                                                              kernel):
    """The bf16 flash and SSD kernels, built from csrc with the shared
    ``hopper.cuh`` helpers, hold HGMMA instructions in their SASS (the
    flash instance at hd 256 too)."""
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


def test_the_launcher_serves_on_the_card(cuda, capsys):
    """``python -m repro_torch.launch.serve`` without ``--device``: the
    reduced minicpm-2b on continuous ``torch-batched`` on the card; every
    request completed, and the kernels launched."""
    import re
    from repro_torch.launch.serve import main
    ops.reset_launch_counts()
    main(["--backend", "torch-batched", "--batching", "continuous",
          "--requests", "8"])
    out = capsys.readouterr().out
    n, done = re.search(r" n=(\d+) done=(\d+) ", out).groups()
    assert int(n) > 0 and n == done
    assert "device=cuda" in out
    got = ops.launch_counts()
    assert got["attention"] > 0 and got["decode_attention"] > 0


def _on_both(cfg, run):
    """``run(cfg, params, device)`` on the CPU and on the card with the
    same weights (made on the CPU); returns both results on the CPU."""
    p_cpu = init_params(cfg, seed=0, device="cpu")

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return tree.to(dev)

    return {dev: to(run(cfg, p, dev), "cpu")
            for dev, p in (("cpu", p_cpu), ("cuda", to(p_cpu, "cuda")))}


def test_moe_decoder_on_the_card_matches_the_cpu(cuda):
    """mixtral-8x22b reduced in float32 (top-2 of 4 experts, sliding window
    64, wrapped by the prompt): the MoE FFN is plain PyTorch on both
    devices, the attention goes through the kernels on the card."""
    cfg = get_config("mixtral-8x22b", reduced=True).with_(
        compute_dtype="float32", param_dtype="float32")
    toks = torch.randint(0, cfg.vocab_size, (2, 80),
                         generator=torch.Generator().manual_seed(0))

    def run(cfg, p, dev):
        lg, cache = prefill(cfg, p, toks.to(dev), init_cache(cfg, 2, 84, dev))
        t = torch.tensor([80, 71], dtype=torch.int32, device=dev)
        l1, _ = decode_step_ragged(cfg, p, cache, lg.argmax(-1), t)
        return [lg, l1]

    before = ops.launch_counts()
    out = _on_both(cfg, run)
    after = ops.launch_counts()
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)
    # a sliding-window ring decodes on the masked plain path, as in JAX
    assert after["attention"] - before["attention"] == cfg.n_layers
    assert after["decode_attention"] == before["decode_attention"]


def test_whisper_step_on_the_card_matches_the_cpu(cuda):
    """whisper-tiny reduced in float32: the encoder's non-causal flash, the
    decoder's causal and cross-attention flash in prefill, then a decode
    step whose cross-attention is the flash kernel with one query."""
    cfg = get_config("whisper-tiny", reduced=True).with_(
        compute_dtype="float32", param_dtype="float32")
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen)
    fe = torch.randn(2, cfg.n_frontend_tokens, cfg.d_model, generator=gen)

    def run(cfg, p, dev):
        lg, cache = prefill(cfg, p, toks.to(dev), init_cache(cfg, 2, 16, dev),
                            fe.to(dev))
        t = torch.tensor([12, 9], dtype=torch.int32, device=dev)
        l1, _ = decode_step_ragged(cfg, p, cache, lg.argmax(-1), t)
        return [lg, l1]

    before = ops.launch_counts()
    out = _on_both(cfg, run)
    after = ops.launch_counts()
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)
    n_enc, n_dec = cfg.n_enc_layers, cfg.n_layers
    assert after["attention"] - before["attention"] == n_enc + 3 * n_dec
    assert after["decode_attention"] - before["decode_attention"] == n_dec


# ---------------------------------------------------------------------------
# training: the kernels' autograd Functions and a train step on the card
# ---------------------------------------------------------------------------

def _grads_against_plain(kind, fn, plain, inputs, dtype):
    """The Function (kernel forward, backward through kernels/ref.py)
    against autograd through the plain version: the forward output within
    TOL (SSD_TOL for y and the state), the gradients within GRAD_TOL of max
    |g| per input (chip_smoke.py says why each bound holds)."""
    w = torch.randn(fn(*inputs).shape if kind == "flash"
                    else fn(*inputs)[0].shape, device="cuda")
    got, outs = {}, {}
    for name, f in (("fn", fn), ("plain", plain)):
        xs = [t.detach().requires_grad_(True) for t in inputs]
        out = f(*xs)
        outs[name] = (out,) if kind == "flash" else out
        got[name] = torch.autograd.grad((outs[name][0].float() * w).sum(),
                                        xs)
    tols = (TOL[dtype],) if kind == "flash" else SSD_TOL[dtype]
    for a, b, tol in zip(outs["fn"], outs["plain"], tols):
        torch.testing.assert_close(a.detach().float(), b.detach().float(),
                                   rtol=tol, atol=tol)
    for i, (a, b) in enumerate(zip(got["fn"], got["plain"])):
        assert a.dtype == b.dtype == inputs[i].dtype
        err = ((a.float() - b.float()).abs().max()
               / b.float().abs().max()).item()
        assert err <= GRAD_TOL[kind][dtype], f"input {i}: {err:.3g}"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", [(2, 128, 128, 4, 4, 64, True, 0),
                                  (2, 160, 160, 4, 4, 128, True, 48),
                                  (2, 40, 200, 4, 4, 256, False, 0),
                                  (2, 130, 130, 8, 2, 64, True, 0),
                                  (2, 300, 300, 24, 4, 128, True, 0),
                                  (3, 200, 200, 8, 8, 96, True, 64),
                                  (2, 300, 300, 6, 6, 64, True, 16),
                                  (2, 1, 200, 4, 4, 64, True, 0),
                                  (2, 150, 150, 4, 2, 32, False, 0)],
                         ids=["causal", "window", "cross", "gqa",
                              "gqa128", "window96", "window64", "sq1_64",
                              "cross32"])
def test_flash_attention_gradients_match_the_plain_version(cuda, case,
                                                           dtype):
    B, Sq, Sk, Hq, Hkv, hd, causal, w = case
    q = torch.randn(B, Sq, Hq, hd, generator=cuda, device="cuda").to(dtype)
    k = torch.randn(B, Sk, Hkv, hd, generator=cuda, device="cuda").to(dtype)
    v = torch.randn(B, Sk, Hkv, hd, generator=cuda, device="cuda").to(dtype)
    before = flash_attention.launches
    _grads_against_plain(
        "flash", lambda *a: flash_attention(*a, causal=causal, window=w),
        lambda *a: flash_attention_plain(*a, causal=causal, window=w),
        [q, k, v], dtype)
    # the w draw and the graded call: the kernel ran under autograd
    assert flash_attention.launches - before == 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S", [128, 100])
def test_ssd_scan_gradients_match_the_plain_version(cuda, S, dtype):
    F = torch.nn.functional
    B, H, P, N = 2, 4, 64, 128
    x = torch.randn(B, S, H, P, generator=cuda, device="cuda").to(dtype)
    dt = F.softplus(torch.randn(B, S, H, generator=cuda,
                                device="cuda")).to(dtype)
    A = -torch.exp(0.5 * torch.randn(H, generator=cuda, device="cuda"))
    Bm = torch.randn(B, S, N, generator=cuda, device="cuda").to(dtype)
    Cm = torch.randn(B, S, N, generator=cuda, device="cuda").to(dtype)
    before = ssd_scan.launches
    _grads_against_plain(
        "ssd", lambda *a: ssd_scan(*a, chunk=64),
        lambda *a: ssd_scan_plain(*a, chunk=64), [x, dt, A, Bm, Cm], dtype)
    assert ssd_scan.launches - before == 2


def test_serving_on_the_card_takes_no_function(cuda, monkeypatch):
    """With no input requiring a gradient the wrappers launch directly: no
    autograd.Function and no checkpoint on the serving path."""
    import importlib
    from repro_torch.models import transformer

    def refuse(*a, **k):
        raise AssertionError("autograd machinery on the serving path")

    for mod, cls in (("flash_attention", "FlashAttentionFn"),
                     ("ssd_scan", "SSDScanFn")):
        m = importlib.import_module(f"repro_torch.kernels.{mod}")
        monkeypatch.setattr(getattr(m, cls), "apply", refuse)
    monkeypatch.setattr(transformer, "checkpoint", refuse)
    cfg = get_config("zamba2-1.2b", reduced=True)
    p = init_params(cfg, seed=0, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 20), device="cuda")
    before = ops.launch_counts()
    lg, _ = prefill(cfg, p, toks, init_cache(cfg, 2, 24, "cuda"))
    assert torch.isfinite(lg.float()).all() and lg.grad_fn is None
    after = ops.launch_counts()
    assert after["ssd"] > before["ssd"]
    assert after["attention"] > before["attention"]


@pytest.mark.parametrize("arch", ["minicpm-2b", "mamba2-370m"])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """Two AdamW steps of the reduced model in float32 from the same
    weights: both losses and the first step's gradients (its first moment
    is a tenth of the clipped gradient) on the card hold to the CPU's, and
    each kernel launched twice a layer a step (forward, remat).  The
    parameters themselves are not compared: where a gradient is near 0 its
    sign may differ between the devices, and Adam's first step then moves
    the parameter by 2 lr."""
    from repro_torch.train import adamw_init, make_train_step
    from repro_torch.train.tree import leaves
    cfg = get_config(arch, reduced=True).with_(
        compute_dtype="float32", param_dtype="float32")
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(0))

    def run(cfg, p, dev):
        step = make_train_step(cfg, total_steps=2, peak_lr=1e-3)
        opt, losses = adamw_init(p), []
        for i in range(2):
            p, opt, loss = step(p, opt, toks.to(dev))
            losses.append(loss)
            if i == 0:
                mu = [m.clone() for m in leaves(opt.mu)]
        return [torch.stack(losses)] + mu

    before = ops.launch_counts()
    out = _on_both(cfg, run)
    after = ops.launch_counts()
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=2e-4,
                               atol=0)
    for a, b in zip(out["cuda"][1:], out["cpu"][1:]):
        assert ((a - b).abs().max() / b.abs().max()).item() <= 1e-3
    op = "ssd" if arch == "mamba2-370m" else "attention"
    assert after[op] - before[op] == 2 * 2 * cfg.n_layers


@pytest.mark.parametrize("arch", ["minicpm-2b", "mamba2-370m", "gemma3-1b",
                                  "mixtral-8x22b"])
def test_replays_equal_the_eager_bodies_on_the_card(cuda, arch):
    """``chip_smoke.replay_parity`` (phase 6 (b)) on the reduced config:
    joins at buckets 8, 1, 4, 2, 8 with steps between, replayed from the
    captured programs against the eager bodies on the same state (equal
    bit for bit, or within ``TOL`` with the same greedy tokens where the
    eager top-2 gap exceeds it); every join and step is one replay, so
    ``n_executions`` equals the joins plus the ticks."""
    rp = SMOKE.replay_parity(get_config(arch, reduced=True),
                             torch.device("cuda"), prompt_len=48, gen_len=8)
    assert rp["replays"] == rp["calls"] == len(SMOKE.REPLAY_SCRIPT)


@pytest.mark.parametrize("arch", ["minicpm-2b", "whisper-tiny",
                                  "phi-3-vision-4.2b", "zamba2-1.2b"])
def test_model_instance_replays_equal_its_eager_bodies(cuda, arch,
                                                       monkeypatch):
    """``ModelInstance`` on the card: one prefill replay (frontend stub,
    encoder and shared blocks inside it) and ``gen_len`` step replays give
    the greedy tokens of an instance that runs its bodies eagerly on the
    same weights."""
    import numpy as np
    from repro_torch.serving import ServedModel, graphs
    from repro_torch.serving.executor import ModelInstance
    cfg = get_config(arch, reduced=True)
    served = ServedModel(cfg, prompt_len=24, gen_len=6)
    dev = torch.device("cuda")
    replayed = ModelInstance(served, dev)
    replayed.setup()
    monkeypatch.setattr(graphs, "graph_for", lambda device: None)
    eager = ModelInstance(served, dev, params=replayed.params)
    eager.setup()
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 24))
    r0 = graphs.CudaGraph.replays
    for inst in (replayed, eager):
        inst.run_tokens(tok)
    assert graphs.CudaGraph.replays - r0 == 1 + served.gen_len
    assert replayed.prefill_fn.graph is not None
    assert eager.prefill_fn.graph is None
    assert torch.equal(replayed.last_tokens, eager.last_tokens)


def test_a_capture_survives_the_collector_freeing_old_graphs(cuda,
                                                           monkeypatch):
    """An instance let go of in a reference cycle keeps its graphs until
    the cycle collector runs; a collection inside another instance's
    capture destroys them there, which a capturing stream refuses (the
    capture fails).  The old instance becomes garbage inside the new one's
    capture, with the collector set to run often: set-up still captures,
    and the instance serves."""
    import gc
    from repro_torch.serving import ServedModel, graphs
    from repro_torch.serving.executor import ModelInstance
    served = ServedModel(get_config("minicpm-2b", reduced=True),
                         prompt_len=24, gen_len=4)
    body, capture = ModelInstance._prefill, graphs.ProgramSet.capture
    held = []

    def letting_go(self, tokens):
        if held and torch.cuda.is_current_stream_capturing():
            held.clear()
            # live allocations, so that collections run
            junk = [[] for _ in range(5000)]
            del junk
        return body(self, tokens)

    def collecting_capture(self):
        gc.set_threshold(1, 1000)
        gc.enable()
        capture(self)

    threshold = gc.get_threshold()
    gc.disable()                # the old instance stays young until then
    try:
        held.append(ModelInstance(served, torch.device("cuda")))
        held[0].setup()
        # in a reference cycle, as the control plane's objects hold a
        # backend's executor: only the collector frees it
        held[0].cycle = held[0]
        monkeypatch.setattr(ModelInstance, "_prefill", letting_go)
        monkeypatch.setattr(graphs.ProgramSet, "capture", collecting_capture)
        new = ModelInstance(served, torch.device("cuda"))
        new.setup()
    finally:
        gc.set_threshold(*threshold)
        gc.enable()
    assert not held
    new.run(seed=1)
    assert new.prefill_fn.graph is not None and new.last_tokens.shape == (1, 5)


@pytest.mark.parametrize("arch", ["minicpm-2b", "mamba2-370m"])
def test_compiled_train_step_on_the_card_matches_the_eager_step(cuda, arch):
    """Four AdamW steps of the reduced model in float32 from the same
    weights, eager (``make_train_step``) and compiled
    (``CompiledTrainStep``: the first step warms up and captures, the
    other three are replays): the losses and the first step's first
    moments agree at the tolerance of
    ``test_train_step_on_the_card_matches_the_cpu``, the counter reads 4,
    and each replayed step counts its kernels' launches, twice a layer."""
    import numpy as np
    from repro_torch.serving import graphs
    from repro_torch.train import (CompiledTrainStep, adamw_init,
                                   make_train_step)
    from repro_torch.train.tree import leaves, map_with_path
    cfg = get_config(arch, reduced=True).with_(
        compute_dtype="float32", param_dtype="float32")
    p_cpu = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, cfg.vocab_size, (2, 40)) for _ in range(4)]
    op = "ssd" if arch == "mamba2-370m" else "attention"
    out = {}
    for kind in ("eager", "compiled"):
        p = map_with_path(lambda _, t: t.to("cuda"), p_cpu)
        opt = adamw_init(p)
        if kind == "eager":
            fn = make_train_step(cfg, total_steps=4, peak_lr=1e-3)
        else:
            compiled = CompiledTrainStep(cfg, p, opt, 2, 40, total_steps=4,
                                         peak_lr=1e-3)
        losses, r0 = [], graphs.CudaGraph.replays
        for i, b in enumerate(batches):
            before = ops.launch_counts()[op]
            if kind == "eager":
                p, opt, loss = fn(p, opt, torch.from_numpy(b).cuda())
            else:
                loss = compiled(b)
            losses.append(float(loss))
            assert ops.launch_counts()[op] - before == 2 * cfg.n_layers
            if i == 0:
                mu = [m.cpu() for m in leaves(opt.mu)]
        assert int(opt.step) == 4
        replays = graphs.CudaGraph.replays - r0
        assert replays == (3 if kind == "compiled" else 0)
        out[kind] = (torch.tensor(losses), mu)
    torch.testing.assert_close(out["compiled"][0], out["eager"][0],
                               rtol=2e-4, atol=0)
    for a, b in zip(out["compiled"][1], out["eager"][1]):
        assert ((a - b).abs().max() / b.abs().max()).item() <= 2e-4


@pytest.mark.parametrize("arch", ["minicpm-2b", "mamba2-370m"])
def test_the_tracer_times_a_replayed_step_inside_its_graph(cuda, arch):
    """With the tracer on from set-up, each step graph holds its body's
    marks (the executor's four, the model's around its one group) as timing
    events, replayed with it: a replayed step's gather, model, group and
    scatter phases are positive and lie inside its device interval, which
    lies inside the seconds it returned.  The same script on an
    executor set up with the tracer off (whose graphs hold no mark) makes
    the same tokens and the same launches per replay."""
    import numpy as np
    from repro_torch import trace
    from repro_torch.serving import ServedModel, graphs
    from repro_torch.serving.executor import ContinuousTorchExecutor
    cfg = get_config(arch, reduced=True)
    group = "mamba" if arch == "mamba2-370m" else "attn"
    served = {"gen": ServedModel(cfg, prompt_len=24, gen_len=4)}
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 24))
    out = {}
    for on in (True, False):
        trace.clear()
        trace.enable(on)
        try:
            ex = ContinuousTorchExecutor(served, max_batch=4, device="cuda")
            st = ex._ensure("gen")
            r0 = graphs.CudaGraph.replays
            ex._admit_tokens("gen", toks, [0, 1, 2])
            secs = [ex.step("gen", [0, 1, 2]) for _ in range(3)]
            assert graphs.CudaGraph.replays - r0 == 4
        finally:
            trace.enable(False)
        marks = st.steps[4].marks
        if on:
            assert [n for n, _ in marks] == ["gather", "model", group,
                                             "model", "scatter", "end"]
            assert all(isinstance(e, torch.cuda.Event) for _, e in marks)
            steps = [s for s in trace.spans() if s.name == "executor.step"]
            assert [s.end - s.start for s in steps] == secs
            for s in steps:
                assert list(s.phases) == ["gather", "model", group,
                                          "scatter"]
                assert all(v > 0 for v in s.phases.values())
                assert sum(s.phases.values()) < s.device_s < s.end - s.start
        else:
            assert marks == [] and trace.spans() == []
        out[on] = (st.tok.clone(), [p.launches for p in st.programs.programs])
    trace.clear()
    assert torch.equal(out[True][0], out[False][0])
    assert out[True][1] == out[False][1]


def test_a_profiled_replay_lies_inside_its_launch_range(cuda):
    """While a profile records, each replayed join and step mirrors its
    spans as ranges: every ``cudaGraphLaunch`` lies inside a ``launch``
    range, the counts agree, and every mirrored span pairs with a range."""
    import numpy as np
    from repro_torch import trace, trace_readings
    from repro_torch.serving import ServedModel
    from repro_torch.serving.executor import ContinuousTorchExecutor
    cfg = get_config("minicpm-2b", reduced=True)
    served = {"gen": ServedModel(cfg, prompt_len=24, gen_len=4)}
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 24))
    trace.clear()
    trace.enable()
    try:
        ex = ContinuousTorchExecutor(served, max_batch=4, device="cuda")
        ex._ensure("gen")
        trace.clear()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            ex._admit_tokens("gen", toks, [0, 1, 2])
            for _ in range(3):
                ex.step("gen", [0, 1, 2])
    finally:
        trace.enable(False)
    dev, host = trace_readings.profile_events(prof)
    got = trace_readings.profile_readings(dev, host)
    assert got["graph_launches"] == got["launch_ranges"] == \
        got["graph_launches_in_launch"] == 4
    clock = trace_readings.clock_agreement(trace.spans(), host)
    trace.clear()
    assert clock["pairs"] == 4 * 4 and clock["unequal"] == []
    assert clock["excess_us"][0] > 0


# (B, R, L, Hq, Hkv, hd): a decode of B rows over a cache of R rows, at hd
# 64 (minicpm-2b), 96 (phi-3), 128 (G 4 and, on the CUDA cores, G 1) and
# 256 (gemma3-1b, at bucket 2 and at batch 1 over 32k keys, combined by
# tickets)
ROWS_CASES = [(4, 8, 544, 36, 36, 64), (8, 8, 544, 36, 36, 64),
              (4, 8, 544, 32, 32, 96), (4, 8, 544, 32, 8, 128),
              (3, 6, 300, 8, 8, 128), (2, 5, 544, 4, 1, 256),
              (1, 3, 32768, 4, 1, 256)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ROWS_CASES, ids=str)
def test_decode_attention_through_rows_equals_the_gathered_cache(cuda, case,
                                                                 dtype):
    """``rows`` on both bodies (bf16 on the tensor cores where
    ``decode_instance`` says so, float32 and bf16 hd 128 at G 1 on the
    CUDA cores): query row b over cache row rows[b] of R > B rows equals
    the same launch on ``k.index_select(0, rows)`` bit for bit, with rows
    permuted, a row repeated and a row at valid_len 0 (zeros)."""
    B, R, L, Hq, Hkv, hd = case
    q = torch.randn(B, Hq, hd, generator=cuda, device="cuda").to(dtype)
    k = torch.randn(R, L, Hkv, hd, generator=cuda, device="cuda").to(dtype)
    v = torch.randn(R, L, Hkv, hd, generator=cuda, device="cuda").to(dtype)
    perm = torch.randperm(R, generator=cuda, device="cuda")[:B]
    if B > 1:
        perm[-1] = perm[0]
    rows = perm.to(torch.int32).contiguous()
    vlen = torch.randint(1, L + 1, (B,), generator=cuda, device="cuda",
                         dtype=torch.int32)
    if B > 2:
        vlen[1] = 0
    got = decode_attention(q, k, v, vlen, rows=rows)
    ids = rows.long()
    want = decode_attention(q, k.index_select(0, ids).contiguous(),
                            v.index_select(0, ids).contiguous(), vlen)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if B > 2:
        assert got[1].abs().max().item() == 0.0
    _close_rows(got, decode_attention_plain(q, k, v, vlen, rows), dtype)
    with pytest.raises(ValueError, match="rows"):
        decode_attention(q, k, v, vlen, rows=ids)


def _gathered_step(st, ids):
    """The step as the reference's executor takes it (every slab leaf's
    rows gathered, decoded into, scattered back) on ``st``'s state."""
    ids = ids.long()
    sub = {"layers": [{k: t.index_select(1, ids) for k, t in e.items()}
                      for e in st.slab["layers"]]}
    pos, tok = st.pos.index_select(0, ids), st.tok.index_select(0, ids)
    lg, c = decode_step_ragged(st.served.cfg, st.params, sub, tok, pos)
    for se, ce in zip(st.slab["layers"], c["layers"]):
        for k in se:
            se[k].index_copy_(1, ids, ce[k])
    st.tok.index_copy_(0, ids, torch.argmax(lg, -1).to(torch.int32))
    st.pos.index_copy_(0, ids, pos + 1)
    return lg


@pytest.mark.parametrize("arch", ["minicpm-2b", "gemma3-1b", "zamba2-1.2b"])
def test_a_replayed_step_through_slot_ids_matches_the_eager_steps(cuda,
                                                                  arch):
    """The continuous executor's step on the card, decoding against the
    slab's full-attention K/V in place: its body run eagerly equals the
    gather-step-scatter step bit for bit (logits, slab, tokens,
    positions), and its replayed graph equals that eager body, bit for bit
    or within TOL with the same greedy tokens (``chip_smoke.replay_parity``'s
    rule), at buckets 4 (padded), 1 and 8 (padded)."""
    import dataclasses

    import numpy as np
    from repro_torch.serving import ServedModel
    from repro_torch.serving.executor import ContinuousTorchExecutor
    cfg = get_config(arch, reduced=True)
    ex = ContinuousTorchExecutor(
        {"gen": ServedModel(cfg, prompt_len=48, gen_len=8)}, max_batch=8,
        device="cuda")
    st = ex._ensure("gen")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 48))
    ex._admit_tokens("gen", toks, list(range(8)))
    ex.step("gen", list(range(8)))

    def snapshot():
        return dataclasses.replace(
            st, slab={"layers": [{k: t.clone() for k, t in e.items()}
                                 for e in st.slab["layers"]]},
            tok=st.tok.clone(), pos=st.pos.clone())

    tol = TOL[cfg.dtype()]
    for slots in ([6, 1, 3], [2], [0, 2, 4, 6, 7]):
        b, padded = ex._pad_slots(slots)
        ids = torch.tensor(padded, dtype=torch.int32, device="cuda")
        eager, gathered = snapshot(), snapshot()
        lg = ContinuousTorchExecutor._step(eager, ids)
        lg_gathered = _gathered_step(gathered, ids)
        ex.step("gen", slots)
        torch.cuda.synchronize()
        assert torch.equal(lg, lg_gathered)
        assert torch.equal(eager.tok, gathered.tok)
        assert torch.equal(eager.pos, gathered.pos)
        for e, g in zip(eager.slab["layers"], gathered.slab["layers"]):
            for k in e:
                assert torch.equal(e[k], g[k]), k
        replayed = st.steps[b].outputs
        assert torch.equal(st.pos, eager.pos)
        if not torch.equal(replayed, lg):
            torch.testing.assert_close(replayed.float(), lg.float(),
                                       rtol=tol, atol=tol)
            top = lg.float().topk(2, dim=-1).values
            sure = (top[..., 0] - top[..., 1]) > tol + tol * top[..., 0].abs()
            assert torch.equal(replayed.argmax(-1)[sure], lg.argmax(-1)[sure])
        for e, g in zip(st.slab["layers"], eager.slab["layers"]):
            for k in e:
                torch.testing.assert_close(e[k].float(), g[k].float(),
                                           rtol=tol, atol=tol)
