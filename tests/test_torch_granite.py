"""granite-4.0-h-micro, the port's first config with no JAX twin, on the
CPU: its layer groups from the published pattern, the slab's split of
K/V (in place) from SSM state and conv inputs (copied), the tracer's
readings of a hybrid step, and prefill plus ragged decode steps through
the slab's rows against the benchmark's plain reference
(``portbench/reference/granite_hybrid.py``), on weights drawn from a seed.
"""
import json
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import trace, trace_readings
from repro_torch.configs import (ARCH_IDS, PORT_ONLY_IDS, all_configs,
                                 get_config)
from repro_torch.models import (decode_step_ragged, in_place_leaves,
                                init_cache, init_params, prefill)
from repro_torch.serving.executor import (ContinuousTorchExecutor,
                                          ServedModel)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import weights as wts  # noqa: E402
from portbench.cells import dims  # noqa: E402
from portbench.reference import granite_hybrid as ref  # noqa: E402

ARCH = "granite-4.0-h-micro"
FILE = json.loads((ROOT / "portbench/configs/granite-4.0-h-micro.json")
                  .read_text())
MB = 1e6


def test_granite_is_registered_beside_the_jax_twins():
    assert ARCH in PORT_ONLY_IDS and ARCH not in ARCH_IDS
    assert ARCH not in all_configs()
    assert get_config(ARCH).name == ARCH
    with pytest.raises(KeyError, match="granite-4.0-h-micro"):
        get_config("granite-4.0-h-nano")


def test_groups_follow_the_published_layer_types():
    cfg = get_config(ARCH)
    assert cfg.layer_type_list == FILE["layer_types"]
    got = [(g.kind, g.count, g.mlp) for g in cfg.groups()]
    m, a = ("mamba", True), ("attn", False)
    assert got == [(k, n, mlp) for (k, mlp), n in
                   [(m, 5), (a, 1), (m, 9), (a, 1), (m, 9), (a, 1), (m, 9),
                    (a, 1), (m, 4)]]
    assert [g.window for g in cfg.groups()] == [0] * 9
    # each attention layer its own weights: no shared block
    params = init_params(cfg, device="meta")
    assert "shared_attn" not in params
    assert [sorted(gp) for gp in params["groups"][1::2]] == [
        ["ln1", "ln2", "w_down", "w_gate", "w_up", "wk", "wo", "wq",
         "wv"]] * 4
    assert params["groups"][2]["w_up"].shape == (9, 2048, 8192)
    assert params["groups"][2]["in_proj"].shape == (9, 2048, 8512)
    assert (cfg.hd, cfg.n_heads // cfg.n_kv_heads, cfg.n_ssm_heads,
            cfg.d_inner) == (64, 4, 64, 4096)
    assert cfg.param_count() == pytest.approx(3.19e9, rel=2e-3)


def test_the_reduced_config_keeps_every_kind_of_layer_and_gqa():
    cfg = get_config(ARCH, reduced=True)
    kinds = [(g.kind, g.count) for g in cfg.groups()]
    assert kinds == [("mamba", 1), ("attn", 1), ("mamba", 2), ("attn", 1),
                     ("mamba", 1)]
    assert cfg.n_heads // cfg.n_kv_heads == 2 and cfg.nope
    full = get_config(ARCH)
    for f in ("attention_multiplier", "embedding_multiplier",
              "residual_multiplier", "logits_scaling", "norm_eps", "hd"):
        assert getattr(cfg, f) == getattr(full, f), f
    assert dims(FILE, smoke=True) == {
        f: getattr(cfg, f) for f in FILE["smoke"]}


def test_slab_bytes_put_kv_in_place_and_copy_state_and_conv():
    """At the cell's sizes (bucket 8, 8192 + 256 positions) a slab row
    holds 69.2 MB of K/V that a step addresses in place and 76.4 MB of
    SSM state and conv inputs that it copies."""
    cfg = get_config(ARCH)
    slab = init_cache(cfg, 8, 8448, "meta")
    st = type("St", (), {"served": ServedModel(cfg, 8192, 256),
                         "slab": slab, "cap": 8})()
    got = ContinuousTorchExecutor._slab_bytes(st, 8)
    kv = 4 * 2 * 8448 * 8 * 64 * 2
    state = 36 * (64 * 64 * 128 * 4 + 3 * (4096 + 256) * 2)
    assert got == {"in_place_bytes": 8 * kv, "copied_bytes": 8 * state}
    assert (kv / MB, state / MB) == (pytest.approx(69.2, abs=0.05),
                                     pytest.approx(76.4, abs=0.05))
    assert 100 * kv / (kv + state) == pytest.approx(47.5, abs=0.05)
    assert [in_place_leaves(g) for g in cfg.groups()] == [
        (), ("k", "v")] * 4 + [()]


# -- the program against the plain reference ---------------------------------

R, MAX_LEN = 4, 40
PROMPTS = {0: 9, 1: 16, 2: 5, 3: 12}          # slot -> prompt length
# steps: the slots stepped, in the order of the bucket's rows
STEPS = [[2, 0, 3, 1], [3, 1], [1, 2, 0], [0, 3, 2, 1], [2, 1], [3, 0, 2]]


def _program(dtype):
    cfg = get_config(ARCH, reduced=True).with_(compute_dtype=dtype,
                                               param_dtype=dtype)
    d = dims(FILE, smoke=True)
    w = wts.fill(ref.leaves(d), 20260, torch.device("cpu"))
    params = init_params(cfg, device="cpu")
    for path, t in w.items():
        wts.at(params, path).copy_(t)
    return cfg, d, w, params


def _serve(cfg, params, seed):
    """Prefill each slot's prompt into its slab row alone, then the ragged
    steps of ``STEPS`` through the slab's rows, K/V in place and the Mamba
    leaves gathered and scattered as the executor's step takes them.
    Returns each slot's tokens and the program's logits per position."""
    g = torch.Generator().manual_seed(seed)
    slab = init_cache(cfg, R, MAX_LEN, "cpu")
    seqs, out = {}, {}
    for s, P in PROMPTS.items():
        toks = torch.randint(0, cfg.vocab_size, (1, P), generator=g)
        one = init_cache(cfg, 1, MAX_LEN, "cpu")
        lg, one = prefill(cfg, params, toks, one)
        for se, ce in zip(slab["layers"], one["layers"]):
            for k in se:
                se[k][:, s].copy_(ce[k][:, 0])
        seqs[s] = toks[0].tolist()
        out[(s, P - 1)] = lg[0, 0]
    kept = [in_place_leaves(gr) for gr in cfg.groups()]
    for slots in STEPS:
        ids = torch.tensor(slots)
        tok = torch.randint(0, cfg.vocab_size, (len(slots), 1), generator=g)
        pos = torch.tensor([len(seqs[s]) for s in slots], dtype=torch.int32)
        sub = {"layers": [{k: t if k in keep else t.index_select(1, ids)
                           for k, t in e.items()}
                          for e, keep in zip(slab["layers"], kept)]}
        lg, c2 = decode_step_ragged(cfg, params, sub, tok, pos,
                                    rows=ids.int())
        for se, ce, keep in zip(slab["layers"], c2["layers"], kept):
            for k in se:
                if k not in keep:
                    se[k].index_copy_(1, ids, ce[k])
        for b, s in enumerate(slots):
            seqs[s].append(int(tok[b, 0]))
            out[(s, len(seqs[s]) - 1)] = lg[b, 0]
    return seqs, out


def _rel_errs(d, w, seqs, out):
    errs = []
    for s, toks in seqs.items():
        want = ref.logits(d, w, torch.tensor([toks]), len(toks))[0]
        for (s2, p), got in out.items():
            if s2 == s:
                e = (got.float() - want[p]).norm() / want[p].norm()
                errs.append(float(e))
    return errs


@pytest.mark.parametrize("dtype, tol", [
    # the same function in the same precision: the chunked scan against
    # the quadratic form, sums in other orders (measured <= 1.4e-6)
    ("float32", 1e-5),
    # the configuration's precision: every product's inputs and the
    # residual stream rounded to bf16 (measured <= 0.027); the fp8
    # control reads 0.18-0.22 (the next test)
    ("bfloat16", 0.06),
], ids=["float32", "bfloat16"])
def test_prefill_and_ragged_steps_through_rows_match_the_reference(dtype,
                                                                   tol):
    """Per position, the norm of the program's logits' difference from
    the reference's full forward over the norm of the reference's: the
    prompts' last positions (prefill) and every position a ragged step
    made, with slots out of order, rows at different depths and buckets
    of 2 to 4."""
    torch.manual_seed(0)
    cfg, d, w, params = _program(dtype)
    seqs, out = _serve(cfg, params, 7)
    assert len(out) == len(PROMPTS) + sum(map(len, STEPS))
    errs = _rel_errs(d, w, seqs, out)
    assert len(errs) == len(out)
    assert max(errs) <= tol, max(errs)


def test_the_reference_tells_the_bf16_program_from_the_fp8_control():
    """The fp8 control (every product's inputs rounded to e4m3) lies
    further from the float32 reference than the bf16 program does: its
    worst position by more than four times the program's worst."""
    cfg, d, w, params = _program("bfloat16")
    seqs, out = _serve(cfg, params, 7)
    prog = max(_rel_errs(d, w, seqs, out))
    fp8 = []
    for s, toks in seqs.items():
        t = torch.tensor([toks])
        a = ref.logits(d, w, t, len(toks), quant="fp8")[0]
        b = ref.logits(d, w, t, len(toks))[0]
        fp8.append(float(((a - b).norm(dim=-1) / b.norm(dim=-1)).max()))
    assert max(fp8) > 4 * prog, (max(fp8), prog)


# -- the tracer on a hybrid step --------------------------------------------

def test_a_traced_hybrid_step_reads_its_groups_and_a_split_slab():
    cfg = get_config(ARCH, reduced=True).with_(compute_dtype="float32",
                                               param_dtype="float32")
    served = {"gen": ServedModel(cfg, prompt_len=8, gen_len=4)}
    trace.clear()
    trace.enable()
    try:
        ex = ContinuousTorchExecutor(served, max_batch=4, device="cpu")
        ex._ensure("gen")
        trace.clear()
        ex._admit_tokens("gen", torch.arange(24).reshape(3, 8).numpy(),
                         [0, 1, 2])
        ex.step("gen", [2, 0, 1])
        ex.step("gen", [1, 2])
        spans = trace.spans()
    finally:
        trace.enable(False)
        trace.clear()
    steps = [s for s in spans if s.name == "executor.step"]
    assert len(steps) == 2
    for s in steps:
        assert list(s.phases) == ["gather", "model", "mamba", "attn",
                                  "scatter"]
        assert all(v > 0 for v in s.phases.values())
    got = trace_readings.summarize(spans)
    assert got["step_mamba_ms"] > 0 and got["step_attn_ms"] > 0
    assert 0 < got["slab_in_place_pct"] < 100
