"""A decode step against the serving slab in place, on the CPU.

``decode_step_ragged(..., rows=...)`` reads and writes a full-attention
group's K/V in the slab itself through the slot ids, where the reference's
executor gathers a private copy of every leaf's rows, decodes into it and
scatters it back.  Here the two are held equal bit for bit in float32, for
a dense model (minicpm-2b), one with sliding-window rings beside its global
layers (gemma3-1b) and a hybrid (zamba2-1.2b), at a bucket smaller than the
slab, over permuted slots and in a padded bucket whose first slot repeats;
the plain ``decode_attention`` with ``rows``; the continuous executor's step
against the gather-and-scatter step; and the tracer's byte counts a step
carries.  The kernel's own ``rows`` is held on the card
(``tests/test_torch_cuda.py``)."""
import pytest
import torch

from repro_torch import trace, trace_readings
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.kernels.ref import decode_attention_ref
from repro_torch.models import (decode_step_ragged, in_place_leaves,
                                init_cache, init_params, prefill)
from repro_torch.serving.executor import (ContinuousTorchExecutor,
                                          ServedModel)

F32 = dict(compute_dtype="float32", param_dtype="float32")
ARCHS = ["minicpm-2b", "gemma3-1b", "zamba2-1.2b"]
R, P, MAX_LEN = 8, 12, 80       # past the reduced windows (64)
# (slots, positions): a bucket of 4 over 8 slots at four depths, the slots
# permuted; a bucket of 2; a padded bucket of 4 whose last two rows repeat
# its first slot
CASES = {"smaller": ([1, 3, 4, 6], [12, 30, 70, 13]),
         "permuted": ([6, 0, 7, 2], [40, 12, 66, 21]),
         "padded": ([5, 2, 5, 5], [20, 70, 20, 20])}


def _cfg(arch):
    return get_config(arch, reduced=True).with_(**F32)


def _clone(cache):
    return {"layers": [{k: t.clone() for k, t in e.items()}
                       for e in cache["layers"]]}


def _slab(cfg, params, seed):
    """R sequences prefilled over P tokens, then every slot written at every
    later position with noise, so that any position a step reads holds
    something of its own."""
    g = torch.Generator().manual_seed(seed)
    slab = init_cache(cfg, R, MAX_LEN, "cpu")
    prefill(cfg, params, torch.randint(0, cfg.vocab_size, (R, P),
                                       generator=g), slab)
    for e in slab["layers"]:
        for t in e.values():
            t.add_(0.1 * torch.randn(t.shape, generator=g, dtype=t.dtype))
    return slab


def _gathered_step(cfg, params, slab, tok, pos, ids):
    """The step as the reference's executor takes it: gather every leaf's
    rows, decode into the copy, scatter the copy back."""
    sub = {"layers": [{k: t.index_select(1, ids) for k, t in e.items()}
                      for e in slab["layers"]]}
    lg, c = decode_step_ragged(cfg, params, sub, tok, pos)
    for se, ce in zip(slab["layers"], c["layers"]):
        for k in se:
            se[k].index_copy_(1, ids, ce[k])
    return lg


def _in_place_step(cfg, params, slab, tok, pos, rows):
    """The step in place: the leaves ``in_place_leaves`` names are the slab
    itself, the others a gathered copy scattered back."""
    ids = rows.long()
    kept = [in_place_leaves(g) for g in cfg.groups()]
    sub = {"layers": [{k: t if k in keep else t.index_select(1, ids)
                       for k, t in e.items()}
                      for e, keep in zip(slab["layers"], kept)]}
    lg, c = decode_step_ragged(cfg, params, sub, tok, pos, rows=rows)
    for se, ce, keep in zip(slab["layers"], c["layers"], kept):
        for k in se:
            if k not in keep:
                se[k].index_copy_(1, ids, ce[k])
    return lg


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_a_step_through_slab_rows_equals_gather_step_scatter(arch, case):
    cfg = _cfg(arch)
    params = init_params(cfg, 3, "cpu")
    slab = _slab(cfg, params, 4)
    slots, positions = CASES[case]
    rows = torch.tensor(slots, dtype=torch.int32)
    pos = torch.tensor(positions, dtype=torch.int32)
    tok = torch.randint(0, cfg.vocab_size, (len(slots), 1),
                        generator=torch.Generator().manual_seed(5))
    # a repeated slot carries its first row's token, as the executor's
    # padding does
    first = {s: i for i, s in reversed(list(enumerate(slots)))}
    tok = tok[[first[s] for s in slots]]
    ref, got = _clone(slab), _clone(slab)
    lg_ref = _gathered_step(cfg, params, ref, tok, pos, rows.long())
    lg = _in_place_step(cfg, params, got, tok, pos, rows)
    assert torch.equal(lg, lg_ref)
    for e, er in zip(got["layers"], ref["layers"]):
        for k in e:
            assert torch.equal(e[k], er[k]), k
    # the step wrote each slot's new position, and no other slot's
    for e, e0 in zip(got["layers"], slab["layers"]):
        if "k" in e and e["k"].shape[2] == MAX_LEN:
            others = [s for s in range(R) if s not in slots]
            assert torch.equal(e["k"][:, others], e0["k"][:, others])
            assert not torch.equal(e["k"][:, slots[0], positions[0]],
                                   e0["k"][:, slots[0], positions[0]])


def test_every_arch_keeps_only_full_attention_k_v_in_place():
    kinds = {a: [in_place_leaves(g) for g in _cfg(a).groups()]
             for a in ARCHS + ["mamba2-370m"]}
    assert kinds["minicpm-2b"] == [("k", "v")]
    assert ("k", "v") in kinds["gemma3-1b"] and () in kinds["gemma3-1b"]
    assert ("k", "v") in kinds["zamba2-1.2b"] and () in kinds["zamba2-1.2b"]
    assert kinds["mamba2-370m"] == [()]


@pytest.mark.parametrize("rows", [[5, 0, 9, 2], [3, 3, 3, 7], [0, 1, 2, 3]],
                         ids=["permuted", "duplicates", "identity"])
@pytest.mark.parametrize("G", [1, 4])
def test_plain_decode_attention_reads_cache_row_rows_b(rows, G):
    """q (B,Hq,hd) over a cache of R > B rows: row b attends over cache row
    rows[b], a valid_len 0 row comes out as zeros, and ``decode_attention``
    on the CPU is that plain version."""
    g = torch.Generator().manual_seed(G)
    B, Rr, L, Hkv, hd = 4, 10, 37, 2, 64
    q = torch.randn(B, Hkv * G, hd, generator=g)
    k = torch.randn(Rr, L, Hkv, hd, generator=g)
    v = torch.randn(Rr, L, Hkv, hd, generator=g)
    vlen = torch.tensor([37, 1, 0, 20], dtype=torch.int32)
    r = torch.tensor(rows, dtype=torch.int32)
    out = decode_attention_plain(q, k, v, vlen, r)
    want = decode_attention_plain(q, k[rows], v[rows], vlen)
    assert torch.equal(out, want)
    assert torch.equal(decode_attention(q, k, v, vlen, rows=r), out)
    assert out[2].abs().max().item() == 0.0
    for b in (0, 1, 3):
        one = decode_attention_ref(q[b:b + 1], k[rows[b]:rows[b] + 1],
                                   v[rows[b]:rows[b] + 1], vlen[b:b + 1])
        torch.testing.assert_close(out[b:b + 1], one, rtol=0, atol=1e-6)


def _served(arch, max_batch=8):
    cfg = _cfg(arch)
    return ContinuousTorchExecutor(
        {"gen": ServedModel(cfg, prompt_len=P, gen_len=6)},
        max_batch=max_batch, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_the_executor_steps_equal_gather_step_scatter(arch):
    """Joins and steps at buckets 8, 4, 2 and 1, padded ones among them,
    against the same steps taken by gathering every leaf and scattering it
    back: the slab, tokens and positions equal bit for bit."""
    ex = _served(arch)
    st = ex._ensure("gen")
    cfg = st.served.cfg
    g = torch.Generator().manual_seed(11)
    ref = None

    def ref_step(slots):
        b, padded = ex._pad_slots(slots)
        ids = torch.tensor(padded)
        pos = ref["pos"].index_select(0, ids)
        tok = ref["tok"].index_select(0, ids)
        lg = _gathered_step(cfg, st.params, ref["slab"], tok, pos, ids)
        ref["tok"].index_copy_(0, ids, torch.argmax(lg, -1).to(torch.int32))
        ref["pos"].index_copy_(0, ids, pos + 1)

    script = [("join", list(range(8))), ("step", list(range(8))),
              ("step", [6, 1, 3]), ("join", [4, 2]), ("step", [2, 4, 5]),
              ("step", [7]), ("step", [0, 2, 4, 6, 7]), ("step", [3, 1])]
    for op, slots in script:
        if op == "join":
            ex._admit_tokens("gen", torch.randint(
                0, cfg.vocab_size, (len(slots), P), generator=g).numpy(),
                slots)
            ref = {"slab": _clone(st.slab), "tok": st.tok.clone(),
                   "pos": st.pos.clone()}
            continue
        ex.step("gen", slots)
        ref_step(slots)
        assert torch.equal(st.tok, ref["tok"])
        assert torch.equal(st.pos, ref["pos"])
        for e, er in zip(st.slab["layers"], ref["slab"]["layers"]):
            for k in e:
                assert torch.equal(e[k], er[k]), k
    assert ex.logits_finite("gen")


@pytest.fixture
def tracing():
    trace.clear()
    trace.enable()
    yield
    trace.enable(False)
    trace.clear()


@pytest.mark.parametrize("arch, want", [("minicpm-2b", 100.0),
                                        ("mamba2-370m", 0.0),
                                        ("zamba2-1.2b", None)])
def test_a_traced_step_carries_the_slab_bytes_it_addressed(tracing, arch,
                                                           want):
    """A step span's bytes in place and copied are its bucket's rows of the
    slab leaves ``in_place_leaves`` names and of the others; a join's are
    zero.  ``slab_in_place_pct`` reads 100 for a dense model, 0 for a pure
    SSM and between them for a hybrid."""
    ex = _served(arch, max_batch=4)
    st = ex._ensure("gen")
    cfg = st.served.cfg
    trace.clear()
    toks = torch.randint(0, cfg.vocab_size, (3, P)).numpy()
    ex._admit_tokens("gen", toks, [0, 1, 2])
    ex.step("gen", [0, 1, 2])
    ex.step("gen", [2])
    row = {"in_place_bytes": 0, "copied_bytes": 0}
    for grp, e in zip(cfg.groups(), st.slab["layers"]):
        for k, t in e.items():
            kind = ("in_place_bytes" if k in in_place_leaves(grp)
                    else "copied_bytes")
            row[kind] += t[:, 0].numel() * t.element_size()
    calls = [s for s in trace.spans() if s.name.startswith("executor.")]
    assert [(s.name, s.bucket) for s in calls] == [
        ("executor.join", 4), ("executor.step", 4), ("executor.step", 1)]
    assert calls[0].in_place_bytes == calls[0].copied_bytes == 0
    for s in calls[1:]:
        assert s.in_place_bytes == s.bucket * row["in_place_bytes"]
        assert s.copied_bytes == s.bucket * row["copied_bytes"]
    pct = trace_readings.summarize(trace.spans())["slab_in_place_pct"]
    if want is None:
        assert 0.0 < pct < 100.0
        assert pct == pytest.approx(100.0 * row["in_place_bytes"]
                                    / sum(row.values()))
    else:
        assert pct == want
