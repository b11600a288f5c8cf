"""Every architecture of the zoo, reduced, through the port and the JAX
package on the CPU: the same bridged weights, numpy-seeded tokens and
frontend embeddings, float32, held at the model-logit tolerance of
tests/test_kernel_dispatch.py.  ``forward``, ``prefill`` (its caches too)
and ``decode_step`` / ``decode_step_ragged``, on a prompt longer than
gemma3's and mixtral's reduced windows (64), so that their rings wrap.
Also the VLM's cache-width property of the reference, and the executors'
frontend stub."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import decode_step_ragged as j_ragged  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.serving import executor as jexec  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models import (decode_step, decode_step_ragged,  # noqa: E402
                                forward, init_cache, params_from_numpy,
                                prefill)
from repro_torch.serving import executor as texec  # noqa: E402

F32 = dict(compute_dtype="float32", param_dtype="float32")
TOL = dict(rtol=2e-4, atol=2e-4)
S = 72          # past the reduced windows of gemma3 and mixtral (64)
GEN = 4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _setup(arch, seed=0):
    jc = j_get_config(arch, reduced=True).with_(**F32)
    tc = get_config(arch, reduced=True).with_(**F32)
    jp = j_init_params(jc, jax.random.PRNGKey(seed))
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(seed + 1)
    toks = rng.integers(0, tc.vocab_size, (2, S))
    fe = None
    if tc.frontend:
        fe = rng.standard_normal((2, tc.n_frontend_tokens, tc.d_model)
                                 ).astype(np.float32)
    return jc, tc, jp, tp, toks, fe


def _jfe(fe):
    return None if fe is None else jnp.asarray(fe)


def _tfe(fe):
    return None if fe is None else torch.from_numpy(fe)


def _assert_caches(ct, cj):
    assert len(ct["layers"]) == len(cj["layers"])
    for et, ej in zip(ct["layers"], cj["layers"]):
        assert set(et) == set(ej)
        for key in et:
            assert tuple(et[key].shape) == tuple(ej[key].shape), key
            np.testing.assert_allclose(_np(et[key]), _np(ej[key]), **TOL,
                                       err_msg=key)


def _clone(cache):
    return {"layers": [{k: t.clone() for k, t in e.items()}
                       for e in cache["layers"]]}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches_jax(arch):
    jc, tc, jp, tp, toks, fe = _setup(arch)
    lj, auxj = j_forward(jc, jp, jnp.asarray(toks, jnp.int32), _jfe(fe))
    lt, auxt = forward(tc, tp, torch.from_numpy(toks), _tfe(fe))
    extra = (tc.n_frontend_tokens
             if tc.frontend and tc.arch_type != "encdec" else 0)
    assert lt.shape == (2, S + extra, tc.vocab_padded)
    np.testing.assert_allclose(_np(lt), _np(lj), **TOL)
    np.testing.assert_allclose(float(auxt), float(auxj), **TOL)
    assert (float(auxt) > 0) == bool(tc.n_experts)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_and_decode_match_jax(arch):
    jc, tc, jp, tp, toks, fe = _setup(arch)
    max_len = S + GEN
    lgj, cj = j_prefill(jc, jp, jnp.asarray(toks, jnp.int32),
                        j_init_cache(jc, 2, max_len), _jfe(fe))
    lgt, ct = prefill(tc, tp, torch.from_numpy(toks),
                      init_cache(tc, 2, max_len, "cpu"), _tfe(fe))
    np.testing.assert_allclose(_np(lgt), _np(lgj), **TOL)
    _assert_caches(ct, cj)

    tok = np.asarray(jnp.argmax(lgj, axis=-1)).astype(np.int32)
    # uniform steps, as the per-invocation executors run them
    cu, cju, tku = _clone(ct), cj, tok
    for i in range(2):
        l1j, cju = j_decode_step(jc, jp, cju, jnp.asarray(tku),
                                 jnp.int32(S + i))
        l1t, cu = decode_step(tc, tp, cu, torch.from_numpy(tku), S + i)
        np.testing.assert_allclose(_np(l1t), _np(l1j), **TOL)
        tku = np.asarray(jnp.argmax(l1j, axis=-1)).astype(np.int32)
    _assert_caches(cu, cju)
    # ragged rows at other depths, as continuous batching runs them
    t = np.array([S, S - 3], np.int32)
    l2j, c2j = j_ragged(jc, jp, cj, jnp.asarray(tok), jnp.asarray(t))
    l2t, c2t = decode_step_ragged(tc, tp, _clone(ct), torch.from_numpy(tok),
                                  torch.from_numpy(t))
    np.testing.assert_allclose(_np(l2t), _np(l2j), **TOL)
    _assert_caches(c2t, c2j)


def test_zamba2_shares_one_attention_block_across_its_groups():
    """``config.groups()`` puts a shared block after every full run of
    ``shared_attn_every`` Mamba layers, the last one too; all of them run
    ``params["shared_attn"]``, each with its own cache entry."""
    jc, tc, jp, tp, toks, fe = _setup("zamba2-1.2b")
    kinds = [(g.kind, g.count) for g in tc.groups()]
    assert kinds == [("mamba", 2), ("shared_attn", 1)] * 2
    assert [g for g in tp["groups"] if not g] == [{}, {}]
    assert tp["shared_attn"]["wq"].dim() == 2       # one unstacked layer
    _, cache = prefill(tc, tp, torch.from_numpy(toks),
                       init_cache(tc, 2, S + GEN, "cpu"))
    k1, k2 = (cache["layers"][i]["k"] for i in (1, 3))
    assert k1.shape == k2.shape and not torch.equal(k1, k2)
    # the one block is the shared block: perturbing it moves the output
    tp2 = dict(tp, shared_attn={k: v.clone()
                                for k, v in tp["shared_attn"].items()})
    tp2["shared_attn"]["wo"] += 0.1
    a, _ = forward(tc, tp, torch.from_numpy(toks))
    b, _ = forward(tc, tp2, torch.from_numpy(toks))
    assert not torch.allclose(a, b)


def test_vlm_prefill_wraps_its_frontend_into_the_full_cache_as_jax_does():
    """A property of the reference, copied as it is: the VLM prefills
    F + S_text positions into a full-attention cache of width
    prompt_len + gen_len.  Past that width the ring keeps the last W
    positions at slot pos mod W, and the decode step at t = S_text reads
    slots [0, t] as a prefix (t + 1 keys)."""
    jc, tc, jp, tp, toks, fe = _setup("phi-3-vision-4.2b")
    F = tc.n_frontend_tokens
    W = S + GEN                         # what the executors allocate
    assert F + S > W
    wide = init_cache(tc, 2, F + S + GEN, "cpu")
    _, wide = prefill(tc, tp, torch.from_numpy(toks), wide, _tfe(fe))
    _, ring = prefill(tc, tp, torch.from_numpy(toks),
                      init_cache(tc, 2, W, "cpu"), _tfe(fe))
    pos = np.arange(F + S - W, F + S)
    for key in ("k", "v"):
        got = ring["layers"][0][key][:, :, pos % W]
        torch.testing.assert_close(got, wide["layers"][0][key][:, :, pos],
                                   rtol=0, atol=0)
    # the step at t = S: the JAX package's mask over the ring, slots <= t
    lgj, cj = j_prefill(jc, jp, jnp.asarray(toks, jnp.int32),
                        j_init_cache(jc, 2, W), _jfe(fe))
    tok = np.asarray(jnp.argmax(lgj, axis=-1)).astype(np.int32)
    l1j, _ = j_decode_step(jc, jp, cj, jnp.asarray(tok), jnp.int32(S))
    l1t, _ = decode_step(tc, tp, ring, torch.from_numpy(tok), S)
    np.testing.assert_allclose(_np(l1t), _np(l1j), **TOL)


def test_encoder_decoder_needs_its_frames_and_a_cache_that_fits_them():
    _, tc, _, tp, toks, fe = _setup("whisper-tiny")
    with pytest.raises(ValueError, match="frontend frames"):
        forward(tc, tp, torch.from_numpy(toks))
    with pytest.raises(ValueError, match="enc_len"):
        prefill(tc, tp, torch.from_numpy(toks),
                init_cache(tc, 2, S + GEN, "cpu", enc_len=8), _tfe(fe))
    c = init_cache(tc, 2, S + GEN, "cpu", enc_len=5)
    assert c["layers"][0]["xk"].shape == (2, 2, 5, tc.n_kv_heads, tc.hd)


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "whisper-tiny"])
def test_model_instance_feeds_the_frontend_stub_as_jax_does(arch):
    """The per-invocation executor passes zero frontend embeddings (batch,
    n_frontend_tokens, d_model) on set-up and every run, as JAX's
    ``ModelInstance`` does: the same greedy tokens on the same weights."""
    P, G = 6, 3
    jc = j_get_config(arch, reduced=True).with_(**F32)
    tc = get_config(arch, reduced=True).with_(**F32)
    jinst = jexec.ModelInstance(jexec.ServedModel(jc, prompt_len=P,
                                                  gen_len=G))
    jinst.setup()
    inst = texec.ModelInstance(texec.ServedModel(tc, prompt_len=P, gen_len=G),
                               torch.device("cpu"),
                               params=params_from_numpy(
                                   tc, jax.tree.map(np.asarray,
                                                    jinst.params), "cpu"))
    inst.setup()
    tokens = texec.prompt_tokens(inst.served, seed=2, n=1)
    inst.run_tokens(tokens)
    frontend = jnp.zeros((1, jc.n_frontend_tokens, jc.d_model), jc.dtype())
    logits, cache = jinst.prefill_fn(jinst.params,
                                     jnp.asarray(tokens, jnp.int32),
                                     jinst.cache0, frontend)
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    want = [tok]
    for i in range(G):
        logits, cache = jinst.decode_fn(jinst.params, cache, tok,
                                        jnp.int32(P + i))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        want.append(tok)
    np.testing.assert_array_equal(
        inst.last_tokens.numpy(),
        np.concatenate([np.asarray(t) for t in want], axis=1))


def test_a_one_layer_encoder_runs_where_the_reference_scan_refuses():
    """A divergence, pinned: the JAX package's ``_encode`` scans over
    ``params["encoder"]``, whose leaves carry no layer axis for one layer,
    so a one-layer encoder fails there; the port walks the layers as every
    group does and runs it (``chip_smoke.py`` holds whisper's parity on
    one encoder and one decoder layer)."""
    kw = dict(n_enc_layers=1, **F32)
    jc = j_get_config("whisper-tiny", reduced=True).with_(**kw)
    tc = get_config("whisper-tiny", reduced=True).with_(**kw)
    jp = j_init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu")
    fe = np.zeros((1, tc.n_frontend_tokens, tc.d_model), np.float32)
    toks = np.zeros((1, 4), np.int64)
    with pytest.raises(ValueError, match="leading axis"):
        j_forward(jc, jp, jnp.asarray(toks, jnp.int32), jnp.asarray(fe))
    lt, _ = forward(tc, tp, torch.from_numpy(toks), torch.from_numpy(fe))
    assert lt.shape == (1, 4, tc.vocab_padded)
    assert torch.isfinite(lt).all()
