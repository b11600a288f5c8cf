"""The model zoo: dense / MoE / SSM / hybrid / enc-dec / VLM / audio, in
plain PyTorch.

Port of ``src/repro/models/transformer.py:44-550``.  Every architecture is
a sequence of homogeneous layer groups (``cfg.groups()``): attention groups
(full, sliding-window, with cross-attention, with a mixture-of-experts FFN),
Mamba2 groups, and zamba2's ``shared_attn`` groups, which all run the one
``params["shared_attn"]`` block and each keep their own cache entry.
Whisper's encoder (``params["encoder"]``, ``enc_norm``) runs bidirectional
attention over the frontend frames; its decoder cross-attends to them.
Modality frontends are stubs, as in the JAX package: the caller passes
``frontend`` embeddings (B, F, d), which an encoder-decoder encodes and any
other frontend model prepends to the text.

Parameters are a dict with the JAX package's key names and layout: each
group's leaves carry a leading layer axis when the group has more than one
layer, and none when it has one (a ``shared_attn`` group's entry is an
empty placeholder).  The JAX ``lax.scan`` over that axis is a loop here.
Caches always carry the leading layer axis: K/V (and an encoder-decoder's
cross K/V, ``xk`` / ``xv``) per attention group, conv inputs and SSM state
per Mamba group.

Differences from the JAX package, all deliberate:

* Caches are updated in place (``prefill`` writes the prompt's K/V, conv
  inputs and SSM state, ``decode_step*`` the new token's) and returned; the
  serving executor gathers a private copy of its slab rows before each
  step.
* ``prefill`` runs a Mamba group from a zero conv prefix and a null initial
  state, where the JAX package passes a zeroed cache: the same numbers
  without reading zeros.
* ``decode_step`` is ``decode_step_ragged`` at a uniform position, so the
  two agree exactly by construction.
* ``cfg.remat`` (the reference's ``jax.checkpoint`` around one attention or
  Mamba layer) is ``torch.utils.checkpoint`` around the same bodies, and
  applies only when a gradient is carried: serving runs the layers as
  they are.
* Every attention and SSD-scan call goes through ``kernels.ops`` (the JAX
  package's kernel path); sliding-window decode keeps the masked
  ``gqa_attention`` on every device, as in JAX, because a ring cache is not
  a prefix.  Cross-attention in decode is the flash kernel with one
  non-causal query, as in JAX.

Properties of the reference, copied as they are:

* A frontend model's prefill runs ``F + S_text`` positions into a
  full-attention cache of width ``max_len``: when ``F + S_text`` exceeds
  it, the ring keeps the last ``max_len`` positions at ``pos mod max_len``,
  and a decode step at ``t`` then attends to slots ``[0, t]`` as a prefix
  at RoPE position ``t`` (text positions, not counting F).
* Cross-attention rotates its query with RoPE in ``forward`` / ``prefill``
  but not in decode.

Entry points:
  init_params(cfg, seed, device)                          -> params
  forward(cfg, params, tokens, frontend=None)             -> (logits, aux)
  lm_loss(cfg, params, tokens, frontend=None)             -> loss
  init_cache(cfg, batch, max_len, device, enc_len=None)   -> cache
  prefill(cfg, params, tokens, cache, frontend=None)      -> (logits, cache)
  decode_step(cfg, params, cache, token, t)               -> (logits, cache)
  decode_step_ragged(cfg, params, cache, token, t)        -> (logits, cache)
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
from ..kernels import ops as kernel_ops
from .config import LayerGroup, ModelConfig
from .layers import (apply_rope, attention_block, gelu_mlp, gqa_attention,
                     mamba2_block, moe_block, rms_norm, swiglu)
from .spmd import (embed, evenly, gather_data, pick, put_slots, ring_fill,
                   rows_and_heads, settled)

Params = Dict[str, Any]
f32 = torch.float32


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def _dense_init(gen, shape, dtype, device, scale=0.02) -> torch.Tensor:
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    return torch.randn(shape, generator=gen, dtype=f32,
                       device=device).mul_(scale).to(dtype)


def _attn_layer_shapes(cfg: ModelConfig, g: LayerGroup) -> Dict[str, tuple]:
    d, hd = cfg.d_model, cfg.hd
    hq, hkv, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    s: Dict[str, tuple] = {
        "ln1": (d,), "ln2": (d,),
        "wq": (d, hq * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd),
        "wo": (hq * hd, d),
    }
    if g.cross_attn:
        s.update({"ln_x": (d,), "xwq": (d, hq * hd), "xwk": (d, hkv * hd),
                  "xwv": (d, hkv * hd), "xwo": (hq * hd, d)})
    if g.moe:
        E = cfg.n_experts
        s.update({"router": (d, E), "w_gate": (E, d, f), "w_up": (E, d, f),
                  "w_down": (E, f, d)})
    elif cfg.mlp == "swiglu":
        s.update({"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)})
    else:
        s.update({"w_up": (d, f), "w_down": (f, d)})
    return s


def _mamba_layer_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    H = cfg.n_ssm_heads
    dxbc = di + 2 * N
    return {
        "ln": (d,),
        "in_proj": (d, 2 * di + 2 * N + H),
        "conv_w": (cfg.ssm_conv, dxbc), "conv_b": (dxbc,),
        "dt_bias": (H,), "A_log": (H,), "D": (H,),
        "norm_w": (di,), "out_proj": (di, d),
    }


def _init_layer(gen, shapes: Dict[str, tuple], count: int, dtype,
                device) -> Params:
    """Walk names in sorted order (as the JAX package does); a group of one
    layer is unstacked; norms start at zero (``rms_norm`` scales by 1+w).
    The Mamba leaves ``A_log`` (log of 1..16 over the heads), ``dt_bias``,
    ``conv_b`` (zeros) and ``D`` (ones) are float32 whatever ``dtype``."""
    out = {}
    for name, shp in sorted(shapes.items()):
        full = (count,) + shp if count > 1 else shp
        if name.startswith(("ln", "norm")):
            out[name] = torch.zeros(full, dtype=dtype, device=device)
        elif name == "A_log":
            base = torch.log(torch.linspace(1.0, 16.0, shp[-1], dtype=f32,
                                            device=device))
            out[name] = base.expand(full).clone()
        elif name in ("dt_bias", "conv_b"):
            out[name] = torch.zeros(full, dtype=f32, device=device)
        elif name == "D":
            out[name] = torch.ones(full, dtype=f32, device=device)
        else:
            fan_in = shp[-2] if len(shp) >= 2 else shp[-1]
            out[name] = _dense_init(gen, full, dtype, device,
                                    scale=1.0 / math.sqrt(fan_in))
    return out


def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None) -> Params:
    """Random weights from a ``torch.Generator`` seeded with ``seed``, with
    the JAX package's shapes, dtypes and distributions (its numbers come
    from ``jax.random`` and differ: tests bridge the JAX weights instead).
    ``device="meta"`` gives the shape tree without allocating."""
    dev = resolve_device(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    dtype = cfg.pdtype()
    params: Params = {
        "embed": _dense_init(gen, (cfg.vocab_padded, cfg.d_model), dtype,
                             dev),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _dense_init(
            gen, (cfg.d_model, cfg.vocab_padded), dtype, dev)
    glist: List[Params] = []
    for g in cfg.groups():
        if g.kind == "shared_attn":
            if "shared_attn" not in params:
                params["shared_attn"] = _init_layer(
                    gen, _attn_layer_shapes(cfg, LayerGroup("attn", 1)), 1,
                    dtype, dev)
            glist.append({})        # placeholder: runs params["shared_attn"]
        elif g.kind == "mamba":
            glist.append(_init_layer(gen, _mamba_layer_shapes(cfg), g.count,
                                     dtype, dev))
        else:
            glist.append(_init_layer(gen, _attn_layer_shapes(cfg, g),
                                     g.count, dtype, dev))
    params["groups"] = glist
    if cfg.n_enc_layers:
        params["encoder"] = _init_layer(
            gen, _attn_layer_shapes(cfg, LayerGroup("attn", cfg.n_enc_layers)),
            cfg.n_enc_layers, dtype, dev)
        params["enc_norm"] = torch.zeros((cfg.d_model,), dtype=dtype,
                                         device=dev)
    return params


# ---------------------------------------------------------------------------
# Layer-group execution
# ---------------------------------------------------------------------------


def _layer_params(gp: Params) -> Iterator[Params]:
    """The group's layers in order: slices of the stacked leaves, or the
    group itself when it holds one unstacked layer (keyed on the first
    norm: ``ln1`` of an attention layer, ``ln`` of a Mamba layer).  The
    slices come from one ``unbind`` per leaf, so that training stacks the
    layers' gradients once instead of scattering each into a zeroed copy
    of the whole leaf.  On a mesh, a layer's FSDP-sharded weights are
    gathered as it comes (``spmd.gather_data``)."""
    ln = gp["ln1"] if "ln1" in gp else gp["ln"]
    if ln.dim() == 1:
        yield {name: gather_data(t) for name, t in gp.items()}
        return
    slices = {name: t.unbind(0) for name, t in gp.items()}
    for i in range(ln.shape[0]):
        yield {name: gather_data(ts[i]) for name, ts in slices.items()}


def _remat(cfg: ModelConfig, body, h: torch.Tensor, lp: Params, *args):
    """``body(h, lp, *args)``, under layer-boundary remat when training:
    the counterpart of the reference's ``jax.checkpoint`` around a layer.
    With ``cfg.remat``, grad enabled and a gradient to carry, only the
    layer's inputs are kept and its activations are recomputed in the
    backward pass (so each kernel of the layer launches twice a training
    step); otherwise, serving included, ``body`` runs as it is."""
    if cfg.remat and torch.is_grad_enabled() and (
            h.requires_grad or any(t.requires_grad for t in lp.values())):
        return checkpoint(body, h, lp, *args, use_reentrant=False)
    return body(h, lp, *args)


def _ffn(cfg: ModelConfig, g: LayerGroup, p: Params, x: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer's FFN and its auxiliary loss (zero unless MoE)."""
    if g.moe:
        return moe_block(x, p, n_experts=cfg.n_experts,
                         k=cfg.experts_per_token,
                         capacity_factor=cfg.capacity_factor, mlp=cfg.mlp)
    zero = torch.zeros((), dtype=f32, device=x.device)
    if cfg.mlp == "swiglu":
        return swiglu(x, p["w_gate"], p["w_up"], p["w_down"]), zero
    return gelu_mlp(x, p["w_up"], p["w_down"]), zero


def _enc_kv(cfg: ModelConfig, lp: Params, enc_out: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A decoder layer's cross-attention K/V over the encoder output."""
    B, Se, _ = enc_out.shape
    k = evenly(enc_out @ lp["xwk"], cfg.n_kv_heads).reshape(
        B, Se, cfg.n_kv_heads, cfg.hd)
    v = evenly(enc_out @ lp["xwv"], cfg.n_kv_heads).reshape(
        B, Se, cfg.n_kv_heads, cfg.hd)
    return k, v


def _attn_group_fwd(cfg: ModelConfig, g: LayerGroup, gp: Params,
                    x: torch.Tensor, positions: torch.Tensor,
                    enc_out: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, torch.Tensor,
                               List[Dict[str, torch.Tensor]]]:
    """Run an attention group over a whole sequence.  Returns the hidden
    state, the group's summed auxiliary loss and each layer's cache rows:
    {"k", "v"}, and the cross K/V {"xk", "xv"} of a cross-attention
    layer."""

    def body(h, lp):
        a, k, v = attention_block(
            rms_norm(h, lp["ln1"], cfg.norm_eps), lp,
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, hd=cfg.hd,
            positions=positions, rope_theta=cfg.rope_theta,
            causal=True, window=g.window)
        h = h + a
        rows = {"k": k, "v": v}
        if g.cross_attn:
            rows["xk"], rows["xv"] = _enc_kv(cfg, lp, enc_out)
            xa, _, _ = attention_block(
                rms_norm(h, lp["ln_x"], cfg.norm_eps),
                {"wq": lp["xwq"], "wo": lp["xwo"]},
                n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, hd=cfg.hd,
                positions=positions, rope_theta=cfg.rope_theta,
                kv_override=(rows["xk"], rows["xv"]), causal=False,
                window=0)
            h = h + xa
        f, a_loss = _ffn(cfg, g, lp, rms_norm(h, lp["ln2"], cfg.norm_eps))
        return h + f, a_loss, rows

    kv = []
    h = x
    aux = torch.zeros((), dtype=f32, device=x.device)
    for lp in _layer_params(gp):
        h, a_loss, rows = _remat(cfg, body, h, lp)
        aux = aux + a_loss
        kv.append(rows)
    return h, aux, kv


def _mamba_group_fwd(cfg: ModelConfig, gp: Params, x: torch.Tensor,
                     ce: Optional[Dict[str, torch.Tensor]] = None,
                     ) -> Tuple[torch.Tensor,
                                List[Dict[str, torch.Tensor]]]:
    """Run a Mamba group over x (B,S,d): from a zero conv prefix and state
    without ``ce``, else from layer i's ``ce["conv"][i]`` and
    ``ce["state"][i]``.  Returns the hidden state and each layer's new
    {'conv', 'state'}."""

    def body(h, lp, lc):
        y, nc = mamba2_block(
            rms_norm(h, lp["ln"], cfg.norm_eps), lp,
            n_heads=cfg.n_ssm_heads, head_dim=cfg.ssm_head_dim,
            d_state=cfg.ssm_state, d_conv=cfg.ssm_conv, chunk=cfg.ssm_chunk,
            cache=lc)
        return h + y, nc

    caches = []
    h = x
    for i, lp in enumerate(_layer_params(gp)):
        lc = None if ce is None else {k: t[i] for k, t in ce.items()}
        h, nc = _remat(cfg, body, h, lp, lc)
        caches.append(nc)
    return h, caches


def _store(ce: Dict[str, torch.Tensor],
           caches: List[Dict[str, torch.Tensor]]) -> None:
    """Write each layer's new Mamba cache into the group's entry, in
    place."""
    for i, nc in enumerate(caches):
        for k, t in nc.items():
            ce[k][i].copy_(t)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def _embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
           frontend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gather, cast to the compute dtype, then scale by sqrt(d) in that
    dtype: JAX rounds the weakly typed scalar to the array's dtype first.
    A frontend model's (B, F, d) embeddings go ahead of the text."""
    h = embed(gather_data(params["embed"]), tokens).to(cfg.dtype())
    scale = torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype,
                         device=h.device)
    h = h * scale
    if frontend is not None and cfg.frontend and cfg.arch_type != "encdec":
        h = torch.cat([frontend.to(cfg.dtype()), h], dim=1)
    return h


def _unembed(cfg: ModelConfig, params: Params,
             h: torch.Tensor) -> torch.Tensor:
    """Logits over all ``vocab_padded`` columns (greedy argmax ranges over
    the padded columns too, as in the JAX package)."""
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return h @ gather_data(params["embed"]).T.to(h.dtype)
    return h @ gather_data(params["lm_head"]).to(h.dtype)


def _encode(cfg: ModelConfig, params: Params,
            frontend: torch.Tensor) -> torch.Tensor:
    """Whisper-style bidirectional encoder over the (stub) frame
    embeddings (B, F, d): non-causal flash attention in every layer."""
    h = frontend.to(cfg.dtype())
    pos = torch.arange(h.shape[1], device=h.device)[None, :]
    for lp in _layer_params(params["encoder"]):
        a, _, _ = attention_block(
            rms_norm(h, lp["ln1"], cfg.norm_eps), lp,
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, hd=cfg.hd,
            positions=pos, rope_theta=cfg.rope_theta, causal=False, window=0)
        h = h + a
        f, _ = _ffn(cfg, LayerGroup("attn", 1), lp,
                    rms_norm(h, lp["ln2"], cfg.norm_eps))
        h = h + f
    return rms_norm(h, params["enc_norm"], cfg.norm_eps)


def _inputs(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            frontend: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The decoder's input sequence and, for an encoder-decoder, the
    encoder output."""
    if cfg.arch_type != "encdec":
        return _embed(cfg, params, tokens, frontend), None
    if frontend is None:
        raise ValueError(f"{cfg.name}: an encoder-decoder needs frontend "
                         f"frames")
    return _embed(cfg, params, tokens), _encode(cfg, params, frontend)


def _group_params(params: Params, g: LayerGroup, gp: Params) -> Params:
    return params["shared_attn"] if g.kind == "shared_attn" else gp


# ---------------------------------------------------------------------------
# forward (teacher forcing)
# ---------------------------------------------------------------------------


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            frontend: Optional[torch.Tensor] = None,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S_text); frontend: (B, F, d) when ``cfg.frontend`` is
    set.  Returns (logits (B, S_total, V), aux_loss scalar): S_total counts
    the frontend positions of a non-encdec frontend model, and the
    auxiliary loss sums the MoE layers' (zero without them)."""
    h, enc_out = _inputs(cfg, params, tokens, frontend)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    aux = torch.zeros((), dtype=f32, device=h.device)
    for g, gp in zip(cfg.groups(), params["groups"]):
        if g.kind == "mamba":
            h, _ = _mamba_group_fwd(cfg, gp, h)
        else:
            h, a, _ = _attn_group_fwd(cfg, g, _group_params(params, g, gp),
                                      h, positions, enc_out)
            aux = aux + a
    return _unembed(cfg, params, h), aux


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def lm_loss(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            frontend: Optional[torch.Tensor] = None,
            aux_weight: float = 0.01) -> torch.Tensor:
    """Next-token cross-entropy (+ MoE load-balance aux), the reference's
    ``lm_loss``: float32 logits of the text positions only, ``logsumexp``
    minus the picked logit, the mean, plus ``aux_weight * aux``.  The
    picked logit is a ``gather`` where the reference contracts a one-hot
    (the same number; the one-hot is B·S·V float32, about 1 GB for
    minicpm-2b at 4 × 512 tokens)."""
    logits, aux = forward(cfg, params, tokens, frontend)
    # predictions for text positions only (frontend tokens are prompts)
    n_text = tokens.shape[1]
    pred = logits[:, -n_text:, :].to(f32)[:, :-1]       # (B, S-1, V)
    tgt = tokens[:, 1:].long()                          # (B, S-1)
    lse = torch.logsumexp(pred, dim=-1)                 # (B, S-1)
    picked = pick(pred, tgt[..., None])[..., 0]
    return (lse - picked).mean() + aux_weight * aux


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------


def _attn_cache_len(g: LayerGroup, max_len: int) -> int:
    return min(g.window, max_len) if g.window > 0 else max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None,
               enc_len: Optional[int] = None) -> Dict[str, Any]:
    """Zeroed caches.  Attention groups: K/V, (layers, batch, W, Hkv, hd);
    W is ``max_len`` for full attention and ``min(window, max_len)`` for a
    sliding-window ring; a cross-attention group adds the cross K/V ``xk`` /
    ``xv``, (layers, batch, L, Hkv, hd), L = ``enc_len`` or
    ``cfg.n_enc_tokens``.  Mamba groups: the conv inputs, (layers, batch,
    conv - 1, d_inner + 2N) in the compute dtype, and the SSM state,
    (layers, batch, H, P, N) in float32."""
    dev = resolve_device(device)
    entries = []
    for g in cfg.groups():
        if g.kind == "mamba":
            entries.append({
                "conv": torch.zeros((g.count, batch, cfg.ssm_conv - 1,
                                     cfg.d_inner + 2 * cfg.ssm_state),
                                    dtype=cfg.dtype(), device=dev),
                "state": torch.zeros((g.count, batch, cfg.n_ssm_heads,
                                      cfg.ssm_head_dim, cfg.ssm_state),
                                     dtype=f32, device=dev)})
            continue
        shapes = {"k": _attn_cache_len(g, max_len),
                  "v": _attn_cache_len(g, max_len)}
        if g.cross_attn:
            shapes["xk"] = shapes["xv"] = enc_len or cfg.n_enc_tokens
        entries.append({
            key: torch.zeros((g.count, batch, L, cfg.n_kv_heads, cfg.hd),
                             dtype=cfg.dtype(), device=dev)
            for key, L in shapes.items()})
    return {"layers": entries}


# ---------------------------------------------------------------------------
# prefill: run the prompt, fill caches, return last-position logits
# ---------------------------------------------------------------------------


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            cache: Dict[str, Any], frontend: Optional[torch.Tensor] = None,
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the prompt (B, S_text), with ``frontend`` (B, F, d) for a
    frontend model, write its K/V (attention; an encoder-decoder's cross
    K/V too) and conv inputs and state (Mamba) into ``cache`` in place and
    return (last-position logits (B, 1, V), cache)."""
    h, enc_out = _inputs(cfg, params, tokens, frontend)
    S = h.shape[1]
    positions = torch.arange(S, device=h.device)[None, :]
    for g, gp, ce in zip(cfg.groups(), params["groups"], cache["layers"]):
        if g.kind == "mamba":
            h, caches = _mamba_group_fwd(cfg, gp, h)
            _store(ce, caches)
            continue
        h, _, kv = _attn_group_fwd(cfg, g, _group_params(params, g, gp), h,
                                   positions, enc_out)
        if g.cross_attn and ce["xk"].shape[2] != enc_out.shape[1]:
            raise ValueError(
                f"{cfg.name}: cross cache holds {ce['xk'].shape[2]} frames, "
                f"the encoder gave {enc_out.shape[1]} (pass enc_len to "
                f"init_cache)")
        W = ce["k"].shape[2]
        for i, rows in enumerate(kv):
            ring_fill(ce["k"][i], rows["k"], S, W)
            ring_fill(ce["v"][i], rows["v"], S, W)
            if g.cross_attn:
                ce["xk"][i].copy_(rows["xk"])
                ce["xv"][i].copy_(rows["xv"])
    return _unembed(cfg, params, h[:, -1:, :]), cache


# ---------------------------------------------------------------------------
# decode: one token per row
# ---------------------------------------------------------------------------


def decode_step(cfg: ModelConfig, params: Params, cache: Dict[str, Any],
                token: torch.Tensor, t: Union[int, torch.Tensor],
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """token: (B,1) int; t: the absolute position of this token, shared by
    every row.  Returns (logits (B,1,V), cache updated in place)."""
    B = token.shape[0]
    tt = torch.as_tensor(t, dtype=torch.int32, device=token.device)
    return decode_step_ragged(cfg, params, cache, token, tt.expand(B))


def decode_step_ragged(cfg: ModelConfig, params: Params,
                       cache: Dict[str, Any], token: torch.Tensor,
                       t: torch.Tensor,
                       ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """token: (B,1) int; t: (B,) int per-row absolute positions.

    The continuous-batching decode step: every row advances its own
    sequence (per-row RoPE angle, cache slot and ``valid_len``), so requests
    at different depths share one step; a Mamba row's state is its own
    whatever its depth.  Returns (logits (B,1,V), cache updated in
    place)."""
    t = t.to(torch.int32)
    h = _embed(cfg, params, token)
    for g, gp, ce in zip(cfg.groups(), params["groups"], cache["layers"]):
        if g.kind == "mamba":
            h, caches = _mamba_group_fwd(cfg, gp, h, ce)
            _store(ce, caches)
        else:
            h = _attn_group_decode(cfg, g, _group_params(params, g, gp), ce,
                                   h, t)
    return _unembed(cfg, params, h), cache


def _attn_group_decode(cfg: ModelConfig, g: LayerGroup, gp: Params,
                       ce: Dict[str, torch.Tensor], x: torch.Tensor,
                       t: torch.Tensor) -> torch.Tensor:
    """One-token step of an attention group at per-row positions ``t``."""
    B = x.shape[0]
    W = ce["k"].shape[2]
    rows = torch.arange(B, device=x.device)
    slot = torch.remainder(t, W).long()
    positions = t[:, None]
    if g.window > 0:
        # absolute position held by ring slot s: t - ((t - s) mod W)
        slots = torch.arange(W, device=x.device)
        tb = t[:, None].long()
        k_pos = tb - torch.remainder(tb - slots, W)
        mask = ((k_pos >= 0) & (k_pos <= tb))[:, None, None, None, :]
    else:
        # a full-attention cache holds slots [0, t] as a prefix, so the
        # flash-decoding kernel attends to valid_len = t + 1 keys
        vlen = (t + 1).to(torch.int32).contiguous()
    h = x
    for i, lp in enumerate(_layer_params(gp)):
        lk, lv = ce["k"][i], ce["v"][i]
        hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
        q = evenly(hn @ lp["wq"], cfg.n_heads).reshape(
            B, 1, cfg.n_heads, cfg.hd)
        k1 = evenly(hn @ lp["wk"], cfg.n_kv_heads).reshape(
            B, 1, cfg.n_kv_heads, cfg.hd)
        v1 = evenly(hn @ lp["wv"], cfg.n_kv_heads).reshape(
            B, 1, cfg.n_kv_heads, cfg.hd)
        q = apply_rope(q, positions, cfg.rope_theta)
        k1 = apply_rope(k1, positions, cfg.rope_theta)
        # write the new K/V at (row, t mod W) before attending, in place
        put_slots(lk, rows, slot, k1[:, 0].to(lk.dtype))
        put_slots(lv, rows, slot, v1[:, 0].to(lv.dtype))
        if g.window > 0:
            a = rows_and_heads(gqa_attention, (q, lk, lv, mask),
                               ((0, 2), (0, 2), (0, 2), (0, None)),
                               ((0, 2),), (q.shape,), (cfg.n_kv_heads,))
        else:
            q0 = q[:, 0].contiguous()
            a = rows_and_heads(kernel_ops.decode_attention,
                               (q0, lk, lv, vlen),
                               ((0, 1), (0, 2), (0, 2), (0, None)),
                               ((0, 1),), (q0.shape,),
                               (cfg.n_kv_heads,))[:, None]
        h = h + settled(evenly(a, cfg.n_heads, dim=2).reshape(
            B, 1, cfg.n_heads * cfg.hd) @ lp["wo"])
        if g.cross_attn:
            # the flash kernel with one non-causal query, q without RoPE,
            # as in the JAX package's decode
            hx = rms_norm(h, lp["ln_x"], cfg.norm_eps)
            qx = evenly(hx @ lp["xwq"], cfg.n_heads).reshape(
                B, 1, cfg.n_heads, cfg.hd)
            ax = rows_and_heads(kernel_ops.attention,
                                (qx, ce["xk"][i], ce["xv"][i]),
                                ((0, 2),) * 3, ((0, 2),), (qx.shape,),
                                (cfg.n_kv_heads,), causal=False, window=0)
            h = h + settled(evenly(ax, cfg.n_heads, dim=2).reshape(
                B, 1, cfg.n_heads * cfg.hd) @ lp["xwo"])
        f, _ = _ffn(cfg, g, lp, rms_norm(h, lp["ln2"], cfg.norm_eps))
        h = h + f
    return h
