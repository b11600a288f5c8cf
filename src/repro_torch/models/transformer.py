"""Decoder model: dense attention and Mamba2 layer groups, in plain PyTorch.

Port of ``src/repro/models/transformer.py:44-550`` for attention and Mamba
groups.
Parameters are a dict with the JAX package's key names and layout: each
group's leaves carry a leading layer axis when the group has more than one
layer, and none when it has one.  The JAX ``lax.scan`` over that axis is a
loop here.  Caches always carry the leading layer axis: K/V per attention
group, conv inputs and SSM state per Mamba group.

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
* Every attention and SSD-scan call goes through ``kernels.ops`` (the JAX
  package's kernel path); sliding-window decode keeps the masked
  ``gqa_attention`` on every device, as in JAX, because a ring cache is not
  a prefix.

Mixture of experts, cross-attention, zamba2's shared attention, the
modality frontends and the encoder are not ported yet and raise
``NotImplementedError`` naming their ROADMAP item.

Entry points:
  init_params(cfg, seed, device)                -> params
  forward(cfg, params, tokens)                  -> (logits, aux)
  init_cache(cfg, batch, max_len, device)       -> cache
  prefill(cfg, params, tokens, cache)           -> (logits, cache)
  decode_step(cfg, params, cache, token, t)     -> (logits, cache)
  decode_step_ragged(cfg, params, cache, token, t) -> (logits, cache)
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import torch

from ..device import DeviceLike, resolve_device
from ..kernels import ops as kernel_ops
from .config import LayerGroup, ModelConfig
from .layers import (apply_rope, attention_block, gelu_mlp, gqa_attention,
                     mamba2_block, rms_norm, swiglu)

Params = Dict[str, Any]
f32 = torch.float32

_ZOO = "ROADMAP Queue 1, 'Rest of the model zoo'"


def _check_supported(cfg: ModelConfig) -> None:
    for g in cfg.groups():
        if g.kind == "shared_attn":
            raise NotImplementedError(
                f"{cfg.name}: zamba2's shared attention is not ported yet "
                f"({_ZOO})")
        if g.moe:
            raise NotImplementedError(
                f"{cfg.name}: mixture-of-experts FFNs are not ported yet "
                f"({_ZOO})")
        if g.cross_attn:
            raise NotImplementedError(
                f"{cfg.name}: cross-attention is not ported yet ({_ZOO})")
    if cfg.n_enc_layers:
        raise NotImplementedError(
            f"{cfg.name}: the encoder stack is not ported yet ({_ZOO})")


def _check_no_frontend(cfg: ModelConfig) -> None:
    if cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} frontend stub is not ported yet "
            f"({_ZOO})")


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def _dense_init(gen, shape, dtype, device, scale=0.02) -> torch.Tensor:
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    return (torch.randn(shape, generator=gen, dtype=f32, device=device)
            * scale).to(dtype)


def _attn_layer_shapes(cfg: ModelConfig, g: LayerGroup) -> Dict[str, tuple]:
    d, hd = cfg.d_model, cfg.hd
    hq, hkv, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    s: Dict[str, tuple] = {
        "ln1": (d,), "ln2": (d,),
        "wq": (d, hq * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd),
        "wo": (hq * hd, d),
    }
    if cfg.mlp == "swiglu":
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
    _check_supported(cfg)
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
    params["groups"] = [
        _init_layer(gen, _mamba_layer_shapes(cfg) if g.kind == "mamba"
                    else _attn_layer_shapes(cfg, g), g.count, dtype, dev)
        for g in cfg.groups()]
    return params


# ---------------------------------------------------------------------------
# Layer-group execution
# ---------------------------------------------------------------------------


def _layer_params(gp: Params) -> Iterator[Params]:
    """The group's layers in order: slices of the stacked leaves, or the
    group itself when it holds one unstacked layer (keyed on the first
    norm: ``ln1`` of an attention layer, ``ln`` of a Mamba layer)."""
    ln = gp["ln1"] if "ln1" in gp else gp["ln"]
    if ln.dim() == 1:
        yield gp
        return
    for i in range(ln.shape[0]):
        yield {name: t[i] for name, t in gp.items()}


def _ffn(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp == "swiglu":
        return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])
    return gelu_mlp(x, p["w_up"], p["w_down"])


def _attn_group_fwd(cfg: ModelConfig, g: LayerGroup, gp: Params,
                    x: torch.Tensor, positions: torch.Tensor
                    ) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor,
                                                        torch.Tensor]]]:
    """Run an attention group over a whole sequence.  Returns the hidden
    state and each layer's (k, v)."""
    kv = []
    h = x
    for lp in _layer_params(gp):
        a, k, v = attention_block(
            rms_norm(h, lp["ln1"], cfg.norm_eps), lp,
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, hd=cfg.hd,
            positions=positions, rope_theta=cfg.rope_theta,
            causal=True, window=g.window)
        h = h + a
        h = h + _ffn(cfg, lp, rms_norm(h, lp["ln2"], cfg.norm_eps))
        kv.append((k, v))
    return h, kv


def _mamba_group_fwd(cfg: ModelConfig, gp: Params, x: torch.Tensor,
                     ce: Optional[Dict[str, torch.Tensor]] = None,
                     ) -> Tuple[torch.Tensor,
                                List[Dict[str, torch.Tensor]]]:
    """Run a Mamba group over x (B,S,d): from a zero conv prefix and state
    without ``ce``, else from layer i's ``ce["conv"][i]`` and
    ``ce["state"][i]``.  Returns the hidden state and each layer's new
    {'conv', 'state'}."""
    caches = []
    h = x
    for i, lp in enumerate(_layer_params(gp)):
        lc = None if ce is None else {k: t[i] for k, t in ce.items()}
        y, nc = mamba2_block(
            rms_norm(h, lp["ln"], cfg.norm_eps), lp,
            n_heads=cfg.n_ssm_heads, head_dim=cfg.ssm_head_dim,
            d_state=cfg.ssm_state, d_conv=cfg.ssm_conv, chunk=cfg.ssm_chunk,
            cache=lc)
        h = h + y
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


def _embed(cfg: ModelConfig, params: Params,
           tokens: torch.Tensor) -> torch.Tensor:
    """Gather, cast to the compute dtype, then scale by sqrt(d) in that
    dtype: JAX rounds the weakly typed scalar to the array's dtype first."""
    h = params["embed"][tokens].to(cfg.dtype())
    scale = torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype,
                         device=h.device)
    return h * scale


def _unembed(cfg: ModelConfig, params: Params,
             h: torch.Tensor) -> torch.Tensor:
    """Logits over all ``vocab_padded`` columns (greedy argmax ranges over
    the padded columns too, as in the JAX package)."""
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return h @ params["embed"].T.to(h.dtype)
    return h @ params["lm_head"].to(h.dtype)


# ---------------------------------------------------------------------------
# forward (teacher forcing)
# ---------------------------------------------------------------------------


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S).  Returns (logits (B, S, V), aux_loss scalar); the
    auxiliary loss is zero without mixture-of-experts layers."""
    _check_supported(cfg)
    _check_no_frontend(cfg)
    h = _embed(cfg, params, tokens)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    for g, gp in zip(cfg.groups(), params["groups"]):
        if g.kind == "mamba":
            h, _ = _mamba_group_fwd(cfg, gp, h)
        else:
            h, _ = _attn_group_fwd(cfg, g, gp, h, positions)
    return _unembed(cfg, params, h), torch.zeros((), dtype=f32,
                                                 device=h.device)


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------


def _attn_cache_len(g: LayerGroup, max_len: int) -> int:
    return min(g.window, max_len) if g.window > 0 else max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> Dict[str, Any]:
    """Zeroed caches.  Attention groups: K/V, (layers, batch, W, Hkv, hd);
    W is ``max_len`` for full attention and ``min(window, max_len)`` for a
    sliding-window ring.  Mamba groups: the conv inputs, (layers, batch,
    conv - 1, d_inner + 2N) in the compute dtype, and the SSM state,
    (layers, batch, H, P, N) in float32."""
    dev = resolve_device(device)
    _check_supported(cfg)
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
        shape = (g.count, batch, _attn_cache_len(g, max_len),
                 cfg.n_kv_heads, cfg.hd)
        entries.append({"k": torch.zeros(shape, dtype=cfg.dtype(),
                                         device=dev),
                        "v": torch.zeros(shape, dtype=cfg.dtype(),
                                         device=dev)})
    return {"layers": entries}


# ---------------------------------------------------------------------------
# prefill: run the prompt, fill caches, return last-position logits
# ---------------------------------------------------------------------------


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            cache: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the prompt (B, S), write its K/V (attention) and conv inputs and
    state (Mamba) into ``cache`` in place and return (last-position logits
    (B, 1, V), cache)."""
    _check_supported(cfg)
    _check_no_frontend(cfg)
    h = _embed(cfg, params, tokens)
    S = h.shape[1]
    positions = torch.arange(S, device=h.device)[None, :]
    for g, gp, ce in zip(cfg.groups(), params["groups"], cache["layers"]):
        if g.kind == "mamba":
            h, caches = _mamba_group_fwd(cfg, gp, h)
            _store(ce, caches)
            continue
        h, kv = _attn_group_fwd(cfg, g, gp, h, positions)
        W = ce["k"].shape[2]
        for i, (k, v) in enumerate(kv):
            _ring_fill(ce["k"][i], k, S, W)
            _ring_fill(ce["v"][i], v, S, W)
    return _unembed(cfg, params, h[:, -1:, :]), cache


def _ring_fill(dst: torch.Tensor, kv: torch.Tensor, S: int, W: int) -> None:
    """Write one layer's prefill K/V (B,S,Hkv,hd) into its cache (B,W,...)
    in place; a ring of width W < S keeps the last W positions at slot
    ``pos mod W``."""
    if S >= W:
        slots = torch.arange(S - W, S, device=dst.device) % W
        dst[:, slots] = kv[:, S - W:].to(dst.dtype)
    else:
        dst[:, :S] = kv.to(dst.dtype)


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
    _check_supported(cfg)
    t = t.to(torch.int32)
    h = _embed(cfg, params, token)
    for g, gp, ce in zip(cfg.groups(), params["groups"], cache["layers"]):
        if g.kind == "mamba":
            h, caches = _mamba_group_fwd(cfg, gp, h, ce)
            _store(ce, caches)
        else:
            h = _attn_group_decode(cfg, g, gp, ce, h, t)
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
        q = (hn @ lp["wq"]).reshape(B, 1, cfg.n_heads, cfg.hd)
        k1 = (hn @ lp["wk"]).reshape(B, 1, cfg.n_kv_heads, cfg.hd)
        v1 = (hn @ lp["wv"]).reshape(B, 1, cfg.n_kv_heads, cfg.hd)
        q = apply_rope(q, positions, cfg.rope_theta)
        k1 = apply_rope(k1, positions, cfg.rope_theta)
        # write the new K/V at (row, t mod W) before attending, in place
        lk.index_put_((rows, slot), k1[:, 0].to(lk.dtype))
        lv.index_put_((rows, slot), v1[:, 0].to(lv.dtype))
        if g.window > 0:
            a = gqa_attention(q, lk, lv, mask)
        else:
            a = kernel_ops.decode_attention(q[:, 0].contiguous(), lk, lv,
                                            vlen)[:, None]
        h = h + a.reshape(B, 1, cfg.n_heads * cfg.hd) @ lp["wo"]
        h = h + _ffn(cfg, lp, rms_norm(h, lp["ln2"], cfg.norm_eps))
    return h
