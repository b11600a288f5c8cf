#!/usr/bin/env python3
"""On-chip smoke test of the PyTorch port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/csrc``, holds
each against its plain PyTorch version on the card (at every head dim the
zoo needs, 256 included), checks that the bf16 flash-attention and SSD
kernels run on the tensor cores (HGMMA in their SASS), times them at the
main paths' shapes (every kernel at buckets 8 and 1, the attention kernels
beside SDPA, gemma3-1b's hd 256 attention too, the SSD scan at every split
of its chunks), and then, for each of the two main paths (the dense decoder
minicpm-2b with the two attention kernels, the Mamba2 decoder mamba2-370m
with the SSD scan): checks the model at full width (two layers) on the card
against the same weights on the CPU, serves 16 full-width, full-depth
requests through continuous batching, asserting that every decoder layer's
hot spot went through its kernel, and profiles one full-bucket join and
decode step to show how much of their time the card is busy.  Phase 8
serves both models at once, at full width and depth, through Archipelago's
control plane: ``simulate(stack="archipelago", backend="torch-batched")``
with continuous batching (the LBS, the SGSs and the sandbox manager over the
card), asserting that every request completes once and that every kernel
launched once per layer in each join or decode step; and it runs
mamba2-370m briefly under the ``torch`` and windowed ``torch-batched``
backends.  Phase 9 takes each of the other eight architectures (gemma3-1b,
minitron-8b, phi3-mini, phi-3-vision, zamba2-1.2b, whisper-tiny,
mixtral-8x22b, llama4-scout) through the same card-vs-CPU parity at
published width on the fewest layers that hold every group kind, then a
short serve at published width (the two MoE models at ``MOE_LAYERS``
layers, which is what fits the card) through ``serve()``, or through
``simulate`` on windowed ``torch-batched`` for the two that continuous
batching refuses, holding each kernel's launches to the model's groups.
Phase 10 serves ``multitenant_apps``' four tenants at published width under
``archipelago`` on windowed ``torch-batched``: every request once, each DAG
in order, each model's launches.  Phase 11 trains: each kernel's autograd
Function (the kernel forward, the backward recomputed through
``kernels/ref.py``) against autograd through its plain version; for each
main path, the ``lm_loss`` gradient of every leaf on two full-width layers
in float32, card against CPU; then eight AdamW steps at full width and
depth through ``launch.train``'s ``Trainer`` (B 4 x S 512 of
``SyntheticLM``), asserting finite, falling losses, a finite non-zero
gradient on every leaf, every leaf changed, each kernel launched twice a
layer a step (forward and remat recompute), and profiling one more step.
Phase 12 runs the multi-device dry-run (``repro_torch.launch.dryrun``) of
three combinations at published width and depth on a fake 256-rank mesh,
in three processes on the host, then prices phase 7's joins and steps and
phase 11's training steps with the dry-run's cost model and asserts that
no bound exceeds the busy time the card measured.  Phase 4 times each
plain version behind a 25 ms device-side sleep, which outlasts the host's
enqueue of its launches.
Any failed phase raises and the script
exits non-zero.  The second-to-last line of output is a JSON object
``{"kernels": [...]}`` (times, bounds, launches); the last line is
``{"ok": true, "device": {...}}``.  A full report is written to
``build/chip_smoke.json`` (``.gitignore`` lists ``build/``).

It exits non-zero, printing no result, where CUDA is not available.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, Tuple

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
    # the zoo's shapes: gemma3-1b's join at hd 256 (4 heads over 1 KV head)
    # at buckets 8 and 1, its local window of 512 within and past the
    # prompt, non-causal, one query over 1500 keys; whisper's encoder and
    # its cross-attention in decode; mixtral's and llama4-scout's GQA (6, 5)
    # at hd 128; phi-3-vision's prompt behind its 576 frames at hd 96
    (8, 512, 512, 4, 1, 256, True, 0),
    (1, 512, 512, 4, 1, 256, True, 512),
    (1, 1100, 1100, 4, 1, 256, True, 512),
    (2, 300, 300, 4, 1, 256, False, 0),
    (2, 1, 1500, 4, 1, 256, False, 0),
    (1, 1500, 1500, 6, 6, 64, False, 0),
    (2, 1, 1500, 6, 6, 64, False, 0),
    (2, 128, 128, 48, 8, 128, True, 0),
    (2, 128, 128, 40, 8, 128, True, 0),
    (1, 592, 592, 32, 32, 96, True, 0),
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
    # gemma3-1b's global decode at hd 256 (G = 4, G * hd = 1024) at
    # buckets 8 and 1 and with a valid_len = 0 row; GQA 4, 5 and 6 at hd
    # 128 (minitron-8b, llama4-scout, mixtral)
    (8, 544, 4, 1, 256, False),
    (1, 544, 4, 1, 256, False),
    (3, 600, 4, 1, 256, True),
    (2, 544, 32, 8, 128, False),
    (2, 544, 40, 8, 128, False),
    (2, 544, 48, 8, 128, True),
]
# The MoE models at published width but cut depth: mixtral-8x22b holds
# about 5.0 GB of bf16 a layer and llama4-scout about 4.2 GB, so 4 layers
# each (about 21 GB with the embeddings) fit one 80 GB card beside the rest
MOE_LAYERS = 4
# phase 10: bench_serving.py's rate per app, for a shorter run
MT_RPS, MT_DURATION = 3.0, 4.0

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

# Phase 11, training.  (a) Each kernel's autograd Function (kernel forward,
# backward through kernels/ref.py) against autograd through the plain
# version on the same inputs: the forward output within TOL (SSD_TOL for the
# scan's y and state), as in phase 3, and the gradients within GRAD_TOL of
# max |grad| per input.  Flash's backward is the plain version's own, so
# only the bf16 rounding of the incoming gradient may differ; the SSD
# reference forms x·dt in the input dtype where the plain version widens it
# first (on the CPU, bf16 up to 7e-3 and f32 up to 1.1e-5, the A gradient).
# tests/test_torch_cuda.py reads these tolerances from here.
GRAD_TOL = {"flash_attention": {"bfloat16": 1e-2, "float32": 1e-5},
            "ssd_scan": {"bfloat16": 2e-2, "float32": 1e-4}}
# (B, Sq, Sk, Hq, Hkv, hd, causal, window): causal, sliding window,
# non-causal over other keys (cross) and GQA at hd 64, 128 and 256, then
# minicpm-2b's training shape (B 4 x S 512, 36 heads of 64)
TRAIN_FA_CASES = [(B, Sq, Sk, Hq, Hkv, hd, causal, w)
                  for B, Sq, Sk, Hq, Hkv, causal, w in (
                      (2, 256, 256, 8, 8, True, 0),
                      (2, 256, 256, 8, 8, True, 100),
                      (2, 64, 300, 8, 8, False, 0),
                      (2, 256, 256, 8, 2, True, 0))
                  for hd in (64, 128, 256)] + [(4, 512, 512, 36, 36, 64,
                                                True, 0)]
# (B, S, H, P, N, chunk): S a multiple of the chunk, and not; then
# mamba2-370m's training shape (B 4 x S 512, 32 heads: the bf16 kernel
# splits each (b, h)'s 8 chunks over 2 CTAs, which no serving bucket does)
TRAIN_SSD_CASES = [(2, 512, 8, 64, 128, 64), (2, 300, 8, 64, 128, 64),
                   (4, 512, 32, 64, 128, 64)]
# (b) lm_loss gradients of every leaf, card (kernels) vs CPU (plain), f32,
# max |Δg| / max |g| per leaf: both sides in float32 (TF32 off), summed in
# other orders through two full-width layers and the vocabulary
MODEL_GRAD_TOL = 1e-3
# (c) AdamW steps at full width and depth, B x S from SyntheticLM.  The
# schedule over 8 steps warms up in one: WSD (minicpm-2b) runs at the peak
# for steps 1-7 and a tenth of it at step 8, cosine (mamba2-370m) decays
# from step 1.  Peak learning rates: mamba2-370m at the launcher's default
# 1e-3; minicpm-2b at make_train_step's default 3e-4.  The runs are
# deterministic; `python -m repro_torch.launch.train --full --steps 8
# --batch 4 --seq 512 --lr LR` on the H100 took minicpm-2b's loss from
# 12.1588 to 13.3239 at 1e-3, 11.8323 at 3e-4, 11.9331 at 1e-4 and
# 12.3439 at 5e-5, and mamba2-370m's from 11.0341 to 10.1755 at 1e-3.
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 8, 4, 512
TRAIN_LR = {"minicpm-2b": 3e-4, "mamba2-370m": 1e-3}

# Phase 4: a device-side sleep of about 25 ms (the card's clock cycles)
# ahead of each timing of a plain version, which outlasts the host's enqueue
# of its launches (the plain SSD scan's ~100 take 2.2-3.5 ms), so that the
# events hold the card's time; the kernels keep phase 4's 0.5 ms
PLAIN_SLEEP = 50_000_000

# Phase 12 (a): the dry-run (repro_torch.launch.dryrun) at full width and
# depth on the 256-rank production mesh, one process per combination: the
# dense decoder's decode, the expert-parallel MoE with backward and AdamW,
# and the context-parallel KV cache of batch-1 long decode
DRYRUN_COMBOS = (("minicpm-2b", "decode_32k"), ("mixtral-8x22b", "train_4k"),
                 ("gemma3-1b", "long_500k"))
DRYRUN_TIMEOUT = 240


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


def check_served(tag: str, r) -> None:
    """Every app's requests all completed, each once, nothing lost."""
    acc = r.accounting
    log(f"[scheduler] {tag}: accounting {acc}; cold starts "
        f"{r.cold_start_count}; backend counters {r.backend_counters}")
    for cls, st in sorted(r.per_class.items()):
        if not 0 < st.n_completed == st.n_requests:
            raise AssertionError(f"{tag}: app {cls} completed "
                                 f"{st.n_completed}/{st.n_requests}")
    if acc["lost"] or acc["duplicate_completions"] \
            or acc["completed"] != acc["arrivals"]:
        raise AssertionError(f"{tag}: accounting {acc}")


def group_launches(cfg) -> Tuple[Dict[str, int], Dict[str, int]]:
    """Kernel launches in one prefill and in one decode step of ``cfg``,
    from its layer groups: flash once in every attention layer of a
    prefill (shared blocks too; an encoder-decoder's encoder layers and
    its decoder's cross-attention as well); in a step, decode once in
    every full-attention layer (a sliding-window ring decodes on the plain
    path, as in JAX) and flash once in every cross-attention layer; the SSD
    scan once in every Mamba layer of a prefill (its step is plain)."""
    gs = cfg.groups()
    attn = sum(g.count for g in gs if g.kind != "mamba")
    full = sum(g.count for g in gs if g.kind != "mamba" and g.window <= 0)
    cross = sum(g.count for g in gs if g.cross_attn)
    mamba = sum(g.count for g in gs if g.kind == "mamba")
    join = {"attention": cfg.n_enc_layers + attn + cross,
            "decode_attention": 0, "ssd": mamba}
    step = {"attention": cross, "decode_attention": full, "ssd": 0}
    return join, step


def windowed_launches(be, served: Dict[str, Any],
                      runs: Dict[str, int]) -> Dict[str, int]:
    """Launches of a windowed ``torch-batched`` run: per function, every
    bucket's instance prefills and steps once in set-up, runs
    ``calib_runs`` times in calibration, then ``runs[fn]`` batches run;
    a run is one prefill and ``gen_len`` steps."""
    want = {"attention": 0, "decode_attention": 0, "ssd": 0}
    for fn, sm in served.items():
        join, step = group_launches(sm.cfg)
        n_inst = sum(1 for f, _ in be.executor._instances if f == fn)
        prefills = n_inst * (1 + be.calib_runs) + runs[fn]
        steps = (n_inst * (1 + be.calib_runs * sm.gen_len)
                 + runs[fn] * sm.gen_len)
        for op in want:
            want[op] += join[op] * prefills + step[op] * steps
    return want


def release(backend) -> None:
    """Let go of a backend's models (weights, caches) once its run is read.
    The control plane's objects refer to each other (each SGS holds the
    backend's ``drop_invocations``), so a finished simulation waits for the
    cycle collector, and the models on the card with it."""
    for held in ("_instances", "_state"):
        getattr(backend.executor, held, {}).clear()


def tree_to(tree, dev):
    """A parameter or cache tree (dicts, lists, tensors) on ``dev``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, dev) for v in tree]
    return tree.to(dev)


def model_parity(cfg, dev, S: int, steps: int = 4) -> Dict[str, Any]:
    """The model on the card (kernels) against the same weights on the CPU
    (plain versions): weights from seed 0, a B=2 prefill of S tokens (with
    seeded frontend embeddings for a frontend model) and ``steps`` ragged
    decode steps at rows of other depths, teacher-forced by the CPU's
    argmax.  Returns max |logit diff| / max |logit| over every call and the
    greedy agreement; raises on non-finite card logits or a difference
    past 2e-2."""
    import torch
    from repro_torch.models import (decode_step_ragged, init_cache,
                                    init_params, prefill)
    params = {"card": init_params(cfg, seed=0, device=dev)}
    params["cpu"] = tree_to(params["card"], "cpu")
    devs = {"cpu": torch.device("cpu"), "card": dev}
    rng = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, S), generator=rng)
    fe = None
    if cfg.frontend:
        fe = torch.randn(2, cfg.n_frontend_tokens, cfg.d_model,
                         generator=rng).to(cfg.dtype())
    enc_len = cfg.n_frontend_tokens if cfg.arch_type == "encdec" else None
    caches = {d: init_cache(cfg, 2, S + 8, devs[d], enc_len=enc_len)
              for d in devs}
    lg = {d: prefill(cfg, params[d], toks.to(devs[d]), caches[d],
                     None if fe is None else fe.to(devs[d]))[0].float().cpu()
          for d in devs}
    worst, agree, n_tok = 0.0, 0, 0
    t = torch.tensor([S, S - 8], dtype=torch.int32)     # rows at two depths
    for step in range(steps + 1):
        if step:
            lg = {d: decode_step_ragged(cfg, params[d], caches[d],
                                        tok.to(devs[d]),
                                        t.to(devs[d]))[0].float().cpu()
                  for d in devs}
            t = t + 1
        worst = max(worst, ((lg["card"] - lg["cpu"]).abs().max()
                            / lg["cpu"].abs().max()).item())
        tok = lg["cpu"].argmax(-1)                         # teacher-forced
        agree += int((lg["card"].argmax(-1) == tok).sum())
        n_tok += tok.numel()
        if not torch.isfinite(lg["card"]).all():
            raise AssertionError(f"{cfg.name}: non-finite logits on the card")
    if worst > 2e-2:
        raise AssertionError(f"{cfg.name}: card vs CPU logits differ by "
                             f"{worst:.3g}")
    return {"max_rel_logit_diff": worst, "greedy_agree": [agree, n_tok]}


def check_serve(cfg, rep: Dict[str, Any], total: Dict[str, int],
                gen_len: int) -> None:
    """A ``serve()`` report: every request answered with ``gen_len + 1``
    tokens in the vocabulary, finite logits, and each kernel launched as
    the groups say in every join and decode tick, in the serving loop and
    over all of ``serve()`` (set-up runs each bucket's join and step once,
    then calibration counts in the executor's admits and steps)."""
    if rep["completed"] != rep["n_requests"]:
        raise AssertionError(f"{cfg.name}: {rep['completed']}/"
                             f"{rep['n_requests']} requests completed")
    for toks_i in rep["tokens"]:
        if len(toks_i) != gen_len + 1 or not all(0 <= x < cfg.vocab_padded
                                                 for x in toks_i):
            raise AssertionError(f"{cfg.name}: bad generation {toks_i}")
    if not rep["logits_finite"]:
        raise AssertionError(f"{cfg.name}: non-finite logits while serving")
    join, step = group_launches(cfg)
    bc, ex = rep["batcher"], rep["executor"]
    n_buckets = len(rep["bucket_admit_ms"])
    want_loop = {op: join[op] * bc["n_prefill_batches"]
                 + step[op] * bc["n_decode_ticks"] for op in join}
    want_total = {op: join[op] * (ex["n_admits"] + n_buckets)
                  + step[op] * (ex["n_steps"] + n_buckets) for op in join}
    if rep["kernel_launches"] != want_loop or total != want_total:
        raise AssertionError(f"{cfg.name}: kernel launches "
                             f"{rep['kernel_launches']} / {total}, "
                             f"expected {want_loop} / {want_total}")


def scheduler_phase(dev, chat_cfg, ssm_cfg, smi: str, prompt_len: int = 512,
                    gen_len: int = 32, duration: float = 8.0,
                    rps: float = 2.0) -> dict:
    """Phase 8: two tenants, a dense chat app and a Mamba2 completion app,
    served through ``simulate(stack="archipelago")`` with the continuous
    ``torch-batched`` backend; then mamba2-370m alone under ``torch`` and
    windowed ``torch-batched``.  Launch counts are set to 0 before each run
    (calibration included) and read after it."""
    from repro_torch.core import (BatchedTorchBackend, ClusterConfig,
                                  TorchBackend)
    from repro_torch.kernels import ops as kops
    from repro_torch.serving import ServedModel, ServingApp
    from repro_torch.sim import Experiment, simulate

    def experiment(backend, apps, duration, rps, drain):
        return Experiment(
            stack="archipelago", backend=backend,
            workload_factory="serving_apps",
            workload_kwargs=dict(apps=apps, duration=duration, rps=rps,
                                 prewarm_per_fn=1),
            cluster=ClusterConfig(n_sgs=2, workers_per_sgs=2,
                                  cores_per_worker=4, pool_mem_mb=2048.0),
            warmup=0.0, drain=drain)

    fns = {"chat/gen": chat_cfg, "ssm/gen": ssm_cfg}
    apps = [ServingApp("chat", {"chat/gen": ServedModel(
                chat_cfg, prompt_len=prompt_len, gen_len=gen_len)},
                       slack=0.8),
            ServingApp("complete", {"ssm/gen": ServedModel(
                ssm_cfg, prompt_len=prompt_len, gen_len=gen_len)},
                       slack=1.2)]
    backend = BatchedTorchBackend(max_batch=8, batching="continuous",
                                  device=dev)
    # drain: every request completes well inside it (the run stops early
    # in wall time once only the control plane's timers are left)
    exp = experiment(backend, apps, duration, rps, drain=60.0)
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    # calibration (simulate finds the backend calibrated and reuses it),
    # timed apart from the serving run
    backend.build(exp, exp.resolve_workload())
    calib_s = time.perf_counter() - t0
    ex = backend.executor
    # per-function joins, decode ticks and step slots of the serving run
    runs = {fn: {"joins": 0, "ticks": 0, "slots": 0} for fn in fns}
    admit, step = ex.admit, ex.step

    def counted_admit(fn, invs, slots):
        runs[fn]["joins"] += 1
        return admit(fn, invs, slots)

    def counted_step(fn, slots):
        runs[fn]["ticks"] += 1
        runs[fn]["slots"] += len(slots)
        return step(fn, slots)

    ex.admit, ex.step = counted_admit, counted_step
    r = simulate(exp)
    got = kops.launch_counts()
    wall = time.perf_counter() - t0
    log(f"[scheduler] archipelago, torch-batched continuous, minicpm-2b + "
        f"mamba2-370m full width and depth, prompt {prompt_len}, gen "
        f"{gen_len}, {rps} rps each for {duration} s: {r.n_completed}/"
        f"{r.n_requests} requests, data plane {r.data_plane}; calibration "
        f"{calib_s:.1f} s (kernel build {ex.build_seconds:.1f} s), serving "
        f"run {r.wall_s:.1f} s, phase {wall:.1f} s; {smi}")
    for cls, st in sorted(r.per_class.items()):
        log(f"[scheduler] app {cls}: deadline met "
            f"{st.deadline_met_frac}, latency p50 {st.p50 * 1e3:.1f} ms, p99 "
            f"{st.p99 * 1e3:.1f} ms, cold starts {st.cold_starts} "
            f"(simulated clock, advanced by measured device time)")
    check_served("phase 8", r)
    if r.data_plane != {"device": str(dev).split(":")[0],
                        "batching": "continuous"}:
        raise AssertionError(f"phase 8: data plane {r.data_plane}")
    bc = r.backend_counters
    if (sum(v["joins"] for v in runs.values()) != bc["n_prefill_batches"]
            or sum(v["ticks"] for v in runs.values()) != bc["n_decode_ticks"]):
        raise AssertionError(f"phase 8: per-function runs {runs} against "
                             f"the batcher's {bc}")
    # every bucket ran once in set-up and calib_runs times in calibration,
    # join and step; then the serving run's joins and ticks
    pre = len(ex.buckets()) * (1 + backend.calib_runs)
    want = {"attention": chat_cfg.n_layers * (pre + runs["chat/gen"]["joins"]),
            "decode_attention": chat_cfg.n_layers
            * (pre + runs["chat/gen"]["ticks"]),
            "ssd": ssm_cfg.n_layers * (pre + runs["ssm/gen"]["joins"])}
    occupancy = {fn: v["slots"] / max(1, v["ticks"]) for fn, v in runs.items()}
    log(f"[scheduler] per function {runs}; mean decode occupancy "
        f"{occupancy}; launches {got}, expected {want}")
    if got != want:
        raise AssertionError(f"phase 8: kernel launches {got}, expected "
                             f"{want}")
    if min(occupancy.values()) <= 2:
        raise AssertionError(f"phase 8: mean decode occupancy {occupancy} "
                             f"not above 2")
    out = {"result": r.detach_sim().to_dict(), "calibration_s": calib_s,
           "build_s": ex.build_seconds, "phase_s": wall, "runs": runs,
           "occupancy": occupancy, "launches": got,
           "bucket_admit_s": {str(k): v for k, v in ex.bucket_admit_s.items()},
           "bucket_step_s": {str(k): v for k, v in ex.bucket_step_s.items()}}
    release(backend)
    del backend, ex, exp

    # mamba2-370m alone: every prefill (set-up, calibration, serving) runs
    # the SSD scan in each of its layers
    for tag, be in (("torch", TorchBackend(device=dev)),
                    ("torch-batched windowed",
                     BatchedTorchBackend(max_batch=8, device=dev))):
        app = ServingApp("complete", {"ssm/gen": ServedModel(
            ssm_cfg, prompt_len=prompt_len, gen_len=4)}, slack=1.2)
        kops.reset_launch_counts()
        t0 = time.perf_counter()
        r = simulate(experiment(be, [app], 2.0, 4.0, drain=30.0))
        got = kops.launch_counts()
        ex = be.executor
        prefills = len(ex._instances) * (1 + be.calib_runs) + ex.n_executions
        want = {"attention": 0, "decode_attention": 0,
                "ssd": ssm_cfg.n_layers * prefills}
        log(f"[scheduler] {tag}, mamba2-370m, gen 4: {r.n_completed}/"
            f"{r.n_requests} requests, {prefills} prefills, launches {got}, "
            f"expected {want}; {time.perf_counter() - t0:.1f} s")
        check_served(tag, r)
        if got != want:
            raise AssertionError(f"{tag}: kernel launches {got}, expected "
                                 f"{want}")
        out[tag] = {"result": r.detach_sim().to_dict(), "launches": got,
                    "prefills": prefills}
        release(be)
    return out


def zoo_phase(dev, smi: str, zoo, *, parity_len: int = 130,
              prompt_len: int = 256, gen_len: int = 8, n_requests: int = 8,
              max_batch: int = 8, windowed_s: float = 2.0,
              windowed_rps: float = 4.0) -> Dict[str, Any]:
    """Phase 9: the architectures ported after the two main paths.  For each
    ``(name, parity cfg, serve cfg, route)`` of ``zoo``: ``model_parity`` at
    published width on the fewest layers that hold every group kind; then
    a short serve at published width through the normal entry point,
    ``serve()`` (continuous batching) or, for a model that continuous
    batching refuses (a frontend or an encoder, as in JAX),
    ``simulate(stack="archipelago")`` on windowed ``torch-batched``; each
    kernel's launches are held to what the model's groups give."""
    import torch
    from repro_torch.core import BatchedTorchBackend, ClusterConfig
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.serve import serve
    from repro_torch.serving import ServedModel, ServingApp
    from repro_torch.sim import Experiment, simulate
    on_card = dev.type == "cuda"
    out = {}
    for name, cfg_p, cfg_s, route in zoo:
        t0 = time.perf_counter()
        par = model_parity(cfg_p, dev, parity_len)
        frames = (f" + {cfg_p.n_frontend_tokens} {cfg_p.frontend} frames"
                  if cfg_p.frontend else "")
        log(f"[zoo] {name} full width, {cfg_p.n_layers} layers"
            + (f" + {cfg_p.n_enc_layers} encoder" if cfg_p.n_enc_layers
               else "")
            + f", {cfg_p.compute_dtype}, prefill B=2 S={parity_len}{frames} "
            f"+ 4 ragged steps: max |logit diff| / max |logit| = "
            f"{par['max_rel_logit_diff']:.3g} (bound 2e-2); greedy agreement "
            f"{par['greedy_agree'][0]}/{par['greedy_agree'][1]}")
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        join, step = group_launches(cfg_s)
        kops.reset_launch_counts()
        if route == "continuous":
            rep = serve(cfg_s, n_requests=n_requests, rps=None,
                        prompt_len=prompt_len, gen_len=gen_len,
                        max_batch=max_batch, device=dev, seed=0)
            got = kops.launch_counts()
            check_serve(cfg_s, rep, got, gen_len)
            bc = rep["batcher"]
            log(f"[zoo] {name} serve(), {cfg_s.n_layers} layers, prompt "
                f"{prompt_len}, gen {gen_len}: {rep['completed']}/"
                f"{rep['n_requests']} requests, {bc['n_prefill_batches']} "
                f"joins, {bc['n_decode_ticks']} ticks, latency p50 "
                f"{rep['latency_p50_s'] * 1e3:.1f} ms p99 "
                f"{rep['latency_p99_s'] * 1e3:.1f} ms, token gap p50 "
                f"{rep['token_gap_p50_s'] * 1e3:.2f} ms")
            res = {"serve": {k: v for k, v in rep.items()
                             if k not in ("tokens", "device_name")}}
        else:
            be = BatchedTorchBackend(max_batch=4, batching="windowed",
                                     device=dev)
            # (a class is the dag_id up to its first "-")
            app = ServingApp("zoo", {"gen": ServedModel(
                cfg_s, prompt_len=prompt_len, gen_len=gen_len)}, slack=1.5)
            r = simulate(Experiment(
                stack="archipelago", backend=be,
                workload_factory="serving_apps",
                workload_kwargs=dict(apps=[app], duration=windowed_s,
                                     rps=windowed_rps, prewarm_per_fn=1),
                cluster=ClusterConfig(n_sgs=2, workers_per_sgs=2,
                                      cores_per_worker=4, pool_mem_mb=2048.0),
                warmup=0.0, drain=60.0))
            got = kops.launch_counts()
            check_served(f"zoo {name}", r)
            want = windowed_launches(be, app.models,
                                     {"gen": be.executor.n_executions})
            if got != want:
                raise AssertionError(f"{name}: kernel launches {got}, "
                                     f"expected {want}")
            st = r.per_class["zoo"]
            log(f"[zoo] {name} simulate(archipelago), windowed "
                f"torch-batched, {cfg_s.n_layers} layers, prompt "
                f"{prompt_len}, gen {gen_len}: {r.n_completed}/"
                f"{r.n_requests} requests in {be.executor.n_executions} "
                f"batches, latency p50 {st.p50 * 1e3:.1f} ms p99 "
                f"{st.p99 * 1e3:.1f} ms")
            res = {"result": r.detach_sim().to_dict()}
            release(be)
            del be
        log(f"[zoo] {name}: launches {got} (per prefill {join}, per step "
            f"{step}); peak memory "
            + (f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
               if on_card else "not measured")
            + f"; {time.perf_counter() - t0:.1f} s; {smi}")
        out[name] = {"parity": par, "launches": got, "per_prefill": join,
                     "per_step": step, "n_layers": cfg_s.n_layers,
                     "phase_s": time.perf_counter() - t0, **res}
        if on_card:
            out[name]["max_memory_allocated"] = \
                torch.cuda.max_memory_allocated(dev)
            torch.cuda.empty_cache()
    return out


def published(apps, get_config, layers: Dict[str, int]):
    """``apps`` with each model at its published configuration (a reduced
    config keeps its architecture's name), cut to ``layers[name]`` layers
    where given; function names, prompts, generation lengths, edges and
    slacks kept."""
    def full(cfg):
        cfg = get_config(cfg.name)
        return cfg.with_(n_layers=layers[cfg.name]) \
            if cfg.name in layers else cfg
    return [dataclasses.replace(a, models={
        fn: dataclasses.replace(sm, cfg=full(sm.cfg))
        for fn, sm in a.models.items()}) for a in apps]


def multitenant_phase(dev, smi: str, apps, *, duration: float, rps: float,
                      max_batch: int = 4, n_sgs: int = 3,
                      prewarm_per_fn: int = 3) -> Dict[str, Any]:
    """Phase 10: ``multitenant_apps``' tenants under Archipelago on one
    card: ``simulate(stack="archipelago")`` with windowed ``torch-batched``
    (continuous batching refuses the VLM, as in JAX), after the base
    experiment of ``benchmarks/bench_serving.py`` (``rps`` per app,
    ``prewarm_per_fn`` sandboxes a function, ``n_sgs`` SGSs of two workers
    of two cores), shortened to ``duration`` s with no warm-up.  Asserts
    that every request completes once, that every function of a request's
    DAG runs once and its edges in order, and each model's launches."""
    import torch
    from repro_torch.core import BatchedTorchBackend, ClusterConfig
    from repro_torch.kernels import ops as kops
    from repro_torch.sim import Experiment, simulate
    on_card = dev.type == "cuda"
    be = BatchedTorchBackend(max_batch=max_batch, batching="windowed",
                             device=dev)
    exp = Experiment(
        stack="archipelago", backend=be, workload_factory="serving_apps",
        workload_kwargs=dict(apps=apps, duration=duration, rps=rps,
                             prewarm_per_fn=prewarm_per_fn),
        cluster=ClusterConfig(n_sgs=n_sgs, workers_per_sgs=2,
                              cores_per_worker=2),
        warmup=0.0, drain=60.0)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    be.build(exp, exp.resolve_workload())      # calibration, reused below
    calib_s = time.perf_counter() - t0
    ex = be.executor
    ran, runs = [], {fn: 0 for fn in ex.served}
    run_batch = ex.run_batch

    def counted(fn, invs):
        runs[fn] += 1
        ran.extend((inv.request.req_id, fn) for inv in invs)
        return run_batch(fn, invs)

    ex.run_batch = counted
    try:
        r = simulate(exp)
    finally:
        del ex.run_batch        # the wrapper and the executor: a cycle
    got = kops.launch_counts()
    wall = time.perf_counter() - t0
    check_served("phase 10", r)
    # every function of each request's DAG once, its edges in order
    app_of = {fn: a for a in apps for fn in a.models}
    order: Dict[int, list] = {}
    for req, fn in ran:
        order.setdefault(req, []).append(fn)
    for req, fns in order.items():
        a = app_of[fns[0]]
        if sorted(fns) != sorted(a.models) or any(
                fns.index(u) > fns.index(v) for u, v in a.edges):
            raise AssertionError(f"phase 10: request {req} of {a.dag_id} "
                                 f"ran {fns}")
    per_fn = {fn: windowed_launches(be, {fn: sm}, runs)
              for fn, sm in ex.served.items()}
    want = {op: sum(w[op] for w in per_fn.values()) for op in got}
    log(f"[multitenant] archipelago, windowed torch-batched (max_batch "
        f"{max_batch}), {len(apps)} apps at published width "
        + ", ".join(f"{fn} {sm.cfg.name} {sm.cfg.n_layers} layers"
                    for fn, sm in ex.served.items())
        + f"; {rps} rps per app for {duration} s: {r.n_completed}/"
        f"{r.n_requests} requests, batches per function {runs}, "
        f"{sum(order.get(q, []) == ['vlm/embed', 'vlm/decode'] for q in order)}"
        f" caption DAGs in order; calibration {calib_s:.1f} s, phase "
        f"{wall:.1f} s; {smi}")
    for cls, st in sorted(r.per_class.items()):
        log(f"[multitenant] app {cls}: deadline met {st.deadline_met_frac}, "
            f"latency p50 {st.p50 * 1e3:.1f} ms, p99 {st.p99 * 1e3:.1f} ms, "
            f"cold starts {st.cold_starts} (simulated clock, advanced by "
            f"measured device time)")
    log(f"[multitenant] launches {got}, expected {want}, per function "
        f"{per_fn}; cold starts {r.cold_start_count}; peak memory "
        + (f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
           if on_card else "not measured"))
    if got != want:
        raise AssertionError(f"phase 10: kernel launches {got}, expected "
                             f"{want}")
    out = {"result": r.detach_sim().to_dict(), "calibration_s": calib_s,
           "phase_s": wall, "batches": runs, "launches": got,
           "per_function_launches": per_fn,
           "bucket_exec_s": {f"{fn}/{b}": v
                             for (fn, b), v in ex.bucket_exec_s.items()}}
    if on_card:
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    release(be)
    return out


def function_grad_parity(dev) -> Dict[str, Any]:
    """Phase 11 (a): each kernel's Function against its plain version on
    the same inputs and cotangent, bf16 and f32: the forward output (the
    kernel, launched under autograd) and the gradients; raises past
    ``TOL`` / ``SSD_TOL`` or ``GRAD_TOL``.  Returns, per kernel and dtype,
    the largest forward error and relative gradient error, and the errors
    at the training shape (each table's last case)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def run(f, inputs, w):
        """f's outputs (a tuple) and the gradients of sum(w * y[0])."""
        xs = [t.detach().requires_grad_(True) for t in inputs]
        out = f(*xs)
        out = out if isinstance(out, tuple) else (out,)
        return out, torch.autograd.grad((out[0].float() * w).sum(), xs)

    cases = []
    for c in TRAIN_FA_CASES:
        B, Sq, Sk, Hq, Hkv, hd, causal, win = c
        kw = dict(causal=causal, window=win)
        cases.append((
            "flash_attention", c, flash_attention,
            lambda q, k, v, kw=kw: flash_attention(q, k, v, **kw),
            lambda q, k, v, kw=kw: flash_attention_plain(q, k, v, **kw),
            lambda dt, s=(B, Sq, Sk, Hq, Hkv, hd): [
                rnd(s[0], s[1], s[3], s[5], dtype=dt),
                rnd(s[0], s[2], s[4], s[5], dtype=dt),
                rnd(s[0], s[2], s[4], s[5], dtype=dt)],
            (B, Sq, Hq, hd), lambda dn: (TOL[dn],)))
    for c in TRAIN_SSD_CASES:
        B, S, H, P, N, Q = c
        cases.append((
            "ssd_scan", c, ssd_scan,
            lambda *a, Q=Q: ssd_scan(*a, chunk=Q),
            lambda *a, Q=Q: ssd_scan_plain(*a, chunk=Q),
            lambda dt, s=(B, S, H, P, N): [
                rnd(s[0], s[1], s[2], s[3], dtype=dt),
                F.softplus(rnd(s[0], s[1], s[2])).to(dt),
                -torch.exp(0.5 * rnd(s[2])),
                rnd(s[0], s[1], s[4], dtype=dt),
                rnd(s[0], s[1], s[4], dtype=dt)],
            (B, S, H, P), lambda dn: SSD_TOL[dn]))
    last = {"flash_attention": TRAIN_FA_CASES[-1],
            "ssd_scan": TRAIN_SSD_CASES[-1]}
    worst: Dict[str, Any] = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        for kname, case, wrapper, fn, plain, make, out_shape, tols in cases:
            inputs, w = make(dtype), rnd(*out_shape)
            before = wrapper.launches
            out_fn, g_fn = run(fn, inputs, w)
            launched = wrapper.launches - before
            out_plain, g_plain = run(plain, inputs, w)
            torch.cuda.synchronize()
            fwd, bad = [], 0
            for a, b, tol in zip(out_fn, out_plain, tols(dn)):
                err = (a.float() - b.float()).abs()
                fwd.append(err.max().item())
                bad += (err > tol + tol * b.float().abs()).sum().item()
            grad = [((a.float() - b.float()).abs().max()
                     / b.float().abs().max()).item()
                    for a, b in zip(g_fn, g_plain)]
            log(f"[train] {kname} {case} {dn}: forward max_abs_err "
                + ", ".join(f"{e:.3g}" for e in fwd) + " (tol "
                + ", ".join(map(str, tols(dn))) + " + tol * |plain|); "
                "gradient max |diff| / max |plain| per input "
                + ", ".join(f"{e:.3g}" for e in grad)
                + f" (tol {GRAD_TOL[kname][dn]})")
            if bad or launched != 1:
                raise AssertionError(f"phase 11: {kname} {case} {dn}: {bad} "
                                     f"forward elements outside tolerance, "
                                     f"{launched} launches")
            if any(not e <= GRAD_TOL[kname][dn] for e in grad) or any(
                    a.dtype != t.dtype for a, t in zip(g_fn, inputs)):
                raise AssertionError(f"phase 11: {kname} {case} {dn} "
                                     f"gradients {grad}")
            key = worst.setdefault(kname, {}).setdefault(dn, {
                "max_abs_err": 0.0, "max_rel_grad_err": 0.0})
            key["max_abs_err"] = max(key["max_abs_err"], fwd[0])
            key["max_rel_grad_err"] = max(key["max_rel_grad_err"], max(grad))
            if case == last[kname]:
                key["train_shape"] = {"case": case, "max_abs_err": fwd,
                                      "max_rel_grad_err": grad}
    return worst


def model_grad_parity(cfg, dev, S: int) -> Dict[str, Any]:
    """Phase 11 (b): ``lm_loss`` and the gradient of every leaf on the card
    (kernels, remat) against the same weights on the CPU (plain versions),
    float32, B = 2 x S tokens; raises past ``MODEL_GRAD_TOL``."""
    import torch
    from repro_torch.models import init_params, lm_loss
    from repro_torch.train.tree import leaves_with_paths
    params = {"card": init_params(cfg, seed=0, device=dev)}
    params["cpu"] = tree_to(params["card"], "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, S),
                         generator=torch.Generator().manual_seed(2))
    got = {}
    for d, p in params.items():
        paths, flat = zip(*leaves_with_paths(p))
        for t in flat:
            t.requires_grad_(True)
        loss = lm_loss(cfg, p, toks.to(flat[0].device))
        got[d] = (loss.item(), dict(zip(
            ("/".join(x) for x in paths),
            (g.cpu() for g in torch.autograd.grad(loss, flat)))))
    worst, worst_key = 0.0, None
    for key, g in got["cpu"][1].items():
        gc = got["card"][1][key]
        scale = g.abs().max().item()
        err = (gc - g).abs().max().item() / scale if scale else float("inf")
        if not (err <= MODEL_GRAD_TOL and torch.isfinite(gc).all()):
            raise AssertionError(f"phase 11: {cfg.name} gradient of {key} "
                                 f"differs by {err:.3g} of max |g| {scale}")
        if err >= worst:
            worst, worst_key = err, key
    rel_loss = abs(got["card"][0] - got["cpu"][0]) / abs(got["cpu"][0])
    if rel_loss > 1e-4:
        raise AssertionError(f"phase 11: {cfg.name} loss {got['card'][0]} "
                             f"on the card, {got['cpu'][0]} on the CPU")
    return {"loss_card": got["card"][0], "loss_cpu": got["cpu"][0],
            "rel_loss_diff": rel_loss, "n_leaves": len(got["cpu"][1]),
            "max_rel_grad_diff": worst, "worst_leaf": worst_key}


def train_run(cfg, dev, smi: str, *, steps: int, batch: int, seq: int,
              lr: float) -> Dict[str, Any]:
    """Phase 11 (c): ``launch.train``'s ``Trainer`` for ``steps`` AdamW
    steps on ``SyntheticLM`` batches.  Asserts finite losses, the last
    below the first, a finite non-zero gradient on every leaf (the first
    step's first moment is a tenth of its clipped gradient), every leaf
    changed, and each kernel launched twice a layer a step (forward and
    remat recompute).  Then times one more step under the profiler, as
    phase 7 does."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.train import Trainer
    from repro_torch.train.tree import leaves_with_paths
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tr = Trainer(cfg, steps=steps, batch=batch, seq=seq, lr=lr, device=dev)
    start = {"/".join(p): t.detach().to("cpu", copy=True)
             for p, t in leaves_with_paths(tr.params)}
    per_layer = {"attention": sum(g.count for g in cfg.groups()
                                  if g.kind != "mamba"),
                 "decode_attention": 0,
                 "ssd": sum(g.count for g in cfg.groups()
                            if g.kind == "mamba")}
    losses, secs = [], []
    kops.reset_launch_counts()
    for step in range(steps):
        before = kops.launch_counts()
        loss, sec = tr.step(tr.data.batch(step))
        after = kops.launch_counts()
        losses.append(loss)
        secs.append(sec)
        got = {op: after[op] - before[op] for op in after}
        want = {op: 2 * n for op, n in per_layer.items()}
        if got != want:
            raise AssertionError(f"phase 11: {cfg.name} step {step} "
                                 f"launches {got}, expected {want}")
        if step == 0:
            for path, m in leaves_with_paths(tr.opt.mu):
                if not (torch.isfinite(m).all() and m.abs().max() > 0):
                    raise AssertionError(f"phase 11: {cfg.name} gradient "
                                         f"of {'/'.join(path)} is not "
                                         f"finite and non-zero")
    launches = kops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[train] {cfg.name}: losses " + " ".join(f"{x:.4f}" for x in
                                                  losses))
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < \
            losses[0]:
        raise AssertionError(f"phase 11: {cfg.name} losses {losses}")
    unchanged = [k for k, t in leaves_with_paths(tr.params)
                 if torch.equal(t.detach().cpu(), start["/".join(k)])]
    if unchanged:
        raise AssertionError(f"phase 11: {cfg.name} leaves unchanged by "
                             f"training: {unchanged[:8]}")
    wall_ms = sorted(secs[1:])[len(secs[1:]) // 2] * 1e3
    batch_np = tr.data.batch(steps)
    prof = device_profile(lambda: tr.step(batch_np)[1], runs=1)
    idle = (1 - prof["device_busy_ms"] / wall_ms
            if prof["device_busy_ms"] else None)
    prof.update(unprofiled_ms=wall_ms, idle_share=idle)
    tps = tr.tokens_per_step / (wall_ms / 1e3)
    log(f"[train] {cfg.name} B {batch} x S {tr.data.cfg.seq_len}: step "
        f"{wall_ms:.1f} ms (median of steps 2-{steps}; first "
        f"{secs[0] * 1e3:.1f} ms), {tps:,.0f} tokens/s, peak memory "
        f"{peak / 2**30:.2f} GiB; profiled step: device busy "
        f"{prof['device_busy_ms']:.1f} ms (idle share "
        f"{'not measured' if idle is None else f'{idle:.2f}'}), "
        f"{prof['launch_calls']:.0f} kernel launch calls; top kernels "
        f"(ms): " + ", ".join(f"{n[:40]} {t:.2f}" for n, t in prof["top"])
        + f"; launches {launches}; {smi}")
    out = {"losses": losses, "step_ms": [x * 1e3 for x in secs],
           "median_step_ms": wall_ms, "tokens_per_s": tps,
           "peak_memory_bytes": peak, "launches": launches,
           "profile": prof, "phase_s": time.perf_counter() - t0}
    del tr, start
    torch.cuda.empty_cache()
    return out


def dryrun_phase(smi: str) -> Dict[str, Any]:
    """Phase 12 (a): ``python -m repro_torch.launch.dryrun`` for each of
    ``DRYRUN_COMBOS`` at full width and depth on the (data 32, model 8)
    mesh of 256 fake ranks, one process each, all at once (host work on
    meta tensors: nothing runs on the card).  Asserts non-zero FLOPs and
    bytes and collectives over some axis; prints the three roofline terms
    and the arguments' bytes a device against the card's 80 GB."""
    import os
    from repro_torch.launch.dryrun import RESULTS_DIR
    from repro_torch.launch.mesh import HBM_BYTES
    from repro_torch.launch.roofline import terms
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    procs = {c: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", c[0],
         "--shape", c[1], "--mesh", "single", "--force"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in DRYRUN_COMBOS}
    out = {}
    try:
        for (arch, shape), p in procs.items():
            text = p.communicate(timeout=DRYRUN_TIMEOUT)[0]
            if p.returncode:
                raise AssertionError(f"phase 12: the dry-run of {arch} x "
                                     f"{shape} failed:\n{text[-3000:]}")
            rec = json.loads((RESULTS_DIR / f"{arch}__{shape}__single.json"
                              ).read_text())
            if not (rec["flops"] > 0 and rec["bytes_accessed"] > 0
                    and rec["coll_by_axis"]):
                raise AssertionError(f"phase 12: {arch} x {shape} counted "
                                     f"nothing: {rec}")
            t = terms(rec)
            arg = rec["argument_size_in_bytes"]
            log(f"[dryrun] {arch} x {shape} on {rec['mesh']} "
                f"({rec['n_devices']} fake ranks, fsdp {rec['fsdp']}; "
                f"trace {rec['trace_s']} s): per device {rec['flops']:.4g} "
                f"flop, {rec['bytes_accessed']:.4g} bytes, collectives "
                + ", ".join(f"{a} {b:.4g}" for a, b in
                            rec["coll_by_axis"].items())
                + f" bytes; compute {t['compute_s'] * 1e3:.3f} ms, memory "
                f"{t['memory_s'] * 1e3:.3f} ms, collective "
                f"{t['collective_s'] * 1e3:.3f} ms (H100 data sheet, not "
                f"measured); arguments {arg / 1e9:.2f} GB a device of the "
                f"card's {HBM_BYTES / 1e9:.0f} GB")
            out[f"{arch}:{shape}"] = {**rec, **t}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    out["phase_s"] = time.perf_counter() - t0
    return out


def anchor_work(cfg, *, batch: int = 8, prompt: int = 512,
                cache_len: int = 544, train_batch: int = TRAIN_BATCH,
                train_seq: int = TRAIN_SEQ) -> Dict[str, Dict[str, float]]:
    """Phase 12 (b): ``DeviceCostMode``'s count, on meta tensors, of the
    work phase 7 timed (a bucket-``batch`` join of ``prompt`` tokens into a
    cache of ``cache_len``, and a decode step over it) and phase 11 timed
    (a training step at ``train_batch`` x ``train_seq``), the three hot
    spots priced as their kernels (``kernels_priced``); with the bound on
    one H100: the larger of flop / 989e12 and bytes / 3.35e12.  Runs on any
    host: nothing is allocated."""
    import torch
    from repro_torch.launch.cost import DeviceCostMode, kernels_priced
    from repro_torch.models import (decode_step_ragged, init_cache,
                                    init_params, prefill)
    from repro_torch.train import adamw_init, make_train_step

    def price(call) -> Dict[str, float]:
        with DeviceCostMode() as mode, kernels_priced(mode):
            call()
        f_ms = mode.flops / BF16_FLOPS * 1e3
        b_ms = mode.bytes / HBM_BYTES_PER_S * 1e3
        return {"flops": mode.flops, "bytes": mode.bytes,
                "bound_ms": max(f_ms, b_ms),
                "bound_by": "operations" if f_ms > b_ms else "bytes"}

    def meta(*shape, dtype=torch.long):
        return torch.empty(shape, dtype=dtype, device="meta")

    params = init_params(cfg, device="meta")
    cache = init_cache(cfg, batch, cache_len, device="meta")
    with torch.no_grad():
        join = price(lambda: prefill(cfg, params, meta(batch, prompt),
                                     cache))
        step = price(lambda: decode_step_ragged(
            cfg, params, cache, meta(batch, 1),
            torch.full((batch,), prompt, dtype=torch.int32, device="meta")))
    opt = adamw_init(params)
    train = price(lambda: make_train_step(cfg)(
        params, opt, meta(train_batch, train_seq)))
    return {"join": join, "step": step, "train": train}


def anchor_phase(report: Dict[str, Any], get_config,
                 smi: str) -> Dict[str, Any]:
    """Phase 12 (b): each main path's bucket-8 join and decode step
    (phase 7) and training step (phase 11), priced by ``anchor_work``,
    against the device-busy ms the card measured in this run.  A bound
    above the card's own time means the count is wrong: it raises."""
    out = {}
    for model in ("minicpm-2b", "mamba2-370m"):
        work = anchor_work(get_config(model))
        busy = {"join": report["profile"][model]["join"]["device_busy_ms"],
                "step": report["profile"][model]["step"]["device_busy_ms"],
                "train": report["train"][model]["profile"]["device_busy_ms"]}
        for what, w in work.items():
            w.update(busy_ms=busy[what], busy_over_bound=(
                busy[what] / w["bound_ms"]))
            log(f"[anchor] {model} {what}: {w['flops']:.4g} flop, "
                f"{w['bytes']:.4g} bytes (DeviceCostMode, kernels as "
                f"kernels): bound {w['bound_ms']:.3f} ms ({w['bound_by']}); "
                f"device busy {busy[what]:.3f} ms; busy / bound "
                f"{w['busy_over_bound']:.2f}; {smi}")
            if w["bound_ms"] > busy[what]:
                raise AssertionError(
                    f"phase 12: {model} {what}: the cost model's bound "
                    f"{w['bound_ms']:.3f} ms exceeds the card's "
                    f"{busy[what]:.3f} ms busy")
        out[model] = work
    return out


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
    from repro_torch.serving import ContinuousTorchExecutor, ServedModel
    from repro_torch.serving.apps import multitenant_apps

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
    report["spills"] = {}
    for src in _build.SOURCES:
        lines = _build.ptxas_log(src).read_text().splitlines()
        regs = [ln.split("Used ")[1].split(",")[0] for ln in lines
                if "Used " in ln]
        # "Function properties for <mangled name>", then its spill line
        spills, fn = {}, None
        for ln in lines:
            if "Function properties for" in ln:
                fn = ln.split("Function properties for")[1].strip()
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m and fn and (int(m[1]) or int(m[2])):
                spills[fn] = (int(m[1]), int(m[2]))
        report["spills"][src] = spills
        log(f"[build] {src}: {len(regs)} instantiations, ptxas: "
            f"{sorted(set(regs))}, {len(spills)} with spills"
            + "".join(f"; {fn}: {st} / {ld} bytes spill stores / loads"
                      for fn, (st, ld) in spills.items()))
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
        # the hd 256 flash instance (gemma3) has its own schedule
        if src == "flash_attention" and not any(
                "fa_kernel_wgmmaILi256E" in fn for fn in hgmma):
            raise AssertionError("the bf16 flash kernel at hd 256 holds no "
                                 "HGMMA instruction")
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

    def time_ms(fn, runs=25, warmup=3, sleep=1_000_000):
        """Median of ``runs`` CUDA-event timings, L2 flushed before each
        (the serving path meets every layer's tensors cold).  A device-side
        sleep of ``sleep`` cycles after the flush (about half a millisecond
        by default; ``PLAIN_SLEEP`` for a plain version's many launches)
        keeps the card busy while the host enqueues ``fn``, so the interval
        between the events holds the device's time for ``fn`` and not the
        host's time to reach its launch."""
        for _ in range(warmup):
            fn()
        ts = []
        for _ in range(runs):
            flush.zero_()
            torch.cuda._sleep(sleep)
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

    def time_fa(B, plain=True, S=512, H=36, hd=64, Hkv=None):
        """A join's attention at bucket B (minicpm-2b's by default):
        kernel, plain version and SDPA in turn, on the same inputs."""
        Hkv = Hkv or H
        q = rnd(B, S, H, hd, dtype=bf)
        k, v = (rnd(B, S, Hkv, hd, dtype=bf) for _ in range(2))
        t = {"ms": time_ms(lambda: flash_attention(q, k, v, causal=True)),
             "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                 q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                 is_causal=True, enable_gqa=Hkv != H))}
        if plain:
            t["plain_ms"] = time_ms(lambda: flash_attention_plain(
                q, k, v, causal=True), sleep=PLAIN_SLEEP)
        # q, k, v read once and o (q's shape) written once; causal pairs
        t.update(bound((2 * q.numel() + k.numel() + v.numel())
                       * q.element_size(),
                       4 * hd * B * H * S * (S + 1) // 2))
        return t

    def time_dec(B, plain=True, L=544, H=36, hd=64, Hkv=None):
        """A step's attention at bucket B (minicpm-2b's by default), every
        row at valid_len L."""
        Hkv = Hkv or H
        qd = rnd(B, H, hd, dtype=bf)
        kd, vd = rnd(B, L, Hkv, hd, dtype=bf), rnd(B, L, Hkv, hd, dtype=bf)
        vlen = torch.full((B,), L, dtype=torch.int32, device=dev)
        t = {"ms": time_ms(lambda: decode_attention(qd, kd, vd, vlen)),
             "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                 qd[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2),
                 enable_gqa=Hkv != H))}
        if plain:
            t["plain_ms"] = time_ms(lambda: decode_attention_plain(
                qd, kd, vd, vlen), sleep=PLAIN_SLEEP)
        live = int(vlen.sum().item())
        t.update(bound(2 * qd.numel() * qd.element_size()
                       + 2 * live * Hkv * hd * kd.element_size()
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
    # gemma3-1b at hd 256 (4 heads over 1 KV head): its join's attention
    # (a global layer's, causal over the prompt) and its global decode
    hd256 = {"flash_attention": [time_fa(b, S=512, H=4, Hkv=1, hd=256)
                                 for b in (8, 1)],
             "decode_attention": [time_dec(b, L=544, H=4, Hkv=1, hd=256)
                                  for b in (8, 1)]}
    for kname, (t8, t1) in hd256.items():
        t8.update(ms_bucket1=t1["ms"], library_ms_bucket1=t1["library_ms"],
                  plain_ms_bucket1=t1["plain_ms"],
                  bound_ms_bucket1=t1["bound_ms"])
        hd256[kname] = t8
        log(f"[timing] {kname} gemma3-1b hd 256 (B x 512/544 x 4/1 heads): "
            + ", ".join(f"bucket {b}: kernel {t8[m]:.4f} ms, plain "
                        f"{t8[pm]:.4f} ms, library {t8[lm]:.4f} ms, bound "
                        f"{t8[bm] * 1e3:.2f} us"
                        for b, m, pm, lm, bm in (
                            (8, "ms", "plain_ms", "library_ms", "bound_ms"),
                            (1, "ms_bucket1", "plain_ms_bucket1",
                             "library_ms_bucket1", "bound_ms_bucket1")))
            + f" ({t8['bound_by']}); {smi}")

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
                                                           chunk=Q),
                                    sleep=PLAIN_SLEEP)
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

    # The two main paths: the model and its parity prompt length (130 is
    # no multiple of mamba2's chunk of 64, so the SSD padding runs on the
    # card); where each kernel launches comes from the model's groups.
    paths = (("minicpm-2b", 128), ("mamba2-370m", 130))
    report["model_parity"], report["serve"], report["profile"] = {}, {}, {}
    path_launches = {}
    for model, S_par in paths:
        # -- 5. model parity at full width: card (kernels) vs CPU (plain) -----
        cfg2 = get_config(model).with_(n_layers=2)
        par = model_parity(cfg2, dev, S_par)
        log(f"[model] {model} full width, 2 layers, prefill B=2 S={S_par} + "
            f"4 ragged steps: max |logit diff| / max |logit| = "
            f"{par['max_rel_logit_diff']:.3g} (bound 2e-2); greedy agreement "
            f"{par['greedy_agree'][0]}/{par['greedy_agree'][1]}")
        report["model_parity"][model] = par
        torch.cuda.empty_cache()

        # -- 6. serve: full-width, full-depth -----------------------------------
        cfg = get_config(model)
        kops.reset_launch_counts()
        rep = serve(cfg, n_requests=16, rps=None, prompt_len=512,
                    gen_len=32, max_batch=8, device=dev, seed=0)
        total = kops.launch_counts()
        path_launches[model] = total
        bc = rep["batcher"]
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
        check_serve(cfg, rep, total, 32)
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

    # -- 8. Archipelago: the control plane over the card ------------------------
    report["scheduler"] = scheduler_phase(dev, get_config("minicpm-2b"),
                                          get_config("mamba2-370m"), smi)
    torch.cuda.empty_cache()

    # -- 9. the rest of the zoo at published width -------------------------------
    f32 = dict(compute_dtype="float32", param_dtype="float32")
    zoo = [(arch, get_config(arch).with_(**par), get_config(arch).with_(**srv),
            route) for arch, par, srv, route in (
        # parity on the fewest layers that hold every group kind; the MoE
        # models' in float32 (a bf16 router can flip a near tie between the
        # two devices, and with it a token's experts); served at published
        # depth but the MoE models, at the depth that fits the card
        ("gemma3-1b", dict(n_layers=2), {}, "continuous"),
        ("minitron-8b", dict(n_layers=1), {}, "continuous"),
        ("phi3-mini-3.8b", dict(n_layers=1), {}, "continuous"),
        ("phi-3-vision-4.2b", dict(n_layers=1), {}, "windowed"),
        ("zamba2-1.2b", dict(n_layers=6), {}, "continuous"),
        ("whisper-tiny", dict(n_layers=1, n_enc_layers=1), {}, "windowed"),
        ("mixtral-8x22b", dict(n_layers=1, **f32),
         dict(n_layers=MOE_LAYERS), "continuous"),
        ("llama4-scout-17b-a16e", dict(n_layers=1, **f32),
         dict(n_layers=MOE_LAYERS), "continuous"))]
    report["zoo"] = zoo_phase(dev, smi, zoo)

    # -- 10. multitenant_apps at published width under Archipelago ---------------
    report["multitenant"] = multitenant_phase(
        dev, smi, published(multitenant_apps(), get_config,
                            {"mixtral-8x22b": MOE_LAYERS}),
        duration=MT_DURATION, rps=MT_RPS)
    torch.cuda.empty_cache()

    # -- 11. training on the card ---------------------------------------------------
    log(f"[train] {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB "
        f"allocated before phase 11")
    report["train"] = {"function_grad": function_grad_parity(dev)}
    for model, S_par in paths:
        f32cfg = get_config(model).with_(n_layers=2, compute_dtype="float32",
                                         param_dtype="float32")
        par = model_grad_parity(f32cfg, dev, S_par)
        log(f"[train] {model} full width, 2 layers, f32, B=2 S={S_par}: "
            f"lm_loss {par['loss_card']:.6f} card / {par['loss_cpu']:.6f} "
            f"CPU; max |grad diff| / max |grad| over {par['n_leaves']} "
            f"leaves {par['max_rel_grad_diff']:.3g} ({par['worst_leaf']}; "
            f"bound {MODEL_GRAD_TOL})")
        torch.cuda.empty_cache()
        run = train_run(get_config(model), dev, smi, steps=TRAIN_STEPS,
                        batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                        lr=TRAIN_LR[model])
        report["train"][model] = {"grad_parity": par, **run}

    # -- 12. the dry-run, and its cost model against the card -----------------
    report["dryrun"] = dryrun_phase(smi)
    report["anchor"] = anchor_phase(report, get_config, smi)

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
                        # this slice's path: phase 10's multi-tenant run
                        "launches_multitenant":
                            report["multitenant"]["launches"][op],
                        # phase 11's training steps of the model
                        **({"launches_train": report["train"][model][
                            "launches"][op]} if op != "decode_attention"
                           else {}),
                        "max_abs_err": errs[kname][(case, "bfloat16")],
                        # phase 11 (a): bf16, under autograd, at the
                        # training shape
                        **({"max_abs_err_train": report["train"][
                            "function_grad"][kname]["bfloat16"][
                            "train_shape"]["max_abs_err"][0]}
                           if kname in report["train"]["function_grad"]
                           else {}),
                        "ms": tm["ms"], "plain_ms": tm["plain_ms"],
                        "bound_ms": tm["bound_ms"],
                        "bound_by": tm["bound_by"],
                        "library_ms": tm["library_ms"],
                        **{key: tm[key] for key in (
                            "ms_bucket1", "library_ms_bucket1",
                            "plain_ms_bucket1", "bound_ms_bucket1")
                           if key in tm}})
        if kname in hd256:
            # gemma3-1b at hd 256: launches over its phase-9 serve()
            case256 = ((8, 512, 512, 4, 1, 256, True, 0)
                       if kname == "flash_attention"
                       else (8, 544, 4, 1, 256, False))
            kernels[-1]["hd256"] = dict(
                hd256[kname], launches=report["zoo"]["gemma3-1b"][
                    "launches"][op],
                max_abs_err=errs[kname][(case256, "bfloat16")])
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
