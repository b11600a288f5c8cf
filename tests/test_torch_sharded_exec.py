"""Sharded execution of the port on the CPU: 4 gloo ranks on a (data 2,
model 2) mesh, parameters, caches and tokens placed by
``repro_torch.models.sharding``, against the unsharded port on the same
weights (f32).  The unsharded port is held to the JAX package at 2e-4
elsewhere (``tests/test_torch_zoo.py``); this holds the program the
dry-run counts (``launch/dryrun.py``) to the one that runs.

Three reduced models: minicpm-2b (dense), mamba2-370m (the SSD scan per
rank's rows and heads) and mixtral-8x22b (MoE, expert-parallel: 4 experts
over a model axis of 2, sliding-window ring caches).  For each: ``lm_loss``
(over vocab-sharded logits), ``forward`` logits, a ``prefill`` of 80 tokens
(past mixtral's window of 64, so the ring wraps) and one ``decode_step``.
The four ranks are spawned once for the file.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("minicpm-2b", "mamba2-370m", "mixtral-8x22b")
TOL = 2e-4

RANK = r"""
import json, sys
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_config
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, lm_loss, prefill)
from repro_torch.models.sharding import (cache_pspecs, distribute,
                                         input_pspecs, param_pspecs,
                                         placements)

rank, store_path, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store_path, 4),
                        world_size=4, rank=rank)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
B, S = 4, 80
out = {}
for arch in ("minicpm-2b", "mamba2-370m", "mixtral-8x22b"):
    cfg = get_config(arch, reduced=True).with_(compute_dtype="float32",
                                               param_dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           dtype=torch.int32)
    nxt = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                        dtype=torch.int32)
    with torch.no_grad():
        ref_loss = lm_loss(cfg, params, tokens)
        ref_fwd, _ = forward(cfg, params, tokens)
        cache = init_cache(cfg, B, S + 8, device="cpu")
        ref_pre, cache = prefill(cfg, params, tokens, cache)
        ref_dec, _ = decode_step(cfg, params, cache, nxt, S)

    sp = input_pspecs(cfg, mesh, B)
    dparams = distribute(mesh, params, param_pspecs(cfg, params, mesh))
    place = lambda t, k: distribute_tensor(t, mesh, placements(mesh, sp[k]))
    dcache = init_cache(cfg, B, S + 8, device="cpu")
    dcache = distribute(mesh, dcache, cache_pspecs(cfg, dcache, mesh, B))
    with torch.no_grad(), implicit_replication():
        loss = lm_loss(cfg, dparams, place(tokens, "tokens"))
        fwd, _ = forward(cfg, dparams, place(tokens, "tokens"))
        pre, dcache = prefill(cfg, dparams, place(tokens, "tokens"), dcache)
        dec, dcache = decode_step(cfg, dparams, dcache, place(nxt, "token"),
                                  S)
        got = [t.full_tensor() for t in (loss, fwd, pre, dec)]
        # (layers, batch, ...): the batch dim over data
        held = [t.placements[0].is_shard(1) for t in
                [c for e in dcache["layers"] for c in e.values()]]
    out[arch] = {
        name: [float((g - r).abs().max()), float(r.abs().max())]
        for name, g, r in zip(("lm_loss", "forward", "prefill", "decode"),
                              got, (ref_loss, ref_fwd, ref_pre, ref_dec))}
    out[arch]["cache_batch_sharded"] = all(held)
dist.barrier()
if rank == 0:
    open(out_path, "w").write(json.dumps(out))
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_exec")
    script = tmp / "rank.py"
    script.write_text(RANK)
    out = tmp / "out.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r),
                               str(tmp / "store"), str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for r in range(4)]
    logs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            logs.append(err[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs) and out.exists(), \
        "\n".join(logs)
    return json.loads(out.read_text())


@pytest.mark.parametrize("what", ["lm_loss", "forward", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_equals_unsharded(results, arch, what):
    diff, scale = results[arch][what]
    assert scale > 0
    assert diff <= TOL * max(1.0, scale), (arch, what, diff, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_caches_stay_batch_sharded(results, arch):
    """Prefill and decode write each rank's own rows in place: the cache
    keeps the placement ``cache_pspecs`` gave it."""
    assert results[arch]["cache_batch_sharded"]
