"""The port's dry-run (``repro_torch.launch.dryrun``, ``cost``, ``roofline``):
the reference's ring factors and model FLOPs, per-device counts on a fake
mesh, the records ``trace_one`` writes, and the kernel wrappers on meta
tensors.

The fake process group is process-global, so the traces run in one child
process (4 fake ranks on a 2 x 2 mesh), spawned once for the file.
"""
import importlib
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES,  # noqa: E402
                                 get_config, shape_applicable)
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch.cost import (DeviceCostMode,  # noqa: E402
                                     collective_wire_bytes)
from repro_torch.launch.roofline import model_flops, terms  # noqa: E402

# the wrappers' modules (the package exports the functions under the same
# names)
fa_mod, dec_mod, ssd_mod = (
    importlib.import_module(f"repro_torch.kernels.{m}")
    for m in ("flash_attention", "decode_attention", "ssd_scan"))
ROOT = pathlib.Path(__file__).resolve().parents[1]
REFERENCE_KEYS = {"arch", "shape", "mesh", "n_devices", "fsdp", "kind",
                  "flops", "bytes_accessed", "argument_size_in_bytes",
                  "coll_by_kind", "coll_by_axis", "trace_s", "device",
                  "temp_size_in_bytes"}
COMBOS = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES
          if shape_applicable(a, s)]

# Run in the child: a reduced minicpm-2b forward under DeviceCostMode on a
# (data 2, model 2) mesh, then one reduced trace_one per kind.
CHILD = r"""
import json, sys, torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_config
from repro_torch.launch.cost import DeviceCostMode
from repro_torch.launch.dryrun import fake_group, gpu_alltoall, trace_one
from repro_torch.models import forward, init_params
from repro_torch.models.sharding import (distribute, input_pspecs,
                                         param_pspecs, placements)
fake_group(4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
cfg = get_config("minicpm-2b", reduced=True)
params = init_params(cfg, device="meta")
params = distribute(mesh, params, param_pspecs(cfg, params, mesh))
B, S = 4, 16
sp = input_pspecs(cfg, mesh, B)
tok = distribute_tensor(torch.empty((B, S), dtype=torch.int32,
                                    device="meta"),
                        mesh, placements(mesh, sp["tokens"]))
mode = DeviceCostMode(mesh)
with torch.no_grad(), gpu_alltoall(), implicit_replication(), mode:
    logits, _ = forward(cfg, params, tok)
    logits.redistribute(mesh, placements(mesh, sp["frontend"]))
out = {"forward": {"flops_by_op": dict(mode.flops_by_op),
                   "coll_log": mode.coll_log}}
for arch, shape in (("minicpm-2b", "train_4k"), ("mixtral-8x22b", "train_4k"),
                    ("mamba2-370m", "prefill_32k"),
                    ("whisper-tiny", "prefill_32k"),
                    ("minicpm-2b", "decode_32k"), ("gemma3-1b", "long_500k")):
    out[f"{arch}:{shape}"] = trace_one(arch, shape, mesh,
                                       cfg=get_config(arch, reduced=True))
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def child():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", CHILD], capture_output=True,
                       text=True, env=env, timeout=600)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    assert r.returncode == 0 and lines, r.stderr[-4000:]
    return json.loads(lines[-1][len("RESULT "):])


def test_collective_wire_bytes_ring_factors():
    """tests/test_roofline_parsing.py::test_parse_collectives_ring_factors'
    numbers."""
    ag_result = 256 * 128 * 2
    assert collective_wire_bytes("all-gather", 16 * 128 * 2, ag_result,
                                 16) == pytest.approx((15 / 16) * ag_result)
    ar_operand = 256 * 128 * 2
    assert collective_wire_bytes("all-reduce", ar_operand, ar_operand,
                                 4) == pytest.approx(2 * (3 / 4) * ar_operand)
    assert collective_wire_bytes("collective-permute", 16 * 128 * 2,
                                 16 * 128 * 2, 16) == 16 * 128 * 2
    assert collective_wire_bytes("reduce-scatter", 1024, 128, 8) == \
        pytest.approx(7 / 8 * 1024)
    assert collective_wire_bytes("all-to-all", 1024, 1024, 8) == \
        pytest.approx(7 / 8 * 1024)
    with pytest.raises(ValueError):
        collective_wire_bytes("gather", 1, 1, 2)


@pytest.mark.parametrize("combo", COMBOS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_model_flops_matches_jax(combo):
    saved = os.environ.get("XLA_FLAGS")
    try:    # the reference module sets XLA_FLAGS on import; keep ours
        from repro.configs import get_config as j_get_config
        from repro.launch.roofline import model_flops as j_model_flops
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    arch, shape = combo
    assert model_flops(get_config(arch), shape) == \
        j_model_flops(j_get_config(arch), shape)


def test_cost_mode_prices_plain_meta_tensors():
    """No mesh: a product's FLOPs, a view's zero bytes, a copy's read and
    write."""
    a = torch.empty((64, 32), device="meta")
    b = torch.empty((32, 16), device="meta")
    with DeviceCostMode() as mode:
        c = a @ b
        c.t()
        d = torch.empty_like(c)
        d.copy_(c)
    assert mode.flops == 2 * 64 * 32 * 16
    assert mode.bytes == (64 * 32 + 32 * 16 + 64 * 16) * 4 + 2 * 64 * 16 * 4
    assert mode.summary()["coll_bytes"] == 0


def test_terms_price_each_axis_at_its_link():
    rec = {"flops": 989e12, "bytes_accessed": 3.35e12,
           "coll_by_axis": {"model": 450e9, "data": 50e9}}
    t = terms(rec)
    assert t == {"compute_s": pytest.approx(1.0),
                 "memory_s": pytest.approx(1.0),
                 "collective_s": pytest.approx(2.0)}


def test_forward_flops_per_device_equal_the_local_count(child):
    """Reduced minicpm-2b, B 4 x S 16 on (data 2, model 2): every product
    of a rank's shard (batch halved, heads / FFN / vocab halved), and the
    plain attention's two products over its local heads."""
    cfg = get_config("minicpm-2b", reduced=True)
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    f, V, L = cfg.d_ff, cfg.vocab_padded, cfg.n_layers
    Bl, S = 2, 16
    mm = L * (2 * Bl * S * d * (hq + 2 * hkv) * hd // 2     # q, k, v
              + 2 * Bl * S * hq * hd * d // 2               # wo
              + 3 * 2 * Bl * S * d * f // 2) \
        + 2 * Bl * S * d * V // 2                           # tied lm head
    att = L * 2 * 2 * Bl * (hq // 2) * S * S * hd
    got = child["forward"]["flops_by_op"]
    assert got == {"aten.mm": mm, "aten.bmm": att}


def test_each_row_parallel_product_is_reduced_once_over_model(child):
    """wo and w_down leave partial sums over ``model``: each is reduced
    once (an all-reduce, or a reduce-scatter whose all-gather comes before
    the next product), as is the vocab-parallel embedding's lookup, and a
    batch-parallel forward moves nothing over ``data``."""
    cfg = get_config("minicpm-2b", reduced=True)
    hidden = 2 * 16 * cfg.d_model        # a rank's (B/2, S, d) partial sum
    log = child["forward"]["coll_log"]
    assert {axis for _, axis, _ in log} == {"model"}
    reductions = [n for kind, axis, n in log
                  if kind in ("all-reduce", "reduce-scatter")
                  and n == hidden]
    assert len(reductions) == 2 * cfg.n_layers + 1


@pytest.mark.parametrize("combo", [
    "minicpm-2b:train_4k", "mixtral-8x22b:train_4k",
    "mamba2-370m:prefill_32k", "whisper-tiny:prefill_32k",
    "minicpm-2b:decode_32k", "gemma3-1b:long_500k"])
def test_trace_one_writes_the_reference_keys(child, combo):
    """Every key of the reference's record; the all-to-all priced as one
    where this torch lets the dry-run swap DTensor's CPU-mesh fallback."""
    from repro_torch.launch.dryrun import gpu_alltoall
    with gpu_alltoall() as swapped:
        pass
    rec = child[combo]
    arch, shape = combo.split(":")
    assert REFERENCE_KEYS <= set(rec)
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["n_devices"]) == \
        (arch, shape, "2x2", 4)
    assert rec["kind"] == INPUT_SHAPES[shape][2]
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert rec["argument_size_in_bytes"] > 0
    assert rec["temp_size_in_bytes"] is None
    assert rec["coll_by_axis"]
    assert rec["alltoall"] == ("all-to-all" if swapped
                               else "all-gather and chunk (CPU mesh)")
    assert rec["device"] == "H100 SXM (data sheet)"


# -- the kernel wrappers on meta tensors (the dry-run's path) -----------------


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _no_launch(*_, **__):
    raise AssertionError("a meta tensor reached a kernel launch")


@pytest.mark.parametrize("name", ["attention", "decode_attention", "ssd"])
def test_meta_tensors_take_the_plain_version(monkeypatch, name):
    for mod in (fa_mod, ssd_mod):
        monkeypatch.setattr(mod, "_launch", _no_launch)
    monkeypatch.setattr(dec_mod, "_build", None)    # the launch reads it
    kops.reset_launch_counts()
    if name == "attention":
        out = kops.attention(_meta(2, 8, 4, 64), _meta(2, 8, 2, 64),
                             _meta(2, 8, 2, 64), causal=True)
        assert out.shape == (2, 8, 4, 64)
    elif name == "decode_attention":
        out = kops.decode_attention(
            _meta(2, 4, 64), _meta(2, 16, 2, 64), _meta(2, 16, 2, 64),
            torch.empty((2,), dtype=torch.int32, device="meta"))
        assert out.shape == (2, 4, 64)
    else:
        y, st = kops.ssd(_meta(1, 32, 2, 16), _meta(1, 32, 2),
                         _meta(2, dtype=torch.float32), _meta(1, 32, 8),
                         _meta(1, 32, 8), chunk=16)
        assert y.shape == (1, 32, 2, 16) and st.shape == (1, 2, 16, 8)
        out = y
    assert out.device.type == "meta"
    assert kops.launch_counts() == {k: 0 for k in kops.KERNEL_TABLE}


@pytest.mark.parametrize("mod", [fa_mod, dec_mod, ssd_mod],
                         ids=["flash", "decode", "ssd"])
def test_a_device_outside_the_plain_ones_takes_the_kernel_path(monkeypatch,
                                                               mod):
    """With meta dropped from the plain devices, a meta tensor goes where a
    CUDA tensor goes: to the kernel launch, which takes CUDA tensors alone
    and raises for any other device.  No fallback to the plain version."""
    monkeypatch.setattr(mod, "PLAIN_DEVICES", ("cpu",))
    with pytest.raises(ValueError, match="cpu, meta or cuda"):
        if mod is fa_mod:
            mod.flash_attention(_meta(1, 8, 2, 64), _meta(1, 8, 2, 64),
                                _meta(1, 8, 2, 64))
        elif mod is dec_mod:
            mod.decode_attention(
                _meta(1, 2, 64), _meta(1, 8, 2, 64), _meta(1, 8, 2, 64),
                torch.empty((1,), dtype=torch.int32, device="meta"))
        else:
            mod.ssd_scan(_meta(1, 32, 2, 16), _meta(1, 32, 2),
                         _meta(2, dtype=torch.float32), _meta(1, 32, 8),
                         _meta(1, 32, 8), chunk=16)
