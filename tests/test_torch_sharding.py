"""The port's sharding rules (``repro_torch.models.sharding``) against the
JAX package's, leaf by leaf, at full size.

The reference's rules run on ``jax.sharding.AbstractMesh`` over
``jax.eval_shape(init_params)`` (no device); the port's take a plain
``{axis: size}`` mapping over ``init_params(device="meta")``.  Meshes: the
reference's (16 x 16, 2 x 16 x 16, the expert mesh 16 x 8 x 2) and the
port's (32 x 8, 2 x 32 x 8, 32 x 4 x 2).  A JAX ``PartitionSpec`` lists
no entry for trailing replicated dims and writes a one-axis tuple as the
axis; both are normalised before the comparison.
"""
import functools

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh, PartitionSpec as P  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import sharding as js  # noqa: E402
from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES,  # noqa: E402
                                 get_config)
from repro_torch.models import init_cache, init_params  # noqa: E402
from repro_torch.models import sharding as ts  # noqa: E402
from repro_torch.train.tree import leaves_with_paths  # noqa: E402

MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "16x8x2": {"data": 16, "expert": 8, "tp": 2},
    "32x8": {"data": 32, "model": 8},
    "2x32x8": {"pod": 2, "data": 32, "model": 8},
    "32x4x2": {"data": 32, "expert": 4, "tp": 2},
}
BATCHES = sorted({b for _, b, _ in INPUT_SHAPES.values()})


def _abstract(axes):
    return AbstractMesh(tuple(axes.values()), tuple(axes))


def _norm(spec, ndim):
    """One entry per dim; a one-axis tuple as the axis itself."""
    entries = [e[0] if isinstance(e, tuple) and len(e) == 1 else e
               for e in tuple(spec)]
    return tuple(entries) + (None,) * (ndim - len(entries))


def _jax_tree(specs, shapes):
    """{path: normalised spec} of a JAX spec tree over its shape tree."""
    flat_s = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    flat_x = dict(jax.tree_util.tree_flatten_with_path(shapes)[0])
    out = {}
    for path, spec in flat_s:
        key = tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)
        out[key] = _norm(spec, len(flat_x[path].shape))
    return out


def _port_tree(specs, tree):
    flat = {}
    ts._map_specs(lambda path, s: flat.__setitem__(path, s), specs)
    return {path: _norm(flat[path], t.dim())
            for path, t in leaves_with_paths(tree)}


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    jcfg = j_get_config(arch)
    jp = jax.eval_shape(lambda: j_init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, jp, init_params(get_config(arch), device="meta")


def test_the_mesh_helpers_read_a_device_mesh_and_a_mapping():
    class Mesh:                         # a DeviceMesh's reading interface
        mesh_dim_names = ("pod", "data", "model")

        def size(self, i):
            return (2, 32, 8)[i]

    for mesh in (Mesh(), MESHES["2x32x8"]):
        assert ts.mesh_axes(mesh) == {"pod": 2, "data": 32, "model": 8}
        assert ts.data_axes(mesh) == ("pod", "data")
        assert ts.model_axes(mesh) == "model"
        assert ts.model_axis_size(mesh) == 8
    assert ts.model_axes(MESHES["32x4x2"]) == ("expert", "tp")
    assert ts.model_axis_size(MESHES["32x4x2"]) == 8
    assert ts.FSDP_THRESHOLD_BYTES == js.FSDP_THRESHOLD_BYTES


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_match_jax(arch, mesh, fsdp):
    jcfg, jp, tp = _shapes(arch)
    axes = MESHES[mesh]
    want = _jax_tree(js.param_pspecs(jcfg, jp, _abstract(axes), fsdp=fsdp),
                     jp)
    got = _port_tree(ts.param_pspecs(get_config(arch), tp, axes, fsdp=fsdp),
                     tp)
    assert got == want


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_pspecs_match_jax_at_every_batch(arch, mesh):
    """Each input shape's batch (256, 32, 128, 1): batch-sharded where the
    data axes divide it, the KV sequence over ``data`` where not."""
    jcfg, cfg = j_get_config(arch), get_config(arch)
    axes = MESHES[mesh]
    for batch in BATCHES:
        jc = jax.eval_shape(lambda: j_init_cache(jcfg, batch, 64))
        tc = init_cache(cfg, batch, 64, device="meta")
        want = _jax_tree(js.cache_pspecs(jcfg, jc, _abstract(axes), batch),
                         jc)
        got = _port_tree(ts.cache_pspecs(cfg, tc, axes, batch), tc)
        assert got == want, batch


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_input_pspecs_match_jax(mesh):
    axes = MESHES[mesh]
    for arch in ("minicpm-2b", "phi-3-vision-4.2b"):
        jcfg, cfg = j_get_config(arch), get_config(arch)
        for batch in BATCHES:
            want = js.input_pspecs(jcfg, _abstract(axes), batch)
            got = ts.input_pspecs(cfg, axes, batch)
            assert set(got) == set(want)
            for k in want:
                nd = len(got[k])
                assert _norm(got[k], nd) == _norm(want[k], nd), (k, batch)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_needs_fsdp_matches_jax_on_every_mesh(arch):
    jcfg, cfg = j_get_config(arch), get_config(arch)
    got = {m: ts.needs_fsdp(cfg, axes) for m, axes in MESHES.items()}
    assert got == {m: js.needs_fsdp(jcfg, _abstract(axes))
                   for m, axes in MESHES.items()}
    # only the two largest models take FSDP, on a model axis of 8 or 16
    assert any(got.values()) == (arch in ("mixtral-8x22b",
                                          "llama4-scout-17b-a16e"))


def test_placements_shard_a_dim_named_by_two_axes_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    axes = MESHES["2x32x8"]
    assert ts.placements(axes, (("pod", "data"), None, "model")) == [
        Shard(0), Shard(0), Shard(2)]
    assert ts.placements(axes, (None, "data")) == [Replicate(), Shard(1),
                                                   Replicate()]
    assert ts.placements(MESHES["32x4x2"], (None, ("expert", "tp"))) == [
        Replicate(), Shard(1), Shard(1)]
    with pytest.raises(ValueError, match="shards two dims"):
        ts.placements(axes, ("model", "model"))
