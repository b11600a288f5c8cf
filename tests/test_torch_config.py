"""The port's model configurations against the JAX package's: every field
but ``kernels``, the derived sizes, and the parameter shape tree."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import ARCH_IDS as J_ARCH_IDS  # noqa: E402
from repro.configs import INPUT_SHAPES as J_INPUT_SHAPES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.models import init_params  # noqa: E402

CASES = [(a, r) for a in J_ARCH_IDS for r in (False, True)]
# architectures whose layers the port runs so far (dense attention and
# Mamba2; the VLM's frontend stub is refused at forward time, its weights
# are dense)
PORTED = ("minicpm-2b", "phi3-mini-3.8b", "gemma3-1b", "minitron-8b",
          "phi-3-vision-4.2b", "mamba2-370m")


def _ids(c):
    return f"{c[0]}-{'reduced' if c[1] else 'full'}"


def _prop(cfg, name):
    """A derived size, or the exception it raises (``hd`` of an
    attention-free model divides by zero in both packages)."""
    try:
        return getattr(cfg, name)
    except ZeroDivisionError as e:
        return type(e)


def test_registry_matches():
    assert ARCH_IDS == J_ARCH_IDS
    assert INPUT_SHAPES == J_INPUT_SHAPES


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_fields_and_derived_sizes_match_jax(case):
    arch, reduced = case
    jc, tc = j_get_config(arch, reduced), get_config(arch, reduced)
    jf = {f.name for f in dataclasses.fields(jc)} - {"kernels"}
    assert {f.name for f in dataclasses.fields(tc)} == jf
    for name in jf:
        assert getattr(tc, name) == getattr(jc, name), name
    assert [dataclasses.asdict(g) for g in tc.groups()] \
        == [dataclasses.asdict(g) for g in jc.groups()]
    for prop in ("vocab_padded", "hd", "n_ssm_heads", "d_inner"):
        assert _prop(tc, prop) == _prop(jc, prop), prop
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
    assert tc.dtype() == torch.bfloat16 and tc.pdtype() == torch.bfloat16


def _shape_tree(tree):
    if isinstance(tree, dict):
        return {k: _shape_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shape_tree(v) for v in tree]
    return tuple(tree.shape), str(tree.dtype).split(".")[-1]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_init_params_shape_tree_matches_jax(case):
    arch, reduced = case
    tc = get_config(arch, reduced)
    if arch not in PORTED:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            init_params(tc, device="meta")
        return
    jc = j_get_config(arch, reduced)
    want = jax.eval_shape(lambda k: j_init_params(jc, k),
                          jax.random.PRNGKey(0))
    got = init_params(tc, device="meta")
    assert _shape_tree(got) == _shape_tree(want)


def test_init_params_is_seeded_and_matches_the_jax_distributions():
    cfg = get_config("minicpm-2b", reduced=True)
    a = init_params(cfg, seed=3, device="cpu")
    b = init_params(cfg, seed=3, device="cpu")
    c = init_params(cfg, seed=4, device="cpu")
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], c["embed"])
    g = a["groups"][0]
    assert not g["ln1"].any()                       # norms start at zero
    fan_in = cfg.d_model
    std = g["wq"].float().std().item()
    assert abs(std * fan_in ** 0.5 - 1.0) < 0.05     # N(0, 1/fan_in)
    assert abs(a["embed"].float().std().item() - 0.02) < 0.002
