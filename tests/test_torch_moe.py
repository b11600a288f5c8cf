"""The port's mixture-of-experts block against the JAX package's
``moe_block`` on the CPU: the same numpy-seeded inputs and weights through
both, float32, at the op tolerance of tests/test_kernels.py.  Also the
top-k tie order of ``jax.lax.top_k`` and the capacity drops of the stable
sort."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.models.layers import moe_block as j_moe_block  # noqa: E402
from repro_torch.models.layers import moe_block, top_k  # noqa: E402

TOL = dict(rtol=3e-5, atol=3e-5)


def _weights(rng, d, f, E, mlp):
    w = {"router": rng.standard_normal((d, E)) / np.sqrt(d),
         "w_up": rng.standard_normal((E, d, f)) / np.sqrt(d),
         "w_down": rng.standard_normal((E, f, d)) / np.sqrt(f)}
    if mlp == "swiglu":
        w["w_gate"] = rng.standard_normal((E, d, f)) / np.sqrt(d)
    return {k: v.astype(np.float32) for k, v in w.items()}


def _both(x, w, **kw):
    yj, auxj = j_moe_block(jnp.asarray(x), {k: jnp.asarray(v)
                                            for k, v in w.items()}, **kw)
    yt, auxt = moe_block(torch.from_numpy(x),
                         {k: torch.from_numpy(v) for k, v in w.items()}, **kw)
    return (np.asarray(yj), float(auxj)), (yt.numpy(), float(auxt))


@pytest.mark.parametrize("mlp", ["swiglu", "gelu"])
@pytest.mark.parametrize("E,k", [(4, 2), (8, 2), (16, 1)])
def test_moe_block_matches_jax(mlp, E, k):
    rng = np.random.default_rng(E * 10 + k)
    d, f = 32, 48
    x = rng.standard_normal((2, 12, d)).astype(np.float32)
    w = _weights(rng, d, f, E, mlp)
    (yj, auxj), (yt, auxt) = _both(x, w, n_experts=E, k=k,
                                   capacity_factor=1.25, mlp=mlp)
    assert yt.shape == (2, 12, d)
    np.testing.assert_allclose(yt, yj, **TOL)
    np.testing.assert_allclose(auxt, auxj, **TOL)


def test_top_k_breaks_ties_by_the_lower_index_as_jax_does():
    probs = np.array([[0.1, 0.3, 0.3, 0.3],
                      [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.1, 0.4, 0.1],
                      [0.0, 0.5, 0.0, 0.5]], np.float32)
    for k in (1, 2, 3):
        vj, ij = jax.lax.top_k(jnp.asarray(probs), k)
        vt, it = top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert top_k(torch.from_numpy(probs), 2)[1][0].tolist() == [1, 2]


def test_moe_block_routes_ties_as_jax_does():
    """Experts 1 and 2 (and 0 and 3) share a router column, so every token
    ties between them; both packages route to the lower index first."""
    rng = np.random.default_rng(7)
    d, f, E = 16, 24, 4
    w = _weights(rng, d, f, E, "swiglu")
    w["router"][:, 2] = w["router"][:, 1]
    w["router"][:, 3] = w["router"][:, 0]
    x = rng.standard_normal((1, 10, d)).astype(np.float32)
    for k in (1, 2):
        (yj, auxj), (yt, auxt) = _both(x, w, n_experts=E, k=k,
                                       capacity_factor=2.0, mlp="swiglu")
        np.testing.assert_allclose(yt, yj, **TOL)
        np.testing.assert_allclose(auxt, auxj, **TOL)
    # top-1 never picks the higher index of a tied pair
    probs = torch.softmax(torch.from_numpy(x.reshape(10, d)
                                           @ w["router"]), -1)
    assert set(top_k(probs, 1)[1].flatten().tolist()) <= {0, 1}


def test_capacity_drops_the_last_tokens_of_an_expert_as_jax_does():
    """A capacity below the load: the stable sort keeps each expert's
    earliest tokens, and a dropped top-1 token's output is zero."""
    rng = np.random.default_rng(3)
    d, f, E, T = 16, 24, 4, 24
    w = _weights(rng, d, f, E, "gelu")
    w["router"][:, 0] += 3.0 / np.sqrt(d)       # crowd expert 0
    x = rng.standard_normal((1, T, d)).astype(np.float32)
    (yj, auxj), (yt, auxt) = _both(x, w, n_experts=E, k=1,
                                   capacity_factor=0.5, mlp="gelu")
    np.testing.assert_allclose(yt, yj, **TOL)
    np.testing.assert_allclose(auxt, auxj, **TOL)
    C = int(np.ceil(T / E * 0.5))
    eidx = top_k(torch.softmax(torch.from_numpy(x[0] @ w["router"]), -1),
                 1)[1][:, 0].numpy()
    zero = ~np.abs(yt[0]).any(axis=-1)
    for e in range(E):
        rows = np.flatnonzero(eidx == e)
        assert not zero[rows[:C]].any()          # kept, in token order
        assert zero[rows[C:]].all()              # dropped
    assert zero.any()


def test_aux_loss_is_the_switch_load_balance_term():
    rng = np.random.default_rng(11)
    d, E = 16, 4
    w = _weights(rng, d, 8, E, "swiglu")
    x = rng.standard_normal((3, 5, d)).astype(np.float32)
    _, aux = moe_block(torch.from_numpy(x),
                       {k: torch.from_numpy(v) for k, v in w.items()},
                       n_experts=E, k=2, capacity_factor=1.25)
    probs = torch.softmax(torch.from_numpy(x.reshape(15, d) @ w["router"]),
                          -1).numpy()
    top1 = np.argmax(probs, -1)
    want = E * np.sum(probs.mean(0) * np.bincount(top1, minlength=E) / 15)
    np.testing.assert_allclose(float(aux), want, **TOL)
