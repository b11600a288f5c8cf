"""The compiled training step (``repro_torch.train.CompiledTrainStep``, the
counterpart of ``jax.jit(make_train_step(...))``) on the CPU.

* Capture safety: the whole training body (forward, remat, backward,
  ``adamw_update``, the counter's write-back, the learning rate) of every
  reduced config runs under ``tests/test_torch_graphs.py``'s
  ``RefuseHostSync``, once through the plain versions, as the CPU runs it,
  and once through the kernels' ``autograd.Function``s with the plain
  version as the forward, as the card runs it (the backward recomputes
  ``kernels/ref.py``).
* Replays through the static buffers, with a stand-in graph whose capture
  leaves every tensor as it found it (a real capture executes nothing) and
  whose replay re-runs only the captured closure: the trajectory equals
  ``make_train_step``'s eager one exactly (float32), so no state the step
  needs is kept outside its body.
* Launch accounting: the warm-up is the first step, counted once; each
  replay adds the captured count.  A failed capture raises, and so does
  every later call.
* ``launch.train``'s ``Trainer`` against ``jax.jit(make_train_step(...))``
  for three steps.

The card's checks are in ``tests/test_torch_cuda.py`` and phase 11 of
``chip_smoke.py``.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import train as jtrain  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.train import Trainer  # noqa: E402
from repro_torch.models import init_params, params_from_numpy  # noqa: E402
from repro_torch.serving import graphs  # noqa: E402
from repro_torch.train import (CompiledTrainStep, adamw_init,  # noqa: E402
                               make_schedule, make_train_step)
from repro_torch.train.tree import leaves, map_with_path  # noqa: E402
from test_torch_graphs import RefuseHostSync, counting  # noqa: E402,F401

F32 = dict(compute_dtype="float32", param_dtype="float32")
S = 40          # no multiple of the reduced SSM chunk (16): the scan pads
LOSS_RTOL = 2e-4            # as tests/test_torch_train.py holds the losses
STEPS = 4

# the wrapper modules (``repro_torch.kernels`` exports the functions under
# the same names)
fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")
ssd_mod = importlib.import_module("repro_torch.kernels.ssd_scan")


def _through_functions(monkeypatch):
    """The wrappers as the card takes them when a gradient is carried (the
    kernel's ``autograd.Function``), with the plain version as the
    forward."""
    fa_fn, fa_plain = fa_mod.FlashAttentionFn, fa_mod.flash_attention_plain
    ssd_fn, ssd_plain = ssd_mod.SSDScanFn, ssd_mod.ssd_scan_plain

    def attention(q, k, v, *, causal=True, window=0):
        if torch.is_grad_enabled() and q.requires_grad:
            return fa_fn.apply(q, k, v, causal, window, fa_plain)
        return fa_plain(q, k, v, causal=causal, window=window)

    def ssd(x, dt, A, Bm, Cm, *, chunk, init_state=None):
        if torch.is_grad_enabled() and x.requires_grad:
            return ssd_fn.apply(x, dt, A, Bm, Cm, init_state, chunk,
                                ssd_plain)
        return ssd_plain(x, dt, A, Bm, Cm, chunk=chunk,
                         init_state=init_state)

    monkeypatch.setattr(ops, "attention", attention)
    monkeypatch.setattr(ops, "ssd", ssd)


def _frontend(cfg, batch):
    if not cfg.frontend:
        return None
    return torch.zeros((batch, cfg.n_frontend_tokens, cfg.d_model),
                       dtype=cfg.dtype())


def _batches(cfg, n=STEPS, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (batch, S)) for _ in range(n)]


# -- capture safety -----------------------------------------------------------


@pytest.mark.parametrize("route", ["plain", "functions"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_the_training_body_can_be_captured(arch, route, monkeypatch):
    if route == "functions":
        _through_functions(monkeypatch)
    cfg = get_config(arch, reduced=True)
    params = init_params(cfg, 0, "cpu")
    opt = adamw_init(params)
    step = CompiledTrainStep(cfg, params, opt, 2, S, _frontend(cfg, 2),
                             total_steps=STEPS, peak_lr=1e-3)
    prog = step.program
    prog.stage(tokens=_batches(cfg, 1)[0])
    with RefuseHostSync():
        loss, lr = prog.body(**prog.inputs)
    assert int(opt.step) == 1 and torch.isfinite(loss)
    assert float(lr) == float(make_schedule(cfg.lr_schedule, 1e-3,
                                            STEPS)(1))


# -- replays through the static buffers ---------------------------------------


class CaptureRunsNothing:
    """A CUDA graph's stand-in off the card for a training step.  Capture
    runs the body to learn its outputs, then puts every tensor of
    ``watched`` (the trainer's parameters, moments and counter) back as it
    found it, since a real capture executes nothing, and fills the outputs
    with NaN, which a real replay writes first.  A replay re-runs only the
    captured closure into those outputs, the launch counters held, as a
    real replay calls no wrapper."""

    watched = []

    def __init__(self, pool, stream):
        assert pool is None and stream is None      # off the card
        self.body = self.outputs = None

    def capture(self, body):
        saved = [t.detach().clone() for t in self.watched]
        self.body, self.outputs = body, body()
        with torch.no_grad():
            for t, s in zip(self.watched, saved):
                t.copy_(s)
            for out in self.outputs:
                out.fill_(float("nan"))
        return self.outputs

    def replay(self):
        held = ops.launch_counts()
        for out, value in zip(self.outputs, self.body()):
            out.copy_(value)
        ops.set_launch_counts(held)


@pytest.fixture
def one_thread():
    """One intra-op thread, for results equal bit for bit: with several,
    the CPU's float32 sums (the embedding's gradient) can take another
    order from one call to the next."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def capture_runs_nothing(monkeypatch):
    monkeypatch.setattr(graphs, "graph_for",
                        lambda device: CaptureRunsNothing)
    yield CaptureRunsNothing
    CaptureRunsNothing.watched = []


def _trainer(cfg, steps=STEPS, lr=1e-3):
    tr = Trainer(cfg, steps=steps, batch=2, seq=S, lr=lr, device="cpu")
    CaptureRunsNothing.watched = (leaves(tr.params) + leaves(tr.opt.mu)
                                  + leaves(tr.opt.nu) + [tr.opt.step])
    return tr


@pytest.mark.parametrize("arch", ["minicpm-2b", "mamba2-370m",
                                  "phi-3-vision-4.2b"])
def test_replays_follow_the_eager_trajectory_exactly(arch, one_thread,
                                                     capture_runs_nothing):
    """Four steps through ``Trainer`` (the first warms up and captures, the
    other three replay the stand-in) against ``make_train_step``'s eager
    step on a copy of the same weights and batches: the same losses, step
    counter, learning rate, parameters and moments, bit for bit."""
    cfg = get_config(arch, reduced=True).with_(**F32)
    tr = _trainer(cfg)
    params = map_with_path(lambda _, t: t.detach().clone(), tr.params)
    opt = adamw_init(params)
    eager = make_train_step(cfg, total_steps=STEPS, peak_lr=1e-3)
    sched = make_schedule(cfg.lr_schedule, 1e-3, STEPS)
    for i in range(STEPS):
        batch = tr.data.batch(i)
        loss, _ = tr.step(batch)
        params, opt, want = eager(params, opt,
                                  torch.from_numpy(batch).long(),
                                  tr.frontend)
        assert loss == float(want), f"step {i}"
        assert int(tr.opt.step) == int(opt.step) == i + 1
        assert float(tr.step_fn.lr) == float(sched(i + 1))
        for name, mine, theirs in (("params", tr.params, params),
                                   ("mu", tr.opt.mu, opt.mu),
                                   ("nu", tr.opt.nu, opt.nu)):
            for a, b in zip(leaves(mine), leaves(theirs)):
                assert torch.equal(a, b), f"step {i}: {name}"
    prog = tr.step_fn.program
    assert isinstance(prog.graph, CaptureRunsNothing)
    assert prog.runs == STEPS - 1


def test_the_stand_in_catches_state_kept_outside_the_body(
        capture_runs_nothing, monkeypatch):
    """The stand-in's check has teeth: a step whose learning rate is a
    Python number fixed at capture (state outside the body) follows the
    eager trajectory at the warm-up only."""
    cfg = get_config("minicpm-2b", reduced=True).with_(**F32)
    real = make_schedule(cfg.lr_schedule, 1e-3, STEPS)
    frozen = [None]

    def fixed_at_capture(kind, peak, total):
        def sched(step):
            if frozen[0] is None:
                frozen[0] = float(real(step))
            return torch.tensor(frozen[0])
        return sched

    from repro_torch.train import steps as steps_mod
    monkeypatch.setattr(steps_mod, "make_schedule", fixed_at_capture)
    tr = _trainer(cfg)
    for i in range(STEPS):
        tr.step(tr.data.batch(i))
    assert float(tr.step_fn.lr) != float(real(STEPS))


# -- launch accounting --------------------------------------------------------


@pytest.mark.parametrize("arch", ["minicpm-2b", "mamba2-370m"])
def test_the_warm_up_is_the_first_step_and_each_replay_counts_its_launches(
        arch, counting, capture_runs_nothing):
    cfg = get_config(arch, reduced=True).with_(**F32)
    op = "ssd" if arch == "mamba2-370m" else "attention"
    per_step = {"attention": 0, "decode_attention": 0, "ssd": 0}
    per_step[op] = 2 * cfg.n_layers            # forward, remat recompute
    tr = _trainer(cfg)
    batches = [tr.data.batch(i) for i in range(STEPS)]
    tr.step(batches[0])
    prog = tr.step_fn.program
    assert ops.launch_counts() == per_step      # the capture added none
    assert prog.launches == per_step and prog.runs == 0
    assert int(tr.opt.step) == 1
    for i, batch in enumerate(batches[1:], start=2):
        tr.step(batch)
        assert ops.launch_counts() == {k: i * n for k, n in
                                       per_step.items()}
        assert int(tr.opt.step) == i
    assert prog.runs == STEPS - 1


def test_a_failed_capture_raises_and_nothing_runs_eagerly_after_it(
        counting, monkeypatch):
    class Refusing(CaptureRunsNothing):
        def capture(self, body):
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    monkeypatch.setattr(graphs, "graph_for", lambda device: Refusing)
    cfg = get_config("mamba2-370m", reduced=True).with_(**F32)
    tr = Trainer(cfg, steps=STEPS, batch=2, seq=S, lr=1e-3, device="cpu")
    batches = [tr.data.batch(i) for i in range(2)]
    with pytest.raises(RuntimeError, match="capturing"):
        tr.step(batches[0])
    # the warm-up ran, as the first step
    assert int(tr.opt.step) == 1
    assert ops.launch_counts()["ssd"] == 2 * cfg.n_layers
    with pytest.raises(RuntimeError, match="does not run eagerly"):
        tr.step(batches[1])
    assert int(tr.opt.step) == 1
    assert ops.launch_counts()["ssd"] == 2 * cfg.n_layers


def test_a_batch_of_another_shape_is_refused():
    cfg = get_config("mamba2-370m", reduced=True).with_(**F32)
    tr = Trainer(cfg, steps=STEPS, batch=2, seq=S, lr=1e-3, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tr.step(np.zeros((1, tr.data.cfg.seq_len), np.int32))
    assert int(tr.opt.step) == 0


# -- against the JAX package --------------------------------------------------


@pytest.mark.parametrize("arch", ["minicpm-2b", "mamba2-370m"])
def test_three_trainer_steps_equal_the_jax_packages(arch):
    """``Trainer`` (its compiled step) from the JAX package's weights on the
    same ``SyntheticLM`` batches against ``jax.jit(make_train_step(...))``:
    the losses within ``LOSS_RTOL``, three updates applied on both."""
    jc = j_get_config(arch, reduced=True).with_(**F32)
    tc = get_config(arch, reduced=True).with_(**F32)
    jp = j_init_params(jc, jax.random.PRNGKey(0))
    tr = Trainer(tc, steps=3, batch=2, seq=S, lr=1e-3, device="cpu")
    bridged = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu")
    with torch.no_grad():
        for mine, theirs in zip(leaves(tr.params), leaves(bridged)):
            mine.copy_(theirs)
    data = jtrain.SyntheticLM(jtrain.DataConfig(
        vocab_size=tc.vocab_size, seq_len=tr.data.cfg.seq_len,
        batch_size=2))
    j_step = jax.jit(jtrain.make_train_step(jc, total_steps=3,
                                            peak_lr=1e-3))
    j_opt = jtrain.adamw_init(jp)
    for step in range(3):
        batch = data.batch(step)
        jp, j_opt, j_loss = j_step(jp, j_opt, jnp.asarray(batch))
        loss, _ = tr.step(batch)
        np.testing.assert_allclose(loss, float(j_loss), rtol=LOSS_RTOL,
                                   err_msg=f"step {step}")
    assert int(tr.opt.step) == int(j_opt.step) == 3
