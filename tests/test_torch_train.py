"""The port's training path (eesen_tpu_torch/training) against the JAX
package's trainer on the CPU, from the same parameters and optimizer
state: train and eval steps at compute_dtype=float32, an epoch through
`Trainer.run_epoch`, and `Trainer.fit` with checkpoint/resume."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eesen_tpu.models.model import AcousticModelConfig as JModelConfig
from eesen_tpu.training import trainer as jtrainer
from eesen_tpu.training.optim import OptimizerConfig as JOptConfig
from eesen_tpu.training.schedule import NewbobConfig as JNewbob
from eesen_tpu_torch.models import model as tmodel
from eesen_tpu_torch.training import optim as toptim
from eesen_tpu_torch.training import trainer as ttrainer
from eesen_tpu_torch.training.schedule import NewbobConfig as TNewbob

SMALL = dict(input_dim=6, cell_dim=8, num_layers=2, num_targets=5)
# f32 end to end: the same arithmetic, float32 sums in another order
LOSS_RTOL, PARAM_ATOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6, 1e-4, 1e-6


def batch(seed=0, b=4, t=12):
    """Toy CTC batch: one-hot 'phone' features + noise, mixed lengths, a
    repeated label, and a padded row (0 frames, 0 labels)."""
    rng = np.random.default_rng(seed)
    feats = (0.3 * rng.standard_normal((b, t, 6))).astype(np.float32)
    feat_lengths = np.array([t, t - 3, 7, 0][:b], np.int32)
    labels = np.zeros((b, 3), np.int32)
    label_lengths = np.array([3, 2, 1, 0][:b], np.int32)
    for i in range(b):
        labels[i, :label_lengths[i]] = rng.integers(1, 5, label_lengths[i])
        feats[i, feat_lengths[i]:] = 0.0
    labels[0, 1] = labels[0, 0]
    return {"feats": feats, "feat_lengths": feat_lengths,
            "labels": labels, "label_lengths": label_lengths}


def to_torch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def configs(algo="sgd", loss="ctc"):
    jm = JModelConfig(**SMALL, compute_dtype=jnp.float32)
    tm = tmodel.AcousticModelConfig(**SMALL, compute_dtype=torch.float32)
    jo = JOptConfig(algorithm=algo, momentum=0.9, max_grad=50.0)
    to = toptim.OptimizerConfig(algorithm=algo, momentum=0.9, max_grad=50.0)
    return jm, tm, jo, to


def carried_state(jstate):
    """The JAX TrainState as the port's, on the CPU."""
    np_tree = jax.tree_util.tree_map(np.asarray, jstate)
    return ttrainer.TrainState(
        tmodel.params_from_jax(np_tree.params, device="cpu"),
        toptim.opt_state_from_jax(np_tree.opt_state, device="cpu"),
        int(np_tree.step),
    )


def assert_params_close(p_t, p_j, atol=PARAM_ATOL):
    leaves_j = jax.tree_util.tree_leaves(p_j)
    leaves_t = toptim.tree_leaves(p_t)
    assert len(leaves_t) == len(leaves_j)
    for a, b in zip(leaves_t, leaves_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("loss", ["ctc", "ce"])
def test_loss_and_grads_match_jax(loss):
    jm, tm, jo, _ = configs()
    jstate, _ = jtrainer.create_train_state(jax.random.PRNGKey(0), jm, jo)
    b = batch()
    if loss == "ce":   # frame-aligned labels [B, T]
        b["labels"] = np.random.default_rng(1).integers(
            0, 5, b["feats"].shape[:2]).astype(np.int32)

    def f(p):
        return jtrainer._loss_and_metrics(
            p, {k: jnp.asarray(v) for k, v in b.items()}, jm, None, True,
            loss, False)

    (l_j, m_j), g_j = jax.value_and_grad(f, has_aux=True)(jstate.params)
    st = carried_state(jstate)
    leaves = [p.requires_grad_() for p in toptim.tree_leaves(st.params)]
    l_t, m_t = ttrainer._loss_and_metrics(
        toptim.tree_unflatten(st.params, leaves), to_torch(b), tm, None,
        True, loss, False)
    grads = torch.autograd.grad(l_t, leaves)
    np.testing.assert_allclose(float(l_t.detach()), float(l_j),
                               rtol=LOSS_RTOL)
    assert int(m_t["frames"]) == int(m_j["frames"])
    if loss == "ce":
        assert int(m_t["correct"]) == int(m_j["correct"])
    for a, g in zip(grads, jax.tree_util.tree_leaves(g_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(g), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


@pytest.mark.parametrize("algo,n_steps", [("sgd", 1), ("sgd", 3),
                                          ("adagrad", 3)])
def test_train_steps_match_jax(algo, n_steps):
    """make_train_step, chained, from the same state and batch: loss and
    parameters after each step."""
    jm, tm, jo, to = configs(algo)
    jstate, jtx = jtrainer.create_train_state(jax.random.PRNGKey(1), jm, jo)
    jstep = jtrainer.make_train_step(jm, jtx, donate=False, with_argmax=True)
    tstate = carried_state(jstate)
    tstep = ttrainer.make_train_step(tm, toptim.make_optimizer(to),
                                     with_argmax=True)
    b = batch(2)
    jb, tb = {k: jnp.asarray(v) for k, v in b.items()}, to_torch(b)
    lr = 0.05
    for _ in range(n_steps):
        jstate, jm_ = jstep(jstate, jb, None, jnp.float32(lr))
        tstate, tm_ = tstep(tstate, tb, None, lr)
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_array_equal(tm_["argmax"].numpy(),
                                      np.asarray(jm_["argmax"]))
    assert tstate.step == int(jstate.step) == n_steps
    assert_params_close(tstate.params, jstate.params, atol=1e-5)


def test_train_step_leaves_the_old_state_alone():
    _, tm, _, to = configs()
    st, tx = ttrainer.create_train_state(torch.Generator().manual_seed(0),
                                         tm, to, device="cpu")
    before = [p.clone() for p in toptim.tree_leaves(st.params)]
    new, metrics = ttrainer.make_train_step(tm, tx)(st, to_torch(batch()),
                                                    None, 0.1)
    assert all(torch.equal(a, b) for a, b in
               zip(before, toptim.tree_leaves(st.params)))
    assert not all(torch.equal(a, b) for a, b in
                   zip(before, toptim.tree_leaves(new.params)))
    assert np.isfinite(float(metrics["loss"]))
    assert all(not p.requires_grad for p in toptim.tree_leaves(new.params))


def test_eval_step_matches_jax():
    jm, tm, jo, _ = configs()
    jstate, _ = jtrainer.create_train_state(jax.random.PRNGKey(2), jm, jo)
    b = batch(3)
    want = jtrainer.make_eval_step(jm)(
        jstate.params, {k: jnp.asarray(v) for k, v in b.items()})
    got = ttrainer.make_eval_step(tm)(carried_state(jstate).params,
                                      to_torch(b))
    np.testing.assert_allclose(float(got["obj_sum"]), float(want["obj_sum"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_array_equal(got["argmax"].numpy(),
                                  np.asarray(want["argmax"]))
    assert int(got["frames"]) == int(want["frames"])


def trainer_cfgs(tmp_path=None, max_iters=2):
    jm, tm, _, _ = configs()
    common = dict(report_step=1000)
    jcfg = jtrainer.TrainerConfig(
        model=jm, optimizer=JOptConfig(algorithm="adagrad"),
        newbob=JNewbob(learn_rate=0.05, max_iters=max_iters,
                       min_iters=max_iters), **common)
    tcfg = ttrainer.TrainerConfig(
        model=tm, optimizer=toptim.OptimizerConfig(algorithm="adagrad"),
        newbob=TNewbob(learn_rate=0.05, max_iters=max_iters,
                       min_iters=max_iters),
        checkpoint_dir=str(tmp_path / "ckpt") if tmp_path else None,
        **common)
    return jcfg, tcfg


def batches():
    return [batch(s) for s in range(3)]


def test_run_epoch_matches_jax():
    """One train epoch and one CV epoch through Trainer.run_epoch, the
    port's trainer started from the JAX trainer's state: the same
    objective, token accuracy and parameters."""
    jcfg, tcfg = trainer_cfgs()
    jt = jtrainer.Trainer(jcfg)
    tt = ttrainer.Trainer(tcfg, device="cpu")
    tt.state = carried_state(jt.state)
    for train in (True, False):
        rj = jt.run_epoch(iter(batches()), train, 0.05)
        rt = tt.run_epoch(iter(batches()), train, 0.05)
        np.testing.assert_allclose(rt.obj_per_frame, rj.obj_per_frame,
                                   rtol=LOSS_RTOL)
        assert (rt.total_frames, rt.total_errs, rt.total_refs,
                rt.num_seqs) == (rj.total_frames, rj.total_errs,
                                 rj.total_refs, rj.num_seqs)
    assert_params_close(tt.state.params, jt.state.params, atol=1e-5)


def test_fit_saves_and_resumes(tmp_path):
    """As tests/test_checkpoint.py for the JAX trainer: fit two epochs,
    resume in a fresh trainer from the saved state and schedule, and a
    completed run trains no further batch."""
    _, tcfg = trainer_cfgs(tmp_path)
    t1 = ttrainer.Trainer(tcfg, device="cpu")
    hist = t1.fit(lambda: iter(batches()), lambda: iter(batches()))
    assert sorted(hist) == [1, 2] and t1.latest_checkpoint() == 2
    assert all(np.isfinite(h["train_obj"]) for h in hist.values())
    assert t1.state.step == 6

    t2 = ttrainer.Trainer(dataclasses.replace(
        tcfg, newbob=TNewbob(learn_rate=0.05, max_iters=3, min_iters=3)),
        device="cpu")
    t2.restore_checkpoint(t2.latest_checkpoint())
    for a, b in zip(toptim.tree_leaves(t1.state.params),
                    toptim.tree_leaves(t2.state.params)):
        assert torch.equal(a, b)
    assert torch.equal(t1.state.opt_state.inner["sum_of_squares"],
                       t2.state.opt_state.inner["sum_of_squares"])
    assert t2.state.step == 6 and t2.sched.epoch == t1.sched.epoch == 3

    calls = []
    t3 = ttrainer.Trainer(tcfg, device="cpu")
    hist3 = t3.fit(lambda: calls.append(1) or iter(batches()),
                   lambda: iter(batches()))
    assert hist3 == {} and calls == [] and t3.sched.finished


def test_trainer_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = trainer_cfgs()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrainer.Trainer(tcfg)
