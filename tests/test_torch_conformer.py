"""The port's Conformer-CTC (eesen_tpu_torch/models/conformer.py, the
relative-position attention ops of ops/rel_attention.py, CTC on the
subsampled lengths, AdamW, BatchNorm's buffers in the train state)
against the plain reference tests/conformer_reference.py, on the CPU at
a small size with seeded weights: d 64, 2 layers, 4 heads, kernel 7,
16-dim input, T <= 96, products in float32.

Tolerances: the port and the reference compute the same float32
arithmetic in another order (fused LayerNorm and BatchNorm kernels, the
attention's strided shift against NeMo's pad-and-view, the port's CTC
kernel against F.ctc_loss), so they differ by float32 round-off, ~1e-6
relative here.  The limits leave ~20x room above that and lie well
below what one step down in precision gives: the same reference with
every product's operands in bfloat16 misses each of them by 10x or more
(test_a_lower_precision_reference_fails).
"""

import dataclasses
import statistics

import numpy as np
import pytest
import torch

from eesen_tpu_torch.models import conformer as tconf
from eesen_tpu_torch.models import model as tmodel
from eesen_tpu_torch.models import proto as tproto
from eesen_tpu_torch.models import streaming as tstream
from eesen_tpu_torch.ops import rel_attention as tatt
from eesen_tpu_torch.parallel.mesh import Mesh
from eesen_tpu_torch.training import trainer as ttrainer
from eesen_tpu_torch.training.optim import (
    OptimizerConfig, make_optimizer, tree_leaves, tree_unflatten, unravel,
)
from tests import conformer_reference as ref

CFG = tconf.ConformerConfig(
    input_dim=16, d_model=64, n_layers=2, n_heads=4, conv_kernel_size=7,
    subsampling_conv_channels=64, num_targets=11,
    compute_dtype=torch.float32)
OPT = {"b1": 0.9, "b2": 0.98, "eps": 1e-8, "weight_decay": 1e-3,
       "learn_rate": 1e-3}
RCFG = {"d_model": 64, "n_heads": 4, "xscaling": True, "bn_momentum": 0.1,
        "optimizer": OPT}
LOGIT_TOL = 2e-5        # absolute, on logits of magnitude ~2
LOSS_TOL = 2e-5         # relative
GRAD_TOL = 1e-4         # leaf gap (below), largest over the leaves
STAT_TOL = 1e-6         # BatchNorm's running statistics, absolute
# AdamW's second step: where the two gradients of a weight disagree in
# sign its first moment nearly cancels, and m_hat / sqrt(v_hat) carries
# the gradients' f32 round-off ~100x magnified (1.7e-4 here)
DELTA_TOL = 1e-3


def params(seed=0):
    return tconf.init_conformer(torch.Generator().manual_seed(seed), CFG,
                                "cpu")


def batch(seed=1, lens=(96, 70, 41), t=96):
    g = torch.Generator().manual_seed(seed)
    lens = torch.tensor(lens)
    feats = torch.randn(len(lens), t, CFG.input_dim, generator=g)
    feats[torch.arange(t)[None, :] >= lens[:, None]] = 0.0
    labels = torch.randint(1, CFG.num_targets, (len(lens), 6), generator=g)
    return {"feats": feats, "feat_lengths": lens, "labels": labels,
            "label_lengths": torch.tensor([6, 5, 3][:len(lens)])}


def gap(got, want):
    """Worst leaf of |got - want| / max(|want|, median |want|) (norms):
    leaves whose gradient is nought by symmetry (the key bias, the
    depthwise bias before BatchNorm) are measured against the median."""
    med = statistics.median(float(w.norm()) for w in want)
    return max(float((g - w).norm()) / max(float(w.norm()), med)
               for g, w in zip(got, want))


def port_loss_and_grads(p, b, cfg=CFG):
    kept = ttrainer.trained(p)
    leaves = [x.detach().requires_grad_() for x in tree_leaves(kept)]
    live = {**tree_unflatten(kept, leaves), "buffers": p["buffers"]}
    buffers = {}
    loss, _ = ttrainer._loss_and_metrics(live, b, cfg, None, True,
                                         buffers_out=buffers)
    return loss, torch.autograd.grad(loss, leaves), buffers["buffers"]


def ref_grads(p, b, prec="f32"):
    loss, g, bufs = ref.loss_and_grads(p, b, RCFG, prec)
    return loss, [t for _, t in ref.leaves(g)], bufs


def test_logits_and_output_lengths_match_the_reference():
    p, b = params(), batch()
    logits = tmodel.apply_model(p, b["feats"], b["feat_lengths"], CFG,
                                train=True)
    want, lens, _ = ref.forward(p, b["feats"], b["feat_lengths"], RCFG)
    assert logits.shape == want.shape == (3, 24, CFG.num_targets)
    assert (logits - want).abs().max() < LOGIT_TOL
    got = tmodel.output_lengths(CFG, b["feat_lengths"])
    assert got.tolist() == lens.tolist() == [24, 18, 11]
    assert tmodel.output_lengths(CFG, np.array([1, 4, 5])).tolist() == \
        [1, 1, 2]
    assert CFG.subsampled_dim == 4


def test_lstm_output_lengths_are_its_input_lengths():
    lens = torch.tensor([5, 3])
    assert tmodel.output_lengths(tmodel.AcousticModelConfig(), lens) is lens


def test_loss_and_every_gradient_match_the_reference():
    p, b = params(), batch()
    loss, grads, _ = port_loss_and_grads(p, b)
    want_loss, want, _ = ref_grads(p, b)
    names = [n for n, _ in ref.leaves(p)]
    assert [n for n, _ in ref.leaves(p)] == names and len(grads) == len(want)
    assert abs(float(loss.detach()) / float(want_loss) - 1) < LOSS_TOL
    assert gap(grads, want) < GRAD_TOL
    # the parts no other model has, each on its own
    for part in ("att/pos_u", "att/pos_v", "att/pos/w", "conv/bn/gamma",
                 "conv/bn/beta"):
        idx = [i for i, n in enumerate(names) if n.endswith(part)]
        assert len(idx) == CFG.n_layers, part
        for i in idx:
            assert float(want[i].norm()) > 0, names[i]
            err = float((grads[i] - want[i]).norm() / want[i].norm())
            assert err < GRAD_TOL, (names[i], err)


def test_a_lower_precision_reference_fails():
    """The reference one step below the configuration's float32 (every
    product's operands in bfloat16) misses the loss and gradient limits
    that the port meets."""
    p, b = params(), batch()
    want_loss, want, _ = ref_grads(p, b)
    low_loss, low, _ = ref_grads(p, b, "bf16")
    assert abs(float(low_loss) / float(want_loss) - 1) > 10 * LOSS_TOL
    assert gap(low, want) > 10 * GRAD_TOL


def test_batch_norm_running_statistics_after_a_step():
    p, b = params(), batch()
    _, _, bufs = port_loss_and_grads(p, b)
    _, _, want = ref_grads(p, b)
    for got, w, old in zip(bufs, want, p["buffers"]):
        assert (got["mean"] - w["mean"]).abs().max() < STAT_TOL
        assert (got["var"] - w["var"]).abs().max() < STAT_TOL
        assert int(got["count"]) == int(w["count"]) == 1
        assert float((got["mean"] - old["mean"]).abs().max()) > 1e-3
        assert int(old["count"]) == 0          # the given buffers unchanged


def test_two_train_steps_with_adamw_match_the_reference():
    p0 = params()
    tx = make_optimizer(OptimizerConfig(
        algorithm="adamw", max_grad=0.0, weight_decay=OPT["weight_decay"]))
    step = ttrainer.make_train_step(CFG, tx)
    state = ttrainer.TrainState(p0, tx.init(ttrainer.trained(p0)), 0)
    batches = [batch(1), batch(2, lens=(90, 77, 64))]
    losses = []
    for b in batches:
        state, m = step(state, b, None, OPT["learn_rate"])
        losses.append(float(m["loss"]))
        assert int(m["frames"]) == int(tconf.output_lengths(
            b["feat_lengths"]).sum())
    want, opt, want_losses = p0, ref.AdamW(OPT), []
    for b in batches:
        loss, grads, bufs = ref.loss_and_grads(want, b, RCFG)
        want = {**opt.step(want, grads), "buffers": bufs}
        want_losses.append(float(loss))
    assert np.allclose(losses, want_losses, rtol=LOSS_TOL, atol=0)
    inner = state.opt_state.inner
    assert int(inner["count"]) == 2
    for k, tree in (("mu", opt.m), ("nu", opt.v)):
        got = tree_leaves(unravel(ttrainer.trained(p0), inner[k]))
        assert gap(got, [t for _, t in ref.leaves(tree)]) < GRAD_TOL, k
    # AdamW moves a weight by about lr whatever its gradient, so where the
    # gradient is round-off (the key bias, the depthwise bias, the slowest
    # positional columns), the port's and the reference's moves differ
    # wholly: the change is compared where sqrt(v_hat) > 1000 eps
    c2 = 1 - OPT["b2"] ** 2
    kept = [(torch.sqrt(v / c2) > 1000 * OPT["eps"])
            for _, v in ref.leaves(opt.v)]
    delta = [(a - b)[k] for a, b, k in zip(
        tree_leaves(ttrainer.trained(state.params)),
        tree_leaves(ttrainer.trained(p0)), kept)]
    want_delta = [(a - b)[k] for (_, a), (_, b), k in zip(
        ref.leaves(want), ref.leaves(p0), kept)]
    assert sum(int(k.sum()) for k in kept) > 0.9 * sum(k.numel()
                                                       for k in kept)
    assert gap(delta, want_delta) < DELTA_TOL
    # the running statistics follow the depthwise bias, whose step-1 move
    # is round-off's (above): here only their count is compared
    for got in state.params["buffers"]:
        assert int(got["count"]) == 2
    assert int(p0["buffers"][0]["count"]) == 0


def test_eval_rows_do_not_see_another_rows_padding():
    """In evaluation (running statistics) a row's outputs stay when
    another row grows and the batch is padded longer: the key mask, the
    convolution's pad mask and the length arithmetic."""
    p = params()
    short = batch(lens=(60, 37), t=64)
    longer = batch(seed=7, lens=(90, 37), t=96)
    longer["feats"][1] = 0.0
    longer["feats"][1, :37] = short["feats"][1, :37]
    out = tmodel.apply_model(p, short["feats"], short["feat_lengths"], CFG)
    out2 = tmodel.apply_model(p, longer["feats"], longer["feat_lengths"],
                              CFG)
    n = int(tconf.output_lengths(37))
    assert out.shape[1] == 16 and out2.shape[1] == 24 and n == 10
    assert (out[1, :n] - out2[1, :n]).abs().max() < LOGIT_TOL
    assert (out[0, :n] - out2[0, :n]).abs().max() > 1e-2   # row 0 changed


def plain_attention(q, k, v, p, u, vb, lengths):
    """The op's arithmetic as plain autograd operations, with NeMo's
    pad-and-view shift."""
    t = q.shape[2]
    ac = torch.matmul(q + u[:, None], k.transpose(-2, -1))
    bd = ref.rel_shift(torch.matmul(q + vb[:, None],
                                    p.transpose(-2, -1)))[..., :t]
    s = (ac + bd) / q.shape[-1] ** 0.5
    pad = torch.arange(t)[None, :] >= lengths[:, None]
    s = s.masked_fill(pad[:, None, None, :], -10000.0)
    return torch.matmul(torch.softmax(s, -1), v)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-6),
                                       (torch.bfloat16, 3e-2)])
def test_registered_op_forward_and_backward(dtype, tol):
    """The op pair against autograd through plain operations (f32, where
    the limit is round-off; bf16 operands, where it is bfloat16's)."""
    g = torch.Generator().manual_seed(3)
    b, h, t, dk = 2, 3, 9, 8
    mk = lambda *s: torch.randn(*s, generator=g)
    q, k, v = mk(b, h, t, dk), mk(b, h, t, dk), mk(b, h, t, dk)
    p, u, vb = mk(h, 2 * t - 1, dk), mk(h, dk), mk(h, dk)
    lengths = torch.tensor([9, 5])
    dout = mk(b, h, t, dk)
    ins = [x.to(dtype).requires_grad_() for x in (q, k, v, p)]
    biases = [u.clone().requires_grad_(), vb.clone().requires_grad_()]
    f0, b0 = tatt.fwd_calls, tatt.bwd_calls
    out, lse = torch.ops.eesen_torch.rel_pos_attention(*ins, *biases, lengths)
    got = torch.autograd.grad(out, ins + biases, dout.to(dtype))
    assert (tatt.fwd_calls - f0, tatt.bwd_calls - b0) == (1, 1)
    assert out.dtype == dtype and lse.dtype == torch.float32
    plain = [x.detach().float().requires_grad_() for x in ins] + [
        u.clone().requires_grad_(), vb.clone().requires_grad_()]
    want_out = plain_attention(*plain, lengths)
    want = torch.autograd.grad(want_out, plain, dout)
    scale = lambda w: max(float(w.detach().abs().max()), 1.0)
    assert (out.float() - want_out).abs().max() < tol * scale(want_out)
    for gi, wi in zip(got, want):
        assert (gi.float() - wi).abs().max() < tol * scale(wi)


def test_products_give_f32_results_and_gradients():
    """ops/products: bf16 operands, f32 results in both passes; on the CPU
    the f32 product of the rounded values.  `rounded` rounds the value
    and passes the gradient unrounded."""
    from eesen_tpu_torch.ops.products import linear32, rounded

    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 5, 16, generator=g, requires_grad=True)
    w = torch.randn(8, 16, generator=g, requires_grad=True)
    dy = torch.randn(2, 5, 8, generator=g)
    bf = lambda t: t.detach().to(torch.bfloat16).float()
    y = linear32(x, w, torch.bfloat16)
    assert y.dtype == torch.float32
    assert torch.equal(y, bf(x) @ bf(w).t())
    dx, dw = torch.autograd.grad(y, (x, w), dy)
    assert dx.dtype == dw.dtype == torch.float32
    assert torch.allclose(dx, bf(dy) @ bf(w), rtol=1e-6, atol=1e-6)
    assert torch.allclose(dw, bf(dy).reshape(-1, 8).t()
                          @ bf(x).reshape(-1, 16), rtol=1e-6, atol=1e-5)
    r = rounded(x, torch.bfloat16)
    assert r.dtype == torch.float32 and torch.equal(r, bf(x))
    (gx,) = torch.autograd.grad(r, x, dy[..., :1].expand(2, 5, 16) / 3)
    assert torch.equal(gx, dy[..., :1].expand(2, 5, 16) / 3)
    assert rounded(x, torch.float32) is x


def test_paths_without_a_conformer_refuse_it():
    with pytest.raises(NotImplementedError, match="make_shard_map"):
        ttrainer.make_shard_map_train_step(
            CFG, make_optimizer(OptimizerConfig()), Mesh.__new__(Mesh))
    with pytest.raises(NotImplementedError, match="emit_nnet_proto"):
        tproto.emit_nnet_proto(CFG)
    with pytest.raises(NotImplementedError, match="streaming"):
        tstream.StreamingAcousticModel(params(), CFG, device="cpu")
    with pytest.raises(NotImplementedError, match="streaming"):
        tstream.init_stream_state(CFG, 2, device="cpu")


def test_checkpoints_round_trip_the_buffers(tmp_path):
    cfg = ttrainer.TrainerConfig(
        model=CFG, optimizer=OptimizerConfig(algorithm="adamw",
                                             max_grad=0.0),
        checkpoint_dir=str(tmp_path))
    tr = ttrainer.Trainer(cfg, device="cpu")
    b = {k: v.numpy() for k, v in batch().items()}
    tr.run_epoch(iter([dict(b)]), True, 1e-3)
    tr.save_checkpoint(1)
    saved = tr.state
    tr2 = ttrainer.Trainer(dataclasses.replace(cfg, seed=5), device="cpu")
    tr2.restore_checkpoint(1)
    assert int(tr2.state.params["buffers"][1]["count"]) == 1
    for a, c in zip(ref.leaves(saved.params["buffers"]),
                    ref.leaves(tr2.state.params["buffers"])):
        assert torch.equal(a[1], c[1])
    for a, c in zip(tree_leaves(saved.params), tree_leaves(tr2.state.params)):
        assert torch.equal(a, c)
    for k in ("mu", "nu", "count"):
        assert torch.equal(saved.opt_state.inner[k],
                           tr2.state.opt_state.inner[k])
    # evaluation with the restored running statistics gives the same
    r1 = tr.run_epoch(iter([dict(b)]), False, 1e-3)
    r2 = tr2.run_epoch(iter([dict(b)]), False, 1e-3)
    assert r1.obj_per_frame == r2.obj_per_frame


def test_the_reference_copies_are_the_same_file():
    """tests/conformer_reference.py is the benchmark's
    reference/conformer_ctc.py, word for word."""
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    assert (root / "tests" / "conformer_reference.py").read_text() == (
        root / "benchmark" / "reference" / "conformer_ctc.py").read_text()
