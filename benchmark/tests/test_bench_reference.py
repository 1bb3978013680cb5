"""The plain reference against the port's CPU path at a toy size: a
training step (loss and gradients), the blank-skip compaction and the
beam search."""

import numpy as np
import pytest
import torch

from benchmark.cells import train_pool as tp
from benchmark.reference import bilstm_ctc as ref
from benchmark.reference import search as rs
from benchmark.tests import toy


def _batch(b=4, t=11, d=6, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"feats": torch.randn(b, t, d, generator=g),
            "feat_lengths": torch.tensor([t, t - 3, 2, 0][:b]),
            "labels": torch.tensor([[1, 2, 2], [3, 4, 0], [5, 0, 0],
                                    [0, 0, 0]][:b]),
            "label_lengths": torch.tensor([3, 2, 1, 0][:b])}


def test_training_step_matches_the_port():
    from eesen_tpu_torch.training.optim import OptimizerConfig, make_optimizer
    from eesen_tpu_torch.training.trainer import TrainState, make_train_step

    c = toy.train_cell()
    cfg = c["config"]
    params = tp.make_params(cfg, 3, "cpu")
    tx = make_optimizer(OptimizerConfig(momentum=0.9, max_grad=50.0))
    step = make_train_step(tp.model_config(cfg), tx)
    batch = _batch()
    st, m = step(TrainState(params, tx.init(params), 0), batch, None, 0.1)
    loss, grads = ref.loss_and_grads(params, batch)
    assert float(m["loss"]) == pytest.approx(float(loss), rel=1e-5)
    flat = torch.cat([g.reshape(-1) for _, g in ref.leaves(grads)])
    got = st.opt_state.inner["trace"]
    assert torch.allclose(got, flat.clamp(-50, 50), rtol=1e-4, atol=1e-6)


def test_backward_matches_autograd():
    """The written-out backward pass against torch autograd through the
    same forward equations."""
    c = toy.train_cell()
    params = tp.make_params(c["config"], 5, "cpu")
    batch = _batch(seed=1)
    loss, grads = ref.loss_and_grads(params, batch)
    tree = ref.tree_map(lambda p: p.clone().requires_grad_(), params)
    leaves = [p for _, p in ref.leaves(tree)]

    # autograd through the same recurrence: a plain torch loop
    feats, lens = batch["feats"], batch["feat_lengths"]
    t_max = feats.shape[1]
    mask = (torch.arange(t_max)[:, None] < lens[None, :]).float()

    def direction(p, x, msk):
        h = p["w_gifo_m"].shape[0]
        c_ = torch.zeros(x.shape[1], h)
        m_ = torch.zeros(x.shape[1], h)
        outs = []
        for t in range(x.shape[0]):
            z = (x[t] @ p["w_gifo_x"].reshape(-1, 4 * h)
                 + m_ @ p["w_gifo_m"].reshape(h, 4 * h)
                 + p["bias"].reshape(4 * h))
            g = torch.tanh(z[:, :h])
            i = torch.sigmoid(z[:, h:2 * h] + c_ * p["phole_i_c"])
            f = torch.sigmoid(z[:, 2 * h:3 * h] + c_ * p["phole_f_c"])
            cn = f * c_ + i * g
            o = torch.sigmoid(z[:, 3 * h:] + cn * p["phole_o_c"])
            mt = msk[t][:, None]
            m = o * torch.tanh(cn) * mt
            c_ = cn * mt + c_ * (1 - mt)
            m_ = m + m_ * (1 - mt)
            outs.append(m)
        return torch.stack(outs)

    x = feats.transpose(0, 1)
    for lp in tree["layers"]:
        fw = direction(lp["fw"], x, mask)
        bw = torch.flip(direction(lp["bw"], torch.flip(x, (0,)),
                                  torch.flip(mask, (0,))), (0,))
        x = torch.cat([fw, bw], -1) * mask[:, :, None]
    logits = (x @ tree["out"]["w"] + tree["out"]["b"]).transpose(0, 1)
    nll, _ = ref.ctc(logits.detach(), lens, batch["labels"],
                     batch["label_lengths"])
    # the CTC gradient is the reference's own (softmax - gamma); autograd
    # checks everything below the logits through it
    _, dlog = ref.ctc(logits.detach(), lens, batch["labels"],
                      batch["label_lengths"])
    frames = lens.sum().float()
    auto = torch.autograd.grad(logits, leaves, dlog / frames)
    assert float(loss) == pytest.approx(float(nll.sum() / frames), rel=1e-6)
    for (path, g), a in zip(ref.leaves(grads), auto):
        assert torch.allclose(g, a, rtol=1e-4, atol=1e-7), path


def test_ctc_gradient_matches_autograd_of_its_loss():
    g = torch.Generator().manual_seed(2)
    logits = torch.randn(3, 9, 5, generator=g, requires_grad=True)
    lens = torch.tensor([9, 6, 4])
    labels = torch.tensor([[1, 2, 2], [3, 4, 0], [1, 0, 0]])
    llen = torch.tensor([3, 2, 1])
    nll, grad = ref.ctc(logits.detach(), lens, labels, llen)
    # an independent log-space forward: the loss's autograd gradient
    lp = torch.log_softmax(logits, -1)
    tot = 0.0
    for b in range(3):
        lab = labels[b, :llen[b]].tolist()
        ext = [0]
        for u in lab:
            ext += [u, 0]
        a = torch.full((len(ext),), -1e30)
        a = a.clone()
        a[0] = lp[b, 0, ext[0]]
        if len(ext) > 1:
            a[1] = lp[b, 0, ext[1]]
        for t in range(1, int(lens[b])):
            prev = [a[s] for s in range(len(ext))]
            new = []
            for s in range(len(ext)):
                terms = [prev[s]]
                if s >= 1:
                    terms.append(prev[s - 1])
                if s >= 2 and ext[s] != 0 and ext[s] != ext[s - 2]:
                    terms.append(prev[s - 2])
                new.append(torch.logsumexp(torch.stack(terms), 0)
                           + lp[b, t, ext[s]])
            a = torch.stack(new)
        ll = torch.logsumexp(a[-2:], 0)
        assert float(-ll.detach()) == pytest.approx(float(nll[b]), rel=1e-5)
        tot = tot - ll
    auto, = torch.autograd.grad(tot, logits)
    assert torch.allclose(grad, auto, atol=1e-5)


def test_decode_path_matches_the_port(tmp_path):
    from eesen_tpu_torch.decoder.beam import (
        BeamSearchConfig, DeviceGraph, make_beam_decoder, traceback,
    )
    from eesen_tpu_torch.decoder.frame_skip import compact_blank_frames
    from eesen_tpu_torch.decoder.graph_compile import CompiledGraph
    from benchmark.traffic import decode_pool

    c, gdir = toy.decode_cell(str(tmp_path))
    s = c["traffic"]["search"]
    prons = np.load(f"{gdir}/prons.npy")
    chunk = decode_pool.make(c["traffic"], c["config"], prons, 9, "cpu")[0]
    graph = CompiledGraph.load(f"{gdir}/tlg.npz")
    cfg = BeamSearchConfig(beam=s["beam"], max_active=s["max_active"],
                           acoustic_scale=s["acoustic_scale"])
    cf = compact_blank_frames(torch.from_numpy(chunk.lp),
                              torch.from_numpy(chunk.lengths),
                              s["blank_skip"], bucket=s["blank_skip_bucket"])
    lens = cf.lengths.numpy()
    out = make_beam_decoder(graph, cfg)(cf.loglikes, lens,
                                        DeviceGraph.put(graph, device="cpu"))
    got = traceback(out, lens, graph.final_weight)
    kept = [rs.compact(chunk.lp[i], int(n), s["blank_skip"])
            for i, n in enumerate(chunk.lengths)]
    assert [len(k) for k in kept] == list(lens)
    for i, k in enumerate(kept):
        np.testing.assert_allclose(cf.loglikes[i, :len(k)].numpy(), k,
                                   atol=1e-4)
    want = rs.search(rs.Graph(f"{gdir}/tlg.npz", "cpu"), kept, s,
                     device="cpu")
    for (gw, gc), (ww, wc) in zip(got, want):
        assert gw == ww
        assert gc == pytest.approx(wc, rel=1e-5)


def test_the_tie_rules_differ_only_on_equal_scores():
    # lanes 0 and 1 reach states 5 and 3 at one score, lane 2 state 4
    # at a worse one; one slot keeps the earlier lane or the lower state
    dst = torch.tensor([[5, 3, 4]])
    score = torch.tensor([[1.0, 1.0, 2.0]])
    st_lane, _, lane = rs._merge(dst, score, 1, 10.0, "lane")
    st_state, _, _ = rs._merge(dst, score, 1, 10.0, "state")
    assert st_lane.tolist() == [[5]] and lane.tolist() == [[0]]
    assert st_state.tolist() == [[3]]
    # without a tie both rules keep the same set, each in score order
    score = torch.tensor([[1.5, 1.0, 2.0]])
    for ties in ("lane", "state"):
        st, sc, _ = rs._merge(dst, score, 2, 10.0, ties)
        assert st.tolist() == [[3, 5]] and sc.tolist() == [[1.0, 1.5]]


def test_the_cost_is_held_to_the_nearer_tie_rule():
    from benchmark.cells.decode_pool import compare

    kept = [np.zeros((2, 3), np.float32)]
    got = [([7], 10.0)]
    by_lane, by_state = [([7], 10.0)], [([8], 10.5)]
    assert compare(got, [by_lane, by_state], kept, kept,
                   [10.0])["cost_gap"] == 0.0
    assert compare([([8], 10.5)], [by_lane, by_state], kept, kept,
                   [10.5])["cost_gap"] == 0.0
    assert compare([([9], 12.0)], [by_lane, by_state], kept, kept,
                   [12.0])["cost_gap"] == pytest.approx(1.5 / 10.5)
