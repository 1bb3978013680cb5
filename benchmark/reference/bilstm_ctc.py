"""Plain reference of one BiLSTM-CTC training step, in float32 torch ops
with the backward pass written out (no autograd, no kernel), and of the
optimizer that follows it.

The model is Eesen's (src/net/bilstm-layer.h): per direction GIFO gates
(g cell candidate, i input, f forget, o output) with diagonal peepholes
from the cell to i, f and o,

    g = tanh(x Wx_g + m' Wm_g + b_g)
    i = sigm(x Wx_i + m' Wm_i + b_i + c' * p_i)
    f = sigm(x Wx_f + m' Wm_f + b_f + c' * p_f)
    c = f * c' + i * g
    o = sigm(x Wx_o + m' Wm_o + b_o + c * p_o)
    m = o * tanh(c)

where a padded step (length mask 0) emits zeros and carries c' and m' on
unchanged; the backward direction runs on the time-flipped input.  The
outputs of both directions are concatenated; an affine layer gives the
logits.  The CTC objective (src/net/ctc-loss.cc) runs the alpha/beta
recursions in log space over blank-interleaved labels with the log-zero
sentinel -1e30, and its gradient with respect to the logits is
softmax - gamma.  The loss is the sum of the rows' negative
log-likelihoods over the frames of the batch.  A row of length 0 (the
batcher's padding) has the likelihood of blank at its first frame and no
gradient, as the port defines it.

The optimizer is the recipe's: elementwise clip to +-max_grad, momentum
trace = g + momentum * trace, p = p - learn_rate * trace.

`prec` selects the arithmetic of every product ("f32", or "fp8" for the
control, reference/quant.py).  Parameters are the port's tree:
{"layers": [{"fw": {...}, "bw": {...}}], "out": {"w", "b"}} with
w_gifo_x [D, 4, H], w_gifo_m [H, 4, H], bias [4, H], phole_{i,f,o}_c [H].
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark.reference.quant import mm

LOG_ZERO = -1e30
LOG_ZERO_THRESHOLD = -1e29


def leaves(tree) -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf, dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}" if p else k, t) for k in sorted(tree)
                for p, t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [(f"{i}/{p}" if p else str(i), t) for i, v in enumerate(tree)
                for p, t in leaves(v)]
    return [("", tree)]


def tree_map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return [tree_map(fn, *(t[i] for t in trees)) for i in range(len(t0))]
    return fn(*trees)


# ---------------------------------------------------------------- LSTM
# The two directions of a layer run side by side: every array carries a
# leading axis of 2 (forward; backward on the time-flipped input).

PH = ("phole_i_c", "phole_f_c", "phole_o_c")


def _stack(lp):
    """A layer's two directions' parameters, stacked: Wx [2, D, 4H],
    Wm [2, H, 4H], b [2, 1, 4H], peepholes [2, 1, H] each."""
    d = [lp["fw"], lp["bw"]]
    h = d[0]["w_gifo_m"].shape[0]
    st = lambda k, shape: torch.stack([x[k].reshape(shape) for x in d])
    return {"wx": st("w_gifo_x", (-1, 4 * h)), "wm": st("w_gifo_m", (h, 4 * h)),
            "b": st("bias", (1, 4 * h)),
            **{k: st(k, (1, h)) for k in PH}}


def _directions_fwd(p, x, mask, prec):
    """x [2, T, B, D], mask [2, T, B] -> (m [2, T, B, H], cache)."""
    _, t_max, b, d = x.shape
    h = p["wm"].shape[1]
    xw = (mm(x.reshape(2, t_max * b, d), p["wx"], prec) + p["b"]).reshape(
        2, t_max, b, 4 * h)
    pi, pf, po = (p[k] for k in PH)
    live = mask[..., None] > 0                        # [2, T, B, 1]
    c = torch.zeros(2, b, h, device=x.device)
    mc = torch.zeros(2, b, h, device=x.device)
    zero = torch.zeros((), device=x.device)
    out, gs, is_, fs, os_, ths, cs, mcs = ([] for _ in range(8))
    for t in range(t_max):
        z = xw[:, t] + mm(mc, p["wm"], prec)
        g = torch.tanh(z[..., :h])
        i = torch.sigmoid(torch.addcmul(z[..., h:2 * h], c, pi))
        f = torch.sigmoid(torch.addcmul(z[..., 2 * h:3 * h], c, pf))
        cn = torch.addcmul(f * c, i, g)
        o = torch.sigmoid(torch.addcmul(z[..., 3 * h:], cn, po))
        th = torch.tanh(cn)
        lt = live[:, t]
        m = torch.where(lt, o * th, zero)
        c = torch.where(lt, cn, c)
        mc = torch.where(lt, m, mc)
        out.append(m)
        gs.append(g), is_.append(i), fs.append(f), os_.append(o)
        ths.append(th), cs.append(c), mcs.append(mc)
    st = lambda xs: torch.stack(xs, 1)
    return st(out), (x, live, st(gs), st(is_), st(fs), st(os_), st(ths),
                     st(cs), st(mcs))


def _directions_bwd(p, cache, dy, prec):
    """dy [2, T, B, H] (cotangent of the outputs) -> (dx, stacked grads)."""
    x, live, g, i, f, o, th, cs, mcs = cache
    _, t_max, b, d = x.shape
    h = p["wm"].shape[1]
    pi, pf, po = (p[k] for k in PH)
    wm_t = p["wm"].transpose(1, 2)
    zero = torch.zeros(2, b, h, device=x.device)
    c_prev = torch.cat([zero[:, None], cs[:, :-1]], 1)   # carries before t
    m_prev = torch.cat([zero[:, None], mcs[:, :-1]], 1)
    cn = torch.addcmul(f * c_prev, i, g)
    z0 = torch.zeros((), device=x.device)
    dc = zero          # cotangent of the c carry after step t
    dmc = zero         # ... of the m carry after step t
    dz = []
    for t in range(t_max - 1, -1, -1):
        lt = live[:, t]
        gt, it, ft, ot, tht = g[:, t], i[:, t], f[:, t], o[:, t], th[:, t]
        dm = torch.where(lt, dy[:, t] + dmc, z0)
        do_z = dm * tht * ot * (1.0 - ot)
        dcn = torch.addcmul(torch.where(lt, dc, z0) + do_z * po,
                            dm * ot, 1.0 - tht * tht)
        di_z = dcn * gt * it * (1.0 - it)
        df_z = dcn * c_prev[:, t] * ft * (1.0 - ft)
        dg_z = dcn * it * (1.0 - gt * gt)
        dc = (torch.where(lt, dcn * ft, dc) + di_z * pi + df_z * pf)
        dzt = torch.cat([dg_z, di_z, df_z, do_z], dim=-1)
        dz.append(dzt)
        dmc = mm(dzt, wm_t, prec) + torch.where(lt, z0, dmc)
    dz = torch.stack(dz[::-1], 1)                     # [2, T, B, 4H]
    dz2 = dz.reshape(2, t_max * b, 4 * h)
    dph = [(dz[..., h:2 * h] * c_prev).sum((1, 2)),
           (dz[..., 2 * h:3 * h] * c_prev).sum((1, 2)),
           (dz[..., 3 * h:] * cn).sum((1, 2))]
    grads = {"w_gifo_x": mm(x.reshape(2, t_max * b, d).transpose(1, 2),
                            dz2, prec).reshape(2, d, 4, h),
             "w_gifo_m": mm(m_prev.reshape(2, t_max * b, h).transpose(1, 2),
                            dz2, prec).reshape(2, h, 4, h),
             "bias": dz2.sum(1).reshape(2, 4, h),
             **dict(zip(PH, dph))}
    dx = mm(dz2, p["wx"].transpose(1, 2), prec).reshape(2, t_max, b, d)
    return dx, grads


def _layer_fwd(lp, x, mask, prec):
    p = _stack(lp)
    xs = torch.stack([x, torch.flip(x, (0,))])
    ms = torch.stack([mask, torch.flip(mask, (0,))])
    y, cache = _directions_fwd(p, xs, ms, prec)
    y = torch.cat([y[0], torch.flip(y[1], (0,))], dim=-1) * mask[:, :, None]
    return y, (p, cache)


def _layer_bwd(cache, dy, mask):
    (p, c), prec = cache
    h = p["wm"].shape[1]
    dy = dy * mask[:, :, None]
    dys = torch.stack([dy[..., :h], torch.flip(dy[..., h:], (0,))])
    dx, g = _directions_bwd(p, c, dys, prec)
    grads = {name: {k: v[j] for k, v in g.items()}
             for j, name in enumerate(("fw", "bw"))}
    return dx[0] + torch.flip(dx[1], (0,)), grads


# ----------------------------------------------------------------- CTC

def _log_add(a, b):
    hi = torch.maximum(a, b)
    lo = torch.minimum(a, b)
    safe = hi > LOG_ZERO_THRESHOLD
    out = hi + torch.log1p(torch.exp(torch.where(safe, lo - hi, 0.0)))
    return torch.where(safe, out, torch.full_like(out, LOG_ZERO))


def _shift(x, n, fill=LOG_ZERO):
    """out[..., s] = x[..., s - n] (n > 0 right, n < 0 left), `fill`
    where that falls outside."""
    out = torch.full_like(x, fill)
    if n > 0:
        out[..., n:] = x[..., :-n]
    else:
        out[..., :n] = x[..., -n:]
    return out


def ctc(logits, lengths, labels, label_lengths):
    """logits [B, T, V] -> (nll [B], dnll/dlogits [B, T, V])."""
    b, t_max, v = logits.shape
    dev = logits.device
    lp = torch.log_softmax(logits, dim=-1)
    ll = labels.shape[1]
    s_max = 2 * ll + 1
    elab = torch.zeros(b, s_max, dtype=torch.long, device=dev)
    elab[:, 1::2] = labels
    s = torch.arange(s_max, device=dev)[None, :]
    valid = s < (2 * label_lengths[:, None] + 1)
    prev2 = torch.full_like(elab, -1)
    prev2[:, 2:] = elab[:, :-2]
    skip = torch.where((s % 2 == 1) & (elab != prev2) & (s >= 2), 0.0,
                       LOG_ZERO)
    lpe = torch.where(valid[:, None, :],
                      lp.gather(2, elab[:, None, :].expand(b, t_max, s_max)),
                      torch.tensor(LOG_ZERO, device=dev))
    alpha = torch.empty(b, t_max, s_max, device=dev)
    a = torch.where(s <= 1, lpe[:, 0], torch.tensor(LOG_ZERO, device=dev))
    a = torch.where((label_lengths[:, None] == 0) & (s > 0),
                    torch.tensor(LOG_ZERO, device=dev), a)
    alpha[:, 0] = a
    for t in range(1, t_max):
        new = lpe[:, t] + _log_add(_log_add(a, _shift(a, 1)),
                                   _shift(a, 2) + skip)
        a = torch.where((t < lengths)[:, None], new, a)
        alpha[:, t] = a
    last_b = 2 * label_lengths
    last_l = (2 * label_lengths - 1).clamp(min=0)
    fin_b = a.gather(1, last_b[:, None])[:, 0]
    fin_l = torch.where(label_lengths > 0, a.gather(1, last_l[:, None])[:, 0],
                        torch.tensor(LOG_ZERO, device=dev))
    loglik = _log_add(fin_b, fin_l)
    final = (s == last_b[:, None]) | ((s == last_l[:, None])
                                      & (label_lengths[:, None] > 0))
    init = torch.where(final, 0.0, LOG_ZERO)
    skip2 = _shift(skip, -2)
    beta = torch.empty(b, t_max, s_max, device=dev)
    bt = torch.full((b, s_max), LOG_ZERO, device=dev)
    for t in range(t_max - 1, -1, -1):
        nxt = bt + lpe[:, min(t + 1, t_max - 1)]
        new = _log_add(_log_add(nxt, _shift(nxt, -1)), _shift(nxt, -2) + skip2)
        bt = torch.where((t == lengths - 1)[:, None], init,
                         torch.where((t < lengths - 1)[:, None], new,
                                     torch.tensor(LOG_ZERO, device=dev)))
        beta[:, t] = bt
    lg = torch.where(valid[:, None, :], alpha + beta - loglik[:, None, None],
                     torch.tensor(LOG_ZERO, device=dev))
    gamma = torch.where(lg > LOG_ZERO_THRESHOLD,
                        torch.exp(lg.clamp(max=0.0)), 0.0)
    gamma_v = torch.zeros(b, t_max, v, device=dev).scatter_add_(
        2, elab[:, None, :].expand(b, t_max, s_max), gamma)
    tmask = (torch.arange(t_max, device=dev)[None, :] < lengths[:, None])
    grad = (torch.exp(lp) - gamma_v) * tmask[:, :, None]
    return -loglik, grad


# ---------------------------------------------------------------- step

def loss_and_grads(params, batch, prec: str = "f32"):
    """(loss, grads tree) of one batch: loss = sum(nll) / frames."""
    feats = batch["feats"]
    lengths = batch["feat_lengths"].long()
    t_max = feats.shape[1]
    mask = (torch.arange(t_max, device=feats.device)[:, None]
            < lengths[None, :]).float()
    x = feats.transpose(0, 1)
    caches = []
    for lp in params["layers"]:
        x, cache = _layer_fwd(lp, x, mask, prec)
        caches.append((cache, prec))
    y = x                                               # [T, B, 2H]
    tb = y.shape[0] * y.shape[1]
    logits = (mm(y.reshape(tb, -1), params["out"]["w"], prec)
              + params["out"]["b"]).reshape(t_max, -1, params["out"]["b"]
                                            .shape[0]).transpose(0, 1)
    nll, dlogits = ctc(logits, lengths, batch["labels"].long(),
                       batch["label_lengths"].long())
    frames = lengths.sum().clamp(min=1).float()
    loss = nll.sum() / frames
    dl = (dlogits / frames).transpose(0, 1).reshape(tb, -1)   # [T*B, V]
    g_out = {"w": mm(y.reshape(tb, -1).t(), dl, prec), "b": dl.sum(0)}
    dy = mm(dl, params["out"]["w"].t(), prec).reshape(t_max, -1, y.shape[2])
    g_layers = [None] * len(params["layers"])
    for li in range(len(params["layers"]) - 1, -1, -1):
        dy, g_layers[li] = _layer_bwd(caches[li], dy, mask)
        caches[li] = None
    return loss, {"layers": g_layers, "out": g_out}


class Sgd:
    """Clip, momentum trace, update: the recipe's optimizer."""

    def __init__(self, momentum: float, max_grad: float, learn_rate: float):
        self.momentum = momentum
        self.max_grad = max_grad
        self.lr = learn_rate
        self.trace = None

    def step(self, params, grads):
        g = tree_map(lambda x: x.clamp(-self.max_grad, self.max_grad), grads)
        if self.trace is None:
            self.trace = g
        else:
            self.trace = tree_map(lambda a, t: a + self.momentum * t, g,
                                  self.trace)
        return tree_map(lambda p, t: p - self.lr * t, params, self.trace)


def follow(params0, batches, opt_cfg: Dict, prec: str = "f32"):
    """The reference's first len(batches) steps from params0: (losses,
    the first step's clipped gradient, the parameters after the last
    step)."""
    opt = Sgd(opt_cfg["momentum"], opt_cfg["max_grad"],
              opt_cfg["learn_rate"])
    params = params0
    losses, g1 = [], None
    for batch in batches:
        loss, grads = loss_and_grads(params, batch, prec)
        losses.append(float(loss))
        params = opt.step(params, grads)
        if g1 is None:
            g1 = opt.trace
        del grads
    return losses, g1, params
