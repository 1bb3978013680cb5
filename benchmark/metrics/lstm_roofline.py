"""Kernels 1 and 3 in the traced steps: each launch's records paired
with its bound.

A launch of kernel 1 (`lib.lstm_fwd`) or kernel 3 (`lib.lstm_bwd`) is a
run of the port's own kernels, in the order the host launched them,
around its recurrence (`lstm_rec_kernel` or `lstm_bwd_rec_kernel`): the
padding copies and the products it launches with it.  A step counts only
where its recurrence records equal the port's launch counter for the
step and no launch call of the step lacks its record; its bound is the
sum of its launches' bounds (metrics/costs.py).  (`lstm_rec_kernel` is
no part of the name `lstm_bwd_rec_kernel`.)"""

from benchmark.metrics.costs import step_bounds

PORT = ("pad_kernel", "gemm_bf16_kernel", "gemm_kernel", "lstm_rec_kernel",
        "lstm_bwd_rec_kernel", "sum_rows_kernel")
REC = {"fwd": "lstm_rec_kernel", "bwd": "lstm_bwd_rec_kernel"}
COUNTER = {"fwd": "lstm_fwd", "bwd": "lstm_bwd"}


def _is_port(name):
    return any(p in name for p in PORT)


def _runs(kernels):
    """Runs of consecutive port kernels: [(names, seconds)]."""
    runs, cur = [], None
    for _, name, dur in kernels:
        if _is_port(name):
            if cur is None:
                cur = [[], 0.0]
                runs.append(cur)
            cur[0].append(name)
            cur[1] += dur * 1e-6
        else:
            cur = None
    return runs


def roofline(ctx, which: str):
    trace = ctx.get("trace")
    if trace is None:
        return None
    segs = trace.by_segment()
    rec = REC[which]
    bound_s = time_s = 0.0
    for label, batch in ctx["traced"]:
        seg, cnt = segs.get(label), ctx["counts"].get(label)
        if seg is None or cnt is None or seg["orphans"]:
            continue
        runs = [r for r in _runs(seg["kernels"])
                if any(rec in n for n in r[0])]
        n_rec = sum(sum(rec in n for n in names) for names, _ in runs)
        t, b = batch["feats"].shape[1], batch["feats"].shape[0]
        fwd, bwd = step_bounds(ctx["cfg"], t, b,
                               int(batch["feat_lengths"].sum()))
        bounds = fwd if which == "fwd" else bwd
        if n_rec == 0 or n_rec != cnt[COUNTER[which]] \
                or n_rec != len(bounds):
            continue
        bound_s += sum(bounds)
        time_s += sum(sec for _, sec in runs)
    if time_s <= 0.0:
        return None
    return 100.0 * bound_s / time_s
