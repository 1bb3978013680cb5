"""dedup_prune_roofline.decode: kernel 2 in the traced chunks, each
chunk's bound over its recorded device time, in %.

A chunk of T' searched frames launches kernel 2 once for the initial
closure (K + K * Dx lanes a row) and twice a frame (the emitting merge,
K * De lanes, and the closure merge, K + K * Dx); a chunk counts only
where its records, the port's counter and 1 + 2 T' agree and no launch
call of the chunk lacks its record."""

from benchmark.metrics.costs import dedup_bound

KERNEL = "dedup_prune_kernel"


def read(ctx):
    trace = ctx.get("trace")
    if trace is None:
        return None
    segs = trace.by_segment()
    g = ctx["graph"]
    k = ctx["spec"]["search"]["max_active"]
    m_e = k * max(g.max_emit_degree, 1)
    m_x = k + k * max(g.max_closure_degree, 1)
    bound_s = time_s = 0.0
    for label, r in ctx["traced"]:
        seg, cnt = segs.get(label), ctx["counts"].get(label)
        if seg is None or cnt is None or seg["orphans"]:
            continue
        recs = [(n, d) for _, n, d in seg["kernels"] if KERNEL in n]
        tp = r["searched"]
        if not recs or len(recs) != cnt["dedup_prune"] \
                or len(recs) != 1 + 2 * tp:
            continue
        b = r["kept"].shape[0]
        bound_s += dedup_bound(b, m_x, k) * (1 + tp) + dedup_bound(b, m_e, k) * tp
        time_s += sum(d for _, d in recs) * 1e-6
    if time_s <= 0.0:
        return None
    return 100.0 * bound_s / time_s
