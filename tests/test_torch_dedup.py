"""The port's recombination (eesen_tpu_torch/ops/beam_cuda.py and the
sort path in decoder/beam.py) against the JAX package on the CPU: the
Pallas kernel in interpret mode (exact, same tie order) and the XLA sort
path `_dedup_and_prune`; and a numpy model of the CUDA kernel's algorithm
(csrc/dedup_prune.cu: hash-table minimum per dst, radix select, sort of
the survivors, prefix-sum filler), which cannot run here, held bit for bit
against both on adversarial rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedup_cases import CASES, make_case

from eesen_tpu.decoder.beam import _dedup_and_prune as j_dedup_and_prune
from eesen_tpu.ops.beam_pallas import dedup_prune as j_dedup_prune
from eesen_tpu_torch.decoder.beam import (
    _dedup_and_prune as t_dedup_and_prune,
)
from eesen_tpu_torch.ops import beam_cuda


def make_props(rng, b, m, n_states, dead_frac=0.15):
    """Random proposals as in tests/test_beam_pallas.py."""
    dst = rng.integers(0, n_states, (b, m)).astype(np.int32)
    score = (rng.standard_normal((b, m)) * 4.0).astype(np.float32)
    dead = rng.random((b, m)) < dead_frac
    score[dead] = np.inf
    dst[dead] = 0
    return dst, score


def canon(states, scores):
    """Order-independent canonical form of an active set."""
    st, sc = np.asarray(states), np.asarray(scores)
    return [
        sorted(zip(st[b][np.isfinite(sc[b])].tolist(),
                   sc[b][np.isfinite(sc[b])].tolist()))
        for b in range(st.shape[0])
    ]


@pytest.mark.parametrize("m,k,n_states", [(128, 64, 100), (256, 64, 300),
                                          (200, 32, 40)])
def test_ref_equals_pallas_kernel(m, k, n_states):
    """Padding, beam, both sorts and the tie order are the kernel's: the
    three outputs are equal, not just close."""
    rng = np.random.default_rng(m)
    dst, score = make_props(rng, 8, m, n_states)
    want = j_dedup_prune(jnp.asarray(dst), jnp.asarray(score), k, 6.0,
                         interpret=True)
    got = beam_cuda.dedup_prune(torch.from_numpy(dst),
                                torch.from_numpy(score), k, 6.0)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 or g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("funnel", [0, 300])
def test_sort_path_matches_xla(funnel):
    """The port of _dedup_and_prune against JAX's at m=1000 (stable sorts:
    equal arrays here, as the inputs carry no score ties)."""
    rng = np.random.default_rng(5)
    dst, score = make_props(rng, 8, 1000, 4000)
    want = j_dedup_and_prune(jnp.asarray(dst), jnp.asarray(score), 128,
                             6.0, funnel=funnel)
    got = t_dedup_and_prune(torch.from_numpy(dst), torch.from_numpy(score),
                            128, 6.0, funnel=funnel)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_kernel_ref_matches_sort_path_canonically():
    rng = np.random.default_rng(0)
    dst, score = make_props(rng, 8, 1000, 4000)
    st_x, sc_x, _ = t_dedup_and_prune(torch.from_numpy(dst),
                                      torch.from_numpy(score), 128, 6.0)
    st_k, sc_k, kept = beam_cuda.dedup_prune_ref(
        torch.from_numpy(dst), torch.from_numpy(score), 128, 6.0
    )
    assert canon(st_k, sc_k) == canon(st_x, sc_x)
    alive = torch.isfinite(sc_k)
    np.testing.assert_array_equal(
        np.take_along_axis(dst, kept.long().numpy(), 1)[alive.numpy()],
        st_k[alive].numpy(),
    )


def test_beam_threshold_applied():
    rng = np.random.default_rng(1)
    dst, score = make_props(rng, 8, 256, 300, dead_frac=0.0)
    beam = 1.0
    _, sc, _ = beam_cuda.dedup_prune(torch.from_numpy(dst),
                                     torch.from_numpy(score), 64, beam)
    sc = sc.numpy()
    for b in range(8):
        alive = np.isfinite(sc[b])
        assert alive.any()
        assert sc[b][alive].max() <= score[b].min() + beam + 1e-6


def test_fewer_live_than_k():
    """Fewer distinct live states than K: dead slots are -1/inf, live
    states distinct, kept clamped below m."""
    rng = np.random.default_rng(2)
    dst, score = make_props(rng, 8, 128, 10, dead_frac=0.5)
    st, sc, kept = beam_cuda.dedup_prune(torch.from_numpy(dst),
                                         torch.from_numpy(score), 64, 100.0)
    st, sc = st.numpy(), sc.numpy()
    for b in range(8):
        alive = np.isfinite(sc[b])
        assert alive.sum() <= 10
        assert (st[b][~alive] == -1).all()
        assert len(set(st[b][alive])) == alive.sum()
    assert int(kept.max()) < 128


def test_padded_width_and_cap():
    assert beam_cuda.padded_width(100) == 128
    assert beam_cuda.padded_width(4096) == 4096
    assert beam_cuda.padded_width(14336) == beam_cuda.MAX_LANES
    assert beam_cuda.padded_width(16385) > beam_cuda.MAX_LANES
    with pytest.raises(ValueError):
        beam_cuda.dedup_prune_ref(torch.zeros((1, 10), dtype=torch.int32),
                                  torch.zeros((1, 10)), 129, 1.0)


DEAD = np.uint64(2**64 - 1)


def ord_bits(s):
    """Order-preserving unsigned bits of float32 scores (csrc ord_bits)."""
    b = s.view(np.uint32).astype(np.uint64)
    return np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)


def from_ord(o):
    o = o.astype(np.uint64)
    b = np.where(o & 0x80000000, o & 0x7FFFFFFF, ~o & 0xFFFFFFFF)
    return b.astype(np.uint32).view(np.float32)


def cluster_model(dst, score, k, beam):
    """The kernel's algorithm step for step, one row at a time, with its
    partition of the padded row over CLUSTER CTAs of contiguous lanes."""
    b, m = dst.shape
    mp = beam_cuda.padded_width(m)
    cl = beam_cuda.CLUSTER
    per_cta = mp // cl
    states = np.full((b, k), -1, np.int32)
    scores = np.full((b, k), np.inf, np.float32)
    kept = np.zeros((b, k), np.int32)
    for r in range(b):
        s = np.full(mp, np.inf, np.float32)
        s[:m] = score[r] + np.float32(0.0)          # -0.0 -> +0.0
        d = np.zeros(mp, np.int64)
        d[:m] = dst[r]
        thr = np.float32(s.min()) + np.float32(beam)
        cand = np.flatnonzero((s <= thr) & (s < np.inf))
        sbits = ord_bits(s)
        # the table: the least score bits per dst, then the least lane there
        best_s, best_l = {}, {}
        for i in cand:
            best_s[d[i]] = min(best_s.get(d[i], 2**32), sbits[i])
        for i in cand:
            if sbits[i] == best_s[d[i]]:
                best_l[d[i]] = min(best_l.get(d[i], 2**32), i)
        keys = np.full(mp, DEAD, np.uint64)
        win = [i for i in cand if best_l.get(d[i]) == i]
        keys[win] = (sbits[win] << np.uint64(32)) | np.asarray(win, np.uint64)
        live = keys != DEAD
        nlive = int(live.sum())
        # radix select of the k-th smallest live key, one 8-bit digit a pass
        prefix, mask = np.uint64(0), np.uint64(0)
        if nlive > k:
            rem = k
            for sh in (56, 48, 40, 32, 8, 0):
                pick = live & ((keys & mask) == prefix)
                hist = np.bincount(((keys[pick] >> np.uint64(sh))
                                    & np.uint64(255)).astype(np.int64),
                                   minlength=256)
                below = np.concatenate([[0], np.cumsum(hist)[:-1]])
                bin_ = int(np.flatnonzero((below < rem)
                                          & (rem <= below + hist))[0])
                rem -= int(below[bin_])
                prefix |= np.uint64(bin_ << sh)
                mask = np.uint64((2**64 - 1) << sh & (2**64 - 1))
                if hist[bin_] == rem:
                    break
        surv = np.sort(keys[live & ((keys & mask) <= prefix)])
        n = min(nlive, k)
        assert len(surv) == n
        lane = (surv & np.uint64(0xFFFFFFFF)).astype(np.int64)
        scores[r, :n] = from_ord(surv >> np.uint64(32))
        states[r, :n] = d[lane]
        kept[r, :n] = np.minimum(lane, m - 1)
        # the filler: each CTA's dead lanes after the live ones and after
        # the dead lanes of the CTAs below it
        live_cta = live.reshape(cl, per_cta).sum(1)
        for q in range(cl):
            dead_below = q * per_cta - int(live_cta[:q].sum())
            idx = q * per_cta + np.flatnonzero(
                ~live[q * per_cta:(q + 1) * per_cta])
            pos = nlive + dead_below + np.arange(len(idx))
            ok = pos < k
            kept[r, pos[ok]] = np.minimum(idx[ok], m - 1)
    return states, scores, kept


def assert_bits_equal(got, want, what, signs=True):
    for name, g, w in zip(("states", "scores", "kept"), got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (what, name)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")
        if signs:
            np.testing.assert_array_equal(np.signbit(g), np.signbit(w),
                                          err_msg=f"{what} {name} sign")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("m,k", [(100, 64), (128, 128), (700, 32),
                                 (1024, 512), (1024, 1024)])
def test_cluster_model_equals_plain(case, m, k):
    """The kernel's algorithm gives dedup_prune_ref's three outputs bit for
    bit: -0.0/+0.0, negative scores, ties, every lane dead, one dst, fewer
    live lanes than K, K = Mp, pad lanes, int32-extreme dst."""
    dst, score = make_case(case, 3, m, seed=m + k)
    want = beam_cuda.dedup_prune_ref(torch.from_numpy(dst),
                                     torch.from_numpy(score), k, 6.0)
    assert_bits_equal(cluster_model(dst, score, k, 6.0),
                      [w.numpy() for w in want], case)


@pytest.mark.parametrize("case", CASES)
def test_cluster_model_equals_pallas_kernel(case):
    """... and the Pallas kernel's, in interpret mode: equal values in the
    same slots.  The Pallas kernel writes a -0.0 score as it came, where
    the port (kernel and plain version) writes +0.0, so sign bits are not
    compared here."""
    dst, score = make_case(case, 2, 200, seed=3)
    want = j_dedup_prune(jnp.asarray(dst), jnp.asarray(score), 64, 6.0,
                         interpret=True)
    assert_bits_equal(cluster_model(dst, score, 64, 6.0), want, case,
                      signs=False)


@pytest.mark.parametrize("mp,k,want", [
    (128, 64, 512),            # 32 slots a CTA + 1: 396 B < 64 keys of 8 B
    (4096, 512, 12304),        # 1025 slots x 12 B = 12300, to 16 B
    (16384, 512, 49168),       # 4097 x 12 = 49164
    (16384, 16384, 131072),    # the survivors' buffer: 16384 x 8 B
])
def test_dedup_smem_bytes(mp, k, want):
    """The kernel's shared memory per CTA, hand-computed: the CTA's share
    of the 2*Mp-slot table (12 B a slot) or CTA 0's sort buffer."""
    assert beam_cuda.smem_bytes(mp, k) == want
    assert want <= 232448
