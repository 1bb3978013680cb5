"""The port's CTC (eesen_tpu_torch/ops/ctc.py; the recursions'
plain version in ops/ctc_cuda.py on the CPU) against the JAX package: the
Pallas kernels in interpret mode, the XLA scan, and jax.grad of
`ctc_loss`; plus torch's own CTC loss as an independent check."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eesen_tpu.ops import ctc as jctc
from eesen_tpu.ops.ctc_pallas import ctc_alpha_beta_pallas
from eesen_tpu_torch.ops import ctc as tctc
from eesen_tpu_torch.ops import ctc_cuda
from eesen_tpu_torch.utils.math import (
    LOG_ZERO, LOG_ZERO_THRESHOLD, log_add, shift_left, shift_right,
)


def case(seed, t=12, v=7):
    """Five rows: full length with repeated labels, shorter rows, a row
    with label length 0, and a padded row (0 frames, 0 labels) as
    training/batching.py makes with fixed_batch=True."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((5, t, v)) * 2.0).astype(np.float32)
    logit_lengths = np.array([t, t - 2, t // 2 + 1, 0, t - 1], np.int32)
    label_lengths = np.array([4, 3, 0, 0, 2], np.int32)
    labels = rng.integers(1, v, (5, 4)).astype(np.int32)
    labels[0, 1] = labels[0, 0]          # repeats: a skip is not allowed
    labels[1, 2] = labels[1, 1]
    for i, n in enumerate(label_lengths):
        labels[i, n:] = 0
    return logits, logit_lengths, labels, label_lengths


def prep(logits, logit_lengths, labels, label_lengths):
    """The kernels' inputs, made by the JAX package's own prep."""
    _, _, can_skip, _, lp_e = jctc._ctc_prep(
        jnp.asarray(logits), jnp.asarray(logit_lengths), jnp.asarray(labels),
        jnp.asarray(label_lengths), 0,
    )
    can_skip_f = np.where(np.asarray(can_skip), 0.0, LOG_ZERO).astype(
        np.float32)
    s = lp_e.shape[-1]
    _, _, init = tctc._final_states(torch.from_numpy(label_lengths), s)
    return np.array(lp_e), can_skip_f, init.numpy(), np.array(can_skip)


def assert_log_close(got, want, rtol=1e-5, atol=1e-4):
    """LOG_ZERO positions identical; elsewhere within tolerance."""
    got, want = np.asarray(got), np.asarray(want)
    finite = want > LOG_ZERO_THRESHOLD
    np.testing.assert_array_equal(got > LOG_ZERO_THRESHOLD, finite)
    np.testing.assert_allclose(got[finite], want[finite], rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("seed", [0, 1])
def test_alpha_beta_ref_matches_pallas(seed):
    """The plain version against the TPU kernels in interpret mode: the
    same log_add, so sums agree to float32 rounding (atol 1e-4 on values
    of tens)."""
    logits, ll, labels, lab_l = case(seed)
    lp_e, skip_f, init, _ = prep(logits, ll, labels, lab_l)
    a_p, b_p = ctc_alpha_beta_pallas(
        jnp.asarray(lp_e), jnp.asarray(skip_f), jnp.asarray(init),
        jnp.asarray(ll), interpret=True,
    )
    a_t, b_t = ctc_cuda.ctc_alpha_beta(
        torch.from_numpy(lp_e), torch.from_numpy(skip_f),
        torch.from_numpy(init), torch.from_numpy(ll),
    )
    assert a_t.dtype == b_t.dtype == torch.float32
    assert_log_close(a_t.numpy(), a_p)
    assert_log_close(b_t.numpy(), b_p)


def test_padded_row_alpha_is_init_and_beta_log_zero():
    logits, ll, labels, lab_l = case(2)
    lp_e, skip_f, init, _ = prep(logits, ll, labels, lab_l)
    a, b = ctc_cuda.ctc_alpha_beta_ref(
        torch.from_numpy(lp_e), torch.from_numpy(skip_f),
        torch.from_numpy(init), torch.from_numpy(ll),
    )
    row0 = torch.where(torch.arange(lp_e.shape[2]) <= 1,
                       torch.from_numpy(lp_e[3, 0]), LOG_ZERO)
    assert torch.equal(a[3], row0.expand_as(a[3]))
    assert torch.all(b[3] == LOG_ZERO)


@pytest.mark.parametrize("seed", [0, 3])
def test_alpha_beta_ref_matches_forward_backward(seed):
    """Kernel form (ops/ctc_cuda) against the XLA-scan form, in both
    packages."""
    logits, ll, labels, lab_l = case(seed)
    lp_e, skip_f, init, can_skip = prep(logits, ll, labels, lab_l)
    ll_j, a_j, b_j = jctc.ctc_forward_backward(
        jnp.asarray(lp_e), jnp.asarray(can_skip), jnp.asarray(ll),
        jnp.asarray(lab_l),
    )
    ll_t, a_t, b_t = tctc.ctc_forward_backward(
        torch.from_numpy(lp_e), torch.from_numpy(can_skip),
        torch.from_numpy(ll), torch.from_numpy(lab_l),
    )
    a_r, b_r = ctc_cuda.ctc_alpha_beta_ref(
        torch.from_numpy(lp_e), torch.from_numpy(skip_f),
        torch.from_numpy(init), torch.from_numpy(ll),
    )
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=1e-5,
                               atol=1e-5)
    for got, want in ((a_t, a_j), (b_t, b_j), (a_r, a_j), (b_r, b_j)):
        assert_log_close(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 4])
def test_nll_and_dlogits_match_jax_grad(seed):
    """NLL and d(sum w*nll)/dlogits against jax.value_and_grad of the JAX
    ctc_loss (XLA path on the CPU): float32 sums in another order, rtol
    1e-5 / atol 1e-5 (the tolerance the JAX package holds its own two
    paths to).  The padded row's NLL is -log p(blank | frame 0), not 0,
    and its gradient is exactly 0."""
    logits, ll, labels, lab_l = case(seed)
    w = np.random.default_rng(seed + 100).uniform(0.5, 2.0, 5).astype(
        np.float32)

    def f(x):
        nll = jctc.ctc_loss(x, jnp.asarray(ll), jnp.asarray(labels),
                            jnp.asarray(lab_l))
        return jnp.sum(nll * w), nll

    (_, nll_j), g_j = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    nll_t = tctc.ctc_loss(x, torch.from_numpy(ll), torch.from_numpy(labels),
                          torch.from_numpy(lab_l))
    (g_t,) = torch.autograd.grad((nll_t * torch.from_numpy(w)).sum(), x)
    nll_t = nll_t.detach()
    np.testing.assert_allclose(nll_t.numpy(), np.asarray(nll_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-5,
                               atol=1e-5)
    blank0 = -torch.log_softmax(torch.from_numpy(logits[3, 0]), -1)[0]
    assert float(nll_t[3]) == pytest.approx(float(blank0), rel=1e-6)
    assert float(nll_t[3]) > 0.5
    assert torch.all(g_t[3] == 0)


def test_nll_matches_torch_ctc_loss():
    """An independent check: torch.nn.functional.ctc_loss on the rows
    with frames and labels (it gives +inf-free values there), float32
    sums in another order."""
    logits, ll, labels, lab_l = case(5)
    rows = [0, 1, 4]
    nll = tctc.ctc_loss(torch.from_numpy(logits), torch.from_numpy(ll),
                        torch.from_numpy(labels), torch.from_numpy(lab_l))
    lp = torch.log_softmax(torch.from_numpy(logits[rows]), -1)
    want = torch.nn.functional.ctc_loss(
        lp.transpose(0, 1), torch.from_numpy(labels[rows]).long(),
        torch.from_numpy(ll[rows]).long(),
        torch.from_numpy(lab_l[rows]).long(), blank=0, reduction="none",
    )
    np.testing.assert_allclose(nll[rows].numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("normalize", ["frames", "sequences", "none"])
def test_ctc_loss_mean_matches_jax(normalize):
    logits, ll, labels, lab_l = case(6)
    want = jctc.ctc_loss_mean(jnp.asarray(logits), jnp.asarray(ll),
                              jnp.asarray(labels), jnp.asarray(lab_l),
                              normalize=normalize)
    got = tctc.ctc_loss_mean(torch.from_numpy(logits), torch.from_numpy(ll),
                             torch.from_numpy(labels),
                             torch.from_numpy(lab_l), normalize=normalize)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_expand_labels_matches_jax():
    labels = np.array([[3, 3, 5], [2, 0, 0]], np.int32)
    np.testing.assert_array_equal(
        tctc.expand_labels(torch.from_numpy(labels)).numpy(),
        np.asarray(jctc.expand_labels(jnp.asarray(labels))),
    )


def test_alpha_beta_past_1024_states_match_forward_backward():
    """The function the card kernels now compute past 1024 states (a thread
    owns several): ctc_cuda.ctc_alpha_beta (its plain version on the CPU)
    at B=2, L=600 (S=1201), T=1300, against the JAX package's XLA
    ctc_forward_backward.  Enough frames (1300 and 1250 for 600 and 590
    labels with repeats) that every state is reached and the finite region
    is real; the tolerance of assert_log_close."""
    rng = np.random.default_rng(7)
    t, l, v = 1300, 600, 30
    logits = (rng.standard_normal((2, t, v)) * 2.0).astype(np.float32)
    ll = np.array([t, 1250], np.int32)
    lab_l = np.array([l, 590], np.int32)
    labels = rng.integers(1, v, (2, l)).astype(np.int32)
    labels[:, 1::9] = labels[:, 0::9][:, :labels[:, 1::9].shape[1]]
    labels[1, lab_l[1]:] = 0
    lp_e, skip_f, init, can_skip = prep(logits, ll, labels, lab_l)
    assert lp_e.shape == (2, t, 2 * l + 1)
    _, a_j, b_j = jctc.ctc_forward_backward(
        jnp.asarray(lp_e), jnp.asarray(can_skip), jnp.asarray(ll),
        jnp.asarray(lab_l),
    )
    a_t, b_t = ctc_cuda.ctc_alpha_beta(
        torch.from_numpy(lp_e), torch.from_numpy(skip_f),
        torch.from_numpy(init), torch.from_numpy(ll),
    )
    a_j, b_j = np.asarray(a_j), np.asarray(b_j)
    # the last states are reached: alpha finite at the last frame's end
    # states, beta finite at frame 0's first states
    for i in range(2):
        end = 2 * lab_l[i]
        assert (a_j[i, ll[i] - 1, end - 1:end + 1] > LOG_ZERO_THRESHOLD).all()
        assert (b_j[i, 0, :2] > LOG_ZERO_THRESHOLD).all()
    assert_log_close(a_t.numpy(), a_j)
    assert_log_close(b_t.numpy(), b_j)


class FeedModel:
    """One thread's LpFeed<SPT, P> of csrc/ctc_alpha_beta.cu, with
    cp.async's semantics: a copy lands only when a wait_group completes its
    group (groups complete in commit order).  The rows are whole [B, S]
    rows: only the issuing thread reads a slot entry, so every thread's
    schedule is this one.  Asserts that each step reads the slot filled for
    it after that copy landed, that no slot is refilled before its last
    step was read and a barrier passed, and that every group waited on was
    committed."""

    def __init__(self, lp, t0, direction, n, depth):
        self.lp, self.t0, self.dir = lp, t0, direction
        self.n, self.p = n, depth
        slots = max(depth, 1)
        self.data = np.zeros((slots, lp.shape[0]) + lp.shape[2:], lp.dtype)
        self.holds = [None] * slots       # step last issued into the slot
        self.landed = [False] * slots
        self.read_at = [None] * slots     # barrier count at its last read
        self.groups, self.open_copies = [], []
        self.done = 0                     # groups complete
        self.barriers = 0
        self.issued = self.reads = 0

    def _issue(self):
        j = self.issued
        slot = j % self.p
        if self.holds[slot] is not None:
            # the step it held was read and, for a shared-memory slot, a
            # barrier passed since (a register is reloaded in program order)
            assert self.read_at[slot] is not None, (j, slot)
            assert self.p == 1 or self.read_at[slot] < self.barriers, (j, slot)
        self.holds[slot], self.landed[slot] = j, False
        self.read_at[slot] = None
        row = self.lp[:, self.t0 + j * self.dir]
        if self.p == 1:                   # a register load: in place at once
            self.data[slot], self.landed[slot] = row, True
        else:
            self.open_copies.append((slot, j, row))
        self.issued += 1

    def _commit(self):
        self.groups.append(self.open_copies)
        self.open_copies = []

    def barrier(self):
        self.barriers += 1

    def start(self):
        if self.p == 1:
            if self.issued < self.n:
                self._issue()
            return
        for _ in range(self.p - 1):
            if self.issued < self.n:
                self._issue()
            self._commit()

    def take(self, k):
        if self.p > 1:                    # cp.async.wait_group P-2
            self.done = max(self.done, len(self.groups) - (self.p - 2))
            assert self.done <= len(self.groups)
            for g in range(self.done):
                for slot, j, row in self.groups[g]:
                    if self.holds[slot] == j and not self.landed[slot]:
                        self.data[slot], self.landed[slot] = row, True
        slot = k % self.p
        assert self.holds[slot] == k and self.landed[slot], (k, slot)
        assert self.read_at[slot] is None, (k, slot)
        self.read_at[slot] = self.barriers
        self.reads += 1
        return torch.from_numpy(self.data[slot].copy())

    def advance(self):
        if self.issued < self.n:
            self._issue()
        if self.p > 1:
            self._commit()

    def finish(self):
        """Every step issued was read once, and every copy sits in a group
        that a wait completed."""
        assert self.reads == self.issued == self.n
        assert not self.open_copies
        assert all(not g for g in self.groups[self.done:])


def ring_alpha(lp_e, can_skip_f, lens, depth):
    """Kernel 6's loop over FeedModel: lp[t] for t = 1..T-1 comes from the
    ring, added last; the arithmetic is ctc_alpha_ref's."""
    _, t_max, s = lp_e.shape
    feed = FeedModel(lp_e.numpy(), 1, 1, max(t_max - 1, 0), depth)
    feed.start()
    if t_max == 0:
        feed.finish()
        return None
    lane = torch.arange(s)[None, :]
    out = torch.empty_like(lp_e)
    a = torch.where(lane <= 1, lp_e[:, 0], LOG_ZERO)
    out[:, 0] = a
    for t in range(1, t_max):
        feed.barrier()
        lp_t = feed.take(t - 1)
        prev2 = shift_right(a, 2) + can_skip_f
        new = lp_t + log_add(log_add(a, shift_right(a, 1)), prev2)
        a = torch.where(t < lens[:, None], new, a)
        out[:, t] = a
        feed.advance()
    feed.finish()
    return out


def ring_beta(lp_e, can_skip_f, init, lens, depth):
    """Kernel 7's loop over FeedModel: n = LOG_ZERO + lp[T-1] at t = T-1
    (the clamped lp[min(t+1, T-1)]), then each step t >= 1 ends with
    n = beta[t] + lp[t] from the ring, rows T-1 down to 1."""
    _, t_max, _ = lp_e.shape
    feed = FeedModel(lp_e.numpy(), t_max - 1, -1, max(t_max - 1, 0), depth)
    feed.start()
    if t_max == 0:
        feed.finish()
        return None
    skip_src = torch.where(shift_left(can_skip_f, 2) > LOG_ZERO_THRESHOLD,
                           0.0, LOG_ZERO)
    out = torch.empty_like(lp_e)
    n = torch.full_like(init, LOG_ZERO) + lp_e[:, t_max - 1]
    for t in range(t_max - 1, -1, -1):
        feed.barrier()
        rec = log_add(log_add(n, shift_left(n, 1)),
                      shift_left(n, 2) + skip_src)
        b = torch.where(t == lens[:, None] - 1, init,
                        torch.where(t < lens[:, None] - 1, rec, LOG_ZERO))
        out[:, t] = b
        if t >= 1:
            n = b + feed.take(t_max - 1 - t)
            feed.advance()
    feed.finish()
    return out


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
@pytest.mark.parametrize("t_case", ["0", "1", "P-1", "P", "P+1", "768"])
def test_ring_schedule_gives_the_plain_recursions(depth, t_case):
    """The kernels' lp ring, walked as they walk it (alpha upward from
    t = 1, beta downward with the clamped t+1), at T around the ring's
    depth: every step reads the row meant for it, no slot is refilled
    before it was read, the groups waited on were committed; and the
    recursions driven through it equal ctc_alpha_ref / ctc_beta_ref bit
    for bit (rows of full length, shorter than the depth, one frame, 0)."""
    t = {"0": 0, "1": 1, "P-1": max(depth - 1, 1), "P": depth,
         "P+1": depth + 1, "768": 768}[t_case]
    rng = np.random.default_rng(depth * 1000 + t)
    b, s = 5, 9
    lp_e = torch.from_numpy(-rng.exponential(2.0, (b, t, s)).astype(
        np.float32))
    skip = np.where(rng.random((b, s)) < 0.5, 0.0, LOG_ZERO).astype(
        np.float32)
    skip[:, :2] = LOG_ZERO
    skip = torch.from_numpy(skip)
    _, _, init = tctc._final_states(torch.tensor([4, 3, 1, 0, 2]), s)
    lens = torch.tensor([t, max(t - 1, 0), min(depth - 1, t), min(1, t), 0])
    alpha = ring_alpha(lp_e, skip, lens, depth)
    beta = ring_beta(lp_e, skip, init, lens, depth)
    if t == 0:
        assert alpha is None and beta is None
        return
    assert torch.equal(alpha, ctc_cuda.ctc_alpha_ref(lp_e, skip, lens))
    assert torch.equal(beta, ctc_cuda.ctc_beta_ref(lp_e, skip, init, lens))
