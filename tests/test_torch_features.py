"""eesen_tpu_torch/frontend/features.py against eesen_tpu's on the CPU, on
the same numpy inputs made from a seed: fbank (every window type, energy
on and off, VTLN warps, snip_edges both ways, batched against single),
digital silence at the log floor, seeded dither, and the post-processing
functions (deltas, shifted deltas, splice, subsample, CMVN) on numpy and
tensor inputs."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eesen_tpu.frontend import features as jf
from eesen_tpu_torch.frontend import features as tf

# port vs JAX on the CPU: log-mel (rtol and atol) where the mel power is
# above MEL_FLOOR; below it the log of FFT rounding differs between FFTs
TOL = 1e-4
MEL_FLOOR = 1.0
LOG_TINY = float(np.log(np.finfo(np.float32).tiny))


def waves(b=3, n=8000, seed=0):
    """Speech-level noise plus a tone, int16 range."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    w = rng.standard_normal((b, n)) * 300 + 3000 * np.sin(
        2 * np.pi * rng.uniform(100, 3000, (b, 1)) * t)
    return w.astype(np.float32)


def options(pkg, **frame):
    return pkg.FbankOptions(
        frame_opts=pkg.FrameOptions(**{"dither": 0.0, **frame}),
        mel_opts=pkg.MelOptions(num_bins=23),
    )


def mel_power(w, opts):
    """The JAX package's mel energies before the log (the floor mask)."""
    frames = jf.frame_signal(jnp.asarray(w), opts.frame_opts)
    mel = jf.mel_banks(opts.mel_opts, opts.frame_opts)
    return np.asarray(jf.power_spectrum(frames)) @ mel.T


def assert_logmel_close(got, want, power):
    """Elementwise within TOL where the mel power is above MEL_FLOOR."""
    assert got.shape == want.shape
    mask = np.broadcast_to(power > MEL_FLOOR, got.shape[:-1] + (
        power.shape[-1],))
    mel_got = got[..., -power.shape[-1]:]
    mel_want = want[..., -power.shape[-1]:]
    assert mask.mean() > 0.9
    np.testing.assert_allclose(mel_got[mask], mel_want[mask], rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("energy", [False, True], ids=["mel", "energy"])
@pytest.mark.parametrize("snip", [True, False], ids=["snip", "nosnip"])
@pytest.mark.parametrize("window", ["povey", "hamming", "hanning",
                                    "rectangular"])
def test_fbank_matches_jax(window, snip, energy):
    w = waves()
    jo = dataclasses.replace(options(jf, window_type=window, snip_edges=snip),
                             use_energy=energy)
    to = dataclasses.replace(options(tf, window_type=window, snip_edges=snip),
                             use_energy=energy)
    want = np.asarray(jf.fbank(jnp.asarray(w), jo))
    got = tf.fbank(w, to, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    got = got.numpy()
    assert got.shape[-2] == jf.num_frames(w.shape[-1], jo.frame_opts)
    assert_logmel_close(got, want, mel_power(w, jo))
    if energy:
        np.testing.assert_allclose(got[..., 0], want[..., 0], rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("warp", [0.8, 1.2])
def test_fbank_vtln_matches_jax(warp):
    w = waves(seed=1)
    np.testing.assert_array_equal(
        tf.mel_banks(tf.MelOptions(num_bins=23), tf.FrameOptions(), warp),
        jf.mel_banks(jf.MelOptions(num_bins=23), jf.FrameOptions(), warp))
    want = np.asarray(jf.fbank(jnp.asarray(w), options(jf), vtln_warp=warp))
    got = tf.fbank(w, options(tf), vtln_warp=warp, device="cpu").numpy()
    assert not np.allclose(
        got, tf.fbank(w, options(tf), device="cpu").numpy(), atol=1e-2)
    assert_logmel_close(got, want, mel_power(w, options(jf)))


def test_fbank_batched_matches_single():
    w = waves(b=4, n=7000, seed=2)
    batched = tf.fbank(torch.from_numpy(w), options(tf)).numpy()
    for i in range(len(w)):
        single = tf.fbank(torch.from_numpy(w[i]), options(tf)).numpy()
        np.testing.assert_allclose(batched[i], single, rtol=1e-6, atol=1e-5)


def test_digital_silence_takes_the_log_floor():
    """Frames wholly inside digital silence give log(tiny) in every bin,
    exactly, in both packages (an all-zero frame's FFT is exactly 0)."""
    w = waves(b=1, n=9600, seed=3)[0]
    w[3200:6400] = 0.0
    jo, to = options(jf), options(tf)
    want = np.asarray(jf.fbank(jnp.asarray(w), jo))
    got = tf.fbank(w, to, device="cpu").numpy()
    ws, shift = jo.frame_opts.window_size, jo.frame_opts.window_shift
    silent = [f for f in range(got.shape[0])
              if f * shift >= 3200 and f * shift + ws <= 6400]
    assert len(silent) >= 15
    assert np.all(got[silent] == np.float32(LOG_TINY))
    np.testing.assert_array_equal(got[silent], want[silent])
    loud = [f for f in range(got.shape[0]) if f * shift + ws <= 3200]
    np.testing.assert_allclose(got[loud], want[loud], rtol=TOL, atol=TOL)


def test_frame_signal_dither_is_the_drawn_noise():
    """With a generator the port adds dither * randn(generator) to the raw
    frames before DC removal, preemphasis and the window: recomputed by
    hand in float64 from the same generator seed."""
    opts = tf.FrameOptions(dither=1.0)
    w = waves(b=2, n=4000, seed=4)
    got = tf.frame_signal(w, opts, device="cpu",
                          generator=torch.Generator().manual_seed(7))
    ws, shift, nfft = opts.window_size, opts.window_shift, (
        opts.padded_window_size)
    f = tf.num_frames(w.shape[-1], opts)
    idx = np.arange(f)[:, None] * shift + np.arange(ws)[None, :]
    noise = torch.randn((2, f, ws), generator=torch.Generator().manual_seed(7))
    x = w[:, idx].astype(np.float64) + noise.numpy().astype(np.float64)
    x = x - x.mean(axis=-1, keepdims=True)
    prev = np.concatenate([x[..., :1], x[..., :-1]], axis=-1)
    x = (x - opts.preemph_coeff * prev) * tf.feature_window(opts)
    want = np.pad(x, [(0, 0), (0, 0), (0, nfft - ws)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-3)
    # and without a generator there is no dither, as without a JAX key
    plain = tf.frame_signal(w, opts, device="cpu").numpy()
    np.testing.assert_allclose(
        plain, np.asarray(jf.frame_signal(jnp.asarray(w), jf.FrameOptions())),
        rtol=1e-5, atol=1e-3)


def test_dithered_fbank_is_seeded_and_unbiased():
    """The same seed gives the same bits; the features move from the
    no-dither ones by little and without a bias (unit-variance noise on
    speech-level waves)."""
    opts = dataclasses.replace(options(tf), frame_opts=tf.FrameOptions())
    w = waves(b=4, n=16000, seed=5)
    a = tf.fbank(w, opts, device="cpu",
                 generator=torch.Generator().manual_seed(0)).numpy()
    b = tf.fbank(w, opts, device="cpu",
                 generator=torch.Generator().manual_seed(0)).numpy()
    c = tf.fbank(w, opts, device="cpu",
                 generator=torch.Generator().manual_seed(1)).numpy()
    ref = tf.fbank(w, opts, device="cpu").numpy()
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    shift = a - ref
    assert np.abs(shift).max() < 0.05
    assert abs(shift.mean()) < 10 * shift.std() / np.sqrt(shift.size) + 1e-4


def test_num_frames_and_windows_match_jax():
    for snip in (True, False):
        o = jf.FrameOptions(snip_edges=snip)
        p = tf.FrameOptions(snip_edges=snip)
        for n in (0, 399, 400, 401, 559, 560, 16000):
            assert tf.num_frames(n, p) == jf.num_frames(n, o)
    for kind in ("povey", "hamming", "hanning", "rectangular"):
        np.testing.assert_array_equal(
            tf.feature_window(tf.FrameOptions(window_type=kind)),
            jf.feature_window(jf.FrameOptions(window_type=kind)))
    np.testing.assert_array_equal(tf.povey_window(400), jf.povey_window(400))
    for a, b in zip(tf.delta_filters(3, 2), jf.delta_filters(3, 2)):
        np.testing.assert_array_equal(a, b)


def feats(seed=6, shape=(2, 37, 5)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


POST = {
    "deltas": (lambda m, x: m.compute_deltas(x, 2, 2)),
    "deltas_o1_w3": (lambda m, x: m.compute_deltas(x, 1, 3)),
    "shifted_deltas": (lambda m, x: m.compute_shifted_deltas(x, 1, 7, 3)),
    "splice": (lambda m, x: m.splice_frames(x, 2, 3)),
    "subsample": (lambda m, x: m.subsample_frames(x, 3, 1)),
    "cmvn_stats": (lambda m, x: m.cmvn_stats(x)),
}


@pytest.mark.parametrize("name", sorted(POST))
@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_post_processing_matches_jax(name, kind):
    """numpy in -> numpy out, the JAX package's numpy lines (equal bits);
    tensor in -> tensor out on its device (float32, another order)."""
    x = feats()
    want = np.asarray(POST[name](jf, jnp.asarray(x)))
    if kind == "numpy":
        got = POST[name](tf, x)
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, POST[name](jf, x))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        got = POST[name](tf, torch.from_numpy(x))
        assert torch.is_tensor(got) and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weights"])
@pytest.mark.parametrize("norm_vars", [False, True])
@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_cmvn_matches_jax(kind, norm_vars, weighted):
    x = feats(7, (41, 6)) * 3 + 5
    w = (np.random.default_rng(8).uniform(0, 1, 41).astype(np.float32)
         if weighted else None)
    jstats = np.asarray(jf.cmvn_stats(jnp.asarray(x),
                                      None if w is None else jnp.asarray(w)))
    want = np.asarray(jf.apply_cmvn(jnp.asarray(x), jnp.asarray(jstats),
                                    norm_vars))
    if kind == "numpy":
        stats = tf.cmvn_stats(x, w)
        got = tf.apply_cmvn(x, stats, norm_vars)
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(stats, jf.cmvn_stats(x, w))
        np.testing.assert_array_equal(got, jf.apply_cmvn(x, stats, norm_vars))
    else:
        stats = tf.cmvn_stats(torch.from_numpy(x),
                              None if w is None else torch.from_numpy(w))
        got = tf.apply_cmvn(torch.from_numpy(x), stats, norm_vars)
        assert torch.is_tensor(got)
        stats, got = stats.numpy(), got.numpy()
    np.testing.assert_allclose(stats, jstats, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if norm_vars and not weighted:
        np.testing.assert_allclose(got.mean(0), 0, atol=1e-5)
        np.testing.assert_allclose(got.std(0), 1, atol=1e-4)


def test_fbank_on_a_host_array_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tf.fbank(waves(b=1)[0])
    # a tensor computes on its own device, whatever `device` says
    assert tf.fbank(torch.from_numpy(waves(b=1)[0])).device.type == "cpu"
