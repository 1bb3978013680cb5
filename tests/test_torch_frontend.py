"""The rest of the port's front end against eesen_tpu's on the CPU: the
feature pipeline at both recipe configurations, MFCC, spectrogram, PLP
(Durbin, LPC -> cepstrum), resampling, and Kaldi pitch (against the
reference extractor's goldens at tests/test_pitch.py's tolerances, and
against the JAX package), process_pitch and fbank_pitch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eesen_tpu.frontend import features as jfeat
from eesen_tpu.frontend import mfcc as jm
from eesen_tpu.frontend import pipeline as jpipe
from eesen_tpu.frontend import pitch as jp
from eesen_tpu.frontend import plp as jplp
from eesen_tpu.frontend import resample as jr
from eesen_tpu.recipes import config as jconfig
from eesen_tpu_torch.frontend import mfcc as tm
from eesen_tpu_torch.frontend import pipeline as tpipe
from eesen_tpu_torch.frontend import pitch as tp
from eesen_tpu_torch.frontend import plp as tplp
from eesen_tpu_torch.frontend import resample as tr
from eesen_tpu_torch.recipes import config as tconfig

from tests.test_pitch import GOLDEN
from tests.test_torch_features import MEL_FLOOR, TOL, mel_power, waves

# tests/test_pitch.py:37-47: near-tie lag choices may differ by one grid
# step (0.5%) on a few frames of "speechish"
PITCH_CASES = [("tone220", 1e-4, 1e-4), ("vibrato", 1e-4, 1e-4),
               ("noise", 1e-4, 1e-4), ("speechish", 6e-3, 2e-3),
               ("tone_8k", 1e-4, 1e-4)]
# process_pitch: the delta column (with the rng's noise) has equal bits;
# the other two differ by float32 ulps of exp, pow and cumsum between
# XLA's and PyTorch's CPU kernels (3.8e-6 measured on the goldens)
PROCESS_TOL = 1e-5


def raw_feats(seed=0):
    """Log-mel-like raw features of six utterances, three speakers."""
    rng = np.random.default_rng(seed)
    raw = {f"u{i}": (rng.standard_normal((40 + 7 * i, 40)) * 2 + 12).astype(
        np.float32) for i in range(6)}
    return raw, {k: f"spk{i % 3}" for i, k in enumerate(raw)}


@pytest.mark.parametrize("recipe", ["wsj_phn", "tedlium_phn_30ms"],
                         ids=["deltas", "splice_skip3"])
def test_pipeline_matches_jax(recipe):
    """Both recipe configurations (_DELTAS, 120-d; _SPLICE_SKIP3, 360-d):
    the host copy gives the JAX package's bits, including the speaker
    CMVN stats and the x3 subsampled copies."""
    raw, utt2spk = raw_feats()
    jcfg = jconfig.RECIPES[recipe].pipeline
    tcfg = tconfig.RECIPES[recipe].pipeline
    jstats = jpipe.speaker_cmvn_stats(raw, utt2spk)
    tstats = tpipe.speaker_cmvn_stats(raw, utt2spk)
    assert sorted(tstats) == sorted(jstats) == ["spk0", "spk1", "spk2"]
    for s in jstats:
        np.testing.assert_array_equal(tstats[s], jstats[s])
    jpl = jpipe.FeaturePipeline(jcfg, jstats, utt2spk)
    tpl = tpipe.FeaturePipeline(tcfg, tstats, utt2spk)
    assert tpl.output_dim(40) == jpl.output_dim(40) == (
        tconfig.pipeline_input_dim(tconfig.RECIPES[recipe]))
    for k, v in raw.items():
        got = tpl(k, v)
        assert got.shape[1] == tpl.output_dim(40)
        np.testing.assert_array_equal(got, jpl(k, v))
        copies_t, copies_j = tpl.subsampled_copies(k, v), (
            jpl.subsampled_copies(k, v))
        assert len(copies_t) == len(copies_j) == tcfg.subsample_n
        for a, b in zip(copies_t, copies_j):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("energy,lifter", [(True, 22.0), (False, 0.0)])
def test_mfcc_matches_jax(energy, lifter):
    w = waves(seed=10)
    kw = dict(num_ceps=13, use_energy=energy, cepstral_lifter=lifter)
    want = np.asarray(jm.mfcc(jnp.asarray(w), jm.MfccOptions(
        frame_opts=jm.FrameOptions(dither=0.0), **kw)))
    got = tm.mfcc(w, tm.MfccOptions(frame_opts=tm.FrameOptions(dither=0.0),
                                    **kw), device="cpu").numpy()
    np.testing.assert_array_equal(tm.dct_matrix(13, 23), jm.dct_matrix(13, 23))
    np.testing.assert_array_equal(tm.lifter_coeffs(22.0, 13),
                                  jm.lifter_coeffs(22.0, 13))
    assert got.shape == want.shape == (3, 48, 13)
    # cepstra are sums of 23 log-mels of magnitude ~20: TOL of that scale
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * 23)


def test_spectrogram_matches_jax():
    w = waves(seed=11)
    jo = jm.SpectrogramOptions(frame_opts=jm.FrameOptions(dither=0.0))
    to = tm.SpectrogramOptions(frame_opts=tm.FrameOptions(dither=0.0))
    want = np.asarray(jm.spectrogram(jnp.asarray(w), jo))
    got = tm.spectrogram(w, to, device="cpu").numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got[..., 0], want[..., 0], rtol=TOL, atol=TOL)
    frames = jm.frame_signal(jnp.asarray(w), jo.frame_opts)
    power = np.asarray(jm.power_spectrum(frames))
    mask = power[..., 1:] > MEL_FLOOR
    assert mask.mean() > 0.9
    np.testing.assert_allclose(got[..., 1:][mask], want[..., 1:][mask],
                               rtol=TOL, atol=TOL)


def test_durbin_and_lpc_to_cepstrum_match_jax():
    """On autocorrelations of random AR signals (positive definite)."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((5, 400))
    ac = np.stack([[np.dot(r[:400 - k], r[k:]) for k in range(13)]
                   for r in x]).astype(np.float32)
    jl, je = jplp._durbin_batch(jnp.asarray(ac), 12)
    tl, te = tplp._durbin_batch(torch.from_numpy(ac), 12)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5)
    lpc = np.array(jl)
    np.testing.assert_allclose(
        tplp._lpc_to_cepstrum(torch.from_numpy(lpc), 12).numpy(),
        np.asarray(jplp._lpc_to_cepstrum(jnp.asarray(lpc), 12)),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tplp.idft_bases(13, 25),
                                  jplp.idft_bases(13, 25))
    np.testing.assert_array_equal(
        tplp.equal_loudness(tplp.MelOptions(num_bins=23), tplp.FrameOptions()),
        jplp.equal_loudness(jplp.MelOptions(num_bins=23), jplp.FrameOptions()))


def test_plp_matches_jax():
    w = waves(seed=13)
    jo = jplp.PlpOptions(frame_opts=jplp.FrameOptions(dither=0.0))
    to = tplp.PlpOptions(frame_opts=tplp.FrameOptions(dither=0.0))
    want = np.asarray(jplp.plp(jnp.asarray(w), jo))
    got = tplp.plp(w, to, device="cpu").numpy()
    assert got.shape == want.shape == (3, 48, 13)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("rates", [(16000, 8000), (8000, 16000),
                                   (44100, 16000), (16000, 22050)])
def test_resample_matches_jax(rates):
    w = waves(b=2, n=6000, seed=14)
    want = np.asarray(jr.resample(jnp.asarray(w), *rates))
    got = tr.resample(w, *rates, device="cpu")
    assert torch.is_tensor(got) and got.shape == want.shape
    # outputs reach ~3000: float32 sums of 33 taps in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)
    assert tr.resample(w, 16000, 16000) is w


@pytest.mark.parametrize("name,tol_pitch,tol_nccf", PITCH_CASES)
def test_pitch_matches_golden_and_jax(name, tol_pitch, tol_nccf):
    """Against the reference binary's outputs at tests/test_pitch.py's
    per-case tolerances, and against the JAX package at the same ones."""
    data = np.load(GOLDEN)
    wave = data[f"{name}_wave"]
    opts = tp.PitchOptions(samp_freq=float(data[f"{name}_sr"]))
    got = tp.kaldi_pitch(wave, opts, device="cpu")
    assert got.dtype == torch.float32
    got = got.numpy()
    for ref in (data[f"{name}_raw"], np.asarray(jp.kaldi_pitch(
            jnp.asarray(wave), jp.PitchOptions(samp_freq=opts.samp_freq)))):
        assert got.shape == ref.shape
        assert (np.abs(got[:, 1] - ref[:, 1]) / ref[:, 1]).max() <= tol_pitch
        assert np.abs(got[:, 0] - ref[:, 0]).max() <= tol_nccf


def test_linear_resample_matches_jax():
    w = np.load(GOLDEN)["vibrato_wave"]
    want = np.asarray(jp.linear_resample(jnp.asarray(w), 16000, 4000,
                                         1000.0, 1))
    got = tp.linear_resample(w, 16000, 4000, 1000.0, 1, device="cpu")
    assert got.shape == want.shape == (4000,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("seed", [0, 3])
def test_process_pitch_matches_jax(seed):
    raw = np.asarray(jp.kaldi_pitch(jnp.asarray(np.load(GOLDEN)[
        "vibrato_wave"])))
    want = np.asarray(jp.process_pitch(jnp.asarray(raw),
                                       rng=np.random.default_rng(seed)))
    got = tp.process_pitch(raw, rng=np.random.default_rng(seed),
                           device="cpu").numpy()
    assert got.shape == want.shape == (raw.shape[0], 3)
    np.testing.assert_array_equal(got[:, 2], want[:, 2])
    np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=PROCESS_TOL,
                               atol=PROCESS_TOL)


def test_fbank_pitch_matches_jax():
    wave = np.load(GOLDEN)["speechish_wave"]
    want = np.asarray(jp.fbank_pitch(jnp.asarray(wave)))
    got = tp.fbank_pitch(wave, device="cpu").numpy()
    assert got.shape == want.shape == (98, 26)
    np.testing.assert_array_equal(got[:, -1], want[:, -1])
    np.testing.assert_allclose(got[:, -3:-1], want[:, -3:-1],
                               rtol=PROCESS_TOL, atol=PROCESS_TOL)
    power = mel_power(wave.astype(np.float32), jfeat.FbankOptions())
    mask = power > MEL_FLOOR
    np.testing.assert_allclose(got[:, :23][mask], want[:, :23][mask],
                               rtol=TOL, atol=TOL)


def test_pitch_on_a_host_array_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wave = np.load(GOLDEN)["tone220_wave"]
    for fn in (tp.kaldi_pitch, tp.fbank_pitch, tm.mfcc, tplp.plp):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(wave)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tr.resample(wave, 16000, 8000)
