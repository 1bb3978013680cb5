"""Kaldi-pitch features (NCCF + Viterbi pitch tracking + POV; counterpart
of eesen_tpu/frontend/pitch.py).

Implements the reference's pitch extractor with matching numerics
(reference: src/feat/pitch-functions.{h,cc} — Ghahremani et al. 2014;
src/featbin/compute-kaldi-pitch-feats.cc + process-kaldi-pitch-feats.cc),
held against golden outputs of the reference extractor itself
(tests/data/pitch_golden/golden.npz).

Pipeline (offline, snip-edges semantics):
  1. LinearResample to 4 kHz (Hanning-windowed sinc,
     reference resample.cc:30-131, 244-257);
  2. per-frame NCCF at integer lags [ceil(4k/max_f0 - w) ..
     floor(4k/min_f0 + w)], zero-mean over the first window
     (pitch-functions.cc:101-125 ComputeCorrelation), with the ballast
     denominator sqrt(e1*e2 + (mean_sq * window)^2 * nccf_ballast)
     for the pitch NCCF and sqrt(e1*e2) for the POV NCCF;
  3. resample the NCCF onto geometric log-spaced lags (SelectLags,
     ArbitraryResample with cutoff 2 kHz, width 5);
  4. Viterbi over lag states: local cost 1 - phi*(1 - soft_min_f0*lag)
     (eq. 5) and transition cost (j-i)^2 * log(1+delta_pitch)^2 *
     penalty_factor (ComputeBacktraces, pitch-functions.cc:305-330);
  5. per frame emit (pov_nccf, 1/lag).

Torch ops on the wave's device (a host array goes to `device`, "cuda"
unless the caller asks for the CPU): the NCCF for all frames and lags is
one batched product over `Tensor.unfold` windows, the lag resampling one
[L_in, L_out] product, and the Viterbi a loop over frames (a min and an
argmin over the dense [L, L] cost per frame, `torch.argmin` taking the
first minimum as `jnp.argmin` does), as is its reverse backtrace.  Each
frame is a few launches: about 1000 frames for 10 s of audio.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from eesen_tpu_torch.frontend.features import as_wave


@dataclasses.dataclass(frozen=True)
class PitchOptions:
    """= reference PitchExtractionOptions defaults
    (pitch-functions.h:113-131)."""
    samp_freq: float = 16000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    min_f0: float = 50.0
    max_f0: float = 400.0
    soft_min_f0: float = 10.0
    penalty_factor: float = 0.1
    lowpass_cutoff: float = 1000.0
    resample_freq: float = 4000.0
    delta_pitch: float = 0.005
    nccf_ballast: float = 7000.0
    lowpass_filter_width: int = 1
    upsample_filter_width: int = 5


@dataclasses.dataclass(frozen=True)
class ProcessPitchOptions:
    """= reference ProcessPitchOptions defaults
    (pitch-functions.h:226-245)."""
    pitch_scale: float = 2.0
    pov_scale: float = 2.0
    pov_offset: float = 0.0
    delta_pitch_scale: float = 10.0
    delta_pitch_noise_stddev: float = 0.005
    normalization_left_context: int = 75
    normalization_right_context: int = 75
    delta_window: int = 2


def _filter_func(t: np.ndarray, cutoff: float, num_zeros: int) -> np.ndarray:
    """Hanning-windowed sinc (reference resample.cc:244-257 FilterFunc)."""
    t = np.asarray(t, np.float64)
    half = num_zeros / (2.0 * cutoff)
    window = np.where(
        np.abs(t) < half,
        0.5 * (1.0 + np.cos(2.0 * np.pi * cutoff / num_zeros * t)),
        0.0,
    )
    filt = np.where(
        t != 0.0,
        np.sin(2.0 * np.pi * cutoff * t) / (np.pi * np.where(t == 0, 1, t)),
        2.0 * cutoff,
    )
    return filt * window


def _linear_resample_matrix(
    n_in: int, sr_in: int, sr_out: int, cutoff: float, num_zeros: int,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Weights for LinearResample with flush=True: returns (first_index
    [n_out], weights [n_out_unit, W], n_out).  Output sample i uses input
    range [first_index[i], first_index[i]+W) with weights
    weights[i % out_unit] (the pattern repeats per unit;
    reference resample.cc:102-131 SetIndexesAndWeights)."""
    g = math.gcd(sr_in, sr_out)
    in_unit = sr_in // g
    out_unit = sr_out // g
    width = num_zeros / (2.0 * cutoff)
    # number of output samples (GetNumOutputSamples, flush=True)
    tick_freq = sr_in * sr_out // g
    interval = n_in * (tick_freq // sr_in)
    tpo = tick_freq // sr_out
    last = interval // tpo
    if last * tpo == interval:
        last -= 1
    n_out = max(int(last + 1), 0)

    firsts = np.zeros(out_unit, np.int64)
    rows = []
    for i in range(out_unit):
        t_out = i / sr_out
        min_in = math.ceil((t_out - width) * sr_in)
        max_in = math.floor((t_out + width) * sr_in)
        idx = np.arange(min_in, max_in + 1)
        w = _filter_func(idx / sr_in - t_out, cutoff, num_zeros) / sr_in
        firsts[i] = min_in
        rows.append(w)
    wmax = max(len(r) for r in rows)
    weights = np.zeros((out_unit, wmax), np.float32)
    for i, r in enumerate(rows):
        weights[i, : len(r)] = r
    out_i = np.arange(n_out)
    unit = out_i // out_unit
    wrap = out_i % out_unit
    first_index = firsts[wrap] + unit * in_unit
    return first_index, weights, n_out


def linear_resample(
    wave, sr_in: int, sr_out: int, cutoff: float, num_zeros: int,
    device="cuda",
) -> torch.Tensor:
    """Resample a full waveform [N] (flush semantics; out-of-range samples
    are zero), float32 on the wave's device."""
    wave = as_wave(wave, device)
    dev = wave.device
    n_in = wave.shape[-1]
    first, weights, n_out = _linear_resample_matrix(
        n_in, sr_in, sr_out, cutoff, num_zeros
    )
    w = weights.shape[1]
    out_unit = weights.shape[0]
    idx = first[:, None] + np.arange(w)[None, :]        # [n_out, W]
    valid = torch.from_numpy((idx >= 0) & (idx < n_in)).to(dev)
    idx_safe = torch.from_numpy(np.clip(idx, 0, max(n_in - 1, 0))).to(dev)
    gathered = torch.where(valid, wave[idx_safe], 0.0)  # [n_out, W]
    wmat = torch.from_numpy(weights[np.arange(n_out) % out_unit]).to(dev)
    return torch.sum(gathered * wmat, dim=-1)


def _select_lags(opts: PitchOptions) -> np.ndarray:
    """Geometric lag grid (reference SelectLags)."""
    lags = []
    lag = 1.0 / opts.max_f0
    while lag <= 1.0 / opts.min_f0:
        lags.append(lag)
        lag *= 1.0 + opts.delta_pitch
    return np.asarray(lags, np.float64)


def _lag_resample_matrix(opts: PitchOptions) -> Tuple[int, int, np.ndarray, np.ndarray]:
    """(first_lag, last_lag, lags, M [L_in, L_out]) where M resamples the
    integer-lag NCCF onto the log lag grid (ArbitraryResample semantics,
    resample.cc:259-330)."""
    fs = opts.resample_freq
    half_w = opts.upsample_filter_width / (2.0 * fs)
    first_lag = math.ceil(fs * (1.0 / opts.max_f0 - half_w))
    last_lag = math.floor(fs * (1.0 / opts.min_f0 + half_w))
    n_in = last_lag + 1 - first_lag
    lags = _select_lags(opts)
    offsets = lags - first_lag / fs
    cutoff = fs * 0.5
    m = np.zeros((n_in, len(lags)), np.float32)
    width = opts.upsample_filter_width / (2.0 * cutoff)
    for j, t in enumerate(offsets):
        min_in = max(0, math.ceil((t - width) * fs))
        max_in = min(n_in - 1, math.floor((t + width) * fs))
        idx = np.arange(min_in, max_in + 1)
        m[idx, j] = _filter_func(idx / fs - t, cutoff, opts.upsample_filter_width) / fs
    return first_lag, last_lag, lags, m


def _viterbi(local_cost: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """Best lag-state path [F] (int64) through local_cost [F, L] under the
    transition cost trans [i_cur, j_prev]: a forward loop over frames
    (renormalized each frame), then the backtrace, both on the device."""
    fwd = local_cost[0] - torch.min(local_cost[0])
    bps = []
    for t in range(1, local_cost.shape[0]):
        cand = trans + fwd[None, :]                      # [i, j]
        bp = torch.argmin(cand, dim=1)
        new = cand.gather(1, bp[:, None])[:, 0] + local_cost[t]
        fwd = new - torch.min(new)
        bps.append(bp)
    state = torch.argmin(fwd).view(1)
    states = [state]
    for bp in reversed(bps):
        state = bp.index_select(0, state)
        states.append(state)
    return torch.cat(states[::-1])


def kaldi_pitch(
    wave, opts: PitchOptions = PitchOptions(), device="cuda",
) -> torch.Tensor:
    """[N] samples -> [F, 2] (nccf_pov, pitch_hz), matching the reference's
    compute-kaldi-pitch-feats (offline, snip-edges); float32 on the wave's
    device (a host array goes to `device`)."""
    fs = opts.resample_freq
    down = linear_resample(
        wave, int(opts.samp_freq), int(fs),
        opts.lowpass_cutoff, opts.lowpass_filter_width, device=device,
    )
    dev = down.device
    n = down.shape[-1]
    shift = int(round(fs * 0.001 * opts.frame_shift_ms))
    win = int(round(fs * 0.001 * opts.frame_length_ms))
    first_lag, last_lag, lags, lagmat = _lag_resample_matrix(opts)
    full = win + last_lag
    num_frames = max(int((n - win) // shift) + 1, 0)
    if num_frames == 0:
        return torch.zeros((0, 2), dtype=torch.float32, device=dev)

    # ballast from the whole-signal mean square (offline semantics:
    # pitch-functions.cc:1021-1026 + RecomputeBacktraces no-op)
    mean = torch.sum(down) / n
    mean_sq = torch.sum(down * down) / n - mean * mean
    ballast = torch.square(mean_sq * win) * opts.nccf_ballast

    starts = np.arange(num_frames) * shift
    pos = starts[:, None] + np.arange(full)[None, :]     # [F, full]
    valid = torch.from_numpy(pos < n).to(dev)
    frames = torch.where(
        valid, down[torch.from_numpy(np.minimum(pos, n - 1)).to(dev)], 0.0
    )                                                    # [F, full]
    # zero-mean using the FIRST `win` samples (ComputeCorrelation:107-110)
    fmean = torch.mean(frames[:, :win], dim=-1, keepdim=True)
    zf = frames - fmean
    base = zf[:, :win]                                   # [F, win]
    e1 = torch.sum(base * base, dim=-1)                  # [F]
    # all shifted windows, lags first_lag..last_lag: [F, n_lags, win]
    shifted = zf[:, first_lag:].unfold(-1, win, 1)
    e2 = torch.sum(shifted * shifted, dim=-1)            # [F, L]
    inner = torch.matmul(shifted, base[:, :, None])[..., 0]   # [F, L]
    norm = e1[:, None] * e2
    denom_pitch = torch.sqrt(norm + ballast)
    denom_pov = torch.sqrt(norm)
    nccf_pitch = torch.where(denom_pitch != 0.0, inner / denom_pitch, 0.0)
    nccf_pov = torch.where(denom_pov != 0.0, inner / denom_pov, 0.0)

    # resample onto the log lag grid: one product each
    lm = torch.from_numpy(lagmat).to(dev)
    nccf_pitch_r = nccf_pitch @ lm                       # [F, L']
    nccf_pov_r = nccf_pov @ lm

    # Viterbi over lag states
    lags_f = torch.from_numpy(lags.astype(np.float32)).to(dev)
    local_cost = (
        1.0 - nccf_pitch_r * (1.0 - opts.soft_min_f0 * lags_f[None, :])
    )                                                    # [F, L']
    num_states = len(lags)
    factor = (math.log(1.0 + opts.delta_pitch) ** 2) * opts.penalty_factor
    ij = np.arange(num_states)
    trans = torch.from_numpy(
        ((ij[None, :] - ij[:, None]).astype(np.float64) ** 2 * factor)
        .astype(np.float32)
    ).to(dev)                                            # [i_cur, j_prev]
    states = _viterbi(local_cost, trans)                 # [F]

    pov = nccf_pov_r.gather(1, states[:, None])[:, 0]
    pitch = 1.0 / lags_f[states]
    return torch.stack([pov, pitch], dim=-1)


def _nccf_to_pov_feature(n: torch.Tensor) -> torch.Tensor:
    """pitch-functions.cc:42-51 NccfToPovFeature."""
    n = torch.clamp(n, -1.0, 1.0)
    return torch.pow(1.0001 - n, 0.15) - 1.0


def _nccf_to_pov(n: torch.Tensor) -> torch.Tensor:
    """pitch-functions.cc:76-86 NccfToPov (probability of voicing)."""
    nd = torch.clamp(torch.abs(n), 0.0, 1.0)
    r = (
        -5.2 + 5.4 * torch.exp(7.5 * (nd - 1.0)) + 4.8 * nd
        - 2.0 * torch.exp(-10.0 * nd) + 4.2 * torch.exp(20.0 * (nd - 1.0))
    )
    return 1.0 / (1.0 + torch.exp(-r))


def _compute_deltas_1d(x: torch.Tensor, window: int) -> torch.Tensor:
    """Kaldi ComputeDeltas order-1 on a [T] series (feature-functions.cc
    DeltaFeatures): scales j/-window..window/ = j / (2*sum(j^2)), edges
    clamped."""
    t = x.shape[0]
    norm = 2.0 * sum(j * j for j in range(1, window + 1))
    out = torch.zeros_like(x)
    idx = torch.arange(t, device=x.device)
    for j in range(1, window + 1):
        plus = x[torch.clamp(idx + j, 0, t - 1)]
        minus = x[torch.clamp(idx - j, 0, t - 1)]
        out = out + (j / norm) * (plus - minus)
    return out


def process_pitch(
    raw,
    opts: ProcessPitchOptions = ProcessPitchOptions(),
    rng: np.random.Generator | None = None,
    device="cuda",
) -> torch.Tensor:
    """[F, 2] (nccf, pitch) -> [F, 3] (pov-feature, normalized-log-pitch,
    delta-log-pitch); reference OnlineProcessPitch with default output
    columns (pitch-functions.cc:1360-1460).  The delta noise comes from
    `rng` (a numpy Generator; default_rng(0) when None), as in the JAX
    package."""
    raw = as_wave(raw, device)
    dev = raw.device
    nccf = raw[:, 0]
    pitch = raw[:, 1]
    log_pitch = torch.log(pitch)
    t = raw.shape[0]

    pov_feat = opts.pov_scale * _nccf_to_pov_feature(nccf) + opts.pov_offset

    # POV-weighted sliding-window mean of log pitch
    pov = _nccf_to_pov(nccf)
    zero = torch.zeros(1, dtype=torch.float32, device=dev)
    cs_pov = torch.cat([zero, torch.cumsum(pov, dim=0)])
    cs_plp = torch.cat([zero, torch.cumsum(pov * log_pitch, dim=0)])
    idx = np.arange(t)
    begin = torch.from_numpy(
        np.maximum(0, idx - opts.normalization_left_context)).to(dev)
    end = torch.from_numpy(
        np.minimum(t, idx + opts.normalization_right_context + 1)).to(dev)
    sum_pov = cs_pov[end] - cs_pov[begin]
    sum_plp = cs_plp[end] - cs_plp[begin]
    norm_log_pitch = (log_pitch - sum_plp / sum_pov) * opts.pitch_scale

    delta = _compute_deltas_1d(log_pitch, opts.delta_window)
    if opts.delta_pitch_noise_stddev > 0.0:
        rng = rng or np.random.default_rng(0)
        delta = delta + torch.from_numpy(
            rng.standard_normal(t).astype(np.float32)
            * opts.delta_pitch_noise_stddev
        ).to(dev)
    delta_feat = delta * opts.delta_pitch_scale
    return torch.stack([pov_feat, norm_log_pitch, delta_feat], dim=-1)


def fbank_pitch(
    wave,
    fbank_opts=None,
    pitch_opts: PitchOptions = PitchOptions(),
    process_opts: ProcessPitchOptions = ProcessPitchOptions(),
    device="cuda",
) -> torch.Tensor:
    """fbank ++ 3-dim pitch, the hkust/swbd front-end
    (reference: asr_egs/hkust/v1/run_ctc_char.sh fbank+pitch configs,
    steps/make_fbank_pitch.sh)."""
    from eesen_tpu_torch.frontend.features import FbankOptions, fbank

    fbank_opts = fbank_opts or FbankOptions()
    wave = as_wave(wave, device)
    fb = fbank(wave, fbank_opts)
    raw = kaldi_pitch(wave, pitch_opts)
    pp = process_pitch(raw, process_opts)
    t = min(fb.shape[0], pp.shape[0])
    return torch.cat([fb[:t], pp[:t]], dim=-1)
