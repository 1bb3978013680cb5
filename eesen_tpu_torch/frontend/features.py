"""Feature frontend: fbank/spectrogram + CMVN + deltas/splice/subsample
(counterpart of eesen_tpu/frontend/features.py).

Re-implements the semantics of the reference feature pipeline
(reference: src/feat/feature-functions.{h,cc} FrameExtractionOptions
:73-148 / ExtractWindow :91-163 / ComputePowerSpectrum :173 /
DeltaFeatures :192+ / SpliceFrames; src/feat/mel-computations.cc MelBanks;
src/feat/feature-fbank.cc Fbank::ComputeInternal; src/feat/cmvn.cc)
in batched torch ops on the wave's device:

- The whole utterance (or batch of utterances) is framed with one
  `Tensor.unfold` and pushed through `torch.fft.rfft` and a single
  [F, N_fft] x [N_fft, n_mels] float32 product (TF32 stays off: the
  package's __init__ switches it off).
- Mel filterbank weights, window functions, and delta filters are computed
  once host-side in numpy (they are tiny constants), as in the JAX package.
- Defaults match Kaldi: 25ms/10ms povey window, preemphasis 0.97,
  remove_dc_offset, round-to-power-of-two FFT, snip_edges, dither 1.0.
  Dither draws from a `torch.Generator` on the wave's device (the JAX
  package draws from a PRNG key: same distribution, different stream);
  without a generator no dither is added, as without a key in JAX.

The recipes' 40-dim fbank + Δ + ΔΔ = 120-dim input
(asr_egs/wsj/conf/fbank.conf --num-mel-bins=40,
 steps/train_ctc_parallel.sh:95-111) is `fbank` + `compute_deltas`.

Device rule (the JAX package's `_xp`): the wave functions (`frame_signal`,
`fbank`) take a tensor and compute on its device, or a host array, which
they move to `device` ("cuda" unless the caller asks for "cpu"); the
post-processing functions (deltas, splice, subsample, CMVN) keep a numpy
array on the host in numpy and a tensor in torch on its own device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from eesen_tpu_torch.models.model import check_device

TINY = float(np.finfo(np.float32).tiny)


# --------------------------------------------------------------------------
# options
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FrameOptions:
    """reference: src/feat/feature-functions.h:73-148."""
    samp_freq: float = 16000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    dither: float = 1.0
    preemph_coeff: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = "povey"     # povey | hamming | hanning | rectangular
    round_to_power_of_two: bool = True
    snip_edges: bool = True

    @property
    def window_shift(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_shift_ms)

    @property
    def window_size(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_length_ms)

    @property
    def padded_window_size(self) -> int:
        if self.round_to_power_of_two:
            return 1 << (self.window_size - 1).bit_length()
        return self.window_size


@dataclasses.dataclass(frozen=True)
class MelOptions:
    """reference: src/feat/mel-computations.h MelBanksOptions."""
    num_bins: int = 23             # recipes use 40 (conf/fbank.conf)
    low_freq: float = 20.0
    high_freq: float = 0.0         # <= 0: offset from Nyquist
    vtln_low: float = 100.0
    vtln_high: float = -500.0


@dataclasses.dataclass(frozen=True)
class FbankOptions:
    frame_opts: FrameOptions = FrameOptions()
    mel_opts: MelOptions = MelOptions()
    use_energy: bool = False
    energy_floor: float = 0.0
    raw_energy: bool = True
    use_log_fbank: bool = True


# --------------------------------------------------------------------------
# host-side constant builders (numpy)
# --------------------------------------------------------------------------

def feature_window(opts: FrameOptions) -> np.ndarray:
    """Window function (reference: feature-functions.cc
    FeatureWindowFunction)."""
    n = opts.window_size
    i = np.arange(n, dtype=np.float64)
    a = 2 * np.pi * i / (n - 1)
    if opts.window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(a)
    elif opts.window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(a)
    elif opts.window_type == "povey":
        w = (0.5 - 0.5 * np.cos(a)) ** 0.85
    elif opts.window_type == "rectangular":
        w = np.ones(n)
    else:
        raise ValueError(f"invalid window type {opts.window_type}")
    return w.astype(np.float32)


def povey_window(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    return ((0.5 - 0.5 * np.cos(2 * np.pi * i / (n - 1))) ** 0.85).astype(
        np.float32
    )


def _mel_scale(f):
    return 1127.0 * np.log(1.0 + f / 700.0)


def _inverse_mel_scale(m):
    return 700.0 * (np.exp(m / 1127.0) - 1.0)


def _vtln_warp_freq(
    vtln_low: float, vtln_high: float, low_freq: float, high_freq: float,
    warp: float, freq: np.ndarray,
) -> np.ndarray:
    """Piecewise-linear VTLN warp (reference: mel-computations.cc
    VtlnWarpFreq)."""
    l = vtln_low * max(1.0, warp)
    h = vtln_high * min(1.0, warp)
    scale = 1.0 / warp
    fl, fh = scale * l, scale * h
    scale_left = (fl - low_freq) / (l - low_freq)
    scale_right = (high_freq - fh) / (high_freq - h)
    out = np.where(
        freq < l,
        low_freq + scale_left * (freq - low_freq),
        np.where(freq < h, scale * freq, high_freq + scale_right * (freq - high_freq)),
    )
    return np.where((freq < low_freq) | (freq > high_freq), freq, out)


def _vtln_warp_mel(vtln_low, vtln_high, low_freq, high_freq, warp, mel):
    return _mel_scale(
        _vtln_warp_freq(
            vtln_low, vtln_high, low_freq, high_freq, warp,
            _inverse_mel_scale(mel),
        )
    )


def mel_banks(
    mel_opts: MelOptions,
    frame_opts: FrameOptions,
    vtln_warp: float = 1.0,
) -> np.ndarray:
    """Triangular mel filterbank matrix [num_bins, n_fft//2 + 1].

    reference: src/feat/mel-computations.cc MelBanks::MelBanks — identical
    bin placement (divide by num_bins+1, per-FFT-bin mel weights), with the
    Nyquist bin zero (the reference's bins never cover it either).
    """
    num_bins = mel_opts.num_bins
    nfft = frame_opts.padded_window_size
    num_fft_bins = nfft // 2
    nyquist = 0.5 * frame_opts.samp_freq
    low_freq = mel_opts.low_freq
    high_freq = (
        mel_opts.high_freq if mel_opts.high_freq > 0.0
        else nyquist + mel_opts.high_freq
    )
    vtln_high = mel_opts.vtln_high
    if vtln_high < 0.0:
        vtln_high += nyquist

    fft_bin_width = frame_opts.samp_freq / nfft
    mel_low = _mel_scale(low_freq)
    mel_high = _mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    freqs = fft_bin_width * np.arange(num_fft_bins, dtype=np.float64)
    mels = _mel_scale(freqs)  # [num_fft_bins]

    bins = np.zeros((num_bins, num_fft_bins + 1), dtype=np.float32)
    for b in range(num_bins):
        left = mel_low + b * mel_delta
        center = mel_low + (b + 1) * mel_delta
        right = mel_low + (b + 2) * mel_delta
        if vtln_warp != 1.0:
            left = _vtln_warp_mel(
                mel_opts.vtln_low, vtln_high, low_freq, high_freq, vtln_warp,
                np.float64(left))
            center = _vtln_warp_mel(
                mel_opts.vtln_low, vtln_high, low_freq, high_freq, vtln_warp,
                np.float64(center))
            right = _vtln_warp_mel(
                mel_opts.vtln_low, vtln_high, low_freq, high_freq, vtln_warp,
                np.float64(right))
        up = (mels - left) / (center - left)
        down = (right - mels) / (right - center)
        w = np.where(mels <= center, up, down)
        w = np.where((mels > left) & (mels < right), w, 0.0)
        bins[b, :num_fft_bins] = w
    return bins


def delta_filters(order: int = 2, window: int = 2) -> list:
    """Delta regression filters (reference: feature-functions.cc
    DeltaFeatures::DeltaFeatures). Returns [order+1] numpy 1-D kernels."""
    scales = [np.array([1.0], dtype=np.float64)]
    for _ in range(order):
        prev = scales[-1]
        prev_offset = (len(prev) - 1) // 2
        cur = np.zeros(len(prev) + 2 * window, dtype=np.float64)
        cur_offset = prev_offset + window
        normalizer = 0.0
        for j in range(-window, window + 1):
            normalizer += j * j
            for k in range(-prev_offset, prev_offset + 1):
                cur[j + k + cur_offset] += j * prev[k + prev_offset]
        scales.append(cur / normalizer)
    return [s.astype(np.float32) for s in scales]


# --------------------------------------------------------------------------
# feature computation on the device
# --------------------------------------------------------------------------

def as_wave(wave, device="cuda") -> torch.Tensor:
    """A wave as a float32 tensor: a tensor stays on its device, a host
    array is copied to `device` ("cuda" unless the caller asks for the
    CPU)."""
    if torch.is_tensor(wave):
        return wave.to(torch.float32)
    return torch.tensor(np.asarray(wave, dtype=np.float32),
                        device=check_device(device))


def num_frames(wave_len: int, opts: FrameOptions) -> int:
    """Frame count for snip_edges framing (reference:
    feature-functions.cc NumFrames)."""
    ws, shift = opts.window_size, opts.window_shift
    if opts.snip_edges:
        if wave_len < ws:
            return 0
        return 1 + (wave_len - ws) // shift
    return (wave_len + shift // 2) // shift


def frame_signal(
    wave,
    opts: FrameOptions,
    *,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> torch.Tensor:
    """wave [..., N] -> windowed, padded frames [..., F, n_fft] float32 on
    the wave's device.

    Applies, in the reference's order (feature-functions.cc:148-163):
    dither (when opts.dither != 0 and a generator on the wave's device is
    given) -> remove DC offset -> preemphasis -> window function, then
    zero-pads to the power-of-two FFT size.  With snip_edges=False the
    last frames read past the end: those samples repeat the last one (the
    JAX package's clamped gather)."""
    wave = as_wave(wave, device)
    ws, shift = opts.window_size, opts.window_shift
    nfft = opts.padded_window_size
    n = wave.shape[-1]
    f = num_frames(n, opts)
    if f <= 0:
        raise ValueError(f"waveform too short: {n} < {ws}")
    need = (f - 1) * shift + ws
    if need > n:
        wave = torch.cat(
            [wave, wave[..., -1:].expand(*wave.shape[:-1], need - n)], dim=-1
        )
    frames = wave.unfold(-1, ws, shift)[..., :f, :]      # [..., F, ws]

    if opts.dither != 0.0 and generator is not None:
        frames = frames + opts.dither * torch.randn(
            frames.shape, generator=generator, dtype=frames.dtype,
            device=frames.device,
        )
    if opts.remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if opts.preemph_coeff != 0.0:
        c = opts.preemph_coeff
        prev = torch.cat(
            [frames[..., :1], frames[..., :-1]], dim=-1
        )  # x[-1] := x[0] (reference Preemphasize edge rule)
        frames = frames - c * prev
    win = torch.from_numpy(feature_window(opts)).to(frames.device)
    frames = frames * win
    return F.pad(frames, (0, nfft - ws))


def power_spectrum(frames: torch.Tensor) -> torch.Tensor:
    """[..., n_fft] real frames -> [..., n_fft//2+1] power spectrum."""
    spec = torch.fft.rfft(frames.to(torch.float32), dim=-1)
    return torch.square(spec.real) + torch.square(spec.imag)


def log_energy(frames: torch.Tensor, energy_floor: float) -> torch.Tensor:
    """Log energy of processed frames, floored at `energy_floor` (> 0)."""
    energy = torch.log(torch.clamp(
        torch.sum(torch.square(frames), dim=-1), min=TINY))
    if energy_floor > 0.0:
        energy = torch.clamp(energy, min=math.log(energy_floor))
    return energy


def mel_energies(
    frames: torch.Tensor, mel_opts: MelOptions, frame_opts: FrameOptions,
    vtln_warp: float = 1.0,
) -> torch.Tensor:
    """Processed frames [..., F, n_fft] -> mel energies [..., F, num_bins]:
    the power spectrum times the filterbank, one float32 product."""
    ps = power_spectrum(frames)
    mel = torch.from_numpy(mel_banks(mel_opts, frame_opts, vtln_warp))
    return torch.matmul(ps, mel.to(ps.device).t())


def fbank_from_frames(
    frames: torch.Tensor, opts: FbankOptions, vtln_warp: float = 1.0,
) -> torch.Tensor:
    feats = mel_energies(frames, opts.mel_opts, opts.frame_opts, vtln_warp)
    if opts.use_log_fbank:
        feats = torch.log(torch.clamp(feats, min=TINY))
    if opts.use_energy:
        # energy after windowing (raw_energy would require the pre-window
        # signal; computed from the processed frames as in !raw_energy mode)
        energy = log_energy(frames, opts.energy_floor)
        feats = torch.cat([energy[..., None], feats], dim=-1)
    return feats


def fbank(
    wave,
    opts: FbankOptions = FbankOptions(),
    *,
    vtln_warp: float = 1.0,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> torch.Tensor:
    """wave [..., N] (float, Kaldi convention: int16 range) -> log-mel
    features [..., F, num_bins(+1 energy)] float32, on the wave's device
    (a host array goes to `device`).  `generator` (on that device) draws
    the dither."""
    frames = frame_signal(wave, opts.frame_opts, generator=generator,
                          device=device)
    return fbank_from_frames(frames, opts, vtln_warp)


def _index(feats, src: np.ndarray):
    """feats[..., src, :] for a numpy index, in the array's own library."""
    if torch.is_tensor(feats):
        return feats[..., torch.from_numpy(src).to(feats.device), :]
    return feats[..., src, :]


def _zeros_like(feats):
    return torch.zeros_like(feats) if torch.is_tensor(feats) else (
        np.zeros_like(feats))


def _cat(parts):
    if torch.is_tensor(parts[0]):
        return torch.cat(parts, dim=-1)
    return np.concatenate(parts, axis=-1)


def compute_deltas(feats, order: int = 2, window: int = 2):
    """[..., T, D] -> [..., T, D*(order+1)]; edge frames replicated
    (reference: feature-functions.cc DeltaFeatures::Process)."""
    filters = delta_filters(order, window)
    outs = [feats]
    t = feats.shape[-2]
    for k in range(1, order + 1):
        kern = filters[k]
        off = (len(kern) - 1) // 2
        acc = _zeros_like(feats)
        for j in range(-off, off + 1):
            scale = float(kern[j + off])
            if scale == 0.0:
                continue
            src = np.clip(np.arange(t) + j, 0, t - 1)
            acc = acc + scale * _index(feats, src)
        outs.append(acc)
    return _cat(outs)


def compute_shifted_deltas(
    feats, window: int = 1, num_blocks: int = 7, block_shift: int = 3
):
    """Shifted delta cepstra: [..., T, D] -> [..., T, D*(num_blocks+1)].

    Output frame = [x(t), d(t), d(t+P), d(t+2P), ...] where d is the
    first-order delta with the given half-window and P = block_shift;
    out-of-range source frames are clamped to the edges (reference:
    src/feat/feature-functions.cc:269-314 ShiftedDeltaFeatures /
    ComputeShiftedDeltas; a language-ID feature, off the CTC recipe path).
    """
    # First-order delta scale window: j / sum(j^2), j in [-window, window].
    normalizer = float(sum(j * j for j in range(-window, window + 1)))
    t = feats.shape[-2]
    outs = [feats]
    for i in range(num_blocks):
        acc = _zeros_like(feats)
        for j in range(-window, window + 1):
            scale = j / normalizer
            if scale == 0.0:
                continue
            src = np.clip(np.arange(t) + j + i * block_shift, 0, t - 1)
            acc = acc + scale * _index(feats, src)
        outs.append(acc)
    return _cat(outs)


def splice_frames(feats, left: int, right: int):
    """[..., T, D] -> [..., T, D*(left+1+right)], edges replicated
    (reference: feature-functions.cc SpliceFrames)."""
    t = feats.shape[-2]
    outs = []
    for j in range(-left, right + 1):
        src = np.clip(np.arange(t) + j, 0, t - 1)
        outs.append(_index(feats, src))
    return _cat(outs)


def subsample_frames(feats, n: int, offset: int = 0):
    """Every n-th frame starting at `offset` (reference:
    src/featbin/subsample-feats.cc — the 30ms frame-rate trick)."""
    return feats[..., offset::n, :]


# --------------------------------------------------------------------------
# CMVN (reference: src/feat/cmvn.{h,cc})
# --------------------------------------------------------------------------

def cmvn_stats(feats, weights=None):
    """Accumulate stats [2, D+1]: row 0 = sum + count, row 1 = sumsq + 0."""
    if torch.is_tensor(feats):
        dims = tuple(range(feats.ndim - 1))
        if weights is None:
            s = feats.sum(dim=dims)
            sq = torch.square(feats).sum(dim=dims)
            count = torch.tensor(float(np.prod(feats.shape[:-1])),
                                 dtype=feats.dtype, device=feats.device)
        else:
            w = weights[..., None]
            s = (feats * w).sum(dim=dims)
            sq = (torch.square(feats) * w).sum(dim=dims)
            count = weights.sum().to(feats.dtype)
        top = torch.cat([s, count[None]])
        bot = torch.cat([sq, torch.zeros((1,), dtype=feats.dtype,
                                         device=feats.device)])
        return torch.stack([top, bot])
    xp = np
    if weights is None:
        s = xp.sum(feats, axis=tuple(range(feats.ndim - 1)))
        sq = xp.sum(xp.square(feats), axis=tuple(range(feats.ndim - 1)))
        count = xp.asarray(
            np.prod(feats.shape[:-1]), dtype=feats.dtype
        )
    else:
        w = weights[..., None]
        s = xp.sum(feats * w, axis=tuple(range(feats.ndim - 1)))
        sq = xp.sum(xp.square(feats) * w, axis=tuple(range(feats.ndim - 1)))
        count = xp.sum(weights)
    top = xp.concatenate([s, count[None]])
    bot = xp.concatenate([sq, xp.zeros((1,), feats.dtype)])
    return xp.stack([top, bot])


def apply_cmvn(feats, stats, norm_vars: bool = True):
    """Apply mean (and optionally variance) normalization
    (reference: src/feat/cmvn.cc ApplyCmvn; var floor 1e-20)."""
    if torch.is_tensor(feats) or torch.is_tensor(stats):
        feats = torch.as_tensor(feats)
        stats = torch.as_tensor(stats, device=feats.device)
        dim = stats.shape[-1] - 1
        count = stats[0, dim]
        mean = stats[0, :dim] / count
        if norm_vars:
            var = stats[1, :dim] / count - torch.square(mean)
            scale = torch.rsqrt(torch.clamp(var, min=1e-20))
        else:
            scale = torch.ones_like(mean)
        return (feats - mean) * scale
    dim = stats.shape[-1] - 1
    count = stats[0, dim]
    mean = stats[0, :dim] / count
    if norm_vars:
        var = stats[1, :dim] / count - np.square(mean)
        scale = 1.0 / np.sqrt(np.maximum(var, 1e-20))
    else:
        scale = np.ones_like(mean)
    return (feats - mean) * scale
