"""Arbitrary-rate waveform resampling (windowed-sinc; counterpart of
eesen_tpu/frontend/resample.py).

The capability of the reference's LinearResample/ArbitraryResample
(reference: src/feat/resample.{h,cc}): lowpass-filtered sinc interpolation
at an arbitrary output rate, used when corpus sample rates differ from
the recipe's expected rate.

Implemented as a dense gather + weighted sum over a precomputed
(host-side) filter bank, in torch ops on the wave's device: for each
output sample, a fixed-width window of input samples times a per-phase
sinc kernel.  Rational rates share phases, so the kernel bank is
[num_phases, width].
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from eesen_tpu_torch.frontend.features import as_wave


def _sinc_kernel(
    phase_offsets: np.ndarray, width: int, cutoff_ratio: float
) -> np.ndarray:
    """Windowed-sinc filters for fractional offsets. [P, 2*width+1]."""
    taps = np.arange(-width, width + 1, dtype=np.float64)
    out = np.zeros((len(phase_offsets), len(taps)), dtype=np.float64)
    for i, off in enumerate(phase_offsets):
        t = taps - off
        h = np.sinc(t * cutoff_ratio) * cutoff_ratio
        # Hann window over the support
        w = 0.5 * (1 + np.cos(np.pi * t / (width + 1)))
        w[np.abs(t) > width + 1] = 0.0
        h = h * w
        out[i] = h / max(h.sum(), 1e-8)
    return out.astype(np.float32)


def resample(
    wave, in_freq: float, out_freq: float, filter_width: int = 16,
    device="cuda",
):
    """wave [..., N] at in_freq -> [..., M] at out_freq, float32 on the
    wave's device (a host array goes to `device`).  Equal rates return
    the wave as given."""
    if in_freq == out_freq:
        return wave
    wave = as_wave(wave, device)
    frac = Fraction(int(round(out_freq)), int(round(in_freq))).limit_denominator(1000)
    up, down = frac.numerator, frac.denominator
    n = wave.shape[-1]
    m = (n * up) // down
    # output sample j is at input position j * down / up
    pos = np.arange(m, dtype=np.float64) * down / up
    base = np.floor(pos).astype(np.int64)
    phase_idx = (np.arange(m, dtype=np.int64) * down) % up
    phases = np.arange(up, dtype=np.float64) / up  # fractional offsets
    cutoff = min(in_freq, out_freq) / in_freq * 0.95
    kernels = _sinc_kernel(phases, filter_width, cutoff)  # [up, W]

    idx = base[:, None] + np.arange(-filter_width, filter_width + 1)[None, :]
    idx = np.clip(idx, 0, n - 1)
    gathered = wave[..., torch.from_numpy(idx).to(wave.device)]  # [..., M, W]
    k = torch.from_numpy(kernels[phase_idx]).to(wave.device)     # [M, W]
    return torch.sum(gathered * k, dim=-1)
