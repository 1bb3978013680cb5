"""MFCC and spectrogram features (counterpart of
eesen_tpu/frontend/mfcc.py).

Mirrors the reference's MFCC computation (reference:
src/feat/feature-mfcc.{h,cc} — MfccOptions :38-59 defaults
num_ceps=13/use_energy=true/cepstral_lifter=22; DCT matrix from
src/cpucompute/matrix-functions.cc:591-608 ComputeDctMatrix; lifter
coefficients src/feat/mel-computations.cc:248-254) and the spectrogram
features (src/feat/feature-spectrogram.{h,cc}: log power spectrum with
log-energy in column 0).  Torch ops on the wave's device (a host array
goes to `device`, "cuda" unless the caller asks for the CPU); the DCT is
one float32 product.  The frames are computed once, so with dither the
log-mel and the energy see the same noise, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from eesen_tpu_torch.frontend.features import (
    TINY, FbankOptions, FrameOptions, MelOptions, fbank_from_frames,
    frame_signal, log_energy, power_spectrum,
)


@dataclasses.dataclass(frozen=True)
class MfccOptions:
    frame_opts: FrameOptions = FrameOptions()
    mel_opts: MelOptions = MelOptions(num_bins=23)
    num_ceps: int = 13
    use_energy: bool = True
    energy_floor: float = 0.0
    cepstral_lifter: float = 22.0


def dct_matrix(k: int, n: int) -> np.ndarray:
    """Orthogonal DCT-II matrix [K, N] (ComputeDctMatrix)."""
    m = np.zeros((k, n), dtype=np.float64)
    m[0, :] = math.sqrt(1.0 / n)
    for i in range(1, k):
        m[i, :] = math.sqrt(2.0 / n) * np.cos(
            math.pi / n * (np.arange(n) + 0.5) * i
        )
    return m.astype(np.float32)


def lifter_coeffs(q: float, n: int) -> np.ndarray:
    """1 + Q/2 sin(pi i / Q) (ComputeLifterCoeffs)."""
    i = np.arange(n, dtype=np.float64)
    return (1.0 + 0.5 * q * np.sin(math.pi * i / q)).astype(np.float32)


def mfcc(
    wave,
    opts: MfccOptions = MfccOptions(),
    *,
    vtln_warp: float = 1.0,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> torch.Tensor:
    """wave [..., N] -> [..., F, num_ceps]."""
    fb_opts = FbankOptions(
        frame_opts=opts.frame_opts, mel_opts=opts.mel_opts,
        use_energy=False, use_log_fbank=True,
    )
    frames = frame_signal(wave, opts.frame_opts, generator=generator,
                          device=device)
    logmel = fbank_from_frames(frames, fb_opts, vtln_warp)  # [..., F, M]
    dct = torch.from_numpy(
        dct_matrix(opts.num_ceps, opts.mel_opts.num_bins)
    ).to(frames.device)
    feats = torch.matmul(logmel, dct.t())
    if opts.cepstral_lifter != 0.0:
        feats = feats * torch.from_numpy(
            lifter_coeffs(opts.cepstral_lifter, opts.num_ceps)
        ).to(frames.device)
    if opts.use_energy:
        feats[..., 0] = log_energy(frames, opts.energy_floor)
    return feats


@dataclasses.dataclass(frozen=True)
class SpectrogramOptions:
    frame_opts: FrameOptions = FrameOptions()
    energy_floor: float = 0.0
    raw_energy: bool = True


def spectrogram(
    wave,
    opts: SpectrogramOptions = SpectrogramOptions(),
    *,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> torch.Tensor:
    """Log power spectrum with log-energy in column 0
    (src/feat/feature-spectrogram.cc)."""
    frames = frame_signal(wave, opts.frame_opts, generator=generator,
                          device=device)
    ps = power_spectrum(frames)
    logps = torch.log(torch.clamp(ps, min=TINY))
    logps[..., 0] = log_energy(frames, opts.energy_floor)
    return logps
