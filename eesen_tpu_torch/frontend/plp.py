"""PLP features (perceptual linear prediction; counterpart of
eesen_tpu/frontend/plp.py).

Mirrors the reference's PLP computation (reference:
src/feat/feature-plp.{h,cc} Plp::ComputeInternal:160-260;
src/feat/feature-functions.cc GetEqualLoudnessVector:347-359 /
InitIdftBases:360-377 / ComputeLpc:378-390; src/feat/mel-computations.cc
Durbin:262-297 / Lpc2Cepstrum:300-310):

  power spectrum -> mel filterbank -> equal-loudness weighting ->
  cube-root compression -> IDFT to autocorrelation -> Durbin LPC ->
  LPC-to-cepstrum -> liftering, C0 = residual log-energy.

All frames are processed batched in torch ops on the wave's device; the
Durbin recursion is a loop over the (static) LPC order with vectorized
frame math.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from eesen_tpu_torch.frontend.features import (
    TINY, FrameOptions, MelOptions, frame_signal, log_energy, mel_energies,
)
from eesen_tpu_torch.frontend.mfcc import lifter_coeffs


@dataclasses.dataclass(frozen=True)
class PlpOptions:
    frame_opts: FrameOptions = FrameOptions()
    mel_opts: MelOptions = MelOptions(num_bins=23)
    lpc_order: int = 12
    num_ceps: int = 13
    use_energy: bool = True
    energy_floor: float = 0.0
    compress_factor: float = 1.0 / 3.0
    cepstral_lifter: float = 22.0
    cepstral_scale: float = 1.0


def equal_loudness(mel_opts: MelOptions, frame_opts: FrameOptions) -> np.ndarray:
    """Equal-loudness weighting at the mel-bin center frequencies."""
    # recompute center freqs the same way mel_banks does
    nyquist = 0.5 * frame_opts.samp_freq
    high = (
        mel_opts.high_freq if mel_opts.high_freq > 0.0
        else nyquist + mel_opts.high_freq
    )
    mel_low = 1127.0 * np.log(1.0 + mel_opts.low_freq / 700.0)
    mel_high = 1127.0 * np.log(1.0 + high / 700.0)
    delta = (mel_high - mel_low) / (mel_opts.num_bins + 1)
    centers_mel = mel_low + (np.arange(mel_opts.num_bins) + 1) * delta
    f0 = 700.0 * (np.exp(centers_mel / 1127.0) - 1.0)
    fsq = f0 * f0
    fsub = fsq / (fsq + 1.6e5)
    return (fsub * fsub * ((fsq + 1.44e6) / (fsq + 9.61e6))).astype(np.float32)


def idft_bases(n_bases: int, dimension: int) -> np.ndarray:
    angle = math.pi / (dimension - 1)
    scale = 1.0 / (2.0 * (dimension - 1))
    m = np.zeros((n_bases, dimension))
    for i in range(n_bases):
        m[i, 0] = scale
        for j in range(1, dimension - 1):
            m[i, j] = 2.0 * scale * math.cos(angle * i * j)
        m[i, dimension - 1] = scale * math.cos(angle * i * (dimension - 1))
    return m.astype(np.float32)


def _durbin_batch(ac: torch.Tensor, n: int) -> tuple:
    """Vectorized Durbin recursion. ac: [..., n+1] -> (lpc [..., n],
    residual energy [...])."""
    shape = ac.shape[:-1]
    lp = [torch.zeros(shape, dtype=ac.dtype, device=ac.device)
          for _ in range(n)]
    e = ac[..., 0]
    for i in range(n):
        ki = ac[..., i + 1]
        for j in range(i):
            ki = ki + lp[j] * ac[..., i - j]
        ki = ki / e
        c = torch.clamp(1.0 - ki * ki, min=1e-5)
        e = e * c
        new_lp = list(lp)
        new_lp[i] = -ki
        for j in range(i):
            new_lp[j] = lp[j] - ki * lp[i - j - 1]
        lp = new_lp
    return torch.stack(lp, dim=-1), e


def _lpc_to_cepstrum(lpc: torch.Tensor, n: int) -> torch.Tensor:
    """[..., n] LPC -> [..., n] cepstra (Lpc2Cepstrum)."""
    ceps = []
    for i in range(n):
        s = torch.zeros(lpc.shape[:-1], dtype=lpc.dtype, device=lpc.device)
        for j in range(i):
            s = s + (i - j) * lpc[..., j] * ceps[i - j - 1]
        ceps.append(-lpc[..., i] - s / (i + 1))
    return torch.stack(ceps, dim=-1)


def plp(
    wave,
    opts: PlpOptions = PlpOptions(),
    *,
    vtln_warp: float = 1.0,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> torch.Tensor:
    """wave [..., N] -> [..., F, num_ceps]."""
    if opts.num_ceps > opts.lpc_order + 1:
        raise ValueError(
            f"num_ceps {opts.num_ceps} > lpc_order + 1 = {opts.lpc_order + 1}"
        )
    frames = frame_signal(wave, opts.frame_opts, generator=generator,
                          device=device)
    dev = frames.device
    mel_e = mel_energies(frames, opts.mel_opts, opts.frame_opts, vtln_warp)
    mel_e = mel_e * torch.from_numpy(
        equal_loudness(opts.mel_opts, opts.frame_opts)).to(dev)
    mel_e = torch.pow(torch.clamp(mel_e, min=1e-20), opts.compress_factor)
    # duplicate first and last bins
    dup = torch.cat([mel_e[..., :1], mel_e, mel_e[..., -1:]], dim=-1)
    bases = torch.from_numpy(
        idft_bases(opts.lpc_order + 1, opts.mel_opts.num_bins + 2)
    ).to(dev)
    autocorr = torch.matmul(dup, bases.t())
    lpc, resid = _durbin_batch(autocorr, opts.lpc_order)
    c0 = -torch.log(1.0 / torch.clamp(resid, min=TINY))
    raw = _lpc_to_cepstrum(lpc, opts.lpc_order)
    feats = torch.cat([c0[..., None], raw[..., : opts.num_ceps - 1]], dim=-1)
    if opts.cepstral_lifter != 0.0:
        feats = feats * torch.from_numpy(
            lifter_coeffs(opts.cepstral_lifter, opts.num_ceps)
        ).to(dev)
    if opts.cepstral_scale != 1.0:
        feats = feats * opts.cepstral_scale
    if opts.use_energy:
        feats[..., 0] = log_energy(frames, opts.energy_floor)
    return feats
