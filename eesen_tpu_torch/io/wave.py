"""RIFF wave reading (reference: src/feat/wave-reader.{h,cc}).

Returns float32 samples in Kaldi's convention (int16 range, NOT normalized
to ±1), so features computed from them match the reference bit-for-bit in
distribution.  Supports plain PCM16/PCM8/PCM32 mono or multi-channel, and
piped commands ("sph2pipe ... |") as used in wav.scp entries.
"""

from __future__ import annotations

import io
import struct
import subprocess
from typing import Tuple

import numpy as np


def read_wav(path_or_cmd: str) -> Tuple[np.ndarray, int]:
    """Read a wav file or 'command |' pipe.

    Returns (samples [channels, n] float32 in int16 range, sample_rate)."""
    if path_or_cmd.strip().endswith("|"):
        data = subprocess.run(
            path_or_cmd.strip()[:-1], shell=True, stdout=subprocess.PIPE,
            check=True,
        ).stdout
        return parse_wav_bytes(data)
    with open(path_or_cmd, "rb") as f:
        return parse_wav_bytes(f.read())


def parse_wav_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    samples = None
    rate = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        chunk_size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            (audio_format, channels, rate, _brate, _balign, bits) = (
                struct.unpack("<HHIIHH", body[:16])
            )
            fmt = (audio_format, channels, bits)
        elif chunk_id == b"data":
            samples = body
            # trust the fmt chunk; some writers lie about data size (the
            # reference tolerates streamed/piped wavs with size 0)
            if chunk_size == 0 or chunk_size > len(body):
                samples = data[pos + 8 :]
        pos += 8 + chunk_size + (chunk_size & 1)
        if fmt is not None and samples is not None:
            break
    if fmt is None or samples is None or rate is None:
        raise ValueError("missing fmt/data chunk")
    audio_format, channels, bits = fmt
    if audio_format not in (1, 0xFFFE):  # PCM
        raise ValueError(f"unsupported wav format {audio_format}")
    if bits == 16:
        arr = np.frombuffer(samples, dtype="<i2").astype(np.float32)
    elif bits == 8:
        arr = (
            np.frombuffer(samples, dtype=np.uint8).astype(np.float32) - 128.0
        ) * 256.0
    elif bits == 32:
        arr = np.frombuffer(samples, dtype="<i4").astype(np.float32) / 65536.0
    else:
        raise ValueError(f"unsupported bit depth {bits}")
    n = (len(arr) // channels) * channels
    arr = arr[:n].reshape(-1, channels).T
    return np.ascontiguousarray(arr), int(rate)
