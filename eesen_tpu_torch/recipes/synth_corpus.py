"""Synthetic speech-like corpus generation for full-pipeline validation.

No LDC/OpenSLR corpora are distributable with this repository, so recipe
validation at scale uses a parametric formant synthesizer: each phone is
a stationary formant stack (voiced: harmonic-rich glottal source shaped
by 3 formant resonance weights; unvoiced: band-shaped noise), with
per-speaker vocal-tract scaling and f0, phone-boundary crossfades
(coarticulation), amplitude envelopes, f0 declination, and additive
noise.  The corpus exercises exactly the code paths a real corpus does —
wav IO, fbank/CMVN/deltas, CTC training, TLG decoding, scoring — with a
controllable difficulty knob (SNR, speaker spread, speaking-rate jitter).

This mirrors the role of the reference's smoke-test corpora; WERs on it
are NOT comparable to published WSJ/LibriSpeech numbers (see RESULTS.md).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

SR = 16000


@dataclasses.dataclass(frozen=True)
class SynthConfig:
    num_phones: int = 40
    num_words: int = 500
    num_speakers: int = 20
    min_word_phones: int = 2
    max_word_phones: int = 6
    min_utt_words: int = 4
    max_utt_words: int = 10
    phone_dur_ms: Tuple[int, int] = (60, 140)
    crossfade_ms: int = 20
    snr_db: float = 20.0
    seed: int = 0
    # --- difficulty levers (stress-v2: drive the ACOUSTIC MODEL below
    # ~95% token accuracy, not just the decoder) ---
    # >0: phones are drawn from this many base formant templates with
    # small perturbations, so ~num_phones/confusable_groups phones share
    # nearly identical spectra (vowel-space crowding)
    confusable_groups: int = 0
    # per-utterance random channel: spectral tilt + band-limiting
    # (telephone-ish), applied after synthesis
    channel_sim: bool = False
    # speaker speaking-rate range (1.0 = nominal)
    rate_range: Tuple[float, float] = (0.85, 1.2)


def make_phones(cfg: SynthConfig, rng: np.random.Generator):
    """Per-phone spectral recipes: (voiced, formants[3], bandwidth-ish
    weights). A quarter of the phones are unvoiced 'fricatives'.

    With cfg.confusable_groups > 0, phones share base templates: group
    members differ only by a small formant jitter (±3%) and weight
    jitter, so the acoustic model faces genuinely overlapping classes
    (the stress-v2 knob that pushes token accuracy down)."""
    if cfg.confusable_groups > 0:
        bases = []
        for _ in range(cfg.confusable_groups):
            f1 = rng.uniform(250, 850)
            f2 = rng.uniform(max(900, f1 + 300), 2400)
            f3 = rng.uniform(max(2500, f2 + 400), 3400)
            bases.append((np.array([f1, f2, f3]),
                          rng.uniform(0.4, 1.0, size=3)))
        phones = []
        for i in range(cfg.num_phones):
            bf, bw = bases[i % cfg.confusable_groups]
            voiced = i % 4 != 3
            f = bf * rng.uniform(0.97, 1.03, size=3)
            w = np.clip(bw * rng.uniform(0.85, 1.15, size=3), 0.2, 1.2)
            phones.append((voiced, f, w))
        return phones
    phones = []
    for i in range(cfg.num_phones):
        voiced = i % 4 != 3
        f1 = rng.uniform(250, 850)
        f2 = rng.uniform(max(900, f1 + 300), 2400)
        f3 = rng.uniform(max(2500, f2 + 400), 3400)
        w = rng.uniform(0.4, 1.0, size=3)
        phones.append((voiced, np.array([f1, f2, f3]), w))
    return phones


def make_lexicon(
    cfg: SynthConfig, rng: np.random.Generator
) -> List[Tuple[str, Tuple[str, ...]]]:
    units = [f"p{i:02d}" for i in range(cfg.num_phones)]
    seen = set()
    lex = []
    while len(lex) < cfg.num_words:
        n = int(rng.integers(cfg.min_word_phones, cfg.max_word_phones + 1))
        pron = tuple(units[int(j)] for j in rng.integers(0, cfg.num_phones, n))
        if pron in seen:
            continue
        seen.add(pron)
        lex.append((f"w{len(lex):04d}", pron))
    return lex


def _speaker(rng: np.random.Generator, cfg: SynthConfig = None):
    lo, hi = cfg.rate_range if cfg is not None else (0.85, 1.2)
    return {
        "formant_scale": float(rng.uniform(0.88, 1.15)),
        "f0": float(rng.uniform(110, 260)),
        "rate": float(rng.uniform(lo, hi)),
    }


def _apply_channel(wave: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Per-utterance channel simulation: random spectral tilt (±6 dB/kHz)
    plus a random band-limit (low cut 100-350 Hz, high cut 2.8-7 kHz) —
    the telephone/far-field mismatch a real corpus carries."""
    n = len(wave)
    spec = np.fft.rfft(wave)
    freqs = np.fft.rfftfreq(n, 1.0 / SR)
    tilt_db_per_khz = rng.uniform(-6.0, 6.0)
    gain = 10.0 ** (tilt_db_per_khz * (freqs / 1000.0) / 20.0)
    lo = rng.uniform(100.0, 350.0)
    hi = rng.uniform(2800.0, 7000.0)
    gain *= 1.0 / (1.0 + (lo / np.maximum(freqs, 1.0)) ** 4)
    gain *= 1.0 / (1.0 + (freqs / hi) ** 6)
    out = np.fft.irfft(spec * gain, n)
    peak = np.abs(out).max() + 1e-9
    return (out / peak * np.abs(wave).max()).astype(wave.dtype)


def synth_phone(
    phone, dur_samps: int, f0: float, formant_scale: float,
    rng: np.random.Generator,
) -> np.ndarray:
    voiced, formants, weights = phone
    t = np.arange(dur_samps) / SR
    out = np.zeros(dur_samps)
    if voiced:
        # harmonic source weighted by proximity to (scaled) formants
        f0_t = f0 * (1.0 - 0.06 * t / max(t[-1], 1e-3))   # declination
        phase = 2 * np.pi * np.cumsum(f0_t) / SR
        for k in range(1, 18):
            fk = k * f0
            if fk > 4000:
                break
            # resonance gain: sum of Lorentzians at the formants
            gain = sum(
                wi / (1.0 + ((fk - fi * formant_scale) / 180.0) ** 2)
                for fi, wi in zip(formants, weights)
            ) + 0.01
            out += gain * np.sin(k * phase)
    else:
        noise = rng.standard_normal(dur_samps)
        spec = np.fft.rfft(noise)
        freqs = np.fft.rfftfreq(dur_samps, 1.0 / SR)
        shape = sum(
            wi / (1.0 + ((freqs - fi * formant_scale) / 300.0) ** 2)
            for fi, wi in zip(formants, weights)
        ) + 0.02
        out = np.fft.irfft(spec * shape, dur_samps)
    # amplitude envelope
    env = np.minimum(1.0, np.minimum(t, t[::-1] + 1e-9) / 0.015)
    out = out * env
    return out / (np.abs(out).max() + 1e-9)


def synth_utterance(
    words: Sequence[str],
    lexicon: Dict[str, Tuple[str, ...]],
    phones_tbl, unit_index: Dict[str, int],
    speaker: dict, cfg: SynthConfig, rng: np.random.Generator,
) -> np.ndarray:
    xf = int(cfg.crossfade_ms * SR / 1000)
    segs = []
    for w in words:
        for u in lexicon[w]:
            lo, hi = cfg.phone_dur_ms
            dur = int(rng.integers(lo, hi) * speaker["rate"] * SR / 1000)
            segs.append(synth_phone(
                phones_tbl[unit_index[u]], max(dur, 2 * xf),
                speaker["f0"] * rng.uniform(0.95, 1.05),
                speaker["formant_scale"], rng,
            ))
        # short inter-word gap (>= 2 crossfades so overlap-add stays valid)
        gap = max(int(rng.integers(10, 40) * SR / 1000), 2 * xf)
        segs.append(np.zeros(gap))
    # overlap-add with crossfades
    total = sum(len(s) for s in segs) - xf * (len(segs) - 1)
    out = np.zeros(max(total, 1))
    pos = 0
    ramp = np.linspace(0.0, 1.0, xf)
    for i, s in enumerate(segs):
        s = s.copy()
        if i > 0:
            s[:xf] *= ramp
            out[pos : pos + xf] *= 1.0 - ramp
        out[pos : pos + len(s)] += s
        pos += len(s) - xf
    out = out / (np.abs(out).max() + 1e-9)
    sig_pow = np.mean(out ** 2)
    noise = rng.standard_normal(len(out))
    noise *= np.sqrt(sig_pow / 10 ** (cfg.snr_db / 10.0))
    return ((out + noise) * 12000).astype(np.float32)


def generate_corpus(
    cfg: SynthConfig, num_utts: int, split_seed: int,
    lexicon: List[Tuple[str, Tuple[str, ...]]],
    phones_tbl, zipf_a: float = 1.3,
):
    """Returns (wav dict key->float32 samples, text dict, utt2spk dict).
    Word frequencies are Zipf-distributed so the LM has realistic mass
    concentration."""
    rng = np.random.default_rng(cfg.seed * 7919 + split_seed)
    units = [f"p{i:02d}" for i in range(cfg.num_phones)]
    unit_index = {u: i for i, u in enumerate(units)}
    lex = dict(lexicon)
    word_list = [w for w, _ in lexicon]
    ranks = np.arange(1, len(word_list) + 1, dtype=np.float64)
    probs = ranks ** -zipf_a
    probs /= probs.sum()
    speakers = [_speaker(rng, cfg) for _ in range(cfg.num_speakers)]
    waves, texts, utt2spk = {}, {}, {}
    for i in range(num_utts):
        spk = int(rng.integers(0, cfg.num_speakers))
        n = int(rng.integers(cfg.min_utt_words, cfg.max_utt_words + 1))
        ws = [word_list[int(j)] for j in
              rng.choice(len(word_list), size=n, p=probs)]
        utt = f"spk{spk:02d}_utt{i:05d}"
        wav = synth_utterance(
            ws, lex, phones_tbl, unit_index, speakers[spk], cfg, rng
        )
        if cfg.channel_sim:
            wav = _apply_channel(wav, rng)
        waves[utt] = wav
        texts[utt] = ws
        utt2spk[utt] = f"spk{spk:02d}"
    return waves, texts, utt2spk


def speaker_seed(spk: str) -> int:
    """The seed of a speaker's parameters: the JAX package's
    abs(hash(spk)) % 2**32, salted per process like every str hash."""
    return abs(hash(spk)) % (2**32)


def generate_corpus_from_texts(
    cfg: SynthConfig,
    texts: Dict[str, List[str]],
    utt2spk: Dict[str, str],
    lexicon: List[Tuple[str, Tuple[str, ...]]],
    phones_tbl,
    snr_range: Tuple[float, float] | None = None,
    seed: int = 0,
    speaker_seeds: Dict[str, int] | None = None,
):
    """Synthesize waves for GIVEN word sequences (the stress-corpus path:
    the caller controls text statistics — Markov LM text, OOV/homophone
    eval sets — while this function only renders audio).  Speakers are
    derived from utt2spk values: each speaker's parameters are drawn from
    speaker_seeds[spk] when given, else from speaker_seed(spk), which
    hashes the name with Python's per-process string hash (so a fresh
    interpreter gives other voices unless PYTHONHASHSEED is fixed);
    per-utterance SNR is drawn from snr_range when given (else
    cfg.snr_db)."""
    rng = np.random.default_rng(cfg.seed * 7919 + seed)
    units = [f"p{i:02d}" for i in range(cfg.num_phones)]
    unit_index = {u: i for i, u in enumerate(units)}
    lex = dict(lexicon)
    spk_params: Dict[str, dict] = {}
    waves = {}
    for utt in sorted(texts):
        spk = utt2spk[utt]
        if spk not in spk_params:
            srng = np.random.default_rng(
                speaker_seeds[spk] if speaker_seeds is not None
                else speaker_seed(spk))
            spk_params[spk] = _speaker(srng, cfg)
        c = cfg
        if snr_range is not None:
            c = dataclasses.replace(
                cfg, snr_db=float(rng.uniform(*snr_range))
            )
        wav = synth_utterance(
            texts[utt], lex, phones_tbl, unit_index, spk_params[spk],
            c, rng,
        )
        if cfg.channel_sim:
            wav = _apply_channel(wav, rng)
        waves[utt] = wav
    return waves
