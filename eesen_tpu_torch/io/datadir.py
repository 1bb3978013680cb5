"""Kaldi data-directory conventions.

The reference's recipes exchange data through directories containing
wav.scp / text / utt2spk / spk2utt / feats.scp / cmvn.scp / segments
(reference: asr_egs/wsj/utils/validate_data_dir.sh, fix_data_dir.sh,
steps/make_fbank.sh).  `DataDir` reads and validates them.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

from eesen_tpu_torch.utils.logging import get_logger

log = get_logger("io.datadir")


def _read_map(path: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            key, _, rest = line.partition(" ")
            out[key] = rest.strip()
    return out


class DataDir:
    """A Kaldi-style data directory."""

    def __init__(self, path: str):
        self.path = path
        self.wav_scp: Dict[str, str] = {}
        self.text: Dict[str, List[str]] = {}
        self.utt2spk: Dict[str, str] = {}
        self.spk2utt: Dict[str, List[str]] = {}
        self.feats_scp: Dict[str, str] = {}
        self.cmvn_scp: Dict[str, str] = {}
        self.segments: Dict[str, tuple] = {}
        self._load()

    def _load(self) -> None:
        p = self.path
        if os.path.exists(os.path.join(p, "wav.scp")):
            self.wav_scp = _read_map(os.path.join(p, "wav.scp"))
        if os.path.exists(os.path.join(p, "text")):
            self.text = {
                k: v.split() for k, v in _read_map(os.path.join(p, "text")).items()
            }
        if os.path.exists(os.path.join(p, "utt2spk")):
            self.utt2spk = _read_map(os.path.join(p, "utt2spk"))
        if os.path.exists(os.path.join(p, "spk2utt")):
            self.spk2utt = {
                k: v.split()
                for k, v in _read_map(os.path.join(p, "spk2utt")).items()
            }
        elif self.utt2spk:
            for u, s in self.utt2spk.items():
                self.spk2utt.setdefault(s, []).append(u)
        if os.path.exists(os.path.join(p, "feats.scp")):
            self.feats_scp = _read_map(os.path.join(p, "feats.scp"))
        if os.path.exists(os.path.join(p, "cmvn.scp")):
            self.cmvn_scp = _read_map(os.path.join(p, "cmvn.scp"))
        if os.path.exists(os.path.join(p, "segments")):
            for k, v in _read_map(os.path.join(p, "segments")).items():
                rec, start, end = v.split()
                self.segments[k] = (rec, float(start), float(end))

    @property
    def utt_ids(self) -> List[str]:
        for src in (self.feats_scp, self.wav_scp, self.text, self.utt2spk):
            if src:
                return sorted(src.keys())
        return []

    def validate(self, require_feats: bool = False) -> None:
        """Check cross-file consistency (reference:
        utils/validate_data_dir.sh)."""
        utts = set(self.utt_ids)
        if not utts:
            raise ValueError(f"{self.path}: no utterances found")
        for name, m in [
            ("wav.scp", {} if self.segments else self.wav_scp),
            ("text", self.text),
            ("utt2spk", self.utt2spk),
            ("feats.scp", self.feats_scp),
        ]:
            if m and set(m.keys()) != utts:
                missing = utts - set(m.keys())
                extra = set(m.keys()) - utts
                raise ValueError(
                    f"{self.path}/{name}: mismatched keys "
                    f"(missing {len(missing)}, extra {len(extra)})"
                )
        if require_feats and not self.feats_scp:
            raise ValueError(f"{self.path}: feats.scp required")

    def filter_utts(self, keep: List[str]) -> None:
        """Subset in place (reference: utils/fix_data_dir.sh)."""
        keep_set = set(keep)
        for m in (
            self.wav_scp, self.text, self.utt2spk, self.feats_scp,
            self.segments,
        ):
            for k in list(m.keys()):
                if k not in keep_set:
                    del m[k]
        self.spk2utt = {}
        for u, s in self.utt2spk.items():
            self.spk2utt.setdefault(s, []).append(u)

    def split_tr_cv(
        self, cv_fraction: float = 0.05, seed: int = 777
    ) -> Tuple[List[str], List[str]]:
        """Speaker-disjoint train/CV utterance split (reference:
        utils/subset_data_dir_tr_cv.sh — the recipes' train_tr95/
        train_cv05 convention).  Returns (train_utts, cv_utts)."""
        import random as _random

        rng = _random.Random(seed)
        speakers = sorted(self.spk2utt) if self.spk2utt else []
        if speakers:
            shuffled = speakers[:]
            rng.shuffle(shuffled)
            n_cv = max(int(round(len(shuffled) * cv_fraction)), 1)
            cv_spk = set(shuffled[:n_cv])
            tr, cv = [], []
            for spk, utts in self.spk2utt.items():
                (cv if spk in cv_spk else tr).extend(utts)
            return sorted(tr), sorted(cv)
        utts = self.utt_ids[:]
        rng.shuffle(utts)
        n_cv = max(int(round(len(utts) * cv_fraction)), 1)
        return sorted(utts[n_cv:]), sorted(utts[:n_cv])

    def split_shards(self, n: int) -> List[List[str]]:
        """Shard utterances round-robin into n pieces (reference:
        utils/split_data.sh for parallel feature/decode jobs)."""
        utts = self.utt_ids
        return [utts[i::n] for i in range(n)]

    @staticmethod
    def write(path: str, **tables) -> "DataDir":
        """Write tables (wav_scp/text/utt2spk/...) to a new data dir."""
        os.makedirs(path, exist_ok=True)
        names = {
            "wav_scp": "wav.scp", "text": "text", "utt2spk": "utt2spk",
            "feats_scp": "feats.scp", "cmvn_scp": "cmvn.scp",
            "segments": "segments",
        }
        for attr, fname in names.items():
            if attr in tables:
                with open(os.path.join(path, fname), "w") as f:
                    for k in sorted(tables[attr]):
                        v = tables[attr][k]
                        if isinstance(v, (list, tuple)):
                            v = " ".join(str(x) for x in v)
                        f.write(f"{k} {v}\n")
        return DataDir(path)
