"""Corpus-specific data preparation: raw corpus trees -> Kaldi data dirs.

Python equivalents of the reference's per-corpus prep scripts — same
directory-layout conventions, transcript normalizations, speaker rules,
and wav.scp pipe commands (flac / sph2pipe), producing DataDir-compatible
output:

  - librispeech_prep: asr_egs/librispeech/local/data_prep.sh
  - wsj_prep (+ ndx2flist / find_transcripts / normalize_transcript):
    asr_egs/wsj/local/wsj_data_prep.sh and the perl helpers
  - tedlium_prep: asr_egs/tedlium/v1/local/tedlium_prepare_data.sh
  - swbd1_prep (+ map_swbd_word): asr_egs/swbd/v1/local/
    swbd1_data_prep.sh and swbd1_map_words.pl
  - hkust_prep: asr_egs/hkust/v1/local/hkust_data_prep.sh

Audio decompression follows the reference's convention of pipe commands
in wav.scp (`flac -c -d -s FILE |`, `sph2pipe -f wav FILE |`); the ark/
wave readers in eesen_tpu.io execute them, so the same external tools
the reference requires (flac, sph2pipe) are needed at read time — prep
itself needs none of them.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from eesen_tpu_torch.io.datadir import DataDir
from eesen_tpu_torch.utils.logging import get_logger

log = get_logger("recipes.data_prep")


def _write_datadir(
    dst: str,
    wav_scp: Dict[str, str],
    text: Dict[str, List[str]],
    utt2spk: Dict[str, str],
    segments: Optional[Dict[str, Tuple[str, float, float]]] = None,
) -> DataDir:
    os.makedirs(dst, exist_ok=True)
    tables = dict(wav_scp=wav_scp, text=text, utt2spk=utt2spk)
    if segments:
        tables["segments"] = {
            k: f"{rec} {s:.2f} {e:.2f}" for k, (rec, s, e) in segments.items()
        }
    return DataDir.write(dst, **tables)


# -------------------------------------------------------------------------
# LibriSpeech (local/data_prep.sh)
# -------------------------------------------------------------------------

def librispeech_prep(src: str, dst: str, flac_cmd: str = "flac") -> DataDir:
    """One split (e.g. .../LibriSpeech/train-clean-100) -> data dir.

    Layout: src/<reader>/<chapter>/<reader>-<chapter>-<utt>.flac with a
    per-chapter transcript <reader>-<chapter>.trans.txt; speaker id is
    reader-chapter (data_prep.sh:37-75)."""
    wav_scp: Dict[str, str] = {}
    text: Dict[str, List[str]] = {}
    utt2spk: Dict[str, str] = {}
    readers = sorted(
        d for d in os.listdir(src)
        if os.path.isdir(os.path.join(src, d))
    )
    if not readers:
        raise FileNotFoundError(f"no reader directories under {src}")
    for reader in readers:
        if not reader.isdigit():
            raise ValueError(f"unexpected subdirectory name {reader}")
        rdir = os.path.join(src, reader)
        for chapter in sorted(os.listdir(rdir)):
            cdir = os.path.join(rdir, chapter)
            if not os.path.isdir(cdir):
                continue
            spk = f"{reader}-{chapter}"
            trans = os.path.join(cdir, f"{spk}.trans.txt")
            if not os.path.exists(trans):
                raise FileNotFoundError(f"expected transcript {trans}")
            with open(trans) as f:
                for line in f:
                    parts = line.split()
                    if not parts:
                        continue
                    utt = parts[0]
                    text[utt] = parts[1:]
            for flac in sorted(glob.glob(os.path.join(cdir, "*.flac"))):
                utt = os.path.splitext(os.path.basename(flac))[0]
                wav_scp[utt] = f"{flac_cmd} -c -d -s {flac} |"
                utt2spk[utt] = spk
    missing = set(wav_scp) - set(text)
    if missing:
        log.warning("librispeech: %d utts without transcript", len(missing))
        for k in missing:
            wav_scp.pop(k)
            utt2spk.pop(k)
    text = {k: v for k, v in text.items() if k in wav_scp}
    return _write_datadir(dst, wav_scp, text, utt2spk)


# -------------------------------------------------------------------------
# WSJ (local/wsj_data_prep.sh + perl helpers)
# -------------------------------------------------------------------------

def ndx2flist(ndx_lines: Iterable[str], disk_dirs: Sequence[str]) -> List[str]:
    """Index entries like `11_2_1:wsj0/si_tr_s/401/...wv1` -> absolute
    paths, resolving disk ids (11_2_1 -> directory named 11-2.1)
    (local/ndx2flist.pl semantics)."""
    by_id: Dict[str, str] = {}
    for d in disk_dirs:
        base = os.path.basename(os.path.abspath(d))
        by_id[base.replace("-", "_").replace(".", "_")] = d
    out = []
    for line in ndx_lines:
        line = line.strip()
        if not line or line.startswith(";"):
            continue
        line = line.replace(": ", ":")
        if ":" in line:
            disk, rest = line.split(":", 1)
        else:
            parts = line.split("/", 1)
            disk, rest = parts[0], parts[1] if len(parts) > 1 else ""
        disk = disk.replace("-", "_").replace(".", "_")
        d = by_id.get(disk)
        if d is None:
            log.warning("ndx2flist: unknown disk id %s", disk)
            continue
        out.append(os.path.join(d, rest.lstrip("/")))
    return out


_WSJ_NOISE_RE = [
    re.compile(r"^\[<\w+\]$"),       # [<door_slam]: affects previous word
    re.compile(r"^\[\w+>\]$"),       # [door_slam>]: affects next word
    re.compile(r"^\[\w+/\]$"),       # [phone_ring/]: phenomenon start
    re.compile(r"^\[/\w+\]$"),       # [/phone_ring]: phenomenon end
]


def normalize_wsj_transcript(
    words: Sequence[str], noise_word: str = "<NOISE>"
) -> List[str]:
    """WSJ dot-transcript normalization (local/normalize_transcript.pl):
    upcase, strip backslash quoting, drop per-word noise annotations,
    map other [noises] to the noise word, unwrap <verbal deletions>."""
    out: List[str] = []
    for w in words:
        w = w.upper().replace("\\", "")
        if w == "%PERCENT":
            w = "PERCENT"
        elif w == ".POINT":
            w = "POINT"
        if any(r.match(w) for r in _WSJ_NOISE_RE) or w in ("~", "."):
            continue
        if re.search(r"\[\w+\]", w):
            out.append(noise_word)
            continue
        m = re.match(r"^<([\w']+)>$", w)
        if m:
            out.append(m.group(1))
            continue
        if w == "--DASH":
            out.append("-DASH")
            continue
        out.append(w)
    return out


def find_wsj_transcripts(
    utt_ids: Iterable[str], dot_files: Sequence[str]
) -> Dict[str, List[str]]:
    """Look up utterance transcripts in speaker dot files
    (local/find_transcripts.pl: speaker = 6-char prefix, dot lines are
    `transcript (uttid)`)."""
    spk2dot: Dict[str, str] = {}
    for path in dot_files:
        m = re.search(r"(\w{6})00\.dot$", path)
        if m:
            spk2dot[m.group(1)] = path
    cache: Dict[str, Dict[str, List[str]]] = {}
    out: Dict[str, List[str]] = {}
    for utt in utt_ids:
        spk = utt[:6]
        if spk not in cache:
            path = spk2dot.get(spk)
            if path is None:
                log.warning("no dot file for speaker %s", spk)
                cache[spk] = {}
            else:
                d: Dict[str, List[str]] = {}
                with open(path) as f:
                    for line in f:
                        m = re.match(r"(.+)\((\w{8})\)\s*$", line)
                        if m:
                            d[m.group(2)] = m.group(1).split()
                cache[spk] = d
        trans = cache[spk].get(utt)
        if trans is None:
            log.warning("no transcript for utterance %s", utt)
        else:
            out[utt] = trans
    return out


def wsj_prep(
    disk_dirs: Sequence[str],
    dst_root: str,
    sets: Optional[Dict[str, str]] = None,
    sph2pipe: str = "sph2pipe",
) -> Dict[str, DataDir]:
    """WSJ disks -> {set_name: DataDir} (wsj_data_prep.sh:45-140).

    sets maps set name -> ndx index path relative to the disk layout;
    defaults cover si84 train and eval92 the way the reference does.
    Utterance id = sphere-file basename; speaker = first 3 chars; audio
    via `sph2pipe -f wav FILE |`; transcripts from dot files found under
    every disk, normalized per normalize_transcript.pl."""
    if sets is None:
        sets = {
            "train_si84": "wsj0/doc/indices/train/tr_s_wv1.ndx",
            "test_eval92": "wsj0/doc/indices/test/nvp/si_et_20.ndx",
        }
    # collect all dot files once (wsj_data_prep.sh:113)
    dot_files: List[str] = []
    for d in disk_dirs:
        dot_files.extend(
            glob.glob(os.path.join(d, "**", "*.dot"), recursive=True)
        )
    out: Dict[str, DataDir] = {}
    for name, rel_ndx in sets.items():
        ndx_path = None
        for d in disk_dirs:
            cand = os.path.join(d, rel_ndx)
            if os.path.exists(cand):
                ndx_path = cand
                break
        if ndx_path is None:
            log.warning("wsj_prep: index %s not found, skipping %s",
                        rel_ndx, name)
            continue
        with open(ndx_path) as f:
            flist = ndx2flist(f, disk_dirs)
        # eval92-style indices omit the .wv1 suffix (wsj_data_prep.sh:74)
        flist = [
            p if p.lower().endswith((".wv1", ".wv2")) else p + ".wv1"
            for p in flist
        ]
        # the reference drops the bad si_tr_s/401 speaker (:46)
        flist = [p for p in flist if "/si_tr_s/401" not in p.lower()]
        utts = {
            os.path.splitext(os.path.basename(p))[0].lower(): p
            for p in flist
        }
        trans = find_wsj_transcripts(sorted(utts), dot_files)
        wav_scp = {
            u: f"{sph2pipe} -f wav {utts[u]} |" for u in sorted(utts)
            if u in trans
        }
        text = {u: normalize_wsj_transcript(trans[u]) for u in wav_scp}
        utt2spk = {u: u[:3] for u in wav_scp}
        out[name] = _write_datadir(
            os.path.join(dst_root, name), wav_scp, text, utt2spk
        )
        log.info("wsj_prep %s: %d utterances", name, len(wav_scp))
    return out


# -------------------------------------------------------------------------
# TEDLIUM (local/tedlium_prepare_data.sh)
# -------------------------------------------------------------------------

def tedlium_prep(
    db_dir: str, dst_root: str,
    sets: Sequence[str] = ("train", "dev", "test"),
    sph2pipe: str = "sph2pipe",
) -> Dict[str, DataDir]:
    """TEDLIUM release dir (with <set>/stm/*.stm and <set>/sph/*.sph) ->
    data dirs with segments.  Utt id = <talk>-<start>-<end> in frames,
    speaker = talk (tedlium_prepare_data.sh:40-63)."""
    out: Dict[str, DataDir] = {}
    for name in sets:
        stm_dir = os.path.join(db_dir, name, "stm")
        sph_dir = os.path.join(db_dir, name, "sph")
        if not os.path.isdir(stm_dir):
            log.warning("tedlium_prep: %s missing, skipping", stm_dir)
            continue
        text: Dict[str, List[str]] = {}
        segments: Dict[str, Tuple[str, float, float]] = {}
        utt2spk: Dict[str, str] = {}
        recs = set()
        for stm in sorted(glob.glob(os.path.join(stm_dir, "*.stm"))):
            with open(stm) as f:
                for line in f:
                    if line.startswith(";;"):
                        continue
                    parts = line.split()
                    if len(parts) < 7:
                        continue
                    talk, _chan, _spk, start, end = parts[:5]
                    if "ignore_time_segment_in_scoring" in line:
                        continue
                    words = parts[6:]
                    # strip pronunciation-variant digits and <sil>,
                    # {NOISE} -> [NOISE] (prepare_data.sh:42-55)
                    cleaned = []
                    for w in words:
                        w = re.sub(r"\(\d\)", "", w)
                        if w in ("<sil>", ""):
                            continue
                        w = w.replace("{", "[").replace("}", "]")
                        cleaned.append(w)
                    if not cleaned:
                        continue
                    s, e = float(start), float(end)
                    utt = f"{talk}-{int(s * 100):07d}-{int(e * 100):07d}"
                    text[utt] = cleaned
                    segments[utt] = (talk, s, e)
                    utt2spk[utt] = talk
                    recs.add(talk)
        wav_scp = {
            rec: f"{sph2pipe} -f wav -p {os.path.join(sph_dir, rec)}.sph |"
            for rec in sorted(recs)
        }
        out[name] = _write_datadir(
            os.path.join(dst_root, name), wav_scp, text, utt2spk, segments
        )
        log.info("tedlium_prep %s: %d segments", name, len(text))
    return out


# -------------------------------------------------------------------------
# Switchboard-1 (local/swbd1_data_prep.sh + swbd1_map_words.pl)
# -------------------------------------------------------------------------

def map_swbd_word(w: str) -> Optional[str]:
    """swbd1_map_words.pl single-word rules: [LAUGHTER-STORY] -> STORY,
    [IT'N/ISN'T] -> IT'N, partial-word brackets -> '-' forms,
    word_1 -> word; [noises] stay; returns None for dropped words."""
    w0 = w
    w = re.sub(r"^\[LAUGHTER-(.+)\](-?)$", r"\1\2", w, flags=re.I)
    w = re.sub(r"^\[(.+)/.+\](-?)$", r"\1\2", w)
    w = re.sub(r"^(-?)\[[^][]+\](.+)$", r"-\2", w)
    w = re.sub(r"^(.+)\[[^][]+\](-?)$", r"\1-", w)
    w = re.sub(r"([^][]+)\[.+\]$", r"\1", w)
    w = re.sub(r"_\d$", "", w)
    return w if w else None


def swbd1_prep(
    swbd_dir: str, dst: str, sph2pipe: str = "sph2pipe",
    trans_dir: Optional[str] = None,
) -> DataDir:
    """SWBD-1 audio + ISIP word-alignment transcripts -> one data dir
    with per-channel recordings (swbd1_data_prep.sh:60-125):
    recordings `sw0XXXX-[AB]` from 2-channel sphere files, utterances
    `sw0XXXX-[AB]_SSSSSS-EEEEEE`, [SILENCE]/<B_ASIDE>/<E_ASIDE> removed,
    swbd1_map_words applied, speaker = sw0XXXX-[AB]."""
    trans_dir = trans_dir or os.path.join(
        swbd_dir, "transcriptions", "swb_ms98_transcriptions"
    )
    sph_files = sorted(
        glob.glob(os.path.join(swbd_dir, "**", "*.sph"), recursive=True)
        + glob.glob(os.path.join(swbd_dir, "**", "*.SPH"), recursive=True)
    )
    wav_scp: Dict[str, str] = {}
    for sph in sph_files:
        base = os.path.splitext(os.path.basename(sph))[0].lower()
        wav_scp[f"{base}-A"] = f"{sph2pipe} -f wav -p -c 1 {sph} |"
        wav_scp[f"{base}-B"] = f"{sph2pipe} -f wav -p -c 2 {sph} |"
    text: Dict[str, List[str]] = {}
    segments: Dict[str, Tuple[str, float, float]] = {}
    utt2spk: Dict[str, str] = {}
    for trans in sorted(glob.glob(
        os.path.join(trans_dir, "**", "*-trans.text"), recursive=True
    )):
        with open(trans) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 4:
                    continue
                token, start, end = parts[0], float(parts[1]), float(parts[2])
                # sw02001A-ms98-a-0001 -> name sw02001, side A
                name, side = token[:6], token[6]
                name = re.sub(r"^sw", "sw0", name)
                rec = f"{name}-{side}"
                words: List[str] = []
                for w in parts[3:]:
                    w = w.lower()
                    if w in ("[silence]", "<b_aside>", "<e_aside>"):
                        continue
                    m = map_swbd_word(w)
                    if m:
                        words.append(m)
                if not words:
                    continue
                utt = (
                    f"{rec}_{int(100 * start + 0.5):06d}-"
                    f"{int(100 * end + 0.5):06d}"
                )
                text[utt] = words
                segments[utt] = (rec, start, end)
                utt2spk[utt] = rec
    return _write_datadir(dst, wav_scp, text, utt2spk, segments)


# -------------------------------------------------------------------------
# HKUST Mandarin (local/hkust_data_prep.sh)
# -------------------------------------------------------------------------

def hkust_prep(
    audio_dir: str, text_dir: str, dst_root: str,
    sph2pipe: str = "sph2pipe",
) -> Dict[str, DataDir]:
    """HKUST audio + GBK transcripts -> train/dev data dirs
    (hkust_data_prep.sh:30-75): transcript lines `# uttid` set the
    recording, then `start end side: words...` lines become segments
    `<uttid>-<side>-<start>-<end>` (centiseconds)."""
    out: Dict[str, DataDir] = {}
    for name in ("train", "dev"):
        sphs = [
            p for p in glob.glob(
                os.path.join(audio_dir, "**", "*.sph"), recursive=True
            )
            if f"audio{os.sep}{name}" in p.lower()
            or f"/{name}/" in p.lower()
        ]
        texts = [
            p for p in glob.glob(
                os.path.join(text_dir, "**", "*.txt"), recursive=True
            )
            if f"trans{os.sep}{name}" in p.lower()
            or f"/{name}/" in p.lower()
        ]
        if not sphs and not texts:
            continue
        wav_scp: Dict[str, str] = {}
        for sph in sorted(sphs):
            base = os.path.splitext(os.path.basename(sph))[0]
            # each sphere has two sides decoded separately
            wav_scp[f"{base}-A"] = f"{sph2pipe} -f wav -p -c 1 {sph} |"
            wav_scp[f"{base}-B"] = f"{sph2pipe} -f wav -p -c 2 {sph} |"
        text: Dict[str, List[str]] = {}
        segments: Dict[str, Tuple[str, float, float]] = {}
        utt2spk: Dict[str, str] = {}
        for path in sorted(texts):
            with open(path, "rb") as f:
                raw = f.read()
            try:
                content = raw.decode("gbk")
            except UnicodeDecodeError:
                content = raw.decode("utf-8", errors="replace")
            rec_id = None
            for line in content.splitlines():
                parts = line.split()
                if len(parts) <= 1:
                    continue
                if parts[0] == "#":
                    rec_id = parts[1]
                    continue
                if rec_id is None or len(parts) < 3:
                    continue
                try:
                    start, end = float(parts[0]), float(parts[1])
                except ValueError:
                    continue
                side = parts[2].rstrip(":")
                words = parts[3:]
                if not words:
                    continue
                utt = (
                    f"{rec_id}-{side}-{int(100 * start + 0.5):06d}-"
                    f"{int(100 * end + 0.5):06d}"
                )
                rec = f"{rec_id}-{side}"
                text[utt] = words
                segments[utt] = (rec, start, end)
                utt2spk[utt] = rec
        out[name] = _write_datadir(
            os.path.join(dst_root, name), wav_scp, text, utt2spk, segments
        )
        log.info("hkust_prep %s: %d segments", name, len(text))
    return out
