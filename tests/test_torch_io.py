"""The port's host copies of eesen_tpu/io (kaldi_io, wave, datadir) and of
decoder/score, recipes/labels, recipes/augment and recipes/data_prep
against the JAX package's: each format written by one package is read by
the other, as in tests/test_io.py; and the reference's int-vector
misread (eesen_tpu/io/kaldi_io.py:161) is pinned in both."""

import io
import struct

import numpy as np
import pytest

from eesen_tpu.decoder import score as jscore
from eesen_tpu.io import datadir as jdd
from eesen_tpu.io import kaldi_io as jk
from eesen_tpu.io import wave as jwave
from eesen_tpu.recipes import augment as jaug
from eesen_tpu.recipes import data_prep as jprep
from eesen_tpu_torch.decoder import score as tscore
from eesen_tpu_torch.io import datadir as tdd
from eesen_tpu_torch.io import kaldi_io as tk
from eesen_tpu_torch.io import wave as twave
from eesen_tpu_torch.recipes import augment as taug
from eesen_tpu_torch.recipes import data_prep as tprep

PAIRS = [(tk, tk), (tk, jk), (jk, tk)]
PAIR_IDS = ["port-port", "port-jax", "jax-port"]


@pytest.mark.parametrize("writer,reader", PAIRS, ids=PAIR_IDS)
def test_matrix_roundtrip(writer, reader):
    m = np.random.default_rng(0).standard_normal((17, 9)).astype(np.float32)
    buf = io.BytesIO()
    writer.write_matrix(buf, m)
    buf.seek(0)
    np.testing.assert_array_equal(reader.read_matrix(io.BufferedReader(buf)),
                                  m)


@pytest.mark.parametrize("writer,reader", PAIRS, ids=PAIR_IDS)
def test_ark_scp_roundtrip(tmp_path, writer, reader):
    rng = np.random.default_rng(1)
    items = {
        "utt_a": rng.standard_normal((5, 3)).astype(np.float32),
        "utt_b": rng.standard_normal((8, 3)).astype(np.float32),
        "utt_c": np.array([3, 1, 4, 1, 5], dtype=np.int32),
        "utt_d": rng.standard_normal(4).astype(np.float32),
    }
    ark, scp = str(tmp_path / "d.ark"), str(tmp_path / "d.scp")
    writer.write_ark(ark, items.items(), scp_path=scp)
    got = dict(reader.read_ark(ark))
    assert set(got) == set(items)
    for k, v in items.items():
        np.testing.assert_array_equal(got[k], v)
        assert got[k].dtype == v.dtype
    table = reader.read_scp(scp)
    for k, v in items.items():
        np.testing.assert_array_equal(reader.read_scp_entry(table[k]), v)
    got2 = dict(reader.read_rspecifier(f"scp:{scp}"))
    np.testing.assert_array_equal(got2["utt_b"], items["utt_b"])


@pytest.mark.parametrize("rows", [40, 6], ids=["CM", "CM2"])
@pytest.mark.parametrize("writer,reader", PAIRS, ids=PAIR_IDS)
def test_compressed_matrix_roundtrip(tmp_path, writer, reader, rows):
    """The same compressed bytes from both writers, and the same floats
    back from both readers (<= 8 rows take the CM2 format)."""
    m = (np.random.default_rng(9).standard_normal((rows, 13)) * 3).astype(
        np.float32)
    path, ref = str(tmp_path / "w.ark"), str(tmp_path / "ref.ark")
    writer.write_ark(path, [("u1", m)], compress=True)
    jk.write_ark(ref, [("u1", m)], compress=True)
    with open(path, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()
    (key, got), = list(reader.read_ark(path))
    (_, want), = list(jk.read_ark(ref))
    assert key == "u1"
    np.testing.assert_array_equal(got, want)


def test_text_entries(tmp_path):
    path = str(tmp_path / "labels.ark")
    with open(path, "w") as f:
        f.write("utt1 3 5 7\nutt2 1 2\nutt3 [ 1.5 2.5\n 3.5 4.5 ]\n")
    got, want = dict(tk.read_ark(path)), dict(jk.read_ark(path))
    assert set(got) == set(want) == {"utt1", "utt2", "utt3"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype


def wav_bytes(samples, rate=16000, bits=16, channels=1):
    body = samples.tobytes()
    align = channels * bits // 8
    return (
        b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE" + b"fmt "
        + struct.pack("<IHHIIHH", 16, 1, channels, rate, rate * align,
                      align, bits)
        + b"data" + struct.pack("<I", len(body)) + body
    )


@pytest.mark.parametrize("bits,channels", [(16, 1), (16, 2), (8, 1),
                                           (32, 1)])
def test_wave_parse(tmp_path, bits, channels):
    rng = np.random.default_rng(bits + channels)
    dtype = {8: "u1", 16: "<i2", 32: "<i4"}[bits]
    hi = {8: 255, 16: 20000, 32: 2 ** 30}[bits]
    samples = rng.integers(0, hi, 1600 * channels).astype(dtype)
    data = wav_bytes(samples, bits=bits, channels=channels)
    arr, sr = twave.parse_wav_bytes(data)
    want, wsr = jwave.parse_wav_bytes(data)
    assert sr == wsr == 16000 and arr.shape == want.shape
    assert arr.shape == (channels, 1600) and arr.dtype == want.dtype
    np.testing.assert_array_equal(arr, want)
    path = tmp_path / "x.wav"
    path.write_bytes(data)
    np.testing.assert_array_equal(twave.read_wav(str(path))[0], want)


def test_datadir_roundtrip_and_splits(tmp_path):
    wav = {f"u{i}": f"/x/u{i}.wav" for i in range(20)}
    text = {k: ["HELLO", "WORLD"] for k in wav}
    utt2spk = {f"u{i}": f"spk{i % 5}" for i in range(20)}
    t = tdd.DataDir.write(str(tmp_path / "d"), wav_scp=wav, text=text,
                          utt2spk=utt2spk)
    j = jdd.DataDir(str(tmp_path / "d"))
    t.validate()
    assert (t.utt_ids, t.text, t.spk2utt) == (j.utt_ids, j.text, j.spk2utt)
    assert t.split_tr_cv(cv_fraction=0.2) == j.split_tr_cv(cv_fraction=0.2)
    assert t.split_shards(3) == j.split_shards(3)
    t.filter_utts(["u1", "u7"])
    assert t.utt_ids == ["u1", "u7"]
    bad = tdd.DataDir.write(str(tmp_path / "bad"), wav_scp=wav,
                            text={"u1": ["HI"]})
    with pytest.raises(ValueError):
        bad.validate()


def test_int_vector_heuristic_misreads_in_both_packages(tmp_path):
    """Pinned reference defect (eesen_tpu/io/kaldi_io.py:161): a raw
    WriteIntegerVector entry ('\\x04', count, packed int32s) of one
    element whose value is 4 mod 256 passes the per-element marker test
    (only byte 0 of the 4n bytes is checked), so the reader takes one
    byte of the next entry as the value's top byte and the stream
    desyncs.  Both packages misread it the same way; the port's copy
    keeps the reference's behaviour."""
    path = str(tmp_path / "raw.ark")
    with open(path, "wb") as f:
        f.write(b"a \x00B\x04" + struct.pack("<i", 1) + struct.pack(
            "<i", 260))                                  # 260 = 4 mod 256
        f.write(b"b \x00B\x04" + struct.pack("<i", 1) + struct.pack(
            "<i", 7))
    results = []
    for mod in (jk, tk):
        it = mod.read_ark(path)
        key, value = next(it)
        try:
            rest = list(it)
        except (ValueError, struct.error, UnicodeDecodeError) as e:
            rest = type(e).__name__
        results.append((key, value.tolist(), rest))
    assert results[0][0] == "a"
    # the value is 260's top three bytes shifted down, plus 'b' on top
    assert results[0][1] == [(ord("b") << 24) | (260 >> 8)]
    assert results[1][:2] == results[0][:2]
    assert repr(results[1][2]) == repr(results[0][2])


def test_wer_scoring_matches_jax():
    rng = np.random.default_rng(4)
    vocab = ["a", "b", "c", "d"]
    refs, hyps = {}, {}
    for i in range(12):
        refs[f"u{i}"] = [vocab[j] for j in rng.integers(0, 4, 6)]
        if i % 5:
            hyps[f"u{i}"] = [vocab[j] for j in rng.integers(0, 4,
                                                            4 + i % 4)]
    for mode in ("present", "all"):
        t = tscore.compute_wer(refs, hyps, mode)
        j = jscore.compute_wer(refs, hyps, mode)
        assert (t.report(), t.absent_sentences) == (j.report(),
                                                    j.absent_sentences)


def test_augment_tags_and_data_prep_match_jax():
    assert [t.name for t in taug.librispeech_tags()] == [
        t.name for t in jaug.librispeech_tags()]
    assert taug.LIBRISPEECH_ROTATION == jaug.LIBRISPEECH_ROTATION
    assert [taug.rotation_tag(taug.LIBRISPEECH_ROTATION, e)
            for e in range(1, 13)] == [
        jaug.rotation_tag(jaug.LIBRISPEECH_ROTATION, e) for e in range(1, 13)]
    assert taug.base_tag(taug.librispeech_tags()).name == "10_1"
    for line in ["The <UH> cat\\'s [door_slam] sat .", "%PERCENT ~ --DASH",
                 "[loud_breath] .POINT <THE> x"]:
        got = tprep.normalize_wsj_transcript(line.split())
        assert got == jprep.normalize_wsj_transcript(line.split())
        assert got
    for w in ["[LAUGHTER-story]", "[it'n/isn't]", "th[e]-", "[th]e",
              "word_1", "[noise]", "uh-huh"]:
        assert tprep.map_swbd_word(w) == jprep.map_swbd_word(w)
