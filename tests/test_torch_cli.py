"""The port's command line (eesen_tpu_torch/tools/cli.py) on the CPU
(`--device cpu`) against the JAX package's (eesen_tpu/tools/cli.py): the
same commands, arguments and defaults, and each command of the feature,
graph and LM, FST and net-tool groups run through both packages' `main`
on the same inputs, outputs compared (the decode, alignment and lattice
commands are in tests/test_torch_cli_decode.py).  Then the port's
own shell pipeline, as tests/test_cli_pipeline.py runs the JAX one:
train -> net-output-extract -> latgen (+lattices, blank-skip, streaming)
-> decode-faster -> lattice-best-path -> compute-wer.

Toy sizes: tests/test_ctc_graph.py's lexicon and bigram, one BiLSTM
layer of 8 cells (24 in the pipeline), waves of half a second."""

import argparse
import contextlib
import io
import pickle
import wave as wavmod

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eesen_tpu.io.kaldi_io import read_rspecifier
from eesen_tpu.io.kaldi_io import write_ark
from eesen_tpu.models import model as jmodel
from eesen_tpu.models.priors import counts_from_labels as j_counts
from eesen_tpu.models.serialize import write_eesen_nnet as j_write_nnet
from eesen_tpu.tools.cli import main as jmain
from eesen_tpu_torch.models import model as tmodel
from eesen_tpu_torch.models.serialize import read_eesen_nnet
from eesen_tpu_torch.tools import cli as tcli

from tests.test_cli_pipeline import _synth_utt
from tests.test_ctc_graph import ARPA, LEXICON, UNITS
from tests.test_fstbin_cli import FST_TEXT
from tests.test_torch_features import MEL_FLOOR, TOL, mel_power, waves

V = len(UNITS) + 1           # blank + units
PROCESS_TOL = 1e-4           # process_pitch after kaldi_pitch, see pitch test


def tmain(argv):
    return tcli.main(["--device", "cpu", *argv])


def run(main, argv):
    """main(argv) -> (rc, stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def both(tmp_path, argv_fn, rc=0):
    """Each package's main on argv_fn(out_dir) in its own out_dir; returns
    (jax dir, port dir, jax stdout, port stdout)."""
    outs = []
    for name, main in (("jax", jmain), ("port", tmain)):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        got_rc, out = run(main, argv_fn(str(d)))
        assert got_rc == rc, (name, got_rc)
        outs.append((d, out))
    (jd, jo), (td, to) = outs
    return jd, td, jo, to


def read(path):
    with open(path, "rb") as f:
        return f.read()


def ark(path):
    return dict(read_rspecifier(f"ark:{path}"))


def text_lines(path):
    with open(path) as f:
        return f.read().splitlines()


# --------------------------------------------------------------------------
# the argument surface
# --------------------------------------------------------------------------

def jax_parser(monkeypatch):
    """The JAX package's parser, caught at parse_args."""
    caught = {}

    class Caught(Exception):
        pass

    def grab(self, args=None, namespace=None):
        caught["parser"] = self
        raise Caught

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(Caught):
            jmain([])
    return caught["parser"]


def surface(parser):
    """{command: sorted argument specs}, and the top-level specs."""
    def spec(p):
        return sorted(
            (tuple(a.option_strings), a.dest, repr(a.default), repr(a.nargs),
             repr(a.choices), a.required,
             getattr(a.type, "__name__", repr(a.type)))
            for a in p._actions
            if not isinstance(a, (argparse._HelpAction,
                                  argparse._SubParsersAction))
        )

    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {name: spec(p) for name, p in sub.choices.items()}, spec(parser)


def test_every_command_with_the_same_arguments(monkeypatch):
    jcmds, jtop = surface(jax_parser(monkeypatch))
    tcmds, ttop = surface(tcli.build_parser())
    assert len(jcmds) > 60
    assert list(tcmds) == list(jcmds)
    for name in jcmds:
        assert tcmds[name] == jcmds[name], name
    # the one addition: --device before the command, "cuda" by default
    assert jtop == [] and ttop == [
        (("--device",), "device", "'cuda'", "None", "None", False, "None")]
    assert tcli.build_parser().prog == "eesen-tpu-torch"


# --------------------------------------------------------------------------
# feature commands
# --------------------------------------------------------------------------

def write_wav(path, samples, sr=16000):
    with wavmod.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.clip(np.round(samples), -32768, 32767).astype(
            "<i2").tobytes())


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """Three half-second waves (noise + a tone, tests/test_torch_features
    .waves) as wav files, a wav.scp, and the samples as read back."""
    d = tmp_path_factory.mktemp("wavs")
    w = waves(b=3, n=8000, seed=5)
    scp = d / "wav.scp"
    with open(scp, "w") as f:
        for i in range(3):
            path = str(d / f"r{i}.wav")
            write_wav(path, w[i])
            f.write(f"r{i} {path}\n")
    back = np.clip(np.round(w), -32768, 32767).astype(np.float32)
    return f"scp:{scp}", back


@pytest.mark.parametrize("kind", ["fbank", "mfcc", "plp", "spectrogram"])
def test_compute_feats(tmp_path, wavs, kind):
    scp, w = wavs
    jd, td, _, _ = both(tmp_path, lambda d: [
        f"compute-{kind}-feats", "--num-mel-bins", "23", scp,
        f"ark,scp:{d}/f.ark,{d}/f.scp"])
    got, want = ark(td / "f.ark"), ark(jd / "f.ark")
    assert sorted(got) == sorted(want) == ["r0", "r1", "r2"]
    assert text_lines(td / "f.scp")[0].split()[0] == "r0"
    from eesen_tpu.frontend import features as jf
    opts = jf.FbankOptions(frame_opts=jf.FrameOptions(dither=0.0),
                           mel_opts=jf.MelOptions(num_bins=23))
    for i, k in enumerate(sorted(want)):
        g, x = got[k], want[k]
        assert g.shape == x.shape
        if kind == "fbank":
            mask = mel_power(w[i], opts) > MEL_FLOOR
            np.testing.assert_allclose(g[mask], x[mask], rtol=TOL, atol=TOL)
        elif kind == "mfcc":
            # cepstra are sums of 23 log-mels (tests/test_torch_frontend.py)
            np.testing.assert_allclose(g, x, rtol=TOL, atol=TOL * 23)
        elif kind == "plp":
            np.testing.assert_allclose(g, x, rtol=TOL, atol=TOL)
        else:
            np.testing.assert_allclose(g[:, 0], x[:, 0], rtol=TOL, atol=TOL)
            # the two FFTs' rounding is relative to a frame's largest bin:
            # compare the bins within 1e-4 of it in power (log 9.2 below)
            logp = x[:, 1:]
            mask = logp > logp.max(axis=1, keepdims=True) - 9.2
            np.testing.assert_allclose(g[:, 1:][mask], logp[mask],
                                       rtol=TOL, atol=TOL)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_dither_adds_no_noise(tmp_path, wavs, pkg):
    """A behaviour of the JAX package's CLI, kept: compute-*-feats pass no
    random key (generator), so --dither 1.0 (the default) gives the bits
    of --dither 0."""
    main = jmain if pkg == "jax" else tmain
    scp, _ = wavs
    for dither in ("1.0", "0"):
        assert main(["compute-fbank-feats", "--dither", dither, scp,
                     f"ark:{tmp_path}/d{dither}.ark"]) == 0
    a, b = ark(tmp_path / "d1.0.ark"), ark(tmp_path / "d0.ark")
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_compute_kaldi_pitch_feats(tmp_path, wavs):
    scp, _ = wavs
    one = tmp_path / "one.scp"           # one wave: the JAX pitch is slow
    with open(scp.split(":", 1)[1]) as f:
        one.write_text(f.readline())
    jd, td, _, _ = both(tmp_path, lambda d: [
        "compute-kaldi-pitch-feats", f"scp:{one}", f"ark:{d}/p.ark"])
    got, want = ark(td / "p.ark"), ark(jd / "p.ark")
    for k in want:
        assert got[k].shape == want[k].shape and got[k].shape[1] == 3
        # kaldi_pitch within 1e-4 (tests/test_torch_frontend.py "noise"),
        # then the normalization and delta of process_pitch
        np.testing.assert_allclose(got[k], want[k], rtol=PROCESS_TOL,
                                   atol=PROCESS_TOL)


@pytest.fixture(scope="module")
def feats(tmp_path_factory):
    """Raw log-mel-like features of four utterances, two speakers."""
    d = tmp_path_factory.mktemp("feats")
    rng = np.random.default_rng(3)
    raw = {f"u{i}": (rng.standard_normal((20 + 3 * i, 6)) * 2 + 10).astype(
        np.float32) for i in range(4)}
    write_ark(str(d / "raw.ark"), raw.items())
    with open(d / "spk2utt", "w") as f:
        f.write("s0 u0 u2\ns1 u1 u3\n")
    with open(d / "utt2spk", "w") as f:
        f.write("u0 s0\nu1 s1\nu2 s0\nu3 s1\n")
    return d


def test_cmvn_stats_and_apply(tmp_path, feats):
    jd, td, _, _ = both(tmp_path, lambda d: [
        "compute-cmvn-stats", f"--spk2utt=ark:{feats}/spk2utt",
        f"ark:{feats}/raw.ark", f"ark:{d}/cmvn.ark"])
    got, want = ark(td / "cmvn.ark"), ark(jd / "cmvn.ark")
    assert sorted(got) == ["s0", "s1"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-4)
    for norm in ("true", "false"):
        jd, td, _, _ = both(tmp_path, lambda d: [
            "apply-cmvn", f"--utt2spk=ark:{feats}/utt2spk",
            f"--norm-vars={norm}", f"ark:{jd}/cmvn.ark",
            f"ark:{feats}/raw.ark", f"ark:{d}/n{norm}.ark"])
        got, want = ark(td / f"n{norm}.ark"), ark(jd / f"n{norm}.ark")
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("argv", [
    ["add-deltas"], ["add-deltas", "--delta-order", "1",
                     "--delta-window", "3"],
    ["splice-feats", "--left-context", "2", "--right-context", "1"],
    ["subsample-feats", "--n", "3", "--offset", "1"], ["copy-feats"],
], ids=["deltas", "deltas_1_3", "splice", "subsample", "copy"])
def test_feature_transforms(tmp_path, feats, argv):
    jd, td, _, _ = both(tmp_path, lambda d: [
        *argv, f"ark:{feats}/raw.ark", f"ark:{d}/o.ark"])
    got, want = ark(td / "o.ark"), ark(jd / "o.ark")
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-5)


def test_paste_dims_lens_and_segments(tmp_path, feats, wavs):
    jd, td, _, _ = both(tmp_path, lambda d: [
        "paste-feats", f"ark:{feats}/raw.ark", f"ark:{feats}/raw.ark",
        f"ark:{d}/p.ark"])
    assert read(td / "p.ark") == read(jd / "p.ark")
    for argv in (["feat-to-dim"], ["feat-to-len"]):
        _, _, jo, to = both(tmp_path, lambda d: [*argv,
                                                  f"ark:{jd}/p.ark"])
        assert to == jo and to.strip()
    scp, _ = wavs
    seg = tmp_path / "segments"
    seg.write_text("a r0 0.05 0.2\nb r1 0.1 0.45\nc r9 0 1\nd r2 0.3 0.3\n")
    jd, td, _, _ = both(tmp_path, lambda d: [
        "extract-segments", scp, str(seg), f"ark:{d}/seg.ark"])
    got, want = ark(td / "seg.ark"), ark(jd / "seg.ark")
    assert list(got) == list(want) == ["a", "b"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# --------------------------------------------------------------------------
# graph / LM and FST commands
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def langs(tmp_path_factory):
    """build-lang and build-tlg of the toy lexicon in each package:
    (jax dir, port dir, arpa path); each dir holds lang files + tlg.pkl."""
    d = tmp_path_factory.mktemp("lang")
    lex, units, arpa = d / "lexicon.txt", d / "units.txt", d / "lm.arpa"
    lex.write_text("".join(f"{w} {' '.join(p)}\n" for w, p in LEXICON))
    units.write_text("".join(f"{u} {i + 1}\n" for i, u in enumerate(UNITS)))
    arpa.write_text(ARPA)
    dirs = []
    for name, main in (("jax", jmain), ("port", tmain)):
        out = d / name
        assert main(["build-lang", str(lex), str(units), str(out)]) == 0
        assert main(["build-tlg", "--max-degree", "8", str(out), str(arpa),
                     str(out / "tlg.pkl")]) == 0
        dirs.append(out)
    return dirs[0], dirs[1], str(arpa)


def test_build_lang_and_tlg(langs):
    jd, td, _ = langs
    for name in ("tokens.txt", "words.txt", "T.fst.txt", "L.fst.txt"):
        assert read(td / name) == read(jd / name), name
    with open(jd / "tlg.pkl", "rb") as f:
        jg = pickle.load(f)
    tg = tcli.load_pickle(str(td / "tlg.pkl"))
    assert type(tg).__module__ == "eesen_tpu_torch.decoder.graph_compile"
    assert tg.has_closure and jg.has_closure
    for k, v in vars(jg).items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(getattr(tg, k), v, k)
        elif not k.startswith("_"):
            assert getattr(tg, k) == v, k
    lang = tcli.load_pickle(str(td / "lang.pkl"), "lang")
    assert type(lang).__module__ == "eesen_tpu_torch.decoder.ctc_graph"


def test_prep_corpus(tmp_path):
    src = tmp_path / "train-clean-100" / "19" / "198"
    src.mkdir(parents=True)
    (src / "19-198.trans.txt").write_text("19-198-0000 HELLO WORLD\n"
                                          "19-198-0001 GOOD DAY\n")
    for u in ("0000", "0001"):
        (src / f"19-198-{u}.flac").write_bytes(b"")
    jd, td, _, _ = both(tmp_path, lambda d: [
        "prep-corpus", "librispeech", f"{d}/data",
        str(tmp_path / "train-clean-100")])
    for name in ("wav.scp", "text", "utt2spk"):
        assert read(td / "data" / name) == read(jd / "data" / name), name


def test_arpa_tools(tmp_path, langs):
    jl, _, arpa = langs
    words = str(jl / "words.txt")
    jd, td, _, _ = both(tmp_path, lambda d: [
        "arpa2fst", arpa, "--words", words, "--out", f"{d}/g.fst"])
    assert read(td / "g.fst") == read(jd / "g.fst")
    jd, td, _, _ = both(tmp_path, lambda d: [
        "arpa-to-const-lm", arpa, words, f"{d}/lm.npz"])
    a, b = np.load(td / "lm.npz"), np.load(jd / "lm.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        np.testing.assert_array_equal(a[k], b[k], k)


UNARY = ["fst-copy", "fst-determinize-star", "fst-determinize-log",
         "fst-minimize-encoded", "fst-rm-epsilon", "fst-push-special",
         "fst-connect", "fst-arcsort"]


@pytest.mark.parametrize("cmd", UNARY)
def test_fst_unary(tmp_path, cmd):
    src = tmp_path / "a.fst"
    src.write_text(FST_TEXT + "0 2 0 5 0.5\n2 3 1 0 0.0\n3 0.1\n")
    extra = ["--sort-type", "olabel"] if cmd == "fst-arcsort" else []
    jd, td, _, _ = both(tmp_path, lambda d: [cmd, str(src), f"{d}/o.fst",
                                             *extra])
    assert read(td / "o.fst") == read(jd / "o.fst")


def test_fst_tools(tmp_path):
    a, b = tmp_path / "a.fst", tmp_path / "b.fst"
    a.write_text("0 1 1 2 0.0\n1 2 2 3 0.5\n2\n")
    b.write_text("0 1 2 3 0.5\n1 2 3 4 0.25\n2\n")
    syms = tmp_path / "syms.list"
    syms.write_text("3\n4\n")
    cases = [
        ["fst-compose", str(a), str(b)],
        ["fst-add-self-loops", str(a), "--isyms", "7", "--osyms", "8"],
        ["fst-add-subsequential-loop", "9", str(a)],
        ["fst-prune-special", str(a), "--beam", "0.2"],
        ["fst-rm-symbols", str(syms), str(b)],
        ["fst-prop-final", "2", str(b)],
        ["fst-rand", "--seed", "3"],
    ]
    for argv in cases:
        _, _, jo, to = both(tmp_path, lambda d: argv)
        assert to == jo and to.strip(), argv
    jd, td, _, _ = both(tmp_path, lambda d: [
        "fst-factor", str(a), f"{d}/f1.fst", f"{d}/f2.fst"])
    for name in ("f1.fst", "f2.fst"):
        assert read(td / name) == read(jd / name)
    for text, rc in (("0 1 1 1 0.6931472\n0 1 2 2 0.6931472\n1 0.0\n", 0),
                     ("0 1 1 1 3.0\n1 0.0\n", 1)):
        (tmp_path / "s.fst").write_text(text)
        _, _, jo, to = both(tmp_path, lambda d: [
            "fst-is-stochastic", str(tmp_path / "s.fst")], rc=rc)
        assert to == jo
    fsts = tmp_path / "fsts.ark"
    fsts.write_text("utt1\n0 1 1 11 0.5\n1 2 2 12\n2\n\nutt2\n0 1 5 15\n1\n")
    for side in ("true", "false"):
        _, _, jo, to = both(tmp_path, lambda d: [
            "fsts-to-transcripts", "--output-side", side, str(fsts)])
        assert to == jo and "utt2" in to


# --------------------------------------------------------------------------
# model files
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """A one-layer f32 model: the JAX package's pickle, and the same
    parameters as the port's model blob (params_from_jax)."""
    d = tmp_path_factory.mktemp("model")
    jcfg = jmodel.AcousticModelConfig(
        input_dim=6, cell_dim=8, num_layers=1, num_targets=V,
        compute_dtype=jnp.float32)
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init_model(jax.random.PRNGKey(1), jcfg))
    with open(d / "m.pkl", "wb") as f:
        pickle.dump({"params": params, "config": jcfg}, f)
    tcfg = tmodel.AcousticModelConfig(
        input_dim=6, cell_dim=8, num_layers=1, num_targets=V,
        compute_dtype=torch.float32)
    tcli.save_model_blob(str(d / "m.pt"), {
        "params": tmodel.params_from_jax(params, device="cpu"),
        "config": tcfg})
    rng = np.random.default_rng(9)
    # two lengths: the JAX package's CLI compiles its forward per length
    utts = {f"u{i}": rng.standard_normal((9 + 4 * (i % 2), 6)).astype(
        np.float32) for i in range(4)}
    write_ark(str(d / "f.ark"), utts.items())
    labels = {k: rng.integers(1, V, 1 + i % 2).astype(np.int32)
              for i, k in enumerate(utts)}
    write_ark(str(d / "l.ark"), labels.items())
    np.savetxt(d / "counts", rng.integers(1, 100, V).astype(np.float64))
    return d


# --------------------------------------------------------------------------
# net tools
# --------------------------------------------------------------------------

def test_model_info_and_net_copy(tmp_path, model):
    _, jo = run(jmain, ["model-info", str(model / "m.pkl")])
    _, to = run(tmain, ["model-info", str(model / "m.pt")])
    assert to == jo and "num-params" in to
    for par in ([], ["--parallel"]):
        assert jmain(["net-copy", *par, str(model / "m.pkl"),
                      str(tmp_path / "j.nnet")]) == 0
        assert tmain(["net-copy", *par, str(model / "m.pt"),
                      str(tmp_path / "t.nnet")]) == 0
        assert read(tmp_path / "t.nnet") == read(tmp_path / "j.nnet")
    # .nnet -> blob -> .nnet gives the same bytes again
    assert tmain(["net-copy", str(tmp_path / "t.nnet"),
                  str(tmp_path / "back.pt")]) == 0
    assert tmain(["net-copy", "--parallel", str(tmp_path / "back.pt"),
                  str(tmp_path / "again.nnet")]) == 0
    assert read(tmp_path / "again.nnet") == read(tmp_path / "j.nnet")
    _, to = run(tmain, ["model-info", str(tmp_path / "t.nnet")])
    assert "cell-dim 8" in to


def test_net_average(tmp_path, model):
    jc = jmodel.AcousticModelConfig(input_dim=6, cell_dim=8, num_layers=1,
                                    num_targets=V, compute_dtype=jnp.float32)
    p2 = jax.tree_util.tree_map(
        np.asarray, jmodel.init_model(jax.random.PRNGKey(2), jc))
    with open(tmp_path / "m2.pkl", "wb") as f:
        pickle.dump({"params": p2, "config": jc}, f)
    tcli.save_model_blob(str(tmp_path / "m2.pt"), {
        "params": tmodel.params_from_jax(p2, device="cpu"),
        "config": tcli.load_model(str(model / "m.pt"))[1]})
    assert jmain(["net-average", str(tmp_path / "a.pkl"),
                  str(model / "m.pkl"), str(tmp_path / "m2.pkl")]) == 0
    assert tmain(["net-average", str(tmp_path / "a.pt"),
                  str(model / "m.pt"), str(tmp_path / "m2.pt")]) == 0
    with open(tmp_path / "a.pkl", "rb") as f:
        want = jax.tree_util.tree_leaves(pickle.load(f)["params"])
    got = tcli.load_model(str(tmp_path / "a.pt"))[0]
    got = [x.numpy() for x in tcli.tree_leaves(got)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_net_change_model(tmp_path, model):
    opts = ["--forwarddrop", "0.2", "--recurrentdrop", "0.3", "--rnndrop",
            "--forwardstep", "true", "--twiddleforward", "true"]
    outs = []
    for name, main, m in (("jax", jmain, "m.pkl"), ("port", tmain, "m.pt")):
        (tmp_path / name).mkdir()
        outs.append(run(main, ["net-change-model", str(model / m),
                               str(tmp_path / name / "x.nnet"), *opts])[1])
    assert outs[1] == outs[0].replace("/jax/", "/port/")
    assert read(tmp_path / "port/x.nnet") == read(tmp_path / "jax/x.nnet")
    assert tmain(["net-change-model", str(model / "m.pt"),
                  str(tmp_path / "t.pt"), "--nmldrop",
                  "--recurrentdrop", "0.1"]) == 0
    params, cfg = tcli.load_model(str(tmp_path / "t.pt"))
    assert (cfg.recurrent_dropout, cfg.recurrent_dropout_mode) == (
        0.1, "no_mem_loss")
    assert cfg.compute_dtype == torch.float32 and cfg.cell_dim == 8
    for a, b in zip(tcli.tree_leaves(params), tcli.tree_leaves(
            tcli.load_model(str(model / "m.pt"))[0])):
        assert torch.equal(a, b)


def test_model_topo_and_net_initialize(tmp_path):
    topo = ["model-topo", "--input-feat-dim", "6", "--lstm-layer-num", "2",
            "--lstm-cell-dim", "8", "--target-num", "5",
            "--fgate-bias-init", "1.0"]
    _, jo = run(jmain, topo)
    _, to = run(tmain, topo)
    assert to == jo and "<BiLstmParallel>" in to
    proto = tmp_path / "nnet.proto"
    proto.write_text(to)
    for out in ("init.nnet", "init.pt"):
        rc, msg = run(tmain, ["net-initialize", str(proto),
                              str(tmp_path / out), "--seed", "5"])
        assert rc == 0 and "params)" in msg
    params, cfg = read_eesen_nnet(str(tmp_path / "init.nnet"), device="cpu")
    assert (cfg.input_dim, cfg.cell_dim, cfg.num_layers, cfg.num_targets
            ) == (6, 8, 2, 5)
    assert tcli.load_model(str(tmp_path / "init.pt"))[1].fgate_bias == 1.0
    w = params["layers"][0]["fw"]["w_gifo_x"]
    assert w.abs().max() <= cfg.param_range + 1e-6 and w.std() > 0
    # the JAX package writes the same bytes for the same parameters
    host = jax.tree_util.tree_map(
        lambda x: x.numpy(), params, is_leaf=torch.is_tensor)
    j_write_nnet(str(tmp_path / "j.nnet"), host, cfg)
    assert read(tmp_path / "j.nnet") == read(tmp_path / "init.nnet")
    # seeded: the blob holds the same draw
    blob_params, _ = tcli.load_model(str(tmp_path / "init.pt"))
    for a, b in zip(tcli.tree_leaves(blob_params), tcli.tree_leaves(params)):
        assert torch.equal(a, b)


def test_analyze_counts_and_compute_wer(tmp_path, model):
    jd, td, _, _ = both(tmp_path, lambda d: [
        "analyze-counts", f"ark:{model}/l.ark", f"{d}/c.txt",
        "--num-targets", str(V)])
    assert read(td / "c.txt") == read(jd / "c.txt")
    ref, hyp = tmp_path / "ref", tmp_path / "hyp"
    ref.write_text("a x y z\nb p q\nc r\n")
    hyp.write_text("a x z z w\nb p q\n")
    for mode in ("present", "all"):
        _, _, jo, to = both(tmp_path, lambda d: [
            "compute-wer", "--mode", mode, str(ref), str(hyp)])
        assert to == jo and "WER" in to


# --------------------------------------------------------------------------
# the port's own shell pipeline (tests/test_cli_pipeline.py, not slow)
# --------------------------------------------------------------------------

def test_port_pipeline(tmp_path, langs):
    _, tl, _ = langs
    lang = tcli.load_pickle(str(tl / "lang.pkl"), "lang")
    wpath, gpath = str(tl / "words.txt"), str(tl / "tlg.pkl")
    rng = np.random.default_rng(0)
    unit_ids = {u: lang.tokens[u] - 1 for u in UNITS}
    words_of = dict(LEXICON)
    vocab = [w for w, _ in LEXICON]
    utts, texts, labs = {}, {}, {}
    for i in range(12):
        ws = [vocab[int(j)] for j in rng.integers(0, len(vocab), 2)]
        k = f"u{i:02d}"
        labs[k] = np.asarray([unit_ids[p] for w in ws for p in words_of[w]],
                             np.int32)
        utts[k] = _synth_utt(rng, labs[k])
        texts[k] = ws
    keys = sorted(utts)
    tr, cv = keys[:9], keys[9:]
    for name, ks in (("tr", tr), ("cv", cv)):
        write_ark(str(tmp_path / f"{name}_f.ark"), ((k, utts[k]) for k in ks))
        write_ark(str(tmp_path / f"{name}_l.ark"), ((k, labs[k]) for k in ks))
    model, counts = str(tmp_path / "model.pt"), str(tmp_path / "counts")
    rc, msg = run(tmain, [
        "train", f"ark:{tmp_path}/tr_f.ark", f"ark:{tmp_path}/tr_l.ark",
        f"ark:{tmp_path}/cv_f.ark", f"ark:{tmp_path}/cv_l.ark", model,
        "--num-targets", str(V), "--cell-dim", "24", "--num-layers", "1",
        "--optimizer", "adagrad", "--learn-rate", "0.02",
        "--max-iters", "8", "--min-iters", "6", "--num-sequence", "9",
        "--report-step", "1000", "--label-counts", counts,
    ])
    assert rc == 0 and msg.startswith("train: ")
    params, cfg = tcli.load_model(model)
    assert cfg.num_targets == V and cfg.cell_dim == 24
    assert all(not p.is_cuda for p in tcli.tree_leaves(params))
    np.testing.assert_array_equal(
        np.loadtxt(counts),
        j_counts([labs[k] for k in tr], V))

    post = str(tmp_path / "post.ark")
    assert tmain(["net-output-extract", model, f"ark:{tmp_path}/cv_f.ark",
                  f"ark:{post}"]) == 0
    common = ["--acoustic-scale", "0.9", "--beam", "20", "--max-active",
              "256", "--words", wpath]
    hyp, lat_ark = str(tmp_path / "hyp.txt"), str(tmp_path / "lat.ark")
    assert tmain(["latgen", *common, "--lattice-ark", lat_ark, "--binary",
                  gpath, f"ark:{post}", hyp]) == 0
    hyps = text_lines(hyp)
    assert [l.split()[0] for l in hyps] == cv
    for name, extra in (("skip", ["--blank-skip", "0.9"]),
                        ("stream", ["--streaming", "--chunk-frames", "16"])):
        out = str(tmp_path / f"{name}.txt")
        assert tmain(["latgen", *common, *extra, gpath, f"ark:{post}",
                      out]) == 0
        assert text_lines(out) == hyps, name
    dense = str(tmp_path / "dense.txt")
    assert tmain(["decode-faster", "--acoustic-scale", "0.9", "--words",
                  wpath, gpath, f"ark:{post}", dense]) == 0
    assert text_lines(dense) == hyps
    lat_txt, bp = str(tmp_path / "lat.txt"), str(tmp_path / "bp.txt")
    assert tmain(["lattice-copy", lat_ark, lat_txt]) == 0
    assert tmain(["lattice-best-path", lat_txt, "--out", bp, "--words",
                  wpath, "--acoustic-scale", "0.9"]) == 0
    assert text_lines(bp) == hyps
    ref = tmp_path / "ref.txt"
    ref.write_text("".join(f"{k} {' '.join(texts[k])}\n" for k in cv))
    rc, report = run(tmain, ["compute-wer", str(ref), hyp])
    assert rc == 0 and "WER" in report


def test_train_ce_on_frame_labels(tmp_path):
    """train --loss ce (train-ce-parallel): one frame-aligned label per
    frame (BatchConfig(frame_labels=True)); a model blob on CPU tensors."""
    rng = np.random.default_rng(4)
    feats = {f"u{i}": rng.standard_normal((12 + i, 6)).astype(np.float32)
             for i in range(6)}
    labels = {k: rng.integers(0, V, len(v)).astype(np.int32)
              for k, v in feats.items()}
    for name, keys in (("tr", ["u0", "u1", "u2", "u3"]), ("cv", ["u4", "u5"])):
        write_ark(str(tmp_path / f"{name}_f.ark"),
                  ((k, feats[k]) for k in keys))
        write_ark(str(tmp_path / f"{name}_l.ark"),
                  ((k, labels[k]) for k in keys))
    model = str(tmp_path / "ce.pt")
    rc, msg = run(tmain, [
        "train", "--loss", "ce", f"ark:{tmp_path}/tr_f.ark",
        f"ark:{tmp_path}/tr_l.ark", f"ark:{tmp_path}/cv_f.ark",
        f"ark:{tmp_path}/cv_l.ark", model, "--num-targets", str(V),
        "--cell-dim", "8", "--num-layers", "1", "--max-iters", "2",
        "--num-sequence", "4", "--optimizer", "adagrad",
        "--learn-rate", "0.05", "--report-step", "1000",
    ])
    assert rc == 0 and msg.startswith("train: 2 epochs")
    params, cfg = tcli.load_model(model)
    assert cfg.num_targets == V and not any(
        p.is_cuda for p in tcli.tree_leaves(params))
