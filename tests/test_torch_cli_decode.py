"""The port's decode and alignment commands (eesen_tpu_torch/tools/cli.py:
net-output-extract, align, latgen offline / blank-skip / streaming /
lattices, decode-faster, and the lattice archive tools) on the CPU
(`--device cpu`) against the JAX package's, on the same inputs: the toy
graph of tests/test_torch_cli.py built by each package's own build-tlg,
its one-layer f32 model, and peaked posteriors of five utterances."""

import numpy as np
import pytest

from eesen_tpu.decoder.lattice_io import read_lattice_ark as j_read_lats
from eesen_tpu.io.kaldi_io import write_ark
from eesen_tpu.tools.cli import main as jmain
from eesen_tpu_torch.tools import cli as tcli

from tests.test_beam import synth_loglikes
from tests.test_torch_cli import (  # noqa: F401  (module fixtures)
    ark, both, langs, model, read, text_lines, tmain,
)

LP_ATOL = 1e-5               # net-output-extract in float32, both packages

# --------------------------------------------------------------------------
# decode and alignment commands
# --------------------------------------------------------------------------

def test_net_output_extract(tmp_path, model):
    for priors in ([], [f"--class-frame-counts={model}/counts",
                        "--prior-scale", "0.8", "--blank-scale", "0.5"]):
        outs = []
        for main, m in ((jmain, "m.pkl"), (tmain, "m.pt")):
            out = tmp_path / f"{m}.ark"
            assert main(["net-output-extract", *priors, str(model / m),
                         f"ark:{model}/f.ark", f"ark:{out}"]) == 0
            outs.append(ark(out))
        want, got = outs
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=LP_ATOL)


def test_align(tmp_path, model):
    outs = []
    for main, m in ((jmain, "m.pkl"), (tmain, "m.pt")):
        out = tmp_path / f"{m}.ali"
        assert main(["align", str(model / m), f"ark:{model}/f.ark",
                     f"ark:{model}/l.ark", str(out)]) == 0
        outs.append(text_lines(out))
    assert outs[1] == outs[0] and len(outs[0]) == 4


@pytest.fixture(scope="module")
def posts(tmp_path_factory, langs):
    """Peaked log-posteriors of five toy utterances (unequal lengths) as
    an ark, the words table, and both packages' graphs."""
    jl, tl, _ = langs
    lang = tcli.load_pickle(str(tl / "lang.pkl"), "lang")
    d = tmp_path_factory.mktemp("posts")
    rng = np.random.default_rng(11)
    seqs = [["a", "<blk>", "b", "<blk>", "b", "a"], ["a", "a", "b", "c"],
            ["b", "a", "<blk>", "a", "b"], ["c", "<blk>", "b", "a", "a"],
            ["a", "b", "<blk>", "b", "a", "<blk>", "a", "b", "c"]]
    lls = {f"p{i}": np.concatenate([
        synth_loglikes(rng, lang, ["<blk>"] + s + ["<blk>"], t_per=2,
                       noise=0.8)]) for i, s in enumerate(seqs)}
    write_ark(str(d / "post.ark"), lls.items())
    return {"ark": f"ark:{d}/post.ark", "words": str(tl / "words.txt"),
            "jg": str(jl / "tlg.pkl"), "tg": str(tl / "tlg.pkl")}


LATGEN = ["--beam", "20", "--max-active", "64", "--batch-size", "3"]


@pytest.fixture(scope="module")
def lats(tmp_path_factory, posts):
    """Offline latgen --lattice-ark of both packages: the best-path text
    and the text lattice archive."""
    d = tmp_path_factory.mktemp("lats")
    for name, main, g in (("jax", jmain, posts["jg"]),
                          ("port", tmain, posts["tg"])):
        assert main(["latgen", *LATGEN, "--words", posts["words"],
                     "--lattice-ark", str(d / f"{name}.lat"),
                     "--lattice-beam", "6", g, posts["ark"],
                     str(d / f"{name}.txt")]) == 0
    return d


def test_latgen_offline_and_lattices(lats):
    assert read(lats / "port.txt") == read(lats / "jax.txt")
    hyps = text_lines(lats / "jax.txt")
    assert len(hyps) == 5 and all(len(l.split()) > 1 for l in hyps)
    assert read(lats / "port.lat") == read(lats / "jax.lat")
    n = [lat.num_states for _, lat in j_read_lats(str(lats / "jax.lat"))]
    assert len(n) == 5 and max(n) > 2


@pytest.mark.parametrize("mode", [
    ["--blank-skip", "0.9"],
    ["--streaming", "--chunk-frames", "8", "--batch-size", "5"],
], ids=["blank_skip", "streaming"])
def test_latgen_modes(tmp_path, posts, lats, mode):
    """Each package's blank-skip and streaming decodes, and the offline
    words on these blank-separated posteriors."""
    outs = []
    for main, g in ((jmain, posts["jg"]), (tmain, posts["tg"])):
        out = tmp_path / f"{len(outs)}.txt"
        assert main(["latgen", *LATGEN, *mode, "--words", posts["words"],
                     g, posts["ark"], str(out)]) == 0
        outs.append(text_lines(out))
    assert outs[1] == outs[0] == text_lines(lats / "jax.txt")


def test_decode_faster(tmp_path, posts, lats):
    outs = []
    for main, g in ((jmain, posts["jg"]), (tmain, posts["tg"])):
        out = tmp_path / f"{len(outs)}.txt"
        assert main(["decode-faster", "--in-degree", "4", "--batch-size",
                     "2", "--words", posts["words"], g, posts["ark"],
                     str(out)]) == 0
        outs.append(text_lines(out))
    assert outs[1] == outs[0]
    # exact Viterbi: the wide beam's words
    assert outs[1] == text_lines(lats / "jax.txt")


LATTICE_CMDS = [
    (["lattice-scale", "--acoustic-scale", "0.5", "--lm-scale", "2"], True),
    (["lattice-prune", "--beam", "3"], True),
    (["lattice-add-penalty", "--word-ins-penalty", "0.5"], True),
    (["lattice-copy", "--binary"], True),
    (["lattice-1best", "--acoustic-scale", "0.9"], True),
    (["lattice-best-path", "--acoustic-scale", "0.9"], False),
    (["lattice-to-nbest", "--n", "3"], False),
    (["lattice-confidence", "--acoustic-scale", "0.9"], False),
    (["lattice-to-ctm-conf"], False),
    (["nbest-to-ctm"], False),
]


@pytest.mark.parametrize("argv,archive", LATTICE_CMDS,
                         ids=[c[0][0] for c in LATTICE_CMDS])
def test_lattice_commands(tmp_path, lats, posts, argv, archive):
    words = [] if argv[0] in ("lattice-scale", "lattice-prune",
                              "lattice-add-penalty", "lattice-copy",
                              "lattice-1best", "lattice-confidence") else [
        "--words", posts["words"]]
    src = str(lats / "jax.lat")
    if archive:
        jd, td, _, _ = both(tmp_path, lambda d: [
            argv[0], src, f"{d}/o.lat", *argv[1:]])
        assert read(td / "o.lat") == read(jd / "o.lat")
    else:
        jd, td, _, _ = both(tmp_path, lambda d: [
            argv[0], src, "--out", f"{d}/o.txt", *argv[1:], *words])
        assert read(td / "o.txt") == read(jd / "o.txt")
        assert len(text_lines(td / "o.txt")) >= 5


def test_lattice_rescore(tmp_path, lats, langs):
    jl, _, arpa = langs
    words = str(jl / "words.txt")
    assert jmain(["arpa-to-const-lm", arpa, words,
                  str(tmp_path / "lm.npz")]) == 0
    for lm in (str(tmp_path / "lm.npz"), arpa):
        jd, td, _, _ = both(tmp_path, lambda d: [
            "lattice-rescore", str(lats / "jax.lat"), lm, f"{d}/r.lat",
            "--words", words, "--lm-scale", "0.5", "--old-graph-scale",
            "1.0"])
        assert read(td / "r.lat") == read(jd / "r.lat")


