"""The port's host copies of the lattice stack (eesen_tpu_torch/decoder/
{lattice,clat,lattice_io,sausages,rescore,const_arpa}) against the JAX
package's on the same inputs: lattices rebuilt from both packages'
searches on the CPU (the `decoded` fixture of tests/test_lattice.py),
the seeded random lattices of tests/test_clat.py, MBR, archives in both
directions, and LM rescoring.  Lattices are compared by what does not
depend on state numbering (paths, words, costs), archives byte for
byte."""

import dataclasses
import io
import random
import types
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest

from eesen_tpu.decoder import arpa as jarpa
from eesen_tpu.decoder import beam as jbeam
from eesen_tpu.decoder import clat as jclat
from eesen_tpu.decoder import const_arpa as jconst
from eesen_tpu.decoder import ctc_graph as jctc
from eesen_tpu.decoder import lattice as jlat
from eesen_tpu.decoder import lattice_io as jio
from eesen_tpu.decoder import rescore as jres
from eesen_tpu.decoder import sausages as jsaus
from eesen_tpu.decoder.graph_compile import compile_graph
from eesen_tpu.recipes.lm import estimate_ngram_arpa
from eesen_tpu_torch.decoder import arpa as tarpa
from eesen_tpu_torch.decoder import beam as tbeam
from eesen_tpu_torch.decoder import clat as tclat
from eesen_tpu_torch.decoder import const_arpa as tconst
from eesen_tpu_torch.decoder import ctc_graph as tctc
from eesen_tpu_torch.decoder import lattice as tlat
from eesen_tpu_torch.decoder import lattice_io as tio
from eesen_tpu_torch.decoder import rescore as tres
from eesen_tpu_torch.decoder import sausages as tsaus

from tests.test_align_mbr import make_two_path_lattice
from tests.test_beam import synth_loglikes
from tests.test_clat import _clat_paths, _enumerate_paths, _random_lattice
from tests.test_ctc_graph import ARPA, LEXICON, UNITS
from tests.test_lattice_io import make_lat
from tests.test_torch_beam import to_port_graph

# each package's LM-side modules under one name
JAX, PORT = (
    types.SimpleNamespace(lattice=lat, rescore=re, const_arpa=ca, arpa=ar,
                          ctc_graph=cg)
    for lat, re, ca, ar, cg in ((jlat, jres, jconst, jarpa, jctc),
                                (tlat, tres, tconst, tarpa, tctc))
)

# the same host code on the same numbers: costs agree to float rounding
# of the searches' f32 scores (the lattices' own arithmetic is equal)
COST_TOL = 1e-5
ACWTS = (0.5, 0.9, 1.3)


def to_port(obj):
    """A JAX-package Lattice or CompactLattice as the port's, state for
    state."""
    if isinstance(obj, jclat.CompactLattice):
        out = tclat.CompactLattice()
        out.arcs = [[tclat.CompactArc(**dataclasses.asdict(a)) for a in arcs]
                    for arcs in obj.arcs]
    else:
        out = tlat.Lattice()
        out.arcs = [[tlat.LatticeArc(**dataclasses.asdict(a)) for a in arcs]
                    for arcs in obj.arcs]
        out.state_frame = list(obj.state_frame)
    out.finals, out.start = dict(obj.finals), obj.start
    return out


@pytest.fixture(scope="module")
def decoded():
    """tests/test_lattice.py's utterance searched by both packages on the
    CPU; each package rebuilds its lattice from its own outputs."""
    lang = jctc.compile_lang(LEXICON, UNITS, dict_type="phn")
    g_fst = jarpa.arpa_to_fst(ARPA, lang.words)
    g = compile_graph(
        jctc.build_tlg(lang.t_fst, jctc.build_lg(lang.l_fst, g_fst)),
        max_degree=8)
    ll = synth_loglikes(np.random.default_rng(3), lang,
                        ["a", "<blk>", "b", "<blk>", "b", "a"], t_per=2,
                        noise=0.5)
    cfg = dict(beam=1e9, max_active=128, acoustic_scale=0.9)
    jout = jbeam.make_beam_decoder(
        g, jbeam.BeamSearchConfig(pallas_dedup="never", **cfg))(
        jnp.asarray(ll[None]), jnp.asarray([len(ll)]),
        jbeam.DeviceGraph.put(g))
    tg = to_port_graph(g)
    tout = tbeam.make_beam_decoder(tg, tbeam.BeamSearchConfig(**cfg))(
        ll[None], np.array([len(ll)], np.int32),
        tbeam.DeviceGraph.put(tg, device="cpu")).numpy()

    def lattices():
        return (jlat.lattice_from_beam(jout, 0, len(ll), g, ll, 0.9),
                tlat.lattice_from_beam(tout, 0, len(ll), tg, ll, 0.9))

    return lattices


def _best(lat):
    ils, ols, cost = lat.best_path()
    return list(ols), cost


LATTICE_OPS = {
    "best_path": _best,
    "scale_0.5": lambda lat: (lat.scale(acoustic_scale=0.5), _best(lat))[1],
    "nbest": lambda lat: lat.nbest(4),
    "word_times": lambda lat: lat.word_times(),
    "prune": lambda lat: (lat.prune(2.0), _best(lat),
                          sorted(w for w, _, _, _ in lat.posterior_arcs())),
    "add_penalty": lambda lat: (lat.add_penalty(0.5), _best(lat))[1],
    "posterior_arcs": lambda lat: sorted(lat.posterior_arcs()),
}


def _assert_close(got, want):
    """Equal structure; floats within COST_TOL."""
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_close(g, w)
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=COST_TOL, abs=COST_TOL)
    else:
        assert got == want


@pytest.mark.parametrize("op", sorted(LATTICE_OPS))
def test_lattice_ops_match_jax(decoded, op):
    jl, tl = decoded()
    assert tl.num_states > 2 and tl.num_arcs > 0
    _assert_close(LATTICE_OPS[op](tl), LATTICE_OPS[op](jl))


@pytest.mark.parametrize("acwt", ACWTS)
def test_determinized_best_path_matches_jax(decoded, acwt):
    """The recipe's pipeline (prune, determinize, unscale by 1/acwt) and
    the best path at another acwt: the JAX package's words and cost, and
    compact_to_lattice keeps them."""
    best = []
    for mod, lat in zip((jclat, tclat), decoded()):
        lat.prune(8.0)
        clat = mod.determinize_lattice_pruned(lat, lattice_beam=8.0)
        sc = clat.scaled(1.0 / 0.9).scaled(acwt)
        _, words, cost = sc.best_path()
        _, lwords, lcost = mod.compact_to_lattice(sc).best_path()
        assert lwords == words and lcost == pytest.approx(cost)
        best.append((list(words), cost))
    assert best[1][0] and best[1][0] == best[0][0]
    assert best[1][1] == pytest.approx(best[0][1], rel=COST_TOL)


def _push(mod, clat):
    mod.push_strings(clat)
    mod.push_weights(clat)
    return clat


CLAT_OPS = {
    "determinize": lambda mod, clat: clat,
    "push_strings": lambda mod, clat: (mod.push_strings(clat), clat)[1],
    "push_weights": lambda mod, clat: (mod.push_weights(clat), clat)[1],
    "minimize": lambda mod, clat: mod.minimize(_push(mod, clat)),
    "prune": lambda mod, clat: (clat.prune(3.0), clat)[1],
    "compact_to_lattice": lambda mod, clat: mod.lattice_to_compact(
        mod.compact_to_lattice(clat)),
}


# tests/test_clat.py's seeds whose random lattice has a complete path
SEEDS = [s for s in range(8)
         if _enumerate_paths(_random_lattice(random.Random(s)))]


@pytest.mark.parametrize("op", sorted(CLAT_OPS))
@pytest.mark.parametrize("seed", SEEDS)
def test_random_lattices_match_jax(seed, op):
    """tests/test_clat.py's seeded random lattices: the same complete
    paths (words, ilabel strings, graph and acoustic costs) after each
    CompactLattice operation, and the same sentence confidence."""
    lat = _random_lattice(random.Random(seed))
    got = []
    for mod, src in ((jclat, lat), (tclat, to_port(lat))):
        clat = mod.determinize_lattice_pruned(src, lattice_beam=1e9)
        clat = CLAT_OPS[op](mod, clat)
        got.append((sorted(_clat_paths(clat)),
                    mod.sentence_confidence_lattice(src)))
    assert got[1] == got[0]


@pytest.mark.parametrize("source", ["two_path", "decoded"])
def test_mbr_matches_jax(decoded, source):
    """minimum_bayes_risk and its CTM on tests/test_align_mbr.py's
    two-path lattice (the majority word at 0.8) and on the search's
    lattice."""
    if source == "two_path":
        jl = make_two_path_lattice(0.8)
        tl = to_port(jl)
    else:
        jl, tl = decoded()
    jr, tr = jsaus.minimum_bayes_risk(jl), tsaus.minimum_bayes_risk(tl)
    assert tr.words == jr.words and tr.times == jr.times
    _assert_close(tr.confidences, jr.confidences)
    _assert_close([[w for w, _ in b] for b in tr.sausage],
                  [[w for w, _ in b] for b in jr.sausage])
    if source == "two_path":
        assert tr.words == [10, 12]
        assert tr.confidences[0] == pytest.approx(0.8, rel=1e-3)
        assert tsaus.sausage_to_ctm(tr) == jsaus.sausage_to_ctm(jr)


def _archive_items(jmod_clat, lat_mod):
    lat = make_lat() if lat_mod is jlat else to_port(make_lat())
    return [("utt1", lat),
            ("utt2", jmod_clat.determinize_lattice_pruned(lat,
                                                         lattice_beam=20.0))]


@pytest.mark.parametrize("binary", [False, True], ids=["text", "binary"])
def test_lattice_archives_match_jax(tmp_path, binary):
    """A Lattice and a CompactLattice in one archive: the same bytes from
    both packages, and each package reads the other's archive back to
    the same bytes."""
    paths = {}
    for name, io_mod, items in (
            ("jax", jio, _archive_items(jclat, jlat)),
            ("port", tio, _archive_items(tclat, tlat))):
        paths[name] = str(tmp_path / f"{name}.ark")
        io_mod.write_lattice_ark(paths[name], iter(items), binary=binary)
    raw = {k: open(p, "rb").read() for k, p in paths.items()}
    assert raw["port"] == raw["jax"]
    for reader, writer_of in ((tio, "jax"), (jio, "port")):
        back = list(reader.read_lattice_ark(paths[writer_of]))
        assert [k for k, _ in back] == ["utt1", "utt2"]
        assert isinstance(back[1][1], (tclat if reader is tio
                                       else jclat).CompactLattice)
        again = str(tmp_path / "again.ark")
        reader.write_lattice_ark(again, iter(back), binary=binary)
        assert open(again, "rb").read() == raw["jax"]


def test_compact_lattice_text_matches_jax():
    text = []
    for mod, io_mod, lat in ((jclat, jio, make_lat()),
                             (tclat, tio, to_port(make_lat()))):
        buf = io.StringIO()
        io_mod.write_compact_lattice_text(
            mod.determinize_lattice_pruned(lat, lattice_beam=20.0), buf)
        text.append(buf.getvalue())
    assert text[1] == text[0]
    back = tio.read_compact_lattice_text(text[0].splitlines())
    assert back.best_path() == jio.read_compact_lattice_text(
        text[0].splitlines()).best_path()


def _ngram(order):
    """tests/test_const_arpa.py's seeded n-gram over 8 words."""
    rng = np.random.default_rng(0)
    vocab = [f"w{i}" for i in range(8)]
    sents = []
    for _ in range(100):
        n, start = int(rng.integers(3, 9)), int(rng.integers(0, 8))
        sents.append([vocab[(start + 3 * k) % 8] for k in range(n)])
    arpa = estimate_ngram_arpa(sents, order=order, vocab=vocab,
                               min_counts=(1,) * order)
    return vocab, arpa


@pytest.mark.parametrize("order", [2, 3])
def test_const_arpa_files_match_jax(tmp_path, order):
    """ConstArpa.save: the same arrays, byte for byte in every member of
    the .npz (the zip's timestamps aside); each package loads the other's
    file and scores a seeded word stream the same."""
    vocab, arpa = _ngram(order)
    tries = {name: pkg.const_arpa.ConstArpa.from_arpa(
        arpa, pkg.ctc_graph.make_word_table(vocab))
        for name, pkg in (("jax", JAX), ("port", PORT))}
    members = {}
    for name, trie in tries.items():
        path = str(tmp_path / f"{name}.npz")
        trie.save(path)
        with zipfile.ZipFile(path) as z:
            members[name] = {n: z.read(n) for n in z.namelist()}
    assert members["port"] == members["jax"]
    words = jctc.make_word_table(vocab)
    stream = [words[vocab[i]]
              for i in np.random.default_rng(1).integers(0, 8, 40)]
    scores = []
    for mod, other in ((tconst, "jax"), (jconst, "port")):
        trie = mod.ConstArpa.load(str(tmp_path / f"{other}.npz"), mmap=False)
        s, out = trie.start, []
        for w in stream:
            c, s = trie.score(s, w)
            out.append(c)
        scores.append(out + [trie.final(s)])
    assert scores[0] == scores[1]


@pytest.mark.parametrize("lm", ["lm_automaton", "const_arpa"])
def test_rescore_matches_jax(lm):
    """rescore_lattice on tests/test_const_arpa.py's four-state lattice
    with the bigram as an LmAutomaton and as a ConstArpa: the JAX
    package's rescored best path."""
    vocab, arpa = _ngram(2)
    best = []
    for pkg in (JAX, PORT):
        words = pkg.ctc_graph.make_word_table(vocab)
        if lm == "const_arpa":
            auto = pkg.const_arpa.ConstArpa.from_arpa(arpa, words)
        else:
            auto = pkg.rescore.LmAutomaton(pkg.arpa.arpa_to_fst(arpa, words),
                                           backoff_ilabel=words["#0"])
        lat = pkg.lattice.Lattice()
        for f in range(4):
            lat.add_state(f)
        w1, w2, w3 = (words[vocab[i]] for i in (0, 3, 6))
        arc = pkg.lattice.LatticeArc
        lat.arcs[0] += [arc(1, w1, 0.5, 1.0, 1), arc(2, w2, 0.6, 0.9, 1)]
        lat.arcs[1] += [arc(3, w3, 0.2, 1.1, 2), arc(4, 0, 0.1, 0.2, 3)]
        lat.finals.update({2: 0.0, 3: 0.3})
        best.append(pkg.rescore.rescore_lattice(
            lat, auto, lm_scale_new=0.8).best_path())
    assert best[1] == best[0]
    assert best[1][1]
