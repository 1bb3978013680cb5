"""The end-to-end examples (eesen_tpu_torch/examples/) against the JAX
package's scripts (examples/*.py) on the CPU.

The host stages of the stress run are the JAX script's bytes: the text
process, the sentences, the lexicon with its homophones and OOVs and the
synthesized waves, from a subprocess that loads examples/stress_recipe.py
(its jax.config updates stay in that process).  A reduced stress run on
the CPU (VOCAB, HOMOPHONES and OOV_WORDS shrunk with monkeypatch, a 1 x
32 model for one epoch) passes its own parity battery, and its ARPA and
TLG arrays equal what the JAX package's estimate_ngram_arpa and
build_full_compiled give.  The toy and flagship recipes run through to a
WER with fewer training repeats.

    python -m tests.test_torch_examples full-tlg OUT.json

builds the full stress run's trigram TLG (24,000 training sentences and
200,000 LM sentences, 20,000 words) with the JAX package's host functions
and writes its state and arc counts and the sha256 of each array of its
saved .npz (minutes of CPU and a few GB of memory; not a test).
"""

import ast
import gzip
import hashlib
import json
import math
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_STRESS = ROOT / "examples" / "stress_recipe.py"

# Both packages' synthesis seeds each speaker from Python's str hash,
# salted per interpreter (recipes/synth_corpus.py speaker_seed), so both
# sides run in fresh interpreters with one PYTHONHASHSEED.
HASH_SEED = "0"


def run_python(args, **kw):
    """`python args` from the repo root with PYTHONHASHSEED fixed."""
    res = subprocess.run(
        [sys.executable, *args], cwd=str(ROOT), capture_output=True,
        timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT),
                          "PYTHONHASHSEED": HASH_SEED}, **kw)
    assert res.returncode == 0, res.stderr[-3000:]
    return res


# the JAX script's main: the synthesis pool runs in-process (a fork of a
# process that imported jax may hang), the bench cache under the workdir
JAX_SIDE = r"""
import importlib.util, sys, types
import numpy as np

script, work, out = sys.argv[1:4]
spec = importlib.util.spec_from_file_location("jax_stress_recipe", script)
m = importlib.util.module_from_spec(spec)
spec.loader.exec_module(m)


class InProcessPool:
    def __init__(self, procs, initializer, initargs):
        initializer(*initargs)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def imap_unordered(self, fn, items):
        return map(fn, items)


m.multiprocessing = types.SimpleNamespace(Pool=InProcessPool)
m.BENCH_GRAPH_CACHE = work + "/bench/tlg_stress.npz"
sys.argv = ["stress_recipe.py", work, *sys.argv[4:]]
m.main()
succ, slot_p = m.build_text_process(m.VOCAB, np.random.default_rng(11))
sents = m.sample_sentences(40, succ, slot_p, m.VOCAB,
                           np.random.default_rng(12))
short = m.sample_sentences(25, succ, slot_p, m.VOCAB,
                           np.random.default_rng(13), min_w=1, max_w=3)
np.savez(out, succ=succ, slot_p=slot_p,
         sents=np.concatenate(sents), sent_lens=[len(s) for s in sents],
         short=np.concatenate(short), short_lens=[len(s) for s in short])
"""
SYNTH_ARGS = ["--utts", "6", "--cv", "2", "--eval", "4", "--lm-sents", "0",
              "--stop-after", "synth"]


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX script's lexicon.pkl, waves.npz and text-process arrays at
    the full 20,000-word vocabulary."""
    work = tmp_path_factory.mktemp("jax_stress")
    out = work / "text.npz"
    run_python(["-c", JAX_SIDE, str(JAX_STRESS), str(work), str(out),
                *SYNTH_ARGS])
    return work, dict(np.load(out))


@pytest.fixture(scope="module")
def port_side(tmp_path_factory):
    """The port's command line on the same arguments on the CPU (its
    synthesis in a spawned pool)."""
    work = tmp_path_factory.mktemp("port_stress")
    res = run_python(["-m", "eesen_tpu_torch.examples.stress_recipe",
                      str(work), *SYNTH_ARGS, "--device", "cpu"], text=True)
    return work, res.stdout


def _split(flat, lens):
    return [list(s) for s in np.split(flat, np.cumsum(lens)[:-1])]


def _host_case(case, jax_side, port_side):
    """(JAX value, port value) of one host stage."""
    from eesen_tpu_torch.examples import stress_recipe as sr

    jwork, jtext = jax_side
    pwork, _ = port_side
    if case in ("text_process", "sentences", "short_sentences"):
        succ, slot_p = sr.build_text_process(sr.VOCAB,
                                             np.random.default_rng(11))
        if case == "text_process":
            return ((jtext["succ"].tobytes(), jtext["slot_p"].tobytes()),
                    (succ.tobytes(), slot_p.tobytes()))
        if case == "sentences":
            got = sr.sample_sentences(40, succ, slot_p, sr.VOCAB,
                                      np.random.default_rng(12))
            want = _split(jtext["sents"], jtext["sent_lens"])
        else:
            got = sr.sample_sentences(25, succ, slot_p, sr.VOCAB,
                                      np.random.default_rng(13), 1, 3)
            want = _split(jtext["short"], jtext["short_lens"])
        assert all(s.dtype == np.int32 for s in got)
        return want, [list(s) for s in got]
    if case in ("lexicon", "homophones_and_oovs"):
        jlex = (jwork / "lexicon.pkl").read_bytes()
        plex = (pwork / "lexicon.pkl").read_bytes()
        if case == "lexicon":
            return jlex, plex
        synth, decode, oov = pickle.loads(plex)
        prons = [p for _, p in decode]
        n_homophone_words = len(prons) - len(set(prons))
        return ((sr.VOCAB, sr.HOMOPHONES, sr.OOV_WORDS),
                (len(decode), n_homophone_words, len(oov)))
    jw, pw = np.load(jwork / "waves.npz"), np.load(pwork / "waves.npz")
    return ({k: jw[k].tobytes() for k in jw.files},
            {k: pw[k].tobytes() for k in pw.files})


HOST_CASES = ["text_process", "sentences", "short_sentences", "lexicon",
              "homophones_and_oovs", "waves"]


@pytest.mark.parametrize("case", HOST_CASES)
def test_stress_host_stages_match_jax(case, jax_side, port_side):
    """Byte-identical host stages at the full vocabulary: 400 homophone
    pairs give 400 words whose pronunciation another word has (the
    prons make_lexicon draws are unique), 200 OOV synthesis words."""
    want, got = _host_case(case, jax_side, port_side)
    assert got == want


def test_stress_synthesis_pool_matches_jax_workers(jax_side):
    """The port's spawned pool over several chunks gives the JAX
    script's worker outputs, chunk for chunk (seed 1000 + the chunk's
    first index): the workers take the parent's speaker seeds, so each
    speaker keeps one voice across chunks as under the JAX script's
    forked pool."""
    from eesen_tpu_torch.examples import stress_recipe as sr
    from eesen_tpu_torch.recipes.synth_corpus import SynthConfig, make_phones

    jwork, _ = jax_side
    synth, _, _ = pickle.loads((jwork / "lexicon.pkl").read_bytes())
    scfg = SynthConfig(num_phones=40, num_words=sr.VOCAB + sr.OOV_WORDS,
                       num_speakers=64, snr_db=15.0, seed=3)
    phones = make_phones(scfg, np.random.default_rng(scfg.seed))
    rng = np.random.default_rng(7)
    texts = {f"spk{i % 3:03d}_u{i:02d}": [synth[int(j)][0] for j in
                                         rng.integers(0, len(synth), 3)]
             for i in range(5)}
    spk = {k: k.split("_")[0] for k in texts}
    inputs = pickle.dumps((scfg, texts, spk, synth, phones))
    got = pickle.loads(run_python(["-c", PORT_POOL], input=inputs).stdout)
    want = pickle.loads(run_python(["-c", JAX_WORKERS, str(JAX_STRESS)],
                                   input=inputs).stdout)
    assert sorted(got) == sorted(want) == sorted(texts)
    assert all(got[k].dtype == np.int16 for k in got)
    assert {k: v.tobytes() for k, v in got.items()} == \
        {k: v.tobytes() for k, v in want.items()}


# the JAX script's chunking and workers, in-process, on pickled inputs
JAX_WORKERS = r"""
import importlib.util, pickle, sys
spec = importlib.util.spec_from_file_location("jax_stress_recipe", sys.argv[1])
m = importlib.util.module_from_spec(spec)
spec.loader.exec_module(m)
scfg, texts, spk, synth, phones = pickle.load(sys.stdin.buffer)
m._synth_init(scfg, synth, phones, (8.0, 25.0))
keys = sorted(texts)
waves = {}
for i in range(0, len(keys), 2):
    waves.update(m._synth_chunk((1000 + i, {k: texts[k] for k in keys[i:i + 2]},
                                 {k: spk[k] for k in keys[i:i + 2]})))
sys.stdout.buffer.write(pickle.dumps(waves))
"""
# the port's spawned pool, two processes over chunks of two utterances
PORT_POOL = r"""
import pickle, sys
from eesen_tpu_torch.examples import stress_recipe as sr
scfg, texts, spk, synth, phones = pickle.load(sys.stdin.buffer)
waves = sr.synth_parallel(scfg, texts, spk, synth, phones, (8.0, 25.0),
                          procs=2, chunk=2)
sys.stdout.buffer.write(pickle.dumps(waves))
"""


# ---------------------------------------------------------------------
# the reduced stress run on the CPU
# ---------------------------------------------------------------------

REDUCED = dict(VOCAB=600, HOMOPHONES=20, OOV_WORDS=20)
REDUCED_ARGS = ["--utts", "48", "--cv", "8", "--eval", "8",
                "--lm-sents", "2000", "--device", "cpu"]


def small_model(sr, mp):
    """The recipe's 4 x 320 cut to 1 x 32 and its newbob schedule to one
    epoch, so the CPU's plain versions train in seconds."""
    model, newbob = sr.AcousticModelConfig, sr.NewbobConfig
    mp.setattr(sr, "AcousticModelConfig", lambda **kw: model(
        **{**kw, "cell_dim": 32, "num_layers": 1}))
    mp.setattr(sr, "NewbobConfig", lambda **kw: newbob(
        **{**kw, "max_iters": 1, "min_iters": 1}))


@pytest.fixture(scope="module")
def reduced_run(tmp_path_factory):
    from eesen_tpu_torch.examples import stress_recipe as sr

    work = tmp_path_factory.mktemp("reduced_stress")
    results_md = (ROOT / "RESULTS.md").read_bytes()
    with pytest.MonkeyPatch.context() as mp:
        for name, value in REDUCED.items():
            mp.setattr(sr, name, value)
        small_model(sr, mp)
        mp.setattr(sr, "BENCH_GRAPH_CACHE",
                   str(work / "bench" / "tlg_stress.npz"))
        res = sr.main([str(work), *REDUCED_ARGS])
    assert (ROOT / "RESULTS.md").read_bytes() == results_md
    return work, res


def test_reduced_stress_parity_battery(reduced_run):
    """The run's own battery: the sweep at the decode acwt equals the
    direct re-decode (with the sweep's blank-skip setting), the blank-skip
    guard ran on its 6 utterances, the
    full and blank-skip decodes both ran, const-arpa rescoring agrees
    with the G-fst automaton on every sampled lattice."""
    work, res = reduced_run
    assert res["sweep_equals_direct"]
    assert res["sweep"][str(res["direct_decode_acwt"])] == \
        round(res["direct_wer"], 2)
    assert res["blank_skip_guard"]["ok"] is not None
    assert res["blank_skip_guard"]["checked"] == 6
    # the direct searches are the sweep's: skipping only where the guard
    # let the sweep skip
    assert res["direct_blank_skip"] == (
        0.98 if res["blank_skip_guard"]["ok"] else 0.0)
    assert math.isfinite(res["full_wer"]) and math.isfinite(
        res["blank_skip_wer"])
    assert res["const_arpa"]["rescore_parity"] == "8/8"
    assert sorted(res["sweep"]) == ["0.5", "0.6", "0.7", "0.8", "0.9", "1.0"]
    for name in ("synth", "features", "train", "lm", "g", "tlg",
                 "graph_put", "sweep", "direct", "direct_best",
                 "full_decode", "skip_decode", "const_arpa", "lattices",
                 "rescore"):
        assert res["stages"][name]["seconds"] >= 0.0, name
        assert res["stages"][name]["launches"] == {}, name   # CPU
    # span seconds beside the launches: the training loop's and the
    # search's own spans, within the stage's wall time
    spans = {name: rec["spans"] for name, rec in res["stages"].items()}
    assert {"train.input_copy", "train.step",
            "train.metrics_wait"} <= set(spans["train"])
    for name in ("full_decode", "skip_decode"):
        assert {"decode.search", "decode.frame",
                "decode.traceback"} <= set(spans[name]), name
        assert not any(k.startswith("train.") for k in spans[name]), name
    outer = ("train.input_copy", "train.step", "train.metrics_wait",
             "train.monitor", "decode.compact", "decode.search",
             "decode.traceback")                 # no one inside another
    for name, rec in res["stages"].items():
        assert sum(spans[name].get(k, 0.0) for k in outer) <= \
            rec["seconds"], name
    saved = json.loads((work / "results.json").read_text())
    assert saved["wer"] == res["wer"]
    assert saved["stages"]["train"]["spans"] == spans["train"]
    md = (work / "results.md").read_text()
    assert "## Stress corpus" in md and "EXACT" in md


def test_reduced_stress_lm_matches_jax(reduced_run):
    """The ARPA the port wrote is the JAX package's estimate_ngram_arpa
    of the same sentences (LM sentences from seed 13, then the training
    texts)."""
    from eesen_tpu.recipes.lm import estimate_ngram_arpa
    from eesen_tpu_torch.examples import stress_recipe as sr

    work, _ = reduced_run
    _, decode, _ = pickle.loads((work / "lexicon.pkl").read_bytes())
    words = [w for w, _ in decode]
    vocab = REDUCED["VOCAB"]
    succ, slot_p = sr.build_text_process(vocab, np.random.default_rng(11))

    def to_words(sents):
        return [[words[int(j)] for j in s] for s in sents]

    tr = to_words(sr.sample_sentences(48, succ, slot_p, vocab,
                                      np.random.default_rng(12)))
    lm = to_words(sr.sample_sentences(2000, succ, slot_p, vocab,
                                      np.random.default_rng(13)))
    want = estimate_ngram_arpa(lm + tr, order=3, vocab=words,
                               min_counts=(1, 2, 2))
    with gzip.open(work / "lm.arpa.gz", "rt") as f:
        assert f.read() == want


def test_reduced_stress_tlg_matches_jax(reduced_run):
    """tlg.npz holds, array for array, the JAX package's
    build_full_compiled of the run's ARPA over its lexicon."""
    from eesen_tpu.decoder.arpa import arpa_to_fst
    from eesen_tpu.decoder.ctc_graph import build_full_compiled, compile_lang

    work, res = reduced_run
    _, decode, _ = pickle.loads((work / "lexicon.pkl").read_bytes())
    units = [f"p{i:02d}" for i in range(40)]
    lang = compile_lang(decode + [("<UNK>", (units[0],))], units,
                        dict_type="phn")
    with gzip.open(work / "lm.arpa.gz", "rt") as f:
        g = arpa_to_fst(f.read(), lang.words)
    want = build_full_compiled(lang.t_fst, lang.l_fst, g,
                               build_closure=True)
    want.save(str(work / "jax_tlg.npz"))
    got, ref = np.load(work / "tlg.npz"), np.load(work / "jax_tlg.npz")
    assert sorted(got.files) == sorted(ref.files)
    for k in ref.files:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert res["graph"]["states"] == want.num_states
    assert res["graph"]["arcs"] == want.num_emit_arcs + want.num_eps_arcs


def test_reduced_stress_bench_cache(reduced_run):
    """The bench graph cache keeps the JAX script's format: the graph
    .npz and a _meta.npz of 512 pron rows (token ids, -1 padded) and the
    token count; the merges record the search's lane widths."""
    from eesen_tpu_torch.decoder.graph_compile import CompiledGraph
    from eesen_tpu_torch.ops import beam_cuda

    work, res = reduced_run
    g = CompiledGraph.load(str(work / "bench" / "tlg_stress.npz"))
    assert g.num_states == res["graph"]["states"]
    meta = np.load(work / "bench" / "tlg_stress_meta.npz")
    assert sorted(meta.files) == ["num_tokens", "prons"]
    assert meta["prons"].shape[0] == 512 and int(meta["num_tokens"]) == 40
    assert meta["prons"].dtype == np.int32
    assert ((meta["prons"] >= 1) | (meta["prons"] == -1)).all()
    merges = res["graph"]["merges"]
    assert merges["emit"]["lanes"] == 512 * g.max_emit_degree
    assert merges["closure"]["lanes"] == 512 * (1 + g.max_closure_degree)
    for m in merges.values():
        assert m["kernel"] == (beam_cuda.padded_width(m["lanes"])
                               <= beam_cuda.MAX_LANES)


def test_stop_after_synth_never_initialises_cuda(tmp_path):
    """A run that stops after synthesis returns before any stage that
    computes on the device; its stages record no launches."""
    import torch
    from eesen_tpu_torch.examples import stress_recipe as sr

    with pytest.MonkeyPatch.context() as mp:
        for name, value in REDUCED.items():
            mp.setattr(sr, name, value)
        res = sr.main([str(tmp_path), "--utts", "3", "--cv", "1", "--eval",
                       "1", "--stop-after", "synth", "--device", "cpu"])
    assert list(res["stages"]) == ["synth"]
    assert res["stages"]["synth"]["utts"] == 5
    assert not torch.cuda.is_initialized()
    assert (tmp_path / "waves.npz").exists()
    assert not (tmp_path / "exp").exists()


# ---------------------------------------------------------------------
# toy and flagship recipes
# ---------------------------------------------------------------------

def test_toy_recipe_runs_to_a_wer(tmp_path, monkeypatch, capsys):
    """The tone corpus through lang, features, newbob training (2 repeats
    an epoch instead of 40), TLG and the beam decode to a WER."""
    from eesen_tpu_torch.examples import toy_recipe

    monkeypatch.setattr(toy_recipe, "EPOCH_REPEAT", 2)
    res = toy_recipe.main([str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "DECODE: %WER" in out
    assert math.isfinite(res["stats"].wer)
    assert sorted(res["hyps"]) == sorted(res["refs"]) == \
        [f"utt{i:03d}" for i in range(24, 32)]
    assert 5 <= len(res["history"]) <= 8
    assert (tmp_path / "exp" / "model.pkl").exists()
    assert (tmp_path / "data" / "wav.scp").exists()


def test_synth_recipe_runs_to_a_sweep(tmp_path, monkeypatch):
    """The flagship at a cut scale (16 / 4 / 4 utterances, a 1 x 32
    model): features (cached in feats.npz), training, the bigram TLG and
    the decode-once sweep; results.md goes to the workdir and the repo's
    RESULTS.md is untouched."""
    from eesen_tpu_torch.examples import synth_recipe as sy

    results_md = (ROOT / "RESULTS.md").read_bytes()
    small_model(sy, monkeypatch)
    args = [str(tmp_path), "--utts", "16", "--cv", "4", "--eval", "4",
            "--epochs-repeat", "1", "--device", "cpu"]
    res = sy.main(args)
    assert (ROOT / "RESULTS.md").read_bytes() == results_md
    assert res["train_utts"] == 16 and math.isfinite(res["wer"])
    assert res["best_acwt"] in (0.5, 0.6, 0.7, 0.8, 0.9, 1.0)
    assert (tmp_path / "feats.npz").exists()
    assert "| acwt | WER |" in (tmp_path / "results.md").read_text()


# ---------------------------------------------------------------------
# the command lines
# ---------------------------------------------------------------------

def _arguments(path: pathlib.Path):
    """{flag or dest: {keyword: literal}} of every add_argument call."""
    out = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func,
                                                      ast.Attribute)
                and node.func.attr == "add_argument"):
            name = ast.literal_eval(node.args[0])
            kw = {}
            for k in node.keywords:
                if k.arg == "help":
                    continue
                try:
                    kw[k.arg] = ast.literal_eval(k.value)
                except ValueError:
                    kw[k.arg] = ast.unparse(k.value)
            out[name] = kw
    return out


@pytest.mark.parametrize("name", ["toy_recipe", "synth_recipe",
                                  "stress_recipe"])
def test_arguments_match_jax(name):
    """Each example takes the JAX script's arguments and defaults, plus
    --device ("cuda"); the workdir defaults to the same name under the
    temporary directory (the toy's to a fresh one)."""
    jax_args = _arguments(ROOT / "examples" / f"{name}.py")
    port = _arguments(ROOT / "eesen_tpu_torch" / "examples" / f"{name}.py")
    if name == "toy_recipe":         # the JAX toy reads sys.argv[1]
        jax_args = {"workdir": {"nargs": "?", "default": None}}
    assert port.pop("--device") == {"default": "cuda"}
    assert sorted(port) == sorted(jax_args)
    for flag, kw in jax_args.items():
        if flag == "workdir" and name != "toy_recipe":
            assert port[flag]["nargs"] == kw["nargs"]
            assert os.path.basename(kw["default"]) in port[flag]["default"]
            continue
        assert port[flag] == kw, flag


@pytest.mark.parametrize("name", ["__init__", "toy_recipe", "synth_recipe",
                                  "stress_recipe"])
def test_examples_import_only_the_port_numpy_and_the_stdlib(name):
    """Parsed, not imported: no jax, no eesen_tpu, not even torch."""
    path = ROOT / "eesen_tpu_torch" / "examples" / f"{name}.py"
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module.split(".")[0])
    allowed = {"eesen_tpu_torch", "numpy", *sys.stdlib_module_names}
    assert mods <= allowed, mods - allowed


# ---------------------------------------------------------------------
# the full run's TLG from the JAX package's host functions (not a test)
# ---------------------------------------------------------------------

def tlg_hashes(path) -> dict:
    """sha256 (16 hex digits) of each array of a saved CompiledGraph."""
    z = np.load(path)
    return {k: hashlib.sha256(np.ascontiguousarray(z[k]).tobytes())
            .hexdigest()[:16] for k in sorted(z.files)}


def jax_full_tlg(work: str, utts: int = 24000, lm_sents: int = 200000):
    """The stress run's trigram TLG at its defaults, by the JAX script's
    lexicon code (its main, stopped after synthesis over an empty wave
    cache) and the JAX package's estimate_ngram_arpa, arpa_to_fst,
    compile_lang and build_full_compiled."""
    import importlib.util
    import time

    from eesen_tpu.decoder.arpa import arpa_to_fst
    from eesen_tpu.decoder.ctc_graph import build_full_compiled, compile_lang
    from eesen_tpu.recipes.lm import estimate_ngram_arpa

    spec = importlib.util.spec_from_file_location("jax_stress_recipe",
                                                  JAX_STRESS)
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    os.makedirs(work, exist_ok=True)
    np.savez(os.path.join(work, "waves.npz"))
    m.BENCH_GRAPH_CACHE = os.path.join(work, "bench", "tlg_stress.npz")
    sys.argv = ["stress_recipe.py", work, "--utts", str(utts), "--cv", "0",
                "--eval", "1", "--stop-after", "synth"]
    m.main()
    with open(os.path.join(work, "lexicon.pkl"), "rb") as f:
        _, decode, _ = pickle.load(f)
    words = [w for w, _ in decode]
    succ, slot_p = m.build_text_process(m.VOCAB, np.random.default_rng(11))

    def to_words(sents):
        return [[words[int(j)] for j in s] for s in sents]

    t0 = time.time()
    tr = to_words(m.sample_sentences(utts, succ, slot_p, m.VOCAB,
                                     np.random.default_rng(12)))
    lm = to_words(m.sample_sentences(lm_sents, succ, slot_p, m.VOCAB,
                                     np.random.default_rng(13)))
    arpa = estimate_ngram_arpa(lm + tr, order=3, vocab=words,
                               min_counts=(1, 2, 2))
    t_lm = time.time() - t0
    units = [f"p{i:02d}" for i in range(40)]
    lang = compile_lang(decode + [("<UNK>", (units[0],))], units,
                        dict_type="phn")
    t0 = time.time()
    g = arpa_to_fst(arpa, lang.words)
    t_g = time.time() - t0
    t0 = time.time()
    tlg = build_full_compiled(lang.t_fst, lang.l_fst, g, build_closure=True)
    t_tlg = time.time() - t0
    path = os.path.join(work, "jax_tlg.npz")
    tlg.save(path)
    return {"states": tlg.num_states,
            "arcs": tlg.num_emit_arcs + tlg.num_eps_arcs,
            "max_emit_degree": tlg.max_emit_degree,
            "max_closure_degree": tlg.max_closure_degree,
            "arpa_sha256": hashlib.sha256(arpa.encode()).hexdigest()[:16],
            "g_states": g.num_states, "g_arcs": g.num_arcs,
            "cpu_seconds": {"lm": t_lm, "g": t_g, "tlg": t_tlg},
            "hashes": tlg_hashes(path)}


if __name__ == "__main__":
    if sys.argv[1:2] != ["full-tlg"] or len(sys.argv) != 3:
        sys.exit("usage: python -m tests.test_torch_examples full-tlg OUT")
    out_path = sys.argv[2]
    result = jax_full_tlg(os.path.splitext(out_path)[0] + "_work")
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
