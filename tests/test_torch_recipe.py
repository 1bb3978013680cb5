"""The recipe driver (eesen_tpu_torch/recipes/run.RecipeRun) and its
configurations against the JAX package's, on the CPU: the six RECIPES
field by field; on the tone corpus of tests/test_recipe_e2e.py (a few
utterances, a 1 x 8 BiLSTM, float32) the lang build, labels and features,
the decode and the blank-skip guard from parameters carried from JAX, and
one training epoch from the JAX trainer's initial state."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eesen_tpu.decoder.beam import BeamSearchConfig as JBeam
from eesen_tpu.frontend import features as jfeat
from eesen_tpu.frontend.pipeline import FeaturePipelineConfig as JPipe
from eesen_tpu.io.datadir import DataDir as JDataDir
from eesen_tpu.models import model as jmodel
from eesen_tpu.recipes import config as jconfig
from eesen_tpu.recipes.run import RecipeRun as JRecipeRun
from eesen_tpu.training import trainer as jtrainer
from eesen_tpu.training.batching import BatchConfig as JBatch
from eesen_tpu.training.optim import OptimizerConfig as JOpt
from eesen_tpu.training.schedule import NewbobConfig as JNewbob
from eesen_tpu_torch.decoder.beam import BeamSearchConfig as TBeam
from eesen_tpu_torch.frontend import features as tfeat
from eesen_tpu_torch.frontend.pipeline import FeaturePipelineConfig as TPipe
from eesen_tpu_torch.io.datadir import DataDir as TDataDir
from eesen_tpu_torch.models import model as tmodel
from eesen_tpu_torch.recipes import config as tconfig
from eesen_tpu_torch.recipes import run as trun
from eesen_tpu_torch.training import trainer as ttrainer
from eesen_tpu_torch.training.batching import BatchConfig as TBatch
from eesen_tpu_torch.training.optim import OptimizerConfig as TOpt
from eesen_tpu_torch.training.schedule import NewbobConfig as TNewbob

from tests.test_recipe_e2e import ARPA, PHONES, WORDS, synth, write_wav
from tests.test_torch_train import LOSS_RTOL, carried_state

FEAT_TOL = 1e-4        # port vs JAX on the CPU (rtol and atol)
# after per-speaker CMVN: var = E[x^2] - mean^2 in float32 on log-mel
# values near 20 cancels about three digits, so raw features that differ
# by ~1e-5 (another FFT and summation order) give normalized features
# that differ by up to 7.5e-4 on this corpus; the mean difference stays
# below 1e-4
PIPE_ATOL, PIPE_MEAN_ATOL = 2e-3, 1e-4
NUM_UTTS = 8
LEXICON = [(w, p) for w, p in WORDS.items()] + [("<UNK>", ("aa",))]


def _fields(obj):
    """A config as nested plain values (dtypes by name) for comparison
    across the two packages."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _fields(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple):
        return tuple(_fields(v) for v in obj)
    if isinstance(obj, torch.dtype):
        return str(obj).split(".")[-1]
    if type(obj).__name__ == "_ScalarMeta":      # jnp.float32, jnp.bfloat16
        return np.dtype(obj).name
    return obj


@pytest.mark.parametrize("name", sorted(jconfig.RECIPES))
def test_recipes_match_jax_field_by_field(name):
    """Every field RECIPES sets exists in the port with the JAX value;
    the port's configs drop only the JAX package's route switches."""
    j, t = _fields(jconfig.RECIPES[name]), _fields(tconfig.RECIPES[name])
    assert sorted(jconfig.RECIPES) == sorted(tconfig.RECIPES)
    for section in j:
        js, ts = j[section], t[section]
        if not isinstance(js, dict):
            assert ts == js, section
            continue
        for field, value in js.items():
            if field in ts:
                assert ts[field] == value, (section, field)
            else:   # a JAX-only switch: the recipe leaves it at its default
                default = _fields(type(getattr(
                    jconfig.RECIPES[name], section))())[field]
                assert value == default, (section, field)
    assert (tconfig.pipeline_input_dim(tconfig.RECIPES[name])
            == jconfig.pipeline_input_dim(jconfig.RECIPES[name]))


def configs(blank_skip=0.98, max_iters=1):
    """The toy recipe in both packages: 20 mel bins + deltas, a 1 x 8
    BiLSTM in float32, dither on (the features below turn it off by
    dither_seed=None)."""
    common = dict(name="toy", dict_type="phn", blank_skip_guard=3)
    newbob = dict(learn_rate=0.05, max_iters=max_iters, min_iters=1)
    batch = dict(num_sequence=4, frame_limit=20000, time_quant=32)
    # lattice_beam 3: the random models' lattices at the recipes' 8.0
    # take ~60 s a package to determinize on this corpus
    decode = dict(beam=20.0, max_active=256, acoustic_scale=0.9,
                  blank_skip=blank_skip, lattice_beam=3.0)
    model = dict(input_dim=60, cell_dim=8, num_layers=1, num_targets=-1)
    j = jconfig.RecipeConfig(
        fbank=jfeat.FbankOptions(mel_opts=jfeat.MelOptions(num_bins=20)),
        pipeline=JPipe(norm_vars=True, delta_order=2),
        model=jmodel.AcousticModelConfig(**model, compute_dtype=jnp.float32),
        optimizer=JOpt(algorithm="adagrad", max_grad=50.0),
        newbob=JNewbob(**newbob), batch=JBatch(**batch),
        decode=JBeam(**decode), **common,
    )
    t = tconfig.RecipeConfig(
        fbank=tfeat.FbankOptions(mel_opts=tfeat.MelOptions(num_bins=20)),
        pipeline=TPipe(norm_vars=True, delta_order=2),
        model=tmodel.AcousticModelConfig(**model,
                                         compute_dtype=torch.float32),
        optimizer=TOpt(algorithm="adagrad", max_grad=50.0),
        newbob=TNewbob(**newbob), batch=TBatch(**batch),
        decode=TBeam(**decode), **common,
    )
    return j, t


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Tone-phone wav files of 1-3 words, two speakers, as a data dir."""
    root = tmp_path_factory.mktemp("tone")
    rng = np.random.default_rng(3)
    vocab = list(WORDS)
    wav_scp, text, utt2spk = {}, {}, {}
    os.makedirs(root / "wavs")
    for i in range(NUM_UTTS):
        ws = [vocab[int(j)] for j in rng.integers(0, len(vocab),
                                                   1 + i % 3)]
        utt = f"utt{i:03d}"
        path = str(root / "wavs" / f"{utt}.wav")
        write_wav(path, synth(rng, ws))
        wav_scp[utt], text[utt], utt2spk[utt] = path, ws, f"spk{i % 2}"
    JDataDir.write(str(root / "data"), wav_scp=wav_scp, text=text,
                   utt2spk=utt2spk)
    return str(root / "data"), text


def runs(tmp_path, **kw):
    jcfg, tcfg = configs(**kw)
    jr = JRecipeRun(jcfg, str(tmp_path / "jax"), LEXICON, PHONES)
    tr = trun.RecipeRun(tcfg, str(tmp_path / "port"), LEXICON, PHONES,
                        device="cpu")
    return jr, tr


@pytest.fixture(scope="module")
def prepared(corpus, tmp_path_factory):
    """Both runs through lang, labels and features (no dither)."""
    data_dir, text = corpus
    jr, tr = runs(tmp_path_factory.mktemp("runs"))
    jr.build_lang()
    tr.build_lang()
    jdata, tdata = JDataDir(data_dir), TDataDir(data_dir)
    return dict(
        jr=jr, tr=tr, text=text,
        jlabels=jr.prep_labels(jdata), tlabels=tr.prep_labels(tdata),
        jfeats=jr.compute_features(jdata, dither_seed=None),
        tfeats=tr.compute_features(tdata, dither_seed=None),
        jraw=jr._raw_fbank(jdata, None), traw=tr._raw_fbank(tdata, None),
    )


def test_lang_and_labels_match_jax(prepared):
    jl, tl = prepared["jr"].lang, prepared["tr"].lang
    for table in ("tokens", "words"):
        j, t = getattr(jl, table), getattr(tl, table)
        assert [j.sym(i) for i in range(len(j))] == [
            t.sym(i) for i in range(len(t))]
    assert sorted(prepared["jlabels"]) == sorted(prepared["tlabels"])
    for k, v in prepared["jlabels"].items():
        np.testing.assert_array_equal(prepared["tlabels"][k], v)
        assert prepared["tlabels"][k].dtype == v.dtype


@pytest.mark.parametrize("stage", ["raw", "feats"])
def test_features_match_jax(prepared, stage):
    """Batched fbank (one power-of-two bucket) and the whole pipeline
    (per-speaker CMVN + deltas) within FEAT_TOL of the JAX run."""
    j, t = prepared[f"j{stage}"], prepared[f"t{stage}"]
    assert sorted(j) == sorted(t) and len(t) == NUM_UTTS
    for k in j:
        assert isinstance(t[k], np.ndarray) and t[k].shape == j[k].shape
        if stage == "raw":
            np.testing.assert_allclose(t[k], j[k], rtol=FEAT_TOL,
                                       atol=FEAT_TOL)
        else:
            np.testing.assert_allclose(t[k], j[k], rtol=0, atol=PIPE_ATOL)
            assert np.abs(t[k] - j[k]).mean() < PIPE_MEAN_ATOL
    if stage == "feats":
        assert next(iter(t.values())).shape[1] == 60


def test_features_with_dither_are_seeded(prepared, corpus):
    """dither_seed draws from a torch.Generator: the same seed gives the
    same bits, another seed other bits, and either stays near the
    no-dither features (the tone waves are ~8000 in amplitude)."""
    tr = prepared["tr"]
    data = TDataDir(corpus[0])
    a = tr._raw_fbank(data, 0)
    b = tr._raw_fbank(data, 0)
    c = tr._raw_fbank(data, 1)
    for k, ref in prepared["traw"].items():
        np.testing.assert_array_equal(a[k], b[k])
        assert not np.array_equal(a[k], c[k])
        assert np.abs(a[k] - ref).mean() < 1e-2


def carried_params(jcfg, units, out_scale, seed=0):
    """JAX-initialised parameters (numpy leaves) for the recipe's model,
    the output affine scaled by `out_scale`."""
    cfg = dataclasses.replace(jcfg.model, num_targets=len(units) + 1)
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init_model(jax.random.PRNGKey(seed), cfg))
    params["out"]["w"] = params["out"]["w"] * out_scale
    return cfg, params


# output scales of the random model: at 5 the blank-skip and the full
# search agree on the guard's sample, at 20 they differ on two of three
# utterances (about 35% of the frames are merged either way)
@pytest.fixture(scope="module", params=[5.0, 20.0], ids=["agree", "differ"])
def decoded(prepared, request):
    """Both runs decode the corpus from the same parameters."""
    jr, tr = prepared["jr"], prepared["tr"]
    jcfg, _ = configs()
    cfg, params = carried_params(jcfg, PHONES, request.param)
    log_priors = np.log(np.full(len(PHONES) + 1, 1.0 / (len(PHONES) + 1),
                                np.float32))
    jr.params, jr.model_cfg, jr.log_priors = params, cfg, log_priors
    tr.params = tmodel.params_from_jax(params, device="cpu")
    tr.model_cfg = dataclasses.replace(
        tr.cfg.model, num_targets=len(PHONES) + 1)
    tr.log_priors = log_priors
    jr.build_graph(ARPA)
    tr.build_graph(ARPA)
    refs = prepared["text"]
    return dict(
        j=jr.decode(prepared["jfeats"], refs),
        t=tr.decode(prepared["tfeats"], refs),
        jguard=jr.check_blank_skip_parity(prepared["jfeats"]),
        tguard=tr.check_blank_skip_parity(prepared["tfeats"]),
        agree=request.param == 5.0,
    )


def test_decode_matches_jax(decoded, prepared):
    (jstats, jhyps), (tstats, thyps) = decoded["j"], decoded["t"]
    assert thyps == jhyps
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    # the check below means something only if the search had words
    assert sum(len(h) for h in thyps.values()) > 0


def test_blank_skip_guard_matches_jax(decoded, prepared):
    """The same verdict and the same sampled and mismatched keys; the
    compaction really merged frames on this corpus."""
    assert decoded["tguard"] == decoded["jguard"]
    assert len(decoded["tguard"][1]["checked"]) == 3
    assert decoded["tguard"][0] == decoded["agree"]
    from eesen_tpu_torch.decoder.frame_skip import compact_blank_frames

    tr = prepared["tr"]
    feats = prepared["tfeats"]
    keys = sorted(feats)
    lp, lens = tr._posteriors(feats, keys)
    cf = compact_blank_frames(lp, lens, 0.98)
    kept = int(cf.lengths.sum())
    assert 0 < kept < 0.8 * int(lens.sum()), (kept, int(lens.sum()))


def test_graph_matches_jax(decoded, prepared):
    jg, tg = prepared["jr"].graph, prepared["tr"].graph
    for f in dataclasses.fields(jg):
        a, b = getattr(jg, f.name), getattr(tg, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a, err_msg=f.name)
        else:
            assert b == a, f.name


def test_train_one_epoch_matches_jax(prepared, tmp_path, monkeypatch):
    """RecipeRun.train for one newbob epoch, the port's trainer started
    from the JAX trainer's initial state: the same history within the
    trainer tests' tolerance, the same priors; model.pkl reloads the
    trained parameters."""
    jcfg, tcfg = configs(max_iters=1)
    jr = JRecipeRun(jcfg, str(tmp_path / "jax"), LEXICON, PHONES)
    tr = trun.RecipeRun(tcfg, str(tmp_path / "port"), LEXICON, PHONES,
                        device="cpu")
    jr.lang, tr.lang = prepared["jr"].lang, prepared["tr"].lang
    jmcfg = dataclasses.replace(jcfg.model, num_targets=len(PHONES) + 1)
    jinit = jtrainer.Trainer(jtrainer.TrainerConfig(
        model=jmcfg, optimizer=jcfg.optimizer, newbob=jcfg.newbob)).state

    class FromJax(ttrainer.Trainer):
        def __init__(self, cfg, device="cuda", mesh=None):
            super().__init__(cfg, device, mesh)
            self.state = carried_state(jinit)

    monkeypatch.setattr(trun, "Trainer", FromJax)
    keys = sorted(prepared["jfeats"])
    tr_keys, cv_keys = keys[:6], keys[6:]

    def split(d, ks):
        return {k: d[k] for k in ks}

    jh = jr.train(split(prepared["jfeats"], tr_keys),
                  split(prepared["jlabels"], tr_keys),
                  split(prepared["jfeats"], cv_keys),
                  split(prepared["jlabels"], cv_keys))
    # the same features into both: the epoch is held, not the front end
    th = tr.train(split(prepared["jfeats"], tr_keys),
                  split(prepared["tlabels"], tr_keys),
                  split(prepared["jfeats"], cv_keys),
                  split(prepared["tlabels"], cv_keys))
    assert sorted(th) == sorted(jh) == [1]
    for key in ("train_obj", "cv_obj"):
        np.testing.assert_allclose(th[1][key], jh[1][key], rtol=LOSS_RTOL)
    for key in ("train_acc", "cv_acc"):
        assert th[1][key] == pytest.approx(jh[1][key], abs=1e-9)
    np.testing.assert_allclose(tr.log_priors, jr.log_priors, rtol=1e-6)
    trained = tr.params
    again = trun.RecipeRun(tcfg, str(tmp_path / "port"), LEXICON, PHONES,
                           device="cpu")
    again.load_model()
    assert again.model_cfg == tr.model_cfg
    np.testing.assert_array_equal(again.log_priors, tr.log_priors)
    for a, b in zip(jax.tree_util.tree_leaves(again.params),
                    jax.tree_util.tree_leaves(trained)):
        assert torch.equal(a, b)


def test_recipe_run_trains_with_a_mesh(prepared, tmp_path):
    """RecipeRun(mesh=...) builds and trains: in a world of one process
    the same history and parameters, bit for bit, as mesh=None (two ranks:
    tests/test_torch_distributed.py)."""
    from eesen_tpu_torch.parallel.mesh import make_mesh

    _, tcfg = configs()
    keys = sorted(prepared["tfeats"])

    def split(d, ks):
        return {k: d[k] for k in ks}

    parts = [split(prepared[name], ks) for ks in (keys[:6], keys[6:])
             for name in ("tfeats", "tlabels")]
    runs = [trun.RecipeRun(tcfg, str(tmp_path / name), LEXICON, PHONES,
                           mesh=mesh, device="cpu")
            for name, mesh in (("plain", None),
                               ("mesh", make_mesh(device="cpu")))]
    hists = []
    for run in runs:
        run.lang = prepared["tr"].lang
        hists.append(run.train(*parts))
    assert hists[0] == hists[1] and sorted(hists[0]) == [1]
    assert runs[1].trainer.mesh is not None
    for a, b in zip(jax.tree_util.tree_leaves(runs[0].params),
                    jax.tree_util.tree_leaves(runs[1].params)):
        assert torch.equal(a, b)


# the JAX recipe test's sweep (tests/test_recipe_e2e.py:149-156)
ACWTS = (0.5, 0.9, 1.3)


def best_path_words(run, feats, blank_skip):
    """The best-path decode's words with the recipe's search at
    `blank_skip` (what RecipeRun.decode gives at its own setting)."""
    from eesen_tpu_torch.decoder.beam import traceback

    cfg = dataclasses.replace(run.cfg.decode, blank_skip=blank_skip)
    hyps = {}
    for chunk, _, lens, out in run._run_search(feats, sorted(feats), cfg, 8):
        for k, (wids, _) in zip(chunk, traceback(out, lens,
                                                 run.graph.final_weight)):
            hyps[k] = [run.lang.words.sym(w) for w in wids]
    return hyps


def _keep_lattices(run):
    """Wrap run.decode_lattices so that the lattices score_sweep scores,
    and the blank-skip setting it decoded them at, are kept."""
    kept, decode_lattices = {}, run.decode_lattices

    def wrapped(feats, **kwargs):
        kept["blank_skip"] = kwargs["decode_cfg"].blank_skip
        kept["lats"] = decode_lattices(feats, **kwargs)
        return kept["lats"]

    run.decode_lattices = wrapped
    return kept


@pytest.fixture(scope="module")
def swept(decoded, prepared):
    """score_sweep at ACWTS and the recipe's acwt_sweep in both runs, on
    the JAX features (the lattices are held, not the front end), with the
    lattices it scored.  The guard caches are emptied first: the runs are
    shared by both output scales."""
    jr, tr = prepared["jr"], prepared["tr"]
    feats, refs = prepared["jfeats"], prepared["text"]
    acwts = tuple(sorted(set(ACWTS) | set(tr.cfg.acwt_sweep)))
    res = dict(acwts=acwts)
    for side, run in (("j", jr), ("t", tr)):
        run._guard_cache = {}
        kept = _keep_lattices(run)
        try:
            res[side] = run.score_sweep(feats, refs, acwts=acwts)
        finally:
            del run.decode_lattices            # the class's method again
        res[f"{side}lats"], res[f"{side}skip"] = kept["lats"], kept[
            "blank_skip"]
    res["words"] = best_path_words(tr, feats, res["tskip"])
    return res


def test_score_sweep_matches_jax(swept, decoded):
    """Per-acwt WER equal to the JAX package's at (0.5, 0.9, 1.3) and the
    recipe's sweep, from lattices of the same search (blank-skip where
    the guard passed, else the full search); at the decode's acwt the
    swept WER is RecipeRun.decode's where the guard passed."""
    assert swept["tskip"] == swept["jskip"] == (
        0.98 if decoded["agree"] else 0.0)
    assert sorted(swept["t"]) == sorted(swept["j"]) == list(swept["acwts"])
    for acwt, stats in swept["j"].items():
        assert (dataclasses.asdict(swept["t"][acwt])
                == dataclasses.asdict(stats)), acwt
    if decoded["agree"]:
        assert swept["t"][0.9].wer == pytest.approx(decoded["t"][0].wer,
                                                    abs=1e-9)
        assert swept["words"] == decoded["t"][1]


def test_decode_lattices_match_jax(swept, prepared):
    """Each utterance's determinized lattice (unscaled acoustics): at
    ACWTS the JAX package's best-path words, costs within 1e-4 relative;
    at the decode's acwt, the best-path decode's words."""
    jl, tl = swept["jlats"], swept["tlats"]
    assert sorted(tl) == sorted(jl) == sorted(prepared["jfeats"])
    words = prepared["tr"].lang.words
    for k in sorted(tl):
        for acwt in ACWTS:
            _, tw, tc = tl[k].scaled(acwt).best_path()
            _, jw, jc = jl[k].scaled(acwt).best_path()
            assert list(tw) == list(jw), (k, acwt)
            assert tc == pytest.approx(jc, rel=1e-4)
        best = tl[k].scaled(0.9).best_path()[1]
        assert [words.sym(w) for w in best] == swept["words"][k], k
    assert sum(len(w) for w in swept["words"].values()) > 0


def test_sweep_guard_cache_is_stale_in_both(prepared, tmp_path):
    """Pinned, not fixed (eesen_tpu/recipes/run.py:526): score_sweep
    caches the blank-skip verdict by (sorted keys, blank_skip) without the
    model.  After a sweep at output scale 5 (the guard passes), the output
    layer is rescaled to 20, where a fresh guard fails; a second sweep
    reuses the cached pass and decodes with blank-skip, in both
    packages."""
    jcfg, _ = configs()
    feats, refs = prepared["jfeats"], prepared["text"]
    log_priors = np.log(np.full(len(PHONES) + 1, 1.0 / (len(PHONES) + 1),
                                np.float32))
    for side, run in zip(("j", "t"), runs(tmp_path)):
        run.lang = prepared[f"{side}r"].lang
        run.build_graph(ARPA)
        guard, skips = run.check_blank_skip_parity, []

        def counted(*args, **kwargs):
            skips.append("guard")
            return guard(*args, **kwargs)

        def lattices(feats, batch_size=8, decode_cfg=None, **kwargs):
            skips.append(decode_cfg.blank_skip)
            return {}

        run.check_blank_skip_parity, run.decode_lattices = counted, lattices
        for scale in (5.0, 20.0):
            cfg, params = carried_params(jcfg, PHONES, scale)
            run.params = (params if side == "j"
                          else tmodel.params_from_jax(params, device="cpu"))
            run.model_cfg = (cfg if side == "j" else dataclasses.replace(
                run.cfg.model, num_targets=len(PHONES) + 1))
            run.log_priors = log_priors
            if scale == 20.0:                  # a fresh verdict fails
                assert not guard(feats)[0], side
            run.score_sweep(feats, refs, acwts=(0.9,))
        assert skips == ["guard", 0.98, 0.98], side
