"""The port stands alone: no module of eesen_tpu_torch, and not
chip_smoke.py, imports jax or the JAX package; entry points run on CUDA
unless the caller asks for the CPU; kernel wrappers refuse devices they
have no kernel for."""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from eesen_tpu_torch.decoder import beam as tbeam
from eesen_tpu_torch.examples import stress_recipe, synth_recipe, toy_recipe
from eesen_tpu_torch.decoder import graph_compile as t_gc
from eesen_tpu_torch.frontend import features as tfeat
from eesen_tpu_torch.frontend import pitch as tpitch
from eesen_tpu_torch.models import model as tmodel
from eesen_tpu_torch.models import serialize as tser
from eesen_tpu_torch.models import streaming as tstream
from eesen_tpu_torch.ops import beam_cuda, ctc_cuda, lstm_cuda, lstm_v1_cuda
from eesen_tpu_torch.recipes import run as trun
from eesen_tpu_torch.recipes.config import RECIPES
from eesen_tpu_torch.training import optim as toptim
from eesen_tpu_torch.training import trainer as ttrainer

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "eesen_tpu")


def port_sources():
    return sorted((ROOT / "eesen_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"
    ]


def imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_or_eesen_tpu_imports():
    """Parsed, not imported: the test environment may import jax at
    interpreter start, so sys.modules proves nothing."""
    files = port_sources()
    assert len(files) > 15
    bad = [
        f"{p.relative_to(ROOT)}: {mod}"
        for p in files for mod in imported_modules(p)
        if mod.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def tiny_graph():
    z = np.zeros(2, np.int32)
    return t_gc.CompiledGraph(
        num_states=1, start=0, emit_offsets=z, emit_ilabel=z[:1],
        emit_olabel=z[:1], emit_weight=np.zeros(1, np.float32),
        emit_dst=z[:1], eps_offsets=np.zeros(2, np.int32),
        eps_olabel=z[:0], eps_weight=np.zeros(0, np.float32),
        eps_dst=z[:0], final_weight=np.zeros(1, np.float32),
        max_emit_degree=1, max_eps_degree=0, eps_depth=0,
    )


@pytest.mark.parametrize("entry", [
    "init_model", "params_from_jax", "device_graph", "posteriors",
    "decode", "create_train_state", "trainer", "opt_state_from_jax",
    "stream_state", "streaming_am", "streaming_decoder",
    "streaming_pipeline", "recipe_run", "fbank", "kaldi_pitch",
    "read_eesen_nnet", "toy_recipe", "synth_recipe", "stress_recipe",
])
def test_entry_points_default_to_cuda(no_cuda, entry, tmp_path):
    cfg = tmodel.AcousticModelConfig(input_dim=4, cell_dim=4, num_layers=1,
                                     num_targets=3)
    params = tmodel.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    ucfg = dataclasses.replace(cfg, bidirectional=False)
    nnet = str(tmp_path / "final.nnet")     # written from CPU tensors
    calls = {
        "init_model": lambda: tmodel.init_model(torch.Generator(), cfg),
        "params_from_jax": lambda: tmodel.params_from_jax(
            {"out": {"b": np.zeros(3)}}),
        "device_graph": lambda: tbeam.DeviceGraph.put(tiny_graph()),
        "posteriors": lambda: trun.posteriors(
            params, cfg, np.zeros((1, 2, 4), np.float32), [2]),
        "decode": lambda: trun.decode(
            params, cfg, tiny_graph(), {"u": np.zeros((2, 4), np.float32)}),
        "create_train_state": lambda: ttrainer.create_train_state(
            torch.Generator(), cfg, toptim.OptimizerConfig()),
        "trainer": lambda: ttrainer.Trainer(ttrainer.TrainerConfig(
            model=cfg)),
        "opt_state_from_jax": lambda: toptim.opt_state_from_jax(
            type("S", (), {"inner": (), "hyperparams": {
                "learning_rate": 0.0}})()),
        "stream_state": lambda: tstream.init_stream_state(ucfg, 2),
        "streaming_am": lambda: tstream.StreamingAcousticModel(params, ucfg),
        "streaming_decoder": lambda: tbeam.StreamingBeamDecoder(
            tiny_graph()),
        "streaming_pipeline": lambda: tstream.StreamingPipeline(
            params, ucfg, tiny_graph()),
        "recipe_run": lambda: trun.RecipeRun(
            RECIPES["wsj_phn"], str(tmp_path), [("a", ("x",))], ["x"]),
        "fbank": lambda: tfeat.fbank(np.zeros(800, np.float32)),
        "kaldi_pitch": lambda: tpitch.kaldi_pitch(np.zeros(800, np.float32)),
        "read_eesen_nnet": lambda: tser.read_eesen_nnet((
            tser.write_eesen_nnet(nnet, params, cfg), nnet)[1]),
        "toy_recipe": lambda: toy_recipe.main([str(tmp_path)]),
        "synth_recipe": lambda: synth_recipe.main([str(tmp_path)]),
        "stress_recipe": lambda: stress_recipe.main(
            [str(tmp_path), "--stop-after", "synth"]),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


def test_wrappers_refuse_other_devices():
    """Only CPU tensors take the plain versions; any other device must
    launch a kernel or raise."""
    meta = torch.device("meta")
    x = torch.empty((3, 2, 4), device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        lstm_cuda.lstm_direction(
            x, torch.empty((3, 2), device=meta),
            torch.empty((4, 8), device=meta), torch.empty(8, device=meta),
            torch.empty((2, 8), device=meta), torch.empty((3, 2), device=meta),
        )
    with pytest.raises(ValueError, match="unsupported device"):
        beam_cuda.dedup_prune(
            torch.empty((2, 200), dtype=torch.int32, device=meta),
            torch.empty((2, 200), device=meta), 8, 1.0,
        )
    e = lambda *s: torch.empty(s, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        lstm_cuda.lstm_direction_bwd(
            e(3, 2, 4), e(3, 2), e(3, 2, 8), e(3, 2, 2), e(3, 2, 2),
            e(3, 2, 2), e(4, 8), e(2, 8), e(3, 2),
        )
    with pytest.raises(ValueError, match="unsupported device"):
        lstm_v1_cuda.lstm_scan_fwd(e(3, 2, 8), e(3, 2), e(2, 8), e(3, 2))
    with pytest.raises(ValueError, match="unsupported device"):
        lstm_v1_cuda.lstm_scan_bwd(e(3, 2), e(3, 2, 8), e(3, 2, 2),
                                   e(3, 2, 2), e(3, 2, 2), e(2, 8), e(3, 2))
    with pytest.raises(ValueError, match="unsupported device"):
        ctc_cuda.ctc_alpha_beta(e(2, 3, 5), e(2, 5), e(2, 5),
                                torch.empty(2, dtype=torch.int32,
                                            device=meta))


def counts():
    return (lstm_cuda.launches, lstm_cuda.bwd_launches,
            lstm_v1_cuda.launches, lstm_v1_cuda.bwd_launches,
            beam_cuda.launches,
            ctc_cuda.alpha_launches, ctc_cuda.beta_launches)


def test_counters_do_not_move_on_cpu():
    before = counts()
    beam_cuda.dedup_prune(torch.zeros((1, 130), dtype=torch.int32),
                          torch.zeros((1, 130)), 4, 1.0)
    w_x = torch.zeros((3, 8), requires_grad=True)
    m = lstm_cuda.lstm_direction(
        torch.zeros((2, 1, 3)), torch.ones((2, 1)), w_x,
        torch.zeros(8), torch.zeros((2, 8)), torch.zeros((3, 2)),
    )
    m.sum().backward()                    # the backward's plain version
    assert w_x.grad is not None
    xw = torch.zeros((2, 1, 8), requires_grad=True)
    lstm_v1_cuda.lstm_scan(xw, torch.ones((2, 1)), torch.zeros((2, 8)),
                           torch.zeros((3, 2))).sum().backward()
    assert xw.grad is not None
    ctc_cuda.ctc_alpha_beta(torch.zeros((1, 2, 3)), torch.zeros((1, 3)),
                            torch.zeros((1, 3)), torch.tensor([2]))
    assert counts() == before


CLI_DEVICE_COMMANDS = {
    "compute-fbank-feats": ["compute-fbank-feats", "scp:w.scp", "ark:f.ark"],
    "compute-mfcc-feats": ["compute-mfcc-feats", "scp:w.scp", "ark:f.ark"],
    "compute-plp-feats": ["compute-plp-feats", "scp:w.scp", "ark:f.ark"],
    "compute-spectrogram-feats": ["compute-spectrogram-feats", "scp:w.scp",
                                  "ark:f.ark"],
    "compute-kaldi-pitch-feats": ["compute-kaldi-pitch-feats", "scp:w.scp",
                                  "ark:f.ark"],
    "net-output-extract": ["net-output-extract", "m.pt", "ark:f.ark",
                           "ark:p.ark"],
    "latgen": ["latgen", "g.pkl", "ark:p.ark", "hyp"],
    "decode-faster": ["decode-faster", "g.pkl", "ark:p.ark", "hyp"],
    "align": ["align", "m.pt", "ark:f.ark", "ark:l.ark", "ali"],
    "train": ["train", "ark:f.ark", "ark:l.ark", "ark:f.ark", "ark:l.ark",
              "m.pt", "--num-targets", "3"],
}


@pytest.mark.parametrize("cmd", sorted(CLI_DEVICE_COMMANDS))
def test_cli_device_commands_default_to_cuda(no_cuda, cmd):
    """A command that computes runs on --device, "cuda" by default: with
    no card it raises (before reading its inputs) unless given
    --device cpu."""
    from eesen_tpu_torch.tools import cli

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(CLI_DEVICE_COMMANDS[cmd])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--device", "cuda", *CLI_DEVICE_COMMANDS[cmd]])


def test_cli_host_commands_never_touch_cuda(no_cuda, tmp_path, capsys):
    """Model tools are host code: they run without a card and without
    --device cpu."""
    from eesen_tpu_torch.tools import cli

    cfg = tmodel.AcousticModelConfig(input_dim=4, cell_dim=4, num_layers=1,
                                     num_targets=3)
    params = tmodel.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    blob = str(tmp_path / "m.pt")
    cli.save_model_blob(blob, {"params": params, "config": cfg})
    assert cli.main(["model-info", blob]) == 0
    assert "cell-dim 4" in capsys.readouterr().out
    assert cli.main(["net-copy", blob, str(tmp_path / "m.nnet")]) == 0
    assert cli.main(["net-average", str(tmp_path / "a.pt"), blob,
                     str(tmp_path / "m.nnet")]) == 0


REFUSAL = """
import sys
from eesen_tpu_torch.tools import cli
for what, load in (("model", cli.load_model), ("graph", cli.load_pickle)):
    try:
        load(sys.argv[1] if what == "model" else sys.argv[2])
    except cli.ForeignPickleError as e:
        print(what, "refused:", e)
    else:
        print(what, "loaded")
print("imported:", sorted(m for m in sys.modules
                          if m.split(".")[0] in ("eesen_tpu", "jax")))
"""


def test_cli_refuses_jax_pickles_without_importing_them(tmp_path):
    """The JAX package's model and graph pickles name its classes (and
    jax's); the port's loaders refuse them before importing any, in a
    fresh interpreter."""
    import os
    import pickle
    import subprocess
    import sys

    import jax
    import jax.numpy as jnp
    from eesen_tpu.models import model as jmodel

    from tests.test_torch_dense import j_arpa, j_compile, j_lang, j_lg, j_tlg
    from tests.test_ctc_graph import ARPA, LEXICON, UNITS

    jcfg = jmodel.AcousticModelConfig(input_dim=4, cell_dim=4, num_layers=1,
                                      num_targets=4, compute_dtype=jnp.float32)
    model = str(tmp_path / "model.pkl")
    with open(model, "wb") as f:
        pickle.dump({"params": jmodel.init_model(jax.random.PRNGKey(0),
                                                 jcfg), "config": jcfg}, f)
    lang = j_lang(LEXICON, UNITS, dict_type="phn")
    graph = str(tmp_path / "tlg.pkl")
    with open(graph, "wb") as f:
        pickle.dump(j_compile(j_tlg(lang.t_fst, j_lg(
            lang.l_fst, j_arpa(ARPA, lang.words))), max_degree=8), f)
    res = subprocess.run(
        [sys.executable, "-c", REFUSAL, model, graph], cwd=str(ROOT),
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert res.returncode == 0, res.stderr
    out = res.stdout.splitlines()
    assert out[0].startswith("model refused:") and "net-copy" in out[0] \
        and ".nnet" in out[0]
    assert out[1].startswith("graph refused:") and "build-tlg" in out[1]
    assert out[2] == "imported: []"
