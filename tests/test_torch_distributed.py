"""The mesh path on two real processes: two ranks of a gloo process group
on the CPU, started by the tests with a free localhost port, run the
port's data-parallel step, Trainer.fit, the sharded decoder and
RecipeRun(mesh=...); the test's own process holds them against the JAX
package on a 2-device data mesh of the conftest's virtual CPU devices
(tests/test_shard_map_step.py, tests/test_beam.py), and against the
port's single-process runs.  The same two ranks as a 1 x 2 mesh (the
parameters split over `model`) against the single-process step in bits.
Also init_distributed's errors.  Four ranks on a 2 x 2 mesh are
tests/test_torch_model_axis.py."""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from eesen_tpu.decoder import beam as jbeam
from eesen_tpu.decoder.graph_compile import compile_graph
from eesen_tpu.models.model import AcousticModelConfig as JModelConfig
from eesen_tpu.parallel.mesh import MeshConfig as JMeshConfig
from eesen_tpu.parallel.mesh import make_mesh as jmake_mesh
from eesen_tpu.parallel.sharding import shard_batch as jshard_batch
from eesen_tpu.parallel.sharding import shard_state as jshard_state
from eesen_tpu.training import trainer as jtrainer
from eesen_tpu.training.optim import OptimizerConfig as JOptConfig
from eesen_tpu_torch.decoder import beam as tbeam
from eesen_tpu_torch.io.datadir import DataDir as TDataDir
from eesen_tpu_torch.models import model as tmodel
from eesen_tpu_torch.parallel import distributed as tdist
from eesen_tpu_torch.parallel import sharding as tsharding
from eesen_tpu_torch.recipes import run as trun
from eesen_tpu_torch.training import optim as toptim
from eesen_tpu_torch.training import trainer as ttrainer

from tests.test_beam import synth_loglikes
from tests.test_torch_beam import tlg, to_port_graph  # noqa: F401
from tests.test_torch_recipe import LEXICON, configs as recipe_configs
from tests.test_torch_recipe import corpus  # noqa: F401
from tests.test_recipe_e2e import PHONES
from tests.test_torch_train import (
    LOSS_RTOL, SMALL, batch, carried_state, to_torch, trainer_cfgs,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# each run of ranks, start to end; every rank is killed past it
RUN_TIMEOUT_S = 120
# the DP-step tolerance with which tests/test_shard_map_step.py holds JAX
STEP_RTOL, STEP_ATOL = 1e-4, 1e-5
LR, STEPS = 0.05, 3
DROPOUT_SEEDS = (11, 12, 13)

WORKER = r'''
import os, sys
rank, port, root, work = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
sys.path.insert(0, root)
import dataclasses
import torch
from eesen_tpu_torch.decoder.beam import (
    DeviceGraph, make_sharded_beam_decoder, traceback)
from eesen_tpu_torch.parallel.distributed import (
    global_batch, host_shard, init_distributed, is_coordinator, psum_)
from eesen_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from eesen_tpu_torch.parallel.sharding import (
    gather_params, shard_batch, shard_state)
from eesen_tpu_torch.recipes.run import RecipeRun
from eesen_tpu_torch.training import trainer as tr
from eesen_tpu_torch.training.optim import make_optimizer, tree_leaves
from eesen_tpu_torch.training.schedule import NewbobScheduler

init_distributed(f"127.0.0.1:{port}", 2, rank, timeout=60)
mesh = make_mesh(device="cpu")
inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
out = {"mesh": (mesh.data, mesh.rank), "coordinator": is_coordinator(),
       "host_shard": host_shard(list(range(10)))}
for cfg in (MeshConfig(data=4), MeshConfig(model=2)):
    try:
        m = make_mesh(cfg, device="cpu")
        out.setdefault("meshes", []).append(
            (m.data, m.model, m.rank, m.data_index, m.model_index))
    except Exception as e:
        out.setdefault("mesh_errors", []).append((type(e).__name__, str(e)))

# (a) every rank's 4 local rows of rank+1 -> one global sum
local = {"feats": torch.full((4, 3, 2), float(rank + 1)),
         "feat_lengths": torch.full((4,), 3), "keys": ["x"] * 4}
gb = global_batch(local, mesh)
out["global_sum"] = float(psum_(gb["feats"].sum(), mesh))
out["global_keys"] = sorted(gb)


def dp_steps(case):
    c = inp[case]
    step = tr.make_shard_map_train_step(
        c["cfg"], make_optimizer(c["opt"]), mesh, with_argmax=True)
    state, local, metrics = c["state"], shard_batch(c["batch"], mesh), []
    for seed in c["seeds"]:
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        state, m = step(state, local, gen, c["lr"])
        metrics.append(m)
    return {"params": tree_leaves(state.params), "metrics": metrics,
            "step": state.step}


out["steps"] = dp_steps("steps")
out["dropout"] = dp_steps("dropout")

# (c) the same steps on a 1 x 2 mesh: the parameters split over `model`
model_mesh = make_mesh(MeshConfig(model=2), device="cpu")
c = inp["steps"]
step = tr.make_shard_map_train_step(
    c["cfg"], make_optimizer(c["opt"]), model_mesh, with_argmax=True)
state, rows, metrics = (shard_state(c["state"], model_mesh),
                        shard_batch(c["batch"], model_mesh), [])
for _ in c["seeds"]:
    state, m = step(state, rows, None, c["lr"])
    metrics.append(m)
out["model_steps"] = {
    "shards": tree_leaves(state.params),
    "params": tree_leaves(gather_params(state.params, model_mesh)),
    "inner": state.opt_state.inner, "metrics": metrics}

# (d) job-sharded decode
d = inp["decode"]
dec = make_sharded_beam_decoder(d["graph"], d["cfg"], mesh)
res = dec(d["ll"], d["lens"], DeviceGraph.put(d["graph"], device="cpu"))
out["decode"] = {"outputs": res.numpy(),
                 "best": traceback(res, d["lens"], d["graph"].final_weight)}

# (e) Trainer.fit with checkpoints: count who writes
f = inp["fit"]
ckpt = os.path.join(work, "ckpt")
tcfg = dataclasses.replace(f["cfg"], checkpoint_dir=ckpt)
writes = []
real_save, real_sched = torch.save, NewbobScheduler.save
torch.save = lambda obj, p, *a, **k: (writes.append(str(p)),
                                      real_save(obj, p, *a, **k))[1]
NewbobScheduler.save = lambda self, p: (writes.append(p),
                                        real_sched(self, p))[1]
batches = lambda: iter([dict(b) for b in f["batches"]])
t = tr.Trainer(tcfg, mesh=mesh)
hist = t.fit(batches, batches)
torch.save, NewbobScheduler.save = real_save, real_sched
t2 = tr.Trainer(tcfg, mesh=mesh)
t2.restore_checkpoint(t2.latest_checkpoint())
t3 = tr.Trainer(tcfg, mesh=mesh)
out["fit"] = {"history": hist, "writes": len(writes),
              "params": tree_leaves(t.state.params), "epoch": t.sched.epoch,
              "restored": tree_leaves(t2.state.params),
              "restored_inner": t2.state.opt_state.inner,
              "restored_step": t2.state.step,
              "restored_epoch": t2.sched.epoch,
              "again": t3.fit(batches, batches)}

# (f) the recipe's training stage
r = inp["recipe"]
run = RecipeRun(r["cfg"], os.path.join(work, "recipe"), r["lexicon"],
                r["units"], mesh=mesh, device="cpu")
run.build_lang()
out["recipe"] = {"history": run.train(*r["parts"]),
                 "params": tree_leaves(run.params)}

torch.save(out, os.path.join(work, f"rank{rank}.pt"))
torch.distributed.destroy_process_group()
print(f"rank{rank} OK", flush=True)
'''


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """`n` worker processes of `worker` (a script's text; argv: rank, port,
    repo root, work dir) over gloo; `results()` waits for all of them (at
    most `timeout` seconds, then kills them all) and loads what each rank
    saved as rank<r>.pt."""

    def __init__(self, work, n=2, worker=WORKER, timeout=RUN_TIMEOUT_S):
        self.work, self.n, self.timeout = work, n, timeout
        script = os.path.join(work, "worker.py")
        with open(script, "w") as f:
            f.write(worker)
        port = str(free_port())
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.procs = [
            subprocess.Popen(
                [sys.executable, "-I", script, str(r), port, ROOT, work],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                cwd=ROOT)
            for r in range(n)
        ]
        self._out = None

    def results(self):
        if self._out is None:
            logs = []
            try:
                for p in self.procs:
                    logs.append(p.communicate(timeout=self.timeout)[0]
                                .decode())
            finally:
                for p in self.procs:
                    p.kill()
            for r, (p, log) in enumerate(zip(self.procs, logs)):
                assert p.returncode == 0 and f"rank{r} OK" in log, \
                    f"rank {r} failed:\n{log}"
            self._out = [
                torch.load(os.path.join(self.work, f"rank{r}.pt"),
                           weights_only=False)
                for r in range(self.n)
            ]
        return self._out


def tone_features(data_dir, work):
    """The tone corpus's features and labels through the port's recipe (no
    dither), split 6 train / 2 CV; the recipe's lang.pkl is left in
    `work`."""
    _, tcfg = recipe_configs()
    run = trun.RecipeRun(tcfg, work, LEXICON, PHONES, device="cpu")
    run.build_lang()
    data = TDataDir(data_dir)
    feats = run.compute_features(data, dither_seed=None)
    labels = run.prep_labels(data)
    keys = sorted(feats)

    def split(d, ks):
        return {k: d[k] for k in ks}

    return (split(feats, keys[:6]), split(labels, keys[:6]),
            split(feats, keys[6:]), split(labels, keys[6:]))


def model_cfgs(**kw):
    jm = JModelConfig(**SMALL, compute_dtype=jnp.float32, **kw)
    tm = tmodel.AcousticModelConfig(**SMALL, compute_dtype=torch.float32,
                                    **kw)
    return jm, tm


def opt_cfgs():
    kw = dict(algorithm="sgd", momentum=0.9, max_grad=10.0)
    return JOptConfig(**kw), toptim.OptimizerConfig(**kw)


def cat_rows(*bs):
    return {k: np.concatenate([b[k] for b in bs]) for k in bs[0]}


# forward dropout with per-frame masks, and the twiddle coin (the JAX
# model's keyword names)
DROPOUT = dict(forward_dropout=0.3, forward_step_dropout=True, twiddle=True)


def decode_case(tlg):  # noqa: F811
    """tests/test_beam.py:245-282: 4 utterances, beam 1e9, max_active 128."""
    lang, fst = tlg
    rng = np.random.default_rng(21)
    seqs = [
        ["a", "<blk>", "b"], ["b", "a", "<blk>", "a"],
        ["a", "a", "b", "c"], ["c", "<blk>", "b", "a"],
    ]
    lls = [synth_loglikes(rng, lang, s, t_per=2) for s in seqs]
    t_max = max(x.shape[0] for x in lls)
    ll = np.zeros((4, t_max, lls[0].shape[1]), np.float32)
    lens = np.zeros(4, np.int32)
    for i, x in enumerate(lls):
        ll[i, : len(x)] = x
        lens[i] = len(x)
    return compile_graph(fst, max_degree=8, build_closure=True), ll, lens


@pytest.fixture(scope="module")
def cases(tlg, corpus, tmp_path_factory):  # noqa: F811
    """The inputs of every two-process case, and the ranks started on them
    (they run while the tests compute their references)."""
    work = str(tmp_path_factory.mktemp("ranks"))
    jm, tm = model_cfgs()
    jo, to = opt_cfgs()
    jstate, _ = jtrainer.create_train_state(jax.random.PRNGKey(1), jm, jo)
    jm_d, tm_d = model_cfgs(**DROPOUT)
    jstate_d, _ = jtrainer.create_train_state(jax.random.PRNGKey(2), jm_d,
                                              jo)
    rows_x = batch(2)
    g, ll, lens = decode_case(tlg)
    _, fit_cfg = trainer_cfgs()
    parts = tone_features(corpus[0], os.path.join(work, "recipe"))
    _, rcfg = recipe_configs()
    inputs = {
        "steps": dict(cfg=tm, opt=to, state=carried_state(jstate), lr=LR,
                      batch=cat_rows(batch(0), batch(1)),
                      seeds=[None] * STEPS),
        "dropout": dict(cfg=tm_d, opt=to, state=carried_state(jstate_d),
                        lr=LR, batch=cat_rows(rows_x, rows_x),
                        seeds=list(DROPOUT_SEEDS)),
        "decode": dict(graph=to_port_graph(g), ll=ll, lens=lens,
                       cfg=tbeam.BeamSearchConfig(beam=1e9, max_active=128)),
        "fit": dict(cfg=fit_cfg, batches=[cat_rows(batch(s), batch(s + 3))
                                          for s in range(3)]),
        "recipe": dict(cfg=rcfg, lexicon=LEXICON, units=PHONES, parts=parts),
    }
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    return dict(inputs=inputs, jax=dict(jm=jm, jo=jo, jstate=jstate,
                                        jm_d=jm_d, jstate_d=jstate_d,
                                        graph=g),
                ranks=Ranks(work), work=work)


def jax_data_mesh():
    return jmake_mesh(JMeshConfig(data=2, model=1), devices=jax.devices()[:2])


def assert_ranks_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_global_batch_over_two_ranks(cases):
    """tests/test_distributed_2proc.py's global sum over two processes,
    the coordinator flags and the round-robin dataset split."""
    outs = cases["ranks"].results()
    for r, o in enumerate(outs):
        assert o["mesh"] == (2, r)
        assert o["coordinator"] == (r == 0)
        assert o["host_shard"] == list(range(10))[r::2]
        assert o["global_sum"] == (4 * 1.0 + 4 * 2.0) * 6
        assert o["global_keys"] == ["feat_lengths", "feats"]
        assert o["mesh_errors"] == [
            ("ValueError", "mesh 4x1 != device count 2")]
        # MeshConfig(model=2) on two ranks: a 1 x 2 mesh, rank r at data
        # index 0 and model index r
        assert o["meshes"] == [(1, 2, r, 0, r)]


def test_dp_steps_match_jax_shard_map(cases):
    """3 DP steps (f32, SGD momentum 0.9, max_grad 10) on 2 ranks against
    make_shard_map_train_step on a 2-device data mesh: loss, obj_sum,
    frames, argmax and every parameter; the ranks' parameters equal bits."""
    j = cases["jax"]
    mesh = jax_data_mesh()
    state, tx = jtrainer.create_train_state(jax.random.PRNGKey(1), j["jm"],
                                            j["jo"])
    state = jshard_state(state, mesh)
    step = jtrainer.make_shard_map_train_step(j["jm"], tx, mesh,
                                              donate=False, with_argmax=True)
    b = jshard_batch(cases["inputs"]["steps"]["batch"], mesh)
    want = []
    for _ in range(STEPS):
        state, m = step(state, b, None, jnp.float32(LR))
        want.append(jax.tree_util.tree_map(np.asarray, m))
    outs = cases["ranks"].results()
    assert_ranks_equal(outs[0]["steps"]["params"], outs[1]["steps"]["params"])
    for o in outs:
        assert o["steps"]["step"] == STEPS
        for got, w in zip(o["steps"]["metrics"], want):
            for k in ("loss", "obj_sum"):
                np.testing.assert_allclose(float(got[k]), float(w[k]),
                                           rtol=STEP_RTOL, atol=STEP_ATOL)
            assert int(got["frames"]) == int(w["frames"])
            np.testing.assert_array_equal(got["argmax"].numpy(), w["argmax"])
        for a, c in zip(o["steps"]["params"],
                        jax.tree_util.tree_leaves(state.params)):
            np.testing.assert_allclose(a.numpy(), np.asarray(c),
                                       rtol=STEP_RTOL, atol=STEP_ATOL)


def test_model_axis_steps_on_two_ranks_are_the_plain_step(cases):
    """3 steps on a 1 x 2 mesh (each rank holds half of every split leaf,
    both take all the rows) give the single-process step's bits: loss,
    metrics, the gathered parameters and the flat accumulator; rank r
    holds block r of each leaf that `model` splits."""
    c = cases["inputs"]["steps"]
    step = ttrainer.make_train_step(c["cfg"], toptim.make_optimizer(c["opt"]),
                                    with_argmax=True)
    state, x, want = c["state"], to_torch(c["batch"]), []
    for _ in range(STEPS):
        state, m = step(state, x, None, LR)
        want.append(m)
    whole = toptim.tree_leaves(state.params)
    for r, o in enumerate(cases["ranks"].results()):
        got = o["model_steps"]
        for g, w in zip(got["metrics"], want):
            assert sorted(g) == sorted(w)
            for k in w:
                assert torch.equal(g[k], w[k]), k
        assert_ranks_equal(got["params"], whole)
        assert torch.equal(got["inner"]["trace"],
                           state.opt_state.inner["trace"])
        for a, w in zip(got["shards"], whole):
            spec = tsharding.leaf_pspec(w)
            if "model" in spec:
                w = w.chunk(2, spec.index("model"))[r]
            assert torch.equal(a, w)


def test_dp_dropout_masks_replicate_in_the_port(cases):
    """A DP step with dropout over [X; X] on 2 ranks is the plain step
    over X with the same generator: every rank draws rank 0's masks for
    its shape, the frames double and so does the summed gradient."""
    c = cases["inputs"]["dropout"]
    step = ttrainer.make_train_step(c["cfg"], toptim.make_optimizer(c["opt"]))
    state, x = c["state"], to_torch(batch(2))
    want = []
    for seed in DROPOUT_SEEDS:
        state, m = step(state, x, torch.Generator().manual_seed(seed), LR)
        want.append(m)
    outs = cases["ranks"].results()
    assert_ranks_equal(outs[0]["dropout"]["params"],
                       outs[1]["dropout"]["params"])
    for o in outs:
        for got, w in zip(o["dropout"]["metrics"], want):
            np.testing.assert_allclose(float(got["loss"]), float(w["loss"]),
                                       rtol=STEP_RTOL, atol=STEP_ATOL)
            assert int(got["frames"]) == 2 * int(w["frames"])
        for a, b in zip(o["dropout"]["params"],
                        toptim.tree_leaves(state.params)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=STEP_RTOL,
                                       atol=STEP_ATOL)
    # the masks are live: other masks give another step
    first, _ = step(c["state"], x, torch.Generator().manual_seed(
        DROPOUT_SEEDS[0]), LR)
    other, _ = step(c["state"], x, torch.Generator().manual_seed(99), LR)
    assert max(float((a - b).abs().max()) for a, b in zip(
        toptim.tree_leaves(first.params),
        toptim.tree_leaves(other.params))) > 10 * STEP_ATOL


def test_dp_dropout_masks_replicate_in_jax(cases):
    """The same in the JAX package: make_shard_map_train_step over [X; X]
    on 2 devices against make_train_step over X, one key a step."""
    j = cases["jax"]
    mesh = jax_data_mesh()
    x = batch(2)
    s1, tx = jtrainer.create_train_state(jax.random.PRNGKey(2), j["jm_d"],
                                         opt_cfgs()[0])
    s2 = jshard_state(s1, mesh)
    plain = jtrainer.make_train_step(j["jm_d"], tx, donate=False)
    dp = jtrainer.make_shard_map_train_step(j["jm_d"], tx, mesh,
                                            donate=False)
    xx = jshard_batch(cat_rows(x, x), mesh)
    x = {k: jnp.asarray(v) for k, v in x.items()}
    for seed in DROPOUT_SEEDS:
        key = jax.random.PRNGKey(seed)
        s1, m1 = plain(s1, x, key, jnp.float32(LR))
        s2, m2 = dp(s2, xx, key, jnp.float32(LR))
        np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                                   rtol=STEP_RTOL, atol=STEP_ATOL)
        assert int(m2["frames"]) == 2 * int(m1["frames"])
    for a, b in zip(jax.tree_util.tree_leaves(s2.params),
                    jax.tree_util.tree_leaves(s1.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=STEP_RTOL, atol=STEP_ATOL)


def test_sharded_decoder_matches_jax(cases):
    """tests/test_beam.py's sharded case on 2 ranks against the JAX
    function on a 2-device mesh: the same words, costs within 1e-5; every
    rank holds the whole batch's outputs, those of the single decode."""
    g = cases["jax"]["graph"]
    d = cases["inputs"]["decode"]
    jcfg = jbeam.BeamSearchConfig(beam=1e9, max_active=128)
    out_j = jbeam.make_sharded_beam_decoder(g, jcfg, jax_data_mesh())(
        jnp.asarray(d["ll"]), jnp.asarray(d["lens"]), jbeam.DeviceGraph.put(g)
    )
    want = jbeam.traceback(out_j, d["lens"], g.final_weight)
    single = tbeam.make_beam_decoder(d["graph"], d["cfg"])(
        d["ll"], d["lens"], tbeam.DeviceGraph.put(d["graph"], device="cpu"))
    outs = cases["ranks"].results()
    for o in outs:
        for (w_t, c_t), (w_j, c_j) in zip(o["decode"]["best"], want):
            assert w_t == w_j
            np.testing.assert_allclose(c_t, c_j, rtol=1e-5, atol=1e-5)
        for got, ref in zip(o["decode"]["outputs"], single.numpy()):
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)
        assert o["decode"]["outputs"].states.shape[1] == 4


def test_trainer_fit_on_two_ranks(cases):
    """Trainer(mesh=...).fit for 2 epochs with a checkpoint_dir: rank 0
    writes every file and rank 1 none; both ranks end and restore equal
    state, stop at the same epoch with equal reports, which are the
    single-process trainer's over the same global batches."""
    f = cases["inputs"]["fit"]
    plain = ttrainer.Trainer(f["cfg"], device="cpu")
    batches = lambda: iter([dict(b) for b in f["batches"]])  # noqa: E731
    want = plain.fit(batches, batches)
    outs = cases["ranks"].results()
    assert [o["fit"]["writes"] for o in outs] == [4, 0]
    ckpt = os.path.join(cases["work"], "ckpt")
    assert sorted(os.listdir(ckpt)) == ["epoch_1", "epoch_2", "sched.json"]
    assert all(os.listdir(os.path.join(ckpt, e)) == ["state.pt"]
               for e in ("epoch_1", "epoch_2"))
    a, b = (o["fit"] for o in outs)
    assert a["history"] == b["history"] and sorted(a["history"]) == [1, 2]
    assert a["epoch"] == b["epoch"] == a["restored_epoch"] == 3
    assert_ranks_equal(a["params"], b["params"])
    assert_ranks_equal(a["restored"], b["restored"])
    assert_ranks_equal(a["params"], a["restored"])
    assert torch.equal(a["restored_inner"]["sum_of_squares"],
                       b["restored_inner"]["sum_of_squares"])
    assert a["restored_step"] == b["restored_step"] == 6
    assert a["again"] == b["again"] == {}
    for epoch, h in want.items():
        for k in ("train_obj", "cv_obj"):
            np.testing.assert_allclose(a["history"][epoch][k], h[k],
                                       rtol=LOSS_RTOL)
        for k in ("train_acc", "cv_acc"):
            assert a["history"][epoch][k] == pytest.approx(h[k], abs=1e-9)
    for x, y in zip(a["params"], toptim.tree_leaves(plain.state.params)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0,
                                   atol=STEP_ATOL)


def test_recipe_trains_on_two_ranks(cases):
    """RecipeRun(mesh=...).train on the tone corpus: equal parameters on
    both ranks, and the single-process recipe's history and parameters."""
    r = cases["inputs"]["recipe"]
    plain = trun.RecipeRun(r["cfg"], os.path.join(cases["work"], "plain"),
                           LEXICON, PHONES, device="cpu")
    plain.build_lang()
    want = plain.train(*r["parts"])
    outs = cases["ranks"].results()
    a, b = (o["recipe"] for o in outs)
    assert_ranks_equal(a["params"], b["params"])
    assert a["history"] == b["history"] and sorted(a["history"]) == [1]
    for k in ("train_obj", "cv_obj"):
        np.testing.assert_allclose(a["history"][1][k], want[1][k],
                                   rtol=LOSS_RTOL)
    # adagrad divides by the root of each element's running sum of
    # squares, so float32 sums taken in another order (two ranks' partial
    # gradients) move an element with a near-zero gradient by ~1e-4 of
    # itself: each parameter is held in relative L2
    for x, y in zip(a["params"], toptim.tree_leaves(plain.params)):
        assert float((x - y).norm() / y.norm()) <= STEP_RTOL
    assert os.path.exists(os.path.join(cases["work"], "recipe", "model.pkl"))


def test_init_distributed_unreachable_coordinator_raises():
    with pytest.raises(RuntimeError):
        tdist.init_distributed(f"127.0.0.1:{free_port()}", 2, 1,
                               backend="gloo", timeout=1)
    assert not dist.is_initialized()


def test_init_distributed_without_launcher_is_a_no_op(monkeypatch):
    for k in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    tdist.init_distributed()
    assert not dist.is_initialized()
    assert (tdist.process_index(), tdist.process_count()) == (0, 1)


def test_init_distributed_needs_a_rank(monkeypatch):
    for k in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="rank"):
        tdist.init_distributed("127.0.0.1:1", num_processes=2)
    assert not dist.is_initialized()
