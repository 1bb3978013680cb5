"""The `model` mesh axis: parameters held as blocks over H across ranks,
on a data x model grid of gloo ranks on the CPU.

In this process: each rank's place on a 2 x 2 grid and its block of every
leaf against the JAX package's device grid and `addressable_shards`
(eesen_tpu/parallel/{mesh,sharding}.py), and an uneven split.  On four
real processes (a 2 x 2 mesh, started by the tests with a free localhost
port): the train step against JAX's make_shard_map_train_step on a 2 x 2
mesh of the conftest's virtual CPU devices, the dropout and eval steps,
Trainer.fit with checkpoints, RecipeRun(mesh=...) and the sharded decoder
over either axis; the files they write are held against those of a
data-only mesh of two of the ranks.  Two ranks on a 1 x 2 mesh are
tests/test_torch_distributed.py."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from eesen_tpu.decoder import beam as jbeam
from eesen_tpu.models import model as jmodel
from eesen_tpu.parallel.mesh import MeshConfig as JMeshConfig
from eesen_tpu.parallel.mesh import make_mesh as jmake_mesh
from eesen_tpu.parallel.sharding import shard_batch as jshard_batch
from eesen_tpu.parallel.sharding import shard_params as jshard_params
from eesen_tpu.parallel.sharding import shard_state as jshard_state
from eesen_tpu.training import trainer as jtrainer
from eesen_tpu_torch.decoder import beam as tbeam
from eesen_tpu_torch.models import model as tmodel
from eesen_tpu_torch.parallel import mesh as tmesh
from eesen_tpu_torch.parallel import sharding as tsharding
from eesen_tpu_torch.training import optim as toptim
from eesen_tpu_torch.training import trainer as ttrainer

from tests.test_torch_beam import tlg  # noqa: F401
from tests.test_torch_distributed import (
    DROPOUT, DROPOUT_SEEDS, LR, STEP_ATOL, STEP_RTOL, STEPS, Ranks,
    assert_ranks_equal, cat_rows, decode_case, model_cfgs, opt_cfgs,
    tone_features,
)
from tests.test_torch_beam import to_port_graph
from tests.test_torch_recipe import LEXICON, configs as recipe_configs
from tests.test_torch_recipe import corpus  # noqa: F401
from tests.test_recipe_e2e import PHONES
from tests.test_torch_train import (
    LOSS_RTOL, SMALL, batch, carried_state, to_torch, trainer_cfgs,
)

# the four-process run, start to end; every rank is killed past it
RUN_TIMEOUT_S = 150
DATA, MODEL = 2, 2

WORKER = r'''
import os, sys
rank, port, root, work = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
sys.path.insert(0, root)
import dataclasses
import torch
import torch.distributed as dist
from eesen_tpu_torch.decoder.beam import (
    DeviceGraph, make_sharded_beam_decoder, traceback)
from eesen_tpu_torch.parallel.distributed import init_distributed
from eesen_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from eesen_tpu_torch.parallel.sharding import (
    gather_params, shard_batch, shard_params, shard_state)
from eesen_tpu_torch.recipes.run import RecipeRun
from eesen_tpu_torch.training import trainer as tr
from eesen_tpu_torch.training.optim import make_optimizer, tree_leaves
from eesen_tpu_torch.training.schedule import NewbobScheduler

init_distributed(f"127.0.0.1:{port}", 4, rank, timeout=60)
mesh = make_mesh(MeshConfig(data=2, model=2), device="cpu")
# ranks 0 and 2 also form a data-only mesh (every rank makes the group)
pair = dist.new_group([0, 2])
inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
out = {"layout": (mesh.data, mesh.model, mesh.rank, mesh.data_index,
                  mesh.model_index)}

# (a) a tree placed on the mesh (rank 0's values), and gathered back
tree = inp["trees"][rank]
placed = shard_params(tree, mesh)
out["shards"] = tree_leaves(placed)
out["gathered"] = tree_leaves(gather_params(placed, mesh))
try:
    shard_params({"w": torch.zeros(4, 3)}, mesh)
except ValueError as e:
    out["uneven"] = str(e)


# (b) train steps, with and without dropout, and an eval step
def steps(case):
    c = inp[case]
    step = tr.make_shard_map_train_step(
        c["cfg"], make_optimizer(c["opt"]), mesh, with_argmax=True)
    state = shard_state(c["state"], mesh)
    local, metrics = shard_batch(c["batch"], mesh), []
    for seed in c["seeds"]:
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        state, m = step(state, local, gen, c["lr"])
        metrics.append(m)
    return {"shards": tree_leaves(state.params),
            "params": tree_leaves(gather_params(state.params, mesh)),
            "inner": state.opt_state.inner, "metrics": metrics,
            "step": state.step}


out["steps"] = steps("steps")
out["dropout"] = steps("dropout")
c = inp["steps"]
out["eval"] = tr.make_eval_step(c["cfg"], mesh=mesh)(
    shard_params(c["state"].params, mesh), shard_batch(c["batch"], mesh))

# (e) the sharded decode over either axis
d = inp["decode"]
dg = DeviceGraph.put(d["graph"], device="cpu")
out["decode"] = {}
for axis in ("data", "model"):
    res = make_sharded_beam_decoder(d["graph"], d["cfg"], mesh, axis=axis)(
        d["ll"], d["lens"], dg)
    out["decode"][axis] = {
        "outputs": res.numpy(),
        "best": traceback(res, d["lens"], d["graph"].final_weight)}


# (d) Trainer.fit with checkpoints (counting who writes), a restore, a
# resume, and the recipe's training stage, all under work/<tag>
def fit_and_recipe(m, tag):
    f = inp["fit"]
    tcfg = dataclasses.replace(
        f["cfg"], checkpoint_dir=os.path.join(work, tag, "ckpt"))
    writes = []
    real_save, real_sched = torch.save, NewbobScheduler.save
    torch.save = lambda obj, p, *a, **k: (writes.append(str(p)),
                                          real_save(obj, p, *a, **k))[1]
    NewbobScheduler.save = lambda self, p: (writes.append(p),
                                            real_sched(self, p))[1]
    batches = lambda: iter([dict(b) for b in f["batches"]])
    t = tr.Trainer(tcfg, mesh=m)
    hist = t.fit(batches, batches)
    torch.save, NewbobScheduler.save = real_save, real_sched
    t2 = tr.Trainer(tcfg, mesh=m)
    t2.restore_checkpoint(t2.latest_checkpoint())
    t3 = tr.Trainer(tcfg, mesh=m)
    res = {"history": hist, "writes": len(writes),
           "shards": tree_leaves(t.state.params),
           "params": tree_leaves(t.full_params()),
           "restored_shards": tree_leaves(t2.state.params),
           "restored_inner": t2.state.opt_state.inner,
           "restored_step": t2.state.step,
           "again": t3.fit(batches, batches)}
    r = inp["recipe"]
    run = RecipeRun(r["cfg"], os.path.join(work, tag, "recipe"),
                    r["lexicon"], r["units"], mesh=m, device="cpu")
    run.build_lang()
    res["recipe_history"] = run.train(*r["parts"])
    res["recipe_params"] = tree_leaves(run.params)
    return res


out["fit"] = fit_and_recipe(mesh, "mesh2x2")
if rank in (0, 2):
    out["fit_data_only"] = fit_and_recipe(
        make_mesh(MeshConfig(data=2), device="cpu", group=pair), "mesh2x1")

torch.save(out, os.path.join(work, f"rank{rank}.pt"))
torch.distributed.destroy_process_group()
print(f"rank{rank} OK", flush=True)
'''


def jax_mesh():
    return jmake_mesh(JMeshConfig(data=DATA, model=MODEL),
                      devices=jax.devices()[:DATA * MODEL])


def rank_mesh(rank):
    """Rank `rank`'s place on the 2 x 2 grid, without a process group:
    enough for the placement, which needs no collective."""
    return tmesh.Mesh(DATA, rank, torch.device("cpu"), model=MODEL)


def leaf_paths(tree, path=""):
    """Leaf names in JAX's leaf order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in leaf_paths(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in leaf_paths(v, f"{path}/{i}")]
    return [path]


LEAVES = leaf_paths(tmodel.init_model(
    torch.Generator().manual_seed(0),
    tmodel.AcousticModelConfig(**SMALL), "cpu"))


@pytest.fixture(scope="module")
def placed():
    """JAX's SMALL parameters placed on the 2 x 2 mesh, and the same
    values as the port's tree."""
    jm, _ = model_cfgs()
    jparams = jmodel.init_model(jax.random.PRNGKey(0), jm)
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    return (jax.tree_util.tree_leaves(jshard_params(jparams, jax_mesh())),
            tmodel.params_from_jax(np_tree, device="cpu"))


@pytest.mark.parametrize("rank", range(DATA * MODEL))
def test_rank_sits_where_jax_puts_its_device(rank):
    """Global rank r is device r of JAX's row-major (data, model) grid."""
    (d,), (m,) = np.nonzero(jax_mesh().devices == jax.devices()[rank])
    mesh = rank_mesh(rank)
    assert (mesh.data_index, mesh.model_index) == (d, m)
    assert mesh.axis("data") == (DATA, d) and mesh.axis("model") == (MODEL, m)


@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("rank", range(DATA * MODEL))
def test_shard_matches_jax_device(placed, rank, leaf):
    """Rank r's block of a leaf is the shard that JAX places on device r:
    the same index into the whole leaf and the same values."""
    jleaves, tree = placed
    i = LEAVES.index(leaf)
    shard, = [s for s in jleaves[i].addressable_shards
              if s.device == jax.devices()[rank]]
    whole = toptim.tree_leaves(tree)[i]
    got = toptim.tree_leaves(tsharding.shard_params(tree,
                                                    rank_mesh(rank)))[i]
    np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data))
    np.testing.assert_array_equal(got.numpy(), whole.numpy()[shard.index])
    assert got.is_contiguous()
    assert tuple(jleaves[i].sharding.spec) == tsharding.leaf_pspec(whole)


def test_uneven_split_raises_as_in_jax():
    """A [4, 3] leaf splits its 3 columns over 2: ValueError in both."""
    x = np.zeros((4, 3), np.float32)
    with pytest.raises(ValueError):
        jax.device_put(x, NamedSharding(jax_mesh(), P(None, "model")))
    with pytest.raises(ValueError, match="does not split its dimension 1"):
        tsharding.shard_params({"w": torch.from_numpy(x)}, rank_mesh(0))


def test_gather_needs_a_process_group(placed):
    _, tree = placed
    blocks = tsharding.shard_params(tree, rank_mesh(0))
    with pytest.raises(RuntimeError, match="process group"):
        tsharding.gather_params(blocks, rank_mesh(0))


@pytest.fixture(scope="module")
def cases(tlg, corpus, tmp_path_factory):  # noqa: F811
    """The inputs of the four-process run, and the ranks started on them
    (they run while the tests compute their references)."""
    work = str(tmp_path_factory.mktemp("model_axis"))
    jm, tm = model_cfgs()
    jo, to = opt_cfgs()
    jstate, _ = jtrainer.create_train_state(jax.random.PRNGKey(1), jm, jo)
    jm_d, tm_d = model_cfgs(**DROPOUT)
    jstate_d, _ = jtrainer.create_train_state(jax.random.PRNGKey(2), jm_d,
                                              jo)
    rows_x = batch(2)
    g, ll, lens = decode_case(tlg)
    _, fit_cfg = trainer_cfgs()
    parts = tone_features(corpus[0], os.path.join(work, "features"))
    for tag in ("mesh2x2", "mesh2x1"):
        os.makedirs(os.path.join(work, tag, "recipe"))
        shutil.copy(os.path.join(work, "features", "lang.pkl"),
                    os.path.join(work, tag, "recipe"))
    _, rcfg = recipe_configs()
    # each rank draws its own tree: the placement must take rank 0's
    trees = [tmodel.init_model(torch.Generator().manual_seed(40 + r), tm,
                               "cpu") for r in range(DATA * MODEL)]
    inputs = {
        "trees": trees,
        "steps": dict(cfg=tm, opt=to, state=carried_state(jstate), lr=LR,
                      batch=cat_rows(batch(0), batch(1)),
                      seeds=[None] * STEPS),
        "dropout": dict(cfg=tm_d, opt=to, state=carried_state(jstate_d),
                        lr=LR, batch=cat_rows(rows_x, rows_x),
                        seeds=list(DROPOUT_SEEDS)),
        "decode": dict(graph=to_port_graph(g), ll=ll, lens=lens,
                       cfg=tbeam.BeamSearchConfig(beam=1e9,
                                                  max_active=128)),
        "fit": dict(cfg=fit_cfg, batches=[cat_rows(batch(s), batch(s + 3))
                                          for s in range(3)]),
        "recipe": dict(cfg=rcfg, lexicon=LEXICON, units=PHONES, parts=parts),
    }
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    return dict(inputs=inputs, jax=dict(jm=jm, jo=jo, jm_d=jm_d, graph=g),
                ranks=Ranks(work, n=DATA * MODEL, worker=WORKER,
                            timeout=RUN_TIMEOUT_S),
                work=work)


def test_ranks_sit_on_the_grid_and_hold_rank0s_blocks(cases):
    """On four processes: rank r at (r // 2, r % 2); its blocks are those
    of rank 0's tree (each rank drew its own); the gather gives rank 0's
    whole tree on every rank; the uneven leaf raises on every rank."""
    outs = cases["ranks"].results()
    tree0 = cases["inputs"]["trees"][0]
    for r, o in enumerate(outs):
        assert o["layout"] == (DATA, MODEL, r, r // MODEL, r % MODEL)
        assert_ranks_equal(o["shards"], toptim.tree_leaves(
            tsharding.shard_params(tree0, rank_mesh(r))))
        assert_ranks_equal(o["gathered"], toptim.tree_leaves(tree0))
        assert "does not split its dimension 1" in o["uneven"]


def jax_steps(cfg, batch_rows, seeds, key):
    """JAX's shard_map step on the 2 x 2 mesh: (params, metrics)."""
    mesh = jax_mesh()
    state, tx = jtrainer.create_train_state(jax.random.PRNGKey(key), cfg,
                                            opt_cfgs()[0])
    state = jshard_state(state, mesh)
    step = jtrainer.make_shard_map_train_step(cfg, tx, mesh, donate=False,
                                              with_argmax=True)
    b = jshard_batch(batch_rows, mesh)
    metrics = []
    for seed in seeds:
        k = None if seed is None else jax.random.PRNGKey(seed)
        state, m = step(state, b, k, jnp.float32(LR))
        metrics.append(jax.tree_util.tree_map(np.asarray, m))
    return state, metrics


def test_model_mesh_steps_match_jax_shard_map(cases):
    """3 steps (f32, SGD momentum 0.9, max_grad 10) on the 2 x 2 mesh
    against make_shard_map_train_step on a 2 x 2 mesh of 4 devices: loss,
    obj_sum, frames, argmax and every gathered parameter; each rank's
    blocks are its blocks of JAX's parameters."""
    j = cases["jax"]
    state, want = jax_steps(j["jm"], cases["inputs"]["steps"]["batch"],
                            [None] * STEPS, 1)
    jleaves = jax.tree_util.tree_leaves(state.params)
    for r, o in enumerate(cases["ranks"].results()):
        assert o["steps"]["step"] == STEPS
        for got, w in zip(o["steps"]["metrics"], want):
            for k in ("loss", "obj_sum"):
                np.testing.assert_allclose(float(got[k]), float(w[k]),
                                           rtol=STEP_RTOL, atol=STEP_ATOL)
            assert int(got["frames"]) == int(w["frames"])
            np.testing.assert_array_equal(got["argmax"].numpy(), w["argmax"])
        for a, c in zip(o["steps"]["params"], jleaves):
            np.testing.assert_allclose(a.numpy(), np.asarray(c),
                                       rtol=STEP_RTOL, atol=STEP_ATOL)
        # the step keeps each rank's blocks in shard_state's placement
        # (after a step XLA may place a JAX leaf otherwise: it leaves the
        # model axis to the partitioner)
        blocks = tsharding.shard_params(
            [torch.from_numpy(np.array(c)) for c in jleaves], rank_mesh(r))
        for a, c in zip(o["steps"]["shards"], blocks):
            assert a.shape == c.shape
            np.testing.assert_allclose(a.numpy(), c.numpy(),
                                       rtol=STEP_RTOL, atol=STEP_ATOL)


def test_model_mesh_ranks_agree_in_bits(cases):
    """Every rank ends with the same whole parameters, bit for bit, and the
    same flat accumulator (replicated, as JAX's `P()`); the ranks of a
    data group (one model index) hold the same blocks."""
    outs = cases["ranks"].results()
    for case in ("steps", "dropout"):
        for o in outs[1:]:
            assert_ranks_equal(o[case]["params"], outs[0][case]["params"])
            assert torch.equal(o[case]["inner"]["trace"],
                               outs[0][case]["inner"]["trace"])
        for m in range(MODEL):
            group = [outs[r][case]["shards"]
                     for r in range(m, DATA * MODEL, MODEL)]
            for shards in group[1:]:
                assert_ranks_equal(shards, group[0])
        assert outs[0][case]["inner"]["trace"].shape == (
            toptim.ravel(cases["inputs"][case]["state"].params).numel(),)


def test_model_mesh_dropout_masks_replicate(cases):
    """A dropout step over [X; X] on the 2 x 2 mesh is the plain step over
    X with the same generator, as on the data-only mesh: rank 0's masks
    for its rows on every rank, whatever the model axis."""
    c = cases["inputs"]["dropout"]
    step = ttrainer.make_train_step(c["cfg"], toptim.make_optimizer(c["opt"]))
    state, x = c["state"], to_torch(batch(2))
    want = []
    for seed in DROPOUT_SEEDS:
        state, m = step(state, x, torch.Generator().manual_seed(seed), LR)
        want.append(m)
    for o in cases["ranks"].results():
        for got, w in zip(o["dropout"]["metrics"], want):
            np.testing.assert_allclose(float(got["loss"]), float(w["loss"]),
                                       rtol=STEP_RTOL, atol=STEP_ATOL)
            assert int(got["frames"]) == 2 * int(w["frames"])
        for a, b in zip(o["dropout"]["params"],
                        toptim.tree_leaves(state.params)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=STEP_RTOL,
                                       atol=STEP_ATOL)


def test_model_mesh_dropout_masks_replicate_in_jax(cases):
    """The same in the JAX package: the 2 x 2 shard_map step over [X; X]
    against make_train_step over X, one key a step."""
    j = cases["jax"]
    x = batch(2)
    _, got = jax_steps(j["jm_d"], cat_rows(x, x), DROPOUT_SEEDS, 2)
    s1, tx = jtrainer.create_train_state(jax.random.PRNGKey(2), j["jm_d"],
                                         opt_cfgs()[0])
    plain = jtrainer.make_train_step(j["jm_d"], tx, donate=False)
    x = {k: jnp.asarray(v) for k, v in x.items()}
    for seed, m2 in zip(DROPOUT_SEEDS, got):
        s1, m1 = plain(s1, x, jax.random.PRNGKey(seed), jnp.float32(LR))
        np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                                   rtol=STEP_RTOL, atol=STEP_ATOL)
        assert int(m2["frames"]) == 2 * int(m1["frames"])


def test_model_mesh_eval_step_matches_jax(cases):
    """make_eval_step(mesh=...) on the rank's blocks against JAX's eval
    step on parameters and rows placed on the 2 x 2 mesh."""
    j = cases["jax"]
    mesh = jax_mesh()
    jstate, _ = jtrainer.create_train_state(jax.random.PRNGKey(1), j["jm"],
                                            j["jo"])
    want = jtrainer.make_eval_step(j["jm"])(
        jshard_params(jstate.params, mesh),
        jshard_batch(cases["inputs"]["steps"]["batch"], mesh))
    for o in cases["ranks"].results():
        got = o["eval"]
        np.testing.assert_allclose(float(got["obj_sum"]),
                                   float(want["obj_sum"]), rtol=STEP_RTOL,
                                   atol=STEP_ATOL)
        assert int(got["frames"]) == int(want["frames"])
        np.testing.assert_array_equal(got["argmax"].numpy(),
                                      np.asarray(want["argmax"]))


def read(path):
    with open(path, "rb") as f:
        return f.read()


def test_trainer_fit_on_the_model_mesh(cases):
    """Trainer(mesh=2 x 2).fit for 2 epochs with a checkpoint_dir: rank 0
    writes every file, the others none; the files are byte for byte those
    of the data-only mesh of ranks 0 and 2 (whole tensors); a restore
    gives each rank its blocks, and a resume trains no further epoch."""
    outs = cases["ranks"].results()
    assert [o["fit"]["writes"] for o in outs] == [4, 0, 0, 0]
    assert [o["fit_data_only"]["writes"] for o in outs[::2]] == [4, 0]
    ckpt = {tag: os.path.join(cases["work"], tag, "ckpt")
            for tag in ("mesh2x2", "mesh2x1")}
    assert sorted(os.listdir(ckpt["mesh2x2"])) == [
        "epoch_1", "epoch_2", "sched.json"]
    for name in ("epoch_1/state.pt", "epoch_2/state.pt", "sched.json"):
        assert read(os.path.join(ckpt["mesh2x2"], name)) == read(
            os.path.join(ckpt["mesh2x1"], name)), name
    ref = outs[0]["fit_data_only"]
    for r, o in enumerate(outs):
        f = o["fit"]
        assert f["history"] == ref["history"] and sorted(f["history"]) == [
            1, 2]
        assert_ranks_equal(f["params"], ref["params"])
        assert_ranks_equal(f["restored_shards"], f["shards"])
        assert_ranks_equal(f["shards"], toptim.tree_leaves(
            tsharding.local_shards(toptim.tree_unflatten(
                cases["inputs"]["trees"][0], f["params"]), rank_mesh(r))))
        assert torch.equal(f["restored_inner"]["sum_of_squares"],
                           ref["restored_inner"]["sum_of_squares"])
        assert f["restored_step"] == 6 and f["again"] == {}
    plain = ttrainer.Trainer(cases["inputs"]["fit"]["cfg"], device="cpu")
    batches = lambda: iter(  # noqa: E731
        [dict(b) for b in cases["inputs"]["fit"]["batches"]])
    want = plain.fit(batches, batches)
    for epoch, h in want.items():
        for k in ("train_obj", "cv_obj"):
            np.testing.assert_allclose(ref["history"][epoch][k], h[k],
                                       rtol=LOSS_RTOL)


def test_recipe_trains_on_the_model_mesh(cases):
    """RecipeRun(mesh=2 x 2).train on the tone corpus: every rank's
    parameters are the whole tree, those of the data-only mesh in bits,
    and model.pkl is the data-only mesh's byte for byte."""
    outs = cases["ranks"].results()
    ref = outs[0]["fit_data_only"]
    for o in outs:
        assert o["fit"]["recipe_history"] == ref["recipe_history"]
        assert_ranks_equal(o["fit"]["recipe_params"], ref["recipe_params"])
    pkl = {tag: read(os.path.join(cases["work"], tag, "recipe", "model.pkl"))
           for tag in ("mesh2x2", "mesh2x1")}
    assert pkl["mesh2x2"] == pkl["mesh2x1"]


@pytest.mark.parametrize("axis", ["data", "model"])
def test_sharded_decoder_over_each_axis_matches_jax(cases, axis):
    """make_sharded_beam_decoder(axis=...) on the 2 x 2 mesh against the
    JAX function on a 2 x 2 mesh: the same words, costs within 1e-5, and
    every rank holds the whole batch's outputs, those of the single
    decode."""
    g = cases["jax"]["graph"]
    d = cases["inputs"]["decode"]
    jcfg = jbeam.BeamSearchConfig(beam=1e9, max_active=128)
    out_j = jbeam.make_sharded_beam_decoder(g, jcfg, jax_mesh(), axis=axis)(
        jnp.asarray(d["ll"]), jnp.asarray(d["lens"]), jbeam.DeviceGraph.put(g)
    )
    want = jbeam.traceback(out_j, d["lens"], g.final_weight)
    single = tbeam.make_beam_decoder(d["graph"], d["cfg"])(
        d["ll"], d["lens"], tbeam.DeviceGraph.put(d["graph"], device="cpu"))
    for o in cases["ranks"].results():
        got = o["decode"][axis]
        for (w_t, c_t), (w_j, c_j) in zip(got["best"], want):
            assert w_t == w_j
            np.testing.assert_allclose(c_t, c_j, rtol=1e-5, atol=1e-5)
        for a, ref in zip(got["outputs"], single.numpy()):
            assert a.dtype == ref.dtype
            np.testing.assert_array_equal(a, ref)
