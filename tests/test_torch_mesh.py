"""The port's mesh rules (eesen_tpu_torch/parallel) against the JAX
package's (eesen_tpu/parallel), and the mesh path in a world of one
process on the CPU: MeshConfig.resolve, the partition specs, the batch
rows a rank takes, and the data-parallel step, the Trainer and the
sharded decoder against their single-process runs (RecipeRun(mesh=...):
tests/test_torch_recipe.py).  Two real processes are
tests/test_torch_distributed.py."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from eesen_tpu.models import model as jmodel
from eesen_tpu.parallel import mesh as jmesh
from eesen_tpu.parallel import sharding as jsharding
from eesen_tpu.decoder.graph_compile import compile_graph
from eesen_tpu_torch.decoder import beam as tbeam
from eesen_tpu_torch.models import model as tmodel
from eesen_tpu_torch.parallel import distributed as tdist
from eesen_tpu_torch.parallel import mesh as tmesh
from eesen_tpu_torch.parallel import sharding as tsharding
from eesen_tpu_torch.training import optim as toptim
from eesen_tpu_torch.training import trainer as ttrainer

from tests.test_torch_beam import batch as beam_batch
from tests.test_torch_beam import tlg, to_port_graph  # noqa: F401
from tests.test_torch_train import (
    SMALL, batch, configs, to_torch, trainer_cfgs,
)


def cpu_mesh():
    """The mesh of this process alone (no process group)."""
    return tmesh.make_mesh(device="cpu")


def rank_mesh(rank, data=2):
    """Rank `rank`'s place on a data axis of `data`, without a process
    group: enough for the rules that need no collective."""
    return tmesh.Mesh(data, rank, torch.device("cpu"))


def outcome(fn):
    try:
        return fn()
    except Exception as e:      # the error itself is what is compared
        return type(e), str(e)


@pytest.mark.parametrize("data,model", [
    (d, m) for d in (-1, 0, 1, 2, 3, 4) for m in (0, 1, 2)])
def test_resolve_matches_jax(data, model):
    for n in (1, 2, 3, 4, 6, 8):
        want = outcome(lambda: jmesh.MeshConfig(data, model).resolve(n))
        got = outcome(lambda: tmesh.MeshConfig(data, model).resolve(n))
        if isinstance(want, jmesh.MeshConfig):
            want = dataclasses.astuple(want)
            got = dataclasses.astuple(got)
        assert got == want, (data, model, n)


def test_make_mesh_of_one_process():
    m = cpu_mesh()
    assert (m.data, m.rank, m.device.type, m.group) == (1, 0, "cpu", None)
    with pytest.raises(ValueError, match="mesh 2x1 != device count 1"):
        tmesh.make_mesh(tmesh.MeshConfig(data=2), device="cpu")


@pytest.mark.parametrize("cfg", [tmesh.MeshConfig(model=2),
                                 tmesh.MeshConfig(data=1, model=4)])
def test_model_axis_raises(cfg):
    """A model axis larger than a world of one raises JAX's ValueError,
    with its message, as make_mesh on one device does."""
    want = outcome(lambda: jmesh.make_mesh(
        jmesh.MeshConfig(cfg.data, cfg.model), devices=jax.devices()[:1]))
    got = outcome(lambda: tmesh.make_mesh(cfg, device="cpu"))
    assert want[0] is ValueError and got == want


def test_make_mesh_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.make_mesh()


def spec_leaves(tree):
    """Specs in JAX's leaf order (dict keys sorted), tuples as leaves."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in spec_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in spec_leaves(v)]
    return [tree]


@pytest.mark.parametrize("bidirectional", [True, False])
def test_pspecs_match_jax(bidirectional):
    jcfg = jmodel.AcousticModelConfig(**SMALL, bidirectional=bidirectional)
    jparams = jmodel.init_model(jax.random.PRNGKey(0), jcfg)
    want = [tuple(p) for p in jax.tree_util.tree_leaves(
        jsharding.tree_pspecs(jparams), is_leaf=lambda x: isinstance(x, P))]
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    ported = tmodel.params_from_jax(np_tree, device="cpu")
    for tree in (np_tree, ported):
        assert spec_leaves(tsharding.tree_pspecs(tree)) == want
        assert [tsharding.leaf_pspec(x)
                for x in toptim.tree_leaves(tree)] == want
    assert {tuple(jsharding.leaf_pspec(x)) for x in
            jax.tree_util.tree_leaves(jparams)} == {
        (None, None, "model"), (None, "model"), ("model", None), ()}
    assert tsharding.param_sharding_rules is tsharding.leaf_pspec
    assert tsharding.param_pspecs is tsharding.tree_pspecs


def test_batch_pspec_matches_jax():
    want = {k: tuple(v) for k, v in jsharding.batch_pspec().items()}
    assert tsharding.batch_pspec() == want


@pytest.mark.parametrize("rank,world", [(0, 1), (0, 2), (1, 2), (2, 3),
                                        (3, 4)])
def test_host_shard(rank, world):
    items = [f"utt{i}" for i in range(11)]
    assert tdist.host_shard(items, rank, world) == items[rank::world]
    assert tdist.host_shard(items) == items      # this process alone


def global_rows(b=4):
    rng = np.random.default_rng(0)
    return {
        "feats": rng.standard_normal((b, 5, 3)).astype(np.float32),
        "feat_lengths": np.arange(b, dtype=np.int32) + 2,
        "labels": rng.integers(1, 5, (b, 2)).astype(np.int32),
        "label_lengths": np.full(b, 2, np.int32),
        "keys": [f"u{i}" for i in range(b)],
    }


@pytest.mark.parametrize("rank", [0, 1])
def test_shard_batch_rows_match_jax(rank):
    """Rank r takes the rows JAX's shard_batch places on device r of a
    MeshConfig(data=2) mesh."""
    rows = global_rows()
    jm = jmesh.make_mesh(jmesh.MeshConfig(data=2, model=1),
                         devices=jax.devices()[:2])
    want = jsharding.shard_batch(rows, jm)
    got = tsharding.shard_batch(rows, rank_mesh(rank))
    assert sorted(got) == sorted(want)
    for k, arr in want.items():
        shard, = [s for s in arr.addressable_shards
                  if s.device == jm.devices[rank, 0]]
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(shard.data))
        assert got[k].device.type == "cpu"


def test_uneven_batch_raises():
    rows = global_rows(3)
    jm = jmesh.make_mesh(jmesh.MeshConfig(data=2, model=1),
                         devices=jax.devices()[:2])
    with pytest.raises(ValueError):
        jsharding.shard_batch(rows, jm)
    with pytest.raises(ValueError, match="3 rows does not split"):
        tsharding.shard_batch(rows, rank_mesh(0))


def test_global_batch_keeps_the_local_rows():
    rows = global_rows()
    got = tdist.global_batch(rows, cpu_mesh())
    assert sorted(got) == sorted(tsharding.batch_pspec())
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), rows[k])
    assert not np.shares_memory(got["feats"].numpy(), rows["feats"])


def test_shard_state_copies_onto_the_mesh():
    _, tm, _, to = configs()
    st, _ = ttrainer.create_train_state(torch.Generator().manual_seed(0),
                                        tm, to, device="cpu")
    sh = tsharding.shard_state(st, cpu_mesh())
    assert sh.step == st.step and sh.opt_state.hyperparams == \
        st.opt_state.hyperparams
    for a, b in zip(toptim.tree_leaves((st.params, st.opt_state.inner)),
                    toptim.tree_leaves((sh.params, sh.opt_state.inner))):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


def test_coordinator_of_one_process():
    assert tdist.is_coordinator()
    assert (tdist.process_index(), tdist.process_count()) == (0, 1)


@pytest.mark.parametrize("loss", ["ctc", "ce"])
def test_dp_step_of_one_process_is_the_plain_step(loss):
    """In a world of one, make_shard_map_train_step gives the plain step's
    bits: loss, metrics and parameters after 3 steps."""
    _, tm, _, to = configs()
    b = to_torch(batch(4))
    if loss == "ce":
        b["labels"] = torch.from_numpy(np.random.default_rng(1).integers(
            0, 5, b["feats"].shape[:2]).astype(np.int32))
    st, tx = ttrainer.create_train_state(torch.Generator().manual_seed(3),
                                         tm, to, device="cpu")
    plain = ttrainer.make_train_step(tm, tx, loss=loss, with_argmax=True)
    dp = ttrainer.make_shard_map_train_step(tm, tx, cpu_mesh(), loss=loss,
                                            with_argmax=True)
    s1 = s2 = st
    for _ in range(3):
        s1, m1 = plain(s1, b, None, 0.05)
        s2, m2 = dp(s2, b, None, 0.05)
        assert sorted(m1) == sorted(m2)
        for k in m1:
            assert torch.equal(m1[k], m2[k]), k
    for a, c in zip(toptim.tree_leaves(s1), toptim.tree_leaves(s2)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(c))


def test_trainer_of_one_process_is_the_plain_trainer():
    _, tcfg = trainer_cfgs()
    plain = ttrainer.Trainer(tcfg, device="cpu")
    meshed = ttrainer.Trainer(tcfg, mesh=cpu_mesh())
    assert meshed.device == torch.device("cpu")
    for train in (True, False):
        batches = lambda: iter([batch(s) for s in range(3)])  # noqa: E731
        r1 = plain.run_epoch(batches(), train, 0.05)
        r2 = meshed.run_epoch(batches(), train, 0.05)
        assert vars(r1) == vars(r2)
    for a, c in zip(toptim.tree_leaves(plain.state.params),
                    toptim.tree_leaves(meshed.state.params)):
        assert torch.equal(a, c)


def test_sharded_decoder_of_one_process_is_the_decoder(tlg):  # noqa: F811
    lang, fst = tlg
    g = to_port_graph(compile_graph(fst, max_degree=8, build_closure=True))
    ll, lens = beam_batch(lang)
    cfg = tbeam.BeamSearchConfig(beam=12.0, max_active=32, lattice_beam=2.0)
    dg = tbeam.DeviceGraph.put(g, device="cpu")
    want = tbeam.make_beam_decoder(g, cfg)(ll, lens, dg)
    got = tbeam.make_sharded_beam_decoder(g, cfg, cpu_mesh())(ll, lens, dg)
    for a, c in zip(want, got):
        assert a.dtype == c.dtype and torch.equal(a, c)
    # a world of one's model axis holds every row too
    by_model = tbeam.make_sharded_beam_decoder(g, cfg, cpu_mesh(),
                                               axis="model")(ll, lens, dg)
    for a, c in zip(want, by_model):
        assert a.dtype == c.dtype and torch.equal(a, c)
    with pytest.raises(ValueError, match="not 'batch'"):
        tbeam.make_sharded_beam_decoder(g, cfg, cpu_mesh(), axis="batch")
    with pytest.raises(ValueError, match="3 rows does not split"):
        tbeam.make_sharded_beam_decoder(g, cfg, rank_mesh(0))(ll, lens, dg)
