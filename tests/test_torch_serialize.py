"""The port's Kaldi <Nnet> model files (eesen_tpu_torch/models/
serialize.py) against the JAX package's: byte-identical files from the
same parameters, each package reading the other's to equal bits, the
read-back model's outputs, and the optimizer accumulators, which the
port keeps in one flat vector (training/optim.OptState)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eesen_tpu.models import model as jmodel
from eesen_tpu.models import serialize as jser
from eesen_tpu.training import optim as joptim
from eesen_tpu_torch.models import model as tmodel
from eesen_tpu_torch.models import serialize as tser
from eesen_tpu_torch.training import optim as toptim

from tests.test_torch_model import inputs

SMALL = dict(input_dim=6, cell_dim=5, num_layers=2, num_targets=7)
GRAD = 0.5          # tests/test_unilstm.py:140's gradient, everywhere


def configs(bidirectional=True):
    return (jmodel.AcousticModelConfig(**SMALL, bidirectional=bidirectional,
                                       compute_dtype=jnp.float32),
            tmodel.AcousticModelConfig(**SMALL, bidirectional=bidirectional,
                                       compute_dtype=torch.float32))


@functools.lru_cache(maxsize=None)
def jax_params(cfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jmodel.init_model(jax.random.PRNGKey(seed), cfg))


def jax_accus(params, algorithm):
    """eesen_tpu's extract_accus on an optax tree state after one update
    with GRAD everywhere (tests/test_unilstm.py:140-172)."""
    tx = {"adagrad": optax.adagrad(0.1, initial_accumulator_value=0.0),
          "rmsprop": optax.rmsprop(0.1, decay=0.9, eps=1e-10)}[algorithm]
    g = jax.tree_util.tree_map(lambda x: jnp.full_like(x, GRAD), params)
    _, st = tx.update(g, tx.init(params), params)
    return jax.tree_util.tree_map(np.asarray, jser.extract_accus(st))


def port_state(params, algorithm, steps=1):
    """The port's flat optimizer state after `steps` updates with GRAD
    everywhere."""
    opt = toptim.make_optimizer(toptim.OptimizerConfig(algorithm=algorithm))
    st = opt.init(params)
    grads = toptim.tree_unflatten(params, [
        torch.full_like(x, GRAD) for x in toptim.tree_leaves(params)])
    for _ in range(steps):
        _, st = opt.update(grads, st, params)
    return st


def leaves_equal(a, b):
    la, lb = toptim.tree_leaves(a), toptim.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
        y = y.cpu().numpy() if torch.is_tensor(y) else np.asarray(y)
        assert x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("accus", [False, True], ids=["plain", "accus"])
@pytest.mark.parametrize("parallel", [False, True], ids=["", "parallel"])
@pytest.mark.parametrize("bidirectional", [True, False], ids=["bi", "uni"])
def test_files_match_jax(tmp_path, bidirectional, parallel, accus):
    """The same bytes from both packages' write_eesen_nnet, and each
    package reads the other's file to the same bits and config."""
    jcfg, tcfg = configs(bidirectional)
    jp = jax_params(jcfg)
    ja = jax_accus(jp, "adagrad") if accus else None
    tp = tmodel.params_from_jax(jp, device="cpu")
    ta = tmodel.params_from_jax(ja, device="cpu") if accus else None
    jpath, tpath = str(tmp_path / "jax.nnet"), str(tmp_path / "port.nnet")
    jser.write_eesen_nnet(jpath, jp, jcfg, parallel=parallel, accus=ja)
    tser.write_eesen_nnet(tpath, tp, tcfg, parallel=parallel, accus=ta)
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert g.read() == f.read()
    tp2, tcfg2, ta2 = tser.read_eesen_nnet(jpath, with_accus=True,
                                           device="cpu")
    jp2, jcfg2, ja2 = jser.read_eesen_nnet(tpath, with_accus=True)
    assert all(x.dtype == torch.float32 and x.device.type == "cpu"
               for x in toptim.tree_leaves(tp2))
    leaves_equal(tp2, jp)
    leaves_equal(jp2, jp)
    leaves_equal(tp2, jp2)
    assert (ta2 is None) == (ja2 is None) == (not accus)
    if accus:
        leaves_equal(ta2, ja)
        leaves_equal(ja2, ja)
    for f in dataclasses.fields(tcfg2):
        if f.name != "compute_dtype":
            assert getattr(tcfg2, f.name) == getattr(jcfg2, f.name), f.name
    assert tcfg2.compute_dtype == torch.bfloat16     # JAX: jnp.bfloat16


@pytest.mark.parametrize("bidirectional", [True, False], ids=["bi", "uni"])
def test_read_model_matches_jax_outputs(tmp_path, bidirectional):
    """A file the JAX package wrote, read on the CPU: apply_model at f32
    gives JAX's logits within tests/test_torch_model.py's f32 tolerance
    (sums in another order)."""
    jcfg, _ = configs(bidirectional)
    jp = jax_params(jcfg, seed=3)
    path = str(tmp_path / "m.nnet")
    jser.write_eesen_nnet(path, jp, jcfg)
    tp, tcfg = tser.read_eesen_nnet(path, device="cpu")
    tcfg = dataclasses.replace(tcfg, compute_dtype=torch.float32)
    feats = np.random.default_rng(0).standard_normal(
        (3, 9, SMALL["input_dim"])).astype(np.float32)
    lens = inputs()[1]
    want = np.asarray(jmodel.apply_model(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(feats),
        jnp.asarray(lens), jcfg))
    got = tmodel.apply_model(tp, torch.from_numpy(feats),
                             torch.from_numpy(lens), tcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("algorithm", ["adagrad", "rmsprop"])
def test_extract_accus_matches_jax(algorithm):
    """The port's flat accumulator unravelled onto the parameters equals
    eesen_tpu's extract_accus on the optax tree state, given the same
    gradient (the sums of squares are exact; rmsprop's (1 - rho) g^2 is
    the same f32 product in both)."""
    jcfg, _ = configs()
    jp = jax_params(jcfg)
    tp = tmodel.params_from_jax(jp, device="cpu")
    got = tser.extract_accus(port_state(tp, algorithm), tp)
    leaves_equal(got, jax_accus(jp, algorithm))
    assert sorted(got) == ["layers", "out"]


def test_inject_accus_round_trips_inner(tmp_path):
    """extract -> file -> read -> inject rebuilds the flat accumulator bit
    for bit on a fresh state; SGD (with or without momentum) has no
    accumulator to extract or inject."""
    _, tcfg = configs()
    tp = tmodel.init_model(torch.Generator().manual_seed(0), tcfg, "cpu")
    st = port_state(tp, "adagrad", steps=2)
    path = str(tmp_path / "a.nnet")
    tser.write_eesen_nnet(path, tp, tcfg, accus=tser.extract_accus(st, tp))
    _, _, accus = tser.read_eesen_nnet(path, with_accus=True, device="cpu")
    fresh = port_state(tp, "adagrad", steps=0)
    back = tser.inject_accus(fresh, accus)
    assert torch.equal(back.inner["sum_of_squares"],
                       st.inner["sum_of_squares"])
    assert not torch.equal(fresh.inner["sum_of_squares"],
                           back.inner["sum_of_squares"])
    with pytest.raises(ValueError, match="accumulators hold"):
        tser.inject_accus(fresh, {"out": accus["out"]})
    for momentum in (0.0, 0.9):
        opt = toptim.make_optimizer(toptim.OptimizerConfig(
            algorithm="sgd", momentum=momentum))
        sgd = opt.init(tp)
        assert tser.extract_accus(sgd, tp) is None
        assert tser.inject_accus(sgd, accus) is sgd


def test_text_header_raises_in_both(tmp_path):
    path = tmp_path / "text.nnet"
    path.write_text("<Nnet>\n<BiLstm> <InputDim> 6 <CellDim> 10\n</Nnet>\n")
    for mod, kw in ((jser, {}), (tser, {"device": "cpu"})):
        with pytest.raises(ValueError, match="text-format"):
            mod.read_eesen_nnet(str(path), **kw)


@pytest.mark.parametrize("bidirectional", [True, False], ids=["bi", "uni"])
def test_accus_block_follows_max_grad_in_both(tmp_path, bidirectional):
    """Pinned, not fixed (eesen_tpu/models/serialize.py:410): the
    accumulator block comes right after <MaxGrad>, before the dropout
    tokens the reference's BiLstm::ReadData expects first, in both
    packages' files."""
    jcfg, tcfg = configs(bidirectional)
    jp = jax_params(jcfg)
    tok = b"<BiLstmAccus> " if bidirectional else b"<LstmAccus> "
    for mod, cfg, params, accus in (
            (jser, jcfg, jp, jax_accus(jp, "adagrad")),
            (tser, tcfg, tmodel.params_from_jax(jp, device="cpu"),
             tmodel.params_from_jax(jax_accus(jp, "adagrad"),
                                    device="cpu"))):
        path = str(tmp_path / "a.nnet")
        mod.write_eesen_nnet(path, params, cfg, accus=accus)
        data = open(path, "rb").read()
        head = b"<MaxGrad> \x04" + np.float32(50.0).tobytes() + tok
        assert data.count(head) == SMALL["num_layers"]
        assert b"Dropout" not in data


def test_jax_flat_state_accus_are_refused(tmp_path):
    """Pinned, not fixed: on the JAX package's own flat optimizer state
    (make_optimizer(flat=True), the default) extract_accus returns the
    flat [P] vector, and write_eesen_nnet refuses it with TypeError.  The
    port's extract_accus takes the parameters and returns their shapes;
    a flat vector is refused with TypeError there too."""
    jcfg, tcfg = configs()
    jp = jax_params(jcfg)
    tx = joptim.make_optimizer(joptim.OptimizerConfig(algorithm="adagrad"))
    p = jax.tree_util.tree_map(jnp.asarray, jp)
    st = tx.init(p)
    g = jax.tree_util.tree_map(lambda x: jnp.full_like(x, GRAD), p)
    _, st = tx.update(g, st, p)
    flat = jser.extract_accus(st)
    n = sum(x.size for x in jax.tree_util.tree_leaves(jp))
    assert np.asarray(flat).shape == (n,)
    with pytest.raises(TypeError):
        jser.write_eesen_nnet(str(tmp_path / "j.nnet"), jp, jcfg,
                              accus=flat)
    tp = tmodel.params_from_jax(jp, device="cpu")
    tst = port_state(tp, "adagrad")
    assert tst.inner["sum_of_squares"].shape == (n,)
    with pytest.raises(TypeError, match="params-shaped"):
        tser.write_eesen_nnet(str(tmp_path / "t.nnet"), tp, tcfg,
                              accus=tst.inner["sum_of_squares"])
    # the flat vector is the same numbers as the port's, in ravel order
    np.testing.assert_array_equal(tst.inner["sum_of_squares"].numpy(),
                                  np.asarray(flat))
