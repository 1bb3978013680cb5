"""The port's nnet.proto parse/emit (eesen_tpu_torch/models/proto.py, a
host copy) against the JAX package's: the LibriSpeech proto of
tests/test_proto_tools.py, the emitted text of every RECIPES model, and
the projection-stack refusal."""

import dataclasses

import pytest

from eesen_tpu.models import proto as jproto
from eesen_tpu.recipes import config as jconfig
from eesen_tpu_torch.models import proto as tproto
from eesen_tpu_torch.recipes import config as tconfig

from tests.test_proto_tools import LIBRISPEECH_PROTO

# the fields the proto carries (the configs' dtypes and route switches
# are not in it)
PROTO_FIELDS = (
    "input_dim", "cell_dim", "num_layers", "num_targets", "param_range",
    "fgate_bias", "forward_dropout", "recurrent_dropout",
    "forward_step_dropout", "recurrent_step_dropout",
    "recurrent_dropout_mode", "twiddle", "bidirectional",
)


def fields(cfg):
    return {f: getattr(cfg, f) for f in PROTO_FIELDS}


def test_librispeech_proto_matches_jax():
    j = jproto.parse_nnet_proto(LIBRISPEECH_PROTO)
    t = tproto.parse_nnet_proto(LIBRISPEECH_PROTO)
    assert fields(t) == fields(j)
    assert (t.input_dim, t.cell_dim, t.num_layers, t.num_targets) == (
        360, 320, 2, 44)
    assert t.twiddle and not t.forward_step_dropout
    assert tproto.emit_nnet_proto(t) == jproto.emit_nnet_proto(j)


@pytest.mark.parametrize("bidirectional", [True, False], ids=["bi", "uni"])
@pytest.mark.parametrize("name", sorted(jconfig.RECIPES))
def test_recipe_protos_match_jax(name, bidirectional):
    """Every recipe's model (num_targets set as a lang would) emits the
    JAX package's text, and both parse it to the same fields, equal to
    the config's."""
    jcfg = dataclasses.replace(jconfig.RECIPES[name].model, num_targets=72,
                               bidirectional=bidirectional)
    tcfg = dataclasses.replace(tconfig.RECIPES[name].model, num_targets=72,
                               bidirectional=bidirectional)
    text = tproto.emit_nnet_proto(tcfg)
    assert text == jproto.emit_nnet_proto(jcfg)
    assert tproto.emit_nnet_proto(tcfg, max_grad=5.0) == (
        jproto.emit_nnet_proto(jcfg, max_grad=5.0))
    back = tproto.parse_nnet_proto(text)
    assert fields(back) == fields(jproto.parse_nnet_proto(text))
    assert fields(back) == fields(tcfg)


BAD_PROTOS = {
    "projection": """<Nnet>
<BiLstmParallel> <InputDim> 120 <CellDim> 640 <ParamRange> 0.1
<AffineTransform> <InputDim> 640 <OutputDim> 300 <ParamRange> 0.1
<AffineTransform> <InputDim> 300 <OutputDim> 72 <ParamRange> 0.1
<Softmax> <InputDim> 72 <OutputDim> 72
</Nnet>""",
    "mixed": """<Nnet>
<BiLstmParallel> <InputDim> 120 <CellDim> 640
<LstmParallel> <InputDim> 640 <CellDim> 640
<AffineTransform> <InputDim> 640 <OutputDim> 72
</Nnet>""",
    "odd_cell": """<Nnet>
<BiLstmParallel> <InputDim> 120 <CellDim> 641
<AffineTransform> <InputDim> 641 <OutputDim> 72
</Nnet>""",
}


@pytest.mark.parametrize("case", sorted(BAD_PROTOS))
def test_bad_protos_raise_as_in_jax(case):
    """The projection stack (tests/test_proto_tools.py), a mixed
    Lstm/BiLstm stack and an odd bidirectional <CellDim>: the same
    exception type and message in both packages."""
    errors = []
    for mod in (jproto, tproto):
        with pytest.raises((NotImplementedError, ValueError)) as e:
            mod.parse_nnet_proto(BAD_PROTOS[case])
        errors.append((type(e.value), str(e.value)))
    assert errors[1] == errors[0]
    if case == "projection":
        assert errors[1][0] is NotImplementedError
