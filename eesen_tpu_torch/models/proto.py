"""nnet.proto text topology format: parse + emit.

The reference describes model topology as a text "proto" emitted by
utils/model_topo.py (reference: asr_egs/wsj/utils/model_topo.py:112-136)
and consumed by net-initialize (reference: src/netbin/net-initialize.cc:30
-> Net::Init, src/net/net.cc:217, per-line Layer::InitData).  A proto is a
`<Nnet>`...`</Nnet>` block with one layer per line:

    <BiLstmParallel> <InputDim> 120 <CellDim> 640 <ParamRange> 0.1
        <LearnRateCoef> 1.0 <MaxGrad> 50.0 [<FgateBias> 1.0] [dropout...]
    <AffineTransform> <InputDim> 640 <OutputDim> 72 <ParamRange> 0.1
    <Softmax> <InputDim> 72 <OutputDim> 72

`<CellDim>` is the reference's "actual" cell dim = 2x the per-direction
cell dim for bidirectional layers (model_topo.py:135 actual_cell_dim).
Dropout tokens follow src/net/bilstm-parallel-layer.h InitData
(e.g. asr_egs/librispeech/config/nnet.proto.nml_seq_fw_seq_tw).

We map the proto onto `AcousticModelConfig`, which expresses the same
homogeneous stack (N BiLSTM layers + affine + softmax); heterogeneous
stacks the reference could express but no recipe uses (projection layers
between LSTMs) are rejected with a clear error.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from eesen_tpu_torch.models.conformer import refuse
from eesen_tpu_torch.models.model import AcousticModelConfig


def _tokens_to_dict(parts: List[str]) -> Dict[str, str]:
    """['<A>', '1', '<B>', 'x'] -> {'A': '1', 'B': 'x'} (valueless tokens
    map to 'T' like the reference's bool reads)."""
    out: Dict[str, str] = {}
    i = 0
    while i < len(parts):
        tok = parts[i]
        if not (tok.startswith("<") and tok.endswith(">")):
            i += 1
            continue
        key = tok[1:-1]
        if i + 1 < len(parts) and not parts[i + 1].startswith("<"):
            out[key] = parts[i + 1]
            i += 2
        else:
            out[key] = "T"
            i += 1
    return out


def _bool(v: str) -> bool:
    return v.strip() in ("T", "t", "true", "1")


def parse_nnet_proto(text: str) -> AcousticModelConfig:
    """Parse a model_topo.py-style nnet.proto into AcousticModelConfig."""
    lstm_lines = []
    affine_lines = []
    bidirectional: Optional[bool] = None
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line in ("<Nnet>", "</Nnet>"):
            continue
        parts = line.split()
        marker = parts[0]
        opts = _tokens_to_dict(parts[1:])
        if marker in ("<BiLstmParallel>", "<BiLstm>",
                      "<LstmParallel>", "<Lstm>"):
            bi = marker in ("<BiLstmParallel>", "<BiLstm>")
            if bidirectional is None:
                bidirectional = bi
            elif bidirectional != bi:
                raise NotImplementedError(
                    "mixed Lstm/BiLstm stacks are not supported"
                )
            lstm_lines.append(opts)
        elif marker == "<AffineTransform>":
            affine_lines.append(opts)
        elif marker == "<Softmax>":
            pass  # implicit: folded into the loss / decoder
        else:
            raise ValueError(f"unsupported proto marker {marker}")
    if not lstm_lines:
        raise ValueError("proto has no LSTM layers")
    if len(affine_lines) != 1:
        raise NotImplementedError(
            "only the standard stack (N x BiLSTM + 1 AffineTransform + "
            "Softmax) is supported; projection/input-reduction layers are "
            "not used by any reference recipe"
        )
    first = lstm_lines[0]
    actual_cell = int(first["CellDim"])
    if bidirectional:
        # <CellDim> is 2x the per-direction dim for BiLstm
        # (model_topo.py:135 actual_cell_dim); for uni <Lstm> it IS the
        # cell dim (layer.cc:119-124 passes it as output_dim)
        if actual_cell % 2:
            raise ValueError(
                f"<CellDim> {actual_cell} is odd (must be 2x the "
                "per-direction cell dim for BiLstm)")
        cell_dim = actual_cell // 2
    else:
        cell_dim = actual_cell
    input_dim = int(first["InputDim"])
    for opts in lstm_lines[1:]:
        if int(opts["CellDim"]) != actual_cell:
            raise NotImplementedError("non-uniform cell dims in proto")
        if int(opts["InputDim"]) != actual_cell:
            raise ValueError("inner LSTM InputDim must equal CellDim")
    out = affine_lines[0]
    if int(out["InputDim"]) != actual_cell:
        raise ValueError("AffineTransform InputDim must equal CellDim")
    num_targets = int(out["OutputDim"])

    fw_drop = float(first.get("ForwardDropoutFactor", 0.0))
    rec_drop = float(first.get("RecurrentDropoutFactor", 0.0))
    # step vs sequence masks: the reference tokens name the SEQUENCE
    # variant; absent -> per-step (bilstm-parallel-layer.h mask reuse)
    fw_seq = _bool(first.get("ForwardSequenceDropout", "F"))
    rec_seq = _bool(first.get("RecurrentSequenceDropout", "F"))
    mode = "no_mem_loss"
    if _bool(first.get("RnnDrop", "F")):
        mode = "rnndrop"
    return AcousticModelConfig(
        input_dim=input_dim,
        cell_dim=cell_dim,
        num_layers=len(lstm_lines),
        num_targets=num_targets,
        param_range=float(first.get("ParamRange", 0.1)),
        fgate_bias=float(first.get("FgateBias", 0.0)),
        forward_dropout=fw_drop,
        recurrent_dropout=rec_drop,
        forward_step_dropout=fw_drop > 0 and not fw_seq,
        recurrent_step_dropout=rec_drop > 0 and not rec_seq,
        recurrent_dropout_mode=mode,
        twiddle=_bool(first.get("TwiddleForward", "F")),
        bidirectional=bool(bidirectional),
    )


def emit_nnet_proto(cfg: AcousticModelConfig, max_grad: float = 50.0) -> str:
    """AcousticModelConfig -> model_topo.py-compatible proto text (a
    Conformer has no Eesen proto: NotImplementedError)."""
    refuse(cfg, "proto.emit_nnet_proto")
    actual = cfg.layer_output_dim
    common = (f" <ParamRange> {cfg.param_range} <LearnRateCoef> 1.0"
              f" <MaxGrad> {max_grad}")
    if cfg.fgate_bias:
        common += f" <FgateBias> {cfg.fgate_bias}"
    if cfg.forward_dropout > 0:
        common += f" <ForwardDropoutFactor> {cfg.forward_dropout}"
        if not cfg.forward_step_dropout:
            common += " <ForwardSequenceDropout> T"
    if cfg.recurrent_dropout > 0:
        common += f" <RecurrentDropoutFactor> {cfg.recurrent_dropout}"
        if not cfg.recurrent_step_dropout:
            common += " <RecurrentSequenceDropout> T"
        if cfg.recurrent_dropout_mode == "no_mem_loss":
            common += " <NoMemLossDropout> T"
        elif cfg.recurrent_dropout_mode == "rnndrop":
            common += " <RnnDrop> T"
    if cfg.twiddle:
        common += " <TwiddleForward> T"
    lines = ["<Nnet>"]
    in_dim = cfg.input_dim
    marker = "<BiLstmParallel>" if cfg.bidirectional else "<LstmParallel>"
    for _ in range(cfg.num_layers):
        lines.append(
            f"{marker} <InputDim> {in_dim} <CellDim> {actual}"
            + common
        )
        in_dim = actual
    lines.append(
        f"<AffineTransform> <InputDim> {actual} <OutputDim> "
        f"{cfg.num_targets} <ParamRange> {cfg.param_range} "
        f"<MaxGrad> {max_grad}"
    )
    lines.append(
        f"<Softmax> <InputDim> {cfg.num_targets} <OutputDim> "
        f"{cfg.num_targets}"
    )
    lines.append("</Nnet>")
    return "\n".join(lines) + "\n"
