"""Read/write the reference's binary nnet model format (counterpart of
eesen_tpu/models/serialize.py).

Byte-compatible with the reference's `Net::Write`/`Layer::Read`
(reference: src/net/net.cc:318-337, src/net/layer.cc:133-175 framing —
`\\0B<Nnet> ` then per layer `<Marker> <InputDim> i <CellDim|OutputDim> i`
followed by layer data; src/net/bilstm-layer.h:317-470 BiLstm ReadData/
WriteData token + weight order; src/net/affine-trans-layer.h ReadData;
src/base/io-funcs.cc basic-type encodings: floats as '\\x04'+4 bytes,
bools as 'T'/'F').

The token I/O and the weight layouts stay numpy on the host: the
reference's [4H, D] GIFO rows are converted to and from the gate-
structured [D, 4, H] of models/model.py.  `read_eesen_nnet` returns
float32 tensors on `device` ("cuda" unless the caller asks for the CPU);
`write_eesen_nnet` takes tensors on any device, moves each to the host
once, and writes the JAX package's bytes for the same parameters.

The optimizer state is one flat vector (training/optim.OptState), so
`extract_accus` / `inject_accus` take the parameters as well: the
accumulator is unravelled onto their shapes and ravelled back
(training/optim.unravel / ravel, ravel_pytree's layout).

Kept from the reference implementation: the accumulator block
(`<BiLstmAccus>` / `<LstmAccus>`) is written right after `<MaxGrad>`,
before any dropout token, which is the order this module reads but not
the one the reference's `BiLstm::ReadData` expects.
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO, Dict, List, Optional, Tuple

import numpy as np
import torch

from eesen_tpu_torch.models.model import (
    AcousticModelConfig, as_tensor, check_device, params_from_jax,
)
from eesen_tpu_torch.training.optim import (
    OptState, ravel, tree_leaves, tree_unflatten, unravel,
)


# --------------------------------------------------------------------------
# low-level binary helpers (Kaldi io-funcs semantics)
# --------------------------------------------------------------------------

def _read_token(f: BinaryIO) -> str:
    tok = []
    while True:
        c = f.read(1)
        if not c or c == b" ":
            break
        tok.append(c.decode("latin1"))
    return "".join(tok)


def _peek(f: BinaryIO) -> bytes:
    return f.peek(1)[:1]


def _expect_token(f: BinaryIO, want: str) -> None:
    got = _read_token(f)
    if got != want:
        raise ValueError(f"expected {want!r}, got {got!r}")


def _read_int(f: BinaryIO) -> int:
    assert f.read(1) == b"\x04"
    return struct.unpack("<i", f.read(4))[0]


def _read_float(f: BinaryIO) -> float:
    assert f.read(1) == b"\x04"
    return struct.unpack("<f", f.read(4))[0]


def _read_bool(f: BinaryIO) -> bool:
    return f.read(1) == b"T"


def _read_matrix(f: BinaryIO) -> np.ndarray:
    tok = _read_token(f)
    dtype = {"FM": np.float32, "DM": np.float64}[tok]
    rows, cols = _read_int(f), _read_int(f)
    return np.frombuffer(
        f.read(rows * cols * dtype().itemsize), dtype=dtype
    ).reshape(rows, cols).astype(np.float32)


def _read_vector(f: BinaryIO) -> np.ndarray:
    tok = _read_token(f)
    dtype = {"FV": np.float32, "DV": np.float64}[tok]
    n = _read_int(f)
    return np.frombuffer(
        f.read(n * dtype().itemsize), dtype=dtype
    ).astype(np.float32)


def _write_token(f: BinaryIO, tok: str) -> None:
    f.write(tok.encode("latin1") + b" ")


def _write_int(f: BinaryIO, v: int) -> None:
    f.write(b"\x04" + struct.pack("<i", v))


def _write_float(f: BinaryIO, v: float) -> None:
    f.write(b"\x04" + struct.pack("<f", v))


def _write_bool(f: BinaryIO, v: bool) -> None:
    f.write(b"T" if v else b"F")


def _write_matrix(f: BinaryIO, m: np.ndarray) -> None:
    m = np.ascontiguousarray(m, np.float32)
    _write_token(f, "FM")
    _write_int(f, m.shape[0])
    _write_int(f, m.shape[1])
    f.write(m.tobytes())


def _write_vector(f: BinaryIO, v: np.ndarray) -> None:
    v = np.ascontiguousarray(v, np.float32)
    _write_token(f, "FV")
    _write_int(f, len(v))
    f.write(v.tobytes())


# --------------------------------------------------------------------------
# layer readers
# --------------------------------------------------------------------------

_BILSTM_OPTIONAL = [
    # (token, reader) in the order WriteData emits them
    ("<LearnRateCoef>", _read_float),
    ("<MaxGrad>", _read_float),
    ("<ForwardDropoutFactor>", _read_float),
    ("<ForwardTimeStepDropout>", _read_bool),
    ("<ForwardSequenceDropout>", _read_bool),
    ("<RecurrentTimeStepDropout>", _read_bool),
    ("<RecurrentSequenceDropout>", _read_bool),
    ("<RNNDrop>", _read_bool),
    ("<NoMemLossDropout>", _read_bool),
    ("<RecurrentDropoutFactor>", _read_float),
    ("<TwiddleForward>", _read_bool),
]


def _read_optional_tokens(f: BinaryIO, table) -> Dict[str, Any]:
    """Read the reference's optional '<Tok> value' prefix sequence.

    Optimizer accumulators (AdaGrad/RMSProp squared-grad sums,
    bilstm-layer.h:376-395 / lstm-layer.h:117-128 / affine-trans-layer.h
    :99-106) are captured under the "_accus" key as a list of raw
    direction dicts in file order — read_eesen_nnet maps them into a
    params-shaped tree for optimizer-state interop."""
    out: Dict[str, Any] = {}
    while _peek(f) == b"<":
        # peek the whole token without consuming if unknown
        pos = f.tell()
        tok = _read_token(f)
        if tok in ("<BiLstmAccus>", "<LstmAccus>"):
            n_dir = 2 if tok == "<BiLstmAccus>" else 1
            out["_accus"] = [_read_direction_block(f) for _ in range(n_dir)]
            continue
        if tok == "<AffineAccus>":
            out["_accus"] = {"w": _read_matrix(f).T.copy(),
                            "b": _read_vector(f)}
            continue
        reader = dict(table).get(tok)
        if reader is None:
            f.seek(pos)
            break
        out[tok] = reader(f)
    return out


def _gifo_to_ours(w: np.ndarray) -> np.ndarray:
    """[4H, D] GIFO-rows -> [D, 4, H]."""
    fourh, d = w.shape
    h = fourh // 4
    return np.transpose(w.reshape(4, h, d), (2, 0, 1))


def _gifo_from_ours(w: np.ndarray) -> np.ndarray:
    """[D, 4, H] -> [4H, D]."""
    d, four, h = w.shape
    return np.transpose(w, (1, 2, 0)).reshape(4 * h, d)


def _read_direction_block(f: BinaryIO) -> Dict[str, np.ndarray]:
    """One direction's 6 tensors (w_gifo_x, w_gifo_m, bias, 3 peepholes)
    in file layout, converted to our packing."""
    w_x = _read_matrix(f)
    w_m = _read_matrix(f)
    bias = _read_vector(f)
    ph_i = _read_vector(f)
    ph_f = _read_vector(f)
    ph_o = _read_vector(f)
    h = len(bias) // 4
    return {
        "w_gifo_x": _gifo_to_ours(w_x),
        "w_gifo_m": _gifo_to_ours(w_m),
        "bias": bias.reshape(4, h),
        "phole_i_c": ph_i,
        "phole_f_c": ph_f,
        "phole_o_c": ph_o,
    }


def _read_bilstm(
    f: BinaryIO, cell_dim: int, directions: Tuple[str, ...] = ("fw", "bw"),
) -> Tuple[Dict, Dict[str, Any]]:
    opts = _read_optional_tokens(f, _BILSTM_OPTIONAL)
    params = {d: _read_direction_block(f) for d in directions}
    if "_accus" in opts:
        opts["_accus"] = dict(zip(directions, opts["_accus"]))
    return params, opts


def _read_affine(f: BinaryIO) -> Tuple[Dict, Dict[str, Any]]:
    opts = _read_optional_tokens(
        f, [("<LearnRateCoef>", _read_float), ("<MaxGrad>", _read_float)]
    )
    linearity = _read_matrix(f)   # [out, in]
    bias = _read_vector(f)
    return {"w": linearity.T.copy(), "b": bias}, opts


# the accumulators of optim.OptState.inner that are the reference's
# `*_corr_accu` buffers (train-opts.h adagrad/rmsprop update rules)
_ACCUS = ("sum_of_squares", "nu")


def extract_accus(opt_state: OptState, params) -> Any:
    """The squared-grad accumulator of a flat optimizer state (adagrad's
    sum_of_squares, rmsprop's nu) as a tree shaped like `params`, or None
    if the optimizer has none (SGD)."""
    for name in _ACCUS:
        if name in opt_state.inner:
            return unravel(params, opt_state.inner[name])
    return None


def inject_accus(opt_state: OptState, accus) -> OptState:
    """`opt_state` with its squared-grad accumulator replaced by `accus`
    (a params-shaped tree, e.g. from read_eesen_nnet(with_accus=True)),
    ravelled onto the accumulator's device; unchanged if the optimizer
    has none."""
    for name in _ACCUS:
        if name in opt_state.inner:
            old = opt_state.inner[name]
            flat = ravel(tree_unflatten(accus, [
                as_tensor(x, old.dtype).to(old.device)
                for x in tree_leaves(accus)]))
            if flat.shape != old.shape:
                raise ValueError(
                    f"accumulators hold {flat.numel()} values, the "
                    f"optimizer state {old.numel()}")
            return OptState(opt_state.hyperparams,
                            {**opt_state.inner, name: flat})
    return opt_state


def _host(tree):
    """`tree` with every leaf as a host numpy array (one copy each)."""
    return tree_unflatten(tree, [
        x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
        for x in tree_leaves(tree)
    ])


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

def read_eesen_nnet(
    path: str, with_accus: bool = False, device="cuda",
):
    """Load a reference-format model file into (params, model config),
    the parameters as float32 tensors on `device` in the layout of
    models/model.params_from_jax.

    Handles <BiLstm>/<BiLstmParallel> AND unidirectional
    <Lstm>/<LstmParallel> stacks (src/net/lstm-layer.h) +
    <AffineTransform> + <Softmax> (the standard eesen CTC topologies).

    with_accus=True additionally returns a params-shaped tree of the
    AdaGrad/RMSProp squared-grad accumulators (tensors on `device`) if
    the file carries them (<BiLstmAccus>/<LstmAccus>/<AffineAccus>), else
    None — feed it to inject_accus() to resume the reference's optimizer
    state."""
    import io as _io

    device = check_device(device)
    with open(path, "rb") as raw:
        f = _io.BufferedReader(raw)
        hdr = f.read(2)
        if hdr != b"\x00B":
            raise ValueError("text-format nnet not supported; use binary")
        layers: List[Dict] = []
        layer_accus: List[Optional[Dict]] = []
        out: Optional[Dict] = None
        out_accus: Optional[Dict] = None
        dims: List[Tuple[int, int]] = []
        bidirectional = True
        dropout: Dict[str, Any] = {}
        while True:
            tok = _read_token(f)
            if tok in ("", "</Nnet>"):
                break
            if tok == "<Nnet>":
                continue
            if tok in ("<BiLstm>", "<BiLstmParallel>",
                       "<Lstm>", "<LstmParallel>"):
                bi = tok in ("<BiLstm>", "<BiLstmParallel>")
                _expect_token(f, "<InputDim>")
                dim_in = _read_int(f)
                _expect_token(f, "<CellDim>")
                cell = _read_int(f)
                dirs = ("fw", "bw") if bi else ("fw",)
                params, opts = _read_bilstm(
                    f, cell // 2 if bi else cell, dirs
                )
                layers.append(params)
                layer_accus.append(opts.pop("_accus", None))
                dims.append((dim_in, cell // 2 if bi else cell))
                bidirectional = bi
                dropout = opts
            elif tok == "<AffineTransform>":
                _expect_token(f, "<InputDim>")
                dim_in = _read_int(f)
                _expect_token(f, "<OutputDim>")
                _read_int(f)
                out, aopts = _read_affine(f)
                out_accus = aopts.pop("_accus", None)
            elif tok == "<Softmax>":
                _expect_token(f, "<InputDim>")
                _read_int(f)
                _expect_token(f, "<OutputDim>")
                _read_int(f)
            elif tok in ("<Sigmoid>", "<Tanh>"):
                raise ValueError(f"unsupported layer {tok} in CTC stack")
            else:
                raise ValueError(f"unknown layer marker {tok!r}")
        if not layers or out is None:
            raise ValueError("no BiLstm/output layers found")
        cfg = AcousticModelConfig(
            input_dim=dims[0][0],
            cell_dim=dims[0][1],
            num_layers=len(layers),
            num_targets=out["b"].shape[0],
            forward_dropout=float(
                dropout.get("<ForwardDropoutFactor>", 0.0)
            ),
            recurrent_dropout=float(
                dropout.get("<RecurrentDropoutFactor>", 0.0)
            ),
            forward_step_dropout=bool(
                dropout.get("<ForwardTimeStepDropout>", False)
            ),
            recurrent_step_dropout=bool(
                dropout.get("<RecurrentTimeStepDropout>", False)
            ),
            bidirectional=bidirectional,
        )
        params = {"layers": layers, "out": out}
        if with_accus:
            accus = None
            if any(a is not None for a in layer_accus) or out_accus:
                zeros = tree_unflatten(params, [
                    np.zeros_like(x) for x in tree_leaves(params)])
                accus = params_from_jax({
                    "layers": [
                        a if a is not None else zeros["layers"][i]
                        for i, a in enumerate(layer_accus)
                    ],
                    "out": out_accus if out_accus is not None
                    else zeros["out"],
                }, device)
            return params_from_jax(params, device), cfg, accus
        return params_from_jax(params, device), cfg


def _write_direction_block(f: BinaryIO, p: Dict) -> None:
    p = {k: np.asarray(v) for k, v in p.items()}
    _write_matrix(f, _gifo_from_ours(p["w_gifo_x"]))
    _write_matrix(f, _gifo_from_ours(p["w_gifo_m"]))
    _write_vector(f, p["bias"].reshape(-1))
    _write_vector(f, p["phole_i_c"])
    _write_vector(f, p["phole_f_c"])
    _write_vector(f, p["phole_o_c"])


def write_eesen_nnet(
    path: str, params: Dict, cfg: AcousticModelConfig,
    parallel: bool = False,
    accus: Optional[Dict] = None,
) -> None:
    """Write our params (tensors on any device, or numpy arrays) in the
    reference's binary format (readable by the reference's
    net-output-extract / format-to-nonparallel); the bytes are the JAX
    package's for the same values.

    accus: optional params-shaped squared-grad accumulator tree (from
    extract_accus) written as <BiLstmAccus>/<LstmAccus>/<AffineAccus>
    blocks so the reference's AdaGrad/RMSProp training can resume
    (bilstm-layer.h:376-395 ReadData accumulator branch).  The
    accumulator block follows <MaxGrad> directly, as the JAX package
    writes it (module docstring)."""
    if accus is not None and not isinstance(accus, dict):
        raise TypeError(
            "accus must be a params-shaped tree (extract_accus(opt_state, "
            f"params)), not {type(accus).__name__}")
    params = _host(params)
    accus = None if accus is None else _host(accus)
    if cfg.bidirectional:
        marker = "<BiLstmParallel>" if parallel else "<BiLstm>"
        dirs = ("fw", "bw")
        accu_tok = "<BiLstmAccus>"
    else:
        marker = "<LstmParallel>" if parallel else "<Lstm>"
        dirs = ("fw",)
        accu_tok = "<LstmAccus>"
    actual = cfg.layer_output_dim
    with open(path, "wb") as f:
        f.write(b"\x00B")
        _write_token(f, "<Nnet>")
        for li, layer in enumerate(params["layers"]):
            dim_in = cfg.input_dim if li == 0 else actual
            _write_token(f, marker)
            _write_token(f, "<InputDim>")
            _write_int(f, dim_in)
            _write_token(f, "<CellDim>")
            _write_int(f, actual)
            _write_token(f, "<LearnRateCoef>")
            _write_float(f, 1.0)
            _write_token(f, "<MaxGrad>")
            _write_float(f, 50.0)
            if accus is not None:
                _write_token(f, accu_tok)
                for direction in dirs:
                    _write_direction_block(f, accus["layers"][li][direction])
            for direction in dirs:
                _write_direction_block(f, layer[direction])
        out = {k: np.asarray(v) for k, v in params["out"].items()}
        _write_token(f, "<AffineTransform>")
        _write_token(f, "<InputDim>")
        _write_int(f, actual)
        _write_token(f, "<OutputDim>")
        _write_int(f, cfg.num_targets)
        _write_token(f, "<LearnRateCoef>")
        _write_float(f, 1.0)
        _write_token(f, "<MaxGrad>")
        _write_float(f, 50.0)
        if accus is not None:
            _write_token(f, "<AffineAccus>")
            _write_matrix(f, np.asarray(accus["out"]["w"]).T)
            _write_vector(f, np.asarray(accus["out"]["b"]))
        _write_matrix(f, out["w"].T)
        _write_vector(f, out["b"])
        _write_token(f, "<Softmax>")
        _write_token(f, "<InputDim>")
        _write_int(f, cfg.num_targets)
        _write_token(f, "<OutputDim>")
        _write_int(f, cfg.num_targets)
        _write_token(f, "</Nnet>")
