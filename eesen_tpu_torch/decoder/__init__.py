from eesen_tpu_torch.decoder.greedy import greedy_decode, greedy_decode_logits
from eesen_tpu_torch.decoder.score import compute_wer, WerStats
from eesen_tpu_torch.decoder.fst import Fst, Arc
from eesen_tpu_torch.decoder.ctc_graph import (
    SymbolTable, compile_lang, build_lg, build_tlg, build_tlg_compiled, Lang,
)
from eesen_tpu_torch.decoder.arpa import arpa_to_fst
from eesen_tpu_torch.decoder.graph_compile import CompiledGraph, compile_graph
from eesen_tpu_torch.decoder.beam import (
    BeamSearchConfig, DeviceGraph, StreamingBeamDecoder,
    make_beam_decoder, make_sharded_beam_decoder, traceback,
)
from eesen_tpu_torch.decoder.dense import (
    DenseDeviceGraph, DenseGraph, build_dense_graph, decode_dense,
    make_dense_decoder, traceback_dense,
)
from eesen_tpu_torch.decoder.faster import FasterDecoder, FasterDecoderOptions
from eesen_tpu_torch.decoder.lattice import Lattice, lattice_from_beam

__all__ = [
    "greedy_decode",
    "greedy_decode_logits",
    "compute_wer",
    "WerStats",
    "Fst",
    "Arc",
    "SymbolTable",
    "compile_lang",
    "build_lg",
    "build_tlg",
    "build_tlg_compiled",
    "Lang",
    "arpa_to_fst",
    "CompiledGraph",
    "compile_graph",
    "BeamSearchConfig",
    "DeviceGraph",
    "make_beam_decoder",
    "make_sharded_beam_decoder",
    "StreamingBeamDecoder",
    "DenseGraph",
    "DenseDeviceGraph",
    "build_dense_graph",
    "decode_dense",
    "make_dense_decoder",
    "traceback_dense",
    "traceback",
    "FasterDecoder",
    "FasterDecoderOptions",
    "Lattice",
    "lattice_from_beam",
]
