from eesen_tpu_torch.io.kaldi_io import (
    read_ark,
    read_scp,
    read_rspecifier,
    write_ark,
    read_matrix,
    write_matrix,
)
from eesen_tpu_torch.io.wave import read_wav
from eesen_tpu_torch.io.datadir import DataDir

__all__ = [
    "read_ark",
    "read_scp",
    "read_rspecifier",
    "write_ark",
    "read_matrix",
    "write_matrix",
    "read_wav",
    "DataDir",
]
