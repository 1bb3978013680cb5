"""eesen_tpu_torch: the PyTorch/CUDA port of eesen_tpu (end-to-end CTC
speech recognition: BiLSTM acoustic model + WFST beam decoding).

Plain tensor code is PyTorch; the TPU's Pallas kernels become CUDA
kernels for Hopper under `csrc/`, built with nvcc at first use
(ops/build.py).  A kernel wrapper launches its kernel on a CUDA tensor
and runs the kernel's plain PyTorch version on a CPU tensor.

Float32 matrix products run in full float32: TF32 is switched off here,
for matmuls and convolutions alike, because the plain versions and the
parity checks against the JAX package assume it.
"""

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
