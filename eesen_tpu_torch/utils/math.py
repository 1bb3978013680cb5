"""Log-space math helpers (counterpart of eesen_tpu/utils/math.py).

The reference's log-domain arithmetic (src/base/kaldi-math.h:171,195
LogAdd; src/gpucompute/ctc-utils.h:35-97 with log_zero = -1e30) with a
large-negative sentinel instead of -inf, so that no expression ever sees
inf - inf.
"""

from __future__ import annotations

import torch

# Log-zero sentinel (reference: src/gpucompute/ctc-utils.h:35): exp()
# underflows to 0 exactly, and a few sums of it stay finite in float32.
LOG_ZERO = -1e30
# Values below this threshold are treated as log-zero.
LOG_ZERO_THRESHOLD = -1e29


def log_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log(exp(a) + exp(b)), safe around the LOG_ZERO sentinel."""
    hi = torch.maximum(a, b)
    lo = torch.minimum(a, b)
    safe = hi > LOG_ZERO_THRESHOLD
    out = hi + torch.log1p(torch.exp(torch.where(safe, lo - hi, 0.0)))
    return torch.where(safe, out, LOG_ZERO)


def log_add3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return log_add(log_add(a, b), c)


def shift_right(x: torch.Tensor, n: int, fill: float = LOG_ZERO) -> torch.Tensor:
    """Shift along the last axis: out[..., s] = x[..., s-n], `fill` below n."""
    return torch.nn.functional.pad(x, (n, 0), value=fill)[..., : x.shape[-1]]


def shift_left(x: torch.Tensor, n: int, fill: float = LOG_ZERO) -> torch.Tensor:
    """Shift along the last axis: out[..., s] = x[..., s+n], `fill` at the
    end."""
    return torch.nn.functional.pad(x, (0, n), value=fill)[..., n:]
