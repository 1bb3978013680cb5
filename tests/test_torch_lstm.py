"""The port's LSTM direction (eesen_tpu_torch/ops/lstm_cuda.py, plain
version on the CPU) against the JAX package: the XLA scan branch of
`_direction_scan` at f32, and the fused Pallas kernel in interpret mode
at bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eesen_tpu.models.bilstm import (
    BiLstmConfig, _direction_scan, init_bilstm_layer,
)
from eesen_tpu.ops.lstm_pallas import lstm_direction_fused_tm
from eesen_tpu_torch.models import bilstm as tbilstm
from eesen_tpu_torch.ops import lstm_cuda


def setup(t=11, b=3, d=5, h=4, seed=0):
    """JAX parameters and time-major inputs with mixed lengths."""
    cfg = BiLstmConfig(input_dim=d, cell_dim=h, compute_dtype=jnp.float32)
    p = init_bilstm_layer(jax.random.PRNGKey(seed), cfg)["fw"]
    p = {k: np.asarray(v) for k, v in p.items()}
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, b, d)).astype(np.float32)
    lens = rng.integers(t // 2, t + 1, size=b)
    lens[0] = t
    mask = (np.arange(t)[:, None] < lens[None, :]).astype(np.float32)
    return cfg, p, x, mask


def torch_args(p, x, mask, dtype):
    d, _, h = p["w_gifo_x"].shape
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    return dict(
        x=t(x).to(dtype), mask=t(mask),
        w_x=t(p["w_gifo_x"]).reshape(d, 4 * h).to(dtype),
        bias=t(p["bias"]).reshape(4 * h),
        w_m=t(p["w_gifo_m"]).reshape(h, 4 * h).to(dtype),
        ph=t(np.stack([p["phole_i_c"], p["phole_f_c"], p["phole_o_c"]])),
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_direction_matches_xla_scan_f32(seed):
    cfg, p, x, mask = setup(seed=seed)
    want = np.asarray(_direction_scan(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(mask), cfg, None,
    ))
    m = lstm_cuda.lstm_direction(**torch_args(p, x, mask, torch.float32))
    assert m.dtype == torch.float32
    # the wrapper returns the carry; the layer output is zero when padded
    np.testing.assert_allclose(
        m.numpy() * mask[:, :, None], want, rtol=0, atol=1e-5
    )


@pytest.mark.parametrize("state_bf16", [False, True])
@pytest.mark.parametrize("seed,block_t", [(0, 4), (3, 3)])
def test_plain_direction_matches_fused_kernel_bf16(seed, block_t, state_bf16):
    """T=11 runs several Pallas time blocks; both sides carry state in
    f32, cast products to bf16 and emit m in the state dtype."""
    _, p, x, mask = setup(seed=seed, d=6, h=5)
    want = np.asarray(lstm_direction_fused_tm(
        jnp.asarray(x), jnp.asarray(mask), p["w_gifo_x"], p["bias"],
        p["w_gifo_m"], p["phole_i_c"], p["phole_f_c"], p["phole_o_c"],
        block_t=block_t, interpret=True, state_bf16=state_bf16,
    ).astype(jnp.float32))
    m = lstm_cuda.lstm_direction(
        **torch_args(p, x, mask, torch.bfloat16), state_bf16=state_bf16
    )
    assert m.dtype == (torch.bfloat16 if state_bf16 else torch.float32)
    np.testing.assert_allclose(m.float().numpy(), want, rtol=2e-2, atol=2e-3)


def test_residuals_are_consistent():
    """with_residuals: gates and c reproduce m (o * tanh(c) on valid
    steps), in the dtypes of the kernel's contract (gates in the dtype of
    x, c in the state dtype)."""
    _, p, x, mask = setup(seed=5)
    m, c, gates = lstm_cuda.lstm_direction(
        **torch_args(p, x, mask, torch.float32), with_residuals=True
    )
    assert gates.dtype == torch.float32 and c.dtype == torch.float32
    m_bf, c_bf, g_bf = lstm_cuda.lstm_direction(
        **torch_args(p, x, mask, torch.bfloat16), state_bf16=True,
        with_residuals=True,
    )
    assert g_bf.dtype == c_bf.dtype == m_bf.dtype == torch.bfloat16
    h = m.shape[-1]
    o = gates[..., 3 * h:].float()
    valid = torch.from_numpy(mask)[:, :, None] > 0
    np.testing.assert_allclose(
        (o * torch.tanh(c))[valid.expand_as(m)].numpy(),
        m[valid.expand_as(m)].numpy(), rtol=1e-2, atol=1e-2,
    )


def test_direction_scan_ignores_state_bf16_on_cpu():
    """As in the JAX package's CPU path, state_bf16 does not change the
    CPU result: the state stays f32."""
    _, p, x, mask = setup(seed=4)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    outs = [
        tbilstm._direction_scan(
            tp, torch.from_numpy(x), torch.from_numpy(mask),
            tbilstm.BiLstmConfig(input_dim=5, cell_dim=4,
                                 compute_dtype=torch.float32,
                                 state_bf16=sb),
        )
        for sb in (False, True)
    ]
    assert outs[0].dtype == torch.float32
    assert torch.equal(outs[0], outs[1])
