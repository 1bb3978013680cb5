"""The v1 LSTM route: the recurrence alone over a precomputed input
projection, as CUDA kernels 4 (forward) and 5 (backward), their plain
PyTorch versions, the autograd Function `LstmScan` over the pair, and the
two entries that run a direction through it.

Replaces the TPU kernels `_fwd_kernel` and `_bwd_kernel`
(eesen_tpu/ops/lstm_pallas.py:50 and :94) behind `lstm_scan`
(lstm_pallas.py:246-297).  The JAX package takes this route for shapes
its fused kernel cannot hold (`_v1_direction_tm`, lstm_pallas.py:843-849);
the port takes it on the card where `lstm_cuda.fused_launch` refuses the
shape, above all H > 1024 (models/bilstm.py).

The route is bf16 whatever the model's compute dtype, as on the TPU: W_m
is cast to bf16 for the kernels, and `_v1_direction_tm` computes the
input projection as a float32 product of bf16-rounded x and W_x
(`torch.matmul` in float32 with TF32 off: the products of bf16 values
are exact in float32, as under `preferred_element_type=float32`).  The
recurrence returns the m carry [T, B, H] float32; `state_bf16` plays no
part.  The backward kernel emits dxw unrounded in float32; dW_m =
m_prevᵀ·dxw (a float32 product of bf16-rounded operands) and the three
peephole sums are computed here from dxw, as lstm_pallas.py:281-293 does
outside its kernel.

`lstm_scan_fwd` and `lstm_scan_bwd` are the wrappers: on a CUDA tensor
each launches its kernel (or raises), on a CPU tensor each runs its plain
version (`lstm_scan_fwd_ref`, `lstm_scan_bwd_ref`).

Each kernel has two designs, chosen per call by host arithmetic on the
shape (`fwd_launch`, `bwd_launch`), never by a switch or a retry:
- "cluster", wherever the cluster plans take H: kernel 4 is kernel 1's
  recurrence (`lstm_rec_kernel`, csrc/lstm_fwd.cu, entry
  `lstm_scan_fwd_rec`) over the caller's xw with c_raw as one more
  output, on `lstm_cuda.fwd_plan` (H <= 2624); kernel 5 is kernel 3's
  reverse recurrence (`lstm_bwd_rec_kernel`, csrc/lstm_bwd.cu, entry
  `lstm_scan_bwd_rec`) in its v1 instance, which reads the stored c_raw,
  writes dxw unrounded in float32 and keeps no per-row sums, on
  `lstm_cuda.bwd_plan(v1=True)` (H <= 1664).  W_m^T and the slice layout
  are made per call.
- "thread_per_unit" for wider cells: `csrc/lstm_scan_fwd.cu` (H <= 14528)
  and `csrc/lstm_scan_bwd.cu` (H <= 5811), one block per ROWS_PER_BLOCK
  batch rows, a thread per hidden unit (several past 1024), W_m streamed
  from L2 every step.
Either way a call counts once in `launches` / `bwd_launches`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch

from eesen_tpu_torch.ops import build, lstm_cuda
from eesen_tpu_torch.ops.lstm_cuda import MAX_THREADS, SMEM_LIMIT, _check

# kernel launches since the last reset (chip_smoke.py reads and resets
# them): `launches` counts kernel 4 (forward), `bwd_launches` kernel 5
launches = 0
bwd_launches = 0

ROWS_PER_BLOCK = 2            # thread-per-unit kernels: batch rows per
                              # thread block (1 or 2)

_BF, _F32 = torch.bfloat16, torch.float32


def lstm_scan_fwd_ref(
    xw: torch.Tensor, mask: torch.Tensor, w_m: torch.Tensor,
    ph: torch.Tensor,
) -> Tuple[torch.Tensor, ...]:
    """Plain version of kernel 4, step for step as `_fwd_kernel`
    (lstm_pallas.py:70-91): the recurrent operand is the m carry rounded
    to bf16, the products are float32 sums of bf16 values.  Returns
    (m carry, c carry, c_raw) [T, B, H] float32 and gates [T, B, 4H]
    bf16."""
    t_max, b, _ = xw.shape
    h = w_m.shape[0]
    wm = w_m.to(_BF).to(_F32)
    ph_i, ph_f, ph_o = ph[0], ph[1], ph[2]
    c = torch.zeros((b, h), dtype=_F32, device=xw.device)
    m = torch.zeros((b, h), dtype=_F32, device=xw.device)
    ms, cs, craws, gs = [], [], [], []
    for t in range(t_max):
        gifo = xw[t] + torch.matmul(m.to(_BF).to(_F32), wm)
        g = torch.tanh(gifo[:, 0 * h:1 * h])
        i = torch.sigmoid(gifo[:, 1 * h:2 * h] + c * ph_i)
        f = torch.sigmoid(gifo[:, 2 * h:3 * h] + c * ph_f)
        c_raw = f * c + i * g
        o = torch.sigmoid(gifo[:, 3 * h:4 * h] + c_raw * ph_o)
        m_raw = o * torch.tanh(c_raw)
        mt = mask[t][:, None]
        c = c_raw * mt + c * (1.0 - mt)
        m = m_raw * mt + m * (1.0 - mt)
        ms.append(m)
        cs.append(c)
        craws.append(c_raw)
        gs.append(torch.cat([g, i, f, o], dim=1).to(_BF))
    if t_max == 0:
        z = torch.zeros((0, b, h), dtype=_F32, device=xw.device)
        return z, z.clone(), z.clone(), torch.zeros(
            (0, b, 4 * h), dtype=_BF, device=xw.device)
    return (torch.stack(ms), torch.stack(cs), torch.stack(craws),
            torch.stack(gs))


def lstm_scan_bwd_ref(
    mask: torch.Tensor, gates: torch.Tensor, c_raw: torch.Tensor,
    c: torch.Tensor, gm: torch.Tensor, w_m: torch.Tensor, ph: torch.Tensor,
) -> torch.Tensor:
    """Plain version of kernel 5, step for step as `_bwd_kernel`
    (lstm_pallas.py:111-156): c_prev is the c carry one step back (zero
    at t=0); dm_{t-1} = bf16(dgifo_t)·bf16(W_m)ᵀ with float32 sums; padded
    steps pass dm and dc through.  Returns dxw [T, B, 4H] float32,
    unrounded."""
    t_max, b, _ = gates.shape
    h = w_m.shape[0]
    wm_t = w_m.to(_BF).to(_F32).t()
    ph_i, ph_f, ph_o = ph[0], ph[1], ph[2]
    dm = torch.zeros((b, h), dtype=_F32, device=gates.device)
    dc = torch.zeros((b, h), dtype=_F32, device=gates.device)
    zero = torch.zeros((b, h), dtype=_F32, device=gates.device)
    dxw = torch.empty((t_max, b, 4 * h), dtype=_F32, device=gates.device)
    for t in range(t_max - 1, -1, -1):
        g, i, f, o = gates[t].to(_F32).split(h, dim=1)
        c_prev = c[t - 1] if t > 0 else zero
        mt = mask[t][:, None]
        tanh_c = torch.tanh(c_raw[t])
        dm_total = gm[t] + dm
        dm_raw = dm_total * mt
        dc_raw = dc * mt
        do = dm_raw * tanh_c
        dc_raw = dc_raw + dm_raw * o * (1.0 - tanh_c * tanh_c)
        do_pre = do * o * (1.0 - o)
        dc_raw = dc_raw + do_pre * ph_o
        di_pre = dc_raw * g * i * (1.0 - i)
        df_pre = dc_raw * c_prev * f * (1.0 - f)
        dg_pre = dc_raw * i * (1.0 - g * g)
        dc = dc_raw * f + di_pre * ph_i + df_pre * ph_f + dc * (1.0 - mt)
        dgifo = torch.cat([dg_pre, di_pre, df_pre, do_pre], dim=1)
        dxw[t] = dgifo
        dm = (torch.matmul(dgifo.to(_BF).to(_F32), wm_t)
              + dm_total * (1.0 - mt))
    return dxw


def _launch_shape(what: str, h: int, smem_bytes) -> Tuple[int, int]:
    """(rows per block, threads) for a thread-per-unit kernel of the v1
    route: each thread owns ceil(H / 1024) hidden units; two rows a block
    unless the shared memory needs one.  Raises past its shared memory."""
    per = -(-h // MAX_THREADS)
    threads = min(MAX_THREADS, 32 * -(-h // (32 * per)))
    rows = ROWS_PER_BLOCK
    while rows > 1 and smem_bytes(h, rows) > SMEM_LIMIT:
        rows //= 2
    if smem_bytes(h, rows) > SMEM_LIMIT:
        raise ValueError(f"{what}: cell_dim {h} exceeds the kernel's "
                         f"shared memory")
    return rows, threads


def fwd_smem_bytes(h: int, rows: int) -> int:
    """Shared memory of kernel 4's thread-per-unit design
    (csrc/lstm_scan_fwd.cu)."""
    return 16 * rows * h


def bwd_smem_bytes(h: int, rows: int) -> int:
    """Shared memory of kernel 5's thread-per-unit design
    (csrc/lstm_scan_bwd.cu)."""
    return 40 * rows * h


class ScanLaunch(NamedTuple):
    design: str        # "cluster" or "thread_per_unit"
    plan: Union[lstm_cuda.FwdPlan, lstm_cuda.BwdPlan, Tuple[int, int]]
    # the cluster plan, or (rows per block, threads)


def fwd_launch(b: int, h: int) -> ScanLaunch:
    """Kernel 4's design at batch b, cell width h: the cluster recurrence
    on `lstm_cuda.fwd_plan(b, h)` where that takes H (H <= 2624), else
    the thread-per-unit kernel (H <= 14528; raises past it)."""
    plan = lstm_cuda.fwd_plan(b, h)
    if plan is not None:
        return ScanLaunch("cluster", plan)
    return ScanLaunch("thread_per_unit",
                      _launch_shape("lstm_scan_fwd", h, fwd_smem_bytes))


def bwd_launch(b: int, h: int) -> ScanLaunch:
    """Kernel 5's design: the v1 instance of kernel 3's cluster
    recurrence on `lstm_cuda.bwd_plan(b, h, v1=True)` where that takes H
    (H <= 1664), else the thread-per-unit kernel (H <= 5811; raises past
    it)."""
    plan = lstm_cuda.bwd_plan(b, h, v1=True)
    if plan is not None:
        return ScanLaunch("cluster", plan)
    return ScanLaunch("thread_per_unit",
                      _launch_shape("lstm_scan_bwd", h, bwd_smem_bytes))


def lstm_scan_fwd(
    xw: torch.Tensor, mask: torch.Tensor, w_m: torch.Tensor,
    ph: torch.Tensor,
) -> Tuple[torch.Tensor, ...]:
    """Kernel 4: xw [T, B, 4H] f32, mask [T, B] f32, w_m [H, 4H] bf16,
    ph [3, H] f32 -> (m carry, c carry, c_raw) [T, B, H] f32 and gates
    [T, B, 4H] bf16.  On the card the design is `fwd_launch(B, H)`'s:
    the cluster recurrence up to H = 2624, the thread-per-unit kernel
    above (to 14528); wider raises."""
    global launches
    if xw.device.type == "cpu":
        return lstm_scan_fwd_ref(xw, mask, w_m, ph)
    if xw.device.type != "cuda":
        raise ValueError(f"lstm_scan_fwd: unsupported device {xw.device}")
    t_max, b, _ = xw.shape
    h = w_m.shape[0]
    _check("lstm_scan_fwd", xw.device, {
        "xw": (xw, (t_max, b, 4 * h), _F32),
        "mask": (mask, (t_max, b), _F32),
        "w_m": (w_m, (h, 4 * h), _BF),
        "ph": (ph, (3, h), _F32),
    })
    launch = fwd_launch(b, h)
    m, c, c_raw = (torch.empty((t_max, b, h), dtype=_F32, device=xw.device)
                   for _ in range(3))
    gates = torch.empty((t_max, b, 4 * h), dtype=_BF, device=xw.device)
    if t_max > 0 and b > 0:
        lib = build.load()
        if launch.design == "cluster":
            w = w_m.t().contiguous()         # W_m^T [4H, H]: mma operand rows
            entry = "lstm_scan_fwd_rec"
        else:
            w, entry = w_m, "lstm_scan_fwd"
        err = getattr(lib, entry)(
            xw.data_ptr(), mask.data_ptr(), w.data_ptr(), ph.data_ptr(),
            m.data_ptr(), c.data_ptr(), c_raw.data_ptr(), gates.data_ptr(),
            t_max, b, h, *launch.plan,
            torch.cuda.current_stream(xw.device).cuda_stream,
        )
        build.check(err, entry)
        launches += 1
    return m, c, c_raw, gates


def lstm_scan_bwd(
    mask: torch.Tensor, gates: torch.Tensor, c_raw: torch.Tensor,
    c: torch.Tensor, gm: torch.Tensor, w_m: torch.Tensor, ph: torch.Tensor,
) -> torch.Tensor:
    """Kernel 5: the residuals of kernel 4 (gates bf16, c_raw and the c
    carry f32), gm [T, B, H] f32 (the cotangent of the m carry), w_m
    [H, 4H] bf16, ph [3, H] f32 -> dxw [T, B, 4H] f32.  On the card the
    design is `bwd_launch(B, H)`'s: the cluster recurrence up to H = 1664,
    the thread-per-unit kernel above (to 5811); wider raises."""
    global bwd_launches
    if gates.device.type == "cpu":
        return lstm_scan_bwd_ref(mask, gates, c_raw, c, gm, w_m, ph)
    if gates.device.type != "cuda":
        raise ValueError(f"lstm_scan_bwd: unsupported device {gates.device}")
    t_max, b, _ = gates.shape
    h = w_m.shape[0]
    _check("lstm_scan_bwd", gates.device, {
        "mask": (mask, (t_max, b), _F32),
        "gates": (gates, (t_max, b, 4 * h), _BF),
        "c_raw": (c_raw, (t_max, b, h), _F32),
        "c": (c, (t_max, b, h), _F32),
        "gm": (gm, (t_max, b, h), _F32),
        "w_m": (w_m, (h, 4 * h), _BF),
        "ph": (ph, (3, h), _F32),
    })
    launch = bwd_launch(b, h)
    dxw = torch.empty((t_max, b, 4 * h), dtype=_F32, device=gates.device)
    if t_max > 0 and b > 0:
        lib = build.load()
        if launch.design == "cluster":
            w = lstm_cuda.bwd_weight_slices(w_m, launch.plan, True)
            entry = "lstm_scan_bwd_rec"
        else:
            w = w_m.t().contiguous()         # [4H, H]: coalesced across h
            entry = "lstm_scan_bwd"
        err = getattr(lib, entry)(
            mask.data_ptr(), gates.data_ptr(), c_raw.data_ptr(),
            c.data_ptr(), gm.data_ptr(), w.data_ptr(), ph.data_ptr(),
            dxw.data_ptr(), t_max, b, h, *launch.plan,
            torch.cuda.current_stream(gates.device).cuda_stream,
        )
        build.check(err, entry)
        bwd_launches += 1
    return dxw


def _shift(a: torch.Tensor) -> torch.Tensor:
    """a one step later in time: a[t-1] at t, zeros at t=0."""
    return torch.cat([torch.zeros_like(a[:1]), a[:-1]])


class LstmScan(torch.autograd.Function):
    """`lstm_scan`'s custom VJP (lstm_pallas.py:246-297): forward = kernel
    4 with residuals (mask, gates, c_raw, c, m, bf16 W_m, ph); backward =
    kernel 5 for dxw, then dW_m = m_prevᵀ·dxw and the peephole sums in
    plain torch.  W_m may come in float32: it is cast to bf16 here and
    its gradient stays float32."""

    @staticmethod
    def forward(ctx, xw, mask, w_m, ph):
        w_bf = w_m.to(_BF)
        m, c, c_raw, gates = lstm_scan_fwd(xw, mask, w_bf, ph)
        ctx.save_for_backward(mask, gates, c_raw, c, m, w_bf, ph)
        return m

    @staticmethod
    def backward(ctx, gm):
        mask, gates, c_raw, c, m, w_bf, ph = ctx.saved_tensors
        t_max, b, g4 = gates.shape
        h = g4 // 4
        dxw = lstm_scan_bwd(mask, gates, c_raw, c,
                            gm.to(_F32).contiguous(), w_bf, ph)
        c_prev = _shift(c)
        dw_m = torch.matmul(
            _shift(m).to(_BF).to(_F32).reshape(t_max * b, h).t(),
            dxw.to(_BF).to(_F32).reshape(t_max * b, g4),
        )
        dph = torch.stack([
            (dxw[:, :, 1 * h:2 * h] * c_prev).sum((0, 1)),
            (dxw[:, :, 2 * h:3 * h] * c_prev).sum((0, 1)),
            (dxw[:, :, 3 * h:4 * h] * c_raw).sum((0, 1)),
        ])
        return dxw, None, dw_m, dph


def lstm_scan(
    xw: torch.Tensor, mask: torch.Tensor, w_m: torch.Tensor,
    ph: torch.Tensor,
) -> torch.Tensor:
    """The v1 recurrence (counterpart of `lstm_scan`, lstm_pallas.py:247):
    xw [T, B, 4H] f32 (input projection + bias, GIFO blocks), mask [T, B]
    f32, w_m [H, 4H] (cast to bf16), ph [3, H] f32 -> m carry [T, B, H]
    f32.  Through `LstmScan` when autograd needs a gradient."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xw, w_m, ph)):
        return LstmScan.apply(xw, mask, w_m, ph)
    return lstm_scan_fwd(xw, mask, w_m.to(_BF), ph)[0]


def _v1_direction_tm(
    x: torch.Tensor, mask: torch.Tensor, w_gifo_x: torch.Tensor,
    bias: torch.Tensor, w_gifo_m: torch.Tensor, ph_i: torch.Tensor,
    ph_f: torch.Tensor, ph_o: torch.Tensor,
) -> torch.Tensor:
    """One direction through the v1 route (counterpart of
    `_v1_direction_tm`, lstm_pallas.py:881-918): x [T, B, D] (already
    time-flipped for the backward direction), mask [T, B] f32, w_gifo_x
    [D, 4, H], bias [4, H], w_gifo_m [H, 4, H], peepholes [H].  The input
    projection is one float32 product of bf16-rounded operands outside
    the kernels (its gradient from autograd); returns the m carry
    [T, B, H] f32."""
    t_max, b, d = x.shape
    h = w_gifo_m.shape[0]
    xw = torch.matmul(
        x.to(_BF).to(_F32), w_gifo_x.reshape(d, 4 * h).to(_BF).to(_F32)
    ) + bias.reshape(4 * h)
    return lstm_scan(xw.contiguous(), mask.contiguous(),
                     w_gifo_m.reshape(h, 4 * h),
                     torch.stack([ph_i, ph_f, ph_o]))


def lstm_direction_xproj(
    x_proj: torch.Tensor, mask: torch.Tensor, w_gifo_m: torch.Tensor,
    ph_i: torch.Tensor, ph_f: torch.Tensor, ph_o: torch.Tensor,
) -> torch.Tensor:
    """Batch-major runner over a precomputed projection (counterpart of
    `lstm_direction_pallas`, lstm_pallas.py:925-958): x_proj [B, T, 4, H]
    f32 (input projection + bias), mask [B, T] f32 -> m carry [B, T, H]
    f32."""
    b, t_max, four, h = x_proj.shape
    if four != 4:
        raise ValueError(f"x_proj must be [B, T, 4, H], got "
                         f"{tuple(x_proj.shape)}")
    xw = x_proj.reshape(b, t_max, 4 * h).transpose(0, 1).contiguous()
    m = lstm_scan(xw, mask.t().contiguous(), w_gifo_m.reshape(h, 4 * h),
                  torch.stack([ph_i, ph_f, ph_o]))
    return m.transpose(0, 1)
