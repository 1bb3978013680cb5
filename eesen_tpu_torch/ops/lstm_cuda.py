"""One LSTM direction, input projection and recurrence fused: the CUDA
kernels `csrc/lstm_fwd.cu` (forward) and `csrc/lstm_bwd.cu` (backward),
their plain PyTorch versions, the autograd Function over the pair, and
the route choice `fused_launch`.

Replaces the TPU kernels `_fused_fwd_kernel` and `_fused_bwd_kernel`
(eesen_tpu/ops/lstm_pallas.py:323 and :379, entry
`lstm_direction_fused_tm`, whose custom VJP `LstmDirection` mirrors).  GIFO
gate order with i/f/o peepholes (src/net/lstm-layer.h:70-73 of the
reference toolkit); padded steps (mask 0) freeze the c and m carries.

`lstm_direction` is the forward wrapper and `lstm_direction_bwd` the
backward one: on a CUDA tensor each launches its kernel (or raises), on a
CPU tensor each runs its plain version (`lstm_direction_ref`,
`lstm_direction_bwd_ref`).  Weights are gate-packed as [D, 4H] / [H, 4H]
(the [D, 4, H] parameters reshaped).  `lstm_direction` returns the m
CARRY [T, B, H]: at a padded step it repeats the previous m, so callers
multiply by the mask to get the layer output.  When autograd needs a
gradient it returns through `LstmDirection`, whose forward keeps the
residuals (c carry, gates) and whose backward is the backward kernel.

Kernel 1 is two device kernels behind one call (one count in `launches`):
the input projection of all T*B rows as one tiled product into a float32
scratch, then the recurrence on thread-block clusters whose CTAs keep
their slice of W_m in shared memory (`fwd_plan` sizes them).  Kernel 3
(one count in `bwd_launches`) is its reverse recurrence on clusters of
the same shape (`bwd_plan`; each CTA keeps its W_m slice, laid out by
`bwd_weight_slices`, and the step's dm is reduce-scattered through
distributed shared memory), then the per-row sums and the three tiled
products.  On the bf16 path the four products run on one wgmma + TMA
kernel (csrc/gemm_wgmma.cu; `gemm_plan` splits the weight gradients over
k, `gemm_bf16` calls the product alone), on the f32 path on an FMA one
(csrc/gemm_tile.cuh).

Which route a direction takes on the card: `fused_launch(B, D, H)` gives
the launch parameters of kernels 1 and 3, or None where they do not take
the shape (H above MAX_H = 1024, or more shared memory than a block
has); then models/bilstm.py sends the direction to the v1 route
(ops/lstm_v1_cuda.py, kernels 4 and 5, which take H up to 14528 forward
and 5811 backward).  This is the
counterpart of `fused_block_ts` (lstm_pallas.py:761-777), which asks
the same question of the TPU's VMEM; speed plays no part in the choice.
A direct call of these wrappers on a shape `fused_launch` refuses raises.
Dropout is ported: forward dropout alone keeps this route (the mask
multiplies the layer output); a direction with a recurrent-dropout mask
or a carried streaming state runs neither this route nor the v1 one, but
the torch-op recurrence `_plain_scan` of models/bilstm.py, as the JAX
package runs its XLA scan then.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from eesen_tpu_torch.ops import build

# kernel launches since the last reset (chip_smoke.py reads and resets
# them): `launches` counts the forward kernel, `bwd_launches` the backward
# pass (one count per call each: kernel 1's projection and recurrence;
# kernel 3's recurrence and the products it feeds)
launches = 0
bwd_launches = 0

MAX_THREADS = 1024
FWD_THREADS = 512             # kernel 1: threads a CTA, and (row, unit)
FWD_EPT = 6                   # elements each carries through a step, at most
MAX_H = 1024                  # widest cell the fused route takes
SMEM_LIMIT = build.SMEM_LIMIT  # bytes of shared memory a block may use
CLUSTERS = (8, 16)            # kernels 1 and 3: CTAs per cluster, in order
                              # of choice
ROWS = (16, 32)               # rows per cluster: kernel 1 16 at B <= 16,
                              # else 32 (halved on the f32 path while they
                              # don't fit); kernel 3 16 while its clusters
                              # fit in one wave, else 32
BWD_WAVE_CTAS = 112           # CTAs of clusters the H100 holds at once
                              # (cudaOccupancyMaxActiveClusters: 7 of 16,
                              # 15 of 8 at these kernels' shared memory)
BWD_THREADS = 512             # kernel 3: threads a CTA, and (row, unit)
BWD_EPT = 4                   # elements each carries in registers
BWD_EPT_V1 = 8                # the same for kernel 5's instance (no sums)
GEMM_TILE = (128, 128, 64)    # the product kernel's output tile and k step
GEMM_STAGES = 4               # its ring of shared-memory stages
GEMM_SMEM_BYTES = GEMM_STAGES * 2 * 128 * 64 * 2 + 1024 + 2 * GEMM_STAGES * 8
SMS = 132                     # the H100's SMs: one product CTA each
GEMM_MAX_SPLIT = 16           # k-slices of a weight-gradient product: at
GEMM_MIN_SLICE = 8            # most 16, each at least 8 k steps


def _scan(
    x: torch.Tensor, mask: torch.Tensor, w_x: torch.Tensor,
    bias: torch.Tensor, w_m: torch.Tensor, ph: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recurrence in plain PyTorch.  Products are of values in the
    dtype of x (bf16 or f32) accumulated in f32; the c and m carries are
    f32.  Returns (m carry, c carry, gates) [T,B,H], [T,B,H], [T,B,4H]."""
    t_max, b, _ = x.shape
    h = w_m.shape[0]
    cdt = x.dtype
    f32 = torch.float32
    # the whole input projection at once (inside the kernel it is per step)
    xw = torch.matmul(x.to(f32), w_x.to(f32)) + bias        # [T, B, 4H]
    wm = w_m.to(f32)
    ph_i, ph_f, ph_o = ph[0], ph[1], ph[2]
    c = torch.zeros((b, h), dtype=f32, device=x.device)
    m = torch.zeros((b, h), dtype=f32, device=x.device)
    ms, cs, gs = [], [], []
    for t in range(t_max):
        gifo = xw[t] + torch.matmul(m.to(cdt).to(f32), wm)
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
        gs.append(torch.cat([g, i, f, o], dim=1))
    return torch.stack(ms), torch.stack(cs), torch.stack(gs)


def lstm_direction_ref(
    x: torch.Tensor, mask: torch.Tensor, w_x: torch.Tensor,
    bias: torch.Tensor, w_m: torch.Tensor, ph: torch.Tensor,
    state_bf16: bool = False, with_residuals: bool = False,
):
    """Plain version of the kernel, with the kernel's casts: m (and c)
    carries in bf16 when state_bf16 else f32; gates in the dtype of x.
    Returns m, or (m, c, gates) with with_residuals."""
    sdt = torch.bfloat16 if state_bf16 else torch.float32
    m, c, gates = _scan(x, mask, w_x, bias, w_m, ph)
    if with_residuals:
        return m.to(sdt), c.to(sdt), gates.to(x.dtype)
    return m.to(sdt)


def fwd_kpad(h: int, bf16: bool) -> int:
    """Length of an operand row of kernel 1's recurrence: H rounded up to
    64 on the bf16 path (whole swizzle blocks), H on the f32 path."""
    return -(-h // 64) * 64 if bf16 else h


def fwd_units(h: int, cluster: int) -> int:
    """Hidden units per CTA of kernel 1's recurrence (even, so that its 4U
    gate columns are whole 8-column mma tiles)."""
    u = -(-h // cluster)
    return u + (u & 1)


def fwd_smem_bytes(h: int, rows: int, units: int, kres: int,
                   bf16: bool) -> int:
    """Shared memory of kernel 1's recurrence (csrc/lstm_fwd.cu
    lstm_fwd_smem_bytes): f32 pre-activations [rows, 4U] (which also hold
    the step's gates until they are stored) and carries 2 x [rows, U], the
    double-buffered operand 2 x [rows, Kp] and `kres` resident input rows
    of the CTA's W_m slice, both in the type of x."""
    s = 2 if bf16 else 4
    cols = 4 * units
    return (rows * cols * 4 + 2 * rows * units * 4
            + 2 * rows * fwd_kpad(h, bf16) * s + kres * cols * s)


class FwdPlan(NamedTuple):
    cluster: int       # CTAs per cluster (8, or 16 non-portable)
    rows: int          # batch rows per cluster (a multiple of 16 on bf16)
    units: int         # hidden units per CTA
    kres: int          # input rows of the CTA's W_m slice kept resident


def fwd_plan(b: int, h: int, bf16: bool = True) -> Optional[FwdPlan]:
    """Cluster shape of kernel 1's recurrence: the smaller cluster whose
    CTAs hold their whole W_m slice, else 16 CTAs with as many input rows
    resident as fit (a multiple of 64 on bf16); rows per cluster 16 at
    B <= 16, else 32, halved (f32 path, down to 4) until the operand fits.
    None when not even the operand fits."""
    s = 2 if bf16 else 4
    kp = fwd_kpad(h, bf16)
    step, min_rows = (64, 16) if bf16 else (1, 4)
    plan = None
    for cluster in CLUSTERS:
        units = fwd_units(h, cluster)
        rows = ROWS[0] if b <= ROWS[0] else ROWS[1]
        while (rows > min_rows
               and fwd_smem_bytes(h, rows, units, 0, bf16) > SMEM_LIMIT):
            rows //= 2
        free = SMEM_LIMIT - fwd_smem_bytes(h, rows, units, 0, bf16)
        if free < 0:
            continue
        kres = min(kp, free // (4 * units * s) // step * step)
        plan = FwdPlan(cluster, rows, units, kres)
        if kres == kp:
            break
    return plan


def bwd_units(h: int, cluster: int, bf16: bool) -> int:
    """Hidden units per CTA of kernel 3's recurrence: on the bf16 path a
    multiple of 4, so that its 4U gate columns are whole 16-deep mma
    k-steps and its receive slots take float4 stores."""
    u = -(-h // cluster)
    return -(-u // 4) * 4 if bf16 else u


def bwd_row_words(units: int, bf16: bool) -> int:
    """32-bit words per row of kernel 3's operand tile and bf16 W_m slice:
    4U bf16 values and 4 words of padding (rows 4 mod 8 words apart, so an
    mma fragment load hits 32 banks); 4U floats on the f32 path."""
    return 2 * units + 4 if bf16 else 4 * units


def bwd_smem_bytes(cluster: int, rows: int, units: int, kres: int,
                   bf16: bool) -> int:
    """Shared memory of kernel 3's recurrence (csrc/lstm_bwd.cu
    lstm_bwd_smem_bytes): the double-buffered receive slots 2 x C x
    [rows, U] f32, the operand [rows] and the resident slice [kres] rows
    of bwd_row_words (bf16; on f32 the slice is [4U, kres] floats, the
    same count)."""
    return 4 * (2 * cluster * rows * units
                + (rows + kres) * bwd_row_words(units, bf16))


class BwdPlan(NamedTuple):
    cluster: int       # CTAs per cluster (8, or 16 non-portable)
    rows: int          # batch rows per cluster (16 or 32 on bf16)
    units: int         # hidden units per CTA
    kres: int          # rows u' of the CTA's W_m slice kept resident


def one_wave(b: int, cluster: int, rows: int) -> bool:
    """Whether ceil(B/rows) clusters of `cluster` CTAs fit in one wave of
    BWD_WAVE_CTAS CTAs: a cluster of a second wave runs its whole T-step
    chain after the first wave's."""
    return -(-b // rows) * cluster <= BWD_WAVE_CTAS


def bwd_plan(b: int, h: int, bf16: bool = True,
             v1: bool = False) -> Optional[BwdPlan]:
    """Cluster shape of kernel 3's recurrence, chosen as `fwd_plan`
    chooses kernel 1's: the smaller cluster whose CTAs hold their whole
    W_m slice beside the receive slots, else 16 CTAs with as many rows u'
    resident as fit (whole 8-row mma tiles on bf16, up to H rounded to
    8).  Rows per cluster: 16 while ceil(B/16) clusters fit in one wave
    of BWD_WAVE_CTAS CTAs (a step's time grows with the rows a CTA
    carries), else 32; halved while the receive slots do not fit or a
    thread would carry more than BWD_EPT elements.  None when not even
    that fits.

    v1: the plan of kernel 5's instance of the same recurrence, which
    carries no per-row sums, so a thread takes up to BWD_EPT_V1 elements;
    and 16 CTAs replace 8 only where their clusters fit in one wave or
    the 8-CTA clusters do not either (at B=128, H=1152: 8 clusters of 8
    CTAs, not 8 of 16, of which the card holds 7)."""
    full = -(-h // 8) * 8 if bf16 else h
    step, min_rows = (8, 16) if bf16 else (1, 4)
    most = BWD_THREADS * (BWD_EPT_V1 if v1 else BWD_EPT)
    plan = None
    for cluster in CLUSTERS:
        units = bwd_units(h, cluster, bf16)
        rows = ROWS[0] if one_wave(b, cluster, ROWS[0]) else ROWS[1]
        while rows > min_rows and (
                rows * units > most
                or bwd_smem_bytes(cluster, rows, units, 0, bf16) > SMEM_LIMIT):
            rows //= 2
        free = SMEM_LIMIT - bwd_smem_bytes(cluster, rows, units, 0, bf16)
        if free < 0 or rows * units > most:
            continue
        if v1 and plan is not None and one_wave(b, plan.cluster, plan.rows) \
                and not one_wave(b, cluster, rows):
            continue
        row_bytes = 4 * bwd_row_words(units, bf16)
        plan = BwdPlan(cluster, rows, units,
                       min(full, free // row_bytes // step * step))
        if plan.kres == full:
            break
    return plan


def bwd_weight_slices(w_m: torch.Tensor, plan: BwdPlan,
                      bf16: bool) -> torch.Tensor:
    """Each CTA's slice of W_m [H, 4H] as kernel 3's recurrence reads it:
    CTA q's columns g*H + q*U + u (zero for units past H), as [C, Hp, 2*SW]
    bf16 (row u', then column j = g*U + u, zero-padded to SW words and Hp =
    H rounded up to 8 rows) on the bf16 path, as [C, 4U, H] (column j, then
    u') on the f32 path."""
    h = w_m.shape[0]
    c, u = plan.cluster, plan.units
    unit = torch.arange(c * u, device=w_m.device).view(c, 1, u)
    cols = torch.arange(4, device=w_m.device).view(1, 4, 1) * h + \
        unit.clamp(max=h - 1)
    sl = torch.where(unit < h, w_m[:, cols], torch.zeros(
        (), dtype=w_m.dtype, device=w_m.device))         # [H, C, 4, U]
    if not bf16:
        return sl.permute(1, 2, 3, 0).reshape(c, 4 * u, h).contiguous()
    out = torch.zeros((c, -(-h // 8) * 8, 2 * bwd_row_words(u, True)),
                      dtype=w_m.dtype, device=w_m.device)
    out[:, :h, :4 * u] = sl.permute(1, 0, 2, 3).reshape(c, h, 4 * u)
    return out


class FusedLaunch(NamedTuple):
    fwd: FwdPlan       # kernel 1's recurrence
    bwd: BwdPlan       # kernel 3's recurrence


def fused_launch(b: int, d: int, h: int,
                 bf16: bool = True) -> Optional[FusedLaunch]:
    """Launch parameters of kernels 1 and 3 for a direction of batch b,
    input width d and cell width h (compute dtype bf16, else f32), or None
    when the fused route does not take the shape: h above MAX_H (those
    go to the v1 route), or a plan beyond a block's shared memory.  Host
    arithmetic only; the input width plays no part (the projections are
    tiled products)."""
    if h > MAX_H:
        return None
    fwd, bwd = fwd_plan(b, h, bf16), bwd_plan(b, h, bf16)
    if fwd is None or bwd is None:
        return None
    return FusedLaunch(fwd, bwd)


def _check(what: str, dev: torch.device, expect) -> None:
    """Raise unless every (tensor, shape, dtype) is as expected, contiguous
    and on `dev`."""
    for name, (ten, shape, dt) in expect.items():
        if tuple(ten.shape) != shape or ten.dtype != dt:
            raise ValueError(
                f"{what}: {name} must be {dt} {shape}, got "
                f"{ten.dtype} {tuple(ten.shape)}"
            )
        if ten.device != dev or not ten.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous on {dev}")


def _forward(x, mask, w_x, bias, w_m, ph, state_bf16, with_residuals):
    """The forward wrapper proper: kernel on CUDA, plain version on CPU."""
    global launches
    if x.device.type == "cpu":
        return lstm_direction_ref(
            x, mask, w_x, bias, w_m, ph, state_bf16, with_residuals
        )
    if x.device.type != "cuda":
        raise ValueError(f"lstm_direction: unsupported device {x.device}")
    t_max, b, d = x.shape
    h = w_m.shape[0]
    cdt = x.dtype
    if cdt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"lstm_direction: x must be bf16 or f32, got {cdt}")
    _check("lstm_direction", x.device, {
        "x": (x, (t_max, b, d), cdt),
        "mask": (mask, (t_max, b), torch.float32),
        "w_x": (w_x, (d, 4 * h), cdt),
        "bias": (bias, (4 * h,), torch.float32),
        "w_m": (w_m, (h, 4 * h), cdt),
        "ph": (ph, (3, h), torch.float32),
    })
    bf16 = cdt == torch.bfloat16
    launch = fused_launch(b, d, h, bf16)
    if launch is None:
        raise ValueError(f"lstm_direction: D={d}, H={h} exceed the fused "
                         f"kernels' width or shared memory (v1 route)")
    lib = build.load()
    sdt = torch.bfloat16 if state_bf16 else torch.float32
    m = torch.empty((t_max, b, h), dtype=sdt, device=x.device)
    c = gates = None
    if with_residuals:
        c = torch.empty((t_max, b, h), dtype=sdt, device=x.device)
        gates = torch.empty((t_max, b, 4 * h), dtype=cdt, device=x.device)
    if t_max > 0 and b > 0:
        p = launch.fwd
        # the recurrence reads W_m^T [4H, H] on the bf16 path (mma operand
        # rows along H), W_m [H, 4H] on the f32 path
        w = w_m.t().contiguous() if bf16 else w_m
        xw = torch.empty((t_max, b, 4 * h), dtype=torch.float32,
                         device=x.device)
        # the projection's operands as its tensor maps take them
        x_pad = wx_pad = None
        if bf16:
            x_pad = _pad_scratch(x, t_max * b, d)
            wx_pad = _pad_scratch(w_x, d, 4 * h)
        err = lib.lstm_fwd(
            x.data_ptr(), mask.data_ptr(), w_x.data_ptr(), bias.data_ptr(),
            w.data_ptr(), ph.data_ptr(), m.data_ptr(), _ptr(c), _ptr(gates),
            xw.data_ptr(), _ptr(x_pad), _ptr(wx_pad),
            t_max, b, d, h, int(bf16), int(state_bf16),
            p.cluster, p.rows, p.units, p.kres,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        build.check(err, "lstm_fwd")
        launches += 1
    if with_residuals:
        return m, c, gates
    return m


def lstm_direction_bwd_rec_ref(
    x: torch.Tensor, mask: torch.Tensor, gates: torch.Tensor,
    c: torch.Tensor, gm: torch.Tensor, w_m: torch.Tensor, ph: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reverse recurrence of the plain backward, step for step as
    `_fused_bwd_kernel` (lstm_pallas.py:403-482), with its casts: c_raw
    recomputed from the stored gates and c carry; dgifo rounded to the
    dtype of x for the products, unrounded for db and dph.  Returns
    (dgifo [T,B,4H] dtype of x, db [4H], dph [3,H] float32)."""
    t_max, b, _ = x.shape
    h = w_m.shape[0]
    cdt = x.dtype
    f32 = torch.float32
    gates_f, c_f, gm_f = gates.to(f32), c.to(f32), gm.to(f32)
    wm = w_m.to(f32)
    ph_i, ph_f, ph_o = ph[0], ph[1], ph[2]
    dm = torch.zeros((b, h), dtype=f32, device=x.device)
    dc = torch.zeros((b, h), dtype=f32, device=x.device)
    zero = torch.zeros((b, h), dtype=f32, device=x.device)
    dgifo_all = torch.empty((t_max, b, 4 * h), dtype=cdt, device=x.device)
    db = torch.zeros(4 * h, dtype=f32, device=x.device)
    dph = torch.zeros((3, h), dtype=f32, device=x.device)
    for t in range(t_max - 1, -1, -1):
        g, i, f, o = gates_f[t].split(h, dim=1)
        c_prev = c_f[t - 1] if t > 0 else zero
        c_raw = f * c_prev + i * g
        mt = mask[t][:, None]
        tanh_c = torch.tanh(c_raw)
        dm_total = gm_f[t] + dm
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
        dgifo_all[t] = dgifo.to(cdt)
        dm = (torch.matmul(dgifo_all[t].to(f32), wm.t())
              + dm_total * (1.0 - mt))
        db += dgifo.sum(0)
        dph[0] += (di_pre * c_prev).sum(0)
        dph[1] += (df_pre * c_prev).sum(0)
        dph[2] += (do_pre * c_raw).sum(0)
    return dgifo_all, db, dph


def lstm_direction_bwd_ref(
    x: torch.Tensor, mask: torch.Tensor, gates: torch.Tensor,
    c: torch.Tensor, m: torch.Tensor, gm: torch.Tensor, w_x: torch.Tensor,
    w_m: torch.Tensor, ph: torch.Tensor,
) -> Tuple[torch.Tensor, ...]:
    """Plain version of the backward kernel: the reverse recurrence
    (`lstm_direction_bwd_rec_ref`), then the three products of the
    rounded dgifo with float32 sums, m_prev rounded to the dtype of x.
    Returns (dx [T,B,D] dtype of x, dw_x [D,4H], dw_m [H,4H], db [4H],
    dph [3,H]) float32."""
    t_max, b, d = x.shape
    h = w_m.shape[0]
    cdt = x.dtype
    f32 = torch.float32
    dgifo_all, db, dph = lstm_direction_bwd_rec_ref(x, mask, gates, c, gm,
                                                    w_m, ph)
    dg2 = dgifo_all.to(f32).reshape(t_max * b, 4 * h)
    dx = torch.matmul(dg2, w_x.to(f32).t()).reshape(t_max, b, d).to(cdt)
    dw_x = torch.matmul(x.to(f32).reshape(t_max * b, d).t(), dg2)
    m_prev = torch.cat([torch.zeros_like(m[:1]), m[:-1]]).to(cdt).to(f32)
    dw_m = torch.matmul(m_prev.reshape(t_max * b, h).t(), dg2)
    return dx, dw_x, dw_m, db, dph


class GemmPlan(NamedTuple):
    tiles: int         # 128 x 128 output tiles
    splits: int        # k-slices, each summed into its own partial
    kslice: int        # k per slice: whole 64-deep k steps


def gemm_plan(m: int, n: int, k: int, split: bool = True) -> GemmPlan:
    """How the product kernel covers C [m, n] = A [m, k] . B [k, n]: its
    tiles, and (split: the weight gradients, few tiles and k ~ T*B) the
    k-slices that fill the card: the fewest slices, up to GEMM_MAX_SPLIT
    and at least GEMM_MIN_SLICE k steps each, whose CTAs fill 90% of the
    waves of SMS CTAs they take, else the fullest.  k per slice is whole k
    steps (csrc/gemm_wgmma.cu gemm_kslice), and no slice is empty."""
    bm, bn, bk = GEMM_TILE
    tiles = -(-m // bm) * -(-n // bn)
    steps = -(-k // bk)
    z = 1
    if split:
        most = max(1, min(GEMM_MAX_SPLIT, steps // GEMM_MIN_SLICE))
        best = (0, 1, 1)                    # (CTAs, wave slots, slices)
        for cand in range(1, most + 1):
            ctas = tiles * cand
            slots = -(-ctas // SMS) * SMS
            if 10 * ctas >= 9 * slots:
                best = (ctas, slots, cand)
                break
            if ctas * best[1] > best[0] * slots:
                best = (ctas, slots, cand)
        z = best[2]
    per = max(1, -(-steps // z))
    return GemmPlan(tiles, max(1, -(-steps // per)), per * bk)


def gemm_operands(a, b, a_mn=False, b_mn=True, k=None, b_k0=0):
    """Views A [M, K] and B [K, N] of the stored arrays as the product
    kernel reads them (see `gemm_bf16`), and K."""
    if k is None:
        k = (b.shape[0] if b_mn else b.shape[1]) - b_k0
    av = a[:k].t() if a_mn else a[:, :k]
    bv = b[b_k0:b_k0 + k] if b_mn else b[:, b_k0:b_k0 + k].t()
    return av, bv, k


def gemm_bf16_ref(a, b, *, a_mn=False, b_mn=True, k=None, b_k0=0,
                  bias=None, out_dtype=torch.float32, splits=1):
    """Plain version of `gemm_bf16`: each k-slice's product in float32
    (plus the bias, in each), rounded to out_dtype."""
    av, bv, k = gemm_operands(a, b, a_mn, b_mn, k, b_k0)
    av, bv = av.float(), bv.float()
    bk = GEMM_TILE[2]
    ks = -(-(-(-k // bk)) // splits) * bk
    parts = torch.stack([av[:, z * ks:(z + 1) * ks] @ bv[z * ks:(z + 1) * ks]
                         for z in range(splits)])
    if bias is not None:
        parts = parts + bias
    parts = parts.to(out_dtype)
    return parts if splits > 1 else parts[0]


def gemm_bf16(a, b, *, a_mn=False, b_mn=True, k=None, b_k0=0, bias=None,
              out_dtype=torch.float32, splits=1):
    """The bf16 product of kernels 1 and 3 alone (the card tests and
    chip_smoke.py hold it against torch.matmul; the LSTM kernels call it
    inside the library): C [M, N] = A . B (+ bias [N] f32) with float32
    sums, in out_dtype (bf16 or float32), or with splits > 1 the
    [splits, M, N] float32 partials of k-slices as gemm_plan cuts them.
    a, b: 2-D bf16, read as they lie: A = a[:, :K] (a_mn False, a [M, >=K])
    or a[:K]^T (a_mn, a [>=K, M]); B = b[b_k0:b_k0+K] (b_mn, b [rows, N])
    or b[:, b_k0:b_k0+K]^T (b [N, cols]).  K defaults to all of B past
    b_k0.  Each row must be whole 16-byte units (a multiple of 8 values)
    at a 16-byte aligned base, else the kernel raises."""
    if a.device.type == "cpu":
        return gemm_bf16_ref(a, b, a_mn=a_mn, b_mn=b_mn, k=k, b_k0=b_k0,
                             bias=bias, out_dtype=out_dtype, splits=splits)
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.bfloat16 or t.dim() != 2 or \
                not t.is_contiguous() or t.device != a.device:
            raise ValueError(f"gemm_bf16: {name} must be contiguous 2-D bf16")
    av, bv, k = gemm_operands(a, b, a_mn, b_mn, k, b_k0)
    m, n = av.shape[0], bv.shape[1]
    if av.shape[1] != k or bv.shape[0] != k or b_k0 < 0:
        raise ValueError(f"gemm_bf16: a or b holds less than K={k} past "
                         f"b_k0={b_k0}")
    if bias is not None and (bias.dtype != torch.float32
                             or tuple(bias.shape) != (n,)):
        raise ValueError("gemm_bf16: bias must be float32 [N]")
    shape = (splits, m, n) if splits > 1 else (m, n)
    out = torch.empty(shape, dtype=out_dtype, device=a.device)
    err = build.load().gemm_bf16(
        a.data_ptr(), int(a_mn), a.shape[1], b.data_ptr(), int(b_mn),
        b.shape[1], b_k0, out.data_ptr(), int(out_dtype == torch.bfloat16),
        _ptr(bias), m, n, k, splits,
        torch.cuda.current_stream(a.device).cuda_stream)
    build.check(err, "gemm_bf16")
    return out


def _pad_scratch(ten: torch.Tensor, rows: int, cols: int,
                 always: bool = False) -> Optional[torch.Tensor]:
    """Scratch [rows, cols rounded up to 8] bf16 for the zero-padded copy
    of a product operand that the kernel's tensor maps need (its rows of
    `cols` values not whole 16-byte units, or its base not 16-byte
    aligned; `always` for an f32 m, which the copy rounds), else None."""
    if not always and cols % 8 == 0 and ten.data_ptr() % 16 == 0:
        return None
    return torch.empty((rows, -(-cols // 8) * 8), dtype=torch.bfloat16,
                       device=ten.device)


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def lstm_direction_bwd(
    x: torch.Tensor, mask: torch.Tensor, gates: torch.Tensor,
    c: torch.Tensor, m: torch.Tensor, gm: torch.Tensor, w_x: torch.Tensor,
    w_m: torch.Tensor, ph: torch.Tensor,
) -> Tuple[torch.Tensor, ...]:
    """Backward pass of one direction from the forward residuals.

    x [T, B, D], gates [T, B, 4H], w_x [D, 4H], w_m [H, 4H] in the compute
    dtype (bf16 or f32); mask [T, B] f32; c and m (the carries) and gm
    (the cotangent of m) [T, B, H] in the state dtype; ph [3, H] f32.
    Returns (dx [T, B, D] compute dtype, dw_x [D, 4H], dw_m [H, 4H],
    db [4H], dph [3, H]) float32."""
    global bwd_launches
    if x.device.type == "cpu":
        return lstm_direction_bwd_ref(x, mask, gates, c, m, gm, w_x, w_m, ph)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_direction_bwd: unsupported device {x.device}")
    t_max, b, d = x.shape
    h = w_m.shape[0]
    cdt, sdt = x.dtype, m.dtype
    if cdt not in (torch.bfloat16, torch.float32) or \
            sdt not in (torch.bfloat16, torch.float32):
        raise TypeError("lstm_direction_bwd: x and m must be bf16 or f32")
    _check("lstm_direction_bwd", x.device, {
        "x": (x, (t_max, b, d), cdt),
        "mask": (mask, (t_max, b), torch.float32),
        "gates": (gates, (t_max, b, 4 * h), cdt),
        "c": (c, (t_max, b, h), sdt),
        "m": (m, (t_max, b, h), sdt),
        "gm": (gm, (t_max, b, h), sdt),
        "w_x": (w_x, (d, 4 * h), cdt),
        "w_m": (w_m, (h, 4 * h), cdt),
        "ph": (ph, (3, h), torch.float32),
    })
    bf16 = cdt == torch.bfloat16
    launch = fused_launch(b, d, h, bf16)
    if launch is None:
        raise ValueError(f"lstm_direction_bwd: D={d}, H={h} exceed the "
                         f"fused kernels' width or shared memory (v1 route)")
    lib = build.load()
    dev = x.device
    f32 = torch.float32
    dx = torch.empty((t_max, b, d), dtype=cdt, device=dev)
    dw_x = torch.empty((d, 4 * h), dtype=f32, device=dev)
    dw_m = torch.empty((h, 4 * h), dtype=f32, device=dev)
    dbph = torch.empty(7 * h, dtype=f32, device=dev)
    if t_max == 0 or b == 0:
        for ten in (dw_x, dw_m, dbph):
            ten.zero_()
    else:
        tb = t_max * b
        zx = gemm_plan(d, 4 * h, tb).splits
        zm = gemm_plan(h, 4 * h, tb - b).splits
        scratch = dict(
            dgifo=torch.empty((t_max, b, 4 * h), dtype=cdt, device=dev),
            rows=torch.empty((b, 7 * h), dtype=f32, device=dev),
            wx=torch.empty((zx, d, 4 * h), dtype=f32, device=dev),
            wm=torch.empty((zm, h, 4 * h), dtype=f32, device=dev),
        )
        # the products' operands as their tensor maps take them: padded
        # bf16 copies where a row is not whole 16-byte units, and m_prev
        # (rows [0, T-1)) in bf16 where the state is f32
        pads = [None] * 4
        if bf16:
            pads = [_pad_scratch(x, tb, d),
                    _pad_scratch(scratch["dgifo"], tb, 4 * h),
                    _pad_scratch(m, tb - b, h, always=sdt == f32),
                    _pad_scratch(w_x, d, 4 * h)]
        p = launch.bwd
        wsl = bwd_weight_slices(w_m, p, bf16)
        err = lib.lstm_bwd(
            x.data_ptr(), mask.data_ptr(), gates.data_ptr(), c.data_ptr(),
            m.data_ptr(), gm.data_ptr(), w_x.data_ptr(), wsl.data_ptr(),
            ph.data_ptr(), dx.data_ptr(), dw_x.data_ptr(), dw_m.data_ptr(),
            dbph.data_ptr(), scratch["dgifo"].data_ptr(),
            scratch["rows"].data_ptr(), scratch["wx"].data_ptr(),
            scratch["wm"].data_ptr(), *map(_ptr, pads), t_max, b, d, h,
            int(bf16),
            int(sdt == torch.bfloat16), p.cluster, p.rows, p.units, p.kres,
            zx, zm, torch.cuda.current_stream(dev).cuda_stream,
        )
        build.check(err, "lstm_bwd")
        bwd_launches += 1
    return dx, dw_x, dw_m, dbph[:4 * h], dbph[4 * h:].view(3, h)


def _cast(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Float32 master weights in the compute dtype; any other dtype is
    left for the kernel's checks to refuse."""
    return w.to(dtype) if w.dtype == torch.float32 else w


class LstmDirection(torch.autograd.Function):
    """One direction with its gradient: forward = the forward kernel with
    residuals, backward = the backward kernel (plain versions on the CPU),
    as `lstm_fused`'s custom VJP (lstm_pallas.py:597-795).  Weights may
    come in float32 and are cast to the dtype of x here, so that their
    gradients stay float32 as the JAX kernel's are."""

    @staticmethod
    def forward(ctx, x, mask, w_x, bias, w_m, ph, state_bf16):
        w_x, w_m = _cast(w_x, x.dtype), _cast(w_m, x.dtype)
        m, c, gates = _forward(x, mask, w_x, bias, w_m, ph, state_bf16, True)
        ctx.save_for_backward(x, mask, gates, c, m, w_x, w_m, ph)
        return m

    @staticmethod
    def backward(ctx, gm):
        x, mask, gates, c, m, w_x, w_m, ph = ctx.saved_tensors
        dx, dw_x, dw_m, db, dph = lstm_direction_bwd(
            x, mask, gates, c, m, gm.to(m.dtype).contiguous(), w_x, w_m, ph
        )
        return dx, None, dw_x, db, dw_m, dph, None


def lstm_direction(
    x: torch.Tensor, mask: torch.Tensor, w_x: torch.Tensor,
    bias: torch.Tensor, w_m: torch.Tensor, ph: torch.Tensor,
    state_bf16: bool = False, with_residuals: bool = False,
):
    """One LSTM direction from a zero state.

    x [T, B, D] in the compute dtype (bf16 or f32), mask [T, B] f32,
    w_x [D, 4H] and w_m [H, 4H] in the dtype of x or float32 (cast to it),
    bias [4H] f32, ph [3, H] f32 (peepholes i, f, o).  Returns the m carry
    [T, B, H] (bf16 when state_bf16, else f32), or (m, c, gates) with
    with_residuals (c like m, gates [T, B, 4H] in the dtype of x).  When
    grad is enabled and an input requires it, m comes through
    `LstmDirection`, whose backward is the backward kernel."""
    if not with_residuals and torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w_x, bias, w_m, ph)):
        return LstmDirection.apply(x, mask, w_x, bias, w_m, ph, state_bf16)
    return _forward(x, mask, _cast(w_x, x.dtype), bias, _cast(w_m, x.dtype),
                    ph, state_bf16, with_residuals)
