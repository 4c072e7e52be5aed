"""K6: the LSTM recurrence of the recurrent PPO update, forward and
backward through time, in two CUDA kernels; their wrapper and their
plain PyTorch version.

The recurrence of :meth:`RecurrentActorCritic.unroll
<gym_futbol_tpu_torch.models.recurrent.RecurrentActorCritic.unroll>` on
its ``compute_dtype=torch.bfloat16`` route: from the torso's output
``t`` ``[T, S, n_t]`` and the carry ``(c0, h0)`` ``[S, H]``, each step's
gates ``[t_t; h_{t-1}] [Wi; Wh] + b`` (i, f, g, o), the cell
``c_t = f c_{t-1} + i g``, ``h_t = o tanh(c_t)``, the carry zeroed after
step t where ``done[t]``. :func:`fused_lstm_bptt` returns every ``h_t``
(before the reset), which the heads read, and the carry after the
window; its backward takes the gradient of every ``h_t`` and returns
those of ``t``, ``Wi``, ``Wh`` and ``b``.

Rounding: the update is held to float32's result. The step's products
(``[t_t; h_{t-1}] [Wi; Wh]`` forward, ``dh_{t-1} = dgates_t Wh^T``
backward) run on the tensor cores with bf16 operands, each operand split
into two bf16 terms ``x = hi + lo`` and each product summed in f32 from
three, ``lo_a hi_b + hi_a lo_b + hi_a hi_b`` (:func:`split_mm`): about
2^-16 relative where one bf16 product is 2^-8, which over the benchmark's
three iterations moved the weights further than its float32 check
admits. The gates, the carries, dc, dh and dgates are f32. The weight
gradients ``dWh = sum_t h_{t-1}^T dgates_t``, ``dWi = sum_t t_t^T
dgates_t``, ``db = sum_t dgates_t`` and the torso's ``dt = dgates Wi^T``
run outside the kernels as one split product each over all T * S rows
(:func:`_mm3`: three bf16 products on cuBLAS, float32 results), from
h_{t-1} and dgates as the kernels leave them, their two bf16 terms.
Sigmoid is ``1 / (1 + exp(-x))`` and tanh ``2 sigmoid(2 x) - 1``, in the
kernels from the hardware exponential and reciprocal.

Source note. Replaces no TPU kernel: the JAX package's recurrent update
(``gym_futbol_tpu/recurrent_ppo.py``) differentiates the cell with
``jax.grad`` under XLA. Before K6 autograd ran it as ~45 launches a
step, its products float32 SGEMM on the CUDA cores (PERF.md §5); K6
(``csrc/fused_bptt_tc.cu``: ``bptt_forward_kernel``,
``bptt_backward_kernel``) walks the whole window inside the kernel, a
block owning 64 sequences from step 0 to T-1 (and back), the products on
the tensor cores (``mma.sync``). It is bounded by the card's bf16 rate
(three products each) and by its inputs' and outputs' bytes, and pays
besides for its saved state (the gates and c written once and read
once); the design keeps h_{t-1} and dgates_t as the next product's
operand, and the carries c and dc, in shared memory, dh in registers,
and the weights (more than shared memory holds at H = 256) in L2
(:func:`bptt_plan`). The gates are saved, not recomputed: a recomputing
backward's operand tiles do not fit in shared memory beside its dgates
tiles and dc (the source's note).

Layouts: t's operand fragments packed on the host (:func:`t_fragments`);
the saved gates and c in the forward kernel's lanes' order
(:func:`fragment_rows` reads them as ``[T, S, H(, 4)]``); the gate
gradients unit-major, ``[T, S, H, 4]`` (i, f, g, o of unit u together);
the weights' columns in K5's gate order
(:func:`ops._policy.recurrent_gate_order`).

On a CUDA tensor the kernels run; on a CPU tensor the plain versions
:func:`bptt_forward_reference` and :func:`bptt_backward_reference`, the
same arithmetic as tensor code. Shapes: H a multiple of 4 with 4H at most
:data:`~gym_futbol_tpu_torch.ops._policy.TC_MAX_GATES`
(:func:`check_bptt_shape`), any torso width, number of sequences and
number of steps.

``ops.LAUNCHES["fused_lstm_bptt"]`` counts the kernels' launches (forward
and backward, one each a call); each forward and backward is the span
``ops.fused_lstm_bptt`` while a profiler runs.

LayerNorm (:func:`fused_lnlstm_bptt`, stable-baselines' layer-normalised
cell: ``gates = LN(t Wi; gx, bx) + LN(h Wh; gh, bh) + b``, ``h = o
tanh(LN(c; gc, bc))``). The kernels' LayerNorm instantiations
(``bptt_ln_forward_kernel``, ``bptt_ln_backward_kernel``, the same
bodies under a compile-time flag) take the recurrence; ``t Wi`` does not
depend on the carry, so it runs outside over the whole window, one split
product (:func:`_mm3_k`), normalised there (``torch.native_layer_norm``,
with ``b`` folded into its bias), and enters the forward kernel as the
gates' input side ``[T, S, H, 4]`` (unit-major). Each step the forward
kernel runs ``h_{t-1} Wh`` alone (K = hp), writes it (``y``, unit-major,
saved for the backward) with each row's statistics, normalises it, runs
the gates and c', then LN(c') and h'; the backward runs LayerNorm's
backward through c' and through ``h Wh``, each a row reduction across
the block. Statistics in float32 over the real 4H (or H) columns, the
population variance as ``E[y^2] - E[y]^2`` (clamped at 0), ``1 /
sqrt(var + 1e-5)``. Outside again: LayerNorm's backward tail, in one
pass of its own kernel (``csrc/lnlstm_tail.cu``: ``lnlstm_tail_kernel``,
then ``lnlstm_tail_sum_kernel`` over its blocks' partial sums): t Wi's
LayerNorm input gradient ``dx``, written as the two bf16 terms its
products take, and the six LayerNorm parameters' gradients as column
sums (``db`` once, the gradient of ``b``, ``bx`` and ``bh`` alike), from
the saved ``x``, ``y``, c' (read in the forward kernel's fragment order)
and their statistics (:func:`ln_tail_plan`; plain version
:func:`ln_tail_reference`, PyTorch's ``native_layer_norm_backward``);
then the split products of ``dWi``, ``dWh`` and ``dt``. The recurrence's
launches count under ``ops.LAUNCHES["fused_lnlstm_bptt"]``, the tail's
(one a backward, two kernels) under ``ops.LAUNCHES["lnlstm_tail"]``;
its autograd node, forward and backward with the LayerNorm work around
the kernels, is the span ``ops.fused_lnlstm_bptt``.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..models.recurrent import LN_EPS
from ..utils.profiling import span
from . import _build
from ._policy import (
    TC_MAX_GATES,
    ln_stats,
    recurrent_gate_order,
    round_up,
    sigmoid,
    unit_major,
)

__all__ = [
    "bptt_backward_reference",
    "bptt_forward_reference",
    "bptt_ln_backward_reference",
    "bptt_ln_forward_reference",
    "bptt_pack",
    "bptt_plan",
    "check_bptt_shape",
    "fragment_rows",
    "fused_lnlstm_bptt",
    "fused_lstm_bptt",
    "ln_tail_plan",
    "ln_tail_reference",
    "split_mm",
    "t_fragments",
]

ROWS = 64        # sequences a block of either kernel
TAIL_BLOCKS_PER_SM = 4   # LayerNorm's backward tail: blocks of 128 threads an SM

_build.counters("fused_lstm_bptt", "fused_lnlstm_bptt", "lnlstm_tail")


def check_bptt_shape(hsize: int) -> None:
    """Raise unless the kernels take LSTM size ``hsize``: a multiple of 4
    with 4H at most :data:`TC_MAX_GATES`."""
    if hsize < 4 or hsize % 4 or 4 * hsize > TC_MAX_GATES:
        raise ValueError(
            f"the fused BPTT kernels take an LSTM size that is a multiple of "
            f"4 with 4H <= {TC_MAX_GATES}, got H = {hsize}; "
            f"compute_dtype=torch.float32 runs the recurrence under autograd")


def bptt_plan(n_t: int, hsize: int, n_seq: int) -> dict:
    """How the kernels run ``n_seq`` sequences, without a card: ``kt``
    (the torso's width padded to 16), ``hp`` (H padded to 16),
    ``blocks`` of :data:`ROWS` sequences and each kernel's shared memory
    (``smem_forward``: two pairs of h_{t-1} tiles, hi and lo, ``[64,
    hp]`` bf16, and the carry c ``[64, hp]`` f32; ``smem_backward``: the
    dgates tiles of half the units, hi and lo, ``[64, 2 hp]`` bf16, and
    dc ``[64, hp]`` f32; rows padded by 8 elements). t's fragments and
    the weights stay in L2, so neither grows with the torso: at H = 256
    the forward takes 202,752 bytes and the backward 200,704, within the
    232,448 a block may have."""
    kt, hp = round_up(n_t, 16), round_up(hsize, 16)
    return {"kt": kt, "hp": hp, "blocks": -(-n_seq // ROWS),
            "smem_forward": 4 * ROWS * (hp + 8) * 2 + ROWS * (hp + 8) * 4,
            "smem_backward": 2 * ROWS * (2 * hp + 8) * 2 + ROWS * (hp + 8) * 4}


def ln_tail_plan(hsize: int, n_rows: int) -> dict:
    """How LayerNorm's backward tail (``csrc/lnlstm_tail.cu``) runs
    ``n_rows`` rows, without a card: ``threads_per_row`` (32, 64 or 128,
    two units of the 4H columns a thread), ``rows_per_block`` (of 128
    threads), ``blocks`` (:data:`TAIL_BLOCKS_PER_SM` an SM, fewer where
    the rows run out; each writes one partial row of ``sums`` floats)
    and ``sums`` (14 H: dgx, db, dgh ``[4H]``, dgc, dbc ``[H]``)."""
    tpr = 32 if hsize <= 64 else 64 if hsize <= 128 else 128
    groups = 128 // tpr
    return {"threads_per_row": tpr, "rows_per_block": groups,
            "blocks": max(1, min(_build.SMS * TAIL_BLOCKS_PER_SM, -(-n_rows // groups))),
            "sums": 14 * hsize}


def fragment_rows(x: torch.Tensor, n_seq: int, hsize: int) -> torch.Tensor:
    """The forward kernel's saved gates or c, held in its lanes' order
    (``[T, blocks, hp / 8, 8, 32, 2(, 4)]``: octet o of units 8 o .., mh
    = 2 m + hh, lane 4 g + t, jl; row 16 m + 8 hh + g of the block, unit
    8 o + 2 t + jl), as ``[T, S, H(, 4)]``."""
    n_steps, nblk, n_oct = x.shape[:3]
    tail = x.shape[6:]
    y = x.reshape(n_steps, nblk, n_oct, 4, 2, 8, 4, 2, *tail)
    y = y.permute(0, 1, 3, 4, 5, 2, 6, 7, *range(8, 8 + len(tail)))
    return y.reshape(n_steps, nblk * ROWS, 8 * n_oct, *tail)[:, :n_seq, :hsize]


def _split(x: torch.Tensor):
    """``x`` (f32) as two bf16 terms (hi, lo): hi = bf16(x), lo = bf16(x
    - hi) (the difference in f32, hi exact in it)."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi).to(torch.bfloat16)


def split_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernels take a product (module docstring): each
    operand split in two bf16 terms, ``lo_a hi_b + hi_a lo_b + hi_a
    hi_b`` summed in f32 (each term's products exact in f32)."""
    return _mm3(_split(a), _split(b))


def t_fragments(t2, kt: int) -> torch.Tensor:
    """The torso's output as the forward kernel reads it, from its two
    bf16 terms ``t2`` (hi, lo) ``[T, S, n_t]`` each: each block's 64 rows
    and each k-step's 16 columns (zero past S and n_t) in mma.sync's
    A-fragment order, ``[T, blocks, kt / 16, 4 (m16 tile), 2 (hi, lo), 32
    (lane 4 g + t), 8]`` bf16, the lane's 8 values rows (g, g + 8) x
    columns (2 t, 2 t + 1) then (g, g + 8) x (2 t + 8, 2 t + 9)."""
    n_steps, n_seq, n_t = t2[0].shape
    nblk = -(-n_seq // ROWS)
    y = torch.stack(t2, 2)
    if nblk * ROWS > n_seq or kt > n_t:
        y = F.pad(y, (0, kt - n_t, 0, 0, 0, nblk * ROWS - n_seq))
    # (T, blk, m, hh, g, hilo, kk, half, t, pair) -> (T, blk, kk, m, hilo, g, t, half, hh, pair)
    y = y.reshape(n_steps, nblk, 4, 2, 8, 2, kt // 16, 2, 4, 2)
    return y.permute(0, 1, 6, 2, 5, 4, 8, 7, 3, 9).contiguous()


def _from_unit_major(d: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`._policy.unit_major` on a gradient laid out
    ``[k, 4H]`` with unit-major columns: ``[4H, k]``, gate blocks; on a
    ``[4H]`` unit-major vector, the vector in gate blocks."""
    if d.dim() == 1:
        return _from_unit_major(d[None])[:, 0]
    k, hs = d.shape[0], d.shape[1] // 4
    return d.reshape(k, hs, 4).permute(2, 1, 0).reshape(4 * hs, k)


@functools.lru_cache(maxsize=None)
def _columns(hsize: int, device: torch.device):
    """On ``device``: the forward weights' columns
    (:func:`recurrent_gate_order`, a padded unit's clamped to 0), the
    padded units' columns (None without any), and the backward's B
    columns: n16 chunk j holds units 8 j .. 8 j + 7, then hp / 2 + 8 j ..
    hp / 2 + 8 j + 7, warp j's two output octets."""
    hp = round_up(hsize, 16)
    order = recurrent_gate_order(hsize)
    pad = (order < 0).nonzero().flatten().to(device) if hsize < hp else None
    paired = torch.arange(hp).reshape(2, hp // 16, 8).permute(1, 0, 2).reshape(-1)
    return order.clamp_min(0).to(device), pad, paired.to(device)


def _fragments_hi_lo(w: torch.Tensor):
    """:func:`tc_fragments` of the two bf16 terms (hi, lo) of ``w`` ``[kp,
    np_]`` (multiples of 16), both from one stacked copy."""
    kp, np_ = w.shape
    y = torch.stack(_split(w)).reshape(2, kp // 16, 2, 4, 2, np_ // 16, 2, 8)
    y = y.permute(0, 1, 5, 7, 3, 6, 2, 4).reshape(2, -1)
    return y[0], y[1]


def bptt_pack(w_i: torch.Tensor, w_h: torch.Tensor, b_h: torch.Tensor, kt: int):
    """The cell's weights as the kernels take them: (the forward's B
    fragments, hi and lo, of ``[kt + hp, 4 hp]``: Wi's rows, zero rows to
    kt, Wh's rows, zero rows to hp, the columns
    :func:`recurrent_gate_order`'s; its f32 bias in that order; the
    backward's B fragments, hi and lo, of Wh^T as ``[4 hp, hp]``, row 4 u
    + g (unit-major), the columns paired by octet (:func:`_columns`)).
    ``w_i`` ``[4H, n_t]``, ``w_h`` ``[4H, H]``, ``b_h`` ``[4H]``: the
    model's ``cell_i.weight``, ``cell_h.weight``, ``cell_h.bias``."""
    hs, n_t = w_h.shape[1], w_i.shape[1]
    hp = round_up(hs, 16)
    cols, pad, paired = _columns(hs, w_i.device)
    with torch.no_grad():
        wc = torch.cat([F.pad(w_i.t(), (0, 0, 0, kt - n_t)),
                        F.pad(w_h.t(), (0, 0, 0, hp - hs))]).index_select(1, cols)
        bias = b_h.detach().index_select(0, cols)
        if pad is not None:              # padded units' columns: zero
            wc[:, pad] = 0.0
            bias[pad] = 0.0
        wb = F.pad(unit_major(w_h.detach()), (0, hp - hs, 0, 4 * (hp - hs)))
        fwd = _fragments_hi_lo(wc)
        bwd = _fragments_hi_lo(wb.index_select(1, paired))
    if any(x.data_ptr() % 16 for x in (*fwd, *bwd, bias)):
        raise ValueError("the weight buffers must be 16-byte aligned")
    return fwd, bias, bwd


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the kernels' arithmetic as tensor code)
# ---------------------------------------------------------------------------


def _tanh(x: torch.Tensor) -> torch.Tensor:
    """``2 sigmoid(2 x) - 1``, as the kernels compute tanh."""
    return 2.0 * sigmoid(2.0 * x) - 1.0


def bptt_forward_reference(t, w_i, w_h, b_h, c0, h0, done):
    """:func:`bptt_forward_kernel`'s computation. ``t`` f32 ``[T, S,
    n_t]`` (the torso's output), the weights as :func:`bptt_pack` takes
    them, ``c0``, ``h0`` f32 ``[S, H]``, ``done`` ``[T, S]`` (0 or 1).
    Returns (the activated gates f32 ``[T, S, H, 4]``, c and h of every
    step before the reset f32 ``[T, S, H]``, the operand h_{t-1} of every
    step f32 ``[T, S, H]``, and the carry after the window (c, h))."""
    n_steps, n_seq, _ = t.shape
    hs = w_h.shape[1]
    wc = torch.cat([w_i.t(), w_h.t()]).detach()
    keep = 1.0 - done.float()
    gates = t.new_empty((n_steps, n_seq, hs, 4))
    c_all, h_all, hprev = (t.new_empty((n_steps, n_seq, hs)) for _ in range(3))
    c, h = c0, h0
    for k in range(n_steps):
        hprev[k] = h
        i, f, g, o = (split_mm(torch.cat([t[k], h], 1), wc) + b_h.detach()).chunk(4, 1)
        i, f, g, o = sigmoid(i), sigmoid(f), _tanh(g), sigmoid(o)
        c_all[k] = f * c + i * g
        h_all[k] = o * _tanh(c_all[k])
        gates[k] = torch.stack([i, f, g, o], -1)
        c, h = c_all[k] * keep[k, :, None], h_all[k] * keep[k, :, None]
    return gates, c_all, h_all, hprev, c, h


def bptt_backward_reference(gates, c_all, c0, done, dh_all, w_h):
    """:func:`bptt_backward_kernel`'s computation: from
    :func:`bptt_forward_reference`'s gates and c, the carry c0, ``done``
    and the gradient of every h_t ``dh_all`` f32 ``[T, S, H]``, the
    pre-activation gradients ``dgates`` f32 ``[T, S, H, 4]``. dh and dc
    flow back through each reset (zero where ``done[t]``);
    ``dh_{t-1} = dgates_t Wh^T`` as :func:`split_mm`."""
    n_steps, n_seq, hs, _ = gates.shape
    whu = unit_major(w_h.detach())
    keep = 1.0 - done.float()
    dc = dhn = torch.zeros_like(c0)
    dgates = torch.empty_like(gates)
    for k in reversed(range(n_steps)):
        gi, gf, gg, go = gates[k].unbind(-1)
        kk = keep[k, :, None]
        cp = c_all[k - 1] * keep[k - 1, :, None] if k else c0
        dh = dh_all[k] + kk * dhn
        tc = _tanh(c_all[k])
        dcv = kk * dc + dh * go * (1.0 - tc * tc)
        dgates[k] = torch.stack([dcv * gg * (gi * (1.0 - gi)),
                                 dcv * cp * (gf * (1.0 - gf)),
                                 dcv * gi * (1.0 - gg * gg),
                                 dh * tc * (go * (1.0 - go))], -1)
        dc = dcv * gf
        if k:
            dhn = split_mm(dgates[k].reshape(n_seq, 4 * hs), whu)
    return dgates


def bptt_ln_forward_reference(a, w_h, gh, bh, gc, bc, c0, h0, done):
    """:func:`bptt_ln_forward_kernel`'s computation. ``a`` f32 ``[T, S, H,
    4]`` (the gates' input side ``LN(t Wi) + b``, unit-major), ``w_h``
    ``[4H, H]``, ``gh``, ``bh`` ``[H, 4]`` (unit-major), ``gc``, ``bc``
    ``[H]``, the carry and ``done`` as :func:`bptt_forward_reference`'s.
    Returns (the activated gates ``[T, S, H, 4]``, c' and h of every step
    before the reset ``[T, S, H]``, h_{t-1} ``[T, S, H]``, ``y = h_{t-1}
    Wh`` ``[T, S, H, 4]``, the statistics (mean, 1 / sqrt(var + eps)) of
    y's rows and of c' ``[T, S, 2]`` each, the carry after the window)."""
    n_steps, n_seq, hs, _ = a.shape
    whu = unit_major(w_h.detach()).t()
    keep = 1.0 - done.float()
    gates, y_all = (a.new_empty((n_steps, n_seq, hs, 4)) for _ in range(2))
    c_all, h_all, hprev = (a.new_empty((n_steps, n_seq, hs)) for _ in range(3))
    st_h, st_c = (a.new_empty((n_steps, n_seq, 2)) for _ in range(2))
    c, h = c0, h0
    for k in range(n_steps):
        hprev[k] = h
        y = split_mm(h, whu).reshape(n_seq, hs, 4)
        mu, r = ln_stats(y, (1, 2))
        pre = a[k] + (gh * ((y - mu) * r) + bh)
        i, f, g, o = sigmoid(pre[..., 0]), sigmoid(pre[..., 1]), _tanh(pre[..., 2]), \
            sigmoid(pre[..., 3])
        c = f * c + i * g
        muc, rc = ln_stats(c, (1,))
        h = o * _tanh(gc * ((c - muc) * rc) + bc)
        gates[k], y_all[k], c_all[k], h_all[k] = torch.stack([i, f, g, o], -1), y, c, h
        st_h[k] = torch.cat([mu.reshape(n_seq, 1), r.reshape(n_seq, 1)], 1)
        st_c[k] = torch.cat([muc, rc], 1)
        c, h = c * keep[k, :, None], h * keep[k, :, None]
    return gates, c_all, h_all, hprev, y_all, st_h, st_c, c, h


def bptt_ln_backward_reference(gates, c_all, y_all, st_h, st_c, c0, done, dh_all, w_h,
                               gh, gc, bc):
    """:func:`bptt_ln_backward_kernel`'s computation, from
    :func:`bptt_ln_forward_reference`'s saved state (gates, c', y, the
    statistics; rows ``[T, S, ...]``), ``c0``, ``done``, the gradient of
    every h_t and the cell's ``w_h``, ``gh`` ``[H, 4]``, ``gc``, ``bc``.
    Returns (the gates' pre-activation gradients ``dpre`` ``[T, S, H,
    4]``, the gradients ``dy`` of ``y = h_{t-1} Wh`` ``[T, S, H, 4]``, the
    gradients ``dn`` of LN(c')'s output ``[T, S, H]``), each f32; dh and
    dc flow back through each reset; ``dh_{t-1} = dy_t Wh^T`` as
    :func:`split_mm`."""
    n_steps, n_seq, hs, _ = gates.shape
    whu = unit_major(w_h.detach())
    keep = 1.0 - done.float()
    dc = dhn = torch.zeros_like(c0)
    dpre, dy = torch.empty_like(gates), torch.empty_like(gates)
    dn_all = torch.empty_like(c_all)
    for k in reversed(range(n_steps)):
        gi, gf, gg, go = gates[k].unbind(-1)
        kk = keep[k, :, None]
        cp = c_all[k - 1] * keep[k - 1, :, None] if k else c0
        dh = dh_all[k] + kk * dhn
        muc, rc = st_c[k, :, :1], st_c[k, :, 1:]
        chat = (c_all[k] - muc) * rc
        tn = _tanh(gc * chat + bc)
        dn = dh * go * (1.0 - tn * tn)
        dchat = dn * gc
        m1, m2 = dchat.sum(1, keepdim=True) / hs, (dchat * chat).sum(1, keepdim=True) / hs
        dcv = kk * dc + ((dchat - m1) - chat * m2) * rc
        d = torch.stack([dcv * gg * (gi * (1.0 - gi)), dcv * cp * (gf * (1.0 - gf)),
                         dcv * gi * (1.0 - gg * gg), dh * tn * (go * (1.0 - go))], -1)
        dc = dcv * gf
        muh, rh = st_h[k, :, 0, None, None], st_h[k, :, 1, None, None]
        yhat = (y_all[k] - muh) * rh
        dyh = d * gh
        m1 = dyh.sum((1, 2), keepdim=True) / (4 * hs)
        m2 = (dyh * yhat).sum((1, 2), keepdim=True) / (4 * hs)
        dpre[k], dn_all[k] = d, dn
        dy[k] = ((dyh - m1) - yhat * m2) * rh
        if k:
            dhn = split_mm(dy[k].reshape(n_seq, 4 * hs), whu)
    return dpre, dy, dn_all


# ---------------------------------------------------------------------------
# The kernels' launches
# ---------------------------------------------------------------------------


def _forward_kernel(t2, w_i, w_h, b_h, c0, h0, done):
    """The forward kernel on the torso's output as its two bf16 terms
    ``t2``: (gates, c (fragment order), h ``[T, S, H]``, h_{t-1} as (hi,
    lo) bf16 ``[T, S, H]``, c and h after the window), and the backward's
    weight fragments."""
    n_steps, n_seq, n_t = t2[0].shape
    hs = w_h.shape[1]
    plan = bptt_plan(n_t, hs, n_seq)
    tfrag = t_fragments(t2, plan["kt"])
    (wf_hi, wf_lo), bias, bwd = bptt_pack(w_i, w_h, b_h, plan["kt"])
    frag = (n_steps, plan["blocks"], plan["hp"] // 8, 8, 32, 2)
    gates = c0.new_empty((*frag, 4))
    c_all = c0.new_empty(frag)
    h_all = c0.new_empty((n_steps, n_seq, hs))
    hprev = tuple(c0.new_empty((n_steps, n_seq, hs), dtype=torch.bfloat16)
                  for _ in range(2))
    c_last, h_last = (c0.new_empty((n_seq, hs)) for _ in range(2))
    _build.launch(
        "futbol_bptt_forward_tc", "fused_lstm_bptt", tfrag.data_ptr(),
        wf_hi.data_ptr(), wf_lo.data_ptr(), wf_hi.numel() // 8, bias.data_ptr(),
        done.data_ptr(), c0.data_ptr(), h0.data_ptr(), gates.data_ptr(),
        c_all.data_ptr(), h_all.data_ptr(), hprev[0].data_ptr(), hprev[1].data_ptr(),
        c_last.data_ptr(), h_last.data_ptr(), n_seq, n_steps, plan["kt"], hs,
        torch.cuda.current_stream(c0.device).cuda_stream)
    return (gates, c_all, h_all, hprev, c_last, h_last), bwd


def _backward_kernel(gates, c_all, c0, done, dh_all, bwd):
    """The backward kernel: dgates as (hi, lo) bf16 ``[T, S, H, 4]``."""
    n_steps, n_seq, hs = dh_all.shape
    wb_hi, wb_lo = bwd
    dgates = tuple(dh_all.new_empty((n_steps, n_seq, hs, 4), dtype=torch.bfloat16)
                   for _ in range(2))
    _build.launch(
        "futbol_bptt_backward_tc", "fused_lstm_bptt", gates.data_ptr(),
        c_all.data_ptr(), c0.data_ptr(), done.data_ptr(), dh_all.data_ptr(),
        wb_hi.data_ptr(), wb_lo.data_ptr(), wb_hi.numel() // 8, dgates[0].data_ptr(),
        dgates[1].data_ptr(), n_seq, n_steps, hs,
        torch.cuda.current_stream(dh_all.device).cuda_stream)
    return dgates


def _gate_cols(v: torch.Tensor, hsize: int) -> torch.Tensor:
    """A ``[4H]`` gate-block vector in the forward kernel's column order
    (:func:`recurrent_gate_order`), zero at a padded unit's columns."""
    cols, pad, _ = _columns(hsize, v.device)
    out = v.detach().index_select(0, cols)
    if pad is not None:
        out[pad] = 0.0
    return out


def _ln_forward_kernel(a, w_h, ln, c0, h0, done):
    """The LayerNorm forward kernel on the gates' input side ``a`` ``[T, S,
    H, 4]``: (gates, c' (fragment order), h ``[T, S, H]``, h_{t-1} as (hi,
    lo), y ``[T, S, H, 4]``, the statistics ``[T, S, 2]`` of y and of c',
    the carry after the window), and the backward's weight fragments.
    ``ln`` is (gh, bh ``[4H]`` gate blocks, gc, bc ``[H]``)."""
    n_steps, n_seq, hs, _ = a.shape
    gh, bh, gc, bc = ln
    plan = bptt_plan(0, hs, n_seq)
    (wf_hi, wf_lo), bias, bwd = bptt_pack(w_h.new_empty((4 * hs, 0)), w_h, bh, 0)
    ghc = _gate_cols(gh, hs)
    frag = (n_steps, plan["blocks"], plan["hp"] // 8, 8, 32, 2)
    gates = c0.new_empty((*frag, 4))
    c_all = c0.new_empty(frag)
    h_all = c0.new_empty((n_steps, n_seq, hs))
    hprev = tuple(c0.new_empty((n_steps, n_seq, hs), dtype=torch.bfloat16)
                  for _ in range(2))
    y = c0.new_empty((n_steps, n_seq, hs, 4))
    st_h, st_c = (c0.new_empty((n_steps, n_seq, 2)) for _ in range(2))
    c_last, h_last = (c0.new_empty((n_seq, hs)) for _ in range(2))
    gcb, bcb = gc.detach().contiguous(), bc.detach().contiguous()
    _build.launch(
        "futbol_bptt_ln_forward_tc", "fused_lnlstm_bptt", a.data_ptr(), wf_hi.data_ptr(),
        wf_lo.data_ptr(), wf_hi.numel() // 8, ghc.data_ptr(), bias.data_ptr(),
        gcb.data_ptr(), bcb.data_ptr(), done.data_ptr(), c0.data_ptr(), h0.data_ptr(),
        gates.data_ptr(), c_all.data_ptr(), h_all.data_ptr(), hprev[0].data_ptr(),
        hprev[1].data_ptr(), c_last.data_ptr(), h_last.data_ptr(), y.data_ptr(),
        st_h.data_ptr(), st_c.data_ptr(), n_seq, n_steps, hs,
        torch.cuda.current_stream(c0.device).cuda_stream)
    return (gates, c_all, h_all, hprev, y, st_h, st_c, c_last, h_last), bwd


def _ln_backward_kernel(gates, c_all, y, st_h, st_c, c0, done, dh_all, bwd, ghu, gc, bc):
    """The LayerNorm backward kernel: (dpre f32 ``[T, S, H, 4]``, dy as
    (hi, lo) bf16 ``[T, S, H, 4]``, dn f32 ``[T, S, H]``). ``ghu`` ``[H,
    4]`` unit-major."""
    n_steps, n_seq, hs = dh_all.shape
    wb_hi, wb_lo = bwd
    dy = tuple(dh_all.new_empty((n_steps, n_seq, hs, 4), dtype=torch.bfloat16)
               for _ in range(2))
    dpre = dh_all.new_empty((n_steps, n_seq, hs, 4))
    dn = dh_all.new_empty((n_steps, n_seq, hs))
    _build.launch(
        "futbol_bptt_ln_backward_tc", "fused_lnlstm_bptt", gates.data_ptr(),
        c_all.data_ptr(), c0.data_ptr(), done.data_ptr(), dh_all.data_ptr(),
        wb_hi.data_ptr(), wb_lo.data_ptr(), wb_hi.numel() // 8, dy[0].data_ptr(),
        dy[1].data_ptr(), y.data_ptr(), st_h.data_ptr(), st_c.data_ptr(), ghu.data_ptr(),
        gc.data_ptr(), bc.data_ptr(), dpre.data_ptr(), dn.data_ptr(), n_seq, n_steps, hs,
        torch.cuda.current_stream(dh_all.device).cuda_stream)
    return dpre, dy, dn


def _mm3(a, b) -> torch.Tensor:
    """``a @ b`` from each operand's two bf16 terms (hi, lo), as
    :func:`split_mm`: three products summed in f32, on cuBLAS with
    float32 results on the card, as f32 products of the bf16 values on
    the host (exact products)."""
    (ah, al), (bh, bl) = a, b
    if ah.device.type == "cuda":
        def mm(x, y):
            return torch.mm(x, y, out_dtype=torch.float32)
    else:
        def mm(x, y):
            return x.float() @ y.float()
    return mm(al, bh) + mm(ah, bl) + mm(ah, bh)


def _mm3_k(a, b) -> torch.Tensor:
    """:func:`_mm3`'s three products as one on the card, their terms
    stacked along K (``[lo_a | hi_a | hi_a] [hi_b; lo_b; hi_b]``): the
    same exact bf16 products summed in f32, written once. For a narrow K
    (the torso's output), where three outputs of 4H columns cost more
    than the product: t Wi over a minibatch of the LayerNorm cell (2^20
    rows, K 64, 1024 columns) 2.08 ms against :func:`_mm3`'s 13.36 on an
    H100 (chip_smoke phase 25)."""
    (ah, al), (bh, bl) = a, b
    if ah.device.type != "cuda":
        return _mm3(a, b)
    return torch.mm(torch.cat([al, ah, ah], 1), torch.cat([bh, bl, bh], 0),
                    out_dtype=torch.float32)


class _LstmBptt(torch.autograd.Function):
    """The recurrence as one autograd node: the forward and the backward
    kernel (or their plain versions on the CPU, their h_{t-1} and dgates
    split as the kernels leave them), then the weight gradients as split
    products over all T * S rows."""

    @staticmethod
    def forward(ctx, t, w_i, w_h, b_h, c0, h0, done):
        with span("ops.fused_lstm_bptt"):
            t2 = _split(t)
            done = (done.contiguous().view(torch.uint8) if done.dtype == torch.bool
                    else done.to(torch.uint8).contiguous())
            c0, h0 = c0.contiguous(), h0.contiguous()
            if t.device.type == "cpu":
                out = bptt_forward_reference(t, w_i, w_h, b_h, c0, h0, done)
                out = (*out[:3], _split(out[3]), *out[4:])
                ctx.packed = None
            else:
                out, ctx.packed = _forward_kernel(t2, w_i, w_h, b_h, c0, h0, done)
            gates, c_all, h_all, hprev, c_last, h_last = out
            ctx.save_for_backward(w_i, w_h, c0, done, gates, c_all, *t2, *hprev)
            ctx.mark_non_differentiable(c_last, h_last)
            return h_all, c_last, h_last

    @staticmethod
    def backward(ctx, dh_all, _dc_last, _dh_last):
        with span("ops.fused_lstm_bptt"):
            w_i, w_h, c0, done, gates, c_all, *split = ctx.saved_tensors
            t2, hprev = split[:2], split[2:]
            n_steps, n_seq, hs = dh_all.shape
            n_t = w_i.shape[1]
            dh_all = dh_all.contiguous()
            if ctx.packed is None:
                dgates = _split(bptt_backward_reference(gates, c_all, c0, done, dh_all,
                                                        w_h))
            else:
                dgates = _backward_kernel(gates, c_all, c0, done, dh_all, ctx.packed)
            d2 = tuple(d.reshape(n_steps * n_seq, 4 * hs) for d in dgates)
            dt = None
            if ctx.needs_input_grad[0]:
                wiu = _split(unit_major(w_i.detach()))
                dt = _mm3(d2, wiu).reshape(n_steps, n_seq, n_t)
            d_wi = _from_unit_major(_mm3(tuple(x.reshape(-1, n_t).t() for x in t2), d2))
            d_wh = _from_unit_major(_mm3(tuple(x.reshape(-1, hs).t() for x in hprev), d2))
            d_b = d2[0].sum(0, dtype=torch.float32) + d2[1].sum(0, dtype=torch.float32)
            return (dt, d_wi, d_wh, d_b.reshape(hs, 4).t().reshape(4 * hs), None, None,
                    None)


def fused_lstm_bptt(t: torch.Tensor, w_i: torch.Tensor, w_h: torch.Tensor,
                    b_h: torch.Tensor, carry, done: torch.Tensor):
    """The LSTM recurrence over a window (module docstring), differentiable
    in ``t`` and the weights. ``t`` f32 ``[T, S, n_t]``, ``w_i`` ``[4H,
    n_t]``, ``w_h`` ``[4H, H]``, ``b_h`` ``[4H]`` (the model's
    ``cell_i.weight``, ``cell_h.weight``, ``cell_h.bias``), ``carry`` (c0,
    h0) f32 ``[S, H]`` each, ``done`` ``[T, S]`` bool or int. Returns
    (h of every step before the reset ``[T, S, H]``, the carry after the
    window (c, h), which carries no gradient)."""
    c0, h0 = carry
    check_bptt_shape(w_h.shape[1])
    _check_inputs(t, w_i, w_h, b_h, c0, h0, done)
    h_all, c, h = _LstmBptt.apply(t, w_i, w_h, b_h, c0.detach(), h0.detach(), done)
    return h_all, (c, h)


def _check_inputs(t, w_i, w_h, b_h, c0, h0, done) -> None:
    """Raise unless the recurrence's inputs have the shapes, dtypes and
    device :func:`fused_lstm_bptt` takes."""
    hs = w_h.shape[1]
    if t.dim() != 3 or tuple(w_i.shape) != (4 * hs, t.shape[2]) or tuple(
            w_h.shape) != (4 * hs, hs) or tuple(b_h.shape) != (4 * hs,):
        raise ValueError(f"t [T, S, n_t], w_i [4H, n_t], w_h [4H, H], b_h [4H]; got "
                         f"{tuple(t.shape)}, {tuple(w_i.shape)}, {tuple(w_h.shape)}, "
                         f"{tuple(b_h.shape)}")
    shape = (t.shape[1], hs)
    if tuple(c0.shape) != shape or tuple(h0.shape) != shape or tuple(
            done.shape) != tuple(t.shape[:2]):
        raise ValueError(f"carry [S, H] = {shape} each and done [T, S]; got "
                         f"{tuple(c0.shape)}, {tuple(h0.shape)}, {tuple(done.shape)}")
    if any(x.dtype != torch.float32 for x in (t, w_i, w_h, b_h, c0, h0)):
        raise TypeError("t, the weights and the carry must be float32")
    if any(x.device != t.device for x in (w_i, w_h, b_h, c0, h0, done)):
        raise ValueError("t, the weights, the carry and done must share a device")


_LN_BWD = torch.ops.aten.native_layer_norm_backward


def ln_tail_reference(dpre, x, mux, rx, gxu, bxu, y, st_h, ghu, dn, c_rows, st_c, gc, bc):
    """LayerNorm's backward tail (module docstring) in PyTorch: ``dpre``,
    ``x`` (t Wi), ``y`` (h_{t-1} Wh) f32 ``[n, 4H]`` with unit-major
    columns, x's statistics ``mux``, ``rx`` ``[n, 1]``, y's and c''s
    ``st_h``, ``st_c`` ``[n, 2]``, ``dn`` and c' ``c_rows`` ``[n, H]``,
    the gains ``gxu``, ``ghu`` ``[4H]`` unit-major and ``gc`` ``[H]``
    (and the biases ``native_layer_norm_backward`` asks for). Returns
    (dx as its two bf16 terms (hi, lo) ``[n, 4H]``, dgx, db, dgh
    ``[4H]`` unit-major, dgc, dbc ``[H]``); db is the gradient of b, bx
    and bh alike."""
    g4, hs = x.shape[1], c_rows.shape[1]
    dx, dgx, db = _LN_BWD(dpre, x, [g4], mux, rx, gxu, bxu, [True, True, True])
    _, dgh, _ = _LN_BWD(dpre, y, [g4], st_h[:, :1].contiguous(), st_h[:, 1:].contiguous(),
                        ghu, bxu, [False, True, False])
    _, dgc, dbc = _LN_BWD(dn, c_rows, [hs], st_c[:, :1].contiguous(),
                          st_c[:, 1:].contiguous(), gc, bc, [False, True, True])
    return _split(dx), dgx, db, dgh, dgc, dbc


def _ln_tail_kernel(dpre, x, mux, rx, gxu, y, st_h, dn, c_all, st_c, dx32=None):
    """LayerNorm's backward tail on the card (``futbol_lnlstm_tail``: the
    tail kernel, then the sum over its blocks): :func:`ln_tail_reference`'s
    outputs from K6-LN's ``dpre`` ``[T, S, H, 4]`` and ``dn`` ``[T, S,
    H]``, the forward's ``y``, statistics and c' (fragment order) as they
    are saved, and ``x``, ``mux``, ``rx`` ``[T S, ...]``. ``dx32``, where
    given (f32 ``[T S, 4H]``), also receives dx before its split."""
    n_steps, n_seq, hs = dn.shape
    n, hp = n_steps * n_seq, round_up(hs, 16)
    ins = (dpre, x, mux, rx, gxu, y, st_h, dn, c_all, st_c)
    shapes = ((n_steps, n_seq, hs, 4), (n, 4 * hs), (n, 1), (n, 1), (4 * hs,),
              (n_steps, n_seq, hs, 4), (n_steps, n_seq, 2), (n_steps, n_seq, hs),
              (n_steps, -(-n_seq // ROWS), hp // 8, 8, 32, 2), (n_steps, n_seq, 2))
    outs = () if dx32 is None else (dx32,)
    if any(tuple(z.shape) != shape for z, shape in zip(ins + outs, shapes + ((n, 4 * hs),))):
        raise ValueError("the tail's inputs do not have the node's saved shapes")
    if any(not z.is_contiguous() or z.dtype != torch.float32 or z.data_ptr() % 16
           or z.device != dn.device for z in ins + outs):
        raise ValueError("the tail's tensors must be contiguous, 16-byte aligned float32 "
                         "on one device")
    plan = ln_tail_plan(hs, n)
    hi, lo = (dn.new_empty((n, 4 * hs), dtype=torch.bfloat16) for _ in range(2))
    part = dn.new_empty((plan["blocks"], plan["sums"]))
    sums = dn.new_empty(plan["sums"])
    _build.launch(
        "futbol_lnlstm_tail", "lnlstm_tail", *(z.data_ptr() for z in ins), hi.data_ptr(),
        lo.data_ptr(), None if dx32 is None else dx32.data_ptr(), part.data_ptr(),
        sums.data_ptr(), n_seq, n_steps, hs, plan["blocks"],
        torch.cuda.current_stream(dn.device).cuda_stream)
    dgx, db, dgh, dgc, dbc = sums.split([4 * hs] * 3 + [hs] * 2)
    return (hi, lo), dgx, db, dgh, dgc, dbc


class _LnLstmBptt(torch.autograd.Function):
    """The layer-normalised recurrence as one autograd node (module
    docstring): ``t Wi`` and its LayerNorm over the window, the kernels
    (or their plain versions on the CPU), then LayerNorm's backward and
    the weight gradients over all T * S rows."""

    @staticmethod
    def forward(ctx, t, w_i, w_h, b, gx, bx, gh, bh, gc, bc, c0, h0, done):
        with span("ops.fused_lnlstm_bptt"):
            n_steps, n_seq, _ = t.shape
            hs = w_h.shape[1]
            t2 = _split(t)
            wiu = unit_major(w_i.detach())
            x = _mm3_k(tuple(z.reshape(n_steps * n_seq, -1) for z in t2), _split(wiu.t()))
            gxu, bxu = unit_major(gx.detach()), unit_major(bx.detach() + b.detach())
            a, mux, rx = torch.native_layer_norm(x, [4 * hs], gxu, bxu, LN_EPS)
            a = a.reshape(n_steps, n_seq, hs, 4)
            done = (done.contiguous().view(torch.uint8) if done.dtype == torch.bool
                    else done.to(torch.uint8).contiguous())
            c0, h0 = c0.contiguous(), h0.contiguous()
            ghu = unit_major(gh.detach()).reshape(hs, 4).contiguous()
            gcd, bcd = gc.detach().contiguous(), bc.detach().contiguous()
            if t.device.type == "cpu":
                bhu = unit_major(bh.detach()).reshape(hs, 4)
                out = bptt_ln_forward_reference(a, w_h, ghu, bhu, gcd, bcd, c0, h0, done)
                out = (*out[:3], _split(out[3]), *out[4:])
                ctx.packed = None
            else:
                out, ctx.packed = _ln_forward_kernel(a, w_h, (gh, bh, gcd, bcd), c0, h0,
                                                     done)
            del a
            gates, c_all, h_all, hprev, y, st_h, st_c, c_last, h_last = out
            ctx.save_for_backward(w_i, w_h, c0, done, gates, c_all, y, st_h, st_c, x, mux,
                                  rx, gxu, bxu, ghu, gcd, bcd, *t2, *hprev)
            ctx.mark_non_differentiable(c_last, h_last)
            return h_all, c_last, h_last

    @staticmethod
    def backward(ctx, dh_all, _dc_last, _dh_last):
        with span("ops.fused_lnlstm_bptt"):
            (w_i, w_h, c0, done, gates, c_all, y, st_h, st_c, x, mux, rx, gxu, bxu, ghu,
             gcd, bcd, *split) = ctx.saved_tensors
            t2, hprev = split[:2], split[2:]
            n_steps, n_seq, hs = dh_all.shape
            n, n_t = n_steps * n_seq, w_i.shape[1]
            dh_all = dh_all.contiguous()
            if ctx.packed is None:
                dpre, dy, dn = bptt_ln_backward_reference(gates, c_all, y, st_h, st_c, c0,
                                                          done, dh_all, w_h, ghu, gcd, bcd)
                dy = _split(dy)
                dx2, dgx, d_b, dgh, dgc, dbc = ln_tail_reference(
                    dpre.reshape(n, 4 * hs), x, mux, rx, gxu, bxu, y.reshape(n, 4 * hs),
                    st_h.reshape(n, 2), ghu.reshape(-1), dn.reshape(n, hs),
                    c_all.reshape(n, hs), st_c.reshape(n, 2), gcd, bcd)
            else:
                dpre, dy, dn = _ln_backward_kernel(gates, c_all, y, st_h, st_c, c0, done,
                                                   dh_all, ctx.packed, ghu, gcd, bcd)
                dx2, dgx, d_b, dgh, dgc, dbc = _ln_tail_kernel(
                    dpre, x, mux, rx, gxu, y, st_h, dn, c_all, st_c)
            del dpre, dn
            d_wh = _from_unit_major(_mm3(tuple(z.reshape(-1, hs).t() for z in hprev),
                                         tuple(d.reshape(n, 4 * hs) for d in dy)))
            d_wi = _from_unit_major(_mm3(tuple(z.reshape(n, n_t).t() for z in t2), dx2))
            dt = None
            if ctx.needs_input_grad[0]:
                wiu = _split(unit_major(w_i.detach()))
                dt = _mm3(dx2, wiu).reshape(n_steps, n_seq, n_t)
            db = _from_unit_major(d_b)
            return (dt, d_wi, d_wh, db, _from_unit_major(dgx), db, _from_unit_major(dgh),
                    _from_unit_major(d_b), dgc, dbc, None, None, None)


def fused_lnlstm_bptt(t: torch.Tensor, w_i: torch.Tensor, w_h: torch.Tensor,
                      b: torch.Tensor, ln, carry, done: torch.Tensor):
    """The layer-normalised LSTM recurrence over a window (module
    docstring), differentiable in ``t``, the weights and the six LayerNorm
    leaves ``ln`` = (gx, bx, gh, bh ``[4H]``, gc, bc ``[H]``; the model's
    ``ln_i``, ``ln_h``, ``ln_c`` weights and biases, gate blocks in the
    cell's order). The rest as :func:`fused_lstm_bptt`'s."""
    c0, h0 = carry
    hs = w_h.shape[1]
    check_bptt_shape(hs)
    gx, bx, gh, bh, gc, bc = ln
    if tuple(b.shape) != (4 * hs,) or any(tuple(v.shape) != (4 * hs,)
                                           for v in (gx, bx, gh, bh)) or any(
            tuple(v.shape) != (hs,) for v in (gc, bc)):
        raise ValueError(f"b, gx, bx, gh, bh [4H] and gc, bc [H], H = {hs}")
    if any(v.dtype != torch.float32 or v.device != t.device for v in ln):
        raise TypeError("the LayerNorm leaves must be float32 on t's device")
    _check_inputs(t, w_i, w_h, b, c0, h0, done)
    h_all, c, h = _LnLstmBptt.apply(t, w_i, w_h, b, gx, bx, gh, bh, gc, bc, c0.detach(),
                                    h0.detach(), done)
    return h_all, (c, h)
