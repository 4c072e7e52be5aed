"""Recurrent (LSTM) self-play experience collection in one launch: the
CUDA kernel's wrapper and its plain PyTorch version.

Counterpart of :mod:`gym_futbol_tpu.ops.fused_recurrent`: the collect of
:mod:`gym_futbol_tpu_torch.ops.fused_collect` with an LSTM cell between
the torso and the heads. Each step, both views (view 0 is team 0, view
1 team 1 in its mirrored frame) go through one
:class:`~gym_futbol_tpu_torch.models.recurrent.RecurrentActorCritic`
(tanh torso, the cell on the view's own carry, logits and value heads);
each view's actions are sampled with their joint log-prob, team 1's
directions are un-mirrored, the env steps with auto-reset, and both
views' carries are zeroed where the episode ended. After the loop come
the bootstrap values: a forward of the carried state on the carried
(post-reset) carries, whose own carry advance is thrown away; the
carries returned are those from before it. On a CUDA tensor
:func:`fused_recurrent_collect` runs it all in one launch: with
``compute_dtype`` bfloat16 (the default, the JAX kernel's rounding on
its chip) of ``csrc/fused_recurrent_tc.cu`` (``recurrent_tc_kernel``:
the torso, the cell and the logits head on the tensor cores, laid out
by :func:`recurrent_tc_plan`), with float32 of ``csrc/fused_recurrent.cu``
(``recurrent_kernel``, exact f32); on a CPU tensor it runs the plain
version :func:`fused_recurrent_collect_reference` in the same mode.

Weights are the flat tuple of :func:`flatten_recurrent_actor_critic`.
Carries are feature-major ``[2, H, B]`` f32 (view 0, view 1). The input
carries are read, never written: the BPTT update needs the carry from
before the window.

OUTPUTS (the JAX package's, without its ``(B//128, 128)`` split):

    obs        [2, F_pad, T, B] f32  feature-major, pad rows zero
    dirs, acts [T, 2, B] i32         packed 3 bits per player
    logp       [T, 2, B] f32         joint log-prob of the sampled actions
    value      [T, 2, B] f32
    reward     [T, 2, B] f32         view k carries team k's reward
    done       [T, 2, B] i32
    last_value [2, B] f32            bootstrap values, both views
    carry_c, carry_h [2, H, B] f32   the carries after the window

The torso must have at least one layer: the JAX kernel, given an empty
torso, feeds ``tanh(obs)`` to the cell where the flax model feeds the raw
observation; here an empty torso raises, as it does for ``fused_collect``.

LayerNorm (``ln``: the six leaves of a layer-normalised cell,
:func:`layer_norm_leaves`): the bfloat16 route's kernel
``recurrent_ln_tc_kernel`` (the same body under a compile-time flag)
keeps the cell's two products apart and normalises each over its 4H
row, and c' over its H units, in float32: statistics over the real
columns, the population variance as ``E[y^2] - E[y]^2`` (clamped at 0),
``1 / sqrt(var + 1e-5)``. The float32 route refuses it. Its launches
count under ``ops.LAUNCHES["fused_recurrent_collect_ln"]``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import env as env_core
from ..models.policy import N_CHOICES
from ..models.recurrent import RecurrentActorCritic, lstm_cell
from ..types import EnvParams
from ..utils.profiling import spanned
from . import _build
from ._policy import (
    MAX_LAYERS,
    MAX_WIDTH,
    TC_CHUNK,
    TC_MAX_GATES,
    check_compute_dtype,
    check_mlp,
    collect_outputs,
    collect_reference,
    dense_rows,
    ln_stats,
    pack_mlp,
    padded,
    recurrent_gate_order,
    round_up,
    sigmoid,
    tc_buffers,
    tc_fragments,
    tc_inputs,
    tc_layout,
    tc_tiles,
    tc_torso,
    unit_major,
)
from .fused_rollout import (
    check_state,
    check_uniforms,
    kernel_args,
    n_draws_per_step,
    state_args,
)

__all__ = [
    "check_kernel_shape",
    "flatten_recurrent_actor_critic",
    "fused_recurrent_collect",
    "fused_recurrent_collect_reference",
    "layer_norm_leaves",
    "n_draws_per_step",
    "recurrent_tc_pack",
    "recurrent_tc_plan",
]

_build.counters("fused_recurrent_collect", "fused_recurrent_collect_f32",
                "fused_recurrent_collect_ln")


def flatten_recurrent_actor_critic(model: RecurrentActorCritic) -> tuple:
    """A :class:`RecurrentActorCritic`'s weights as the flat kernel-order
    tuple of the JAX package::

        (Wt1, bt1, ..., Wtk, btk,                     # torso, tanh after each
         Wi [n_t, 4H], Wh [H, 4H], bh [4H, 1],        # the cell, gates i|f|g|o
         Wl [H, G*5], bl [G*5, 1], Wv [H, 1], bv [1, 1])   # heads

    each ``W`` ``[in, out]`` f32 and ``b`` ``[out, 1]``."""
    def wb(layer):
        return (layer.weight.detach().t().contiguous(),
                layer.bias.detach().reshape(-1, 1).contiguous())

    out = [t for layer in model.torso for t in wb(layer)]
    out += [model.cell_i.weight.detach().t().contiguous(), *wb(model.cell_h)]
    out += [*wb(model.logits), *wb(model.value)]
    return tuple(out)


def layer_norm_leaves(model: RecurrentActorCritic) -> tuple | None:
    """The layer-normalised cell's leaves (gx, bx, gh, bh ``[4H]``, gates in
    blocks, gc, bc ``[H]``: ``ln_i``, ``ln_h``, ``ln_c``'s weights and
    biases), detached; None for the plain cell."""
    return tuple(p.detach() for ln in model.layer_norms()
                 for p in (ln.weight, ln.bias)) or None


def _check_ln(ln, hs: int, device) -> None:
    if ln is None:
        return
    shapes = [(4 * hs,)] * 4 + [(hs,)] * 2
    if len(ln) != 6 or any(tuple(v.shape) != sh or v.dtype != torch.float32
                           or v.device != device for v, sh in zip(ln, shapes)):
        raise ValueError(f"ln must be (gx, bx, gh, bh [4H], gc, bc [H]) float32 on the "
                         f"state's device, H = {hs}")


def _check_weights(weights: tuple, params: EnvParams) -> tuple[int, int]:
    """Validate a flat tuple; returns (torso layers, LSTM size H)."""
    n_torso = (len(weights) - 7) // 2
    if len(weights) < 9 or len(weights) % 2 == 0:
        raise ValueError(
            "the recurrent actor-critic needs a torso of at least one layer "
            "(the JAX kernel's empty-torso forward applies a tanh the model "
            "does not) and the flat tuple of flatten_recurrent_actor_critic")
    if any(w.dtype != torch.float32 for w in weights):
        raise TypeError("weights must be float32")
    prev = check_mlp(weights[:2 * n_torso], env_core.obs_size(params), "torso")[-1][1]
    wi, wh, bh, wl, bl, wv, bv = weights[2 * n_torso:]
    hs = wh.shape[0]
    n_logits = params.players_per_team * 2 * N_CHOICES
    shapes = ((wi, (prev, 4 * hs)), (wh, (hs, 4 * hs)), (bh, (4 * hs, 1)),
              (wl, (hs, n_logits)), (bl, (n_logits, 1)), (wv, (hs, 1)),
              (bv, (1, 1)))
    for w, shape in shapes:
        if tuple(w.shape) != shape:
            raise ValueError(f"the cell and heads must be Wi [{prev}, 4H], Wh "
                             f"[H, 4H], bh [4H, 1], Wl [H, {n_logits}], bl, Wv "
                             f"[H, 1], bv; got {tuple(w.shape)} for {shape}")
    return n_torso, hs


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _ln_rows(y: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the rows (features) of ``y`` ``[n, B]`` as the
    kernel computes it (:func:`._policy.ln_stats`); ``g``, ``b`` ``[n]``."""
    mu, r = ln_stats(y, (0,))
    return g[:, None] * ((y - mu) * r) + b[:, None]


def _forward(x: torch.Tensor, weights: tuple, n_torso: int, c: torch.Tensor,
             h: torch.Tensor, compute_dtype=torch.float32, ln=None):
    """One view's forward on ``x`` ``[F, B]`` and its carry ``[H, B]``:
    (logits ``[G*5, B]``, value ``[B]``, c', h'). The cell's two products
    are one sum over the stacked column ``[t; h]``, inputs in that order,
    then the bias. ``compute_dtype`` bfloat16 rounds the operands of the
    torso's, the cell's and the logits head's products (:func:`dense_rows`);
    the gates, the carries and the value head (on the unrounded h') stay
    f32. ``ln``: the layer-normalised cell, its products apart, each
    normalised (:func:`_ln_rows`), then the bias."""
    t = x
    for li in range(n_torso):
        t = torch.tanh(dense_rows(t, weights[2 * li], weights[2 * li + 1],
                                  compute_dtype))
    wi, wh, bh, wl, bl, wv, bv = weights[2 * n_torso:]
    if ln is None:
        gates = dense_rows(torch.cat([t, h]), torch.cat([wi, wh]), bh, compute_dtype)
        c, h = lstm_cell(gates, c, dim=0, sigmoid=sigmoid)
    else:
        gx, bx, gh, bhn, gc, bc = ln
        zero = bh.new_zeros(bh.shape)
        gates = (_ln_rows(dense_rows(t, wi, zero, compute_dtype), gx, bx)
                 + _ln_rows(dense_rows(h, wh, zero, compute_dtype), gh, bhn)) + bh
        i, f, g, o = gates.chunk(4, 0)
        c = sigmoid(f) * c + sigmoid(i) * torch.tanh(g)
        h = sigmoid(o) * torch.tanh(_ln_rows(c, gc, bc))
    return (dense_rows(h, wl, bl, compute_dtype), dense_rows(h, wv, bv)[0], c, h)


def fused_recurrent_collect_reference(
    statef: torch.Tensor, statei: torch.Tensor, weights: tuple,
    carry_c: torch.Tensor, carry_h: torch.Tensor, params: EnvParams,
    n_steps: int | None = None, *, uniforms: torch.Tensor | None = None,
    seed: int | None = None, compute_dtype=torch.bfloat16, ln=None,
):
    """The kernel's computation as T steps of row-matrix code.

    Exactly one draw source: ``uniforms`` f32 ``[T, n_draws, B]`` or
    ``seed`` (the kernel's Philox stream), drawn in ``fused_collect``'s
    order. ``compute_dtype`` and ``ln`` as :func:`fused_recurrent_collect`'s
    (:func:`_forward`). Returns (statef', statei', obs, dirs, acts, logp,
    value, reward, done, last_value, carry_c', carry_h') as listed in the
    module docstring.
    """
    check_compute_dtype(compute_dtype)
    n_torso, hs = _check_weights(weights, params)
    _check_ln(ln, hs, statef.device)
    cc, hh = list(carry_c), list(carry_h)

    def forward(v, x, last=False):
        # the bootstrap forward's own carry advance is thrown away
        logits, value, c, h = _forward(x, weights, n_torso, cc[v], hh[v], compute_dtype,
                                       ln)
        if not last:
            cc[v], hh[v] = c, h
        return logits, value

    def reset(done):
        # both views' carries zeroed where the episode ended
        keep = (1 - done).to(torch.float32)
        cc[:] = [c * keep for c in cc]
        hh[:] = [h * keep for h in hh]

    out = collect_reference(statef, statei, params, n_steps, uniforms, seed, forward,
                            reset)
    return (*out, torch.stack(cc), torch.stack(hh))


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# The tensor-core route (csrc/fused_recurrent_tc.cu)
# ---------------------------------------------------------------------------


def _reorder(w: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """``w``'s columns (last dim) in ``order``, zero where it is -1."""
    out = w[..., order.clamp_min(0)]
    return torch.where(order >= 0, out, torch.zeros_like(out))


def recurrent_tc_pack(weights: tuple, params: EnvParams, ln=None):
    """The flat recurrent weights as the tensor-core kernel takes them:
    (bf16 fragments, flat, in the order torso, logits head, cell; f32
    vector of the padded biases (the cell's in the kernel's column order)
    and the value head (hp weights, its bias, a pad); ctypes layer table
    ``[n_torso + 2, 4]`` of (kp, np, w_off in 16-byte units, b_off) for
    the torso layers, the cell and the head; the value head's offset).
    The cell is ``[t; h]`` x ``[kt + hp, 4 hp]``: Wi's rows, zero rows to
    the torso's padded width kt, Wh's rows, zero rows to hp; its columns
    :func:`._policy.recurrent_gate_order`'s. With ``ln`` the f32 vector
    goes on, from the value head's offset + hp + 2, with gx, bx, gh, bh in
    the cell's column order (``[4 hp]`` each, zero at a padded unit's
    columns) and gc, bc (``[hp]``, zero past H)."""
    n_torso, hs = _check_weights(weights, params)
    hp = round_up(hs, 16)
    wi, wh, bh, wl, bl, wv, bv = weights[2 * n_torso:]
    frags, fvec, table, w_off, b_off = tc_torso(
        list(zip(weights[:2 * n_torso:2], weights[1:2 * n_torso:2])),
        round_up(env_core.obs_size(params), 16), [TC_CHUNK] * n_torso)
    kt, nl = table[-3], round_up(wl.shape[1], 16)
    frags.append(tc_fragments(wl, hp, nl))
    wc = wi.new_zeros((kt + hp, 4 * hs))
    wc[:wi.shape[0]] = wi
    wc[kt:kt + hs] = wh
    order = recurrent_gate_order(hs).to(wi.device)
    frags.append(tc_fragments(_reorder(wc, order), kt + hp, 4 * hp))
    table += [kt + hp, 4 * hp, w_off + hp * nl // 8, b_off,     # the cell
              hp, nl, w_off, b_off + 4 * hp]                     # the logits head
    fvec += [_reorder(bh.reshape(-1), order), padded(bl, nl), wv.reshape(-1),
             wv.new_zeros(hp - hs), bv.reshape(1), bv.new_zeros(1)]
    if ln is not None:
        fvec += [_reorder(v, order) for v in ln[:4]]
        fvec += [F.pad(v, (0, hp - hs)) for v in ln[4:]]
    return (*tc_buffers(frags, fvec), (ctypes.c_int * len(table))(*table),
            b_off + 4 * hp + nl)


def recurrent_tc_plan(params: EnvParams, hidden, hsize: int, n_envs: int) -> dict:
    """How the tensor-core kernel runs ``n_envs`` envs, without a card.
    Each warp runs its own 32 envs and holds three tiles in shared
    memory: t[0] and t[1] as K2's (:func:`._policy.tc_tiles`), and xc
    (the cell's input ``[t | h]``, ``kt + hp`` wide, rows padded by 8
    bf16 elements). The fragments (:func:`recurrent_tc_pack`) are
    resident in shared memory as a prefix of ``n_res`` 16-byte units
    (torso, head, then as much of the cell as fits), the rest read from
    L2, as :func:`._policy.tc_layout` chooses with prefixes. Returns
    ``envs``, ``blocks``, ``smem``, ``blocks_per_sm``, ``n_res``,
    ``weights`` ("resident", "prefix" or "streamed"), ``frag_bytes``,
    ``ld`` and ``t_bytes`` of the three tiles."""
    hidden = tuple(int(x) for x in hidden)
    nl = round_up(params.players_per_team * 2 * N_CHOICES, 16)
    hp = round_up(hsize, 16)
    kps = tc_inputs(params, hidden)
    kt = kps[-1]
    units = (sum(k * n for k, n in zip(kps, kps[1:])) + hp * nl
             + (kt + hp) * 4 * hp) // 8
    ld, t_bytes = tc_tiles(params, [hidden])
    return tc_layout(n_envs, (*ld, kt + hp + 8), (*t_bytes, 64 * (kt + hp + 8)),
                     units, prefix=True)


def check_kernel_shape(widths, hsize: int, compute_dtype) -> None:
    """Raise unless the route of ``compute_dtype`` takes torso ``widths``
    and LSTM size ``hsize``: H a multiple of 4, at most
    ``MAX_LAYERS - 2`` torso layers of width at most ``MAX_WIDTH``; 4H at
    most :data:`TC_MAX_GATES` on the bfloat16 route, and on the float32
    route 4H and the cell's input rows (t and h together) at most
    ``MAX_WIDTH``."""
    if hsize % 4:
        raise ValueError(f"the kernel takes an LSTM size that is a multiple "
                         f"of 4, got {hsize}")
    if len(widths) + 2 > MAX_LAYERS or max(widths) > MAX_WIDTH:
        raise ValueError(f"the kernels take at most {MAX_LAYERS - 2} torso "
                         f"layers, each at most {MAX_WIDTH} wide")
    if compute_dtype == torch.float32:
        if max(4 * hsize, widths[-1] + hsize) > MAX_WIDTH:
            raise ValueError(
                f"the float32 kernel takes 4H <= {MAX_WIDTH} and t and h "
                f"together at most {MAX_WIDTH} rows, got H = {hsize} after a "
                f"torso {widths[-1]} wide; the bfloat16 route "
                f"(compute_dtype=torch.bfloat16) takes 4H <= {TC_MAX_GATES}")
    elif 4 * hsize > TC_MAX_GATES:
        raise ValueError(f"the bfloat16 kernel takes 4H <= {TC_MAX_GATES}, "
                         f"got H = {hsize}")


@spanned("ops.fused_recurrent_collect")
def fused_recurrent_collect(
    statef: torch.Tensor, statei: torch.Tensor, weights: tuple,
    carry_c: torch.Tensor, carry_h: torch.Tensor, seed: int,
    params: EnvParams, n_steps: int, uniforms: torch.Tensor | None = None,
    compute_dtype=torch.bfloat16, ln=None,
):
    """Collect ``n_steps`` of recurrent self-play experience (module
    docstring).

    ``weights``: the flat tuple of :func:`flatten_recurrent_actor_critic`
    (the kernels take H a multiple of 4, torso widths at most 512 and at
    most 6 torso layers; 4H at most 1024 on the bfloat16 route, at most
    512 on the float32 route, which also takes the cell's input t and h
    together at most 512 rows: :func:`check_kernel_shape`). ``carry_c``/
    ``carry_h`` f32 ``[2, H, B]``, left unchanged. Draws come from Philox
    keyed by ``seed`` (an int; a new seed for each call), or from
    ``uniforms`` f32 ``[n_steps, n_draws, B]``. ``compute_dtype``:
    bfloat16 (the main path: the products' operands rounded to bf16 and
    summed in f32, as the JAX kernel's run on its chip, on the
    tensor-core kernel laid out by :func:`recurrent_tc_plan`) or float32
    (exact, the CUDA-core kernel). ``ln``: the six leaves of a
    layer-normalised cell (:func:`layer_norm_leaves`), on the bfloat16
    route only. Returns (statef', statei', obs, dirs, acts, logp, value,
    reward, done, last_value, carry_c', carry_h').
    """
    check_compute_dtype(compute_dtype)
    b = check_state(statef, statei, params)
    n_torso, hs = _check_weights(weights, params)
    if ln is not None and compute_dtype == torch.float32:
        raise ValueError(
            "the float32 route (recurrent_kernel, recurrent A2C's fused collect) has no "
            "LayerNorm: a layer-normalised cell collects on compute_dtype=torch.bfloat16")
    _check_ln(ln, hs, statef.device)
    for name, c in (("carry_c", carry_c), ("carry_h", carry_h)):
        if tuple(c.shape) != (2, hs, b) or c.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [2, {hs}, {b}], got "
                             f"{c.dtype} {tuple(c.shape)}")
    if any(t.device != statef.device for t in (*weights, carry_c, carry_h)):
        raise ValueError("weights and carries must be on the state's device")
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    check_uniforms(uniforms, n_steps, params, statef)
    if statef.device.type == "cpu":
        return fused_recurrent_collect_reference(
            statef, statei, weights, carry_c, carry_h, params, n_steps,
            uniforms=uniforms, seed=None if uniforms is not None else seed,
            compute_dtype=compute_dtype, ln=ln)
    widths = [w.shape[1] for w in weights[:2 * n_torso:2]]
    check_kernel_shape(widths, hs, compute_dtype)
    if not (carry_c.is_contiguous() and carry_h.is_contiguous()):
        raise ValueError("carry_c and carry_h must be contiguous")
    b, c_consts, stream = kernel_args(statef, statei, params)
    sf, si, state = state_args(statef, statei)
    outs, tail = collect_outputs(params, statef, n_steps, uniforms, seed, c_consts,
                                 stream)
    cc, hh = torch.empty_like(carry_c), torch.empty_like(carry_h)
    carries = (carry_c.data_ptr(), carry_h.data_ptr(), cc.data_ptr(), hh.data_ptr(),
               *tail)
    if compute_dtype == torch.float32:
        wi, wh, bh = weights[2 * n_torso:2 * n_torso + 3]
        wl, bl, wv, bv = weights[2 * n_torso + 3:]
        # torso layers; the cell over [t; h], its columns unit-major; the
        # logits and value heads as one layer
        layers = list(zip(weights[:2 * n_torso:2], weights[1:2 * n_torso:2]))
        layers.append((unit_major(torch.cat([wi, wh]).t()).t(), unit_major(bh)))
        layers.append((torch.cat([wl, wv], 1), torch.cat([bl, bv], 0)))
        flat, table = pack_mlp(layers)
        _build.launch("futbol_fused_recurrent", "fused_recurrent_collect_f32", *state,
                      flat.data_ptr(), table, n_torso, hs, *carries)
    else:
        plan = recurrent_tc_plan(params, widths, hs, b)
        frags, fv, table, wv_off = recurrent_tc_pack(weights, params, ln)
        vals = (plan["envs"], plan["n_res"], *plan["t_bytes"], *plan["ld"])
        plan_ints = (ctypes.c_int * len(vals))(*vals)
        head = (*state, frags.data_ptr(), frags.numel() // 8, fv.data_ptr(), table,
                n_torso, hs, wv_off)
        if ln is None:
            _build.launch("futbol_fused_recurrent_tc", "fused_recurrent_collect", *head,
                          plan_ints, *carries)
        else:
            # the bootstrap forward's c' and o gates, both views: [2, 2, H, B]
            scratch = torch.empty((2, 2, hs, b), device=statef.device)
            _build.launch("futbol_fused_recurrent_ln_tc", "fused_recurrent_collect_ln",
                          *head, wv_off + round_up(hs, 16) + 2, scratch.data_ptr(),
                          plan_ints, *carries)
    return (sf, si, *outs, cc, hh)
