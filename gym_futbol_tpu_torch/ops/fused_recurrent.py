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
"""

from __future__ import annotations

import ctypes

import torch

from .. import env as env_core
from ..models.policy import N_CHOICES
from ..models.recurrent import RecurrentActorCritic, lstm_cell
from ..types import EnvParams
from ..utils.profiling import spanned
from .fused_actor import (
    MAX_LAYERS,
    MAX_WIDTH,
    TC_CHUNK,
    TC_ENVS,
    TC_SMEM_BYTES,
    TC_SMS,
    TC_WARPS_PER_SM,
    _round_up,
    check_compute_dtype,
    dense_rows,
    joint_action,
    obs_matrix,
    obs_scales,
    pack_mlp,
    pack_rows,
    sample_with_logp,
    step_draws,
    tc_fragments,
)
from .fused_collect import feature_rows
from .fused_rollout import (
    LAUNCHES,
    _check_state,
    _kernel_args,
    _raise_on_error,
    check_uniforms,
    n_draws_per_step,
    split_state,
    step_uniforms,
)

__all__ = [
    "check_kernel_shape",
    "flatten_recurrent_actor_critic",
    "fused_recurrent_collect",
    "fused_recurrent_collect_reference",
    "n_draws_per_step",
    "recurrent_gate_order",
    "recurrent_tc_pack",
    "recurrent_tc_plan",
]


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
    prev = env_core.obs_size(params)
    for li in range(n_torso):
        w, b = weights[2 * li], weights[2 * li + 1]
        if w.dim() != 2 or w.shape[0] != prev or tuple(b.shape) != (w.shape[1], 1):
            raise ValueError(f"torso layer {li} must be W [{prev}, out], b [out, 1]; "
                             f"got {tuple(w.shape)}, {tuple(b.shape)}")
        prev = w.shape[1]
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


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))`` written out, as the kernel rounds it."""
    return torch.reciprocal(1.0 + torch.exp(-x))


def _forward(x: torch.Tensor, weights: tuple, n_torso: int, c: torch.Tensor,
             h: torch.Tensor, compute_dtype=torch.float32):
    """One view's forward on ``x`` ``[F, B]`` and its carry ``[H, B]``:
    (logits ``[G*5, B]``, value ``[B]``, c', h'). The cell's two products
    are one sum over the stacked column ``[t; h]``, inputs in that order,
    then the bias. ``compute_dtype`` bfloat16 rounds the operands of the
    torso's, the cell's and the logits head's products (:func:`dense_rows`);
    the gates, the carries and the value head (on the unrounded h') stay
    f32."""
    t = x
    for li in range(n_torso):
        t = torch.tanh(dense_rows(t, weights[2 * li], weights[2 * li + 1],
                                  compute_dtype))
    wi, wh, bh, wl, bl, wv, bv = weights[2 * n_torso:]
    gates = dense_rows(torch.cat([t, h]), torch.cat([wi, wh]), bh, compute_dtype)
    c, h = lstm_cell(gates, c, dim=0, sigmoid=_sigmoid)
    return (dense_rows(h, wl, bl, compute_dtype), dense_rows(h, wv, bv)[0], c, h)


def fused_recurrent_collect_reference(
    statef: torch.Tensor, statei: torch.Tensor, weights: tuple,
    carry_c: torch.Tensor, carry_h: torch.Tensor, params: EnvParams,
    n_steps: int | None = None, *, uniforms: torch.Tensor | None = None,
    seed: int | None = None, compute_dtype=torch.bfloat16,
):
    """The kernel's computation as T steps of row-matrix code.

    Exactly one draw source: ``uniforms`` f32 ``[T, n_draws, B]`` or
    ``seed`` (the kernel's Philox stream), drawn in ``fused_collect``'s
    order. ``compute_dtype`` as :func:`fused_recurrent_collect`'s
    (:func:`_forward`). Returns (statef', statei', obs, dirs, acts, logp,
    value, reward, done, last_value, carry_c', carry_h') as listed in the
    module docstring.
    """
    if (uniforms is None) == (seed is None):
        raise ValueError("give exactly one of uniforms, seed")
    check_compute_dtype(compute_dtype)
    n_torso, _ = _check_weights(weights, params)
    n, ppt = params.n_bodies, params.players_per_team
    g = 2 * ppt
    f, f_pad = env_core.obs_size(params), feature_rows(params)
    n_draws = n_draws_per_step(params)
    b = statef.shape[1]
    if uniforms is not None:
        n_steps = uniforms.shape[0]
    px, py, vx, vy, poss, s0, s1, t = split_state(statef, statei, n)
    cc, hh = list(carry_c), list(carry_h)
    obs = statef.new_zeros((2, f_pad, n_steps, b))
    rows = {k: [] for k in ("dirs", "acts", "logp", "value", "reward", "done")}
    for k in range(n_steps):
        u = step_uniforms(uniforms, seed, k, n_draws, b, statef.device)
        idx = []
        for v in range(2):
            x = obs_matrix(px, py, vx, vy, poss, params, v == 1)
            obs[v, :f, k] = x
            logits, value, cc[v], hh[v] = _forward(x, weights, n_torso, cc[v], hh[v],
                                                   compute_dtype)
            iv, logp = sample_with_logp(logits, g, u[v * g:(v + 1) * g])
            idx.append(iv)
            rows["logp"].append(logp)
            rows["value"].append(value)
            dpack, apack = pack_rows(iv, ppt)
            rows["dirs"].append(dpack)
            rows["acts"].append(apack)
        dirs, acts = joint_action(idx[0], idx[1], ppt)
        theta, noise_x, noise_y = step_draws(u, params)
        s = env_core.step_scalars(px, py, vx, vy, poss, s0, s1, t, dirs, acts,
                                  theta, noise_x, noise_y, params)
        done = s.done.to(torch.int32)
        rows["reward"] += [s.r0, s.r1]
        rows["done"] += [done, done]
        # both views' carries zeroed where the episode ended
        keep = (1 - done).to(torch.float32)
        cc = [c * keep for c in cc]
        hh = [h * keep for h in hh]
        s = env_core.auto_reset_scalars(s)
        px, py, vx, vy = s.px, s.py, s.vx, s.vy
        poss, s0, s1, t = s.possession, s.score0, s.score1, s.t
    last_value = torch.stack([
        _forward(obs_matrix(px, py, vx, vy, poss, params, v == 1), weights,
                 n_torso, cc[v], hh[v], compute_dtype)[1]
        for v in range(2)])
    per_step = {k: torch.stack(r).reshape(n_steps, 2, b) for k, r in rows.items()}
    return (torch.stack(px + py + vx + vy),
            torch.stack([poss, s0, s1, t]).to(torch.int32), obs,
            per_step["dirs"], per_step["acts"], per_step["logp"],
            per_step["value"], per_step["reward"], per_step["done"], last_value,
            torch.stack(cc), torch.stack(hh))


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------


def _unit_major(hs: int) -> torch.Tensor:
    """Column order of the float32 kernel's cell: column 4u + g is gate g
    of unit u (the JAX layout has gate g's block at columns g*H..g*H+H-1)."""
    return torch.arange(4 * hs).reshape(4, hs).t().reshape(-1)


# ---------------------------------------------------------------------------
# The tensor-core route (csrc/fused_recurrent_tc.cu)
# ---------------------------------------------------------------------------


# 4H on the tensor-core route: the widest cell run against its plain
# version on the card (H = 256, stable-baselines' MlpLstmPolicy)
TC_MAX_GATES = 1024


def recurrent_gate_order(hsize: int) -> torch.Tensor:
    """The tensor-core kernel's cell columns: entry ``n`` of the ``[4
    hp]`` result (hp = H rounded up to 16) is the JAX-layout column
    (gate g at ``g * H + u``) that the kernel's column ``n`` holds, or -1
    for a padded unit's. Column ``64 q + 16 j + 8 h + 2 t + e`` is gate
    ``2 h + e`` (i, f, g, o) of unit ``16 q + 8 (j // 2) + 2 t + j % 2``:
    the mma C fragment of lane (g, t) over n16 chunk j of group q holds
    its unit's four gates, and over the group's four chunks the lane's
    units 2t, 2t+1, 8+2t, 9+2t are the heads' A fragment of k-step q."""
    hp = _round_up(hsize, 16)
    n = torch.arange(4 * hp)
    q, j, h, t, e = n // 64, n // 16 % 4, n // 8 % 2, n // 2 % 4, n % 2
    u = 16 * q + 8 * (j // 2) + 2 * t + j % 2
    return torch.where(u < hsize, (2 * h + e) * hsize + u, -1)


def _reorder(w: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """``w``'s columns (last dim) in ``order``, zero where it is -1."""
    out = w[..., order.clamp_min(0)]
    return torch.where(order >= 0, out, torch.zeros_like(out))


def recurrent_tc_pack(weights: tuple, params: EnvParams):
    """The flat recurrent weights as the tensor-core kernel takes them:
    (bf16 fragments, flat, in the order torso, logits head, cell; f32
    vector of the padded biases (the cell's in the kernel's column order)
    and the value head (hp weights, its bias, a pad); ctypes layer table
    ``[n_torso + 2, 4]`` of (kp, np, w_off in 16-byte units, b_off) for
    the torso layers, the cell and the head; the value head's offset).
    The cell is ``[t; h]`` x ``[kt + hp, 4 hp]``: Wi's rows, zero rows to
    the torso's padded width kt, Wh's rows, zero rows to hp; its columns
    :func:`recurrent_gate_order`'s."""
    n_torso, hs = _check_weights(weights, params)
    hp = _round_up(hs, 16)
    wi, wh, bh, wl, bl, wv, bv = weights[2 * n_torso:]
    torso_frags, cell_head = [], []
    fvec, rows = [], []
    w_off = b_off = 0
    kp = _round_up(env_core.obs_size(params), 16)
    for li in range(n_torso):
        w, b = weights[2 * li], weights[2 * li + 1]
        np_ = _round_up(w.shape[1], TC_CHUNK)
        torso_frags.append(tc_fragments(w, kp, np_))
        fvec.append(torch.cat([b.reshape(-1), b.new_zeros(np_ - w.shape[1])]))
        rows.append([kp, np_, w_off, b_off])
        w_off, b_off = w_off + kp * np_ // 8, b_off + np_
        kp = np_
    kt, nl = kp, _round_up(wl.shape[1], 16)
    head_frags = tc_fragments(wl, hp, nl)
    head_off = w_off
    w_off += hp * nl // 8
    wc = wi.new_zeros((kt + hp, 4 * hs))
    wc[:wi.shape[0]] = wi
    wc[kt:kt + hs] = wh
    order = recurrent_gate_order(hs).to(wi.device)
    cell_frags = tc_fragments(_reorder(wc, order), kt + hp, 4 * hp)
    rows.append([kt + hp, 4 * hp, w_off, b_off])         # the cell
    fvec.append(_reorder(bh.reshape(-1), order))
    b_off += 4 * hp
    rows.append([hp, nl, head_off, b_off])               # the logits head
    fvec.append(torch.cat([bl.reshape(-1), bl.new_zeros(nl - wl.shape[1])]))
    b_off += nl
    wv_off = b_off
    fvec += [wv.reshape(-1), wv.new_zeros(hp - hs), bv.reshape(1), bv.new_zeros(1)]
    flat = torch.cat([*torso_frags, head_frags, cell_frags])
    fv = torch.cat(fvec)
    if flat.data_ptr() % 16 or fv.data_ptr() % 16:
        raise ValueError("the weight buffers must be 16-byte aligned")
    table = [x for r in rows for x in r]
    return flat, fv, (ctypes.c_int * len(table))(*table), wv_off


def recurrent_tc_plan(params: EnvParams, hidden, hsize: int, n_envs: int) -> dict:
    """How the tensor-core kernel runs ``n_envs`` envs, without a card.
    Each warp runs its own 32 envs and holds three tiles in shared
    memory: t[0] (the obs, torso layers 0, 2, .. but the last, the f32
    logits and value), t[1] (torso layers 1, 3, .. but the last), xc (the
    cell's input ``[t | h]``, ``kt + hp`` wide), rows padded by 8 bf16
    elements so that ldmatrix meets no bank conflict. The fragments
    (:func:`recurrent_tc_pack`) are resident in shared memory as a prefix
    of ``n_res`` 16-byte units (torso, head, then as much of the cell as
    fits), the rest read from L2. The choice, in order: the fewest envs
    on the busiest SM, the fewest waves of blocks, the most resident
    bytes, more envs a block (``envs`` from :data:`TC_ENVS`). Returns
    ``envs``, ``blocks``, ``smem``, ``blocks_per_sm``, ``n_res``,
    ``weights`` ("resident", "prefix" or "streamed"), ``frag_bytes``,
    ``ld`` and ``t_bytes`` of the three tiles."""
    hidden = tuple(int(x) for x in hidden)
    f = env_core.obs_size(params)
    g5 = params.players_per_team * 2 * N_CHOICES
    k0, nl, hp = _round_up(f, 16), _round_up(g5, 16), _round_up(hsize, 16)
    nps = [_round_up(x, TC_CHUNK) for x in hidden]
    units, kp = 0, k0
    for np_ in nps:
        units += kp * np_ // 8
        kp = np_
    kt = kp
    units += hp * nl // 8 + (kt + hp) * 4 * hp // 8
    widest = [k0, 0]
    for li, np_ in enumerate(nps[:-1]):
        widest[li % 2] = max(widest[li % 2], np_)
    ld = (widest[0] + 8, widest[1] + 8 if widest[1] else 0, kt + hp + 8)
    t_bytes = (_round_up(max(64 * ld[0], 128 * (nl + 1)), 16), 64 * ld[1], 64 * ld[2])
    best = None
    for envs in TC_ENVS:
        tiles = envs // 32 * sum(t_bytes)
        if tiles > TC_SMEM_BYTES:
            continue
        blocks = -(-n_envs // envs)
        fill = [min(units, (TC_SMEM_BYTES // per - tiles) // 16)
                for per in (1, 2) if TC_SMEM_BYTES // per >= tiles]
        for n_res in {*fill, 0}:
            smem = 16 * n_res + tiles
            per_sm = min(TC_WARPS_PER_SM // (envs // 32), TC_SMEM_BYTES // smem)
            key = (-(-blocks // TC_SMS) * envs, -(-blocks // (TC_SMS * per_sm)),
                   -n_res, -envs)
            if best is None or key < best[0]:
                weights = ("resident" if n_res == units else
                           "streamed" if n_res == 0 else "prefix")
                best = (key, dict(route="tensor_cores", envs=envs, blocks=blocks,
                                  smem=smem, blocks_per_sm=per_sm, n_res=n_res,
                                  weights=weights, frag_bytes=16 * units, ld=ld,
                                  t_bytes=t_bytes))
    return best[1]


def recurrent_tc_plan_ints(plan: dict):
    """The plan as the kernel's C interface takes it: envs, n_res, the
    tiles' bytes and row strides."""
    vals = (plan["envs"], plan["n_res"], *plan["t_bytes"], *plan["ld"])
    return (ctypes.c_int * len(vals))(*vals)


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
    compute_dtype=torch.bfloat16,
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
    (exact, the CUDA-core kernel). Returns (statef', statei', obs, dirs,
    acts, logp, value, reward, done, last_value, carry_c', carry_h').
    """
    check_compute_dtype(compute_dtype)
    b = _check_state(statef, statei, params)
    n_torso, hs = _check_weights(weights, params)
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
            compute_dtype=compute_dtype)
    widths = [w.shape[1] for w in weights[:2 * n_torso:2]]
    check_kernel_shape(widths, hs, compute_dtype)
    if not (carry_c.is_contiguous() and carry_h.is_contiguous()):
        raise ValueError("carry_c and carry_h must be contiguous")
    b, c_consts, stream = _kernel_args(statef, statei, params)
    f_pad = feature_rows(params)
    dev = statef.device

    def out(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    sf, si = torch.empty_like(statef), torch.empty_like(statei)
    obs = out(2, f_pad, n_steps, b)
    dirs, acts, done = (out(n_steps, 2, b, dtype=torch.int32) for _ in range(3))
    logp, value, reward = (out(n_steps, 2, b) for _ in range(3))
    last_value = out(2, b)
    cc, hh = torch.empty_like(carry_c), torch.empty_like(carry_h)
    scales = (ctypes.c_float * 3)(*obs_scales(params))
    carries = (carry_c.data_ptr(), carry_h.data_ptr(), cc.data_ptr(), hh.data_ptr(),
               obs.data_ptr(), dirs.data_ptr(), acts.data_ptr(), logp.data_ptr(),
               value.data_ptr(), reward.data_ptr(), done.data_ptr(),
               last_value.data_ptr(),
               None if uniforms is None else uniforms.data_ptr(),
               seed & 0xFFFFFFFF, params.n_bodies, b, n_steps, f_pad,
               params.substeps, params.solver_iterations, params.max_steps,
               c_consts, len(c_consts), scales, stream)
    from . import _build

    lib = _build.load()
    if compute_dtype == torch.float32:
        wi, wh, bh = weights[2 * n_torso:2 * n_torso + 3]
        wl, bl, wv, bv = weights[2 * n_torso + 3:]
        perm = _unit_major(hs).to(dev)
        # torso layers; the cell over [t; h], its columns unit-major; the
        # logits and value heads as one layer
        layers = list(zip(weights[:2 * n_torso:2], weights[1:2 * n_torso:2]))
        layers.append((torch.cat([wi, wh])[:, perm], bh[perm]))
        layers.append((torch.cat([wl, wv], 1), torch.cat([bl, bv], 0)))
        flat, table = pack_mlp(layers)
        err = lib.futbol_fused_recurrent(
            statef.data_ptr(), statei.data_ptr(), sf.data_ptr(), si.data_ptr(),
            flat.data_ptr(), table, n_torso, hs, *carries)
        name = "fused_recurrent_collect_f32"
    else:
        plan = recurrent_tc_plan(params, widths, hs, b)
        frags, fv, table, wv_off = recurrent_tc_pack(weights, params)
        err = lib.futbol_fused_recurrent_tc(
            statef.data_ptr(), statei.data_ptr(), sf.data_ptr(), si.data_ptr(),
            frags.data_ptr(), frags.numel() // 8, fv.data_ptr(), table, n_torso, hs,
            wv_off, recurrent_tc_plan_ints(plan), *carries)
        name = "fused_recurrent_collect"
    _raise_on_error(err, "fused_recurrent_collect")
    LAUNCHES[name] += 1
    return (sf, si, obs, dirs, acts, logp, value, reward, done, last_value,
            cc, hh)
