"""The host side the policy kernels K2 (:mod:`.fused_collect`), K4
(:mod:`.fused_actor`) and K5 (:mod:`.fused_recurrent`) share, with the
LSTM gate layout K5 shares with K6 (:mod:`.fused_bptt`): the plain
versions' pieces on ``[feature, B]`` row matrices, each dense output an
ordered sum over its inputs with the bias added last (the kernels'
arithmetic, operation for operation); the float32 routes' MLP packing;
the tensor-core routes' fragment order, layout search and torso packer;
the collect kernels' outputs and trailing launch arguments."""

from __future__ import annotations

import ctypes

import torch

from .. import env as env_core
from ..models.policy import N_CHOICES, pack_actions, sample_group
from ..models.recurrent import LN_EPS
from ..physics import to_dtype
from ..types import EnvParams
from . import _build
from .fused_rollout import (
    n_draws_per_step,
    normal_from,
    pm1_from,
    split_state,
    step_args,
    step_uniforms,
)

# The float32 kernels' limits (csrc/fused_policy.cu): dense layers per
# MLP, and the widest layer, whose two activation columns per env must
# fit the block's shared memory (2 * 512 rows * 32 envs * 4 bytes = 128
# KB); layer widths pad to a multiple of CHUNK, the register tile.
MAX_LAYERS = 8
MAX_WIDTH = 512
CHUNK = 16
# The tensor-core kernels: up to 255 registers a thread, so 8 warps per
# SM; hidden widths pad to the kernels' output chunk; envs per block, 32
# a warp.
TC_WARPS_PER_SM = 8
TC_CHUNK = 32
TC_ENVS = (128, 64, 32)
# 4H on K5's tensor-core route and in K6: the widest cell run against
# its plain version on the card (H = 256, stable-baselines'
# MlpLstmPolicy)
TC_MAX_GATES = 1024


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def feature_rows(params: EnvParams) -> int:
    """F_pad: the observation's F rows rounded up to a multiple of 8."""
    return round_up(env_core.obs_size(params), 8)


def check_compute_dtype(compute_dtype) -> None:
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("compute_dtype must be torch.bfloat16 or torch.float32")


# ---------------------------------------------------------------------------
# Plain versions of the kernels' pieces (row matrices [rows, B])
# ---------------------------------------------------------------------------


def obs_scales(params: EnvParams) -> tuple[float, float, float]:
    """(1/width, 1/height, 1/max_speed), each rounded to f32 as
    ``jnp.float32(1.0 / x)`` rounds it."""
    f32 = torch.float32
    return (to_dtype(1.0 / params.width, f32), to_dtype(1.0 / params.height, f32),
            to_dtype(1.0 / params.max_speed, f32))


def obs_matrix(px, py, vx, vy, possession, params: EnvParams,
               mirror: bool) -> torch.Tensor:
    """The observation as an ``[F, B]`` matrix from per-body ``[B]``
    rows: positions times the f32 reciprocals of the field size (not
    divided, as ``env.observe`` does), velocities times 1/max_speed,
    then the possession flags. ``mirror`` gives team 1's view:
    x -> 1 - x, vx -> -vx, team blocks and flags swapped."""
    ppt = params.players_per_team
    inv_w, inv_h, inv_s = obs_scales(params)
    order = list(range(params.n_bodies))
    if mirror:
        order = [0, *range(1 + ppt, 1 + 2 * ppt), *range(1, 1 + ppt)]
    rows = []
    for i in order:
        x = px[i] * inv_w
        rows += [1.0 - x if mirror else x, py[i] * inv_h]
    for i in order:
        v = vx[i] * inv_s
        rows += [-v if mirror else v, vy[i] * inv_s]
    owner_p = possession - 1
    owns0 = ((possession > 0) & (owner_p < ppt)).to(px[0].dtype)
    owns1 = ((possession > 0) & (owner_p >= ppt)).to(px[0].dtype)
    rows += [owns1, owns0] if mirror else [owns0, owns1]
    return torch.stack(rows)


def dense_rows(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               compute_dtype=torch.float32) -> torch.Tensor:
    """``x`` ``[in, B]`` through ``w`` ``[in, out]``, ``b`` ``[out, 1]``:
    each output summed over the inputs in ascending order, then the bias
    added, each product and sum rounded to f32 (no FMA), as the float32
    kernels compute it. With ``compute_dtype`` bfloat16, ``x`` and ``w``
    are rounded to bf16 first, as the tensor-core routes round their
    operands (a product of two bf16 values is exact in f32)."""
    if compute_dtype == torch.bfloat16:
        x = x.to(compute_dtype).to(torch.float32)
        w = w.to(compute_dtype).to(torch.float32)
    acc = w[0][:, None] * x[0]
    for k in range(1, w.shape[0]):
        acc = acc + w[k][:, None] * x[k]
    return acc + b


def sample_with_logp(logit_rows: torch.Tensor, n_groups: int,
                     uniforms: torch.Tensor):
    """Row-form inverse-CDF sampling of each 5-way group of
    ``logit_rows`` ``[G*5, B]`` with ``uniforms[g]`` ``[B]``: (index rows
    ``[B]`` int32 per group, joint log-prob of the sampled indices)."""
    idxs, logp_total = [], None
    for g in range(n_groups):
        idx, taken = sample_group(
            [logit_rows[g * N_CHOICES + i] for i in range(N_CHOICES)],
            uniforms[g])
        idxs.append(idx)
        logp_total = taken if logp_total is None else logp_total + taken
    return idxs, logp_total


# Swap left/right (2 <-> 4) for the mirrored team's direction.
unmirror_dir = env_core.mirror_dir


def joint_action(ia: list, ib: list, ppt: int):
    """World-frame (dirs, acts) per player from both views' group
    indices: team 0 as sampled, team 1's directions un-mirrored."""
    dirs = [ia[2 * p] for p in range(ppt)] + [
        unmirror_dir(ib[2 * p]) for p in range(ppt)]
    acts = [ia[2 * p + 1] for p in range(ppt)] + [
        ib[2 * p + 1] for p in range(ppt)]
    return dirs, acts


def pack_rows(idx: list, ppt: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One view's group index rows packed at 3 bits per player: (dirs,
    acts)."""
    return pack_actions(torch.stack(idx, -1).reshape(-1, ppt, 2))


def step_draws(u: torch.Tensor, params: EnvParams):
    """The env's draws of one step from its uniforms ``[n_draws, B]``
    (after both views' group draws): (theta, kickoff noise x, y)."""
    n, g = params.n_bodies, 2 * params.players_per_team
    theta = normal_from(u[2 * g], u[2 * g + 1]) * to_dtype(
        params.kick_noise, u.dtype)
    noise_x = [pm1_from(u[2 * g + 2 + i]) for i in range(n)]
    noise_y = [pm1_from(u[2 * g + 2 + n + i]) for i in range(n)]
    return theta, noise_x, noise_y


def collect_reference(statef, statei, params: EnvParams, n_steps, uniforms, seed,
                      forward, reset=lambda done: None):
    """K2's and K5's computation as T steps of row-matrix code: each
    step, each view's obs through ``forward(view, x)`` -> (logits ``[G*5,
    B]``, value ``[B]``), its actions sampled with their joint log-prob,
    the env stepped with the joint action, ``reset(done)`` (K5 zeroes its
    carries there), then the auto-reset; after the loop the bootstrap
    values, ``forward(view, x, last=True)``. Exactly one draw source:
    ``uniforms`` f32 ``[T, n_draws, B]`` or ``seed`` (the kernels' Philox
    stream), in :func:`.fused_actor.fused_selfplay_rollout_reference`'s
    order. Returns (statef', statei', obs, dirs, acts, logp, value,
    reward, done, last_value) as :mod:`.fused_collect` lists them."""
    if (uniforms is None) == (seed is None):
        raise ValueError("give exactly one of uniforms, seed")
    n, ppt = params.n_bodies, params.players_per_team
    g = 2 * ppt
    f, f_pad = env_core.obs_size(params), feature_rows(params)
    n_draws = n_draws_per_step(params)
    b = statef.shape[1]
    if uniforms is not None:
        n_steps = uniforms.shape[0]
    px, py, vx, vy, poss, s0, s1, t = split_state(statef, statei, n)
    obs = statef.new_zeros((2, f_pad, n_steps, b))
    rows = {k: [] for k in ("dirs", "acts", "logp", "value", "reward", "done")}
    for k in range(n_steps):
        u = step_uniforms(uniforms, seed, k, n_draws, b, statef.device)
        idx = []
        for v in range(2):
            x = obs_matrix(px, py, vx, vy, poss, params, v == 1)
            obs[v, :f, k] = x
            logits, value = forward(v, x)
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
        reset(done)
        s = env_core.auto_reset_scalars(s)
        px, py, vx, vy = s.px, s.py, s.vx, s.vy
        poss, s0, s1, t = s.possession, s.score0, s.score1, s.t
    last_value = torch.stack([
        forward(v, obs_matrix(px, py, vx, vy, poss, params, v == 1), last=True)[1]
        for v in range(2)])
    per_step = {k: torch.stack(r).reshape(n_steps, 2, b) for k, r in rows.items()}
    return (torch.stack(px + py + vx + vy),
            torch.stack([poss, s0, s1, t]).to(torch.int32), obs,
            per_step["dirs"], per_step["acts"], per_step["logp"],
            per_step["value"], per_step["reward"], per_step["done"], last_value)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))`` written out, as the kernels round it."""
    return torch.reciprocal(1.0 + torch.exp(-x))


def ln_stats(y: torch.Tensor, dims) -> tuple[torch.Tensor, torch.Tensor]:
    """The LayerNorm statistics K5's and K6's LayerNorm instantiations take
    of ``y`` over ``dims`` (kept): the mean and ``1 / sqrt(var + eps)``,
    var = ``E[y^2] - E[y]^2`` clamped at 0, each a sum in float32."""
    n = 1
    for d in dims:
        n *= y.shape[d]
    mu = y.sum(dims, keepdim=True) / n
    var = ((y * y).sum(dims, keepdim=True) / n - mu * mu).clamp_min(0.0)
    return mu, 1.0 / torch.sqrt(var + LN_EPS)


def unit_major(w: torch.Tensor) -> torch.Tensor:
    """``w`` ``[4H, ...]``, gate g's block at rows g H .. g H + H - 1 (the
    model's and the JAX layout), with its rows unit-major: row 4 u + g is
    gate g of unit u (K5's float32 cell, K6's gate gradients)."""
    return w.reshape(4, w.shape[0] // 4, -1).transpose(0, 1).reshape(w.shape)


# ---------------------------------------------------------------------------
# The float32 routes' weights (csrc/fused_policy.cu, csrc/fused_recurrent.cu)
# ---------------------------------------------------------------------------


def check_mlp(weights: tuple, n_in: int, name: str) -> list[tuple[int, int]]:
    """Validate a flat (W, b, ...) tuple; returns its (in, out) per layer."""
    if len(weights) < 2 or len(weights) % 2:
        raise ValueError(f"{name}: a flat (W1, b1, ..., Wl, bl) tuple")
    dims, prev = [], n_in
    for li in range(len(weights) // 2):
        w, b = weights[2 * li], weights[2 * li + 1]
        if w.dtype != torch.float32 or b.dtype != torch.float32:
            raise TypeError(f"{name}: weights must be float32")
        if w.dim() != 2 or w.shape[0] != prev or tuple(b.shape) != (w.shape[1], 1):
            raise ValueError(f"{name}: layer {li} must be W [{prev}, out], "
                             f"b [out, 1]; got {tuple(w.shape)}, {tuple(b.shape)}")
        dims.append((w.shape[0], w.shape[1]))
        prev = w.shape[1]
    return dims


def check_limits(dims: list[tuple[int, int]]) -> None:
    """The kernels' limits on an MLP's (in, out) layers, both routes."""
    if len(dims) > MAX_LAYERS:
        raise ValueError(f"the kernels take at most {MAX_LAYERS} dense layers")
    if max(max(d) for d in dims) > MAX_WIDTH:
        raise ValueError(f"layer widths must be <= {MAX_WIDTH}")


def pack_mlp(layers: list[tuple[torch.Tensor, torch.Tensor]]):
    """Dense layers ``(W [in, out], b)`` -> (flat f32 buffer, ctypes int
    table ``[n_layers, 4]`` of (in, out_pad, w_off, b_off)) in the
    float32 kernels' layout: each W padded with zero columns to
    ``out_pad``, a multiple of 16, then its bias padded the same."""
    check_limits([tuple(w.shape) for w, _ in layers])
    chunks, table, off = [], [], 0
    for w, b in layers:
        n_in, n_out = w.shape
        out_pad = round_up(n_out, CHUNK)
        wp = w.new_zeros((n_in, out_pad))
        wp[:, :n_out] = w
        bp = w.new_zeros(out_pad)
        bp[:n_out] = b.reshape(-1)
        table += [n_in, out_pad, off, off + n_in * out_pad]
        off += n_in * out_pad + out_pad
        chunks += [wp.reshape(-1), bp]
    flat = torch.cat(chunks)
    if flat.data_ptr() % 16:
        raise ValueError("the flat weight buffer must be 16-byte aligned")
    return flat, (ctypes.c_int * len(table))(*table)


# ---------------------------------------------------------------------------
# The tensor-core routes (csrc/fused_policy_tc.cu, csrc/fused_recurrent_tc.cu)
# ---------------------------------------------------------------------------


def tc_inputs(params: EnvParams, hidden) -> list[int]:
    """A torso's padded widths, input first: the obs rounded up to 16,
    then each hidden layer's output rounded up to :data:`TC_CHUNK`."""
    return [round_up(env_core.obs_size(params), 16),
            *(round_up(h, TC_CHUNK) for h in hidden)]


def tc_tiles(params: EnvParams, hiddens):
    """Row strides ``ld`` (bf16 elements) and bytes of a warp's two
    tiles: t[0] holds the obs, hidden layers 0, 2, .. and the f32 logits
    and value ``[nl + 1][32]``; t[1] layers 1, 3, ..; each torso's last
    hidden layer stays in registers. Rows are padded by 8 elements: the 8
    rows an ldmatrix reads fall in 8 bank groups."""
    widest = [round_up(env_core.obs_size(params), 16), 0]
    for hs in hiddens:
        for li, np_ in enumerate(tc_inputs(params, hs)[1:-1]):
            widest[li % 2] = max(widest[li % 2], np_)
    ld = [w + 8 if w else 0 for w in widest]
    nl = round_up(params.players_per_team * 2 * N_CHOICES, 16)
    return ld, [round_up(max(64 * ld[0], 128 * (nl + 1)), 16), 64 * ld[1]]


def tc_layout(n_envs: int, ld, t_bytes, units: int, prefix: bool = False) -> dict:
    """The tensor-core kernels' launch for ``n_envs`` envs, each warp
    running its own 32 envs with its tiles (``ld``, ``t_bytes``) in
    shared memory, and of the weights' ``units`` 16-byte units of
    fragments the first ``n_res`` resident in shared memory, the rest
    read from L2: all or none, or with ``prefix`` also as many as fill
    the block at one or two blocks an SM. The choice, in order: the
    fewest envs on the busiest SM (no SM left empty while another takes
    two blocks' envs), the fewest waves of blocks, the most resident
    bytes, more envs a block (from :data:`TC_ENVS`). Returns ``envs``,
    ``blocks``, ``smem`` bytes, ``blocks_per_sm``, ``n_res``, ``weights``
    ("resident", "prefix" or "streamed"), ``frag_bytes``, ``ld`` and
    ``t_bytes``."""
    smem_max, sms = _build.SMEM_BYTES, _build.SMS
    best = None
    for envs in TC_ENVS:
        tiles = envs // 32 * sum(t_bytes)
        blocks = -(-n_envs // envs)
        fills = {units, 0}
        if prefix:
            fills = {min(units, (smem_max // per - tiles) // 16)
                     for per in (1, 2) if smem_max // per >= tiles} | {0}
        for n_res in fills:
            smem = 16 * n_res + tiles
            if smem > smem_max:
                continue
            per_sm = min(TC_WARPS_PER_SM // (envs // 32), smem_max // smem)
            key = (-(-blocks // sms) * envs, -(-blocks // (sms * per_sm)),
                   -n_res, -envs)
            if best is None or key < best[0]:
                best = (key, dict(envs=envs, blocks=blocks, smem=smem,
                                  blocks_per_sm=per_sm, n_res=n_res))
    plan = best[1]
    weights = ("resident" if plan["n_res"] == units else
               "streamed" if plan["n_res"] == 0 else "prefix")
    return dict(route="tensor_cores", **plan, weights=weights,
                frag_bytes=16 * units, ld=tuple(ld), t_bytes=tuple(t_bytes))


def tc_plan(params: EnvParams, hiddens, n_envs: int,
            compute_dtype=torch.bfloat16) -> dict:
    """How K2 and K4 run ``n_envs`` envs, without a card. ``hiddens``:
    one tuple of hidden widths per MLP (fused_collect: the torso's;
    fused_selfplay_rollout: each policy's widths but the last layer's).

    float32 takes the exact route of ``csrc/fused_policy.cu``
    ("cuda_cores": 32 envs and 4 warps a block, two activation columns
    per env in shared memory). bfloat16 takes ``csrc/fused_policy_tc.cu``
    ("tensor_cores") as :func:`tc_layout` lays it out, the bf16 weight
    fragments (inputs padded to 16, hidden outputs to 32, the logits to
    16) all "resident" in shared memory (measured faster, PERF.md) or all
    "streamed" from L2, which leaves the shared memory to the tiles.
    Returns the route, ``envs``, ``blocks``, ``smem`` bytes and, for the
    tensor cores, ``blocks_per_sm``, ``weights``, ``frag_bytes``, ``ld``
    and ``t_bytes``."""
    check_compute_dtype(compute_dtype)
    hiddens = [tuple(int(h) for h in hs) for hs in hiddens]
    f = env_core.obs_size(params)
    g5 = params.players_per_team * 2 * N_CHOICES
    if compute_dtype == torch.float32:
        # (fused_collect's value head joins its logits: g5 + 1 rounds up
        # as g5 does)
        rows = max(f, *(round_up(h, CHUNK) for hs in hiddens for h in (*hs, g5)))
        return dict(route="cuda_cores", envs=32, blocks=-(-n_envs // 32),
                    smem=2 * rows * 32 * 4)
    units = 0
    for hs in hiddens:
        kps = [*tc_inputs(params, hs), round_up(g5, 16)]
        units += sum(k * n for k, n in zip(kps, kps[1:])) // 8
    plan = tc_layout(n_envs, *tc_tiles(params, hiddens), units)
    del plan["n_res"]
    return plan


def tc_plan_ints(plan: dict):
    """The plan as K2's and K4's C interface takes it: envs, resident,
    the tiles' bytes and row strides."""
    return (ctypes.c_int * 6)(plan["envs"], plan["weights"] == "resident",
                              *plan["t_bytes"], *plan["ld"])


def tc_fragments(w: torch.Tensor, kp: int, np_: int) -> torch.Tensor:
    """``w`` ``[in, out]`` zero-padded to ``[kp, np_]`` (multiples of 16),
    rounded to bf16, in mma.sync's B-fragment order: for k-step kk and
    output pair jj, lane g * 4 + t holds 8 values, (W[k][16 jj + g],
    W[k + 1][16 jj + g], W[k + 8][16 jj + g], W[k + 9][16 jj + g]) with k
    = 16 kk + 2 t, then the same for output 16 jj + 8 + g. Flat bf16."""
    wp = w.new_zeros((kp, np_))
    wp[:w.shape[0], :w.shape[1]] = w
    # (kk, khalf, t, pair, jj, nhalf, g) -> (kk, jj, g, t, nhalf, khalf, pair)
    return (wp.to(torch.bfloat16).reshape(kp // 16, 2, 4, 2, np_ // 16, 2, 8)
            .permute(0, 4, 6, 2, 5, 1, 3).reshape(-1))


def padded(v: torch.Tensor, n: int) -> torch.Tensor:
    """``v`` flat, zero-padded to ``n`` values."""
    return torch.cat([v.reshape(-1), v.new_zeros(n - v.numel())])


def tc_torso(layers, kp: int, pads, w_off: int = 0, b_off: int = 0):
    """The torso packer: dense layers ``(W, b)`` chained from input width
    ``kp``, layer i's outputs padded to a multiple of ``pads[i]``, placed
    from ``w_off`` (16-byte units) in the fragments and ``b_off`` in the
    f32 vector. Returns (their fragments, padded biases, rows (kp, np,
    w_off, b_off) of the kernels' layer table, w_off and b_off after)."""
    frags, fvec, table = [], [], []
    for (w, b), pad in zip(layers, pads):
        np_ = round_up(w.shape[1], pad)
        frags.append(tc_fragments(w, kp, np_))
        fvec.append(padded(b, np_))
        table += [kp, np_, w_off, b_off]
        w_off, b_off, kp = w_off + kp * np_ // 8, b_off + np_, np_
    return frags, fvec, table, w_off, b_off


def tc_buffers(frags: list, fvec: list) -> tuple[torch.Tensor, torch.Tensor]:
    """The fragments and f32 vectors joined into the two weight buffers."""
    flat, fv = torch.cat(frags), torch.cat(fvec)
    if flat.data_ptr() % 16 or fv.data_ptr() % 16:
        raise ValueError("the weight buffers must be 16-byte aligned")
    return flat, fv


def tc_pack(mlps: list, params: EnvParams):
    """The MLPs ``[(layers [(W, b), ...], value (Wv, bv) or None), ...]``
    as K2's and K4's tensor-core kernels take them: (bf16 fragments of
    every layer, flat; f32 vector of the padded biases and value heads;
    per MLP its ctypes layer table [n_layers, 4] of (kp, np, w_off in
    16-byte units, b_off) and its value head's offset, or -1)."""
    frags, fvec, tables, wv_offs = [], [], [], []
    w_off = b_off = 0
    k0 = round_up(env_core.obs_size(params), 16)
    for layers, value in mlps:
        f, v, table, w_off, b_off = tc_torso(
            layers, k0, [TC_CHUNK] * (len(layers) - 1) + [16], w_off, b_off)
        frags, fvec = frags + f, fvec + v
        wv_offs.append(-1 if value is None else b_off)
        if value is not None:            # W_v padded to the torso's width, b_v, a pad
            wv, bv = value
            fvec += [wv.reshape(-1), wv.new_zeros(table[-4] - wv.shape[0]),
                     bv.reshape(1), bv.new_zeros(1)]
            b_off += table[-4] + 2
        tables.append((ctypes.c_int * len(table))(*table))
    return (*tc_buffers(frags, fvec), tables, wv_offs)


def recurrent_gate_order(hsize: int) -> torch.Tensor:
    """The LSTM cell's columns on the tensor cores (K5's kernel, K6's
    forward): entry ``n`` of the ``[4 hp]`` result (hp = H rounded up to
    16) is the JAX-layout column (gate g at ``g * H + u``) that the
    kernel's column ``n`` holds, or -1 for a padded unit's. Column ``64 q
    + 16 j + 8 h + 2 t + e`` is gate ``2 h + e`` (i, f, g, o) of unit ``16
    q + 8 (j // 2) + 2 t + j % 2``: the mma C fragment of lane (g, t) over
    n16 chunk j of group q holds its unit's four gates, and over the
    group's four chunks the lane's units 2t, 2t+1, 8+2t, 9+2t are the
    heads' A fragment of k-step q."""
    hp = round_up(hsize, 16)
    n = torch.arange(4 * hp)
    q, j, h, t, e = n // 64, n // 16 % 4, n // 8 % 2, n // 2 % 4, n % 2
    u = 16 * q + 8 * (j // 2) + 2 * t + j % 2
    return torch.where(u < hsize, (2 * h + e) * hsize + u, -1)


# ---------------------------------------------------------------------------
# Launches
# ---------------------------------------------------------------------------


def policy_args(params: EnvParams, uniforms, seed: int, b: int, n_steps: int,
                c_consts, stream, *dims):
    """The arguments every policy kernel's entry ends with: the uniforms
    table or NULL, the Philox seed, the env's (:func:`step_args`, with
    ``dims`` after T), the observation scales and the stream."""
    return (None if uniforms is None else uniforms.data_ptr(), seed & 0xFFFFFFFF,
            *step_args(params, b, n_steps, c_consts, *dims),
            (ctypes.c_float * 3)(*obs_scales(params)), stream)


def collect_outputs(params: EnvParams, statef, n_steps: int, uniforms, seed: int,
                    c_consts, stream):
    """K2's and K5's outputs, empty: (obs ``[2, F_pad, T, B]``, dirs,
    acts, logp, value, reward, done ``[T, 2, B]``, last_value ``[2,
    B]``), and their entries' arguments from obs to the stream."""
    b, f_pad = statef.shape[1], feature_rows(params)

    def out(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=statef.device)

    obs = out(2, f_pad, n_steps, b)
    dirs, acts, done = (out(n_steps, 2, b, dtype=torch.int32) for _ in range(3))
    logp, value, reward = (out(n_steps, 2, b) for _ in range(3))
    outs = (obs, dirs, acts, logp, value, reward, done, out(2, b))
    return outs, (*(t.data_ptr() for t in outs),
                  *policy_args(params, uniforms, seed, b, n_steps, c_consts,
                               stream, f_pad))
