"""One PPO minibatch gradient: the CUDA kernels' wrapper and its plain
PyTorch version.

Counterpart of :mod:`gym_futbol_tpu.ops.fused_update`. For a minibatch
of ``mb_blocks`` sample blocks, chosen by the block indices ``idx`` out
of the feature-major buffer, it runs the actor-critic forward (tanh
torso, logits head, value head), the clipped surrogate, the clipped
value loss and the entropy bonus, and the hand-written backward pass:

  d loss / d logp   = -inv_M * adv_n * ratio * pick,
                      pick = 1[pg1 <= pg2] or 1[|ratio - 1| <= eps]
  d loss / d logits = dlogp * (onehot(a) - p) + inv_M*ent_coef*p*(logp + H)
  d loss / d value  = inv_M * vf_coef * (e1 if e1^2 >= e2^2 else
                      e2 * 1[|v - v_old| <= eps]),  e = v* - ret

``adv_n`` arrives gathered and normalised per minibatch; the 1/M loss
scale is inside the gradients and the four metrics are sums. On a CUDA
tensor :func:`fused_minibatch_grad` runs the kernels of
``csrc/fused_update.cu`` on the route :func:`update_plan` names: in
bfloat16 the tensor-core kernels (torsos of one or two layers up to
:data:`TC_MAX_WIDTH` wide), otherwise the chain of CUDA-core kernels; on
a CPU tensor it runs the plain version
:func:`fused_minibatch_grad_reference`.

Precision, as the JAX kernel rounds: with ``compute_dtype`` bfloat16,
every operand of a layer product (the obs, each activation, each weight
matrix, ``dlogits`` and each ``dz``) is rounded to bfloat16 and the
products are summed in float32; the value head's products and every
elementwise step stay float32, tanh' uses the float32 activation. With
float32 the products are true float32 (the plain version's matrix
products need ``torch.backends.cuda.matmul.allow_tf32 = False`` on a
card).

Weight layout is :func:`gym_futbol_tpu_torch.ops.fused_collect.flatten_actor_critic`'s:
``(W1, b1, ..., Wt, bt, Wl, bl, Wv, bv)``, ``W`` ``[in, out]``, ``b``
``[out, 1]``; the gradients come back in the same shapes.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.policy import N_CHOICES
from .fused_rollout import LAUNCHES, _raise_on_error

METRICS = ("pg_loss", "v_loss", "entropy", "approx_kl")
_LANE = 128
# Samples per partial sum of the kernels' reductions over the minibatch
# (a fixed split, then one pass in fixed order: the result does not
# change from run to run).
CHUNK = 4096
# Samples per block of the kernels' loss pass: one metric partial each.
_LOSS_THREADS = 256
_GROUPS = (2, 4, 6, 8, 10)   # action groups the loss kernel is built for
# Shared memory a block may use (H100): the CUDA-core loss kernel keeps
# both heads' weights there, [H, G*5 + 1] float32; the tensor-core forward
# every weight in bf16.
_SMEM_BYTES = 232448
# The tensor-core kernels: samples per tile (and the multiple the torso
# widths are padded to), first-layer units per backward block, the widest
# torso layer they take, warps per forward block.
TC_TILE = 64
TC_SLAB = 64
TC_MAX_WIDTH = 256
TC_FWD_WARPS = 16


def _check(weights, obs_fm, dirs_blk, acts_blk, logp_blk, value_blk, ret_blk,
           adv_n, idx, n_torso: int, block: int) -> None:
    n_w = 2 * (n_torso + 2)
    if n_torso < 1 or len(weights) != n_w:
        raise ValueError(f"weights: a torso of n_torso={n_torso} >= 1 layers "
                         f"and both heads, {n_w} tensors")
    if obs_fm.dim() != 2 or obs_fm.dtype != torch.float32:
        raise ValueError("obs_fm must be float32 [F_pad, N]")
    f_dim, n = obs_fm.shape
    if block % _LANE or n % block:
        raise ValueError(f"block must be a multiple of {_LANE} dividing N={n}")
    if f_dim % 8:
        raise ValueError(f"obs rows {f_dim} must be padded to a multiple of 8")
    n_blocks = n // block
    prev = None
    for li in range(n_torso + 2):
        w, b = weights[2 * li], weights[2 * li + 1]
        if w.dtype != torch.float32 or b.dtype != torch.float32:
            raise TypeError("weights must be float32")
        # each torso layer reads the one before; both heads read the last
        if w.dim() != 2 or tuple(b.shape) != (w.shape[1], 1) or (
                li > 0 and w.shape[0] != prev):
            raise ValueError(f"weights: layer {li} must be W [in, out], "
                             f"b [out, 1]; got {tuple(w.shape)}, {tuple(b.shape)}")
        if li < n_torso:
            prev = w.shape[1]
    if weights[0].shape[0] > f_dim:
        raise ValueError("W1 has more rows than the obs matrix")
    g5 = weights[2 * n_torso].shape[1]
    if g5 % N_CHOICES or weights[-2].shape[1] != 1:
        raise ValueError("the heads must be logits [H, G*5] and value [H, 1]")
    for name, t, dt in (("dirs_blk", dirs_blk, torch.int32),
                        ("acts_blk", acts_blk, torch.int32),
                        ("logp_blk", logp_blk, torch.float32),
                        ("value_blk", value_blk, torch.float32),
                        ("ret_blk", ret_blk, torch.float32)):
        if tuple(t.shape) != (n_blocks, block) or t.dtype != dt:
            raise ValueError(f"{name} must be {dt} [{n_blocks}, {block}]")
    mb_blocks = idx.shape[0]
    if idx.dim() != 1 or idx.dtype != torch.int32 or not 0 < mb_blocks <= n_blocks:
        raise ValueError(f"idx must be int32 [mb_blocks], 0 < mb_blocks <= "
                         f"{n_blocks}")
    if tuple(adv_n.shape) != (mb_blocks, block) or adv_n.dtype != torch.float32:
        raise ValueError(f"adv_n must be float32 [{mb_blocks}, {block}]")
    dev = obs_fm.device
    if any(t.device != dev for t in (*weights, dirs_blk, acts_blk, logp_blk,
                                      value_blk, ret_blk, adv_n, idx)):
        raise ValueError("every input must be on obs_fm's device")


def _pad_first_layer(weights: tuple, f_dim: int) -> list:
    """W1 padded with zero rows to the obs matrix's F_pad rows (exact:
    the pad rows of the obs are zero too)."""
    w = list(weights)
    if w[0].shape[0] != f_dim:
        w[0] = torch.cat([w[0], w[0].new_zeros(f_dim - w[0].shape[0],
                                               w[0].shape[1])])
    return w


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def fused_minibatch_grad_reference(
    weights: tuple, obs_fm: torch.Tensor, dirs_blk: torch.Tensor,
    acts_blk: torch.Tensor, logp_blk: torch.Tensor, value_blk: torch.Tensor,
    ret_blk: torch.Tensor, adv_n: torch.Tensor, idx: torch.Tensor, *,
    n_torso: int, clip_eps: float, vf_coef: float, ent_coef: float,
    block: int, compute_dtype=torch.bfloat16, per_sample: bool = False,
):
    """The kernels' computation as torch ops on the gathered minibatch:
    the same rounding points, products summed in float32 by matrix
    products. Same arguments and results as :func:`fused_minibatch_grad`.

    With ``per_sample`` the metrics come back as the per-sample terms
    ``[M]`` whose sums they are, beside ``pg_clip`` and ``v_clip``: 1.0
    where the surrogate's or the value loss's clip zeroes the sample's
    gradient, else 0.0."""
    _check(weights, obs_fm, dirs_blk, acts_blk, logp_blk, value_blk, ret_blk,
           adv_n, idx, n_torso, block)
    f32 = torch.float32
    f_dim, n = obs_fm.shape
    if int(idx.min()) < 0 or int(idx.max()) >= n // block:
        raise ValueError(f"idx holds a block index outside [0, {n // block})")
    f_w = weights[0].shape[0]
    w = _pad_first_layer(weights, f_dim)
    sel = idx.long()
    m = sel.shape[0] * block
    x = obs_fm.reshape(f_dim, n // block, block)[:, sel].reshape(f_dim, m)

    def rows(a):
        return a[sel].reshape(m)

    dirs, acts = rows(dirs_blk), rows(acts_blk)
    logp_old, value_old, ret = rows(logp_blk), rows(value_blk), rows(ret_blk)
    adv = adv_n.reshape(m)

    def rnd(a):
        return a if compute_dtype == f32 else a.to(compute_dtype).to(f32)

    def dot(a, b):
        return rnd(a) @ rnd(b)

    # constants rounded to float32 once, as the kernels take them
    inv_m = 1.0 / float(m)

    def const(v):
        return torch.tensor(v, dtype=f32, device=obs_fm.device)

    one, eps, c_pg = const(1.0), const(clip_eps), const(inv_m)
    c_v, c_ent = const(vf_coef * inv_m), const(ent_coef * inv_m)
    lo, hi = one - eps, one + eps

    hs = [x]
    for li in range(n_torso):
        hs.append(torch.tanh(dot(w[2 * li].T, hs[-1]) + w[2 * li + 1]))
    h_last = hs[-1]
    wl, bl, wv, bv = w[-4:]
    logits = dot(wl.T, h_last) + bl
    value = (wv.T @ h_last + bv)[0]

    groups = []
    logp_total = ent_total = None
    for g in range(logits.shape[0] // N_CHOICES):
        r = [logits[g * N_CHOICES + k] for k in range(N_CHOICES)]
        mx = r[0]
        for rk in r[1:]:
            mx = torch.maximum(mx, rk)
        exps = [torch.exp(rk - mx) for rk in r]
        z = exps[0]
        for e in exps[1:]:
            z = z + e
        inv_z = one / z
        logz = torch.log(z)
        lp = [rk - mx - logz for rk in r]
        p = [e * inv_z for e in exps]
        packed = dirs if g % 2 == 0 else acts
        a = (packed >> (3 * (g // 2))) & 7
        taken, ent = lp[0], -p[0] * lp[0]
        for k in range(1, N_CHOICES):
            taken = torch.where(a == k, lp[k], taken)
            ent = ent - p[k] * lp[k]
        groups.append((lp, p, a))
        logp_total = taken if logp_total is None else logp_total + taken
        ent_total = ent if ent_total is None else ent_total + ent

    ratio = torch.exp(logp_total - logp_old)
    pg1 = ratio * adv
    pg2 = torch.clamp(ratio, lo, hi) * adv
    pg_vec = -torch.minimum(pg1, pg2)
    inclip = ((ratio >= lo) & (ratio <= hi)).to(f32)
    pick = torch.where(pg1 <= pg2, one, inclip)
    dlogp = -c_pg * adv * ratio * pick

    dv_raw = value - value_old
    v_clipped = value_old + torch.clamp(dv_raw, -eps, eps)
    e1, e2 = value - ret, v_clipped - ret
    v_vec = 0.5 * torch.maximum(e1 * e1, e2 * e2)
    inclip_v = ((dv_raw >= -eps) & (dv_raw <= eps)).to(f32)
    dvalue = c_v * torch.where(e1 * e1 >= e2 * e2, e1, e2 * inclip_v)

    dl_rows = []
    for lp, p, a in groups:
        h_g = torch.zeros_like(ent_total)
        for k in range(N_CHOICES):
            h_g = h_g - p[k] * lp[k]
        for k in range(N_CHOICES):
            onehot = (a == k).to(f32)
            dl_rows.append(dlogp * (onehot - p[k]) + c_ent * p[k] * (lp[k] + h_g))
    dlogits = torch.stack(dl_rows)
    dvalue2 = dvalue[None]

    grads = [None] * len(w)
    dh = dot(wl, dlogits) + wv @ dvalue2
    grads[2 * n_torso] = dot(h_last, dlogits.T)
    grads[2 * n_torso + 1] = dlogits.sum(1, keepdim=True)
    grads[2 * n_torso + 2] = h_last @ dvalue2.T
    grads[2 * n_torso + 3] = dvalue2.sum(1, keepdim=True)
    for li in range(n_torso - 1, -1, -1):
        h = hs[li + 1]
        dz = dh * (one - h * h)
        grads[2 * li] = dot(hs[li], dz.T)
        grads[2 * li + 1] = dz.sum(1, keepdim=True)
        if li > 0:
            dh = dot(w[2 * li], dz)
    grads[0] = grads[0][:f_w]
    terms = dict(zip(METRICS, (pg_vec, v_vec, ent_total,
                               (ratio - one) - (logp_total - logp_old))))
    if per_sample:
        terms["pg_clip"] = (pick == 0).to(f32)
        terms["v_clip"] = ((e1 * e1 < e2 * e2) & (inclip_v == 0)).to(f32)
        return tuple(grads), terms
    return tuple(grads), {k: v.sum() for k, v in terms.items()}


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def update_plan(f_dim: int, widths, g5: int, m: int,
                compute_dtype=torch.bfloat16) -> dict:
    """How :func:`fused_minibatch_grad` runs a minibatch of ``m`` samples
    with ``f_dim`` obs rows, torso ``widths`` and a ``g5``-wide logits
    head, without a card: the route and, for the tensor cores, the padded
    sizes, shared memory, grids and buffer sizes of ``csrc/fused_update.cu``
    (``fwd_smem``, ``bwd_smem``, ``FwdLayout``, ``BwdLayout``).

    bfloat16 with one or two torso layers of at most :data:`TC_MAX_WIDTH`
    units whose forward block fits in shared memory takes the tensor-core
    kernels ("tensor_cores"); float32, and bfloat16 beyond those limits,
    the chain of CUDA-core kernels ("cuda_cores"). Raises ValueError for a
    minibatch neither takes."""
    widths = [int(h) for h in widths]
    g = g5 // N_CHOICES
    if g5 % N_CHOICES or g not in _GROUPS:
        raise ValueError(f"the loss kernels take {_GROUPS} action groups")
    if not widths or m % _LANE:
        raise ValueError(f"a torso of >= 1 layers and a multiple of {_LANE} "
                         "samples")
    n_chunks = -(-m // CHUNK)
    plan = dict(route="cuda_cores", n_chunks=n_chunks)
    f1p = _round_up(f_dim, 16)
    padded = [_round_up(h, TC_TILE) for h in widths]
    g5p = _round_up(g5, 16)
    hp = padded[-1]
    two = len(widths) == 2
    h1p, h2p = padded[0], padded[1] if two else 0
    halves = (f1p * h1p + (h1p * h2p if two else 0) + hp * (g5p + 8)
              + f1p * TC_TILE + max(h1p, h2p) * TC_TILE + g5p * TC_TILE)
    floats = (g5p * TC_TILE + h1p + h2p + g5p + hp + TC_FWD_WARPS * TC_TILE
              + 8 * TC_TILE + 2 * g * TC_TILE)
    smem_fwd = 2 * halves + 4 * floats
    if (compute_dtype == torch.bfloat16 and len(widths) <= 2
            and max(widths) <= TC_MAX_WIDTH and f1p <= 64
            and smem_fwd <= _SMEM_BYTES):
        e_fwd = hp * g5p + g5p + 2 * hp + 8
        e_bwd = f1p * h1p + (h1p + h1p * h2p if two else 0)
        # two (obs, dz) buffers; two-layer torsos: W2's and W1's slab, h1
        # and dz1 tiles
        smem_bwd = 2 * (2 * f1p * TC_TILE + (
            2 * h2p * TC_TILE + TC_SLAB * h2p + f1p * TC_SLAB
            + 2 * TC_SLAB * TC_TILE if two else 2 * TC_SLAB * TC_TILE)
        ) + 4 * (TC_SLAB + 8 * 16)
        plan.update(
            route="tensor_cores", f1p=f1p, h1p=h1p, h2p=h2p, hp=hp, g5p=g5p,
            smem_fwd=smem_fwd, smem_bwd=smem_bwd,
            fwd_blocks=n_chunks, bwd_blocks=n_chunks * (h1p // TC_SLAB),
            tiles_per_chunk=CHUNK // TC_TILE, e_fwd=e_fwd, e_bwd=e_bwd,
            partial_floats=n_chunks * (e_fwd + e_bwd), dz_shape=(hp, m),
            xb_shape=(f1p, m),
            # offsets in the forward and backward sums
            fwd_offsets=dict(dwl=0, dbl=hp * g5p, dwv=hp * g5p + g5p,
                             dbv=hp * g5p + g5p + hp,
                             db=hp * g5p + g5p + hp + 4,
                             met=hp * g5p + g5p + 2 * hp + 4),
            bwd_offsets=dict(dw1=0, db1=f1p * h1p, dw2=f1p * h1p + h1p))
        return plan
    if widths[-1] * (g5 + 1) * 4 > _SMEM_BYTES:
        raise ValueError(f"the last torso layer ({widths[-1]} wide) and the "
                         f"heads do not fit the loss kernel's shared memory")
    dims = [f_dim, *widths]
    part = max([dims[i] * dims[i + 1] for i in range(len(dims) - 1)]
               + [dims[-1] * g5, dims[-1]])
    plan.update(partial_floats=max(n_chunks * part,
                                   -(-m // _LOSS_THREADS) * 4))
    return plan


def padded_weights(weights, n_torso: int, plan: dict) -> dict:
    """The weights as the tensor-core kernels take them, float32 and
    zero-padded to ``plan``'s sizes: ``w1`` [f1p, h1p], ``b1`` [h1p],
    ``w2`` [h1p, h2p], ``b2`` [h2p] (two-layer torsos), ``wl`` [hp, g5p],
    ``bl`` [g5p], ``wv`` [hp], ``bv`` [1]. Exact: a pad unit's
    activation is tanh(0) = 0 and its outgoing weights are zero, so its
    dz is zero; a pad logit row has zero weights, so its dlogits row is
    never read (the kernels write zero there)."""
    f1p, h1p, h2p, hp, g5p = (plan[k] for k in ("f1p", "h1p", "h2p", "hp", "g5p"))

    def pad(t, *shape):
        out = t.new_zeros(shape)
        out[tuple(slice(0, n) for n in t.shape)] = t
        return out

    out = dict(w1=pad(weights[0], f1p, h1p), b1=pad(weights[1][:, 0], h1p))
    if n_torso == 2:
        out.update(w2=pad(weights[2], h1p, h2p), b2=pad(weights[3][:, 0], h2p))
    wl, bl, wv, bv = weights[-4:]
    out.update(wl=pad(wl, hp, g5p), bl=pad(bl[:, 0], g5p), wv=pad(wv[:, 0], hp),
               bv=bv.reshape(1))
    return out


def _run_tensor_cores(weights, obs_fm, rows, adv_n, idx, n_torso, block,
                      coefs, plan):
    """The tensor-core kernels on one minibatch: pads and rounds the
    weights, launches ``futbol_fused_update_tc`` and cuts the padded sums
    back to the weights' shapes. Returns (grads, metrics [4])."""
    from . import _build

    if any(t.data_ptr() % 16 for t in (obs_fm, adv_n, *rows)):
        raise ValueError("the tensor-core kernels copy the obs and the per-sample "
                         "rows 16 bytes at a time: each must start on a 16-byte "
                         "boundary")
    dev = obs_fm.device
    f32 = torch.float32
    f1p, h1p, h2p, hp, g5p = (plan[k] for k in ("f1p", "h1p", "h2p", "hp", "g5p"))
    pw = padded_weights(weights, n_torso, plan)
    w1, wl_p = pw["w1"].to(torch.bfloat16), pw["wl"].to(torch.bfloat16)
    w2 = pw["w2"].to(torch.bfloat16) if n_torso == 2 else w1
    b1, b2 = pw["b1"], pw.get("b2", pw["b1"])
    bl_p, wv_p, bv = pw["bl"], pw["wv"], pw["bv"]
    wl = weights[-4]
    dz = torch.empty(plan["dz_shape"], dtype=torch.bfloat16, device=dev)
    xb = torch.empty(plan["xb_shape"], dtype=torch.bfloat16, device=dev)
    n_chunks, e_fwd, e_bwd = plan["n_chunks"], plan["e_fwd"], plan["e_bwd"]
    part_fwd = torch.empty(n_chunks * e_fwd, dtype=f32, device=dev)
    part_bwd = torch.empty(n_chunks * e_bwd, dtype=f32, device=dev)
    out_fwd = torch.empty(e_fwd, dtype=f32, device=dev)
    out_bwd = torch.empty(e_bwd, dtype=f32, device=dev)
    lib = _build.load()
    err = lib.futbol_fused_update_tc(
        w1.data_ptr(), w2.data_ptr(), wl_p.data_ptr(), b1.data_ptr(),
        b2.data_ptr(), bl_p.data_ptr(), wv_p.data_ptr(), bv.data_ptr(),
        obs_fm.shape[0], f1p, h1p, h2p, wl.shape[1] // N_CHOICES,
        obs_fm.data_ptr(), obs_fm.shape[1], idx.data_ptr(), idx.shape[0], block,
        *(r.data_ptr() for r in rows), adv_n.data_ptr(), *coefs,
        dz.data_ptr(), xb.data_ptr(), part_fwd.data_ptr(), part_bwd.data_ptr(),
        CHUNK, out_fwd.data_ptr(), out_bwd.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on_error(err, "fused_minibatch_grad")
    fo, bo = plan["fwd_offsets"], plan["bwd_offsets"]
    widths = [weights[2 * li].shape[1] for li in range(n_torso)]
    h, g5 = widths[-1], wl.shape[1]
    grads = [None] * len(weights)
    grads[0] = out_bwd[:f1p * h1p].view(f1p, h1p)[:weights[0].shape[0],
                                                  :widths[0]]
    if n_torso == 2:
        grads[1] = out_bwd[bo["db1"]:bo["db1"] + widths[0]].view(-1, 1)
        grads[2] = out_bwd[bo["dw2"]:].view(h1p, h2p)[:widths[0], :widths[1]]
    grads[2 * n_torso - 1] = out_fwd[fo["db"]:fo["db"] + h].view(-1, 1)
    grads[2 * n_torso] = out_fwd[:hp * g5p].view(hp, g5p)[:h, :g5]
    grads[2 * n_torso + 1] = out_fwd[fo["dbl"]:fo["dbl"] + g5].view(-1, 1)
    grads[2 * n_torso + 2] = out_fwd[fo["dwv"]:fo["dwv"] + h].view(-1, 1)
    grads[2 * n_torso + 3] = out_fwd[fo["dbv"]:fo["dbv"] + 1].view(1, 1)
    return (tuple(g.contiguous() for g in grads),
            out_fwd[fo["met"]:fo["met"] + 4])


def _workspace(dev, dims: list, g5: int, m: int, partial_floats: int) -> dict:
    """The CUDA-core chain's buffers for one call: each torso layer's
    activations [width, M], dz, dlogits, dvalue and the partial sums (per
    chunk, each layer's [in, out] weight gradient or a row sum; per loss
    block, 4 metrics). They come from PyTorch's caching allocator, which
    hands the same blocks back on the next call of the same shape
    (stream-ordered, so a later call's buffers never overlap a running
    launch); so do the tensor-core kernels' buffers."""
    def buf(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    return dict(acts=[buf(h, m) for h in dims[1:]], dz=buf(dims[-1], m),
                dlogits=buf(g5, m), dvalue=buf(m), partial=buf(partial_floats))


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def fused_minibatch_grad(
    weights: tuple, obs_fm: torch.Tensor, dirs_blk: torch.Tensor,
    acts_blk: torch.Tensor, logp_blk: torch.Tensor, value_blk: torch.Tensor,
    ret_blk: torch.Tensor, adv_n: torch.Tensor, idx: torch.Tensor, *,
    n_torso: int, clip_eps: float, vf_coef: float, ent_coef: float,
    block: int, compute_dtype=torch.bfloat16,
):
    """One PPO minibatch gradient and its metric sums (module docstring).

    ``obs_fm`` f32 ``[F_pad, N]`` feature-major, N in blocks of
    ``block`` samples; ``dirs_blk``/``acts_blk`` i32 and ``logp_blk``,
    ``value_blk``, ``ret_blk`` f32 ``[n_blocks, block]``; ``adv_n`` f32
    ``[mb_blocks, block]``, normalised and gathered; ``idx`` i32
    ``[mb_blocks]`` block indices, each in ``[0, n_blocks)``: the plain
    version checks that, the kernels read what they are given (a check
    would synchronise with the card on every call; callers such as
    :func:`ppo.update_epochs_fused` check a permutation once). Returns
    (grads in the weights' shapes and order, ``{metric: sum}`` over
    :data:`METRICS`).
    """
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("compute_dtype must be torch.bfloat16 or torch.float32")
    if obs_fm.device.type == "cpu":
        return fused_minibatch_grad_reference(
            weights, obs_fm, dirs_blk, acts_blk, logp_blk, value_blk, ret_blk,
            adv_n, idx, n_torso=n_torso, clip_eps=clip_eps, vf_coef=vf_coef,
            ent_coef=ent_coef, block=block, compute_dtype=compute_dtype)
    _check(weights, obs_fm, dirs_blk, acts_blk, logp_blk, value_blk, ret_blk,
           adv_n, idx, n_torso, block)
    if obs_fm.device.type != "cuda":
        raise ValueError(f"the kernels need CUDA tensors, got {obs_fm.device}")
    inputs = (obs_fm, dirs_blk, acts_blk, logp_blk, value_blk, ret_blk, adv_n,
              idx, *weights)
    if not all(t.is_contiguous() for t in inputs):
        raise ValueError("every input must be contiguous")
    f_dim, n = obs_fm.shape
    f_w = weights[0].shape[0]
    g5 = weights[2 * n_torso].shape[1]
    widths = [weights[2 * li].shape[1] for li in range(n_torso)]
    m = idx.shape[0] * block
    plan = update_plan(f_dim, widths, g5, m, compute_dtype)
    inv_m = 1.0 / float(m)
    coefs = (clip_eps, inv_m, vf_coef * inv_m, ent_coef * inv_m)
    rows = (dirs_blk, acts_blk, logp_blk, value_blk, ret_blk)
    if plan["route"] == "tensor_cores":
        grads, metrics = _run_tensor_cores(weights, obs_fm, rows, adv_n, idx,
                                           n_torso, block, coefs, plan)
        LAUNCHES["fused_minibatch_grad"] += 1
        return grads, dict(zip(METRICS, metrics.unbind()))
    w = _pad_first_layer(weights, f_dim)
    dims = [f_dim, *widths]
    dev = obs_fm.device
    ws = _workspace(dev, dims, g5, m, plan["partial_floats"])
    grads = [torch.empty_like(t) for t in weights]
    metrics = torch.empty(4, dtype=torch.float32, device=dev)
    from . import _build

    lib = _build.load()
    err = lib.futbol_fused_update(
        _ptrs(w), _ptrs(grads), (ctypes.c_int * len(dims))(*dims), n_torso,
        f_w, g5, obs_fm.data_ptr(), n, idx.data_ptr(), idx.shape[0], block,
        *(r.data_ptr() for r in rows), adv_n.data_ptr(), *coefs,
        int(compute_dtype == torch.bfloat16), _ptrs(ws["acts"]),
        ws["dz"].data_ptr(), ws["dlogits"].data_ptr(), ws["dvalue"].data_ptr(),
        ws["partial"].data_ptr(), ws["partial"].numel(), CHUNK,
        metrics.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on_error(err, "fused_minibatch_grad")
    LAUNCHES["fused_minibatch_grad"] += 1
    return tuple(grads), dict(zip(METRICS, metrics.unbind()))


def unflatten_actor_critic(grads: tuple, model) -> None:
    """Write flat kernel-order gradients (``dW`` ``[in, out]``, ``db``
    ``[out, 1]``) into the ``.grad`` of ``model``'s layers (``nn.Linear``
    weights are ``[out, in]``): the inverse of ``flatten_actor_critic``."""
    layers = model.dense_layers()
    if len(grads) != 2 * len(layers):
        raise ValueError(f"{len(grads)} gradients for {len(layers)} layers")
    for layer, dw, db in zip(layers, grads[::2], grads[1::2]):
        layer.weight.grad = dw.t().contiguous()
        layer.bias.grad = db.reshape(-1).clone()
