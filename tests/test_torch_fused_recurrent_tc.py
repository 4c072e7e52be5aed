"""The bfloat16 route of the recurrent collect (K5
``fused_recurrent_collect``, ``csrc/fused_recurrent_tc.cu``): the plain
version's bf16 rows against JAX, the tensor-core kernel's gate order,
weight fragments and cell loop read back as the kernel's lanes read them,
the layout plan, and the wrapper's CPU path in both modes.

On its chip the JAX kernel's f32 ``dot_general`` runs as one bf16 pass
(default precision): both operands rounded to bf16, the products summed
in f32; the value head ``[H, 1]`` is a degenerate dot, exact f32. Here
JAX on the CPU (its ``_lstm_cell`` and heads) is fed the bf16-rounded
operands at ``HIGHEST`` precision, which is that computation, stage by
stage from the port's own inputs to the stage (the torso, the cell, the
heads), so that a one-ulp bf16 flip of an earlier stage's output cannot
reach a later one. Tolerances, with their reasons: rows rtol 1e-5 / atol
2e-5 (f32 sums in another order than XLA's, XLA's sigmoid and tanh
against torch's in the last f32 bit); the fragment layout and gate order
exact; the kernel's cell loop emulated from the packed buffers, summing
in the plain version's order, equal to the plain bf16 forward exactly.
"""

import importlib

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gym_futbol_tpu import EnvParams as JEnvParams  # noqa: E402
from gym_futbol_tpu import RewardConfig as JRewardConfig  # noqa: E402
from gym_futbol_tpu_torch import a2c as ta2c  # noqa: E402
from gym_futbol_tpu_torch import obs_size, ops, vector  # noqa: E402
from gym_futbol_tpu_torch.interop import params_from_reference  # noqa: E402
from gym_futbol_tpu_torch.models.recurrent import RecurrentActorCritic  # noqa: E402
from gym_futbol_tpu_torch.ops import _build  # noqa: E402

from _torch_cases import custom_params, game_states  # noqa: E402

jfa = importlib.import_module("gym_futbol_tpu.ops.fused_actor")
jfr = importlib.import_module("gym_futbol_tpu.ops.fused_recurrent")
tfr = importlib.import_module("gym_futbol_tpu_torch.ops.fused_recurrent")
tpol = importlib.import_module("gym_futbol_tpu_torch.ops._policy")

B = 96
BF16, F32 = torch.bfloat16, torch.float32
ROWS_TOL = dict(rtol=1e-5, atol=2e-5)


def _rnd(a):
    return jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)


def _jax_dense(x, w, b, rounded):
    """The TPU's layer product: bf16-rounded operands (``rounded``), f32
    sums, then the bias."""
    def r(a):
        return _rnd(a) if rounded else jnp.asarray(a)

    return jax.lax.dot_general(
        r(w), r(x), (((0,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32) + jnp.asarray(b)


def _jax_obs(ref, rng, mirror):
    pos, vel, poss, _, _ = game_states(rng, ref, B)
    n = ref.n_bodies
    rows = [[jnp.asarray(pos[:, i, c]) for i in range(n)] for c in (0, 1)] + \
        [[jnp.asarray(vel[:, i, c]) for i in range(n)] for c in (0, 1)]
    return np.array(jfa._obs_matrix(*rows, jnp.asarray(poss), ref, mirror, B))


def _recurrent_weights(rng, f, hidden, hs, g5):
    """A flat recurrent tuple (numpy) with non-zero biases:
    torso, Wi, Wh, bh, Wl, bl, Wv, bv."""
    out, prev = [], f
    for h in hidden:
        out += [(rng.normal(0.0, 1.0, (prev, h)) / np.sqrt(prev)).astype(np.float32),
                rng.normal(0.0, 0.1, (h, 1)).astype(np.float32)]
        prev = h
    for shape in ((prev, 4 * hs), (hs, 4 * hs)):
        out.append((rng.normal(0.0, 1.0, shape) / np.sqrt(shape[0])).astype(np.float32))
    out.append(rng.normal(0.0, 0.1, (4 * hs, 1)).astype(np.float32))
    for n_out in (g5, 1):
        out += [(rng.normal(0.0, 1.0, (hs, n_out)) / np.sqrt(hs)).astype(np.float32),
                rng.normal(0.0, 0.1, (n_out, 1)).astype(np.float32)]
    return out


@pytest.mark.parametrize("ref", [JEnvParams(players_per_team=3), custom_params(
    JEnvParams, JRewardConfig)], ids=["3v3", "custom"])
@pytest.mark.parametrize("mirror", [False, True], ids=["view0", "view1"])
def test_recurrent_bf16_rows_match_jax(ref, mirror):
    """K5's plain forward in bf16, stage by stage, against JAX fed the same
    rounded operands: the torso; the cell (JAX's own ``_lstm_cell``) from
    the port's torso output and a non-zero carry; the logits head (bf16)
    and the value head (f32, unrounded h') from the port's h'."""
    rng = np.random.default_rng(5 + mirror)
    x = _jax_obs(ref, rng, mirror)
    hs, g5 = 24, ref.players_per_team * 10
    w = _recurrent_weights(rng, x.shape[0], (48,), hs, g5)
    tw = tuple(torch.from_numpy(a) for a in w)
    c0 = rng.normal(0.0, 0.5, (hs, B)).astype(np.float32)
    h0 = rng.normal(0.0, 0.5, (hs, B)).astype(np.float32)
    # the torso
    t_port = torch.tanh(tpol.dense_rows(torch.from_numpy(x), tw[0], tw[1], BF16))
    t_jax = jnp.tanh(_jax_dense(x, w[0], w[1], True))
    np.testing.assert_allclose(t_port.numpy(), np.asarray(t_jax), **ROWS_TOL)
    # the cell and heads from the port's torso output (an empty torso here
    # takes t as given)
    logits, value, c1, h1 = tfr._forward(t_port, tw[2:], 0, torch.from_numpy(c0),
                                         torch.from_numpy(h0), BF16)
    with jax.default_matmul_precision("highest"):
        jc, jh = jfr._lstm_cell(_rnd(t_port.numpy()), jnp.asarray(c0), _rnd(h0),
                                _rnd(w[2]), _rnd(w[3]), jnp.asarray(w[4]), hs)
    np.testing.assert_allclose(c1.numpy(), np.asarray(jc), **ROWS_TOL)
    np.testing.assert_allclose(h1.numpy(), np.asarray(jh), **ROWS_TOL)
    want_logits = _jax_dense(h1.numpy(), w[5], w[6], True)
    want_value = _jax_dense(h1.numpy(), w[7], w[8], False)[0]
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **ROWS_TOL)
    np.testing.assert_allclose(value.numpy(), np.asarray(want_value), **ROWS_TOL)
    # the rounding matters at this tolerance: the f32 forward is further off
    f32_logits = tfr._forward(t_port, tw[2:], 0, torch.from_numpy(c0),
                              torch.from_numpy(h0), F32)[0]
    assert (f32_logits - logits).abs().max().item() > 1e-4


# ---------------------------------------------------------------------------
# The tensor-core kernel's layout, read back as the kernel reads it
# ---------------------------------------------------------------------------


def _unpack(frags: torch.Tensor, w_off: int, kp: int, np_: int) -> torch.Tensor:
    """The dense [kp, np_] matrix a layer's B fragments hold, read as the
    kernel's lanes read them: uint4 (kk * np_/16 + jj) * 32 + lane from
    w_off, lane = 4 g + t, halves (b0, b1) of outputs 16 jj + g and
    16 jj + 8 + g, b0 = rows 16 kk + 2 t, + 1, b1 the same + 8."""
    units = frags.reshape(-1, 8)[w_off:w_off + kp * np_ // 8].float()
    w = torch.full((kp, np_), float("nan"))
    for kk in range(kp // 16):
        for jj in range(np_ // 16):
            for lane in range(32):
                g, t = lane // 4, lane % 4
                u = units[(kk * (np_ // 16) + jj) * 32 + lane]
                for half in range(2):
                    n = 16 * jj + 8 * half + g
                    k = 16 * kk + 2 * t
                    w[k, n], w[k + 1, n] = u[4 * half], u[4 * half + 1]
                    w[k + 8, n], w[k + 9, n] = u[4 * half + 2], u[4 * half + 3]
    return w


@pytest.mark.parametrize("hs", [4, 20, 36, 128])
def test_gate_order_gives_each_lane_its_units_gates(hs):
    """In n16 chunk j of 64-column group q, the C fragment of lane (g, t)
    (columns 2t, 2t+1 of the chunk's two n8 tiles) holds gates i, f, g, o
    of one unit, 16 q + 8 (j // 2) + 2 t + j % 2; over the group's four
    chunks the lane holds units 2t, 2t+1, 8+2t, 9+2t of the group: the
    heads' A fragment of k-step q (a0/a1 columns 2t, 2t+1, a2/a3 8+2t,
    9+2t). Every JAX column appears once; padded units point nowhere."""
    order = tpol.recurrent_gate_order(hs)
    hp = -(-hs // 16) * 16
    assert order.shape == (4 * hp,)
    assert sorted(order[order >= 0].tolist()) == list(range(4 * hs))
    for q in range(hp // 16):
        for t in range(4):
            units = []
            for j in range(4):
                cols = [16 * (4 * q + j) + 8 * h + 2 * t + e for h in (0, 1)
                        for e in (0, 1)]
                src = order[cols].tolist()
                u = 16 * q + 8 * (j // 2) + 2 * t + j % 2
                if u < hs:
                    assert src == [gate * hs + u for gate in range(4)]
                else:
                    assert src == [-1] * 4
                units.append(u - 16 * q)
            assert units == [2 * t, 2 * t + 1, 8 + 2 * t, 9 + 2 * t]


def _seq(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """w [K, N] x [K, B] summed over K in ascending order (the plain
    version's order; the kernel's zero rows add exact zeros)."""
    acc = w[0][:, None] * x[0]
    for k in range(1, w.shape[0]):
        acc = acc + w[k][:, None] * x[k]
    return acc


def _emulate_cell_loop(x, c0, h0, frags, fv, table, wv_off, n_torso, hs):
    """The kernel's forward of one view from the packed buffers, read as
    its lanes read them: the torso into bf16 tiles, the cell tile [t | h]
    (t to the torso's padded width, h to hp), then the cell per 64-column
    group q, pass ``half`` and chunk ``jl`` exactly as
    ``rec_view_forward`` indexes them (gate columns col, col + 1, col + 8,
    col + 9 with col = 16 (4 q + 2 half + jl) + 2 t, unit 16 q + 8 half +
    2 t + jl), h' into the heads. Returns (logits, value, c', h')."""
    rows = [table[4 * li:4 * li + 4] for li in range(n_torso + 2)]
    hp = -(-hs // 16) * 16
    b = x.shape[1]
    t = torch.zeros(rows[0][0], b)
    t[:x.shape[0]] = x
    for li in range(n_torso):
        kp, np_, w_off, b_off = rows[li]
        t = torch.tanh(_seq(_unpack(frags, w_off, kp, np_), t.to(BF16).float())
                       + fv[b_off:b_off + np_, None])
    kp, np_, w_off, b_off = rows[n_torso]
    assert kp == t.shape[0] + hp and np_ == 4 * hp
    xc = torch.cat([t, torch.cat([h0, torch.zeros(hp - hs, b)])]).to(BF16).float()
    pre = _seq(_unpack(frags, w_off, kp, np_), xc) + fv[b_off:b_off + np_, None]
    h_new, c_new = torch.zeros(hp, b), torch.zeros(hs, b)
    for q in range(hp // 16):
        for half in range(2):
            for jl in range(2):
                for lt in range(4):
                    u = 16 * q + 8 * half + 2 * lt + jl
                    col = 16 * (4 * q + 2 * half + jl) + 2 * lt
                    gi, gf = tpol.sigmoid(pre[col]), tpol.sigmoid(pre[col + 1])
                    gg, go = torch.tanh(pre[col + 8]), tpol.sigmoid(pre[col + 9])
                    c = gf * (c0[u] if u < hs else torch.zeros(b)) + gi * gg
                    h_new[u] = go * torch.tanh(c)
                    if u < hs:
                        c_new[u] = c
    kp, np_, w_off, b_off = rows[n_torso + 1]
    logits = _seq(_unpack(frags, w_off, kp, np_), h_new.to(BF16).float()) \
        + fv[b_off:b_off + np_, None]
    value = _seq(fv[wv_off:wv_off + hp, None], h_new)[0] + fv[wv_off + hp]
    return logits, value, c_new, h_new[:hs]


@pytest.mark.parametrize("ppt,hidden,hs", [(3, (128,), 128), (2, (48, 40), 20),
                                           (1, (16, 16, 16), 4), (5, (100,), 36),
                                           (3, (64, 64), 256)])
def test_packed_cell_loop_matches_plain_forward(ppt, hidden, hs):
    """K5's packed buffers (torso, logits head, the cell in the kernel's
    gate order, biases, value head) through an emulation of the kernel's
    cell loop give the plain bf16 forward's logits, value, c' and h'
    exactly: the offsets, padding, gate order and value-head placement are
    right; the pad logits are zero."""
    params = params_from_reference(JEnvParams(players_per_team=ppt))
    gen = torch.Generator().manual_seed(ppt)
    model = RecurrentActorCritic(ppt, obs_size(params), hidden, hs, generator=gen,
                                 device="cpu")
    w = tfr.flatten_recurrent_actor_critic(model)
    with torch.no_grad():                  # non-zero biases
        for bias in (*w[1:2 * len(hidden):2], w[2 * len(hidden) + 2], w[-3], w[-1]):
            bias.normal_(0.0, 0.1, generator=gen)
    x = torch.randn(obs_size(params), 40, generator=gen)
    c0 = torch.randn(hs, 40, generator=gen) * 0.5
    h0 = torch.randn(hs, 40, generator=gen) * 0.5
    frags, fv, table, wv_off = tfr.recurrent_tc_pack(w, params)
    assert frags.dtype == BF16 and fv.dtype == F32
    got = _emulate_cell_loop(x, c0, h0, frags, fv, list(table), wv_off, len(hidden), hs)
    want = tfr._forward(x, w, len(hidden), c0, h0, BF16)
    g5 = want[0].shape[0]
    assert torch.equal(got[0][:g5], want[0]) and (got[0][g5:] == 0).all()
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)


def test_pack_layout_order():
    """The fragment buffer holds the torso, the logits head, then the cell
    (so a resident prefix takes the small layers first); every bias offset
    is even (the kernel loads float2)."""
    params = params_from_reference(JEnvParams(players_per_team=3))
    model = RecurrentActorCritic(3, obs_size(params), (128,), 128,
                                 generator=torch.Generator().manual_seed(0),
                                 device="cpu")
    frags, fv, table, wv_off = tfr.recurrent_tc_pack(
        tfr.flatten_recurrent_actor_critic(model), params)
    rows = [list(table)[4 * i:4 * i + 4] for i in range(3)]
    assert rows[0] == [32, 128, 0, 0]
    assert rows[2] == [128, 32, 32 * 128 // 8, 128 + 512]     # the head
    assert rows[1] == [256, 512, (32 * 128 + 128 * 32) // 8, 128]   # the cell
    assert frags.numel() * 2 == 278528
    assert all(r[3] % 2 == 0 for r in rows) and wv_off == 128 + 512 + 32
    assert fv.numel() == wv_off + 128 + 2


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ppt", [1, 2, 3, 5])
@pytest.mark.parametrize("hs", [4, 20, 64, 128, 256])
@pytest.mark.parametrize("n_envs", [1000, 4096, 16384, 65536])
def test_recurrent_plan_covers_every_accepted_shape(ppt, hs, n_envs):
    """Every shape the wrapper takes on the bf16 route (torso widths
    16-512, one to three layers, H a multiple of 4 up to 256) has a
    layout within the block's shared memory whose tiles hold what the
    kernel puts there."""
    params = params_from_reference(JEnvParams(players_per_team=ppt))
    k0 = -(-obs_size(params) // 16) * 16
    nl = -(-ppt * 10 // 16) * 16
    hp = -(-hs // 16) * 16
    for hidden in ((16,), (128,), (512,), (48, 40), (256, 256), (512, 512, 512),
                   (40, 24, 16)):
        plan = tfr.recurrent_tc_plan(params, hidden, hs, n_envs)
        assert plan["route"] == "tensor_cores" and plan["envs"] in tpol.TC_ENVS
        assert plan["blocks"] * plan["envs"] >= n_envs
        assert plan["smem"] == 16 * plan["n_res"] + plan["envs"] // 32 * sum(
            plan["t_bytes"]) <= _build.SMEM_BYTES
        assert 0 <= plan["n_res"] <= plan["frag_bytes"] // 16
        assert all(b % 16 == 0 for b in plan["t_bytes"])
        assert all(ld % 8 == 0 and b >= 64 * ld
                   for ld, b in zip(plan["ld"], plan["t_bytes"]))
        nps = [-(-h // 32) * 32 for h in hidden]
        assert plan["ld"][0] >= k0 and plan["t_bytes"][0] >= 128 * (nl + 1)
        assert plan["ld"][2] >= nps[-1] + hp
        for li, np_ in enumerate(nps[:-1]):
            assert plan["ld"][li % 2] >= np_


def test_recurrent_plan_main_shape():
    """The recurrent main path (3v3, 16384 envs, hidden (128,), H = 128):
    128 blocks of 128 envs, one wave on the 132 SMs; the 278,528 bytes of
    fragments do not fit beside four warps' tiles (84,480 bytes), so the
    torso, the head and the first 131,584 bytes of the cell are resident
    (the whole block's 232,448 bytes used), the rest read from L2."""
    p3 = params_from_reference(JEnvParams(players_per_team=3))
    plan = tfr.recurrent_tc_plan(p3, (128,), 128, 16384)
    assert (plan["envs"], plan["blocks"], plan["blocks_per_sm"]) == (128, 128, 1)
    assert plan["frag_bytes"] == 278528 and plan["weights"] == "prefix"
    assert plan["ld"] == (40, 0, 264) and plan["t_bytes"] == (4224, 0, 16896)
    assert plan["n_res"] == (232448 - 4 * (4224 + 16896)) // 16
    assert plan["smem"] == 232448


def test_recurrent_plan_mlplstm_shape():
    """stable-baselines' MlpLstmPolicy on the benchmark's 16384 3v3 envs
    (torso (64, 64), H = 256): 128 blocks of 128 envs, one wave; the
    cell's fragments, (64 + 256) x 1024 bf16 = 655,360 bytes, with the
    torso's and the head's 28,672 make 684,032; four warps' tiles take
    102,400 bytes (xc 328 elements wide), so the torso, the head and the
    first 101,376 bytes of the cell are resident, the rest read from L2."""
    p3 = params_from_reference(JEnvParams(players_per_team=3))
    plan = tfr.recurrent_tc_plan(p3, (64, 64), 256, 16384)
    assert (plan["envs"], plan["blocks"], plan["blocks_per_sm"]) == (128, 128, 1)
    assert plan["frag_bytes"] == 684032 and plan["weights"] == "prefix"
    assert plan["ld"] == (72, 0, 328) and plan["t_bytes"] == (4608, 0, 20992)
    assert plan["n_res"] == (232448 - 4 * (4608 + 20992)) // 16 == 8128
    assert plan["smem"] == 232448


@pytest.mark.parametrize("hidden,hs,want", [
    ((64, 64), 256, dict(n_res=8128, frag_bytes=684032, ld=(72, 0, 328),
                         t_bytes=(4608, 0, 20992))),
    ((128,), 128, dict(n_res=9248, frag_bytes=278528, ld=(40, 0, 264),
                       t_bytes=(4224, 0, 16896))),
], ids=["recurrent_ppo_iter.3v3", "main"])
def test_recurrent_plan_pinned(hidden, hs, want):
    """The whole plan on 16384 3v3 envs at the benchmark's cell
    (``recurrent_ppo_iter.3v3``: torso (64, 64), H = 256) and at the
    recurrent main path ((128,), H = 128): one wave of 128 blocks of 128
    envs, a prefix of the fragments filling the block."""
    p3 = params_from_reference(JEnvParams(players_per_team=3))
    assert tfr.recurrent_tc_plan(p3, hidden, hs, 16384) == dict(
        route="tensor_cores", envs=128, blocks=128, smem=232448, blocks_per_sm=1,
        weights="prefix", **want)


@pytest.mark.parametrize("widths,hs,dtype,match", [
    ((64, 64), 256, F32, "bfloat16 route"),     # 4H = 1024 > 512
    ((512,), 32, F32, "bfloat16 route"),        # t and h 544 rows
    ((64, 64), 260, BF16, "4H <= 1024"),
    ((64, 64), 250, BF16, "multiple of 4"),
    ((64, 1024), 64, BF16, "at most 512 wide"),
])
def test_kernel_shape_refusals(widths, hs, dtype, match):
    """The float32 route keeps 4H and the cell's input rows at most 512,
    and its refusal names the bfloat16 route, which takes 4H up to
    1024; both take H a multiple of 4 and torso widths up to 512."""
    with pytest.raises(ValueError, match=match):
        tfr.check_kernel_shape(widths, hs, dtype)


@pytest.mark.parametrize("widths,hs,dtype", [
    ((64, 64), 256, BF16), ((128,), 128, F32), ((128,), 128, BF16), ((384,), 128, F32)])
def test_kernel_shape_accepted(widths, hs, dtype):
    tfr.check_kernel_shape(widths, hs, dtype)


# ---------------------------------------------------------------------------
# compute_dtype and the wrapper's CPU path
# ---------------------------------------------------------------------------


def _setup(n_envs=32, hidden=(24,), lstm=12, seed=0):
    params = params_from_reference(JEnvParams(players_per_team=2, max_steps=5))
    gen = torch.Generator().manual_seed(seed)
    state, _ = vector.reset_batch(gen, params, n_envs, device="cpu")
    sf, si = ops.pack_state(state, params)
    model = RecurrentActorCritic(2, obs_size(params), hidden, lstm, generator=gen,
                                 device="cpu")
    cc, hh = (torch.randn(2, lstm, n_envs, generator=gen) * 0.5 for _ in range(2))
    return params, gen, sf, si, model, cc, hh


def test_compute_dtype_validation():
    """Every recurrent entry point with a compute_dtype takes bfloat16 or
    float32 and refuses anything else before any work."""
    params, gen, sf, si, model, cc, hh = _setup()
    w = tfr.flatten_recurrent_actor_critic(model)
    cfg = ta2c.A2CConfig(rollout_steps=2)
    runner = ta2c.init_recurrent_runner(gen, model, params, cfg, 32)
    calls = (
        lambda d: ops.fused_recurrent_collect(sf, si, w, cc, hh, 0, params, 2,
                                              compute_dtype=d),
        lambda d: tfr.fused_recurrent_collect_reference(sf, si, w, cc, hh, params, 2,
                                                        seed=0, compute_dtype=d),
        lambda d: ta2c.collect_recurrent_rollout_fused(runner, params, cfg,
                                                       compute_dtype=d),
    )
    for call in calls:
        for bad in (torch.float16, torch.float64, "bfloat16"):
            with pytest.raises(ValueError, match="compute_dtype"):
                call(bad)


@pytest.mark.parametrize("mode", [BF16, F32], ids=["bfloat16", "float32"])
def test_wrapper_cpu_path_both_modes(mode, monkeypatch):
    """On CPU tensors the wrapper is its plain version in the requested
    mode, exactly, never builds a kernel and counts no launch; the two
    modes sample from different logits, so their log-probs differ; the
    fused collector passes its compute_dtype through."""
    def refuse():
        raise AssertionError("the CPU path reached the kernel build")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    params, gen, sf, si, model, cc, hh = _setup(n_envs=64)
    cfg = ta2c.A2CConfig(rollout_steps=3)
    runner = ta2c.init_recurrent_runner(gen, model, params, cfg, 64)  # inits model
    runner = runner.replace(env_state=ops.unpack_state(sf, si, params),
                            carry=(cc.transpose(1, 2), hh.transpose(1, 2)))
    w = tfr.flatten_recurrent_actor_critic(model)
    u = torch.rand((3, tfr.n_draws_per_step(params), 64), generator=gen)
    ops.reset_launch_counts()
    got = ops.fused_recurrent_collect(sf, si, w, cc, hh, 0, params, 3, uniforms=u,
                                      compute_dtype=mode)
    want = tfr.fused_recurrent_collect_reference(sf, si, w, cc, hh, params,
                                                 uniforms=u, compute_dtype=mode)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    other = tfr.fused_recurrent_collect_reference(
        sf, si, w, cc, hh, params, uniforms=u,
        compute_dtype=F32 if mode == BF16 else BF16)
    assert not torch.equal(got[5], other[5])                 # logp
    assert torch.equal(got[2][:, :, 0], other[2][:, :, 0])   # step 0's obs: f32
    _, traj, _ = ta2c.collect_recurrent_rollout_fused(runner, params, cfg, uniforms=u,
                                                      compute_dtype=mode)
    assert torch.equal(traj.logp, got[5].reshape(3, 128))
    assert sum(ops.LAUNCHES.values()) == 0
