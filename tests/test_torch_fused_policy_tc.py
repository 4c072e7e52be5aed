"""The bfloat16 route of the self-play policy kernels (K2
``fused_collect``, K4 ``fused_selfplay_rollout``): the plain versions'
bf16 MLP rows against JAX, the tensor-core kernel's weight fragments and
layout read back as the kernel reads them, the layout plan, and the
wrappers' CPU path in both modes.

On its chip the JAX kernels' f32 ``dot_general`` runs as one bf16 pass
(default precision): both operands rounded to bf16, the products summed
in f32; the value head ``[H, 1]`` is a degenerate dot, exact f32. Here
JAX on the CPU is fed the bf16-rounded operands with ``HIGHEST``
precision, which is that computation. Tolerances, with their reasons:
MLP rows rtol 1e-5 / atol 2e-5 (f32 sums in another order than XLA's,
and tanh differing from XLA's in the last f32 bit, which can move a
rounded activation by one bf16 ulp, 2^-8 relative, in a rare element);
the fragment layout exact; the kernel's layout emulated here against the
plain version rtol 1e-5 / atol 1e-5 (another summation order only).
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
from gym_futbol_tpu_torch import evaluate as teval  # noqa: E402
from gym_futbol_tpu_torch import obs_size, ops, vector  # noqa: E402
from gym_futbol_tpu_torch import ppo as tppo  # noqa: E402
from gym_futbol_tpu_torch.interop import params_from_reference  # noqa: E402
from gym_futbol_tpu_torch.models.policy import ActorCritic  # noqa: E402
from gym_futbol_tpu_torch.ops import _build  # noqa: E402

from _torch_cases import custom_params, game_states  # noqa: E402

jfa = importlib.import_module("gym_futbol_tpu.ops.fused_actor")
tfa = importlib.import_module("gym_futbol_tpu_torch.ops.fused_actor")
tfc = importlib.import_module("gym_futbol_tpu_torch.ops.fused_collect")
tpol = importlib.import_module("gym_futbol_tpu_torch.ops._policy")

B = 96
BF16, F32 = torch.bfloat16, torch.float32
ROWS_TOL = dict(rtol=1e-5, atol=2e-5)


def _weights(rng, dims):
    """A flat (W [in, out], b [out, 1], ...) numpy tuple, He-scaled, with
    non-zero biases."""
    out = []
    for n_in, n_out in zip(dims[:-1], dims[1:]):
        out.append((rng.normal(0.0, 1.0, (n_in, n_out)) / np.sqrt(n_in))
                   .astype(np.float32))
        out.append(rng.normal(0.0, 0.1, (n_out, 1)).astype(np.float32))
    return out


def _jax_dense(x, w, b, rounded):
    """The TPU's layer product: bf16-rounded operands (``rounded``), f32
    sums, then the bias."""
    def rnd(a):
        a = jnp.asarray(a)
        return a.astype(jnp.bfloat16).astype(jnp.float32) if rounded else a

    return jax.lax.dot_general(
        rnd(w), rnd(x), (((0,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32) + jnp.asarray(b)


def _jax_obs(ref, rng, mirror):
    pos, vel, poss, _, _ = game_states(rng, ref, B)
    n = ref.n_bodies
    rows = [[jnp.asarray(pos[:, i, c]) for i in range(n)] for c in (0, 1)] + \
        [[jnp.asarray(vel[:, i, c]) for i in range(n)] for c in (0, 1)]
    return np.array(jfa._obs_matrix(*rows, jnp.asarray(poss), ref, mirror, B))


@pytest.mark.parametrize("ref", [JEnvParams(players_per_team=3), custom_params(
    JEnvParams, JRewardConfig)], ids=["3v3", "custom"])
@pytest.mark.parametrize("mirror", [False, True], ids=["view0", "view1"])
def test_collect_bf16_rows_match_jax(ref, mirror):
    """K2's plain forward in bf16 (torso, logits head, f32 value head on
    the unrounded torso output) against JAX fed the same rounded
    operands, for both views' observations."""
    rng = np.random.default_rng(3)
    x = _jax_obs(ref, rng, mirror)
    f, g5 = x.shape[0], ref.players_per_team * 10
    w = _weights(rng, [f, 48, 40, g5])
    wv = _weights(rng, [40, 1])
    h = x
    for li in range(2):
        h = jnp.tanh(_jax_dense(h, w[2 * li], w[2 * li + 1], True))
    want_logits = _jax_dense(h, w[4], w[5], True)
    want_value = _jax_dense(h, wv[0], wv[1], False)[0]
    tw = tuple(torch.from_numpy(a) for a in (*w, *wv))
    logits, value = tfc._forward(torch.from_numpy(x), tw, BF16)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **ROWS_TOL)
    np.testing.assert_allclose(value.numpy(), np.asarray(want_value), **ROWS_TOL)
    # the rounding matters at this tolerance: the f32 forward is further off
    f32_logits = tfc._forward(torch.from_numpy(x), tw, F32)[0]
    assert (f32_logits - logits).abs().max().item() > 1e-4


@pytest.mark.parametrize("team", [0, 1])
def test_selfplay_bf16_rows_match_jax(team):
    """K4's plain MLP rows in bf16 for each team's policy on its own view
    (team 1 mirrored) against JAX fed the same rounded operands."""
    ref = JEnvParams(players_per_team=2)
    rng = np.random.default_rng(4 + team)
    x = _jax_obs(ref, rng, team == 1)
    w = _weights(rng, [x.shape[0], 64, 24, 20])
    h = jnp.asarray(x)
    for li in range(3):
        h = _jax_dense(h, w[2 * li], w[2 * li + 1], True)
        if li < 2:
            h = jnp.tanh(h)
    got = tfa.mlp_logit_rows(torch.from_numpy(x),
                             tuple(torch.from_numpy(a) for a in w), BF16)
    np.testing.assert_allclose(got.numpy(), np.asarray(h), **ROWS_TOL)


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
                for half in range(2):          # the two n8 tiles
                    n = 16 * jj + 8 * half + g
                    k = 16 * kk + 2 * t
                    w[k, n], w[k + 1, n] = u[4 * half], u[4 * half + 1]
                    w[k + 8, n], w[k + 9, n] = u[4 * half + 2], u[4 * half + 3]
    return w


@pytest.mark.parametrize("shape,kp,np_", [((30, 256), 32, 256), ((46, 40), 48, 64),
                                          ((64, 30), 64, 32), ((16, 50), 16, 64)])
def test_tc_fragments_layout(shape, kp, np_):
    """Every element of the padded, bf16-rounded matrix lands where the
    kernel's mma.sync B fragments read it; the pad is zero."""
    w = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    got = _unpack(tpol.tc_fragments(w, kp, np_), 0, kp, np_)
    want = torch.zeros(kp, np_)
    want[:shape[0], :shape[1]] = w.to(BF16).float()
    assert torch.equal(got, want)


def _emulate_tc_mlp(x, frags, fv, table, wv_off, n_layers):
    """The kernel's MLP on obs columns ``x`` [F, B] from the packed
    buffers: fragments read back as the kernel reads them at the table's
    offsets, bf16 activations between layers, the last hidden layer's
    f32 output into the f32 value head. Returns (logits [np_head, B],
    value [B] or None)."""
    dims = [tuple(table[4 * li:4 * li + 4]) for li in range(n_layers)]
    h = torch.zeros(dims[0][0], x.shape[1])
    h[:x.shape[0]] = x
    for li, (kp, np_, w_off, b_off) in enumerate(dims):
        w = _unpack(frags, w_off, kp, np_)
        y = w.T @ h.to(BF16).float() + fv[b_off:b_off + np_, None]
        if li == n_layers - 1:
            value = None
            if wv_off >= 0:
                value = fv[wv_off:wv_off + kp] @ h + fv[wv_off + kp]
            return y, value
        h = torch.tanh(y)


@pytest.mark.parametrize("ppt,hidden", [(3, (256, 256)), (2, (48, 40)),
                                        (5, (100,)), (1, (16, 16, 16))])
def test_tc_pack_matches_plain_forward(ppt, hidden):
    """K2's packed weights (torso, logits head, value head) through the
    kernel's reading of them give the plain bf16 forward's logits and
    value: the offsets, padding and value-head placement are right."""
    params = params_from_reference(JEnvParams(players_per_team=ppt))
    gen = torch.Generator().manual_seed(ppt)
    model = ActorCritic(ppt, obs_size(params), hidden, generator=gen, device="cpu")
    w = tfc.flatten_actor_critic(model)
    with torch.no_grad():                  # non-zero biases
        for b in w[1::2]:
            b.normal_(0.0, 0.1, generator=gen)
    x = torch.randn(obs_size(params), 64, generator=gen)
    torso = list(zip(w[:-4:2], w[1:-4:2]))
    frags, fv, (table,), (wv_off,) = tpol.tc_pack(
        [(torso + [(w[-4], w[-3])], (w[-2], w[-1]))], params)
    logits, value = _emulate_tc_mlp(x, frags, fv, list(table), wv_off,
                                    len(hidden) + 1)
    want_logits, want_value = tfc._forward(x, w, BF16)
    g5 = want_logits.shape[0]
    torch.testing.assert_close(logits[:g5], want_logits, rtol=1e-5, atol=1e-5)
    assert (logits[g5:] == 0).all()
    torch.testing.assert_close(value, want_value, rtol=1e-5, atol=1e-5)


def test_tc_pack_two_policies():
    """K4's two MLPs share one fragment buffer and one f32 vector: B's
    offsets follow A's, neither has a value head."""
    params = params_from_reference(JEnvParams(players_per_team=2))
    gen = torch.Generator().manual_seed(7)
    wa = tfa.init_mlp(gen, params, (64, 32), device="cpu")
    wb = tfa.init_mlp(gen, params, (64, 32), device="cpu")
    frags, fv, tables, wv_offs = tpol.tc_pack(
        [(list(zip(w[::2], w[1::2])), None) for w in (wa, wb)], params)
    assert wv_offs == [-1, -1]
    x = torch.randn(obs_size(params), 32, generator=gen)
    for w, table in zip((wa, wb), tables):
        logits, _ = _emulate_tc_mlp(x, frags, fv, list(table), -1, 3)
        torch.testing.assert_close(logits[:20], tfa.mlp_logit_rows(x, w, BF16),
                                   rtol=1e-5, atol=1e-5)
    assert list(tables[1])[2] == list(tables[0])[-2] + 32 * 32 // 8


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ppt", [1, 2, 3, 5])
@pytest.mark.parametrize("width", [16, 48, 128, 256, 512])
@pytest.mark.parametrize("n_envs", [1000, 4096, 16384, 65536])
def test_tc_plan_covers_every_accepted_shape(ppt, width, n_envs):
    """Every width the wrappers take (16-512, one to three hidden layers,
    one MLP or two) has a tensor-core layout within the block's shared
    memory; the float32 route is the CUDA-core kernel."""
    params = params_from_reference(JEnvParams(players_per_team=ppt))
    for hiddens, value in (([(width,)], True), ([(width, width)], True),
                           ([(width,) * 3], True), ([(width, width)] * 2, False),
                           ([()] * 2, False)):
        plan = tpol.tc_plan(params, hiddens, n_envs)
        assert plan["route"] == "tensor_cores"
        assert plan["envs"] in tpol.TC_ENVS and plan["smem"] <= _build.SMEM_BYTES
        assert plan["blocks"] * plan["envs"] >= n_envs
        assert all(b % 16 == 0 for b in plan["t_bytes"])
        assert all(ld % 8 == 0 for ld in plan["ld"])
        resident = plan["weights"] == "resident"
        assert plan["smem"] == (plan["frag_bytes"] if resident else 0) + \
            plan["envs"] // 32 * sum(plan["t_bytes"])
        f32 = tpol.tc_plan(params, hiddens, n_envs, F32)
        assert f32["route"] == "cuda_cores" and f32["smem"] <= 2 * 512 * 128


def test_tc_plan_main_shapes():
    """Config 4 (3v3, 16384 envs, (256, 256)): every weight resident
    (163,840 bytes of bf16 fragments) beside four warps' tiles, 128
    blocks of 128 envs. Config 6 (2v2, 4096 envs, two (128, 128) MLPs):
    both MLPs resident, 32 envs a block so that 128 SMs get one each."""
    p4 = params_from_reference(JEnvParams(players_per_team=3))
    plan = tpol.tc_plan(p4, [(256, 256)], 16384)
    assert (plan["weights"], plan["envs"], plan["blocks"]) == ("resident", 128, 128)
    assert plan["frag_bytes"] == 32 * 256 * 2 + 256 * 256 * 2 + 256 * 32 * 2
    assert plan["ld"] == (264, 0) and plan["t_bytes"] == (64 * 264, 0)
    assert plan["smem"] == 163840 + 4 * 64 * 264 <= _build.SMEM_BYTES
    p6 = params_from_reference(JEnvParams(players_per_team=2))
    plan = tpol.tc_plan(p6, [(128, 128)] * 2, 4096)
    assert (plan["weights"], plan["envs"], plan["blocks"]) == ("resident", 32, 128)
    assert plan["frag_bytes"] == 2 * 49152
    # 5v5 at (256, 256) with 16384 envs: four warps' tiles leave no room
    # for the 188,416 bytes of weights, so they stream
    p5 = params_from_reference(JEnvParams(players_per_team=5))
    plan = tpol.tc_plan(p5, [(256, 256)], 16384)
    assert plan["frag_bytes"] == 188416 and plan["weights"] == "streamed"


@pytest.mark.parametrize("ppt,hiddens,n_envs,want", [
    (5, [(256, 256)], 65536, dict(
        envs=128, blocks=512, smem=67584, blocks_per_sm=2, weights="streamed",
        frag_bytes=188416, ld=(264, 0), t_bytes=(16896, 0))),
    (3, [(256, 256)], 16384, dict(
        envs=128, blocks=128, smem=231424, blocks_per_sm=1, weights="resident",
        frag_bytes=163840, ld=(264, 0), t_bytes=(16896, 0))),
    (2, [(128, 128)] * 2, 4096, dict(
        envs=32, blocks=128, smem=107008, blocks_per_sm=2, weights="resident",
        frag_bytes=98304, ld=(136, 0), t_bytes=(8704, 0))),
], ids=["ppo_iter.5v5", "config4", "config6"])
def test_tc_plan_pinned(ppt, hiddens, n_envs, want):
    """The whole plan at the shapes the benchmark's cells and the bench
    configs run: K2 in ``ppo_iter.5v5`` (5v5, (256, 256), 65536 envs:
    weights streamed, two blocks an SM), config 4's collect and config
    6's two policies."""
    params = params_from_reference(JEnvParams(players_per_team=ppt))
    assert tpol.tc_plan(params, hiddens, n_envs) == dict(route="tensor_cores", **want)


def test_compute_dtype_validation():
    """Every entry point with a compute_dtype takes bfloat16 or float32
    and refuses anything else before any work."""
    params = params_from_reference(JEnvParams(players_per_team=2))
    gen = torch.Generator().manual_seed(0)
    state, _ = vector.reset_batch(gen, params, 8, device="cpu")
    sf, si = ops.pack_state(state, params)
    model = ActorCritic(2, obs_size(params), (16,), generator=gen, device="cpu")
    w = tfc.flatten_actor_critic(model)
    mlp = tfc.actor_critic_policy_weights(model)
    cfg = tppo.PPOConfig(rollout_steps=2)
    runner = tppo.init_runner(gen, model, params, cfg, 8)
    calls = (
        lambda d: ops.fused_collect(sf, si, w, 0, params, 2, compute_dtype=d),
        lambda d: tfc.fused_collect_reference(sf, si, w, params, 2, seed=0,
                                              compute_dtype=d),
        lambda d: ops.fused_selfplay_rollout(sf, si, mlp, mlp, 0, params, 2,
                                             compute_dtype=d),
        lambda d: tfa.fused_selfplay_rollout_reference(
            sf, si, mlp, mlp, params, 2, seed=0, compute_dtype=d),
        lambda d: tppo.collect_rollout_fused(runner, params, cfg, compute_dtype=d),
        lambda d: teval.evaluate_fused(params, mlp, n_envs=8, n_steps=2,
                                       compute_dtype=d),
        lambda d: tpol.tc_plan(params, [(16,)], 8, d),
    )
    for call in calls:
        for bad in (torch.float16, torch.float64, "bfloat16"):
            with pytest.raises(ValueError, match="compute_dtype"):
                call(bad)


def test_wrappers_refuse_what_no_route_takes():
    """A width over 512 or more than 8 dense layers: both routes refuse,
    on the CPU too."""
    params = params_from_reference(JEnvParams(players_per_team=2))
    gen = torch.Generator().manual_seed(0)
    state, _ = vector.reset_batch(gen, params, 8, device="cpu")
    sf, si = ops.pack_state(state, params)
    wide = tfa.init_mlp(gen, params, (513,), device="cpu")
    deep = tfa.init_mlp(gen, params, (16,) * 8, device="cpu")
    for mlp in (wide, deep):
        for mode in (BF16, F32):
            with pytest.raises(ValueError):
                ops.fused_selfplay_rollout(sf, si, mlp, mlp, 0, params, 2,
                                           compute_dtype=mode)
    model = ActorCritic(2, obs_size(params), (600,), generator=gen, device="cpu")
    with pytest.raises(ValueError, match="512"):
        ops.fused_collect(sf, si, tfc.flatten_actor_critic(model), 0, params, 2)


# ---------------------------------------------------------------------------
# The wrappers' CPU path in both modes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", [BF16, F32], ids=["bfloat16", "float32"])
def test_wrappers_cpu_path_both_modes(mode):
    """On CPU tensors each wrapper is its plain version in the requested
    mode, exactly; the two modes sample from different logits, so their
    log-probs differ."""
    params = params_from_reference(JEnvParams(players_per_team=2))
    gen = torch.Generator().manual_seed(5)
    state, _ = vector.reset_batch(gen, params, 64, device="cpu")
    sf, si = ops.pack_state(state, params)
    model = ActorCritic(2, obs_size(params), (32, 24), generator=gen, device="cpu")
    w = tfc.flatten_actor_critic(model)
    wa = tfa.init_mlp(gen, params, (24,), device="cpu")
    wb = tfa.init_mlp(gen, params, (24,), device="cpu")
    u = torch.rand((3, tfa.n_draws_per_step(params), 64), generator=gen)
    ops.reset_launch_counts()
    got = ops.fused_collect(sf, si, w, 0, params, 3, uniforms=u, compute_dtype=mode)
    want = tfc.fused_collect_reference(sf, si, w, params, uniforms=u,
                                       compute_dtype=mode)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    other = tfc.fused_collect_reference(
        sf, si, w, params, uniforms=u, compute_dtype=F32 if mode == BF16 else BF16)
    assert not torch.equal(got[5], other[5])             # logp
    assert torch.equal(got[2][:, :, 0], other[2][:, :, 0])   # step 0's obs: f32
    got = ops.fused_selfplay_rollout(sf, si, wa, wb, 0, params, 3, uniforms=u,
                                     return_actions=True, compute_dtype=mode)
    want = tfa.fused_selfplay_rollout_reference(
        sf, si, wa, wb, params, uniforms=u, return_actions=True,
        compute_dtype=mode)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert sum(ops.LAUNCHES.values()) == 0
