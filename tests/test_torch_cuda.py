"""The CUDA kernels against their plain PyTorch versions on the card.

Needs a CUDA device and nvcc; skips without a card (a hand-written
kernel has no CPU mode). Imports nothing of JAX, so it runs where only
PyTorch is installed, without this directory's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Replay, table and Philox modes at 2v2 (zero-noise and custom params)
and 5v5: pos/vel rtol 1e-4 / atol 1e-3, rewards rtol 1e-4 / atol 1e-4,
integer state exact (the kernel rounds every operation as the plain
version does, so on the card the two agree bitwise in practice). The
policy kernels in table and Philox modes, 3v3 at a ragged batch, the
custom params and 2v2 with the evaluation's (128, 128) MLPs: the float32
route with integers and sampled actions exact, floats 1e-5; the
bfloat16 route (tensor cores) on the uniforms table, every differing
action a near tie, floats on the agreeing envs within their bounds
(given at the test). The update kernels at 2v2
(64, 64), 5v5 and 4v4 at (256, 256) and other shapes in both modes (per
leaf rel-L2, bounds with their reasons at the test), W2 streamed bitwise
equal to resident at 3v3 (256, 256), and one train_iteration on the
collect and update kernels.
The recurrent collect in table and Philox modes from non-zero carries
(3v3 ragged, custom, 2v2 at H = 128): the float32 route with integers and
sampled actions exact, floats and carries 1e-5, the input carries
unchanged; the bfloat16 route (tensor cores) at the main shape, the
custom params and a ragged batch on the uniforms table, as the policy
kernels' bf16 route (bounds at the test), also at stable-baselines'
MlpLstmPolicy widths (torso (64, 64), H = 256, 4H = 1024: the cell's
fragments mostly read from L2); one recurrent PPO iteration on it. The
random rollout also on states built for the culled contact solver
(crowded, on the walls, in the goal mouth, ragged): bitwise, and so at
1v1-5v5 and custom on every layout its plan can give and its own, in
Philox and table mode; a layout its kernel does not take raises. The
replay (G lanes per env, per-env contact lists) on those states at
1v1-5v5 and custom, on every layout its plan can give and its own, at a
ragged batch and one smaller than a block: bitwise; a layout the kernel
does not take raises. K6, the recurrent update's LSTM recurrence: both
kernels against their plain versions at the recurrent PPO cell's
minibatch and a ragged H = 128 (bounds at the test), the autograd node
on the card against the same node on the host, the refused shapes, and
one update on it (two launches and two spans a minibatch). LayerNorm
(stable-baselines' layer-normalised cell): K6's and K5's LayerNorm
instantiations against their plain versions (a padded H among the
shapes), a zero carry's rows, the node on the card against the host, one
recurrent PPO iteration on both kernels, and the refusals; LayerNorm's
backward tail kernel and its plain version against float64.
"""

import importlib

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from gym_futbol_tpu_torch import EnvParams, RewardConfig, ops, vector  # noqa: E402

from _torch_cases import custom_params, random_actions  # noqa: E402

tfr = importlib.import_module("gym_futbol_tpu_torch.ops.fused_rollout")

CUSTOM = custom_params(EnvParams, RewardConfig)
B, T = 256, 9


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("params", [
    CUSTOM.replace(kick_noise=0.0, placement_noise=0.0), CUSTOM,
    EnvParams(players_per_team=5, max_steps=5),
], ids=["custom-zero-noise", "custom", "5v5"])
def test_kernel_matches_plain(cuda, params):
    gen = torch.Generator(device=cuda).manual_seed(2)
    state, _ = vector.reset_batch(gen, params, B, device=cuda)
    sf, si = ops.pack_state(state, params)
    acts = torch.from_numpy(
        random_actions(np.random.default_rng(1), params, (T, B))
        .reshape(T, B, -1).transpose(0, 2, 1).copy()).to(cuda)
    u = torch.rand((T, tfr.n_draws_per_step(params), B), generator=gen,
                   device=cuda)
    before = dict(ops.LAUNCHES)
    cases = [
        (ops.fused_rollout_replay(sf, si, acts, params),
         tfr.fused_rollout_reference(sf, si, params, actions=acts)),
        (ops.fused_rollout(sf, si, 0, params, T, uniforms=u),
         tfr.fused_rollout_reference(sf, si, params, uniforms=u)),
        (ops.fused_rollout(sf, si, 77, params, T),
         tfr.fused_rollout_reference(sf, si, params, T, seed=77)),
    ]
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_rollout"] == before["fused_rollout"] + 2
    assert ops.LAUNCHES["fused_rollout_replay"] == before["fused_rollout_replay"] + 1
    for (ksf, ksi, krew), (psf, psi, prew) in cases:
        assert ksf.device.type == "cuda" and krew.shape == (T, B)
        torch.testing.assert_close(ksf, psf, rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(krew, prew, rtol=1e-4, atol=1e-4)
        assert torch.equal(ksi, psi)


@pytest.mark.cuda
@pytest.mark.parametrize("params", [
    EnvParams(players_per_team=2), EnvParams(players_per_team=5, max_steps=4),
    CUSTOM,
], ids=["2v2", "5v5", "custom"])
def test_kernel_bitwise_on_contact_states(cuda, params):
    """The culled env step (futbol_step.cuh: each pair or wall update runs
    where some lane of the warp needs it) on states built to exercise it:
    crowded, on every wall, balls in the goal mouth, mixed within warps,
    on a batch that is not a multiple of 32. Table and Philox modes and
    the replay: bitwise equal to the plain version (signed zeros compare
    equal)."""
    from gym_futbol_tpu_torch.interop import state_from_numpy

    from _torch_cases import contact_states

    n_envs = 32 * 7 + 19
    pos, vel = contact_states(params, n_envs, seed=11)
    rng = np.random.default_rng(12)
    poss = np.where(rng.random(n_envs) < 0.5,
                    rng.integers(1, params.n_players + 1, n_envs), -1).astype(np.int32)
    score = np.zeros((n_envs, 2), np.int32)
    t = rng.integers(0, params.max_steps, n_envs).astype(np.int32)
    sf, si = ops.pack_state(state_from_numpy(pos, vel, poss, score, t, device=cuda),
                            params)
    gen = torch.Generator(device=cuda).manual_seed(13)
    u = torch.rand((T, tfr.n_draws_per_step(params), n_envs), generator=gen,
                   device=cuda)
    acts = torch.from_numpy(
        random_actions(rng, params, (T, n_envs))
        .reshape(T, n_envs, -1).transpose(0, 2, 1).copy()).to(cuda)
    cases = [
        (ops.fused_rollout(sf, si, 0, params, T, uniforms=u),
         tfr.fused_rollout_reference(sf, si, params, uniforms=u)),
        (ops.fused_rollout(sf, si, 31, params, T),
         tfr.fused_rollout_reference(sf, si, params, T, seed=31)),
        (ops.fused_rollout_replay(sf, si, acts, params),
         tfr.fused_rollout_reference(sf, si, params, actions=acts)),
    ]
    for got, want in cases:
        assert all(torch.equal(a, b) for a, b in zip(got, want))


REPLAY_CASES = {
    "1v1": EnvParams(players_per_team=1),
    "2v2": EnvParams(players_per_team=2),
    "3v3": EnvParams(players_per_team=3, max_steps=5),
    "4v4": EnvParams(players_per_team=4, max_steps=6),
    "5v5": EnvParams(players_per_team=5, max_steps=4),
    "custom": CUSTOM.replace(kick_noise=0.0, placement_noise=0.0),
}
# every (lanes, threads) the plan (the replay's and the random rollout's)
# can give, and each lane count at the smallest block and at 128 threads
# (lowered until the envs' records fit, as the plan lowers its own)
REPLAY_ROUTES = sorted({(g, n) for rows in tfr.LANE_LAYOUTS.values() for _, g, n in rows}
                       | {(g, n) for g in (2, 4, 8) for n in (32, 128)} | {(0, 32)})


def _replay_contact_case(cuda, params, n_envs):
    from gym_futbol_tpu_torch.interop import state_from_numpy

    from _torch_cases import contact_states

    pos, vel = contact_states(params, n_envs, seed=21)
    rng = np.random.default_rng(22)
    poss = np.where(rng.random(n_envs) < 0.5,
                    rng.integers(1, params.n_players + 1, n_envs), -1).astype(np.int32)
    score = rng.integers(0, 3, (n_envs, 2)).astype(np.int32)
    t = rng.integers(0, params.max_steps, n_envs).astype(np.int32)
    sf, si = ops.pack_state(state_from_numpy(pos, vel, poss, score, t, device=cuda),
                            params)
    acts = torch.from_numpy(
        random_actions(rng, params, (T, n_envs))
        .reshape(T, n_envs, -1).transpose(0, 2, 1).copy()).to(cuda)
    return sf, si, acts


@pytest.mark.cuda
@pytest.mark.parametrize("n_envs", [32 * 7 + 19, 5], ids=["ragged", "small"])
@pytest.mark.parametrize("case", list(REPLAY_CASES))
def test_replay_lanes_bitwise_on_contact_states(cuda, case, n_envs, monkeypatch):
    """The replay kernel (G lanes per env, per-env contact lists) on
    contact states, on every route the plan can pick (each lane count
    G in 2, 4, 8 at 32 and 128 threads a block, one thread per env (G
    = 0, 32 a block), and every layout of the plan's table) and the
    plan's own:
    bitwise equal to the plain version (signed zeros compare equal), on a
    batch that is no multiple of 32 / G and on one smaller than a
    block; one launch counted per call."""
    params = REPLAY_CASES[case]
    sf, si, acts = _replay_contact_case(cuda, params, n_envs)
    want = tfr.fused_rollout_reference(sf, si, params, actions=acts)
    from gym_futbol_tpu_torch.replay_timing import forced_plan

    for lanes, threads in [(None, None), *REPLAY_ROUTES]:
        if lanes is not None:
            monkeypatch.setattr(tfr, "replay_plan", forced_plan(tfr, lanes, threads))
        before = ops.LAUNCHES["fused_rollout_replay"]
        got = ops.fused_rollout_replay(sf, si, acts, params)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["fused_rollout_replay"] == before + 1
        for name, a, b in zip(("statef", "statei", "rewards"), got, want):
            assert torch.equal(a, b), (lanes, threads, name)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes, threads", [(1, 64), (3, 96), (8, 48), (8, 512), (0, 64)],
                         ids=["one-lane", "lanes", "partial-warp", "too-many",
                              "thread-block"])
def test_replay_refuses_a_bad_plan(cuda, lanes, threads, monkeypatch):
    """A layout the replay kernel does not take is refused at launch and
    raises; nothing runs and no launch is counted."""
    params = REPLAY_CASES["2v2"]
    sf, si, acts = _replay_contact_case(cuda, params, 64)
    monkeypatch.setattr(tfr, "replay_plan", lambda p, n: dict(
        lanes=lanes, threads=threads, slots="shared"))
    before = ops.LAUNCHES["fused_rollout_replay"]
    with pytest.raises(RuntimeError, match="fused_rollout_replay"):
        ops.fused_rollout_replay(sf, si, acts, params)
    assert ops.LAUNCHES["fused_rollout_replay"] == before


# the random rollout's cases: the replay's, the custom params with their noise
ROLLOUT_CASES = {**REPLAY_CASES, "custom": CUSTOM}


def _route_counter(lanes):
    return "fused_rollout" if lanes else "fused_rollout_union"


@pytest.mark.cuda
@pytest.mark.parametrize("draws", ["philox", "table"])
@pytest.mark.parametrize("n_envs", [32 * 7 + 19, 5], ids=["ragged", "small"])
@pytest.mark.parametrize("case", list(ROLLOUT_CASES))
def test_random_lanes_bitwise_on_contact_states(cuda, case, n_envs, draws, monkeypatch):
    """The random rollout on contact states, on every route its plan can
    pick (each lane count G in 2, 4, 8 at 32 and 128 threads a block, one
    thread per env (G = 0, 32 a block), and every layout of the plan's
    table) and the plan's own, drawing from Philox or from a uniforms
    table: bitwise equal to the plain version and to the one-thread
    route (signed zeros compare equal), on a batch that is no multiple of
    32 / G and on one smaller than a block; one launch counted per call,
    under ``fused_rollout`` on G lanes and ``fused_rollout_union`` on one
    thread per env."""
    from gym_futbol_tpu_torch.replay_timing import forced_plan

    params = ROLLOUT_CASES[case]
    sf, si, _ = _replay_contact_case(cuda, params, n_envs)
    if draws == "table":
        gen = torch.Generator(device=cuda).manual_seed(23)
        u = torch.rand((T, tfr.n_draws_per_step(params), n_envs), generator=gen,
                       device=cuda)
        want = tfr.fused_rollout_reference(sf, si, params, uniforms=u)
    else:
        u = None
        want = tfr.fused_rollout_reference(sf, si, params, T, seed=2**31 + 5)
    outs = {}
    for lanes, threads in [(None, None), *REPLAY_ROUTES]:
        if lanes is not None:
            monkeypatch.setattr(tfr, "rollout_plan", forced_plan(tfr, lanes, threads))
        counter = _route_counter(tfr.rollout_plan(params, n_envs)["lanes"])
        before = dict(ops.LAUNCHES)
        got = ops.fused_rollout(sf, si, 2**31 + 5, params, T, uniforms=u)
        torch.cuda.synchronize()
        assert {k: ops.LAUNCHES[k] - before[k] for k in before if ops.LAUNCHES[k] != before[k]} \
            == {counter: 1}
        outs[lanes, threads] = got
        for name, a, b in zip(("statef", "statei", "rewards"), got, want):
            assert torch.equal(a, b), (lanes, threads, name)
    for got in outs.values():
        assert all(torch.equal(a, b) for a, b in zip(got, outs[0, 32]))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes, threads", [(1, 64), (3, 96), (8, 48), (8, 512), (0, 64)],
                         ids=["one-lane", "lanes", "partial-warp", "too-many",
                              "thread-block"])
def test_random_refuses_a_bad_plan(cuda, lanes, threads, monkeypatch):
    """A layout the random rollout's kernel does not take is refused at
    launch and raises; nothing runs and no launch is counted."""
    params = ROLLOUT_CASES["2v2"]
    sf, si, _ = _replay_contact_case(cuda, params, 64)
    monkeypatch.setattr(tfr, "rollout_plan", lambda p, n: dict(
        lanes=lanes, threads=threads, slots="shared"))
    before = dict(ops.LAUNCHES)
    with pytest.raises(RuntimeError, match="fused_rollout"):
        ops.fused_rollout(sf, si, 0, params, T)
    assert ops.LAUNCHES == before


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda):
    params = EnvParams()
    gen = torch.Generator(device=cuda).manual_seed(0)
    state, _ = vector.reset_batch(gen, params, 64, device=cuda)
    sf, si = ops.pack_state(state, params)
    with pytest.raises(ValueError):
        ops.fused_rollout(sf[:, ::2], si[:, ::2], 0, params, 2)  # strided
    p6 = params.replace(players_per_team=6)   # the kernel stops at 5v5
    state6, _ = vector.reset_batch(gen, p6, 64, device=cuda)
    with pytest.raises(ValueError):
        ops.fused_rollout(*ops.pack_state(state6, p6), 0, p6, 2)


# ---------------------------------------------------------------------------
# The policy kernels (fused_collect, fused_selfplay_rollout)
# ---------------------------------------------------------------------------

tfa = importlib.import_module("gym_futbol_tpu_torch.ops.fused_actor")
tfc = importlib.import_module("gym_futbol_tpu_torch.ops.fused_collect")
tpol = importlib.import_module("gym_futbol_tpu_torch.ops._policy")


def _policy_case(cuda, params, hidden, n_envs, seed=3):
    from gym_futbol_tpu_torch.models.policy import ActorCritic

    gen = torch.Generator(device=cuda).manual_seed(seed)
    state, _ = vector.reset_batch(gen, params, n_envs, device=cuda)
    sf, si = ops.pack_state(state, params)
    model = ActorCritic(params.players_per_team, 4 * params.n_bodies + 2,
                        hidden, generator=gen, device=cuda)
    wa = tfa.init_mlp(gen, params, hidden, device=cuda)
    wb = tfa.init_mlp(gen, params, hidden, device=cuda)
    u = torch.rand((T, tfr.n_draws_per_step(params), n_envs), generator=gen,
                   device=cuda)
    return sf, si, tfc.flatten_actor_critic(model), wa, wb, u


def _assert_policy_outputs(got, want):
    """Integers exact; floats within 1e-5 (the two agree bitwise on the
    card in practice: same operations, same order, no FMA)."""
    assert len(got) == len(want)
    for k, p in zip(got, want):
        assert k.device.type == "cuda" and k.shape == p.shape
        if k.dtype.is_floating_point:
            torch.testing.assert_close(k, p, rtol=1e-5, atol=1e-5)
        else:
            assert torch.equal(k, p)


@pytest.mark.cuda
@pytest.mark.parametrize("params,hidden,n_envs", [
    (EnvParams(players_per_team=3, max_steps=6), (64, 48), 1000),
    (CUSTOM, (32, 16), B),
    (EnvParams(players_per_team=2), (128, 128), B),   # the evaluation's widths
], ids=["3v3-ragged", "custom", "2v2-128"])
def test_policy_kernels_match_plain(cuda, params, hidden, n_envs):
    torch.backends.cuda.matmul.allow_tf32 = False
    sf, si, w, wa, wb, u = _policy_case(cuda, params, hidden, n_envs)
    before = dict(ops.LAUNCHES)
    f32 = dict(compute_dtype=torch.float32)      # the exact route
    cases = [
        (ops.fused_collect(sf, si, w, 0, params, T, uniforms=u, **f32),
         tfc.fused_collect_reference(sf, si, w, params, uniforms=u, **f32)),
        (ops.fused_collect(sf, si, w, 41, params, T, **f32),
         tfc.fused_collect_reference(sf, si, w, params, T, seed=41, **f32)),
        (ops.fused_selfplay_rollout(sf, si, wa, wb, 0, params, T, uniforms=u,
                                    return_actions=True, **f32),
         tfa.fused_selfplay_rollout_reference(sf, si, wa, wb, params,
                                              uniforms=u, return_actions=True,
                                              **f32)),
        (ops.fused_selfplay_rollout(sf, si, wa, wb, 42, params, T, **f32),
         tfa.fused_selfplay_rollout_reference(sf, si, wa, wb, params, T,
                                              seed=42, **f32)),
    ]
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_collect_f32"] == before["fused_collect_f32"] + 2
    assert (ops.LAUNCHES["fused_selfplay_rollout_f32"]
            == before["fused_selfplay_rollout_f32"] + 2)
    for got, want in cases:
        _assert_policy_outputs(got, want)
    obs = cases[0][0][2]
    assert (obs[:, 4 * params.n_bodies + 2:] == 0).all()


def _near_ties(kernel_out, plain_out, calls, actions, eps):
    """Envs whose sampled actions all agree with the plain version's, and
    the check that each env's first differing sample is a near tie: its
    uniform within 2 ``eps`` of a boundary of the plain version's CDF
    (its logits and uniforms, per step and view, in ``calls``). Returns
    (agreeing envs [B] bool, near-tie count, mismatched samples)."""
    kd, ka = (kernel_out[i] for i in actions)
    pd, pa = (plain_out[i] for i in actions)
    t, _, b = kd.shape
    n_groups = calls[0][0].shape[0] // 5

    def idx(d, a):                                       # [T, 2, G, B]
        return torch.stack([((d, a)[g % 2] >> (3 * (g // 2))) & 7
                            for g in range(n_groups)], 2)

    differ = idx(kd, ka) != idx(pd, pa)
    bad_step = differ.flatten(1, 2).any(1)
    bad_env = bad_step.any(0)
    first = torch.where(bad_env, bad_step.int().argmax(0), t)
    steps = torch.arange(t, device=kd.device)[:, None]
    logits = torch.stack([c[0] for c in calls]).reshape(t, 2, n_groups, 5, b)
    u = torch.stack([c[1] for c in calls]).reshape(t, 2, n_groups, b)
    cdf = torch.softmax(logits.double(), 3).cumsum(3)[:, :, :, :4]
    margin = (u.double()[:, :, :, None] - cdf).abs().amin(3)
    at_first = differ & (steps == first)[:, None, None, :]
    assert not (at_first & (margin > 2 * eps)).any(), "a differing action is no tie"
    in_window = (steps <= first)[:, None, None, :]
    return ~bad_env, int((in_window & (margin <= 2 * eps)).sum()), int(at_first.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("params,hidden,n_envs,culled", [
    (EnvParams(players_per_team=3, max_steps=6), (64, 48), 1000, False),
    (CUSTOM, (32, 16), B, False),
    (EnvParams(players_per_team=2), (128, 128), B, False),
    (EnvParams(players_per_team=1, max_steps=6), (64, 64), 1000, True),
    (EnvParams(players_per_team=4, max_steps=6), (256, 256), 1000, True),
    (EnvParams(players_per_team=5), (256, 256), 1000, True),
], ids=["3v3-ragged", "custom", "2v2-128", "1v1-ragged", "4v4-256-ragged",
        "5v5-256-ragged"])
def test_policy_kernels_bf16_match_plain(cuda, params, hidden, n_envs, culled,
                                         monkeypatch):
    """The bfloat16 route (tensor cores) against the plain bfloat16
    version on the same uniforms, at test_policy_kernels_match_plain's
    shapes and at 1v1, 4v4 and 5v5: on the envs whose sampled actions all
    agree, logp, value and last_value within 1e-2 (the f32 sums in
    another order, which can move a rounded activation by one bf16 ulp),
    the env's outputs within 1e-5 and integers exact, and exactly where
    K2 runs the culled env step (``culled``, the route that
    ``collect_culls`` reports; the ragged batches leave lanes of the last
    warp without an env); every differing action a near tie (within
    twice the measured logp error of a CDF boundary); the near-tie
    count is reported."""
    assert tfc.collect_culls(params) == culled
    sf, si, w, wa, wb, u = _policy_case(cuda, params, hidden, n_envs)
    before = dict(ops.LAUNCHES)
    got2 = ops.fused_collect(sf, si, w, 0, params, T, uniforms=u)
    got4 = ops.fused_selfplay_rollout(sf, si, wa, wb, 0, params, T, uniforms=u,
                                      return_actions=True)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_collect"] == before["fused_collect"] + 1
    assert (ops.LAUNCHES["fused_selfplay_rollout"]
            == before["fused_selfplay_rollout"] + 1)
    calls2, calls4 = [], []
    sample_with_logp, sample_rows = tpol.sample_with_logp, tfa.sample_rows
    monkeypatch.setattr(tpol, "sample_with_logp", lambda lg, g, uu: (
        calls2.append((lg.clone(), uu.clone())), sample_with_logp(lg, g, uu))[1])
    monkeypatch.setattr(tfa, "sample_rows", lambda lg, g, uu: (
        calls4.append((lg.clone(), uu.clone())), sample_rows(lg, g, uu))[1])
    want2 = tfc.fused_collect_reference(sf, si, w, params, uniforms=u)
    want4 = tfa.fused_selfplay_rollout_reference(sf, si, wa, wb, params,
                                                 uniforms=u, return_actions=True)
    # the log-prob error on envs that agree everywhere sets the tie margin
    agree = (got2[3] == want2[3]).all(0).all(0) & (got2[4] == want2[4]).all(0).all(0)
    eps = (got2[5][..., agree] - want2[5][..., agree]).abs().max().item()
    good2, ties2, miss2 = _near_ties(got2, want2, calls2, (3, 4), eps)
    good4, ties4, miss4 = _near_ties(got4, want4, calls4, (4, 5), eps)
    print(f"near ties: collect {ties2} ({miss2} mismatched), selfplay {ties4} "
          f"({miss4} mismatched), logp error {eps:.3g}")
    for i in (5, 6, 9):                                  # logp, value, last_value
        torch.testing.assert_close(got2[i][..., good2], want2[i][..., good2],
                                   rtol=0, atol=1e-2)
    for got, want, good, env_outs in ((got2, want2, good2, (0, 1, 2, 7, 8)),
                                      (got4, want4, good4, (0, 1, 2, 3))):
        for i in env_outs:
            if got[i].dtype.is_floating_point and not culled:
                torch.testing.assert_close(got[i][..., good], want[i][..., good],
                                           rtol=1e-5, atol=1e-5)
            else:
                assert torch.equal(got[i][..., good], want[i][..., good])
    assert good2.float().mean() > 0.9 and good4.float().mean() > 0.9


@pytest.mark.cuda
def test_policy_kernels_reject_bad_inputs(cuda):
    params = EnvParams(players_per_team=2)
    sf, si, w, wa, wb, _ = _policy_case(cuda, params, (16,), 64)
    with pytest.raises(ValueError):                     # strided state
        ops.fused_collect(sf[:, ::2], si[:, ::2], w, 0, params, 2)
    with pytest.raises(ValueError):
        ops.fused_selfplay_rollout(sf[:, ::2], si[:, ::2], wa, wb, 0, params, 2)
    _, _, w0, _, _, _ = _policy_case(cuda, params, (), 64)
    with pytest.raises(ValueError, match="torso"):      # empty torso
        ops.fused_collect(sf, si, w0, 0, params, 2)
    with pytest.raises(ValueError):                     # mismatched policies
        ops.fused_selfplay_rollout(sf, si, wa, tfa.init_mlp(
            torch.Generator(device=cuda).manual_seed(1), params, (16, 16),
            device=cuda), 0, params, 2)
    p6 = params.replace(players_per_team=6)             # the kernels stop at 5v5
    sf6, si6, w6, wa6, _, _ = _policy_case(cuda, p6, (16,), 64)
    with pytest.raises(ValueError):
        ops.fused_collect(sf6, si6, w6, 0, p6, 2)
    with pytest.raises(ValueError):
        ops.fused_selfplay_rollout(sf6, si6, wa6, wa6, 0, p6, 2)


# ---------------------------------------------------------------------------
# The update kernels (fused_minibatch_grad) and train_iteration
# ---------------------------------------------------------------------------

tfu = importlib.import_module("gym_futbol_tpu_torch.ops.fused_update")
_build = importlib.import_module("gym_futbol_tpu_torch.ops._build")


def _update_case(cuda, ppt, hidden, n_blocks, block, idx, seed=5):
    """A minibatch for fused_minibatch_grad on the card: a module's
    weights, random obs (zero pad rows), in-range packed actions and
    per-sample rows, a normalised advantage, permuted block indices."""
    from gym_futbol_tpu_torch.models.policy import ActorCritic

    gen = torch.Generator(device=cuda).manual_seed(seed)
    f = 4 * (2 * ppt + 1) + 2
    f_pad = -(-f // 8) * 8
    n = n_blocks * block
    model = ActorCritic(ppt, f, hidden, generator=gen, device=cuda)
    obs = torch.zeros(f_pad, n, device=cuda)
    obs[:f] = torch.randn(f, n, generator=gen, device=cuda)

    def packed():
        a = torch.randint(0, 5, (ppt, n_blocks, block), generator=gen,
                          device=cuda, dtype=torch.int32)
        return sum(a[q] << (3 * q) for q in range(ppt)).to(torch.int32)

    def rows(scale=1.0):
        return torch.randn(n_blocks, block, generator=gen, device=cuda) * scale

    idx = torch.tensor(idx, dtype=torch.int32, device=cuda)
    adv = rows()[idx.long()]
    adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    args = (tfc.flatten_actor_critic(model), obs, packed(), packed(),
            -rows().abs() * 2 * ppt, rows(), rows(), adv_n, idx)
    kw = dict(n_torso=len(hidden), clip_eps=0.2, vf_coef=0.5, ent_coef=0.01,
              block=block)
    return args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("ppt,hidden,n_blocks,block,idx", [
    (2, (64, 64), 8, 128, [5, 0, 3]),
    (5, (128, 128), 4, 1024, [3, 1]),        # G = 10: a 64-wide padded head
    (5, (48, 40), 6, 128, [4, 1, 5]),        # widths and G*5 not tile multiples
    (3, (100,), 4, 256, [2, 0, 3]),          # one layer, padded to 128
    (2, (32, 16), 40, 128, list(range(39, 0, -1))),   # 39 blocks: chunks of 4096
    # W2 streamed: 9 blocks of 1024, three chunks, the last a quarter full
    (5, (256, 256), 10, 1024, [9, 2, 7, 0, 4, 1, 8, 5, 3]),
    (4, (256, 256), 6, 1024, [5, 0, 3, 1, 4]),
], ids=["2v2-64-64", "5v5-128-128", "5v5-48-40", "3v3-100", "2v2-32-16",
        "5v5-256-256", "4v4-256-256"])
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-3)],
                         ids=["float32", "bfloat16"])
def test_update_kernels_match_plain(cuda, dtype, rel, ppt, hidden, n_blocks,
                                    block, idx):
    """Permuted minibatches at 2v2 (64, 64), 5v5 (G = 10), widths that
    are not tile multiples and 4v4 / 5v5 at (256, 256) (W2 streamed):
    per leaf rel-L2 within 1e-4 (float32, the CUDA-core chain: sums in
    another order) or 1e-3 (bfloat16, the tensor-core kernels: the same
    rounding points, so the order of the sums and the rare one-ulp flip
    of a rounded operand it causes); metric sums within 1e-4 of the
    larger of the sum and the sample count; two calls identical (no
    atomics); each launch counted under its route."""
    torch.backends.cuda.matmul.allow_tf32 = False
    args, kw = _update_case(cuda, ppt, hidden, n_blocks, block, idx)
    m = len(idx) * block
    route = tfu.update_plan(args[1].shape[0], hidden, args[0][-4].shape[1], m,
                            dtype)["route"]
    assert route == ("tensor_cores" if dtype == torch.bfloat16 else "cuda_cores")
    before = dict(ops.LAUNCHES)
    got = ops.fused_minibatch_grad(*args, **kw, compute_dtype=dtype)
    again = ops.fused_minibatch_grad(*args, **kw, compute_dtype=dtype)
    want = tfu.fused_minibatch_grad_reference(*args, **kw, compute_dtype=dtype)
    torch.cuda.synchronize()
    counted = ("fused_minibatch_grad" if dtype == torch.bfloat16
               else "fused_minibatch_grad_chain")
    assert {k: ops.LAUNCHES[k] - before[k] for k in before} == {
        k: 2 if k == counted else 0 for k in before}
    assert [g.shape for g in got[0]] == [w.shape for w in args[0]]
    for k, p, a in zip(got[0], want[0], again[0]):
        assert k.device.type == "cuda" and torch.isfinite(k).all()
        assert ((k - p).norm() / p.norm()).item() <= rel
        assert torch.equal(k, a)
    n_samples = args[-1].shape[0] * kw["block"]
    for m in tfu.METRICS:
        k, p = got[1][m].item(), want[1][m].item()
        assert abs(k - p) <= 1e-4 * max(abs(p), n_samples), m
        assert torch.equal(got[1][m], again[1][m])


@pytest.mark.cuda
def test_update_streamed_w2_matches_resident(cuda, monkeypatch):
    """At 3v3 (256, 256), where W2 fits in the forward block and stays
    resident, the streamed layout (forced by a shared-memory limit below
    the resident block, 229,504 bytes, and above the streamed one,
    163,968) gives the same bits: the same products in the same order of
    k steps."""
    args, kw = _update_case(cuda, 3, (256, 256), 10, 1024,
                            [9, 2, 7, 0, 4, 1, 8, 5, 3])
    layouts = []
    plan = tfu.update_plan

    def recorded(*a, **k):
        p = plan(*a, **k)
        layouts.append(p["w2_layout"])
        return p

    monkeypatch.setattr(tfu, "update_plan", recorded)
    resident = ops.fused_minibatch_grad(*args, **kw)
    monkeypatch.setattr(_build, "SMEM_BYTES", 200000)
    streamed = ops.fused_minibatch_grad(*args, **kw)
    torch.cuda.synchronize()
    assert layouts == ["resident", "streamed"]
    assert all(torch.equal(a, b) for a, b in zip(resident[0], streamed[0]))
    assert all(torch.equal(resident[1][m], streamed[1][m]) for m in tfu.METRICS)


@pytest.mark.cuda
def test_update_kernels_reject_bad_inputs(cuda):
    """The wrapper refuses what the kernels do not take: strided obs,
    block indices on the host, a head too wide for shared memory."""
    args, kw = _update_case(cuda, 2, (16,), 4, 128, [1, 2])
    w, obs, rest = args[0], args[1], args[2:]
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_minibatch_grad(w, obs.t().contiguous().t(), *rest, **kw)
    with pytest.raises(ValueError, match="device"):
        ops.fused_minibatch_grad(w, obs, *rest[:-1], rest[-1].cpu(), **kw)
    wide, wide_kw = _update_case(cuda, 2, (4096,), 4, 128, [1, 2])
    with pytest.raises(ValueError, match="shared memory"):
        ops.fused_minibatch_grad(*wide, **wide_kw)


@pytest.mark.cuda
def test_train_iteration_on_kernels(cuda):
    """One train_iteration at 2v2, 256 envs, T=8, hidden (32, 32) on the
    collect and update kernels: one collect launch, epochs x minibatches
    update launches, finite metrics, every parameter moved."""
    from gym_futbol_tpu_torch import obs_size, ppo
    from gym_futbol_tpu_torch.models.policy import ActorCritic

    params = EnvParams(players_per_team=2)
    gen = torch.Generator(device=cuda).manual_seed(0)
    model = ActorCritic(2, obs_size(params), (32, 32), device=cuda)
    cfg = ppo.PPOConfig(rollout_steps=8)
    runner = ppo.init_runner(gen, model, params, cfg, B)
    first = [p.detach().clone() for p in model.parameters()]
    before = dict(ops.LAUNCHES)
    runner, metrics = ppo.train_iteration(
        runner, params, cfg, collect_fn=ppo.collect_rollout_fused,
        update_fn=ppo.update_epochs_fused)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_collect"] == before["fused_collect"] + 1
    assert (ops.LAUNCHES["fused_minibatch_grad"]
            == before["fused_minibatch_grad"] + cfg.epochs * cfg.minibatches)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert all(not torch.equal(a, b) for a, b in zip(first, model.parameters()))


# ---------------------------------------------------------------------------
# The recurrent collect (fused_recurrent_collect) and its iteration
# ---------------------------------------------------------------------------

tfrc = importlib.import_module("gym_futbol_tpu_torch.ops.fused_recurrent")


def _recurrent_case(cuda, params, hidden, lstm, n_envs, seed=4):
    """A recurrent actor-critic's flat weights, a reset batch, non-zero
    carries [2, H, B] and a uniforms table on the card."""
    from gym_futbol_tpu_torch.models.recurrent import RecurrentActorCritic

    gen = torch.Generator(device=cuda).manual_seed(seed)
    state, _ = vector.reset_batch(gen, params, n_envs, device=cuda)
    sf, si = ops.pack_state(state, params)
    model = RecurrentActorCritic(params.players_per_team, 4 * params.n_bodies + 2,
                                 hidden, lstm, generator=gen, device=cuda)
    cc, hh = (torch.randn(2, lstm, n_envs, generator=gen, device=cuda) * 0.5
              for _ in range(2))
    u = torch.rand((T, tfr.n_draws_per_step(params), n_envs), generator=gen,
                   device=cuda)
    return sf, si, tfrc.flatten_recurrent_actor_critic(model), cc, hh, u


@pytest.mark.cuda
@pytest.mark.parametrize("params,hidden,lstm,n_envs", [
    (EnvParams(players_per_team=3, max_steps=6), (64,), 32, 1000),
    (CUSTOM, (32, 16), 16, B),
    (EnvParams(players_per_team=2, max_steps=5), (128,), 128, B),
], ids=["3v3-ragged", "custom", "2v2-128"])
def test_recurrent_kernel_matches_plain(cuda, params, hidden, lstm, n_envs):
    """The float32 route (the exact one), table and Philox modes from
    non-zero carries, episodes ending in the window: integers and sampled
    actions exact, floats (the carries among them) within 1e-5; the input
    carries left unchanged."""
    torch.backends.cuda.matmul.allow_tf32 = False
    sf, si, w, cc, hh, u = _recurrent_case(cuda, params, hidden, lstm, n_envs)
    c0, h0 = cc.clone(), hh.clone()
    before = ops.LAUNCHES["fused_recurrent_collect_f32"]
    f32 = dict(compute_dtype=torch.float32)
    cases = [
        (ops.fused_recurrent_collect(sf, si, w, cc, hh, 0, params, T, uniforms=u,
                                     **f32),
         tfrc.fused_recurrent_collect_reference(sf, si, w, cc, hh, params,
                                                uniforms=u, **f32)),
        (ops.fused_recurrent_collect(sf, si, w, cc, hh, 43, params, T, **f32),
         tfrc.fused_recurrent_collect_reference(sf, si, w, cc, hh, params, T,
                                                seed=43, **f32)),
    ]
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_recurrent_collect_f32"] == before + 2
    for got, want in cases:
        _assert_policy_outputs(got, want)
    assert torch.equal(cc, c0) and torch.equal(hh, h0)
    assert cases[0][0][8].any()                          # episode ends
    assert (cases[0][0][2][:, 4 * params.n_bodies + 2:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("params,hidden,lstm,n_envs", [
    (EnvParams(players_per_team=3), (128,), 128, 16384),      # the main shape
    (CUSTOM, (32, 16), 16, B),
    (EnvParams(players_per_team=3, max_steps=6), (64,), 36, 1000),
    (EnvParams(players_per_team=3), (64, 64), 256, 16384),    # MlpLstmPolicy
    (EnvParams(players_per_team=3, max_steps=6), (64, 64), 256, 1000),
], ids=["3v3-main", "custom", "3v3-ragged", "3v3-mlplstm", "3v3-mlplstm-ragged"])
def test_recurrent_kernel_bf16_matches_plain(cuda, params, hidden, lstm, n_envs,
                                            monkeypatch):
    """The bfloat16 route (recurrent_tc_kernel, tensor cores) against the
    plain bfloat16 version on the same uniforms from non-zero carries: on
    the envs whose sampled actions all agree over the window, logp, value,
    last_value and both carries within 1e-2 (the f32 sums in another
    order, which can move a rounded activation by one bf16 ulp), the
    env's outputs within 1e-5 and integers exact; every differing action
    a near tie (within twice the measured logp error of a CDF boundary);
    the input carries unchanged; one launch of the bf16 route."""
    sf, si, w, cc, hh, u = _recurrent_case(cuda, params, hidden, lstm, n_envs)
    c0, h0 = cc.clone(), hh.clone()
    before = dict(ops.LAUNCHES)
    got = ops.fused_recurrent_collect(sf, si, w, cc, hh, 0, params, T, uniforms=u)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_recurrent_collect"] == (
        before["fused_recurrent_collect"] + 1)
    assert ops.LAUNCHES["fused_recurrent_collect_f32"] == (
        before["fused_recurrent_collect_f32"])
    calls = []
    sample_with_logp = tpol.sample_with_logp
    monkeypatch.setattr(tpol, "sample_with_logp", lambda lg, g, uu: (
        calls.append((lg.clone(), uu.clone())), sample_with_logp(lg, g, uu))[1])
    want = tfrc.fused_recurrent_collect_reference(sf, si, w, cc, hh, params,
                                                  uniforms=u)
    agree = (got[3] == want[3]).all(0).all(0) & (got[4] == want[4]).all(0).all(0)
    eps = (got[5][..., agree] - want[5][..., agree]).abs().max().item()
    good, ties, miss = _near_ties(got, want, calls, (3, 4), eps)
    print(f"near ties: {ties} ({miss} mismatched), logp error {eps:.3g}")
    for i in (5, 6, 9, 10, 11):        # logp, value, last_value, carries
        torch.testing.assert_close(got[i][..., good], want[i][..., good],
                                   rtol=0, atol=1e-2)
    for i in (0, 1, 2, 7, 8):          # states, obs, rewards, dones
        if got[i].dtype.is_floating_point:
            torch.testing.assert_close(got[i][..., good], want[i][..., good],
                                       rtol=1e-5, atol=1e-5)
        else:
            assert torch.equal(got[i][..., good], want[i][..., good])
    assert good.float().mean() > 0.9
    assert torch.equal(cc, c0) and torch.equal(hh, h0)


@pytest.mark.cuda
def test_recurrent_kernel_rejects_bad_inputs(cuda):
    params = EnvParams(players_per_team=2)
    sf, si, w, cc, hh, _ = _recurrent_case(cuda, params, (16,), 8, 64)
    with pytest.raises(ValueError, match="contiguous"):   # strided carries
        ops.fused_recurrent_collect(sf, si, w, cc.transpose(1, 2).contiguous()
                                    .transpose(1, 2), hh, 0, params, 2)
    _, _, w6, cc6, hh6, _ = _recurrent_case(cuda, params, (16,), 6, 64)
    with pytest.raises(ValueError, match="multiple of 4"):
        ops.fused_recurrent_collect(sf, si, w6, cc6, hh6, 0, params, 2)
    with pytest.raises(ValueError):                      # carries on the host
        ops.fused_recurrent_collect(sf, si, w, cc.cpu(), hh, 0, params, 2)


@pytest.mark.cuda
def test_recurrent_train_iteration_on_kernel(cuda):
    """One recurrent PPO iteration at 2v2, 256 envs, T=8, hidden (32,),
    H=32 on the collect kernel: one launch, finite metrics, every
    parameter moved."""
    from gym_futbol_tpu_torch import a2c, obs_size
    from gym_futbol_tpu_torch import recurrent_ppo as rppo
    from gym_futbol_tpu_torch.models.recurrent import RecurrentActorCritic

    params = EnvParams(players_per_team=2)
    gen = torch.Generator(device=cuda).manual_seed(0)
    model = RecurrentActorCritic(2, obs_size(params), (32,), 32, device=cuda)
    cfg = rppo.RecurrentPPOConfig(rollout_steps=8)
    runner = rppo.init_recurrent_ppo_runner(gen, model, params, cfg, B)
    first = [p.detach().clone() for p in model.parameters()]
    before = ops.LAUNCHES["fused_recurrent_collect"]
    runner, metrics = rppo.train_iteration_recurrent_ppo(
        runner, params, cfg, collect_fn=a2c.collect_recurrent_rollout_fused)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_recurrent_collect"] == before + 1
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert all(not torch.equal(a, b) for a, b in zip(first, model.parameters()))


# ---------------------------------------------------------------------------
# K6: the recurrent update's LSTM recurrence (ops.fused_bptt)
# ---------------------------------------------------------------------------


def _bptt_case(dev, n_seq, t_len, n_t, hs, seed, p_done=0.02):
    """A torso output in (-1, 1), lecun-scaled cell weights, a bias,
    non-zero carries, episodes ending inside the window and a gradient of
    every h_t of the heads' size."""
    import math

    gen = torch.Generator(device=dev).manual_seed(seed)
    t = torch.tanh(torch.randn(t_len, n_seq, n_t, generator=gen, device=dev))
    std = 1.0 / math.sqrt(n_t + hs)
    w_i = torch.randn(4 * hs, n_t, generator=gen, device=dev) * std
    w_h = torch.randn(4 * hs, hs, generator=gen, device=dev) * std
    b_h = torch.randn(4 * hs, generator=gen, device=dev) * 0.1
    c0 = torch.randn(n_seq, hs, generator=gen, device=dev) * 0.5
    h0 = torch.tanh(torch.randn(n_seq, hs, generator=gen, device=dev))
    done = torch.rand(t_len, n_seq, generator=gen, device=dev) < p_done
    dh = torch.randn(t_len, n_seq, hs, generator=gen, device=dev) * 1e-2
    return t, w_i, w_h, b_h, c0, h0, done, dh


def _rel_max(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8192, 128, 64, 256), (1000, 16, 64, 128)],
                         ids=["cell", "ragged-H128"])
def test_bptt_kernels_match_plain(cuda, shape):
    """K6's forward and backward kernels against their plain versions on
    the card, from non-zero carries with resets inside the window: the
    recurrent PPO cell's minibatch (8192 sequences, T = 128, torso 64, H =
    256) and a ragged 1000 at H = 128. The backward's plain version is
    fed the forward kernel's own saved state; h_{t-1} and dgates are
    read as the sums of their two bf16 terms. Bounds (largest over the
    max of the plain output): forward and h_{t-1} 1e-4, dgates 1e-3: both
    sides take the same split products (hi + lo, about 2^-16), and part
    only by float32 sums in another order and the hardware exponential;
    a kernel that lost a product's low terms reads bf16's 9e-4 (gates)
    and 4e-3 (dgates) here."""
    from gym_futbol_tpu_torch import ops

    fb = importlib.import_module("gym_futbol_tpu_torch.ops.fused_bptt")
    n_seq, t_len, n_t, hs = shape
    t, w_i, w_h, b_h, c0, h0, done, dh = _bptt_case(cuda, n_seq, t_len, n_t, hs, 1)
    assert done.any()
    d8 = done.to(torch.uint8)
    before = ops.LAUNCHES["fused_lstm_bptt"]
    (kg, kc, kh, khp, kcl, khl), bwd = fb._forward_kernel(fb._split(t), w_i, w_h, b_h,
                                                           c0, h0, d8)
    pg, pc, ph, php, pcl, phl = fb.bptt_forward_reference(t, w_i, w_h, b_h, c0, h0, d8)
    kd = fb._backward_kernel(kg, kc, c0, d8, dh, bwd)
    pd = fb.bptt_backward_reference(fb.fragment_rows(kg, n_seq, hs).contiguous(),
                                    fb.fragment_rows(kc, n_seq, hs).contiguous(),
                                    c0, d8, dh, w_h)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_lstm_bptt"] == before + 2
    for got, want in ((fb.fragment_rows(kg, n_seq, hs), pg),
                      (fb.fragment_rows(kc, n_seq, hs), pc), (kh, ph), (kcl, pcl),
                      (khl, phl), (khp[0].float() + khp[1].float(), php)):
        assert torch.isfinite(got).all() and _rel_max(got, want) <= 1e-4
    kd = kd[0].float() + kd[1].float()      # dgates' two bf16 terms
    assert torch.isfinite(kd).all() and _rel_max(kd, pd) <= 1e-3


@pytest.mark.cuda
def test_bptt_function_matches_host(cuda):
    """The whole autograd node on the card (the kernels, then the weight
    gradients as split bf16 products on cuBLAS) against the same node on the
    host (the plain versions): h of every step, the carry after the
    window and the gradients of t and the three weights, 256 sequences,
    T = 16, H = 128. h within 1e-4 of its max and gradients per tensor
    within 1e-3 relative (L2), as above."""
    fb = importlib.import_module("gym_futbol_tpu_torch.ops.fused_bptt")
    case = _bptt_case(cuda, 256, 16, 64, 128, 2, p_done=0.05)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        t, w_i, w_h, b_h, c0, h0, done, dh = (x.to(dev) for x in case)
        leaves = [x.clone().requires_grad_(True) for x in (t, w_i, w_h, b_h)]
        h_all, carry = fb.fused_lstm_bptt(*leaves, (c0, h0), done)
        grads = torch.autograd.grad((h_all * dh).sum(), leaves)
        outs.append([x.detach().cpu() for x in (h_all, *carry, *grads)])
    for k, (got, want) in enumerate(zip(*outs)):
        if k < 3:
            assert _rel_max(got, want) <= 1e-4
        else:
            assert ((got - want).norm() / want.norm()).item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("hs", [6, 260])
def test_bptt_refuses_shapes(cuda, hs):
    """H not a multiple of 4 or 4H over 1024: the card's route raises,
    naming the float32 route, before any launch."""
    fb = importlib.import_module("gym_futbol_tpu_torch.ops.fused_bptt")
    from gym_futbol_tpu_torch import ops

    t, w_i, w_h, b_h, c0, h0, done, _ = _bptt_case(cuda, 8, 2, 16, hs, 3)
    before = ops.LAUNCHES["fused_lstm_bptt"]
    with pytest.raises(ValueError, match=r"compute_dtype=torch\.float32"):
        fb.fused_lstm_bptt(t, w_i, w_h, b_h, (c0, h0), done)
    assert ops.LAUNCHES["fused_lstm_bptt"] == before


@pytest.mark.cuda
def test_recurrent_update_on_bptt_kernels(cuda):
    """One ``update_epochs_recurrent`` call on its default route, 2 epochs
    x 2 minibatches: K6's launches advance by 2 a minibatch, each
    forward and backward is the span ``ops.fused_lstm_bptt``; finite
    metrics, every parameter moved."""
    from torch.autograd import DeviceType

    from gym_futbol_tpu_torch import obs_size, ops, ppo
    from gym_futbol_tpu_torch import recurrent_ppo as rppo
    from gym_futbol_tpu_torch.models.recurrent import RecurrentActorCritic

    params = EnvParams(players_per_team=2)
    gen = torch.Generator(device=cuda).manual_seed(4)
    model = RecurrentActorCritic(2, obs_size(params), (32,), 32, generator=gen, device=cuda)
    cfg = rppo.RecurrentPPOConfig(rollout_steps=8, epochs=2, minibatches=2, shuffle_block=64)
    t_len, s = 8, 256
    idx = torch.randint(0, 5, (t_len, s, 4), generator=gen, device=cuda)
    traj = ppo.Transition(
        obs=torch.rand(t_len, s, obs_size(params), generator=gen, device=cuda),
        dirs=(idx[..., 0] + (idx[..., 2] << 3)).int(),
        acts=(idx[..., 1] + (idx[..., 3] << 3)).int(),
        logp=-torch.rand(t_len, s, generator=gen, device=cuda) * 4 - 2,
        value=torch.randn(t_len, s, generator=gen, device=cuda),
        reward=torch.randn(t_len, s, generator=gen, device=cuda),
        done=torch.rand(t_len, s, generator=gen, device=cuda) < 0.1)
    adv, ret = (torch.randn(t_len, s, generator=gen, device=cuda) for _ in range(2))
    carry = tuple(torch.randn(s, 32, generator=gen, device=cuda) * 0.3 for _ in range(2))
    first = [p.detach().clone() for p in model.parameters()]
    before = ops.LAUNCHES["fused_lstm_bptt"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        metrics = rppo.update_epochs_recurrent(
            model, rppo.make_optimizer(model, cfg), traj, carry, adv, ret, gen, cfg)
        torch.cuda.synchronize()
    n_mb = cfg.epochs * cfg.minibatches
    assert ops.LAUNCHES["fused_lstm_bptt"] == before + 2 * n_mb
    spans = [e for e in prof.events() if e.name == "ops.fused_lstm_bptt"
             and e.device_type == DeviceType.CPU]
    assert len(spans) == 2 * n_mb
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert all(not torch.equal(a, b) for a, b in zip(first, model.parameters()))


# ---------------------------------------------------------------------------
# LayerNorm: K6's and K5's LayerNorm instantiations
# ---------------------------------------------------------------------------


def _ln_leaves(dev, hs, gen, spread=0.1):
    """Seeded LayerNorm leaves (gx, bx, gh, bh [4H], gc, bc [H]): gains
    about 1, biases about 0."""
    sizes = (4 * hs,) * 4 + (hs,) * 2
    return [(1.0 if k % 2 == 0 else 0.0)
            + spread * torch.randn(n, generator=gen, device=dev) for k, n in enumerate(sizes)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8192, 128, 64, 256), (1000, 16, 64, 100)],
                         ids=["cell", "ragged-padded-H100"])
def test_bptt_ln_kernels_match_plain(cuda, shape):
    """K6's LayerNorm instantiations against their plain versions on the
    card, from non-zero (and seven zero) carries with resets inside the
    window, at the LayerNorm cell's minibatch (8192 sequences, T = 128, H
    = 256) and a ragged 1000 at H = 100 (padded to 112: the padded units
    out of every statistic). Both sides take the same gates' input side.
    At these random weights the layer-normalised recurrence is chaotic (a
    difference in h grows ~1.12x a step, the plain versions alone: PERF.md
    §6), so two roundings part by O(1) over 128 steps: the forward's plain
    version is teacher-forced, each step run from the kernel's own carry
    of the step before; the backward's is fed the kernel's saved state of
    the window's first 4 steps (its dh recurrence grows the same way).
    Bounds as K6's plain route's (largest over the max of the plain
    output): forward, y and the statistics 1e-4, dpre, dy and dn 1e-3 (the
    same split products, float32 sums in another order, the hardware
    exponential)."""
    from gym_futbol_tpu_torch import ops
    from gym_futbol_tpu_torch.ops._policy import unit_major

    fb = importlib.import_module("gym_futbol_tpu_torch.ops.fused_bptt")
    n_seq, t_len, n_t, hs = shape
    t, w_i, w_h, b_h, c0, h0, done, dh = _bptt_case(cuda, n_seq, t_len, n_t, hs, 1)
    gen = torch.Generator(device=cuda).manual_seed(7)
    gx, bx, gh, bh, gc, bc = _ln_leaves(cuda, hs, gen)
    c0[:7] = 0.0
    h0[:7] = 0.0                      # zero carries: h Wh a zero row
    a = torch.tanh(torch.randn(t_len, n_seq, hs, 4, generator=gen, device=cuda))
    d8 = done.to(torch.uint8)
    ghu, bhu = unit_major(gh).reshape(hs, 4), unit_major(bh).reshape(hs, 4)
    before = dict(ops.LAUNCHES)
    kout, bwd = fb._ln_forward_kernel(a, w_h, (gh, bh, gc, bc), c0, h0, d8)
    kg, kc, kh, khp, ky, ksh, ksc, kcl, khl = kout
    rows = [fb.fragment_rows(kg, n_seq, hs).contiguous(),
            fb.fragment_rows(kc, n_seq, hs).contiguous()]
    keep = (1.0 - done.float())[..., None]
    pout, c, h = [], c0, h0
    for k in range(t_len):            # each step from the kernel's carry
        pout.append(fb.bptt_ln_forward_reference(a[k:k + 1], w_h, ghu, bhu, gc, bc, c, h,
                                                 d8[k:k + 1]))
        c, h = rows[1][k] * keep[k], kh[k] * keep[k]
    pg, pc, ph, php, py, psh, psc = (torch.cat([p[i] for p in pout]) for i in range(7))
    assert (ky[0, :7] == 0).all() and (ksh[0, :7, 0] == 0).all()   # y a zero row
    for got, want in ((rows[0], pg), (rows[1], pc), (kh, ph), (kcl, pout[-1][7]),
                      (khl, pout[-1][8]), (khp[0].float() + khp[1].float(), php), (ky, py),
                      (ksh, psh), (ksc, psc)):
        assert torch.isfinite(got).all() and _rel_max(got, want) <= 1e-4
    w4 = 4
    kd = fb._ln_backward_kernel(kg[:w4], kc[:w4], ky[:w4], ksh[:w4], ksc[:w4], c0, d8[:w4],
                                dh[:w4], bwd, ghu.contiguous(), gc, bc)
    pd = fb.bptt_ln_backward_reference(rows[0][:w4], rows[1][:w4], ky[:w4], ksh[:w4],
                                       ksc[:w4], c0, d8[:w4], dh[:w4], w_h, ghu, gc, bc)
    torch.cuda.synchronize()
    assert {k: ops.LAUNCHES[k] - before[k] for k in before if ops.LAUNCHES[k] != before[k]} \
        == {"fused_lnlstm_bptt": 2}
    dpre, dy, dn = kd
    for got, want in ((dpre, pd[0]), (dy[0].float() + dy[1].float(), pd[1]), (dn, pd[2])):
        assert torch.isfinite(got).all() and _rel_max(got, want) <= 1e-3


@pytest.mark.cuda
def test_bptt_ln_function_matches_host(cuda):
    """The LayerNorm autograd node on the card (t Wi and its LayerNorm, the
    kernels, LayerNorm's backward and the split products) against the
    same node on the host: h of every step, the carry after the window
    and the gradients of t, the three weights and the six LayerNorm leaves,
    256 sequences, T = 16, H = 100 (padded). h within 1e-4 of its max,
    gradients per tensor within 1e-3 relative (L2), as K6's plain node."""
    fb = importlib.import_module("gym_futbol_tpu_torch.ops.fused_bptt")
    case = _bptt_case(cuda, 256, 16, 64, 100, 2, p_done=0.05)
    ln = _ln_leaves(cuda, 100, torch.Generator(device=cuda).manual_seed(3))
    outs = []
    for dev in (cuda, torch.device("cpu")):
        t, w_i, w_h, b_h, c0, h0, done, dh = (x.to(dev) for x in case)
        leaves = [x.clone().requires_grad_(True) for x in (t, w_i, w_h, b_h)]
        lnl = [x.to(dev).clone().requires_grad_(True) for x in ln]
        h_all, carry = fb.fused_lnlstm_bptt(*leaves, lnl, (c0, h0), done)
        grads = torch.autograd.grad((h_all * dh).sum(), leaves + lnl)
        outs.append([x.detach().cpu() for x in (h_all, *carry, *grads)])
    for k, (got, want) in enumerate(zip(*outs)):
        if k < 3:
            assert _rel_max(got, want) <= 1e-4
        else:
            assert ((got - want).norm() / want.norm()).item() <= 1e-3


def _ln_tail_case(dev, n_seq, t_len, hs, seed):
    """The tail's inputs as the node holds them: dpre, y ``[T, S, H, 4]``,
    x ``[T S, 4H]`` with its LayerNorm statistics, y's and c''s
    statistics ``[T, S, 2]`` from their rows, dn ``[T, S, H]``, c' in the
    forward kernel's fragment order (the padded units and rows past S
    holding noise, which the kernel must not read), the gains and biases
    ``[4H]`` unit-major and ``[H]``."""
    fb = importlib.import_module("gym_futbol_tpu_torch.ops.fused_bptt")
    from gym_futbol_tpu_torch.ops._policy import ln_stats

    gen = torch.Generator(device=dev).manual_seed(seed)
    n, hp, nblk = t_len * n_seq, -(-hs // 16) * 16, -(-n_seq // 64)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale + shift

    dpre, y = randn(t_len, n_seq, hs, 4, scale=1e-2), randn(t_len, n_seq, hs, 4, shift=0.2)
    x = randn(n, 4 * hs, scale=0.7, shift=0.1)
    dn = randn(t_len, n_seq, hs, scale=1e-2)
    c_frag = randn(t_len, nblk, hp // 8, 8, 32, 2, scale=0.5, shift=0.1)
    gxu, bxu, ghu = randn(4 * hs, scale=0.1, shift=1.0), randn(4 * hs, scale=0.1), \
        randn(4 * hs, scale=0.1, shift=1.0)
    gc, bc = randn(hs, scale=0.1, shift=1.0), randn(hs, scale=0.1)
    _, mux, rx = torch.native_layer_norm(x, [4 * hs], gxu, bxu, 1e-5)
    st_h = torch.cat(ln_stats(y, (2, 3)), -1).reshape(t_len, n_seq, 2)
    c_rows = fb.fragment_rows(c_frag, n_seq, hs).contiguous()
    st_c = torch.cat(ln_stats(c_rows, (2,)), -1)
    return dpre, x, mux, rx, gxu, bxu, y, st_h, ghu, dn, c_frag, c_rows, st_c, gc, bc


@pytest.mark.cuda
@pytest.mark.parametrize("n_seq,t_len,hs", [(2048, 8, 256), (1000, 3, 100), (333, 3, 64)],
                         ids=["cell-H256", "padded-H100", "ragged-rows-H64"])
def test_ln_tail_kernel_matches_float64(cuda, n_seq, t_len, hs):
    """LayerNorm's backward tail kernel (``csrc/lnlstm_tail.cu``) and its
    plain version ``ln_tail_reference`` (PyTorch's float32
    ``native_layer_norm_backward``) against the same tail in float64 on
    the card: the cell's H = 256 over 16384 rows, H = 100 (padded to 112:
    the padded units out of c''s sums) over 1000 sequences (ragged
    fragment blocks), and H = 64 over 999 rows (four rows a block: not a
    multiple). dx's hi + lo and each of the five parameter gradients
    (dgx, db, dgh, dgc, dbc) within twice PyTorch's error, or 1e-6
    relative (L2), whichever is larger: the same float32 work, its sums in
    another order. hi and lo are the bf16 split of the kernel's own f32
    dx bit for bit; two runs, and a run that also writes the f32 dx, are
    bitwise equal; one launch counted under ``lnlstm_tail``."""
    fb = importlib.import_module("gym_futbol_tpu_torch.ops.fused_bptt")
    (dpre, x, mux, rx, gxu, bxu, y, st_h, ghu, dn, c_frag, c_rows, st_c, gc,
     bc) = _ln_tail_case(cuda, n_seq, t_len, hs, 11)
    n = t_len * n_seq
    rows = (dpre.reshape(n, 4 * hs), x, y.reshape(n, 4 * hs), st_h.reshape(n, 2),
            dn.reshape(n, hs), c_rows.reshape(n, hs), st_c.reshape(n, 2))
    d, xx, yy, sh, dd, cc, sc = (z.double() for z in rows)
    xhat = (xx - mux.double()) * rx.double()
    gd = gxu.double() * d
    want = [rx.double() * (gd - gd.mean(1, keepdim=True)
                           - xhat * (gd * xhat).mean(1, keepdim=True)),
            (d * xhat).sum(0), d.sum(0), (d * (yy - sh[:, :1]) * sh[:, 1:]).sum(0),
            (dd * (cc - sc[:, :1]) * sc[:, 1:]).sum(0), dd.sum(0)]
    plain = fb.ln_tail_reference(rows[0], x, mux, rx, gxu, bxu, rows[2], rows[3], ghu,
                                 rows[4], rows[5], rows[6], gc, bc)
    before = ops.LAUNCHES["lnlstm_tail"]
    dx32 = torch.empty(n, 4 * hs, device=cuda)
    runs = [fb._ln_tail_kernel(dpre, x, mux, rx, gxu, y, st_h, dn, c_frag, st_c, dx32=z)
            for z in (None, None, dx32)]
    torch.cuda.synchronize()
    assert ops.LAUNCHES["lnlstm_tail"] == before + 3

    def flat(out):
        return [out[0][0].double() + out[0][1].double(), *(z.double() for z in out[1:])]

    def rel(got, ref):
        return ((got - ref).norm() / ref.norm()).item()

    for name, got, pt, ref in zip(("dx", "dgx", "db", "dgh", "dgc", "dbc"), flat(runs[0]),
                                  flat(plain), want):
        assert torch.isfinite(got).all()
        assert rel(got, ref) <= max(2.0 * rel(pt, ref), 1e-6), (name, rel(got, ref),
                                                                 rel(pt, ref))
    hi, lo = runs[0][0]
    assert torch.equal(hi, dx32.bfloat16())
    assert torch.equal(lo, (dx32 - hi.float()).bfloat16())
    for other in runs[1:]:
        assert torch.equal(other[0][0], hi) and torch.equal(other[0][1], lo)
        assert all(torch.equal(a, b) for a, b in zip(other[1:], runs[0][1:]))


@pytest.mark.cuda
@pytest.mark.parametrize("hs", [6, 260])
def test_bptt_ln_refuses_shapes(cuda, hs):
    """The LayerNorm route refuses what K6 refuses, naming the float32
    route, before any launch."""
    fb = importlib.import_module("gym_futbol_tpu_torch.ops.fused_bptt")
    from gym_futbol_tpu_torch import ops

    t, w_i, w_h, b_h, c0, h0, done, _ = _bptt_case(cuda, 8, 2, 16, hs, 3)
    ln = _ln_leaves(cuda, hs, torch.Generator(device=cuda).manual_seed(3))
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match=r"compute_dtype=torch\.float32"):
        fb.fused_lnlstm_bptt(t, w_i, w_h, b_h, ln, (c0, h0), done)
    assert ops.LAUNCHES == before


T_LN = 3      # K5's LayerNorm test's steps


def _ln_model_case(cuda, params, hidden, lstm, n_envs, seed=5):
    from gym_futbol_tpu_torch.models.recurrent import RecurrentActorCritic

    gen = torch.Generator(device=cuda).manual_seed(seed)
    state, _ = vector.reset_batch(gen, params, n_envs, device=cuda)
    sf, si = ops.pack_state(state, params)
    model = RecurrentActorCritic(params.players_per_team, 4 * params.n_bodies + 2,
                                 hidden, lstm, generator=gen, device=cuda, layer_norm=True)
    with torch.no_grad():
        for ln, v in zip(model.layer_norms(), (0.1, 0.1, 0.1)):
            ln.weight.add_(v * torch.randn(ln.weight.shape, generator=gen, device=cuda))
            ln.bias.add_(v * torch.randn(ln.bias.shape, generator=gen, device=cuda))
        model.cell_h.bias.normal_(0.0, 0.1, generator=gen)
    cc, hh = (torch.randn(2, lstm, n_envs, generator=gen, device=cuda) * 0.5
              for _ in range(2))
    cc[:, :, :5] = 0.0
    hh[:, :, :5] = 0.0                 # zero carries
    u = torch.rand((T, tfr.n_draws_per_step(params), n_envs), generator=gen, device=cuda)
    return sf, si, model, cc, hh, u


@pytest.mark.cuda
@pytest.mark.parametrize("params,hidden,lstm,n_envs", [
    (EnvParams(players_per_team=3), (64, 64), 256, 16384),    # MlpLnLstmPolicy
    (EnvParams(players_per_team=3, max_steps=6), (64, 64), 100, 1000),
    (CUSTOM, (32, 16), 12, B),
], ids=["3v3-mlplnlstm", "3v3-ragged-H100", "custom-H12"])
def test_recurrent_ln_kernel_matches_plain(cuda, params, hidden, lstm, n_envs,
                                           monkeypatch):
    """K5's LayerNorm instantiation (recurrent_ln_tc_kernel) against the
    plain bfloat16 version with the same LayerNorm on the same uniforms,
    from non-zero and zero carries, by the plain K5 bf16 test's rules
    and bounds, over 3 steps (T_LN): a bf16 rounding that falls the other
    way moves a normalised row by its share of the row's deviation, and
    the chaotic recurrence (PERF.md §6) grows it past 1e-2 within 9 steps
    on a few of 16384 envs; padded units (H 100 and 12) out of the
    statistics; one launch, under the LayerNorm route's own counter."""
    sf, si, model, cc, hh, u = _ln_model_case(cuda, params, hidden, lstm, n_envs)
    u = u[:T_LN]
    w, ln = tfrc.flatten_recurrent_actor_critic(model), tfrc.layer_norm_leaves(model)
    c0, h0 = cc.clone(), hh.clone()
    before = dict(ops.LAUNCHES)
    got = ops.fused_recurrent_collect(sf, si, w, cc, hh, 0, params, T_LN, uniforms=u, ln=ln)
    torch.cuda.synchronize()
    assert {k: ops.LAUNCHES[k] - before[k] for k in before if ops.LAUNCHES[k] != before[k]} \
        == {"fused_recurrent_collect_ln": 1}
    calls = []
    sample_with_logp = tpol.sample_with_logp
    monkeypatch.setattr(tpol, "sample_with_logp", lambda lg, g, uu: (
        calls.append((lg.clone(), uu.clone())), sample_with_logp(lg, g, uu))[1])
    want = tfrc.fused_recurrent_collect_reference(sf, si, w, cc, hh, params, uniforms=u,
                                                  ln=ln)
    agree = (got[3] == want[3]).all(0).all(0) & (got[4] == want[4]).all(0).all(0)
    eps = (got[5][..., agree] - want[5][..., agree]).abs().max().item()
    good, ties, miss = _near_ties(got, want, calls, (3, 4), eps)
    print(f"near ties: {ties} ({miss} mismatched), logp error {eps:.3g}")
    for i in (5, 6, 9, 10, 11):
        torch.testing.assert_close(got[i][..., good], want[i][..., good], rtol=0, atol=1e-2)
    for i in (0, 1, 2, 7, 8):
        if got[i].dtype.is_floating_point:
            torch.testing.assert_close(got[i][..., good], want[i][..., good],
                                       rtol=1e-5, atol=1e-5)
        else:
            assert torch.equal(got[i][..., good], want[i][..., good])
    assert good.float().mean() > 0.9
    assert torch.equal(cc, c0) and torch.equal(hh, h0)


@pytest.mark.cuda
def test_recurrent_ln_float32_route_refused(cuda):
    """The float32 route has no LayerNorm: it raises, naming the route and
    the bfloat16 one, before any launch."""
    params = EnvParams(players_per_team=2)
    sf, si, model, cc, hh, _ = _ln_model_case(cuda, params, (16,), 8, 64)
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match=r"float32 route.*compute_dtype=torch\.bfloat16"):
        ops.fused_recurrent_collect(sf, si, tfrc.flatten_recurrent_actor_critic(model), cc,
                                    hh, 0, params, 2, compute_dtype=torch.float32,
                                    ln=tfrc.layer_norm_leaves(model))
    assert ops.LAUNCHES == before


@pytest.mark.cuda
def test_recurrent_ln_train_iteration_on_kernels(cuda):
    """One recurrent PPO iteration of the layer-normalised model at 2v2,
    256 envs, T=8, hidden (32,), H=32 on the main path: K5's LayerNorm
    instantiation collects (one launch), K6's updates (two a minibatch)
    and LayerNorm's backward tail runs (one a minibatch), each counted
    under the LayerNorm route's own counter and no other,
    finite metrics, every parameter moved (the six LayerNorm leaves
    among them)."""
    from gym_futbol_tpu_torch import a2c, obs_size
    from gym_futbol_tpu_torch import recurrent_ppo as rppo
    from gym_futbol_tpu_torch.models.recurrent import RecurrentActorCritic

    params = EnvParams(players_per_team=2)
    gen = torch.Generator(device=cuda).manual_seed(0)
    model = RecurrentActorCritic(2, obs_size(params), (32,), 32, device=cuda,
                                 layer_norm=True)
    cfg = rppo.RecurrentPPOConfig(rollout_steps=8, shuffle_block=64)
    runner = rppo.init_recurrent_ppo_runner(gen, model, params, cfg, B)
    first = [p.detach().clone() for p in model.parameters()]
    before = dict(ops.LAUNCHES)
    runner, metrics = rppo.train_iteration_recurrent_ppo(
        runner, params, cfg, collect_fn=a2c.collect_recurrent_rollout_fused)
    torch.cuda.synchronize()
    assert {k: ops.LAUNCHES[k] - before[k] for k in before if ops.LAUNCHES[k] != before[k]} \
        == {"fused_recurrent_collect_ln": 1,
            "fused_lnlstm_bptt": 2 * cfg.epochs * cfg.minibatches,
            "lnlstm_tail": cfg.epochs * cfg.minibatches}
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert all(not torch.equal(a, b) for a, b in zip(first, model.parameters()))
