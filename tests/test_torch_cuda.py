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
custom params and 2v2 with the evaluation's (128, 128) MLPs: integers
and sampled actions exact, floats 1e-5. The update kernels at 2v2
(64, 64) in both modes (per leaf rel-L2, bounds with their reasons at
the test) and one train_iteration on the collect and update kernels.
The recurrent collect in table and Philox modes from non-zero carries
(3v3 ragged, custom, 2v2 at H = 128): integers and sampled actions
exact, floats and carries 1e-5, the input carries unchanged; one
recurrent PPO iteration on it.
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
    cases = [
        (ops.fused_collect(sf, si, w, 0, params, T, uniforms=u),
         tfc.fused_collect_reference(sf, si, w, params, uniforms=u)),
        (ops.fused_collect(sf, si, w, 41, params, T),
         tfc.fused_collect_reference(sf, si, w, params, T, seed=41)),
        (ops.fused_selfplay_rollout(sf, si, wa, wb, 0, params, T, uniforms=u,
                                    return_actions=True),
         tfa.fused_selfplay_rollout_reference(sf, si, wa, wb, params,
                                              uniforms=u, return_actions=True)),
        (ops.fused_selfplay_rollout(sf, si, wa, wb, 42, params, T),
         tfa.fused_selfplay_rollout_reference(sf, si, wa, wb, params, T,
                                              seed=42)),
    ]
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_collect"] == before["fused_collect"] + 2
    assert (ops.LAUNCHES["fused_selfplay_rollout"]
            == before["fused_selfplay_rollout"] + 2)
    for got, want in cases:
        _assert_policy_outputs(got, want)
    obs = cases[0][0][2]
    assert (obs[:, 4 * params.n_bodies + 2:] == 0).all()


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
], ids=["2v2-64-64", "5v5-128-128", "5v5-48-40", "3v3-100", "2v2-32-16"])
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-3)],
                         ids=["float32", "bfloat16"])
def test_update_kernels_match_plain(cuda, dtype, rel, ppt, hidden, n_blocks,
                                    block, idx):
    """Permuted minibatches at 2v2 (64, 64), 5v5 (G = 10) and widths that
    are not tile multiples: per leaf rel-L2 within 1e-4 (float32, the
    CUDA-core chain: sums in another order) or 1e-3 (bfloat16, the
    tensor-core kernels: the same rounding points, so the order of the
    sums and the rare one-ulp flip of a rounded operand it causes);
    metric sums within 1e-4 of the larger of the sum and the sample
    count; two calls identical (no atomics)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    args, kw = _update_case(cuda, ppt, hidden, n_blocks, block, idx)
    m = len(idx) * block
    route = tfu.update_plan(args[1].shape[0], hidden, args[0][-4].shape[1], m,
                            dtype)["route"]
    assert route == ("tensor_cores" if dtype == torch.bfloat16 else "cuda_cores")
    before = ops.LAUNCHES["fused_minibatch_grad"]
    got = ops.fused_minibatch_grad(*args, **kw, compute_dtype=dtype)
    again = ops.fused_minibatch_grad(*args, **kw, compute_dtype=dtype)
    want = tfu.fused_minibatch_grad_reference(*args, **kw, compute_dtype=dtype)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_minibatch_grad"] == before + 2
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
    """Table and Philox modes from non-zero carries, episodes ending in
    the window: integers and sampled actions exact, floats (the carries
    among them) within 1e-5; the input carries left unchanged."""
    torch.backends.cuda.matmul.allow_tf32 = False
    sf, si, w, cc, hh, u = _recurrent_case(cuda, params, hidden, lstm, n_envs)
    c0, h0 = cc.clone(), hh.clone()
    before = ops.LAUNCHES["fused_recurrent_collect"]
    cases = [
        (ops.fused_recurrent_collect(sf, si, w, cc, hh, 0, params, T, uniforms=u),
         tfrc.fused_recurrent_collect_reference(sf, si, w, cc, hh, params,
                                                uniforms=u)),
        (ops.fused_recurrent_collect(sf, si, w, cc, hh, 43, params, T),
         tfrc.fused_recurrent_collect_reference(sf, si, w, cc, hh, params, T,
                                                seed=43)),
    ]
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_recurrent_collect"] == before + 2
    for got, want in cases:
        _assert_policy_outputs(got, want)
    assert torch.equal(cc, c0) and torch.equal(hh, h0)
    assert cases[0][0][8].any()                          # episode ends
    assert (cases[0][0][2][:, 4 * params.n_bodies + 2:] == 0).all()


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
