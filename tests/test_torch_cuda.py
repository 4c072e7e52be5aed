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
and sampled actions exact, floats 1e-5.
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
