"""The plain reference against the program's plain versions on the host,
at small sizes: the env step bit for bit (the host's float32 square root
on both sides), the PPO loss and its gradients to float32 rounding."""

import pytest
import torch

from futbench import counts
from futbench.reference import env as ref_env
from futbench.reference import ppo as ref_ppo

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def host_sqrt():
    ref_env.exact_sqrt(False)
    yield
    ref_env.exact_sqrt(True)


@pytest.mark.parametrize("ppt, n_envs, n_steps, max_steps", [
    (2, 48, 24, 10), (3, 24, 8, 300), (5, 16, 6, 4)])
def test_rollout_matches_the_program_bitwise(ppt, n_envs, n_steps, max_steps):
    from gym_futbol_tpu_torch import EnvParams
    from gym_futbol_tpu_torch.ops.fused_rollout import fused_rollout_reference

    p = ref_env.Params.from_config(ppt, {"max_steps": max_steps})
    sf, si = ref_env.initial_state(torch.Generator().manual_seed(ppt), p, n_envs, "cpu")
    want = fused_rollout_reference(sf, si, EnvParams(players_per_team=ppt,
                                                     max_steps=max_steps),
                                   n_steps, seed=2**31 + 5)
    envs = torch.tensor([0, 3, n_envs - 1])
    got = ref_env.random_rollout(sf[:, envs], si[:, envs], 2**31 + 5, p, n_steps, envs)
    for a, b in zip(got, want):
        assert torch.equal(a, b[:, envs])


def test_exact_sqrt_is_the_nearest_float():
    x = torch.rand(100000, dtype=torch.float64).float() * 1e5
    ref_env.exact_sqrt(True)
    exact = ref_env._sqrt(x)
    assert torch.equal(exact, torch.sqrt(x.double()).float())


def test_ppo_loss_and_grads_match_the_program():
    from gym_futbol_tpu_torch import ppo
    from gym_futbol_tpu_torch.models.policy import ActorCritic

    torch.manual_seed(0)
    model = ActorCritic(2, 22, (16, 16), device="cpu")
    n = 256
    obs = torch.rand(24, n)
    idx = torch.randint(0, 5, (n, 4))      # 2 players a team, 2 slots each
    dirs = sum(idx[:, 2 * q] << (3 * q) for q in range(2)).int()
    acts = sum(idx[:, 2 * q + 1] << (3 * q) for q in range(2)).int()
    logp_old, value_old = -torch.rand(n) * 5, torch.randn(n)
    adv, ret = torch.randn(n), torch.randn(n)
    cfg = ppo.PPOConfig()
    loss, _ = ppo.ppo_loss(model, obs, dirs, acts, logp_old, value_old, adv, ret, cfg)
    loss.backward()
    w = [x.detach() for layer in model.dense_layers() for x in (layer.weight.T, layer.bias)]
    w = [x.clone().requires_grad_(True) for x in w]
    ref = ref_ppo.ppo_loss(w, obs[:22].T, ref_ppo.unpack(dirs, acts, 4), logp_old,
                           value_old, adv, ret, vars(cfg), "f32")
    grads = torch.autograd.grad(ref, w)
    assert ref.item() == pytest.approx(loss.item(), rel=1e-5)
    mine = [x.grad for layer in model.dense_layers() for x in (layer.weight, layer.bias)]
    for g, m in zip(grads, mine):
        m = m.T if m.dim() == 2 else m
        assert torch.allclose(g, m, rtol=1e-4, atol=1e-6)


def test_gae_matches_the_program():
    from gym_futbol_tpu_torch import ppo

    t, b2 = 12, 10
    traj = ppo.Transition(obs=None, dirs=None, acts=None, logp=None,
                          value=torch.randn(t, b2), reward=torch.randn(t, b2),
                          done=torch.rand(t, b2) < 0.2)
    last = torch.randn(b2)
    want = ppo.compute_gae(traj, last, ppo.PPOConfig())
    got = ref_ppo.gae(traj.reward, traj.value, traj.done, last, 0.99, 0.95)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_tie_distance():
    cdf = torch.tensor([[[0.2, 0.4, 0.6, 0.8]]], dtype=torch.float64)
    u = torch.tensor([[0.401]])
    same = torch.tensor([[2]])
    assert ref_ppo.tie_distance(same, same, cdf, u).item() == 0
    assert ref_ppo.tie_distance(torch.tensor([[2]]), torch.tensor([[1]]), cdf,
                                u).item() == pytest.approx(0.001, abs=1e-6)
    assert ref_ppo.tie_distance(torch.tensor([[2]]), torch.tensor([[4]]), cdf,
                                u).item() == pytest.approx(0.399, abs=1e-6)
    assert counts.mlp_dims(22, (16, 16), 20)[-1] == (16, 1)
