"""The port's recurrent PPO learner against the benchmark's plain
reference (``futbench/reference/recurrent.py``, plain torch in float32,
which imports nothing of the port) on the host, on seeded random
weights: ``RecurrentActorCritic.unroll`` with episodes ending inside the
window at stable-baselines' ``MlpLstmPolicy`` widths (torso (64, 64),
H = 256); ``recurrent_ppo_loss`` and its per-leaf gradients, and one
``update_epochs_recurrent`` call on given block permutations, at 1v1 and
3v3; and K5's plain version (``fused_recurrent_collect_reference``)
teacher-forced: the reference's env stepped with the collect's actions
and draws, its LSTM on its own carries.

Tolerances, with their reasons:

* unroll, loss and the collect in float32: the port sums the cell's two
  products apart (``cell_h(h) + cell_i(t)``; the plain collect in
  ascending order without FMAs), the reference as one product over
  ``[t, h]``: float32 rounding in another order, atol 2e-5 on logits,
  values, log-probs and carries (all of order 1), rel 1e-5 on the loss;
  gradients rtol 1e-4 / atol 1e-6 (sums over the whole window);
* the parameters after Adam's steps, per leaf: the norm of the
  difference of the two changes within 1e-3 of the reference change's
  norm. Adam divides each entry's gradient by its own running size, so
  an entry whose gradient is as small as the rounding of its sums can
  move by up to ``lr`` either way; the leaf as a whole cannot;
* the env's observations, rewards, dones and end state: bitwise (the
  host's float32 square root on both sides, as ``futbench/tests``
  compares the env step);
* the collect in bfloat16: the same operands rounded on both sides; a
  float32 sum in another order can move a rounded activation by one
  bf16 ulp, so log-probs, values and carries within 1e-2 (the bound of
  ``tests/test_torch_cuda.py``'s bf16 K5 test); sampled actions equal
  the reference's draws but for near ties (a differing draw's uniform
  within 1e-4 of a CDF boundary in float32, 2e-2 in bfloat16).
"""

import pytest
import torch

torch.set_num_threads(1)

from futbench.reference import env as ref_env  # noqa: E402
from futbench.reference import ppo as ref_ppo  # noqa: E402
from futbench.reference import recurrent as ref_rec  # noqa: E402
from gym_futbol_tpu_torch import EnvParams, obs_size, ppo  # noqa: E402
from gym_futbol_tpu_torch import recurrent_ppo as rppo  # noqa: E402
from gym_futbol_tpu_torch.models.recurrent import RecurrentActorCritic  # noqa: E402
from gym_futbol_tpu_torch.ops import fused_recurrent as tfr  # noqa: E402


@pytest.fixture(autouse=True)
def host_sqrt():
    ref_env.exact_sqrt(False)
    yield
    ref_env.exact_sqrt(True)


def leaves(model: RecurrentActorCritic, grads: bool = False) -> list:
    """The model's parameters (or their ``.grad``) as the reference's
    leaves: ``W`` ``[in, out]``."""
    out = []
    for p in model.parameters():
        x = (p.grad if grads else p).detach()
        out.append((x.T if x.dim() == 2 else x).clone())
    return out


def model_with_biases(ppt, hidden, hs, seed):
    """A seeded model whose biases are non-zero (flax zeroes them)."""
    gen = torch.Generator().manual_seed(seed)
    model = RecurrentActorCritic(ppt, obs_size(EnvParams(players_per_team=ppt)), hidden,
                                 hs, generator=gen, device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.1, generator=gen)
    return model, gen


def test_unroll_matches_reference():
    """3v3, torso (64, 64), H = 256, 5 sequences over 9 steps from
    non-zero carries, episodes ending inside the window."""
    model, gen = model_with_biases(3, (64, 64), 256, 0)
    t, s = 9, 5
    obs = torch.randn(t, s, model.obs_dim, generator=gen)
    done = torch.rand(t, s, generator=gen) < 0.25
    done[2, 0] = done[5, 3] = True
    c0, h0 = (torch.randn(s, 256, generator=gen) * 0.5 for _ in range(2))
    with torch.no_grad():
        carry, (logits, value) = model.unroll((c0, h0), obs, done)
        ref_logits, ref_value = ref_rec.unroll(leaves(model), obs, done, c0, h0, "f32")
    torch.testing.assert_close(logits, ref_logits, rtol=0, atol=2e-5)
    torch.testing.assert_close(value, ref_value, rtol=0, atol=2e-5)
    # the carry after the window: the reference's last step, zeroed where done
    c, h = c0, h0
    w = leaves(model)
    for k in range(t):
        c, h = ref_rec.cell(w, ref_rec.torso(w, obs[k], "f32"), c, h, "f32")
        keep = (~done[k]).float()[:, None]
        c, h = c * keep, h * keep
    torch.testing.assert_close(carry[0], c, rtol=0, atol=2e-5)
    torch.testing.assert_close(carry[1], h, rtol=0, atol=2e-5)
    assert not torch.equal(logits[3], logits[3].roll(1, 0))   # sequences differ


def _window(ppt, hs, t, s, gen):
    """A recurrent window of ``s`` sequences: the fields the loss reads,
    as the program holds them and as the reference's ``seq``."""
    g = 2 * ppt
    f = obs_size(EnvParams(players_per_team=ppt))
    idx = torch.randint(0, 5, (t, s, g), generator=gen)
    dirs = sum(idx[..., 2 * q] << (3 * q) for q in range(ppt)).int()
    acts = sum(idx[..., 2 * q + 1] << (3 * q) for q in range(ppt)).int()
    traj = ppo.Transition(
        obs=torch.randn(t, s, f, generator=gen), dirs=dirs, acts=acts,
        logp=-torch.rand(t, s, generator=gen) * 6 - 2,
        value=torch.randn(t, s, generator=gen), reward=torch.randn(t, s, generator=gen),
        done=torch.rand(t, s, generator=gen) < 0.2)
    adv, ret = torch.randn(t, s, generator=gen), torch.randn(t, s, generator=gen)
    c0, h0 = (torch.randn(s, hs, generator=gen) * 0.5 for _ in range(2))
    seq = dict(obs=traj.obs, done=traj.done, idx=idx, logp=traj.logp, value=traj.value,
               adv=adv, ret=ret, c0=c0, h0=h0)
    return traj, adv, ret, (c0, h0), seq


@pytest.mark.parametrize("ppt", [1, 3])
def test_loss_and_grads_match_reference(ppt):
    """One minibatch of whole sequences, T = 6, H = 12: the loss and each
    leaf's gradient."""
    model, gen = model_with_biases(ppt, (16,), 12, ppt)
    cfg = rppo.RecurrentPPOConfig(rollout_steps=6)
    traj, adv, ret, carry, seq = _window(ppt, 12, 6, 24, gen)
    loss, _ = rppo.recurrent_ppo_loss(model, traj, carry, adv, ret, cfg)
    loss.backward()
    w = [x.requires_grad_(True) for x in leaves(model)]
    ref = ref_rec.ppo_loss(w, seq, vars(cfg), "f32")
    grads = torch.autograd.grad(ref, w)
    assert loss.item() == pytest.approx(ref.item(), rel=1e-5)
    for got, want in zip(leaves(model, grads=True), grads, strict=True):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("ppt", [1, 3])
def test_update_epochs_match_reference(ppt):
    """One ``update_epochs_recurrent`` call, 2 epochs x 2 minibatches of
    blocks of 8 sequences on given permutations, T = 6, H = 12, from the
    optimiser's first step: the mean loss, and each leaf's change."""
    model, gen = model_with_biases(ppt, (16,), 12, 10 + ppt)
    cfg = rppo.RecurrentPPOConfig(rollout_steps=6, epochs=2, minibatches=2,
                                  shuffle_block=8, lr=2.5e-4)
    traj, adv, ret, carry, seq = _window(ppt, 12, 6, 32, gen)
    perms = torch.stack([torch.randperm(4, generator=gen) for _ in range(2)])
    w0 = leaves(model)
    opt = rppo.make_optimizer(model, cfg)
    metrics = rppo.update_epochs_recurrent(model, opt, traj, carry, adv, ret, gen, cfg,
                                           perms=perms, compute_dtype=torch.float32)
    w = [x.clone() for x in w0]
    ref_loss = ref_rec.update(w, ref_ppo.Adam(w, cfg.lr, cfg.max_grad_norm), seq, perms,
                              vars(cfg), "f32")
    assert metrics["loss"].item() == pytest.approx(ref_loss, rel=1e-5)
    for got, want, start in zip(leaves(model), w, w0, strict=True):
        d_got, d_want = got - start, want - start
        assert d_want.norm() > 0
        assert (d_got - d_want).norm() <= 1e-3 * d_want.norm()


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_plain_k5_collect_teacher_forced(mode):
    """K5's plain version, 2v2, 24 envs, T = 10, torso (16,), H = 12, from
    non-zero carries, on a uniforms table, episodes ending in the window;
    the reference replays it with the collect's own actions."""
    ppt, b, t_len, hs = 2, 24, 10, 12
    params = EnvParams(players_per_team=ppt, max_steps=7)
    p = ref_env.Params.from_config(ppt, {"max_steps": 7})
    model, gen = model_with_biases(ppt, (16,), hs, 3)
    sf, si = ref_env.initial_state(gen, p, b, "cpu")
    cc, hh = (torch.randn(2, hs, b, generator=gen) * 0.5 for _ in range(2))
    u = torch.rand((t_len, tfr.n_draws_per_step(params), b), generator=gen)
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[mode]
    (sf1, si1, obs, dirs, acts, logp, value, reward, done, last_v, c1,
     h1) = tfr.fused_recurrent_collect_reference(
        sf, si, tfr.flatten_recurrent_actor_critic(model), cc, hh, params,
        uniforms=u, compute_dtype=dtype)
    assert done.any()
    w, g, f = leaves(model), 2 * ppt, obs_size(params)
    state = ref_env.state_from_packed(sf, si, p.n_bodies)
    cos_t, sin_t, nx, ny = ref_env.step_noise(u, p, 2 * g, "cpu")
    c, h = (x.permute(0, 2, 1).reshape(2 * b, hs) for x in (cc, hh))
    ties, tol = [], 1e-2 if mode == "bf16" else 2e-5
    for k in range(t_len):
        x = torch.cat([ref_env.observation(state, p, mirror=False),
                       ref_env.observation(state, p, mirror=True)], 1)
        assert torch.equal(x, torch.cat([obs[0, :f, k], obs[1, :f, k]], 1))
        logits, v, c, h = ref_rec.forward(w, x.T, c, h, mode)
        ia = ref_ppo.unpack(dirs[k].reshape(2 * b), acts[k].reshape(2 * b), g)
        lp, _ = ref_ppo.logp_entropy(logits, ia)
        torch.testing.assert_close(logp[k].reshape(2 * b), lp, rtol=0, atol=tol)
        torch.testing.assert_close(value[k].reshape(2 * b), v, rtol=0, atol=tol)
        uv = torch.cat([u[k, :g], u[k, g:2 * g]], 1).T
        idx, cdf = ref_ppo.sample(logits, uv)
        ties.append(ref_ppo.tie_distance(idx, ia, cdf, uv).max().item())
        dd = [ia[:b, 2 * q].int() for q in range(ppt)] + [
            ref_env.mirror_dir(ia[b:, 2 * q]).int() for q in range(ppt)]
        aa = [ia[:b, 2 * q + 1].int() for q in range(ppt)] + [
            ia[b:, 2 * q + 1].int() for q in range(ppt)]
        state, r0, r1, dn = ref_env.step(state, dd, aa, cos_t[k], sin_t[k], list(nx[k]),
                                         list(ny[k]), p)
        assert torch.equal(torch.stack([r0, r1]).float(), reward[k])
        assert torch.equal(torch.stack([dn, dn]).int(), done[k])
        keep = (1.0 - torch.cat([dn, dn]).float())[:, None]
        c, h = c * keep, h * keep
    end = ref_env.packed(state)
    assert torch.equal(end[0], sf1) and torch.equal(end[1], si1)
    assert max(ties) <= (2e-2 if mode == "bf16" else 1e-4)
    x = torch.cat([ref_env.observation(state, p, mirror=False),
                   ref_env.observation(state, p, mirror=True)], 1)
    torch.testing.assert_close(last_v.reshape(2 * b), ref_rec.forward(w, x.T, c, h, mode)[1],
                               rtol=0, atol=tol)
    torch.testing.assert_close(c1.permute(0, 2, 1).reshape(2 * b, hs), c, rtol=0, atol=tol)
    torch.testing.assert_close(h1.permute(0, 2, 1).reshape(2 * b, hs), h, rtol=0, atol=tol)
