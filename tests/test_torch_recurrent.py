"""The recurrent learners and A2C: the port's ``RecurrentActorCritic``,
losses, updates, RMSProp, ``evaluate_recurrent`` and the training CLI
against the JAX package (flax, ``jax.grad``, optax) on the CPU.

Every input is made with numpy from a seed and handed to both packages.
Bounds, with their reasons:
- ``RecurrentActorCritic`` against flax ``apply`` on the same weights,
  stepped with resets: logits, value and carry within 1e-5 (the two CPU
  matmuls sum in different orders; the carry feeds back over the steps).
- Loss gradients (autograd against ``jax.grad``, the same batch and
  initial carry): rtol 2e-4 / atol 2e-6, as the PPO loss's
  (tests/test_torch_ppo_update.py); the BPTT window sums the same terms
  in another order. Metrics rtol 2e-4.
- ``update_epochs_recurrent`` after 2 epochs x 2 minibatches with JAX's
  permutations: parameters and loss rtol 5e-3 / atol 5e-5, the PPO
  update's bound (Adam divides by the gradients' own scale, so last-bit
  differences grow over the steps).
- RMSProp against optax after three steps: 1e-6 (optax's ``rsqrt`` on
  the CPU is not IEEE ``1/sqrt``, ROADMAP).
"""

import contextlib
import dataclasses
import io
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from gym_futbol_tpu import EnvParams as JEnvParams  # noqa: E402
from gym_futbol_tpu import a2c as ja2c  # noqa: E402
from gym_futbol_tpu import ppo as jppo  # noqa: E402
from gym_futbol_tpu import recurrent_ppo as jrppo  # noqa: E402
from gym_futbol_tpu.models.policy import ActorCritic as JActorCritic  # noqa: E402
from gym_futbol_tpu.models.recurrent import RecurrentActorCritic as JRAC  # noqa: E402
from gym_futbol_tpu.models.recurrent import (  # noqa: E402
    init_recurrent_params,
    reset_carry_where_done,
)
from gym_futbol_tpu_torch import a2c as ta2c  # noqa: E402
from gym_futbol_tpu_torch import evaluate as teval  # noqa: E402
from gym_futbol_tpu_torch import ops  # noqa: E402
from gym_futbol_tpu_torch import ppo as tppo  # noqa: E402
from gym_futbol_tpu_torch import recurrent_ppo as trppo  # noqa: E402
from gym_futbol_tpu_torch import train as ttrain  # noqa: E402
from gym_futbol_tpu_torch.env import mirror_actions, mirror_obs  # noqa: E402
from gym_futbol_tpu_torch.interop import (  # noqa: E402
    actor_critic_from_flax,
    params_from_reference,
    recurrent_actor_critic_from_flax,
)
from gym_futbol_tpu_torch.models import recurrent as trec  # noqa: E402
from gym_futbol_tpu_torch.models.policy import sample_actions  # noqa: E402
from gym_futbol_tpu_torch.vector import reset_batch, step_batch  # noqa: E402

P = JEnvParams(players_per_team=2, max_steps=6)
F = 4 * P.n_bodies + 2
H = 16
HIDDEN = (32,)
GRAD_TOL = dict(rtol=2e-4, atol=2e-6)


def _np(x):
    return np.asarray(jax.device_get(x))


def _flax(ppt=2, hidden=HIDDEN, lstm=H, seed=0, bias_scale=0.1):
    """Flax RecurrentActorCritic variables as numpy, the zero biases
    replaced by random ones so that every bias path is exercised."""
    ref = JEnvParams(players_per_team=ppt)
    model = JRAC(n_players=ppt, hidden=hidden, lstm_size=lstm)
    variables = jax.tree.map(np.asarray, init_recurrent_params(
        jax.random.PRNGKey(seed), model, ref))
    rng = np.random.default_rng(seed + 100)

    def perturb(path, x):
        if path[-1].key == "bias":
            return rng.normal(0.0, bias_scale, x.shape).astype(np.float32)
        return x

    return model, jax.tree_util.tree_map_with_path(perturb, variables)


def _as_flax(model, grads=False):
    """The port model's weights (or their gradients) in flax's tree."""
    def get(t):
        return (t.grad if grads else t).detach().numpy()

    dense = [*model.torso, model.logits, model.value]
    tree = {f"Dense_{i}": {"kernel": get(layer.weight).T, "bias": get(layer.bias)}
            for i, layer in enumerate(dense)}
    wi, wh, bh = (np.split(get(t).T if t.dim() == 2 else get(t), 4, -1)
                  for t in (model.cell_i.weight, model.cell_h.weight,
                            model.cell_h.bias))
    cell = {}
    for k, g in enumerate(trec.GATES):
        cell[f"i{g}"] = {"kernel": wi[k]}
        cell[f"h{g}"] = {"kernel": wh[k], "bias": bh[k]}
    tree["OptimizedLSTMCell_0"] = cell
    return {"params": tree}


def _assert_trees(got, want, **tol):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want)
    for path, g in flat_got:
        np.testing.assert_allclose(g, _np(flat_want[path]), **tol,
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ppt,hidden,lstm", [(2, (32,), 16), (1, (24, 16), 8),
                                             (2, (), 16)],
                         ids=["2v2", "1v1-two-layers", "no-torso"])
def test_recurrent_actor_critic_matches_flax(ppt, hidden, lstm):
    """Five steps of the port's module and of flax's, zeroing the carry
    where a random done falls, from a non-zero carry: logits, value and
    carry within 1e-5; :meth:`unroll` gives the same."""
    model, variables = _flax(ppt, hidden, lstm)
    tmodel = recurrent_actor_critic_from_flax(variables, ppt, device="cpu")
    rng = np.random.default_rng(1)
    f, b, t = 4 * (2 * ppt + 1) + 2, 64, 5
    obs = rng.normal(0.0, 1.0, (t, b, f)).astype(np.float32)
    done = rng.random((t, b)) < 0.2
    carry0 = tuple(rng.normal(0.0, 0.5, (b, lstm)).astype(np.float32)
                   for _ in range(2))
    jc = tuple(jnp.asarray(c) for c in carry0)
    tc = tuple(torch.from_numpy(c) for c in carry0)
    logits_all, value_all = [], []
    with torch.no_grad():
        for k in range(t):
            jc, (jl, jv) = model.apply(variables, jc, jnp.asarray(obs[k]))
            tc, (tl, tv) = tmodel(tc, torch.from_numpy(obs[k]))
            np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(tv.numpy(), _np(jv), rtol=1e-5, atol=1e-5)
            for a, c in zip(tc, jc):
                np.testing.assert_allclose(a.numpy(), _np(c), rtol=1e-5, atol=1e-5)
            logits_all.append(tl)
            value_all.append(tv)
            jc = reset_carry_where_done(jc, jnp.asarray(done[k]))
            tc = trec.reset_carry_where_done(tc, torch.from_numpy(done[k]))
        uc, (ul, uv) = tmodel.unroll(tuple(torch.from_numpy(c) for c in carry0),
                                     torch.from_numpy(obs), torch.from_numpy(done))
    torch.testing.assert_close(ul, torch.stack(logits_all), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(uv, torch.stack(value_all), rtol=1e-6, atol=1e-6)
    for a, c in zip(uc, tc):
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-6)
    assert model.initial_carry(3)[0].shape == tmodel.initial_carry(3)[0].shape


def test_recurrent_rollout_runs_and_resets():
    """models.recurrent.recurrent_rollout (the model controlling every
    player, as the JAX package's): [T, B] outputs, finite, episodes
    ending inside the window, the carry of an env done at the last step
    zeroed."""
    params = params_from_reference(P)
    gen = torch.Generator().manual_seed(6)
    model = trec.RecurrentActorCritic(params.n_players, F, (16,), 8, generator=gen,
                                      device="cpu")
    state, obs = reset_batch(gen, params, 8, device="cpu")
    state, obs, carry, ys = trec.recurrent_rollout(
        model, state, obs, model.initial_carry(8), gen, params, 12)
    value, logp, reward, done = ys
    assert value.shape == reward.shape == done.shape == (12, 8)
    assert all(bool(torch.isfinite(y).all()) for y in (value, logp, reward))
    assert done[-1].any() and obs.shape == (8, F)       # max_steps 6
    assert (carry[0][done[-1]] == 0).all() and (carry[1][done[-1]] == 0).all()


def test_fresh_init_is_flax_like():
    """A fresh module: each gate's [H, H] recurrent block orthogonal,
    biases zero, input and head kernels at flax's truncated lecun-normal
    scale (std 1/sqrt(fan_in), cut at 2 std of the untruncated normal),
    as flax's own init measures on the same shapes; the generator fixes
    the draw."""
    def make(seed):
        return trec.RecurrentActorCritic(3, 30, (128,), 64, device="cpu",
                                         generator=torch.Generator().manual_seed(seed))

    m = make(0)
    eye = torch.eye(64)
    for block in m.cell_h.weight.detach().chunk(4, 0):
        torch.testing.assert_close(block @ block.T, eye, atol=1e-5, rtol=0)
    assert not torch.equal(*m.cell_h.weight.detach().chunk(4, 0)[:2])
    _, variables = _flax(3, (128,), 64, bias_scale=0.0)
    fl = variables["params"]
    for layer, kernel in ((m.torso[0], fl["Dense_0"]["kernel"]),
                          (m.cell_i, fl["OptimizedLSTMCell_0"]["ii"]["kernel"]),
                          (m.logits, fl["Dense_1"]["kernel"])):
        w = layer.weight.detach()
        std = layer.in_features ** -0.5
        assert abs(w.std().item() / std - 1) < 0.05
        assert abs(kernel.std() / std - 1) < 0.05
        assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6
    for b in (m.torso[0].bias, m.cell_h.bias, m.logits.bias, m.value.bias):
        assert (b == 0).all()
    assert m.cell_i.bias is None
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(),
                                                 make(0).parameters()))


# ---------------------------------------------------------------------------
# Losses against jax.grad
# ---------------------------------------------------------------------------


def _packed(rng, shape, ppt=2):
    a = rng.integers(0, 5, (ppt, *shape))
    return sum(a[q] << (3 * q) for q in range(ppt)).astype(np.int32)


def _window(seed, t=5, s=64):
    """A [T, S] window: obs, packed actions, old logp/value, rewards,
    dones (episode ends inside it), advantages, returns, init carry."""
    rng = np.random.default_rng(seed)
    traj = dict(
        obs=rng.normal(0.0, 1.0, (t, s, F)).astype(np.float32),
        dirs=_packed(rng, (t, s)), acts=_packed(rng, (t, s)),
        logp=-np.abs(rng.normal(0.0, 1.0, (t, s))).astype(np.float32) * 4,
        value=rng.normal(0.0, 1.0, (t, s)).astype(np.float32),
        reward=rng.normal(0.0, 0.1, (t, s)).astype(np.float32),
        done=rng.random((t, s)) < 0.15,
    )
    adv = rng.normal(0.0, 1.0, (t, s)).astype(np.float32)
    ret = rng.normal(0.0, 1.0, (t, s)).astype(np.float32)
    carry = tuple(rng.normal(0.0, 0.5, (s, H)).astype(np.float32)
                  for _ in range(2))
    return traj, adv, ret, carry


def _both(traj, adv, ret, carry):
    jt = jppo.Transition(**{k: jnp.asarray(v) for k, v in traj.items()})
    tt = tppo.Transition(**{k: torch.from_numpy(v) for k, v in traj.items()})
    return ((jt, tuple(map(jnp.asarray, carry)), jnp.asarray(adv), jnp.asarray(ret)),
            (tt, tuple(map(torch.from_numpy, carry)), torch.from_numpy(adv),
             torch.from_numpy(ret)))


@pytest.mark.parametrize("algo", ["ppo", "a2c"])
def test_recurrent_loss_grads_match_jax_grad(algo):
    """recurrent_ppo_loss and recurrent_a2c_loss: the BPTT gradients from
    one initial carry over a window with episode ends, against jax.grad
    of the JAX losses on the same batch."""
    model, variables = _flax()
    j, t = _both(*_window(2))
    if algo == "ppo":
        jloss, jcfg = jrppo.recurrent_ppo_loss, jrppo.RecurrentPPOConfig(remat=False)
        tloss, tcfg = trppo.recurrent_ppo_loss, trppo.RecurrentPPOConfig()
    else:
        jloss, tloss = ja2c.recurrent_a2c_loss, ta2c.recurrent_a2c_loss
        jcfg, tcfg = ja2c.A2CConfig(), ta2c.A2CConfig()
    jgrads, jm = jax.grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, variables), model, j[0], j[1], j[2], j[3], jcfg)
    tmodel = recurrent_actor_critic_from_flax(variables, 2, device="cpu")
    loss, tm = tloss(tmodel, *t, tcfg)
    loss.backward()
    _assert_trees(_as_flax(tmodel, grads=True), jgrads, **GRAD_TOL)
    assert set(tm) == set(jm)
    for k in tm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=2e-4,
                                   atol=1e-6, err_msg=k)


def test_a2c_loss_grads_match_jax_grad():
    """Feed-forward a2c_loss (row-major obs) and a2c_loss_fm (the fused
    collect's feature-major obs with its zero pad rows) against
    jax.grad of JAX's two."""
    rng = np.random.default_rng(3)
    n, f_pad = 256, 24
    dense = [(F, 16), (16, 20), (16, 1)]
    variables = {"params": {f"Dense_{i}": {
        "kernel": rng.normal(0.0, a ** -0.5, (a, b)).astype(np.float32),
        "bias": rng.normal(0.0, 0.1, (b,)).astype(np.float32)}
        for i, (a, b) in enumerate(dense)}}
    obs = np.zeros((n, f_pad), np.float32)
    obs[:, :F] = rng.normal(0.0, 1.0, (n, F))
    dirs, acts = _packed(rng, (n,)), _packed(rng, (n,))
    adv, ret = (rng.normal(0.0, 1.0, n).astype(np.float32) for _ in range(2))
    jmodel = JActorCritic(n_players=2, hidden=(16,))
    params = jax.tree.map(jnp.asarray, variables)
    z = np.zeros(n, np.float32)
    jtraj = jppo.Transition(obs=jnp.asarray(obs[:, :F]), dirs=dirs, acts=acts,
                            logp=z, value=z, reward=z, done=z)
    ttraj = tppo.Transition(obs=torch.from_numpy(obs[:, :F]),
                            dirs=torch.from_numpy(dirs), acts=torch.from_numpy(acts),
                            logp=None, value=None, reward=None, done=None)
    cases = (
        (jax.grad(ja2c.a2c_loss, has_aux=True)(
            params, jmodel, jtraj, jnp.asarray(adv), jnp.asarray(ret),
            ja2c.A2CConfig()),
         lambda m: ta2c.a2c_loss(m, ttraj, torch.from_numpy(adv),
                                 torch.from_numpy(ret), ta2c.A2CConfig())),
        (jax.grad(ja2c.a2c_loss_fm, has_aux=True)(
            params, jmodel, jnp.asarray(obs.T), jnp.asarray(dirs), jnp.asarray(acts),
            jnp.asarray(adv), jnp.asarray(ret), ja2c.A2CConfig()),
         lambda m: ta2c.a2c_loss_fm(
             m, torch.from_numpy(obs.T.copy()), torch.from_numpy(dirs),
             torch.from_numpy(acts), torch.from_numpy(adv), torch.from_numpy(ret),
             ta2c.A2CConfig())),
    )
    for (jgrads, jm), fn in cases:
        model = actor_critic_from_flax(variables, 2, device="cpu")
        loss, tm = fn(model)
        loss.backward()
        for i, layer in enumerate(model.dense_layers()):
            g = jgrads["params"][f"Dense_{i}"]
            np.testing.assert_allclose(layer.weight.grad.numpy().T, _np(g["kernel"]),
                                       **GRAD_TOL)
            np.testing.assert_allclose(layer.bias.grad.numpy(), _np(g["bias"]),
                                       **GRAD_TOL)
        for k in tm:
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=2e-4,
                                       atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# The recurrent PPO update
# ---------------------------------------------------------------------------


def test_update_epochs_recurrent_matches_jax():
    """update_epochs_recurrent against JAX's, fed JAX's per-epoch block
    permutations: 2 epochs x 2 minibatches over 4 blocks of 16 sequences
    (Adam, the clip): parameters and mean loss."""
    model, variables = _flax(seed=4)
    traj, adv, ret, carry = _window(5)
    j, t = _both(traj, adv, ret, carry)
    kw = dict(rollout_steps=5, epochs=2, minibatches=2, shuffle_block=16)
    jcfg = jrppo.RecurrentPPOConfig(**kw, remat=False)
    tcfg = trppo.RecurrentPPOConfig(**kw)
    key = jax.random.PRNGKey(6)
    perms = torch.from_numpy(np.stack([
        _np(jax.random.permutation(k, 4)) for k in jax.random.split(key, 2)
    ]).astype(np.int64))
    tx = jrppo.make_optimizer(jcfg)
    params = jax.tree.map(jnp.asarray, variables)
    jparams, _, jm = jrppo.update_epochs_recurrent(
        params, tx.init(params), j[0], j[1], j[2], j[3], key, model, tx, jcfg)
    tmodel = recurrent_actor_critic_from_flax(variables, 2, device="cpu")
    opt = trppo.make_optimizer(tmodel, tcfg)
    tm = trppo.update_epochs_recurrent(tmodel, opt, *t, torch.Generator(), tcfg,
                                       perms=perms, compute_dtype=torch.float32)
    assert opt.count == 4
    _assert_trees(_as_flax(tmodel), jparams, rtol=5e-3, atol=5e-5)
    assert set(tm) == set(jm)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=5e-3,
                               atol=5e-5)


def test_leftover_blocks_refused():
    """10 sequences make 5 blocks of 2, which 4 minibatches do not
    divide: the port raises where the JAX package drops a block."""
    traj, adv, ret, carry = _window(7, t=2, s=10)
    _, t = _both(traj, adv, ret, carry)
    model = trec.RecurrentActorCritic(2, F, HIDDEN, H, device="cpu")
    cfg = trppo.RecurrentPPOConfig(minibatches=4)
    with pytest.raises(ValueError, match="do not divide"):
        trppo.update_epochs_recurrent(model, trppo.make_optimizer(model, cfg), *t,
                                      torch.Generator(), cfg)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_ratio_starts_at_one(fused):
    """With unchanged weights the BPTT loss recomputes the collect's
    log-probs from the carry the window started with (episode ends inside
    it), so the ratio is 1: approx_kl below 1e-6, for the plain collect
    and the fused one's plain version."""
    params = params_from_reference(P)
    gen = torch.Generator().manual_seed(1)
    model = trec.RecurrentActorCritic(2, F, (16,), H, device="cpu")
    cfg = trppo.RecurrentPPOConfig(rollout_steps=7)
    runner = trppo.init_recurrent_ppo_runner(gen, model, params, cfg, 32)
    runner = runner.replace(carry=tuple(torch.randn(2, 32, H, generator=gen) * 0.5
                                        for _ in range(2)))
    init_carry = ta2c._flat_carry(runner.carry, 32)
    collect = (ta2c.collect_recurrent_rollout_fused if fused
               else ta2c.collect_recurrent_rollout)
    runner, traj, last_v = collect(runner, params, cfg)
    assert traj.done.any()
    adv, ret = tppo.compute_gae(traj, last_v, cfg)
    with torch.no_grad():
        _, m = trppo.recurrent_ppo_loss(model, traj, init_carry, adv, ret, cfg)
    assert abs(float(m["approx_kl"])) < 1e-6, m


# ---------------------------------------------------------------------------
# RMSProp, A2C iterations and the recurrent iterations
# ---------------------------------------------------------------------------


def test_rmsprop_matches_optax():
    """Global-norm clipping above and below the threshold, then three
    RMSProp steps, against JAX's a2c.make_optimizer (optax's clip and
    rmsprop, eps inside the root); PyTorch's RMSprop (eps outside the
    root) steps orders of magnitude further on the first update."""
    rng = np.random.default_rng(8)
    cfg = ta2c.A2CConfig()
    shapes = [(4, 3), (3,), (2, 3)]
    for scale in (1e-4, 5.0):                   # norm below / above 0.5
        init = [rng.normal(size=s).astype(np.float32) for s in shapes]
        grads = [[(scale * rng.normal(size=s)).astype(np.float32) for s in shapes]
                 for _ in range(3)]
        tx = ja2c.make_optimizer(ja2c.A2CConfig())
        jp = [jnp.asarray(x) for x in init]
        state = tx.init(jp)
        tp = [torch.tensor(x, requires_grad=True) for x in init]
        opt = ta2c.RMSProp(tp, cfg.lr, cfg.max_grad_norm, cfg.rms_decay,
                           cfg.rms_eps)
        for g in grads:
            for p, gk in zip(tp, g):
                p.grad = torch.tensor(gk)
            opt.step()
            upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
            jp = optax.apply_updates(jp, upd)
        for p, w in zip(tp, jp):
            np.testing.assert_allclose(p.detach().numpy(), _np(w), atol=1e-6)
        assert opt.count == 3
    tp = [torch.tensor(x) for x in init]
    ref = torch.optim.RMSprop(tp, lr=cfg.lr, alpha=cfg.rms_decay, eps=cfg.rms_eps)
    for p, gk in zip(tp, [1e-4 * np.ones(s, np.float32) for s in shapes]):
        p.grad = torch.tensor(gk)
    ours = ta2c.RMSProp([t.clone().requires_grad_() for t in tp], cfg.lr,
                        cfg.max_grad_norm, cfg.rms_decay, cfg.rms_eps)
    for p, t in zip(ours.params, tp):
        p.grad = t.grad.clone()
    before = [t.clone() for t in tp]
    ref.step()
    ours.step()
    theirs = (tp[0] - before[0]).abs().mean()
    mine = (ours.params[0].detach() - before[0]).abs().mean()
    assert theirs > 100 * mine


def test_a2c_config_matches_jax():
    """A2CConfig and RecurrentPPOConfig hold JAX's fields (but remat) with
    JAX's defaults."""
    for tcfg, jcfg in ((ta2c.A2CConfig(), ja2c.A2CConfig()),
                       (trppo.RecurrentPPOConfig(), jrppo.RecurrentPPOConfig())):
        names = [f.name for f in dataclasses.fields(tcfg)]
        assert names == [f.name for f in dataclasses.fields(jcfg)
                         if f.name != "remat"]
        for name in names:
            assert getattr(tcfg, name) == getattr(jcfg, name), name


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_a2c_train_iteration_cpu(fused):
    """One feed-forward A2C iteration at 2v2, 64 envs, T=8: finite
    metrics, every parameter moved by one RMSProp step, no launch."""
    params = params_from_reference(P)
    gen = torch.Generator().manual_seed(0)
    model = tppo.ActorCritic(2, F, (16,), device="cpu")
    cfg = ta2c.A2CConfig()
    runner = ta2c.init_runner(gen, model, params, cfg, 64)
    before = [p.detach().clone() for p in model.parameters()]
    ops.reset_launch_counts()
    kw = {"collect_fn": tppo.collect_rollout_fused} if fused else {}
    runner, metrics = ta2c.train_iteration(runner, params, cfg, **kw)
    assert set(metrics) == {"loss", "pg_loss", "v_loss", "entropy", "mean_reward"}
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert all(not torch.equal(a, b) for a, b in zip(before, model.parameters()))
    assert runner.optimizer.count == 1 and sum(ops.LAUNCHES.values()) == 0


@pytest.mark.parametrize("algo,fused", [("ppo", False), ("ppo", True),
                                        ("a2c", False), ("a2c", True)])
def test_recurrent_train_iteration_cpu(algo, fused):
    """One recurrent iteration at 2v2, 32 envs, T=5, hidden (16,), H=8,
    on either collect: finite metrics, every parameter moved, the carry
    carried on, one optimiser step per minibatch (PPO) or one (A2C)."""
    params = params_from_reference(P)
    gen = torch.Generator().manual_seed(2)
    model = trec.RecurrentActorCritic(2, F, (16,), 8, device="cpu")
    if algo == "ppo":
        cfg = trppo.RecurrentPPOConfig(rollout_steps=5)
        runner = trppo.init_recurrent_ppo_runner(gen, model, params, cfg, 32)
        step, n_steps = trppo.train_iteration_recurrent_ppo, 16
    else:
        cfg = ta2c.A2CConfig(rollout_steps=5)
        runner = ta2c.init_recurrent_runner(gen, model, params, cfg, 32)
        step, n_steps = ta2c.train_iteration_recurrent, 1
    collect = (ta2c.collect_recurrent_rollout_fused if fused
               else ta2c.collect_recurrent_rollout)
    before = [p.detach().clone() for p in model.parameters()]
    runner, metrics = step(runner, params, cfg, collect_fn=collect)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert all(not torch.equal(a, b) for a, b in zip(before, model.parameters()))
    assert runner.optimizer.count == n_steps
    assert runner.carry[0].shape == (2, 32, 8) and runner.carry[1].abs().sum() > 0


# ---------------------------------------------------------------------------
# evaluate_recurrent and the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opponent", ["random", "recurrent"])
def test_evaluate_recurrent_matches_manual_loop(opponent):
    """evaluate_recurrent against the same matches played by hand from
    the same generator: team 0's carry threaded and zeroed at episode
    ends; team 1 uniform random or a second recurrent model on the
    mirrored view with its own carry."""
    params = params_from_reference(P)
    gen = torch.Generator().manual_seed(3)
    model = trec.RecurrentActorCritic(2, F, (16,), 8, generator=gen, device="cpu")
    model_b = trec.RecurrentActorCritic(2, F, (16,), 8, generator=gen, device="cpu")
    n_envs, n_steps = 64, 9
    kw = {"model_b": model_b} if opponent == "recurrent" else {}
    got = teval.evaluate_recurrent(params, model, n_envs=n_envs, n_steps=n_steps,
                                   seed=5, **kw)

    g = torch.Generator().manual_seed(5)
    state, obs = reset_batch(g, params, n_envs, device="cpu")
    carry, carry_b = model.initial_carry(n_envs), model.initial_carry(n_envs)
    goals, rew, dones = torch.zeros(2, n_envs, dtype=torch.int32), [], 0
    with torch.no_grad():
        for _ in range(n_steps):
            carry, (logits, _) = model(carry, obs)
            act_a = sample_actions(logits, generator=g)[0]
            if opponent == "recurrent":
                carry_b, (lb, _) = model_b(carry_b, mirror_obs(obs, params))
                act_b = sample_actions(lb, generator=g)[0]
            else:
                act_b = torch.randint(0, 5, (n_envs, 2, 2), generator=g,
                                      dtype=torch.int32)
            state, out = step_batch(state, torch.cat(
                [act_a, mirror_actions(act_b)], -2), params, g)
            carry = trec.reset_carry_where_done(carry, out.done)
            carry_b = trec.reset_carry_where_done(carry_b, out.done)
            goals += out.info["goal"].T.to(torch.int32)
            rew.append(out.team_reward[:, 0])
            dones += int(out.done.sum())
            obs = out.obs
    want = teval._match_metrics(goals, torch.stack(rew).mean(), n_envs)
    assert set(got) == set(want)
    for k in ("goals", "goals_per_episode", "win_rate_a", "win_rate_b", "draw_rate"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["mean_team0_reward"], want["mean_team0_reward"],
                               rtol=1e-6)
    assert abs(got["win_rate_a"] + got["win_rate_b"] + got["draw_rate"] - 1) < 1e-9
    assert dones == n_envs          # every episode ended once: the resets ran


@pytest.mark.parametrize("argv,n_updates", [
    (["--algo", "ppo"], 16),
    (["--algo", "a2c", "--fused-collect"], 1),
    (["--algo", "ppo", "--iters", "0", "--eval-episodes", "16"], 0),
    (["--algo", "ppo", "--lstm-size", "6"], 16),
    (["--algo", "ppo", "--fused-collect"], 16),
], ids=["ppo", "a2c-fused", "eval", "ppo-h6", "ppo-fused"])
def test_cli_recurrent_cpu(argv, n_updates):
    """``python -m gym_futbol_tpu_torch.train --recurrent ... --device
    cpu``: T resolves to 16 (not PPO's 128), one record per iteration
    with the JAX CLI's keys, an eval record with --eval-episodes, then
    the done record. Recurrent PPO's update follows the collect: float32
    behind the plain collect, so an LSTM size K6 refuses (6) still
    trains; K6's plain version behind the fused collect."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runner = ttrain.main(["--device", "cpu", "--recurrent", "--ppt", "2",
                              "--iters", "1", "--envs", "32", "--hidden", "16",
                              "--lstm-size", "8", "--max-steps", "20", *argv])
    lines = [json.loads(s) for s in out.getvalue().splitlines()]
    assert isinstance(runner, ta2c.RecurrentRunnerState)
    assert lines[-1]["done"] is True
    if n_updates:
        rec = lines[0]
        assert rec["step"] == 0 and {"loss", "pg_loss", "v_loss", "entropy",
                                     "mean_reward"} <= set(rec)
        assert all(np.isfinite(v) for v in rec.values())
        assert lines[-1]["total_env_steps"] == 32 * 16
    else:
        ev = lines[0]["eval_vs_random"]
        assert ev["episodes"] == 16
        assert abs(ev["win"] + ev["loss"] + ev["draw"] - 1.0) < 1e-9
    assert runner.optimizer.count == n_updates
