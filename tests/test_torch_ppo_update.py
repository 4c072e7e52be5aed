"""The PPO update (kernel K3 ``fused_minibatch_grad``, the optimiser,
``update_epochs(_fused)``, ``train_iteration`` and the training CLI):
the port's plain versions against the JAX package on the CPU.

Every input is made with numpy from a seed and handed to both packages.
JAX's K3 runs in interpret mode, as tests/test_ops.py runs it. Bounds,
with their reasons:
- ``ppo_loss`` gradients (autograd against ``jax.grad``) and K3's plain
  version in float32 against JAX's kernel in float32: grads rtol 2e-4 /
  atol 2e-6, metrics rtol 2e-4, JAX's own bounds for its kernel against
  ``jax.grad`` (sums in another order only).
- K3's plain version in bfloat16 against JAX's kernel in bfloat16: the
  same rounding points, so only the summation order and rare one-ulp
  bfloat16 flips of ``dlogits``/``dz`` differ. Per leaf rel-L2 at most
  2e-4, and at most a fifth of the same leaf's float32-to-bfloat16 gap
  measured on the same inputs (1.3e-3 to 7.9e-3 at this shape), so the
  test fails if the port rounded anywhere else than JAX does.
- ``update_epochs(_fused)`` after 2 epochs x 2 minibatches with JAX's
  permutations: parameters and loss rtol 5e-3 / atol 5e-5 (JAX's bound
  for its two update paths: Adam divides by the gradients' own scale,
  so last-bit differences grow over the steps).
- The optimiser against optax: learning rates rtol 1e-5, clipped
  gradients and parameters after three Adam steps within 1e-6.
"""

import contextlib
import importlib
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
from gym_futbol_tpu import ppo as jppo  # noqa: E402
from gym_futbol_tpu.models.policy import ActorCritic as JActorCritic  # noqa: E402
from gym_futbol_tpu_torch import ops  # noqa: E402
from gym_futbol_tpu_torch import ppo as tppo  # noqa: E402
from gym_futbol_tpu_torch import train as ttrain  # noqa: E402
from gym_futbol_tpu_torch.interop import (  # noqa: E402
    actor_critic_from_flax,
    params_from_reference,
)
from gym_futbol_tpu_torch.models.policy import ActorCritic  # noqa: E402
from gym_futbol_tpu_torch.ops import _build  # noqa: E402

# the modules, which each package's ops/__init__ shadows with a function
jfu = importlib.import_module("gym_futbol_tpu.ops.fused_update")
jfc = importlib.import_module("gym_futbol_tpu.ops.fused_collect")
tfu = importlib.import_module("gym_futbol_tpu_torch.ops.fused_update")
tfc = importlib.import_module("gym_futbol_tpu_torch.ops.fused_collect")

P = JEnvParams(players_per_team=2)
F = 4 * P.n_bodies + 2          # 22 obs rows
F_PAD = -(-F // 8) * 8          # 24, the fused collect's padded rows
G5 = P.players_per_team * 2 * 5
BLOCK = 128


def _np(x):
    return np.asarray(jax.device_get(x))


def _variables(rng, hidden):
    """Flax ActorCritic variables as numpy: lecun-scaled kernels and
    nonzero biases (so every bias gradient path is exercised)."""
    dims = [F, *hidden]
    shapes = list(zip(dims[:-1], dims[1:])) + [(dims[-1], G5), (dims[-1], 1)]
    return {"params": {
        f"Dense_{i}": {
            "kernel": rng.normal(0.0, a ** -0.5, (a, b)).astype(np.float32),
            "bias": rng.normal(0.0, 0.1, (b,)).astype(np.float32),
        } for i, (a, b) in enumerate(shapes)}}


def _packed(rng, shape):
    """In-range bit-packed actions, 3 bits for each of the 2 players."""
    a = rng.integers(0, 5, (2, *shape))
    return (a[0] | (a[1] << 3)).astype(np.int32)


def _minibatch_case(seed, hidden=(16, 8), n_blocks=4, idx=(2, 0)):
    """One minibatch's inputs as numpy (K3's argument layout)."""
    rng = np.random.default_rng(seed)
    variables = _variables(rng, hidden)
    obs = np.zeros((F_PAD, n_blocks * BLOCK), np.float32)
    obs[:F] = rng.normal(0.0, 1.0, (F, n_blocks * BLOCK))
    shape = (n_blocks, BLOCK)
    data = dict(
        obs_fm=obs, dirs_blk=_packed(rng, shape), acts_blk=_packed(rng, shape),
        logp_blk=-np.abs(rng.normal(0.0, 1.0, shape)).astype(np.float32) * 4,
        value_blk=rng.normal(0.0, 1.0, shape).astype(np.float32),
        ret_blk=rng.normal(0.0, 1.0, shape).astype(np.float32),
    )
    adv_blk = rng.normal(0.0, 1.0, shape).astype(np.float32)
    idx = np.asarray(idx, np.int32)
    adv_mb = adv_blk[idx]
    adv_n = ((adv_mb - adv_mb.mean()) / (adv_mb.std() + 1e-8)).astype(np.float32)
    return variables, data, adv_blk, adv_n, idx


def _kw(cfg, hidden):
    return dict(n_torso=len(hidden), clip_eps=cfg.clip_eps, vf_coef=cfg.vf_coef,
                ent_coef=cfg.ent_coef, block=BLOCK)


def _jax_kernel(case, hidden, dtype):
    variables, data, _, adv_n, idx = case
    jmodel = JActorCritic(n_players=P.players_per_team, hidden=hidden)
    w = jfc.flatten_actor_critic(jax.tree.map(jnp.asarray, variables), jmodel)
    grads, sums = jfu.fused_minibatch_grad(
        w, **{k: jnp.asarray(v) for k, v in data.items()},
        adv_n=jnp.asarray(adv_n), idx=jnp.asarray(idx),
        **_kw(jppo.PPOConfig(), hidden), interpret=True, compute_dtype=dtype)
    return [_np(g) for g in grads], {k: float(v) for k, v in sums.items()}


def _port_reference(case, hidden, dtype):
    variables, data, _, adv_n, idx = case
    model = actor_critic_from_flax(variables, P.players_per_team, device="cpu")
    grads, sums = tfu.fused_minibatch_grad_reference(
        tfc.flatten_actor_critic(model),
        **{k: torch.from_numpy(v) for k, v in data.items()},
        adv_n=torch.from_numpy(adv_n), idx=torch.from_numpy(idx),
        **_kw(tppo.PPOConfig(), hidden), compute_dtype=dtype)
    return [g.numpy() for g in grads], {k: float(v) for k, v in sums.items()}


@pytest.fixture(scope="module")
def k3_case():
    """JAX's kernel (interpret mode) in float32 and bfloat16 on one
    minibatch: 2v2, hidden (16, 8), blocks 2 and 0 of 4 (128 samples)."""
    hidden = (16, 8)
    case = _minibatch_case(0, hidden)
    return dict(case=case, hidden=hidden,
                f32=_jax_kernel(case, hidden, jnp.float32),
                bf16=_jax_kernel(case, hidden, jnp.bfloat16))


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# ppo_loss and K3's plain version
# ---------------------------------------------------------------------------


def test_ppo_loss_grads_match_jax_grad(k3_case):
    """Autograd of the port's ppo_loss against jax.grad(ppo.ppo_loss) on
    the gathered minibatch (F_pad obs rows: the first layer's zero pad)."""
    variables, data, adv_blk, _, idx = k3_case["case"]
    hidden = k3_case["hidden"]
    cfg_j, cfg_t = jppo.PPOConfig(remat=False), tppo.PPOConfig()
    obs = data["obs_fm"].reshape(F_PAD, -1, BLOCK)[:, idx].reshape(F_PAD, -1)

    def take(x):
        return x[idx].reshape(-1)

    rows = [take(data[k]) for k in ("dirs_blk", "acts_blk", "logp_blk",
                                    "value_blk")]
    jmodel = JActorCritic(n_players=P.players_per_team, hidden=hidden)
    jgrads, jm = jax.grad(jppo.ppo_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, variables), jmodel, jnp.asarray(obs),
        *map(jnp.asarray, rows), jnp.asarray(take(adv_blk)),
        jnp.asarray(take(data["ret_blk"])), cfg_j)

    model = actor_critic_from_flax(variables, P.players_per_team, device="cpu")
    loss, tm = tppo.ppo_loss(
        model, torch.from_numpy(obs), *map(torch.from_numpy, rows),
        torch.from_numpy(take(adv_blk)), torch.from_numpy(take(data["ret_blk"])),
        cfg_t)
    loss.backward()
    for i, layer in enumerate(model.dense_layers()):
        g = jgrads["params"][f"Dense_{i}"]
        np.testing.assert_allclose(layer.weight.grad.numpy().T, _np(g["kernel"]),
                                   rtol=2e-4, atol=2e-6)
        np.testing.assert_allclose(layer.bias.grad.numpy(), _np(g["bias"]),
                                   rtol=2e-4, atol=2e-6)
    assert set(tm) == set(jm)
    for k in tm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=2e-4,
                                   atol=1e-6, err_msg=k)


def test_fused_reference_f32_matches_jax_kernel(k3_case):
    """K3's plain version against JAX's kernel, both float32: gradients
    in the weights' shapes (dW1 with F rows, not F_pad) and the four
    metric sums."""
    want_g, want_m = k3_case["f32"]
    got_g, got_m = _port_reference(k3_case["case"], k3_case["hidden"],
                                   torch.float32)
    assert [g.shape for g in got_g] == [g.shape for g in want_g]
    assert got_g[0].shape == (F, k3_case["hidden"][0])
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-6)
    assert set(got_m) == set(tfu.METRICS)
    for k in tfu.METRICS:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=2e-4, err_msg=k)


def test_fused_reference_bf16_rounds_where_jax_does(k3_case):
    """K3's plain version against JAX's kernel, both bfloat16: per leaf
    within 2e-4 rel-L2 and within a fifth of the float32-to-bfloat16
    gap of the same leaf (module docstring)."""
    want_g, want_m = k3_case["bf16"]
    f32_g, _ = k3_case["f32"]
    got_g, got_m = _port_reference(k3_case["case"], k3_case["hidden"],
                                   torch.bfloat16)
    for i, (a, b, c) in enumerate(zip(got_g, want_g, f32_g)):
        gap = _rel_l2(c, b)
        err = _rel_l2(a, b)
        assert err <= 2e-4 and err <= gap / 5, (i, err, gap)
    for k in tfu.METRICS:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=2e-4, err_msg=k)


def test_fused_reference_per_sample_terms(k3_case):
    """``per_sample=True``: the metric sums' per-sample terms (summing to
    the same metrics) and the 0/1 masks of the samples whose gradient a
    clip zeroes, which an unbounded clip range empties."""
    variables, data, _, adv_n, idx = k3_case["case"]
    hidden = k3_case["hidden"]
    model = actor_critic_from_flax(variables, P.players_per_team, device="cpu")
    args = (tfc.flatten_actor_critic(model),
            *(torch.from_numpy(v) for v in data.values()),
            torch.from_numpy(adv_n), torch.from_numpy(idx))
    kw = _kw(tppo.PPOConfig(), hidden)
    grads, sums = tfu.fused_minibatch_grad_reference(*args, **kw)
    grads2, terms = tfu.fused_minibatch_grad_reference(*args, **kw,
                                                       per_sample=True)
    assert set(terms) == {*tfu.METRICS, "pg_clip", "v_clip"}
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))
    for k in tfu.METRICS:
        assert terms[k].shape == (len(idx) * BLOCK,)
        assert torch.equal(terms[k].sum(), sums[k]), k
    for k in ("pg_clip", "v_clip"):
        assert set(terms[k].unique().tolist()) == {0.0, 1.0}, k
    _, wide = tfu.fused_minibatch_grad_reference(
        *args, **{**kw, "clip_eps": 1e9}, per_sample=True)
    assert wide["pg_clip"].sum() == 0 and wide["v_clip"].sum() == 0


def test_fused_wrapper_cpu_path(monkeypatch):
    """On CPU tensors the wrapper is its plain version: no build, no
    launch counted; a permuted idx reads the blocks it names."""
    def refuse():
        raise AssertionError("the CPU path reached the kernel build")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    ops.reset_launch_counts()
    hidden = (16,)
    variables, data, _, adv_n, idx = _minibatch_case(3, hidden, idx=(3, 1))
    model = actor_critic_from_flax(variables, P.players_per_team, device="cpu")
    args = (tfc.flatten_actor_critic(model),
            *(torch.from_numpy(v) for v in data.values()),
            torch.from_numpy(adv_n), torch.from_numpy(idx))
    kw = _kw(tppo.PPOConfig(), hidden)
    got = ops.fused_minibatch_grad(*args, **kw, compute_dtype=torch.float32)
    want = ops.fused_minibatch_grad_reference(*args, **kw,
                                              compute_dtype=torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    assert ops.LAUNCHES["fused_minibatch_grad"] == 0
    # the same minibatch gathered and handed over as blocks 0 and 1
    obs = data["obs_fm"].reshape(F_PAD, -1, BLOCK)[:, idx].reshape(F_PAD, -1)
    rows = {k: torch.from_numpy(np.ascontiguousarray(v[idx]))
            for k, v in data.items() if k != "obs_fm"}
    again = ops.fused_minibatch_grad(
        args[0], torch.from_numpy(obs), **rows, adv_n=args[-2],
        idx=torch.tensor([0, 1], dtype=torch.int32), **kw,
        compute_dtype=torch.float32)
    for a, b in zip(got[0], again[0]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


def test_fused_wrapper_validates_inputs():
    hidden = (16,)
    variables, data, _, adv_n, idx = _minibatch_case(4, hidden)
    model = actor_critic_from_flax(variables, P.players_per_team, device="cpu")
    w = tfc.flatten_actor_critic(model)
    d = {k: torch.from_numpy(v) for k, v in data.items()}
    kw = _kw(tppo.PPOConfig(), hidden)
    a, i = torch.from_numpy(adv_n), torch.from_numpy(idx)
    ops.fused_minibatch_grad(w, **d, adv_n=a, idx=i, **kw)   # well-formed
    with pytest.raises(ValueError):                           # idx past the end
        ops.fused_minibatch_grad(w, **d, adv_n=a, idx=torch.tensor(
            [4, 0], dtype=torch.int32), **kw)
    with pytest.raises(ValueError):                           # int64 idx
        ops.fused_minibatch_grad(w, **d, adv_n=a, idx=i.long(), **kw)
    with pytest.raises(ValueError):                           # obs rows not /8
        ops.fused_minibatch_grad(w, **{**d, "obs_fm": d["obs_fm"][:F]},
                                 adv_n=a, idx=i, **kw)
    with pytest.raises(ValueError):                           # block not /128
        ops.fused_minibatch_grad(w, **d, adv_n=a, idx=i, **{**kw, "block": 64})
    with pytest.raises(ValueError):                           # no value head
        ops.fused_minibatch_grad(w[:-2], **d, adv_n=a, idx=i, **kw)
    with pytest.raises(ValueError):
        ops.fused_minibatch_grad(w, **d, adv_n=a, idx=i, **kw,
                                 compute_dtype=torch.float16)


def test_unflatten_actor_critic_round_trip():
    """Kernel-order gradients land in each nn.Linear's .grad, transposed
    to [out, in]: unflatten(flatten(model)) puts the weights there."""
    gen = torch.Generator().manual_seed(5)
    model = ActorCritic(2, F, (16, 8), generator=gen, device="cpu")
    ops.unflatten_actor_critic(tfc.flatten_actor_critic(model), model)
    for layer in model.dense_layers():
        assert torch.equal(layer.weight.grad, layer.weight.detach())
        assert torch.equal(layer.bias.grad, layer.bias.detach())
    with pytest.raises(ValueError):
        ops.unflatten_actor_critic(tfc.flatten_actor_critic(model)[:-2], model)


def test_layout_helpers_match_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 8)).astype(np.float32)
    obs3 = rng.normal(size=(3, 8, 5)).astype(np.float32)
    np.testing.assert_array_equal(tppo._flatten_tm(torch.from_numpy(x)).numpy(),
                                  _np(jppo._flatten_tm(jnp.asarray(x))))
    np.testing.assert_array_equal(tppo._obs_to_fm(torch.from_numpy(obs3)).numpy(),
                                  _np(jppo._obs_to_fm(jnp.asarray(obs3))))
    for n, sb, mbs in ((4096, 1024, 4), (3000, 1024, 4), (512, 128, 2),
                       (97, 16, 4)):
        jc = jppo.PPOConfig(shuffle_block=sb, minibatches=mbs)
        tc = tppo.PPOConfig(shuffle_block=sb, minibatches=mbs)
        assert tppo._shuffle_block_for(n, tc) == jppo._shuffle_block_for(n, jc)


# ---------------------------------------------------------------------------
# The optimiser
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("total_iters,lr_final", [
    (None, None), (3, None), (3, 0.0), (2, 1e-5)],
    ids=["constant", "floor", "to-zero", "explicit"])
def test_optimizer_schedule_matches_optax(total_iters, lr_final):
    """The learning rate of every update, past the end of the anneal:
    JAX's make_optimizer's step on a gradient under the clip, divided by
    optax's bare Adam direction for the same gradients, against the
    port's lr_at(k)."""
    jcfg = jppo.PPOConfig(epochs=2, minibatches=2, lr_final=lr_final)
    tcfg = tppo.PPOConfig(epochs=2, minibatches=2, lr_final=lr_final)
    tx, adam = jppo.make_optimizer(jcfg, total_iters), optax.scale_by_adam()
    params = jnp.zeros(())
    state, adam_state = tx.init(params), adam.init(params)
    model = ActorCritic(2, F, (4,), device="cpu")
    opt = tppo.make_optimizer(model, tcfg, total_iters)
    for k in range(15):
        grad = jnp.float32(0.25 + 0.01 * k)     # under the clip
        upd, state = tx.update(grad, state, params)
        direction, adam_state = adam.update(grad, adam_state, params)
        lr_jax = -float(upd) / float(direction)
        np.testing.assert_allclose(opt.lr_at(k), lr_jax, rtol=1e-5, atol=1e-12,
                                   err_msg=f"update {k}")


def test_optimizer_clip_and_adam_match_optax():
    """Global-norm clipping above and below the threshold, then three
    Adam steps on the same gradients, against optax's chain."""
    rng = np.random.default_rng(7)
    cfg = tppo.PPOConfig(lr=1e-2)
    shapes = [(4, 3), (3,), (2, 3)]
    for scale in (0.01, 5.0):                       # norm below / above 0.5
        init = [rng.normal(size=s).astype(np.float32) for s in shapes]
        grads = [[(scale * rng.normal(size=s)).astype(np.float32) for s in shapes]
                 for _ in range(3)]
        tx = jppo.make_optimizer(jppo.PPOConfig(lr=1e-2))
        jp = [jnp.asarray(x) for x in init]
        state = tx.init(jp)
        clip = optax.clip_by_global_norm(cfg.max_grad_norm)
        tp = [torch.tensor(x, requires_grad=True) for x in init]
        opt = tppo.Optimizer(tp, cfg.lr, cfg.max_grad_norm)
        for step, g in enumerate(grads):
            for p, gk in zip(tp, g):
                p.grad = torch.tensor(gk)
            if step == 0:
                opt.clip_grads()
                want, _ = clip.update([jnp.asarray(x) for x in g], clip.init(jp))
                for p, w in zip(tp, want):
                    np.testing.assert_allclose(p.grad.numpy(), _np(w), rtol=1e-6,
                                               atol=1e-7)
                for p, gk in zip(tp, g):
                    p.grad = torch.tensor(gk)
            upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
            jp = optax.apply_updates(jp, upd)
            opt.step()
        for p, w in zip(tp, jp):
            np.testing.assert_allclose(p.detach().numpy(), _np(w), atol=1e-6)
        assert opt.count == 3


# ---------------------------------------------------------------------------
# update_epochs, update_epochs_fused
# ---------------------------------------------------------------------------


def _update_case(seed=8):
    """A [T=2, 2B=256] trajectory with feature-major obs (4 blocks of
    128), its GAE, hidden (16,), and JAX's permutations for 2 epochs."""
    rng = np.random.default_rng(seed)
    t, b2 = 2, 256
    obs = np.zeros((F_PAD, t * b2), np.float32)
    obs[:F] = rng.normal(0.0, 1.0, (F, t * b2))
    traj = dict(
        obs=obs, dirs=_packed(rng, (t, b2)), acts=_packed(rng, (t, b2)),
        logp=-np.abs(rng.normal(0.0, 1.0, (t, b2))).astype(np.float32) * 4,
        value=rng.normal(0.0, 1.0, (t, b2)).astype(np.float32),
        reward=rng.normal(0.0, 1.0, (t, b2)).astype(np.float32),
        done=rng.random((t, b2)) < 0.1,
    )
    return _variables(rng, (16,)), traj


def test_update_epochs_match_jax():
    """Both port updates (plain versions on the CPU) against JAX's
    update_epochs and update_epochs_fused (interpret, float32), fed JAX's
    per-epoch block permutations: parameters and mean loss."""
    variables, traj = _update_case()
    jcfg = jppo.PPOConfig(rollout_steps=2, epochs=2, minibatches=2,
                          shuffle_block=BLOCK, remat=False)
    tcfg = tppo.PPOConfig(rollout_steps=2, epochs=2, minibatches=2,
                          shuffle_block=BLOCK)
    key = jax.random.PRNGKey(11)
    n_blocks = traj["reward"].size // BLOCK
    perms = torch.from_numpy(np.stack([
        _np(jax.random.permutation(k, n_blocks))
        for k in jax.random.split(key, jcfg.epochs)]).astype(np.int64))

    jmodel = JActorCritic(n_players=P.players_per_team, hidden=(16,))
    jtraj = jppo.Transition(**{k: jnp.asarray(v) for k, v in traj.items()})
    jadv, jret = jppo.compute_gae(jtraj, jnp.zeros(256), jcfg)
    tx = jppo.make_optimizer(jcfg)
    params = jax.tree.map(jnp.asarray, variables)
    jax_out = {
        "plain": jppo.update_epochs(params, tx.init(params), jtraj, jadv, jret,
                                    key, jmodel, tx, jcfg),
        "fused": jppo.update_epochs_fused(
            params, tx.init(params), jtraj, jadv, jret, key, jmodel, tx, jcfg,
            interpret=True, compute_dtype=jnp.float32),
    }
    ttraj = tppo.Transition(**{k: torch.from_numpy(v) for k, v in traj.items()})
    tadv, tret = tppo.compute_gae(ttraj, torch.zeros(256), tcfg)
    np.testing.assert_allclose(tadv.numpy(), _np(jadv), rtol=1e-5, atol=1e-5)
    for name, fn, kw in (
            ("plain", tppo.update_epochs, {}),
            ("fused", tppo.update_epochs_fused, {"compute_dtype": torch.float32})):
        model = actor_critic_from_flax(variables, P.players_per_team,
                                       device="cpu")
        opt = tppo.make_optimizer(model, tcfg)
        m = fn(model, opt, ttraj, tadv, tret, torch.Generator(), tcfg,
               perms=perms, **kw)
        jparams, _, jm = jax_out[name]
        assert opt.count == tcfg.epochs * tcfg.minibatches
        for i, layer in enumerate(model.dense_layers()):
            g = jparams["params"][f"Dense_{i}"]
            np.testing.assert_allclose(layer.weight.detach().numpy().T,
                                       _np(g["kernel"]), rtol=5e-3, atol=5e-5,
                                       err_msg=f"{name} Dense_{i}")
            np.testing.assert_allclose(layer.bias.detach().numpy(),
                                       _np(g["bias"]), rtol=5e-3, atol=5e-5)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=5e-3, atol=5e-5, err_msg=name)
        assert set(m) == set(jm)


def test_update_epochs_fused_refuses_bad_buffers():
    variables, traj = _update_case()
    ttraj = tppo.Transition(**{k: torch.from_numpy(v) for k, v in traj.items()})
    model = actor_critic_from_flax(variables, P.players_per_team, device="cpu")
    cfg = tppo.PPOConfig(epochs=1, minibatches=2, shuffle_block=1024)
    adv = torch.zeros(2, 256)
    opt = tppo.make_optimizer(model, cfg)
    with pytest.raises(ValueError, match="shuffle_block"):   # 512 samples
        tppo.update_epochs_fused(model, opt, ttraj, adv, adv, torch.Generator(),
                                 cfg)
    row_major = tppo.Transition(**{**ttraj.__dict__,
                                   "obs": torch.zeros(2, 256, F)})
    with pytest.raises(ValueError, match="feature-major"):
        tppo.update_epochs_fused(model, opt, row_major, adv, adv,
                                 torch.Generator(), cfg)
    with pytest.raises(ValueError, match="perms"):
        tppo.update_epochs(model, opt, ttraj, adv, adv, torch.Generator(), cfg,
                           perms=torch.zeros(2, 4, dtype=torch.long))
    with pytest.raises(ValueError, match="outside"):         # 2 blocks of 256
        tppo.update_epochs(model, opt, ttraj, adv, adv, torch.Generator(), cfg,
                           perms=torch.tensor([[0, 2]]))


# ---------------------------------------------------------------------------
# train_iteration and the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_train_iteration_cpu(fused):
    """One iteration at 2v2, 64 envs, T=4, hidden (16,), with either
    collect/update pair: finite metrics, parameters moved, one optimiser
    step per minibatch, no kernel launched."""
    params = params_from_reference(P)
    gen = torch.Generator().manual_seed(0)
    model = ActorCritic(2, F, (16,), device="cpu")
    cfg = tppo.PPOConfig(rollout_steps=4, shuffle_block=BLOCK)
    runner = tppo.init_runner(gen, model, params, cfg, 64)
    before = [p.detach().clone() for p in model.parameters()]
    ops.reset_launch_counts()
    kw = dict(collect_fn=tppo.collect_rollout_fused,
              update_fn=tppo.update_epochs_fused) if fused else {}
    runner, metrics = tppo.train_iteration(runner, params, cfg, **kw)
    assert set(metrics) == {"loss", "pg_loss", "v_loss", "entropy",
                            "approx_kl", "mean_reward"}
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert 0.0 < float(metrics["entropy"]) <= 4 * np.log(5) + 1e-5
    assert all(not torch.equal(a, b) for a, b in zip(before, model.parameters()))
    assert runner.optimizer.count == cfg.epochs * cfg.minibatches
    assert sum(ops.LAUNCHES.values()) == 0


@pytest.mark.parametrize("argv", [
    ["--envs", "64", "--rollout-steps", "4"],
    ["--envs", "512", "--rollout-steps", "4", "--fused-collect", "--lr-anneal"],
], ids=["plain", "fused"])
def test_cli_main_cpu(argv):
    """`python -m gym_futbol_tpu_torch.train ... --device cpu`: one
    iteration record with the JAX CLI's keys, then the done record."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runner = ttrain.main(["--device", "cpu", "--ppt", "2", "--iters", "1",
                              "--hidden", "16", *argv])
    lines = [json.loads(s) for s in out.getvalue().splitlines()]
    assert len(lines) == 2
    rec, done = lines
    assert rec["step"] == 0 and {"wall_s", "env_steps_per_sec", "loss",
                                 "pg_loss", "v_loss", "entropy", "approx_kl",
                                 "mean_reward"} <= set(rec)
    assert all(np.isfinite(v) for v in rec.values())
    n_envs = int(argv[1])
    assert done == {"done": True, "total_env_steps": n_envs * 4,
                    "wall_s": done["wall_s"],
                    "env_steps_per_sec": done["env_steps_per_sec"]}
    assert runner.optimizer.count == 16


def test_cli_eval_vs_random_cpu():
    """``--iters 0 --eval-episodes N``: the untrained policy plays N full
    episodes against uniform random play; one eval record, then done."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ttrain.main(["--device", "cpu", "--ppt", "2", "--iters", "0",
                     "--envs", "64", "--hidden", "16", "--max-steps", "5",
                     "--eval-episodes", "32"])
    lines = [json.loads(s) for s in out.getvalue().splitlines()]
    assert len(lines) == 2 and lines[1]["done"] is True
    ev = lines[0]["eval_vs_random"]
    assert ev["episodes"] == 32 and len(ev["goals_per_episode"]) == 2
    assert abs(ev["win"] + ev["loss"] + ev["draw"] - 1.0) < 1e-9
