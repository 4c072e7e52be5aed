"""The port's policy model, its categorical math, the observation mirror
and the weight loaders, against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances, with their reasons:
- ``ActorCritic`` against flax ``apply`` with the carried weights:
  rtol 1e-5 / atol 1e-6. The two CPU matmuls sum in different orders.
- ``sample_actions`` fed JAX's own uniforms for the key: actions equal,
  and logp within 1e-6 (9.5e-7 measured, two f32 ulps of a 4-group
  joint logp). ``exp`` and ``log`` differ in the last bit between the
  frameworks; the 6-group logp of the packed case adds rtol 1e-6.
- ``pack_actions`` and ``mirror_obs``/``mirror_actions``: exact. The
  mirror is checked against JAX's output, never against itself.
"""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gym_futbol_tpu import EnvParams as JEnvParams  # noqa: E402
from gym_futbol_tpu import env as jenv  # noqa: E402
from gym_futbol_tpu.models import policy as jpolicy  # noqa: E402
from gym_futbol_tpu.ops.fused_actor import init_mlp as jinit_mlp  # noqa: E402
from gym_futbol_tpu_torch import env as tenv  # noqa: E402
from gym_futbol_tpu_torch.interop import (  # noqa: E402
    actor_critic_from_flax,
    mlp_weights_from_numpy,
    params_from_reference,
)
from gym_futbol_tpu_torch.models import policy as tpolicy  # noqa: E402

B = 256
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flax_variables(ppt, hidden, seed=0):
    ref = JEnvParams(players_per_team=ppt)
    model = jpolicy.ActorCritic(n_players=ppt, hidden=hidden)
    variables = jpolicy.init_params(jax.random.PRNGKey(seed), model, ref)
    return ref, model, jax.tree.map(np.asarray, variables)


def _logits(rng, g5, shape=(B,)):
    return (rng.normal(0.0, 2.0, shape + (g5,))).astype(np.float32)


@pytest.mark.parametrize("ppt,hidden", [(2, (32, 16)), (3, (24,))])
def test_actor_critic_matches_flax(ppt, hidden):
    ref, model, variables = _flax_variables(ppt, hidden)
    obs = np.random.default_rng(1).normal(
        0.0, 1.0, (B, jenv.obs_size(ref))).astype(np.float32)
    jlogits, jvalue = model.apply(variables, jnp.asarray(obs))
    tmodel = actor_critic_from_flax(variables, ppt, device="cpu")
    assert tmodel.hidden == hidden and tmodel.obs_dim == jenv.obs_size(ref)
    with torch.no_grad():
        logits, value = tmodel(torch.from_numpy(obs))
    assert logits.shape == (B, ppt * 2 * 5) and value.shape == (B,)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(value.numpy(), np.asarray(jvalue),
                               rtol=1e-5, atol=1e-6)


def test_actor_critic_init_like_flax():
    """Truncated lecun-normal kernels and zero biases, as flax's Dense:
    per layer, |w| <= 2 * std / 0.8796 and the std within 5% of
    sqrt(1 / fan_in)."""
    gen = torch.Generator().manual_seed(3)
    model = tpolicy.ActorCritic(2, 22, (256, 128), generator=gen,
                                device="cpu")
    for layer in model.dense_layers():
        w = layer.weight.detach()
        want = (1.0 / layer.in_features) ** 0.5
        assert (layer.bias == 0).all()
        assert w.abs().max() <= 2.0 * want / tpolicy._TRUNC_STD + 1e-6
        if w.numel() >= 1000:
            assert abs(w.std().item() / want - 1.0) < 0.05
    again = tpolicy.ActorCritic(2, 22, (256, 128),
                                generator=torch.Generator().manual_seed(3),
                                device="cpu")
    assert torch.equal(again.torso[0].weight, model.torso[0].weight)


@pytest.mark.parametrize("batch", [(B,), (3, 64)])
def test_sample_actions_matches_jax(batch):
    g5 = 2 * 2 * 5
    logits = _logits(np.random.default_rng(2), g5, batch)
    key = jax.random.PRNGKey(11)
    jact, jlogp = jpolicy.sample_actions(key, jnp.asarray(logits))
    u = jax.random.uniform(key, (g5 // 5,) + batch, jnp.float32)
    act, logp = tpolicy.sample_actions(torch.from_numpy(logits),
                                       torch.from_numpy(np.array(u)))
    assert act.dtype == torch.int32 and act.shape == batch + (2, 2)
    np.testing.assert_array_equal(act.numpy(), np.asarray(jact))
    np.testing.assert_allclose(logp.numpy(), np.asarray(jlogp), atol=1e-6)
    # every choice is reached
    assert set(np.unique(act.numpy())) == set(range(5))


def test_sample_actions_from_generator():
    logits = torch.from_numpy(_logits(np.random.default_rng(4), 30))
    a1, l1 = tpolicy.sample_actions(logits, generator=torch.Generator().manual_seed(5))
    a2, l2 = tpolicy.sample_actions(logits, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a1, a2) and torch.equal(l1, l2)
    with pytest.raises(ValueError):
        tpolicy.sample_actions(logits, torch.zeros(5, B + 1))


def test_pack_and_log_prob_match_jax():
    rng = np.random.default_rng(6)
    actions = rng.integers(0, 5, (B, 3, 2)).astype(np.int32)
    logits = _logits(rng, 30)
    jd, ja = jpolicy.pack_actions(jnp.asarray(actions))
    td, ta = tpolicy.pack_actions(torch.from_numpy(actions))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    jlp, jent = jpolicy.action_log_prob_and_entropy_packed(
        jnp.asarray(logits), jd, ja)
    lp, ent = tpolicy.action_log_prob_and_entropy_packed(
        torch.from_numpy(logits), td, ta)
    # a joint logp of 6 groups reaches -15, where 2 f32 ulps are 1.9e-6
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ent.numpy(), np.asarray(jent), rtol=1e-6,
                               atol=1e-6)
    lp2, ent2 = tpolicy.action_log_prob_and_entropy(
        torch.from_numpy(logits), torch.from_numpy(actions))
    assert torch.equal(lp2, lp) and torch.equal(ent2, ent)


@pytest.mark.parametrize("ppt", [1, 2, 3, 5])
def test_mirror_matches_jax(ppt):
    ref = JEnvParams(players_per_team=ppt)
    params = params_from_reference(ref)
    rng = np.random.default_rng(ppt)
    # rows shaped like observations: positions in [0, 1], velocities,
    # and one-hot or empty possession flags
    n = ref.n_bodies
    obs = np.concatenate([
        rng.random((B, 2 * n)), rng.normal(0.0, 0.5, (B, 2 * n)),
        np.eye(3)[rng.integers(0, 3, B)][:, :2]], 1).astype(np.float32)
    np.testing.assert_array_equal(
        tenv.mirror_obs(torch.from_numpy(obs), params).numpy(),
        np.asarray(jenv.mirror_obs(jnp.asarray(obs), ref)))
    actions = rng.integers(0, 5, (B, ppt, 2)).astype(np.int32)
    np.testing.assert_array_equal(
        tenv.mirror_actions(torch.from_numpy(actions)).numpy(),
        np.asarray(jenv.mirror_actions(jnp.asarray(actions))))


def test_make_policy_fn_and_init_params():
    params = params_from_reference(JEnvParams(players_per_team=2))
    gen = torch.Generator().manual_seed(0)
    model = tpolicy.init_params(
        gen, tpolicy.ActorCritic(2, tenv.obs_size(params), (16,), device="cpu"),
        params)
    obs = tenv.reset(gen, params, 8, device="cpu")[1]
    actions = tpolicy.make_policy_fn(model)(gen, obs)
    assert actions.shape == (8, 2, 2) and actions.dtype == torch.int32
    with pytest.raises(ValueError):
        tpolicy.init_params(gen, tpolicy.ActorCritic(2, 7, (16,), device="cpu"),
                            params)


def test_mlp_weights_from_numpy():
    ref = JEnvParams(players_per_team=2)
    jw = jinit_mlp(jax.random.PRNGKey(0), ref, (32, 16))
    tw = mlp_weights_from_numpy([np.asarray(w) for w in jw], device="cpu")
    assert len(tw) == len(jw)
    for t, j in zip(tw, jw):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_port_imports_no_jax():
    """The port imports torch and never JAX, flax, optax or the JAX
    package: with all four made unimportable, every module of the package
    (ppo, train, ops.fused_update, the recurrent learners' a2c,
    recurrent_ppo, models.recurrent and ops.fused_recurrent, wrappers,
    utils.checkpoint and utils.metrics, and the distribution layer and
    user-facing surface: parallel.mesh, parallel.rollout, spaces,
    entities, registry, render and utils.profiling among them, and the
    learning gates check_learning and check_recurrent_learning) still
    imports. No module is loaded from parity/ (the JAX package's
    scripts), and both learning gates ask for the card when no --device
    is given."""
    code = (
        "import os, sys, pkgutil, importlib\n"
        "for name in ('jax', 'flax', 'optax', 'gym_futbol_tpu', 'parity'):\n"
        "    sys.modules[name] = None\n"
        "import gym_futbol_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert {'gym_futbol_tpu_torch.train', 'gym_futbol_tpu_torch.ppo',\n"
        "        'gym_futbol_tpu_torch.ops.fused_update',\n"
        "        'gym_futbol_tpu_torch.a2c', 'gym_futbol_tpu_torch.recurrent_ppo',\n"
        "        'gym_futbol_tpu_torch.models.recurrent',\n"
        "        'gym_futbol_tpu_torch.ops.fused_recurrent',\n"
        "        'gym_futbol_tpu_torch.wrappers',\n"
        "        'gym_futbol_tpu_torch.utils.checkpoint',\n"
        "        'gym_futbol_tpu_torch.utils.metrics',\n"
        "        'gym_futbol_tpu_torch.parallel.mesh',\n"
        "        'gym_futbol_tpu_torch.parallel.rollout',\n"
        "        'gym_futbol_tpu_torch.spaces', 'gym_futbol_tpu_torch.entities',\n"
        "        'gym_futbol_tpu_torch.registry', 'gym_futbol_tpu_torch.render',\n"
        "        'gym_futbol_tpu_torch.utils.profiling',\n"
        "        'gym_futbol_tpu_torch.check_learning',\n"
        "        'gym_futbol_tpu_torch.check_recurrent_learning'} <= set(names)\n"
        "assert not any(k.startswith(('jax', 'flax', 'optax', 'gym_futbol_tpu.'))\n"
        "               and sys.modules[k] for k in sys.modules)\n"
        "parity = os.path.join(os.getcwd(), 'parity') + os.sep\n"
        "assert not any((getattr(m, '__file__', None) or '').startswith(parity)\n"
        "               for m in list(sys.modules.values()) if m)\n"
        "from gym_futbol_tpu_torch import check_learning, check_recurrent_learning\n"
        "assert check_learning.parse_args([]).device == 'cuda'\n"
        "assert check_recurrent_learning.parse_args([]).device == 'cuda'\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
