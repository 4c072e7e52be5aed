"""The port's user-facing surface (``FutbolEnv``, spaces, registry,
entities, render, profiling helpers) against the JAX package's on the
CPU, on the same states.

Bounds, with their reasons: ``FutbolEnv.step`` against JAX's from the
same state at zero kick and placement noise (the env's draws then do not
matter): positions rtol 1e-4 / atol 1e-3, velocities and observations
rtol 1e-4 / atol 1e-4, rewards rtol 1e-5 / atol 1e-5 (XLA contracts
multiply-adds into FMAs on the CPU, so one step parts in the last bits,
spread by the contact solver; tests/test_torch_fused_collect.py),
integers, flags and ``done`` exact.
Entity views read the same numbers (exact); the renders draw the same
positions (the ASCII frame string-equal, the matplotlib frame
pixel-equal).
"""

import contextlib
import inspect
import io
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import gym_futbol_tpu as J  # noqa: E402
import gym_futbol_tpu_torch as G  # noqa: E402
from gym_futbol_tpu import RewardConfig as JRewardConfig  # noqa: E402
from gym_futbol_tpu.render import render_state as jrender  # noqa: E402
from gym_futbol_tpu.types import EnvState as JEnvState  # noqa: E402
from gym_futbol_tpu_torch import render as trender  # noqa: E402
from gym_futbol_tpu_torch import spaces as tspaces  # noqa: E402
from gym_futbol_tpu_torch.interop import params_from_reference  # noqa: E402
from gym_futbol_tpu_torch.utils import profiling  # noqa: E402

from _torch_cases import custom_params, game_states, random_actions  # noqa: E402

ZERO = dict(kick_noise=0.0, placement_noise=0.0)
CASES = {
    "2v2": J.EnvParams(players_per_team=2, substeps=2, solver_iterations=4,
                       max_steps=12, **ZERO),
    "custom": custom_params(J.EnvParams, JRewardConfig).replace(**ZERO),
}
POS_TOL = dict(rtol=1e-4, atol=1e-3)
VEL_TOL = dict(rtol=1e-4, atol=1e-4)
REW_TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.asarray(x)


def _states(ref, b, seed):
    """``b`` game-like single-env states as (JAX EnvState, the port's
    single-env EnvState) pairs."""
    pos, vel, poss, score, t = game_states(np.random.default_rng(seed), ref, b)
    out = []
    for e in range(b):
        j = JEnvState(pos=jnp.asarray(pos[e], jnp.float32),
                      vel=jnp.asarray(vel[e], jnp.float32),
                      possession=jnp.asarray(poss[e]), score=jnp.asarray(score[e]),
                      t=jnp.asarray(t[e]), key=jax.random.PRNGKey(e))
        p = G.EnvState(pos=torch.tensor(pos[e], dtype=torch.float32),
                       vel=torch.tensor(vel[e], dtype=torch.float32),
                       possession=torch.tensor(poss[e]), score=torch.tensor(score[e]),
                       t=torch.tensor(t[e]))
        out.append((j, p))
    return out


# ---------------------------------------------------------------------------
# FutbolEnv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_futbol_env_matches_jax(name):
    """reset() and 16 step()s of the port's FutbolEnv against JAX's on the
    same states and actions, from the kickoff and from game-like states,
    past ``done`` (no auto-reset in either): obs, reward, done, every
    info entry and the state after each step."""
    ref = CASES[name]
    params = params_from_reference(ref)
    rng = np.random.default_rng(3)
    starts = [None] + _states(ref, 3, 4)
    for start in starts:
        jenv, tenv = J.FutbolEnv(ref, seed=1), G.FutbolEnv(params, seed=1,
                                                           device="cpu")
        jobs, tobs = jenv.reset(), tenv.reset()
        np.testing.assert_allclose(tobs.numpy(), _np(jobs), **VEL_TOL)
        if start is not None:
            jenv._state = start[0]
        for k in range(16):
            # lockstep: each step starts from JAX's state, so the last-bit
            # drift of a free run does not pile up
            js = jenv.state
            tenv._state = G.EnvState(**{f: torch.from_numpy(np.array(
                getattr(js, f)))[None] for f in ("pos", "vel", "possession",
                                                 "score", "t")})
            a = random_actions(rng, ref, ())
            jo, jr, jd, ji = jenv.step(jnp.asarray(a))
            to, tr, td, ti = tenv.step(torch.from_numpy(a))
            what = f"{name} start {start is not None} step {k}"
            assert to.shape == (G.obs_size(params),) and tr.shape == ()
            np.testing.assert_allclose(to.numpy(), _np(jo), **VEL_TOL, err_msg=what)
            np.testing.assert_allclose(float(tr), float(jr), **REW_TOL, err_msg=what)
            assert td is jd, what
            assert set(ti) == set(ji)
            for key in ti:
                np.testing.assert_array_equal(ti[key].numpy(), _np(ji[key]),
                                              err_msg=f"{what} {key}")
            js, ts = jenv.state, tenv.state
            np.testing.assert_allclose(ts.pos.numpy(), _np(js.pos), **POS_TOL)
            np.testing.assert_allclose(ts.vel.numpy(), _np(js.vel), **VEL_TOL)
            for key in ("possession", "score", "t"):
                np.testing.assert_array_equal(getattr(ts, key).numpy(),
                                              _np(getattr(js, key)))
        assert td                                   # past max_steps


def test_futbol_env_contract():
    """step() before reset() raises; the spaces match JAX's; seed()
    restarts the noise stream; render modes."""
    ref = J.EnvParams(players_per_team=2)
    env = G.FutbolEnv(params_from_reference(ref), seed=0, device="cpu")
    jenv = J.FutbolEnv(ref)
    assert env.state is None
    with pytest.raises(RuntimeError, match="reset"):
        env.step(torch.zeros(4, 2, dtype=torch.int32))
    assert env.action_space.shape == jenv.action_space.shape
    assert (env.action_space.nvec == jenv.action_space.nvec).all()
    assert env.observation_space.shape == jenv.observation_space.shape
    first = env.reset()
    env.seed(0)
    again = env.reset()
    assert torch.equal(first, again)
    env.seed(1)
    assert not torch.equal(env.reset(), first)       # placement noise 0.1
    assert env.observation_space.contains(first)
    s = env.render(mode="ansi")
    assert "o" in s and "A" in s and "B" in s and s.startswith("score 0:0 t=0")


def test_entry_points_default_to_the_card():
    """Every new entry point that places tensors defaults to the card."""
    from gym_futbol_tpu_torch.parallel import mesh

    for fn in (G.FutbolEnv, G.make, trender.render_episode, tspaces.Box,
               tspaces.Discrete, tspaces.MultiDiscrete, mesh.init_distributed,
               mesh.rank_device, mesh.default_backend):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


# ---------------------------------------------------------------------------
# Spaces
# ---------------------------------------------------------------------------


def test_spaces_match_jax():
    """Shapes, dtypes, reprs and ``contains`` as JAX's on the same inputs;
    samples on an explicit generator lie in the space, are reproducible
    and reach every value."""
    gen = torch.Generator().manual_seed(0)
    for j, t in ((J.Box(0.0, 2.0, shape=(3,)), tspaces.Box(0.0, 2.0, shape=(3,),
                                                              device="cpu")),
                 (J.Discrete(5), tspaces.Discrete(5, device="cpu")),
                 (J.MultiDiscrete([[5, 5]] * 4),
                  tspaces.MultiDiscrete([[5, 5]] * 4, device="cpu"))):
        assert t.shape == j.shape
        assert repr(t).split("(")[0] == repr(j).split("(")[0]
        samples = [t.sample(gen) for _ in range(400)]
        assert all(t.contains(x) and j.contains(_np(x)) for x in samples)
        assert all(tuple(x.shape) == j.shape for x in samples)
        if not isinstance(t, tspaces.Box):
            assert samples[0].dtype == torch.int32
            hi = 5
            assert torch.stack(samples).unique().tolist() == list(range(hi))
        else:
            assert samples[0].dtype == torch.float32
    g1, g2 = (torch.Generator().manual_seed(9) for _ in range(2))
    md = tspaces.MultiDiscrete([[5, 5]] * 4, device="cpu")
    assert torch.equal(md.sample(g1), md.sample(g2))
    probes = {
        "box": (J.Box(-1.0, 1.0, shape=(2,)),
                tspaces.Box(-1.0, 1.0, shape=(2,), device="cpu"),
                [[0.0, 0.5], [1.0, -1.0], [1.5, 0.0], [0.0, 0.0, 0.0]]),
        "discrete": (J.Discrete(3), tspaces.Discrete(3, device="cpu"),
                     [0, 2, 3, -1]),
        "multi": (J.MultiDiscrete([[5, 5]] * 2),
                  tspaces.MultiDiscrete([[5, 5]] * 2, device="cpu"),
                  [[[0, 4], [2, 2]], [[5, 0], [0, 0]], [[0, -1], [1, 1]],
                   [[0, 0]]]),
    }
    for name, (j, t, xs) in probes.items():
        for x in xs:
            assert t.contains(x) == j.contains(x), (name, x)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


def test_registry_matches_jax():
    """The same ids; each resolves to JAX's params (overrides too); make
    builds a FutbolEnv on the given device; unknown and duplicate ids
    raise as in JAX."""
    assert G.registered_ids() == J.registered_ids()
    for env_id in G.registered_ids():
        assert G.make_params(env_id) == params_from_reference(J.make_params(env_id))
    assert G.make_params("futbol-v0", max_steps=7) == params_from_reference(
        J.make_params("futbol-v0", max_steps=7))
    env = G.make("futbol-3v3-v0", seed=2, device="cpu", max_steps=9)
    assert isinstance(env, G.FutbolEnv) and env.device == torch.device("cpu")
    assert env.params.players_per_team == 3 and env.params.max_steps == 9
    assert env.reset().shape == (G.obs_size(env.params),)
    with pytest.raises(KeyError, match="unknown env id"):
        G.make_params("nope-v0")
    with pytest.raises(ValueError, match="already registered"):
        G.register("futbol-v0", G.EnvParams)


# ---------------------------------------------------------------------------
# Entities
# ---------------------------------------------------------------------------


def test_entities_match_jax():
    """Ball, Player and Team views of the same single-env and batched
    states read what JAX's read; a body outside the players raises."""
    ref = J.EnvParams(players_per_team=3)
    params = params_from_reference(ref)
    pairs = _states(ref, 8, 5)
    jbatch = jax.tree.map(lambda *x: jnp.stack(x), *[j for j, _ in pairs])
    tbatch = G.EnvState(**{k: torch.stack([getattr(t, k) for _, t in pairs])
                           for k in ("pos", "vel", "possession", "score", "t")})
    for js, ts in pairs[:3] + [(jbatch, tbatch)]:
        jb, tb = J.Ball(js), G.Ball(ts)
        for k in ("position", "velocity", "owner", "is_free"):
            np.testing.assert_array_equal(getattr(tb, k).numpy(), _np(getattr(jb, k)))
        for body in range(1, params.n_players + 1):
            jp, tp = J.Player(js, body, ref), G.Player(ts, body, params)
            assert tp.team == jp.team
            for k in ("position", "velocity", "has_ball"):
                np.testing.assert_array_equal(getattr(tp, k).numpy(),
                                              _np(getattr(jp, k)))
        for team in (0, 1):
            jt, tt = J.Team(js, team, ref), G.Team(ts, team, params)
            assert [p.body for p in tt.players] == [p.body for p in jt.players]
            for k in ("positions", "velocities", "has_ball", "score"):
                np.testing.assert_array_equal(getattr(tt, k).numpy(),
                                              _np(getattr(jt, k)))
    assert bool(tbatch.possession.gt(0).any()) and bool(tbatch.possession.lt(0).any())
    for body in (0, params.n_players + 1):
        with pytest.raises(IndexError):
            G.Player(tbatch, body, params)


# ---------------------------------------------------------------------------
# Render, profiling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_render_matches_jax(name):
    """render_state of the same states: "ansi" string-equal to JAX's,
    "rgb_array" pixel-equal (the ASCII frame when matplotlib does not
    import, in both), "human" prints the ASCII frame."""
    ref = CASES[name]
    params = params_from_reference(ref)
    for js, ts in _states(ref, 3, 6):
        assert trender.render_state(ts, params, "ansi") == jrender(js, ref, "ansi")
        got, want = (trender.render_state(ts, params, "rgb_array"),
                     jrender(js, ref, "rgb_array"))
        if isinstance(want, str):
            assert got == want
        else:
            assert got.dtype == np.uint8 and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert trender.render_state(ts, params, "human") is None
        assert out.getvalue() == jrender(js, ref, "ansi") + "\n"


def test_render_episode_and_video(tmp_path):
    """render_episode draws the first frame and every ``every``-th one,
    stops at ``done``; save_video writes a GIF."""
    params = params_from_reference(J.EnvParams(players_per_team=2, substeps=2,
                                               solver_iterations=3, max_steps=5))
    frames = trender.render_episode(params, seed=1, n_steps=4, every=2,
                                    device="cpu")
    assert len(frames) == 3
    assert len(trender.render_episode(params, seed=1, device="cpu")) == 6
    path = trender.save_video(frames, str(tmp_path / "ep.gif"), fps=10)
    assert os.path.getsize(path) > 1000


def test_profiling_helpers(tmp_path):
    """timed() measures a block (its sync may name CPU tensors, a no-op);
    profile_trace writes a Chrome trace and hands back the profiler."""
    x = torch.randn(64, 64)
    with profiling.timed("matmul", sync=[x, {"y": x}]) as box:
        (x @ x).sum()
    assert box["label"] == "matmul" and box["seconds"] > 0
    with profiling.profile_trace(str(tmp_path / "trace")) as prof:
        (x @ x).sum()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    assert any("mm" in e.key for e in prof.key_averages())
