"""The fused rollout's plain PyTorch version against the JAX package's
Pallas kernel (interpret mode on the CPU), its draws, its layout, and
its wrappers' CPU path.

- Replay mode against ``fused_rollout_replay(..., interpret=True)`` at
  the parameter sets of tests/test_ops.py.
- Table mode against ``fused_rollout(..., interpret=True)``, fed the
  uniform table that kernel builds itself from the seed
  (``gym_futbol_tpu/ops/fused_rollout.py:373``): this holds the port's
  draw order and draw derivations against JAX's.
- ``pack_state``/``unpack_state`` against the JAX layout.
- Philox4x32-10 against published known-answer vectors.
- CPU tensors never reach the kernel build.

Trajectories run free for T steps from a kickoff, so last-bit
differences (XLA's FMA contraction, see test_torch_physics.py) grow
along them: pos/vel rtol 1e-4 / atol 1e-3, integers exact, rewards
rtol 1e-5 / atol 1e-5 in replay (as tests/test_ops.py holds the Pallas
kernel to the jnp path; 7e-7 measured) and rtol 1e-4 / atol 1e-4 in
table mode, where the kick angle also passes through log and cos,
which differ in the last bit between the frameworks (3.4e-6 measured).

The kernel itself is compared with this plain version on the card by
tests/test_torch_cuda.py and by chip_smoke.py.
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
from gym_futbol_tpu.vector import reset_batch as jreset_batch  # noqa: E402
from gym_futbol_tpu_torch import ops  # noqa: E402
from gym_futbol_tpu_torch.interop import (  # noqa: E402
    params_from_reference,
    state_from_numpy,
)
from gym_futbol_tpu_torch.ops import _build  # noqa: E402

from _torch_cases import custom_params, random_actions  # noqa: E402

# the modules, which each package's ops/__init__ shadows with a function
jfr = importlib.import_module("gym_futbol_tpu.ops.fused_rollout")
tfr = importlib.import_module("gym_futbol_tpu_torch.ops.fused_rollout")

CUSTOM = custom_params(JEnvParams, JRewardConfig)

# tests/test_ops.py:26-30 and :99-117
P = JEnvParams(
    players_per_team=2, kick_noise=0.0, placement_noise=0.0,
    substeps=2, solver_iterations=4, max_steps=6,
)
P_CUSTOM = CUSTOM.replace(kick_noise=0.0, placement_noise=0.0)
B, T = 128, 9
POS_TOL = dict(rtol=1e-4, atol=1e-3)
REPLAY_REW_TOL = dict(rtol=1e-5, atol=1e-5)
TABLE_REW_TOL = dict(rtol=1e-4, atol=1e-4)


def _jax_start(ref, seed):
    """A JAX reset batch, and the same state packed for the port."""
    jstate, _ = jreset_batch(jax.random.PRNGKey(seed), ref, B)
    tstate = state_from_numpy(jstate.pos, jstate.vel, jstate.possession,
                              jstate.score, jstate.t, device="cpu")
    return jstate, tstate


def _compare(ref, rew_tol, got, want_sf, want_si, want_rew):
    sf, si, rew = got
    n4 = 4 * ref.n_bodies
    np.testing.assert_allclose(
        rew.numpy(), np.asarray(want_rew).reshape(T, B), **rew_tol)
    np.testing.assert_allclose(
        sf.numpy(), np.asarray(want_sf).reshape(n4, B), **POS_TOL)
    np.testing.assert_array_equal(si.numpy(), np.asarray(want_si).reshape(4, B))


@pytest.mark.parametrize("ref", [P, P_CUSTOM], ids=["P", "custom"])
def test_replay_matches_jax_kernel(ref):
    params = params_from_reference(ref)
    jstate, tstate = _jax_start(ref, 7)
    # [T, B, n_players, 2] -> [T, 2*n_players, B]: (dir, act) per player
    acts = random_actions(np.random.default_rng(3), ref, (T, B))
    acts = acts.reshape(T, B, 2 * ref.n_players).transpose(0, 2, 1).copy()

    jsf, jsi = jfr.pack_state(jstate, ref)
    want = jfr.fused_rollout_replay(
        jsf, jsi, jnp.asarray(acts.reshape(T, -1, B // 128, 128)), ref,
        block=128, interpret=True)
    sf, si = ops.pack_state(tstate, params)
    got = ops.fused_rollout_replay(sf, si, torch.from_numpy(acts), params)
    _compare(ref, REPLAY_REW_TOL, got, *want)
    # the rollout crossed episode ends (max_steps < T)
    assert (np.asarray(want[1]).reshape(4, B)[3] < T).all()


@pytest.mark.parametrize("seed", [42, 5])
def test_table_mode_matches_jax_kernel(seed):
    """Same uniforms, same draw order: the plain version reproduces the
    JAX kernel's random-mode rollout (default noise, fast auto-reset)."""
    ref = JEnvParams(players_per_team=2, substeps=2, solver_iterations=4,
                     max_steps=6)
    params = params_from_reference(ref)
    jstate, tstate = _jax_start(ref, seed)
    n_draws = jfr.n_draws_per_step(ref)
    assert tfr.n_draws_per_step(params) == n_draws
    table = jax.random.uniform(jax.random.PRNGKey(seed),
                               (T, n_draws, B // 128, 128), jnp.float32)

    jsf, jsi = jfr.pack_state(jstate, ref)
    want = jfr.fused_rollout(jsf, jsi, jnp.asarray([seed], jnp.int32), ref,
                             n_steps=T, block=128, interpret=True)
    sf, si = ops.pack_state(tstate, params)
    u = torch.from_numpy(np.array(table).reshape(T, n_draws, B))
    got = ops.fused_rollout(sf, si, seed, params, T, uniforms=u)
    _compare(ref, TABLE_REW_TOL, got, *want)
    # the draws mattered: kickoffs were jittered
    assert np.asarray(want[2]).std() > 0


def test_draw_derivations_match_jax():
    u = np.random.default_rng(0).random((3, 4096), dtype=np.float32)
    u[0, :3] = [0.0, 1.0 - 2.0 ** -24, 0.5]
    tu = torch.from_numpy(u)
    np.testing.assert_array_equal(
        tfr.randint5_from(tu[0]).numpy(), np.asarray(jfr._randint5_from(u[0])))
    np.testing.assert_array_equal(
        tfr.pm1_from(tu[0]).numpy(), np.asarray(jfr._pm1_from(u[0])))
    # log and cos differ in the last bit between the two frameworks
    np.testing.assert_allclose(
        tfr.normal_from(tu[1], tu[2]).numpy(),
        np.asarray(jfr._normal_from(u[1], u[2])), rtol=1e-6, atol=1e-6)


def test_pack_unpack_match_jax_layout():
    jstate, tstate = _jax_start(P, 11)
    params = params_from_reference(P)
    jsf, jsi = jfr.pack_state(jstate, P)
    sf, si = ops.pack_state(tstate, params)
    assert sf.is_contiguous() and si.dtype == torch.int32
    np.testing.assert_array_equal(sf.numpy(), np.asarray(jsf).reshape(-1, B))
    np.testing.assert_array_equal(si.numpy(), np.asarray(jsi).reshape(4, B))
    back = ops.unpack_state(sf, si, params)
    for name in ("pos", "vel", "possession", "score", "t"):
        np.testing.assert_array_equal(getattr(back, name).numpy(),
                                      getattr(tstate, name).numpy())


# Random123's known-answer vectors for Philox4x32-10.
_PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", _PHILOX_KAT)
def test_philox_known_answers(ctr, key, want):
    words = tfr.philox4x32_10(*(torch.tensor([c], dtype=torch.int64)
                                for c in ctr), *key)
    assert tuple(int(w) for w in words) == want


def test_philox_uniforms_layout_and_range():
    n_draws, n_envs = 21, 300
    u = tfr.philox_uniforms(9, 4, n_draws, n_envs)
    assert u.shape == (n_draws, n_envs) and u.dtype == torch.float32
    assert (u >= 0).all() and (u < 1).all()
    assert abs(u.mean().item() - 0.5) < 0.02    # not the signed-shift bias
    # draw d is word d % 4 of group d // 4, counter (env, step, group, 0)
    env, d = 123, 17
    words = tfr.philox4x32_10(*(torch.tensor([c]) for c in (env, 4, d // 4, 0)),
                              9, 0)
    assert u[d, env].item() == (int(words[d % 4]) >> 8) * 2.0 ** -24
    assert not torch.equal(u, tfr.philox_uniforms(10, 4, n_draws, n_envs))
    assert not torch.equal(u, tfr.philox_uniforms(9, 5, n_draws, n_envs))


def test_cpu_path_never_builds(monkeypatch):
    """On CPU tensors the wrappers run the plain version: no nvcc, no
    library, no launch counted."""
    def refuse():
        raise AssertionError("the CPU path reached the kernel build")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    ops.reset_launch_counts()
    params = params_from_reference(P)
    _, tstate = _jax_start(P, 1)
    sf, si = ops.pack_state(tstate, params)
    a = torch.from_numpy(random_actions(np.random.default_rng(0), P, (2, B))
                         .reshape(2, B, -1).transpose(0, 2, 1).copy())
    ops.fused_rollout_replay(sf, si, a, params)
    out1 = ops.fused_rollout(sf, si, 3, params, 4)
    out2 = ops.fused_rollout(sf, si, 3, params, 4)
    out3 = ops.fused_rollout(sf, si, 4, params, 4)
    assert ops.LAUNCHES and set(ops.LAUNCHES.values()) == {0}
    for x, y in zip(out1, out2):
        assert torch.equal(x, y)
    assert not torch.equal(out1[2], out3[2])
    assert torch.isfinite(out1[2]).all()
    assert ((out1[1][3] >= 0) & (out1[1][3] < P.max_steps)).all()


def test_wrappers_validate_inputs():
    params = params_from_reference(P)
    _, tstate = _jax_start(P, 1)
    sf, si = ops.pack_state(tstate, params)
    with pytest.raises(TypeError):
        ops.fused_rollout(sf.double(), si, 0, params, 2)
    with pytest.raises(ValueError):
        ops.fused_rollout(sf[:-1], si, 0, params, 2)
    with pytest.raises(ValueError):
        ops.fused_rollout(sf, si, 0, params, 2, uniforms=torch.zeros(2, 3, B))
    with pytest.raises(ValueError):
        ops.fused_rollout_replay(sf, si, torch.zeros(2, 8, B), params)


# ---------------------------------------------------------------------------
# The kernels' plan
# ---------------------------------------------------------------------------


def _check_plan(plan, params, n_envs):
    """A plan's layout is one the kernels take, its block's records fit
    the shared memory; the grid, with env e of block k on threads
    [e * G, (e + 1) * G), gives every env exactly one group of G lanes;
    the ints the kernel takes (lanes, threads) give back the plan's
    launch (``lanes_launch``, the C entry's arithmetic)."""
    g, threads = plan["lanes"], plan["threads"]
    assert plan["slots"] == ("registers" if g == 0 else "shared")
    assert g in (0, 2, 4, 8)
    assert threads % 32 == 0 and 32 <= threads <= tfr.MAX_LANE_THREADS
    assert g or threads == 32          # one thread per env: one warp a block
    assert plan["smem"] <= _build.SMEM_BYTES
    launch = tfr.lanes_launch(params.n_bodies, n_envs, g, threads)
    assert {k: plan[k] for k in launch} == launch
    per_env = max(g, 1)                 # lanes 0: one thread per env
    assert launch["envs"] * per_env == threads
    thread = torch.arange(launch["blocks"] * threads)
    env = thread // threads * launch["envs"] + thread % threads // per_env
    lanes = torch.bincount(env[env < n_envs], minlength=n_envs)
    assert lanes.shape == (n_envs,) and bool((lanes == per_env).all())
    # a warp's envs are whole groups: no group straddles two warps
    assert 32 % per_env == 0
    assert int((env[::per_env] < n_envs).sum()) == n_envs


@pytest.mark.parametrize("n_envs", [1, 31, 33, 4096, 16384, 65536])
@pytest.mark.parametrize("ppt", [1, 2, 3, 4, 5])
def test_replay_plan(ppt, n_envs):
    """``replay_plan`` for every team size and batch: G is 2, 4 or 8 (or
    0, one thread per env), the block is whole warps within the kernel's
    limit and its envs' records fit the shared memory; the grid, with env e of block k on threads
    [e * G, (e + 1) * G), gives every env exactly one group of G lanes;
    the ints the kernel takes (lanes, threads) give back the plan's
    launch (``lanes_launch``, the C entry's arithmetic)."""
    params = params_from_reference(JEnvParams(players_per_team=ppt))
    _check_plan(tfr.replay_plan(params, n_envs), params, n_envs)


@pytest.mark.parametrize("n_envs", [1, 31, 33, 4096, 16384, 65536])
@pytest.mark.parametrize("ppt", [1, 2, 3, 4, 5])
def test_rollout_plan(ppt, n_envs):
    """``rollout_plan``, the random rollout's, as ``replay_plan`` is
    held: G one of 0, 2, 4, 8, the block fits, every env one group, the
    launch's ints back unchanged; and the plan is the row of
    ``LANE_LAYOUTS`` the batch falls in, its threads lowered only to fit."""
    params = params_from_reference(JEnvParams(players_per_team=ppt))
    plan = tfr.rollout_plan(params, n_envs)
    _check_plan(plan, params, n_envs)
    row = next(r for r in tfr.LANE_LAYOUTS[ppt] if r[0] is None or n_envs <= r[0])
    assert plan["lanes"] == row[1] and plan["threads"] <= row[2]
    if plan["threads"] < row[2]:
        assert tfr.lanes_launch(params.n_bodies, n_envs, row[1], plan["threads"] + 32)[
            "smem"] > _build.SMEM_BYTES


def test_replay_plan_layouts():
    """Every team size's rows end in one for any batch, their batch bounds
    rise, and each row's layout is one the kernel takes."""
    assert sorted(tfr.LANE_LAYOUTS) == [1, 2, 3, 4, 5]
    for ppt, rows in tfr.LANE_LAYOUTS.items():
        bounds = [most for most, _, _ in rows]
        assert bounds[-1] is None and bounds[:-1] == sorted(bounds[:-1])
        for _, g, threads in rows:
            assert g in (0, 2, 4, 8) and threads % 32 == 0
            assert 32 <= threads <= tfr.MAX_LANE_THREADS
            assert g or threads == 32      # one thread per env: PR 1's block


def test_rollout_plan_layouts():
    """The random rollout and the replay share one table and one plan
    function (their fastest layouts measured alike), each wrapper
    reading its own name: the same plan for every team size and batch."""
    assert tfr.replay_plan is tfr.rollout_plan
    for ppt in tfr.LANE_LAYOUTS:
        params = params_from_reference(JEnvParams(players_per_team=ppt))
        for n_envs in (1, 8192, 8193, 32768, 32769, 1 << 20):
            assert tfr.replay_plan(params, n_envs) == tfr.rollout_plan(params, n_envs)


def test_replay_plan_fits_shared_memory(monkeypatch):
    """A plan whose block's records would not fit the shared memory is
    cut a warp at a time until they do; the record is the C header's
    EnvSlots<NB> (odd stride). The plan is formed uncached here
    (``__wrapped__``), so the patched table stays out of the cache."""
    assert [tfr.env_slot_floats(nb) for nb in (3, 5, 7, 9, 11)] == [69, 141, 231, 343, 473]
    monkeypatch.setitem(tfr.LANE_LAYOUTS, 5, ((None, 2, 256),))
    plan = tfr.replay_plan.__wrapped__(
        params_from_reference(JEnvParams(players_per_team=5)), 65536)
    assert plan["threads"] == 224 and plan["smem"] <= _build.SMEM_BYTES
    assert tfr.lanes_launch(11, 65536, 2, 256)["smem"] > _build.SMEM_BYTES
    with pytest.raises(ValueError):
        tfr.replay_plan(params_from_reference(JEnvParams(players_per_team=2)), 0)


@pytest.mark.parametrize("ppt", [1, 2, 3, 4, 5])
def test_rollout_plan_fits_shared_memory(ppt, monkeypatch):
    """At every team size and lane count, a 256-thread row is cut to the
    largest block of whole warps whose envs' records fit the shared
    memory, and an unfitting block is never planned."""
    params = params_from_reference(JEnvParams(players_per_team=ppt))
    for g in (2, 4, 8):
        monkeypatch.setitem(tfr.LANE_LAYOUTS, ppt, ((None, g, 256),))
        plan = tfr.rollout_plan.__wrapped__(params, 65536)
        fits = [n for n in range(32, 257, 32)
                if tfr.lanes_launch(params.n_bodies, 65536, g, n)["smem"]
                <= _build.SMEM_BYTES]
        assert plan["lanes"] == g and plan["threads"] == max(fits)
        assert plan["smem"] <= _build.SMEM_BYTES


def test_rollout_plan_is_cached():
    """The wrapper's plan is formed once per (params, batch): a second
    call returns the same object, as ``_constants_array`` does."""
    params = params_from_reference(JEnvParams(players_per_team=2))
    first = tfr.rollout_plan(params, 4096)
    assert tfr.rollout_plan(params, 4096) is first
    assert tfr.rollout_plan(params, 4097) is not first
    assert tfr.rollout_plan.cache_info().maxsize >= 64


def test_random_kernels_keep_the_benchmark_name():
    """Every random-mode kernel of csrc/fused_rollout.cu (each
    ``__global__`` kernel that takes a uniforms table) is named
    ``random_rollout_kernel``: the benchmark finds K1a in a trace by that
    name (``futbench/metrics/k1a_roofline.py``)."""
    import os
    import re

    path = os.path.join(os.path.dirname(tfr.__file__), "..", "csrc", "fused_rollout.cu")
    with open(path) as fh:
        src = fh.read()
    kernels = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s*(\w+)\s*\(([^)]*)\)",
                         src)
    assert sorted(name for name, _ in kernels) == ["random_rollout_kernel",
                                                   "replay_rollout_kernel"]
    random = [name for name, args in kernels if "table" in args]
    assert random and all(re.search("random_rollout_kernel", n) for n in random)
    assert "futbol_fused_rollout_random" in src
    launched = re.findall(r"(\w+)<NB, (?:0|G)>(?:<<<|,)", src.split('extern "C"')[1])
    assert "random_rollout_kernel" in launched
