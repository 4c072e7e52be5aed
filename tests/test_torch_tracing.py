"""The program's spans (``utils.profiling.span``): nothing reached while
no profiler runs; under ``torch.profiler`` the PPO iteration's three
stages and the recurrent PPO iteration's, each kernel wrapper once per
call and nested where they run; and the same numbers with a profiler
open as without. Host only, tiny shapes (the wrappers' plain
versions)."""

import pytest
import torch

torch.set_num_threads(1)

from gym_futbol_tpu_torch import a2c  # noqa: E402
from gym_futbol_tpu_torch import env as env_core  # noqa: E402
from gym_futbol_tpu_torch import ops  # noqa: E402
from gym_futbol_tpu_torch import ppo  # noqa: E402
from gym_futbol_tpu_torch import recurrent_ppo as rppo  # noqa: E402
from gym_futbol_tpu_torch.models.policy import ActorCritic  # noqa: E402
from gym_futbol_tpu_torch.models.recurrent import RecurrentActorCritic  # noqa: E402
from gym_futbol_tpu_torch.ops._policy import feature_rows  # noqa: E402
from gym_futbol_tpu_torch.types import EnvParams  # noqa: E402
from gym_futbol_tpu_torch.utils import profiling  # noqa: E402
from gym_futbol_tpu_torch.vector import reset_batch  # noqa: E402

P = EnvParams(players_per_team=1)
F = env_core.obs_size(P)
B, T, BLOCK = 8, 1, 128
STAGES = ("ppo.collect", "ppo.gae", "ppo.update")


def cpu_profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def spans(prof, prefixes=("ppo.", "ops.")) -> list:
    """The program's spans in the profile: (name, start, end), by start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith(prefixes)),
                  key=lambda s: s[1])


def inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def runner(seed: int):
    gen = torch.Generator().manual_seed(seed)
    model = ActorCritic(P.players_per_team, F, (16,), device="cpu")
    cfg = ppo.PPOConfig(rollout_steps=2, shuffle_block=BLOCK, epochs=2, minibatches=2)
    return ppo.init_runner(gen, model, P, cfg, 64), cfg


def iterate(r, cfg):
    return ppo.train_iteration(r, P, cfg, collect_fn=ppo.collect_rollout_fused,
                               update_fn=ppo.update_epochs_fused)


RECURRENT_STAGES = ("rppo.collect", "rppo.gae", "rppo.update")


def recurrent_runner(seed: int):
    gen = torch.Generator().manual_seed(seed)
    model = RecurrentActorCritic(P.players_per_team, F, (16,), lstm_size=4,
                                 device="cpu")
    cfg = rppo.RecurrentPPOConfig(rollout_steps=2, shuffle_block=8, epochs=2,
                                  minibatches=2)
    return rppo.init_recurrent_ppo_runner(gen, model, P, cfg, 16), cfg


def iterate_recurrent(r, cfg):
    return rppo.train_iteration_recurrent_ppo(
        r, P, cfg, collect_fn=a2c.collect_recurrent_rollout_fused)


def packed_state(seed: int = 0):
    state, _ = reset_batch(torch.Generator().manual_seed(seed), P, B, device="cpu")
    return ops.pack_state(state, P)


def test_span_off_reaches_no_profiler(monkeypatch):
    """No profiler: ``span`` is the shared no-op and the wrappers and the
    iteration never reach ``record_function``."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) reached with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("ppo.gae") is profiling.NO_SPAN
    with profiling.span("ppo.gae") as inner:
        assert inner is None
    sf, si = packed_state()
    ops.fused_rollout(sf, si, 3, P, T)
    r, cfg = runner(0)
    iterate(r, cfg)


def test_iteration_spans():
    """One fused iteration under the profiler: the three stages once
    each, in order, apart; K2's wrapper inside the collect, one K3
    wrapper a minibatch inside the update."""
    r, cfg = runner(1)
    with cpu_profile() as prof:
        iterate(r, cfg)
    got = spans(prof)
    stages = [s for s in got if s[0].startswith("ppo.")]
    assert [s[0] for s in stages] == list(STAGES)
    assert all(a[2] <= b[1] for a, b in zip(stages, stages[1:]))
    collect, _, update = stages
    k2 = [s for s in got if s[0] == "ops.fused_collect"]
    k3 = [s for s in got if s[0] == "ops.fused_minibatch_grad"]
    assert len(k2) == 1 and inside(k2[0], collect)
    assert len(k3) == cfg.epochs * cfg.minibatches
    assert all(inside(s, update) for s in k3)
    assert len(got) == len(stages) + len(k2) + len(k3)


def test_profiler_leaves_the_numbers_alone():
    """Two iterations with a profiler open and two without, from the
    same seed: parameters, Adam's state and the metrics bitwise equal."""
    def two(profiled: bool):
        r, cfg = runner(2)
        ctx = cpu_profile() if profiled else profiling.NO_SPAN
        with ctx:
            for _ in range(2):
                r, metrics = iterate(r, cfg)
        adam = r.optimizer.adam.state
        state = [t for p in r.optimizer.params for t in (adam[p]["exp_avg"],
                                                          adam[p]["exp_avg_sq"])]
        return [p.detach() for p in r.optimizer.params], state, metrics

    plain, traced = two(False), two(True)
    for a, b in zip(plain[0] + plain[1], traced[0] + traced[1]):
        assert torch.equal(a, b)
    assert plain[2].keys() == traced[2].keys()
    assert all(torch.equal(plain[2][k], traced[2][k]) for k in plain[2])


def test_recurrent_span_off_reaches_no_profiler(monkeypatch):
    """No profiler: the recurrent iteration's stages and K5's wrapper
    take the shared no-op and never reach ``record_function``."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) reached with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("rppo.update") is profiling.NO_SPAN
    r, cfg = recurrent_runner(0)
    iterate_recurrent(r, cfg)


def test_recurrent_iteration_spans():
    """One recurrent PPO iteration on K5's and K6's plain versions under
    the profiler: its three stages once each, in order, apart; K5's
    wrapper inside the collect; K6's inside the update, its forward and
    its backward once a minibatch each; none of the MLP learner's
    stages."""
    r, cfg = recurrent_runner(3)
    with cpu_profile() as prof:
        iterate_recurrent(r, cfg)
    got = spans(prof, ("rppo.", "ppo.", "ops."))
    stages = [s for s in got if s[0].startswith("rppo.")]
    assert [s[0] for s in stages] == list(RECURRENT_STAGES)
    assert all(a[2] <= b[1] for a, b in zip(stages, stages[1:]))
    k5 = [s for s in got if s[0] == "ops.fused_recurrent_collect"]
    assert len(k5) == 1 and inside(k5[0], stages[0])
    k6 = [s for s in got if s[0] == "ops.fused_lstm_bptt"]
    assert len(k6) == 2 * cfg.epochs * cfg.minibatches
    assert all(inside(s, stages[2]) for s in k6)
    assert len(got) == len(stages) + len(k5) + len(k6)


def test_profiler_leaves_the_recurrent_numbers_alone():
    """Two recurrent iterations with a profiler open and two without,
    from the same seed: parameters and the metrics bitwise equal."""
    def two(profiled: bool):
        r, cfg = recurrent_runner(4)
        with cpu_profile() if profiled else profiling.NO_SPAN:
            for _ in range(2):
                r, metrics = iterate_recurrent(r, cfg)
        return [p.detach() for p in r.optimizer.params], metrics

    plain, traced = two(False), two(True)
    assert all(torch.equal(a, b) for a, b in zip(plain[0], traced[0], strict=True))
    assert plain[1].keys() == traced[1].keys()
    assert all(torch.equal(plain[1][k], traced[1][k]) for k in plain[1])


def _call_fused_rollout():
    sf, si = packed_state()
    return ops.fused_rollout(sf, si, 5, P, T)


def _call_fused_rollout_replay():
    sf, si = packed_state()
    acts = torch.randint(0, 5, (T, 2 * P.n_players, B), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(0))
    return ops.fused_rollout_replay(sf, si, acts, P)


def _call_fused_collect():
    sf, si = packed_state()
    model = ActorCritic(P.players_per_team, F, (16,), device="cpu")
    return ops.fused_collect(sf, si, ops.flatten_actor_critic(model), 7, P, T,
                             compute_dtype=torch.float32)


def _call_fused_selfplay_rollout():
    sf, si = packed_state()
    w = ops.init_mlp(torch.Generator().manual_seed(0), P, (16,), device="cpu")
    return ops.fused_selfplay_rollout(sf, si, w, w, 9, P, T)


def _call_fused_recurrent_collect():
    sf, si = packed_state()
    h = 4
    model = RecurrentActorCritic(P.players_per_team, F, (16,), lstm_size=h,
                                 generator=torch.Generator().manual_seed(0),
                                 device="cpu")
    c = torch.zeros(2, h, B)
    return ops.fused_recurrent_collect(sf, si, ops.flatten_recurrent_actor_critic(model),
                                       c, c.clone(), 11, P, T)


def _call_fused_minibatch_grad():
    gen = torch.Generator().manual_seed(0)
    model = ActorCritic(P.players_per_team, F, (16,), device="cpu")
    rows = (2, BLOCK)

    def packed():
        return sum(torch.randint(0, 5, rows, generator=gen, dtype=torch.int32) << (3 * q)
                   for q in range(P.players_per_team))

    obs = torch.zeros(feature_rows(P), 2 * BLOCK)
    obs[:F] = torch.randn(F, 2 * BLOCK, generator=gen)
    adv = torch.randn(rows, generator=gen)
    return ops.fused_minibatch_grad(
        ops.flatten_actor_critic(model), obs, packed(), packed(),
        -torch.rand(rows, generator=gen) * 4, torch.randn(rows, generator=gen),
        torch.randn(rows, generator=gen), (adv - adv.mean()) / adv.std(),
        torch.tensor([1, 0], dtype=torch.int32), n_torso=1, clip_eps=0.2,
        vf_coef=0.5, ent_coef=0.01, block=BLOCK, compute_dtype=torch.float32)


WRAPPERS = {
    "fused_rollout": _call_fused_rollout,
    "fused_rollout_replay": _call_fused_rollout_replay,
    "fused_collect": _call_fused_collect,
    "fused_selfplay_rollout": _call_fused_selfplay_rollout,
    "fused_recurrent_collect": _call_fused_recurrent_collect,
    "fused_minibatch_grad": _call_fused_minibatch_grad,
}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_wrapper_opens_one_span_a_call(name):
    """Each public kernel wrapper is one ``ops.<name>`` span a call
    (here its plain version), and no other span."""
    with cpu_profile() as prof:
        WRAPPERS[name]()
    assert [s[0] for s in spans(prof)] == [f"ops.{name}"]
