"""One rank of the port's distributed CPU tests (not collected by pytest:
tests/test_torch_parallel.py starts one process per rank).

Usage: python tests/_torch_dist_worker.py <dir> <rank> <world>

The rank joins a gloo group through a file store in <dir>, runs every
scenario named in <dir>/in.pt in order on its share of the envs (the
port's plain versions of the kernels on the CPU), and writes what the
test compares to <dir>/out<rank>.pt. It imports torch and the port only.
"""

from __future__ import annotations

import contextlib
import datetime
import functools
import io
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
torch.set_num_threads(1)

from gym_futbol_tpu_torch import a2c, ops, ppo, train  # noqa: E402
from gym_futbol_tpu_torch import recurrent_ppo as rppo  # noqa: E402
from gym_futbol_tpu_torch.interop import (  # noqa: E402
    actor_critic_from_flax,
    recurrent_actor_critic_from_flax,
    reward_norm_from_numpy,
    running_norm_from_numpy,
    state_from_numpy,
)
from gym_futbol_tpu_torch.parallel import (  # noqa: E402
    check_replicated,
    env_group,
    init_distributed,
    shard_env_state,
    shard_fused_rollout,
    shard_rollout,
    shard_runner,
    shard_train_iteration,
)
from gym_futbol_tpu_torch.types import EnvParams, RewardConfig  # noqa: E402
from gym_futbol_tpu_torch.utils.checkpoint import _state  # noqa: E402


def _params(d: dict) -> EnvParams:
    return EnvParams(**{**d, "rewards": RewardConfig(**d["rewards"])})


def _variables(flat: dict) -> dict:
    """{"a/b/c": tensor} -> {"a": {"b": {"c": ndarray}}}, flax's
    variables."""
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v.numpy()
    return out


def _flax_kernels(model) -> dict:
    """The model's dense layers as flax kernels ``[in, out]`` and biases."""
    return {f"Dense_{i}": (layer.weight.detach().T.clone(),
                           layer.bias.detach().clone())
            for i, layer in enumerate(model.dense_layers())}


def _state_of(case: dict):
    s = case["state"]
    return state_from_numpy(s["pos"], s["vel"], s["possession"], s["score"],
                            s["t"], device="cpu")


def _iterate(runner, fn, case, rank, group, env_params, cfg):
    """``case["iters"]`` iterations of ``fn`` under shard_train_iteration,
    each fed the rank's action uniforms (and block permutations)."""
    metrics = []
    for it in range(case["iters"]):
        u = case["uniforms"][rank][it]
        kw = {}
        if "perms" in case:
            kw["update_fn"] = functools.partial(
                case["update"], perms=case["perms"][rank][it])
        step = shard_train_iteration(
            functools.partial(fn, collect_fn=functools.partial(
                case["collect"], action_uniforms=u), **kw), group)
        runner, m = step(runner, env_params, cfg)
        metrics.append({k: float(v) for k, v in m.items()})
        if getattr(runner, "obs_norm", None) is not None:
            metrics[-1]["norms"] = (_state(runner.obs_norm),
                                    _state(runner.rew_norm))
    check_replicated(runner, group)
    return runner, metrics


def scenario_ppo(case, rank, group, normalize=False):
    env_params = _params(case["env_params"])
    cfg = ppo.PPOConfig(**case["cfg"])
    model = actor_critic_from_flax(_variables(case["variables"]),
                                   env_params.players_per_team, device="cpu")
    runner = ppo.RunnerState(
        model=model, env_state=_state_of(case), obs=case["obs"],
        generator=torch.Generator().manual_seed(0),
        optimizer=ppo.make_optimizer(model, cfg))
    collect = ppo.collect_rollout
    if normalize:
        on, rn = case["obs_norm"], case["rew_norm"]
        runner = runner.replace(
            obs_norm=running_norm_from_numpy(on["mean"], on["var"], on["count"],
                                             device="cpu"),
            rew_norm=reward_norm_from_numpy(rn["ret"], rn["mean"], rn["var"],
                                            rn["count"], device="cpu"))
        collect = ppo.make_normalized_collect(True, True, group)
    runner = shard_runner(runner, group)
    runner, metrics = _iterate(
        runner, ppo.train_iteration,
        {**case, "collect": collect, "update": ppo.update_epochs},
        rank, group, env_params, cfg)
    out = {"kernels": _flax_kernels(runner.model), "metrics": metrics,
           "pos": runner.env_state.pos, "t": runner.env_state.t,
           "obs": runner.obs}
    return out


def scenario_norm(case, rank, group):
    return scenario_ppo(case, rank, group, normalize=True)


def scenario_a2c(case, rank, group):
    env_params = _params(case["env_params"])
    cfg = a2c.A2CConfig(**case["cfg"])
    model = actor_critic_from_flax(_variables(case["variables"]),
                                   env_params.players_per_team, device="cpu")
    runner = ppo.RunnerState(
        model=model, env_state=_state_of(case), obs=case["obs"],
        generator=torch.Generator().manual_seed(0),
        optimizer=a2c.make_optimizer(model, cfg))
    runner = shard_runner(runner, group)
    runner, metrics = _iterate(
        runner, a2c.train_iteration, {**case, "collect": ppo.collect_rollout},
        rank, group, env_params, cfg)
    return {"kernels": _flax_kernels(runner.model), "metrics": metrics,
            "pos": runner.env_state.pos, "t": runner.env_state.t}


def scenario_rppo(case, rank, group):
    env_params = _params(case["env_params"])
    cfg = rppo.RecurrentPPOConfig(**case["cfg"])
    model = recurrent_actor_critic_from_flax(
        _variables(case["variables"]), env_params.players_per_team, device="cpu")
    b = case["obs"].shape[0]
    runner = a2c.RecurrentRunnerState(
        model=model, env_state=_state_of(case), obs=case["obs"],
        carry=tuple(torch.zeros(2, b, model.lstm_size) for _ in range(2)),
        generator=torch.Generator().manual_seed(0),
        optimizer=rppo.make_optimizer(model, cfg))
    runner = shard_runner(runner, group)
    runner, metrics = _iterate(
        runner, rppo.train_iteration_recurrent_ppo,
        {**case, "collect": a2c.collect_recurrent_rollout,
         "update": functools.partial(rppo.update_epochs_recurrent,
                                     compute_dtype=torch.float32)},
        rank, group, env_params, cfg)
    return {"params": {k: v.detach().clone()
                       for k, v in runner.model.named_parameters()},
            "metrics": metrics, "pos": runner.env_state.pos,
            "carry": runner.carry}


class _Recorder:
    """An optimiser that records the gradients it is handed and leaves
    the parameters alone."""

    def __init__(self, params):
        self.params = list(params)
        self.grads, self.count = [], 0

    def step(self):
        self.grads.append([p.grad.clone() for p in self.params])
        self.count += 1


def scenario_fused(case, rank, group):
    """The sharded fused path on the kernels' plain versions: one
    minibatch update's averaged gradients beside this rank's own, then
    two whole sharded fused iterations (K2 and K3), replicated leaves
    checked."""
    env_params = _params(case["env_params"])
    cfg = ppo.PPOConfig(**case["cfg"])
    gen = torch.Generator().manual_seed(5)
    model = ppo.ActorCritic(env_params.players_per_team,
                            case["obs_dim"], tuple(case["hidden"]), device="cpu")
    runner = shard_runner(ppo.init_runner(gen, model, env_params, cfg,
                                          case["n_envs"]), group)
    runner, traj, last_v = ppo.collect_rollout_fused(runner, env_params, cfg,
                                                     compute_dtype=torch.float32)
    adv, ret = ppo.compute_gae(traj, last_v, cfg)
    out = {}
    for name, g in (("own", None), ("mean", group)):
        rec = _Recorder(runner.model.parameters())
        m = ppo.update_epochs_fused(runner.model, rec, traj, adv, ret, gen, cfg,
                                    perms=case["perms"], group=g,
                                    compute_dtype=torch.float32)
        out[name] = rec.grads
        out[name + "_metrics"] = {k: float(v) for k, v in m.items()}
    step = shard_train_iteration(functools.partial(
        ppo.train_iteration, collect_fn=ppo.collect_rollout_fused,
        update_fn=ppo.update_epochs_fused), group)
    ops.reset_launch_counts()
    for _ in range(2):
        runner, m = step(runner, env_params, cfg)
    check_replicated(runner, group)
    out["iteration"] = {k: float(v) for k, v in m.items()}
    out["launches"] = sum(ops.LAUNCHES.values())
    return out


def scenario_rollout(case, rank, group):
    """shard_fused_rollout and shard_rollout (plain versions) and the
    sharded replay on the rank's envs."""
    env_params = _params(case["env_params"])
    state = shard_env_state(_state_of(case), group)
    sf, si = ops.pack_state(state, env_params)
    fused = shard_fused_rollout(group, env_params, case["n_steps"])(
        sf, si, case["seed"])
    replay = ops.fused_rollout_replay(
        sf, si, shard_env_state(case["actions"], group, dim=2), env_params)
    plain_state, outs = shard_rollout(group, env_params, case["n_steps"])(
        state, case["seed"])
    return {"fused": fused, "replay": replay, "plain_pos": plain_state.pos,
            "plain_reward": outs.reward}


def scenario_checks(case, rank, group):
    """check_replicated on equal replicas, then after rank 1's parameters
    move; a normaliser update over unequal shares."""
    from gym_futbol_tpu_torch.env import obs_size
    from gym_futbol_tpu_torch.models.policy import ActorCritic
    from gym_futbol_tpu_torch.wrappers import RunningNorm

    env_params = _params(case["env_params"])
    model = ActorCritic(env_params.players_per_team, obs_size(env_params), (8,),
                        device="cpu")
    runner = shard_runner(ppo.init_runner(torch.Generator().manual_seed(0), model,
                                          env_params, ppo.PPOConfig(), 8), group)
    out = {}
    check_replicated(runner, group)
    out["equal"] = "ok"
    if rank == 1:
        with torch.no_grad():
            model.logits.bias.add_(1e-6)
    try:
        check_replicated(runner, group)
        out["moved"] = "no error"
    except RuntimeError as e:
        out["moved"] = str(e)
    try:
        RunningNorm.init(3, "cpu").update(torch.randn(4 + rank, 3), group)
        out["unequal"] = "no error"
    except ValueError as e:
        out["unequal"] = str(e)
    return out


def _cli(argv) -> tuple[list[str], object]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runner = train.main(argv + ["--device", "cpu", "--distributed"])
    return out.getvalue().splitlines(), runner


def _leaves(runner) -> dict:
    flat = {}

    def walk(x, name):
        if isinstance(x, torch.Tensor):
            flat[name] = x
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{name}.{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{name}[{i}]")
        elif isinstance(x, (int, float)):
            flat[name] = torch.tensor(float(x), dtype=torch.float64)

    walk(_state(runner), "runner")
    return flat


def scenario_cli(case, rank, group):
    """The CLI with --distributed: a checkpointed, logged run of 2
    iterations, resumed to 3, beside an uninterrupted run of 3; then one
    iteration of every algorithm and collect the CLI shards."""
    base = case["argv"]
    d1, d2 = case["dirs"]
    out = {}
    out["first"], _ = _cli(base + ["--iters", "2", "--checkpoint-dir", d1,
                                   "--checkpoint-every", "1", "--log-dir", d1])
    out["resumed"], resumed = _cli(base + ["--iters", "3", "--checkpoint-dir", d1,
                                           "--log-dir", d1])
    out["whole"], whole = _cli(base + ["--iters", "3", "--checkpoint-dir", d2])
    out["resumed_leaves"], out["whole_leaves"] = _leaves(resumed), _leaves(whole)
    out["algos"] = {}
    for name, argv in case["algos"].items():
        lines, runner = _cli(argv + ["--iters", "1"])
        check_replicated(runner, group)
        out["algos"][name] = lines
    return out


def main() -> int:
    d, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    init_distributed(init_method=f"file://{os.path.join(d, 'rendezvous')}",
                     rank=rank, world_size=world, device="cpu",
                     timeout=datetime.timedelta(seconds=60))
    group = env_group().group
    cases = torch.load(os.path.join(d, "in.pt"), weights_only=True)
    results = {}
    for name, case in cases.items():
        results[name] = globals()[f"scenario_{name}"](case, rank, group)
    torch.save(results, os.path.join(d, f"out{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()
    print(json.dumps({"rank": rank, "done": sorted(results)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
