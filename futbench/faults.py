"""Faults planted in the program under a run, to read what the
comparison says of a broken timed path (``python -m futbench ...
--fault <name>``; the harness's tests and the readings of the limits,
never a benchmark run). Each replaces one of the program's functions in
this process before the cell is set up.

* ``unchanged``: a step that returns its state unchanged (the rollout's
  state; the learner's optimiser step).
* ``half_batch``: half of the batch left out, the mean taken over the
  rest (the rollout's second half of envs not stepped; each of the
  update's minibatch gradients over its first half of blocks).
* ``half_envs``: the collect steps the first half of the envs and hands
  their copies for the second.
* ``altered``: an answer altered where it is produced (the rollout's
  last rewards; one act of each collected step).
* ``no_exchange``: the ranks' all-reduce left out.
"""

from __future__ import annotations

import torch


def plant(name: str, kind: str) -> None:
    from gym_futbol_tpu_torch import ops, ppo
    from gym_futbol_tpu_torch.ops import fused_update
    from gym_futbol_tpu_torch.parallel import mesh

    if kind == "rollout":
        real = ops.fused_rollout

        def rollout(sf, si, seed, params, n_steps, uniforms=None):
            if name == "half_batch":
                h = sf.shape[1] // 2
                a = real(sf[:, :h].contiguous(), si[:, :h].contiguous(), seed,
                         params, n_steps)
                rew = torch.zeros((n_steps, sf.shape[1]), device=sf.device)
                rew[:, :h] = a[2]
                return (torch.cat([a[0], sf[:, h:]], 1), torch.cat([a[1], si[:, h:]], 1),
                        rew)
            out = real(sf, si, seed, params, n_steps)
            if name == "unchanged":
                return sf.clone(), si.clone(), out[2]
            if name == "altered":
                out[2][-1] += 1e-4
                return out
            raise ValueError(f"no fault {name!r} for the rollout")

        ops.fused_rollout = rollout
        return
    if name == "unchanged":
        ppo.Optimizer.step = lambda self: None
    elif name == "half_batch":
        real_grad = fused_update.fused_minibatch_grad

        def half(w, obs, dirs, acts, logp, value, ret, adv_n, idx, **kw):
            h = idx.shape[0] // 2
            grads, sums = real_grad(w, obs, dirs, acts, logp, value, ret,
                                    adv_n[:h].contiguous(), idx[:h].contiguous(), **kw)
            return grads, {k: 2 * v for k, v in sums.items()}

        fused_update.fused_minibatch_grad = half
    elif name in ("half_envs", "altered"):
        real_collect = ppo.collect_rollout_fused

        def collect(runner, env_params, cfg, **kw):
            runner, traj, last_v = real_collect(runner, env_params, cfg, **kw)
            if name == "altered":
                low = traj.acts & 7             # player 0's act, 0..4
                traj.acts = traj.acts - low + (low + 1) % 5
                return runner, traj, last_v
            t, b2 = traj.reward.shape
            b, h = b2 // 2, b2 // 4
            for field in ("dirs", "acts", "logp", "value", "reward", "done"):
                x = getattr(traj, field).reshape(t, 2, b)
                x[:, :, h:2 * h] = x[:, :, :h]
            obs = traj.obs.reshape(traj.obs.shape[0], 2, t, b)
            obs[..., h:2 * h] = obs[..., :h]
            return runner, traj, last_v

        ppo.collect_rollout_fused = collect
    elif name == "no_exchange":
        mesh.all_mean = lambda tensors, group: list(tensors)
    else:
        raise ValueError(f"no fault {name!r} for the learner")
