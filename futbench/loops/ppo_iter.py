"""Traffic kind ``ppo_iter``: whole self-play PPO iterations through the
program's entry, a closed loop of whole calls.

One call is ``ppo.train_iteration`` with the kernels (``collect_fn``
``ppo.collect_rollout_fused``, K2; ``compute_gae``; ``update_fn``
``ppo.update_epochs_fused``, K3), or on several chips
``parallel.shard_train_iteration`` of it over the process group, and it
ends when the iteration's loss is on the host. Set-up builds the runner
once from the benchmark's own inputs (weights made on the card from the
seed, a starting batch of envs at kickoff with their clocks spread) and
drives it through its first ``recorded_iterations`` iterations through
the same entry, keeping what the check needs; the window goes on with
that same runner.

The check follows those iterations in two stages, because sampled
actions split at near ties of the bf16 logits and the trajectories then
part (an iteration's whole batch cannot be re-collected alike):

* the collect, on a sample of envs drawn from the seed on each rank: the
  reference steps them from the benchmark's starting state with the
  program's own actions and the kernel's Philox draws; their
  observations, rewards, dones and end state must equal the program's
  bits (``env_mismatches``); the reference's policy, on its own
  observations and its own weights, gives the log-prob and value of the
  program's actions (``logp_gap``, ``value_gap``, the bootstrap values
  included), and each of the program's actions must be the reference's
  inverse-CDF draw from the same uniform or lie within a hair of its
  boundary (``tie_gap``: the largest distance of a differing draw's
  uniform from the CDF boundaries between the two choices);
* the update, from the program's collected buffers: the reference's GAE
  and its ``epochs`` x ``minibatches`` steps, on the same block
  permutations (the reference redraws the program's generator stream
  from the benchmark's seed), gradients averaged over the ranks, starting
  from the benchmark's weights. Compared: each iteration's loss
  (``loss_gap``, relative), per leaf the norm of the optimiser's first
  moment after the first iteration (``grad_gap``) and of the parameters'
  change over the recorded iterations (``change_gap``), each the gap of
  the norms over the larger of the reference leaf's norm and the median
  leaf's; leaves whose reference moment is under a thousandth of the
  median leaf's are left out of both.

On several chips each rank also compares its parameters after the window
with rank 0's (``replica_gap``, largest absolute difference, limit 0).
"""

from __future__ import annotations

import functools
import time

import torch

from futbench import common, counts
from futbench.reference import env as ref_env
from futbench.reference import ppo as ref_ppo

TRAJ = ("obs", "dirs", "acts", "logp", "value", "reward", "done")


def make_weights(gen: torch.Generator, dims, device) -> list:
    """The actor-critic's weights from the seed in one draw on the card:
    each ``W`` ``[in, out]`` normal with std 1/sqrt(in), clipped at two
    std (a lecun-normal initialiser), each bias 0.01 times a normal."""
    sizes = [a * b + b for a, b in dims]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = [], 0
    for (a, b), size in zip(dims, sizes):
        std = a ** -0.5
        w = (flat[at:at + a * b].reshape(a, b) * std).clamp(-2 * std, 2 * std)
        out += [w.contiguous(), (0.01 * flat[at + a * b:at + size]).contiguous()]
        at += size
    return out


class Cell:
    def __init__(self, config: dict, traffic: dict, ctx):
        self.ctx, self.traffic, self.config = ctx, traffic, config
        self.params = common.program_params(config)
        self.ref = common.ref_params(config)
        self.world = ctx.world
        self.n_envs = traffic["envs"] // ctx.world
        self.n_steps = traffic["steps"]
        self.steps_per_call = self.n_envs * self.n_steps
        self.cfg = dict(config["ppo"], rollout_steps=self.n_steps)
        ppt = self.ref.players_per_team
        self.dims = counts.mlp_dims(ref_env.obs_size(self.ref), config["hidden"],
                                    ppt * 2 * ref_env.N_CHOICES)
        self.shared, self.own = ctx.words(4), ctx.words(4, per_rank=True)
        ref_env.exact_sqrt(ctx.device.type == "cuda")

    # ------------------------------------------------------------------ set-up

    def setup(self) -> None:
        t0 = time.time()
        from gym_futbol_tpu_torch import env as penv
        from gym_futbol_tpu_torch import ops, ppo
        from gym_futbol_tpu_torch.models.policy import ActorCritic

        dev, ctx = self.ctx.device, self.ctx
        self.ppo = ppo
        self.setup_parts = {"program imported": time.time() - t0}
        self.pcfg = ppo.PPOConfig(**self.cfg)
        gen = torch.Generator(device=dev).manual_seed(self.shared[0])
        self.w0 = make_weights(gen, self.dims, dev)
        sf, si = ref_env.initial_state(gen, self.ref, self.n_envs * self.world, dev)
        share = slice(ctx.rank * self.n_envs, (ctx.rank + 1) * self.n_envs)
        self.sf0, self.si0 = sf[:, share].contiguous(), si[:, share].contiguous()
        del sf, si
        model = ActorCritic(self.ref.players_per_team, ref_env.obs_size(self.ref),
                            self.config["hidden"], device=dev)
        with torch.no_grad():
            for layer, w, b in zip(model.dense_layers(), self.w0[::2], self.w0[1::2]):
                layer.weight.copy_(w.T)
                layer.bias.copy_(b)
        state = ops.unpack_state(self.sf0, self.si0, self.params)
        self.runner = ppo.RunnerState(
            model=model, env_state=state, obs=penv.observe(state, self.params),
            generator=torch.Generator(device=dev).manual_seed(self.own[0]),
            optimizer=ppo.make_optimizer(model, self.pcfg))
        self.iteration = self._entry(ppo.collect_rollout_fused, ppo.update_epochs_fused)
        self.envs = common.sample(self.own[1], self.n_envs, self.traffic["check_envs"])
        self.cols = torch.tensor(self.envs, device=dev)
        self.recorded, self.losses = [], []
        self.setup_parts["inputs and runner made"] = time.time() - t0
        for k in range(self.traffic["recorded_iterations"]):
            self.losses.append(self._recorded_call())
            if k == 0:
                adam = self.runner.optimizer.adam.state
                self.m1 = leaves(adam[p]["exp_avg"] if p in adam else torch.zeros_like(p)
                                 for p in self.runner.optimizer.params)
        self.w_end = leaves(p.detach() for p in self.runner.optimizer.params)
        self.setup_parts["recorded iterations (the first loads the kernels)"] = (
            time.time() - t0)

    def _entry(self, collect_fn, update_fn):
        """The window's entry, ``ppo.train_iteration`` with these collect
        and update functions; on several chips, sharded over the group."""
        entry = functools.partial(self.ppo.train_iteration, collect_fn=collect_fn,
                                  update_fn=update_fn)
        if self.ctx.group is None:
            return entry
        from gym_futbol_tpu_torch.parallel import shard_train_iteration

        return shard_train_iteration(entry, group=self.ctx.group)

    def _recorded_call(self) -> float:
        """One iteration through the window's entry, its collect's
        outputs kept on the host for the check."""
        ppo = self.ppo
        kept = {}

        def collect(runner, env_params, cfg, group=None):
            runner, traj, last_v = ppo.collect_rollout_fused(runner, env_params, cfg)
            kept.update({k: getattr(traj, k).cpu() for k in TRAJ},
                        last_v=last_v.cpu())
            return runner, traj, last_v

        entry = self._entry(collect, ppo.update_epochs_fused)
        self.runner, metrics = entry(self.runner, self.params, self.pcfg)
        loss = metrics["loss"].item()
        from gym_futbol_tpu_torch import ops

        sf, si = ops.pack_state(self.runner.env_state, self.params)
        kept["end"] = (sf[:, self.cols].cpu(), si[:, self.cols].cpu())
        self.recorded.append(kept)
        return loss

    # ------------------------------------------------------------------ window

    def call(self) -> float:
        self.runner, metrics = self.iteration(self.runner, self.params, self.pcfg)
        return metrics["loss"].item()

    def traced_call(self) -> float:
        from torch.profiler import record_function

        ppo = self.ppo

        def collect(*a, **kw):
            with record_function("futbench.collect"):
                return ppo.collect_rollout_fused(*a, **kw)

        def update(*a, **kw):
            with record_function("futbench.update"):
                return ppo.update_epochs_fused(*a, **kw)

        self.runner, metrics = self._entry(collect, update)(self.runner, self.params,
                                                            self.pcfg)
        return metrics["loss"].item()

    def release(self) -> None:
        self.replica_gap = None
        if self.ctx.group is not None:
            import torch.distributed as dist

            flat = torch.cat([p.detach().reshape(-1)
                              for p in self.runner.optimizer.params])
            lead = flat.clone()
            dist.broadcast(lead, 0, group=self.ctx.group)
            self.replica_gap = (flat - lead).abs().max().item()
        del self.runner
        self.w0 = [w.cpu() for w in self.w0]
        self.m1 = [m.cpu() for m in self.m1]
        self.w_end = [w.cpu() for w in self.w_end]
        self.sf0, self.si0 = self.sf0[:, self.cols].cpu(), self.si0[:, self.cols].cpu()

    # ------------------------------------------------------------------ check

    def check(self, control: bool = False) -> list:
        """The compared numbers, each with its limit. ``control``: the
        reference computed with float8 products stands in the program's
        place (the control run of the harness's tests)."""
        ref = self.follow("bf16")
        got = self.follow("fp8") if control else self.program_outputs()
        lim = self.traffic["limits"]
        g = {"env_mismatches": 0 if control else ref["env_mismatches"]}
        g["logp_gap"] = (got["logp"] - ref["logp"]).abs().max().item()
        g["value_gap"] = max((got["value"] - ref["value"]).abs().max().item(),
                             (got["last_v"] - ref["last_v"]).abs().max().item())
        g["tie_gap"] = ref_ppo.tie_distance(ref["idx"], got["idx"], ref["cdf"],
                                            ref["u"]).max().item()
        g["loss_gap"] = max(abs(a - b) / max(abs(b), 1e-12)
                            for a, b in zip(got["losses"], ref["losses"]))
        g["grad_gap"], g["change_gap"] = leaf_gaps(
            ref["m1"], got["m1"], [a - b for a, b in zip(ref["w_end"], self.w0)],
            [a - b for a, b in zip(got["w_end"], self.w0)])
        out = [(name, value, lim[name]) for name, value in g.items()]
        if self.replica_gap is not None:
            out.append(("replica_gap", self.replica_gap, lim["replica_gap"]))
        return out

    def program_outputs(self) -> dict:
        """The recorded outputs at the sample envs, in :meth:`follow`'s
        layout."""
        g = 2 * self.ref.players_per_team
        b, envs = self.n_envs, torch.tensor(self.envs)
        cols = torch.cat([envs, b + envs])
        out = {k: [] for k in ("logp", "value", "last_v", "idx")}
        for kept in self.recorded:
            out["logp"].append(kept["logp"][:, cols])
            out["value"].append(kept["value"][:, cols])
            out["last_v"].append(kept["last_v"][cols])
            out["idx"].append(ref_ppo.unpack(kept["dirs"][:, cols],
                                             kept["acts"][:, cols], g))
        out = {k: torch.stack(v) for k, v in out.items()}
        return dict(out, losses=self.losses, m1=self.m1, w_end=self.w_end)

    def follow(self, mode: str) -> dict:
        """The reference through the recorded iterations, with products
        in ``mode``: at the sample envs (team-0 view then team-1 in each
        ``[.., 2S]`` row) the log-probs and values of the program's
        actions, the bootstrap values, the inverse-CDF draws and their
        CDFs; each iteration's mean loss, the first moment after the
        first, the weights after the last; and the count of the sample's
        env outputs that differ from the program's."""
        ref_ppo.no_tf32()
        dev = self.ctx.device
        gen = torch.Generator(device=dev).manual_seed(self.own[0])
        w = [x.to(dev).clone() for x in self.w0]
        opt = ref_ppo.Adam(w, self.cfg["lr"], self.cfg["max_grad_norm"])
        state = ref_env.state_from_packed(self.sf0, self.si0, self.ref.n_bodies)
        ref_env.reset_active()
        n_blocks = 2 * self.n_steps * self.n_envs // self.cfg["shuffle_block"]
        out = {k: [] for k in ("logp", "value", "last_v", "idx", "cdf", "u", "losses")}
        out["env_mismatches"] = 0
        for k, kept in enumerate(self.recorded):
            seed = int(torch.randint(0, 2**31 - 1, (), generator=gen, device=dev))
            perms = torch.stack([torch.randperm(n_blocks, generator=gen, device=dev)
                                 for _ in range(self.cfg["epochs"])])
            state = self._collect(kept, state, seed, [x.cpu() for x in w], mode, out)
            out["losses"].append(self._update(kept, w, opt, perms, mode))
            if k == 0:
                out["m1"] = [m.detach().cpu().clone() for m in opt.m]
        out["w_end"] = [x.detach().cpu() for x in w]
        self.shares = {
            "pairs_env": ref_env.ACTIVE["pairs"] / ref_env.ACTIVE["env_substeps"],
            "walls_env": ref_env.ACTIVE["walls"] / ref_env.ACTIVE["env_substeps"]}
        for key in ("logp", "value", "last_v", "idx", "cdf", "u"):
            out[key] = torch.stack(out[key])
        return out

    def _collect(self, kept, state, seed, w, mode, out):
        """Replay the sample envs through one recorded collect with the
        program's actions; returns their end state."""
        p, t_len, b = self.ref, self.n_steps, self.n_envs
        g = 2 * p.players_per_team
        envs = torch.tensor(self.envs)
        u = ref_env.philox_uniforms(seed, t_len, ref_env.n_draws_per_step(p), envs)
        cos_t, sin_t, nx, ny = ref_env.step_noise(u, p, 2 * g, self.ctx.device)
        f = ref_env.obs_size(p)
        obs = kept["obs"]
        cols = torch.cat([envs, b + envs])
        ia = ref_ppo.unpack(kept["dirs"][:, cols], kept["acts"][:, cols], g)
        bad = 0
        rows = {k: [] for k in ("logp", "value", "idx", "cdf", "u")}
        for k in range(t_len):
            x = torch.cat([ref_env.observation(state, p, mirror=False),
                           ref_env.observation(state, p, mirror=True)], 1)
            got = torch.cat([obs[:f, v * t_len * b + k * b + envs] for v in (0, 1)], 1)
            bad += common.mismatches(x, got)
            logits, value = ref_ppo.forward(w, x.T, mode)
            logp, _ = ref_ppo.logp_entropy(logits, ia[k])
            uv = torch.cat([u[k, :g], u[k, g:2 * g]], 1).T
            idx, cdf = ref_ppo.sample(logits, uv)
            for key, val in zip(rows, (logp, value, idx, cdf, uv)):
                rows[key].append(val)
            s = len(envs)
            dirs = [ia[k, :s, 2 * q].int() for q in range(p.players_per_team)] + [
                ref_env.mirror_dir(ia[k, s:, 2 * q]).int()
                for q in range(p.players_per_team)]
            acts = [ia[k, :s, 2 * q + 1].int() for q in range(p.players_per_team)] + [
                ia[k, s:, 2 * q + 1].int() for q in range(p.players_per_team)]
            state, r0, r1, done = ref_env.step(state, dirs, acts, cos_t[k], sin_t[k],
                                               list(nx[k]), list(ny[k]), p)
            bad += (common.mismatches(torch.cat([r0, r1]).float(), kept["reward"][k, cols])
                    + common.mismatches(torch.cat([done, done]), kept["done"][k, cols]))
        sf, si = ref_env.packed(state)
        bad += common.mismatches(sf, kept["end"][0]) + common.mismatches(si, kept["end"][1])
        x = torch.cat([ref_env.observation(state, p, mirror=False),
                       ref_env.observation(state, p, mirror=True)], 1)
        for key, val in rows.items():
            out[key].append(torch.stack(val))
        out["last_v"].append(ref_ppo.forward(w, x.T, mode)[1])
        out["env_mismatches"] += bad
        return state

    def _update(self, kept, w, opt, perms, mode) -> float:
        """The reference's GAE and update on one recorded buffer, the
        gradients averaged over the ranks; returns the mean loss."""
        dev = self.ctx.device
        g = 2 * self.ref.players_per_team
        adv, ret = ref_ppo.gae(kept["reward"].to(dev), kept["value"].to(dev),
                               kept["done"].to(dev), kept["last_v"].to(dev),
                               self.cfg["gamma"], self.cfg["gae_lambda"])
        flat = ref_ppo.flatten_views
        buf = dict(obs=kept["obs"].to(dev),
                   idx=ref_ppo.unpack(flat(kept["dirs"].to(dev)),
                                      flat(kept["acts"].to(dev)), g),
                   logp=flat(kept["logp"].to(dev)), value=flat(kept["value"].to(dev)),
                   adv=flat(adv), ret=flat(ret))
        return ref_ppo.update(w, opt, buf, perms, self.cfg, mode, group=self.ctx.group)

    def work(self) -> dict:
        ppt, b, t = self.ref.players_per_team, self.n_envs, self.n_steps
        f_pad = -(-ref_env.obs_size(self.ref) // 8) * 8
        n = 2 * b * t
        block = self.cfg["shuffle_block"]
        mb = n // block // self.cfg["minibatches"]
        k2 = counts.k2_bound(ppt, self.dims, f_pad, b, t, self.shares,
                             self.ref.substeps, self.ref.solver_iterations)
        k3_ms, k3_by = counts.k3_bound(self.dims, f_pad, mb * block, mb)
        n_updates = self.cfg["epochs"] * self.cfg["minibatches"]
        return {"bounds": {"k2": k2, "k3": (k3_ms * n_updates, k3_by)},
                "shares": self.shares,
                "model_flops": counts.ppo_model_flops(self.dims, n, self.cfg["epochs"])}


def leaves(params) -> list:
    """``nn.Linear`` parameters (``W`` ``[out, in]``) as the reference's
    leaves (``W`` ``[in, out]``), copied."""
    return [(p.T if p.dim() == 2 else p).clone() for p in params]


def leaf_gaps(m_ref, m_prog, d_ref, d_prog):
    """(worst leaf's first-moment gap, worst leaf's change gap): per leaf
    the gap of the two norms over the larger of the reference leaf's norm
    and the median leaf's; leaves whose reference moment norm is under a
    thousandth of the median leaf's are left out."""
    def norms(xs):
        return torch.stack([x.double().norm() for x in xs])

    mr, mp, dr, dp = (norms(x) for x in (m_ref, m_prog, d_ref, d_prog))
    keep = mr >= 1e-3 * mr.median()
    grad = ((mp - mr).abs() / torch.maximum(mr, mr.median()))[keep].max().item()
    change = ((dp - dr).abs() / torch.maximum(dr, dr.median()))[keep].max().item()
    return grad, change
