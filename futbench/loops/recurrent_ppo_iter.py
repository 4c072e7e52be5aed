"""Traffic kind ``recurrent_ppo_iter``: whole recurrent (LSTM) PPO
iterations through the program's entry, a closed loop of whole calls, on
one chip.

One call is ``recurrent_ppo.train_iteration_recurrent_ppo`` with the
kernel (``collect_fn`` ``a2c.collect_recurrent_rollout_fused``, K5, at
the configuration's precision; ``compute_gae``; ``update_fn``
``recurrent_ppo.update_epochs_recurrent``, the BPTT update under
autograd), and it ends when the iteration's loss is on the host. Set-up
builds the runner once from the benchmark's own inputs (weights made on
the card from the seed, a starting batch of envs at kickoff with their
clocks spread, zero carries) and drives it through its first
``recorded_iterations`` iterations through the same entry, keeping what
the check needs; the window goes on with that same runner.

The check follows those iterations in :mod:`ppo_iter`'s two stages:

* the collect, on a sample of envs drawn from the seed: the reference
  steps them from the benchmark's starting state with the program's own
  actions and the kernel's Philox draws, its LSTM carrying its own
  carries across the windows (zeroed where an episode ends); compared as
  ``ppo_iter`` compares them (``env_mismatches``, ``logp_gap``,
  ``value_gap`` with the bootstrap values, ``tie_gap``), and
  ``carry_gap``: the largest absolute difference of the carries c and h
  of both views after each window;
* the update, from the program's collected buffers and the carries each
  window started with: the reference's GAE and its ``epochs`` x
  ``minibatches`` BPTT steps in float32 (the program's update runs in
  float32), on the same block permutations of sequences (redrawn from
  the program's generator stream), starting from the benchmark's
  weights; ``loss_gap``, ``grad_gap`` and ``change_gap`` as in
  ``ppo_iter``.
"""

from __future__ import annotations

import functools
import time

import torch

from futbench import common, counts, counts_recurrent
from futbench.loops import ppo_iter
from futbench.reference import env as ref_env
from futbench.reference import ppo as ref_ppo
from futbench.reference import recurrent as ref_rec

TRAJ = ("obs", "dirs", "acts", "logp", "value", "reward", "done")
MODES = {"bfloat16": "bf16", "float32": "f32"}


def make_weights(gen: torch.Generator, dims, device) -> list:
    """The LSTM actor-critic's leaves from the seed: :func:`ppo_iter.make_weights`
    over ``dims`` (:func:`counts_recurrent.lstm_dims`), the cell drawn as
    one ``[n_t + H, 4H]`` kernel (lecun-normal over its whole fan-in) and
    split into its input kernel ``Wi`` and recurrent kernel ``Wh``, one
    bias."""
    w = ppo_iter.make_weights(gen, dims, device)
    k = 2 * (len(dims) - 3)
    n_t = dims[len(dims) - 4][1]
    return w[:k] + [w[k][:n_t].contiguous(), w[k][n_t:].contiguous()] + w[k + 1:]


class Cell:
    def __init__(self, config: dict, traffic: dict, ctx):
        if ctx.world != 1:
            raise ValueError("recurrent_ppo_iter runs on one chip")
        self.ctx, self.traffic, self.config = ctx, traffic, config
        self.params = common.program_params(config)
        self.ref = common.ref_params(config)
        self.n_envs = traffic["envs"]
        self.n_steps = traffic["steps"]
        self.steps_per_call = self.n_envs * self.n_steps
        self.hsize = config["lstm_size"]
        self.cfg = dict(config["ppo"], rollout_steps=self.n_steps)
        self.mode = MODES[config["compute_dtype"]]
        ppt = self.ref.players_per_team
        self.dims = counts_recurrent.lstm_dims(ref_env.obs_size(self.ref),
                                               config["hidden"], self.hsize,
                                               ppt * 2 * ref_env.N_CHOICES)
        self.shared, self.own = ctx.words(4), ctx.words(4, per_rank=True)
        ref_env.exact_sqrt(ctx.device.type == "cuda")

    # ------------------------------------------------------------------ set-up

    def setup(self) -> None:
        t0 = time.time()
        from gym_futbol_tpu_torch import a2c, ops, recurrent_ppo
        from gym_futbol_tpu_torch import env as penv
        from gym_futbol_tpu_torch.models.recurrent import RecurrentActorCritic

        dev = self.ctx.device
        self.rppo, self.ops = recurrent_ppo, ops
        self.setup_parts = {"program imported": time.time() - t0}
        self.pcfg = recurrent_ppo.RecurrentPPOConfig(**self.cfg)
        gen = torch.Generator(device=dev).manual_seed(self.shared[0])
        self.w0 = make_weights(gen, self.dims, dev)
        self.sf0, self.si0 = ref_env.initial_state(gen, self.ref, self.n_envs, dev)
        model = RecurrentActorCritic(self.ref.players_per_team, ref_env.obs_size(self.ref),
                                     self.config["hidden"], self.hsize, device=dev)
        with torch.no_grad():
            for p, w in zip(model.parameters(), self.w0, strict=True):
                p.copy_(w.T if w.dim() == 2 else w)
        state = ops.unpack_state(self.sf0, self.si0, self.params)
        z = torch.zeros((2, self.n_envs, self.hsize), device=dev)
        self.runner = a2c.RecurrentRunnerState(
            model=model, env_state=state, obs=penv.observe(state, self.params),
            carry=(z, z.clone()),
            generator=torch.Generator(device=dev).manual_seed(self.own[0]),
            optimizer=recurrent_ppo.make_optimizer(model, self.pcfg))
        dtype = getattr(torch, self.config["compute_dtype"])
        self.collect = functools.partial(a2c.collect_recurrent_rollout_fused,
                                         compute_dtype=dtype)
        self.envs = common.sample(self.own[1], self.n_envs, self.traffic["check_envs"])
        self.cols = torch.tensor(self.envs, device=dev)
        self.recorded, self.losses = [], []
        self.setup_parts["inputs and runner made"] = time.time() - t0
        for k in range(self.traffic["recorded_iterations"]):
            self.losses.append(self._recorded_call())
            if k == 0:
                adam = self.runner.optimizer.adam.state
                self.m1 = ppo_iter.leaves(
                    adam[p]["exp_avg"] if p in adam else torch.zeros_like(p)
                    for p in self.runner.optimizer.params)
        self.w_end = ppo_iter.leaves(p.detach() for p in self.runner.optimizer.params)
        self.setup_parts["recorded iterations (the first loads the kernels)"] = (
            time.time() - t0)

    def _recorded_collect(self, runner, env_params, cfg):
        """The collect, its outputs, the carries it started from and, at the
        sample envs, the carries it ended with kept on the host."""
        kept = {"c0": tuple(c.cpu() for c in runner.carry)}
        runner, traj, last_v = self.collect(runner, env_params, cfg)
        kept.update({k: getattr(traj, k).cpu() for k in TRAJ}, last_v=last_v.cpu(),
                    c_end=tuple(c[:, self.cols].cpu() for c in runner.carry))
        self.recorded.append(kept)
        return runner, traj, last_v

    def _recorded_call(self) -> float:
        """One iteration through the window's entry, its collect's outputs
        and the sample envs' end state kept on the host for the check."""
        loss = self._call(self._recorded_collect)
        sf, si = self.ops.pack_state(self.runner.env_state, self.params)
        self.recorded[-1]["end"] = (sf[:, self.cols].cpu(), si[:, self.cols].cpu())
        return loss

    def _call(self, collect_fn) -> float:
        self.runner, metrics = self.rppo.train_iteration_recurrent_ppo(
            self.runner, self.params, self.pcfg, collect_fn=collect_fn,
            update_fn=self.rppo.update_epochs_recurrent)
        return metrics["loss"].item()

    # ------------------------------------------------------------------ window

    def call(self) -> float:
        return self._call(self.collect)

    traced_call = call

    def release(self) -> None:
        del self.runner
        self.w0 = [w.cpu() for w in self.w0]
        self.m1 = [m.cpu() for m in self.m1]
        self.w_end = [w.cpu() for w in self.w_end]
        self.sf0, self.si0 = self.sf0[:, self.cols].cpu(), self.si0[:, self.cols].cpu()

    # ------------------------------------------------------------------ check

    def check(self, control: bool = False) -> list:
        """The compared numbers, each with its limit. ``control``: the
        reference computed with float8 products, the collect's and the
        update's, stands in the program's place."""
        ref = self.follow(self.mode, "f32")
        got = self.follow("fp8", "fp8") if control else self.program_outputs()
        return self.compare(ref, got, control)

    def compare(self, ref: dict, got: dict, control: bool = False) -> list:
        lim = self.traffic["limits"]
        g = {"env_mismatches": 0 if control else ref["env_mismatches"]}
        g["logp_gap"] = (got["logp"] - ref["logp"]).abs().max().item()
        g["value_gap"] = max((got["value"] - ref["value"]).abs().max().item(),
                             (got["last_v"] - ref["last_v"]).abs().max().item())
        g["tie_gap"] = ref_ppo.tie_distance(ref["idx"], got["idx"], ref["cdf"],
                                            ref["u"]).max().item()
        g["carry_gap"] = (got["carry"] - ref["carry"]).abs().max().item()
        g["loss_gap"] = max(abs(a - b) / max(abs(b), 1e-12)
                            for a, b in zip(got["losses"], ref["losses"]))
        g["grad_gap"], g["change_gap"] = ppo_iter.leaf_gaps(
            ref["m1"], got["m1"], [a - b for a, b in zip(ref["w_end"], self.w0)],
            [a - b for a, b in zip(got["w_end"], self.w0)])
        return [(name, value, lim[name]) for name, value in g.items()]

    def _sample_cols(self) -> torch.Tensor:
        """The sample envs' columns of a ``[T, 2B]`` row: team-0 views, then
        team-1."""
        envs = torch.tensor(self.envs)
        return torch.cat([envs, self.n_envs + envs])

    def program_outputs(self) -> dict:
        """The recorded outputs at the sample envs, in :meth:`follow`'s
        layout."""
        g = 2 * self.ref.players_per_team
        cols = self._sample_cols()
        out = {k: [] for k in ("logp", "value", "last_v", "idx", "carry")}
        for kept in self.recorded:
            out["logp"].append(kept["logp"][:, cols])
            out["value"].append(kept["value"][:, cols])
            out["last_v"].append(kept["last_v"][cols])
            out["idx"].append(ref_ppo.unpack(kept["dirs"][:, cols],
                                             kept["acts"][:, cols], g))
            out["carry"].append(torch.stack([c.reshape(len(cols), -1)
                                             for c in kept["c_end"]]))
        out = {k: torch.stack(v) for k, v in out.items()}
        return dict(out, losses=self.losses, m1=self.m1, w_end=self.w_end)

    def follow(self, collect_mode: str, update_mode: str) -> dict:
        """The reference through the recorded iterations, the collect's
        products in ``collect_mode`` and the update's in ``update_mode``:
        at the sample envs (team-0 views then team-1 in each ``[.., 2S]``
        row) the log-probs and values of the program's actions, the
        bootstrap values, the inverse-CDF draws and their CDFs, the carries
        after each window ``[2, 2S, H]``; each iteration's mean loss, the
        first moment after the first, the weights after the last; and the
        count of the sample's env outputs that differ from the program's."""
        ref_ppo.no_tf32()
        dev = self.ctx.device
        gen = torch.Generator(device=dev).manual_seed(self.own[0])
        w = [x.to(dev).clone() for x in self.w0]
        opt = ref_ppo.Adam(w, self.cfg["lr"], self.cfg["max_grad_norm"])
        state = ref_env.state_from_packed(self.sf0, self.si0, self.ref.n_bodies)
        carry = (torch.zeros(2 * len(self.envs), self.hsize),) * 2
        ref_env.reset_active()
        n_blocks = 2 * self.n_envs // self.cfg["shuffle_block"]
        keys = ("logp", "value", "last_v", "idx", "cdf", "u", "carry", "losses")
        out = {k: [] for k in keys}
        out["env_mismatches"] = 0
        for k, kept in enumerate(self.recorded):
            seed = int(torch.randint(0, 2**31 - 1, (), generator=gen, device=dev))
            perms = torch.stack([torch.randperm(n_blocks, generator=gen, device=dev)
                                 for _ in range(self.cfg["epochs"])])
            state, carry = self._collect(kept, state, carry, seed,
                                         [x.cpu() for x in w], collect_mode, out)
            out["losses"].append(self._update(kept, w, opt, perms, update_mode))
            if k == 0:
                out["m1"] = [m.detach().cpu().clone() for m in opt.m]
        out["w_end"] = [x.detach().cpu() for x in w]
        self.shares = {
            "pairs_env": ref_env.ACTIVE["pairs"] / ref_env.ACTIVE["env_substeps"],
            "walls_env": ref_env.ACTIVE["walls"] / ref_env.ACTIVE["env_substeps"]}
        for key in keys[:-1]:
            out[key] = torch.stack(out[key])
        return out

    def _collect(self, kept, state, carry, seed, w, mode, out):
        """Replay the sample envs through one recorded collect with the
        program's actions, the reference's LSTM on its own carries;
        returns their end state and carries."""
        p, t_len = self.ref, self.n_steps
        g = 2 * p.players_per_team
        envs = torch.tensor(self.envs)
        s = len(envs)
        u = ref_env.philox_uniforms(seed, t_len, ref_env.n_draws_per_step(p), envs)
        cos_t, sin_t, nx, ny = ref_env.step_noise(u, p, 2 * g, self.ctx.device)
        cols = self._sample_cols()
        ia = ref_ppo.unpack(kept["dirs"][:, cols], kept["acts"][:, cols], g)
        c, h = carry
        bad = 0
        rows = {k: [] for k in ("logp", "value", "idx", "cdf", "u")}
        for k in range(t_len):
            x = torch.cat([ref_env.observation(state, p, mirror=False),
                           ref_env.observation(state, p, mirror=True)], 1).T
            bad += common.mismatches(x, kept["obs"][k, cols])
            logits, value, c, h = ref_rec.forward(w, x, c, h, mode)
            logp, _ = ref_ppo.logp_entropy(logits, ia[k])
            uv = torch.cat([u[k, :g], u[k, g:2 * g]], 1).T
            idx, cdf = ref_ppo.sample(logits, uv)
            for key, val in zip(rows, (logp, value, idx, cdf, uv)):
                rows[key].append(val)
            dirs = [ia[k, :s, 2 * q].int() for q in range(p.players_per_team)] + [
                ref_env.mirror_dir(ia[k, s:, 2 * q]).int()
                for q in range(p.players_per_team)]
            acts = [ia[k, :s, 2 * q + 1].int() for q in range(p.players_per_team)] + [
                ia[k, s:, 2 * q + 1].int() for q in range(p.players_per_team)]
            state, r0, r1, done = ref_env.step(state, dirs, acts, cos_t[k], sin_t[k],
                                               list(nx[k]), list(ny[k]), p)
            both = torch.cat([done, done])
            bad += (common.mismatches(torch.cat([r0, r1]).float(), kept["reward"][k, cols])
                    + common.mismatches(both, kept["done"][k, cols]))
            keep = (1.0 - both.float())[:, None]
            c, h = c * keep, h * keep
        sf, si = ref_env.packed(state)
        bad += common.mismatches(sf, kept["end"][0]) + common.mismatches(si, kept["end"][1])
        x = torch.cat([ref_env.observation(state, p, mirror=False),
                       ref_env.observation(state, p, mirror=True)], 1).T
        for key, val in rows.items():
            out[key].append(torch.stack(val))
        out["last_v"].append(ref_rec.forward(w, x, c, h, mode)[1])
        out["carry"].append(torch.stack([c, h]))
        out["env_mismatches"] += bad
        return state, (c, h)

    def _update(self, kept, w, opt, perms, mode) -> float:
        """The reference's GAE and BPTT update on one recorded window, from
        the carries it started with; returns the mean loss."""
        dev = self.ctx.device
        g = 2 * self.ref.players_per_team
        on = {k: kept[k].to(dev) for k in TRAJ + ("last_v",)}
        adv, ret = ref_ppo.gae(on["reward"], on["value"], on["done"], on["last_v"],
                               self.cfg["gamma"], self.cfg["gae_lambda"])
        c0, h0 = (c.reshape(2 * self.n_envs, -1).to(dev) for c in kept["c0"])
        buf = dict(obs=on["obs"], done=on["done"],
                   idx=ref_ppo.unpack(on["dirs"], on["acts"], g), logp=on["logp"],
                   value=on["value"], adv=adv, ret=ret, c0=c0, h0=h0)
        return ref_rec.update(w, opt, buf, perms, self.cfg, mode)

    def work(self) -> dict:
        ppt, b, t = self.ref.players_per_team, self.n_envs, self.n_steps
        f_pad = -(-ref_env.obs_size(self.ref) // 8) * 8
        k5 = counts_recurrent.k5_bound(ppt, self.dims, self.hsize, f_pad, b, t,
                                       self.shares, self.ref.substeps,
                                       self.ref.solver_iterations)
        return {"bounds": {"k5": k5}, "shares": self.shares,
                "model_flops": counts.ppo_model_flops(self.dims, 2 * b * t,
                                                      self.cfg["epochs"])}
