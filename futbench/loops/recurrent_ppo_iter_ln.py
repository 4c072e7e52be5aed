"""Traffic kind ``recurrent_ppo_iter_ln``: whole recurrent PPO iterations
of the layer-normalised LSTM actor-critic (stable-baselines'
``MlpLnLstmPolicy``) through the program's entry, a closed loop of whole
calls, on one chip.

:mod:`recurrent_ppo_iter`'s cell with the configuration's ``layer_norm``
read: the program's ``RecurrentActorCritic(..., layer_norm=True)``
trained through the same ``recurrent_ppo.train_iteration_recurrent_ppo``
(K5's collect at the configuration's precision, ``compute_gae``,
``update_epochs_recurrent`` on its default route, K6), the weights made
from the seed with the six LayerNorm leaves after the plain ones, and
the check followed by :mod:`futbench.reference.lnlstm`.

The check. The layer-normalised recurrence is chaotic at these weights:
a difference in the carry grows about 1.12x a step, so two sound
roundings of the collect part by O(1) over a 128-step window, and a
whole-window comparison of the collect's log-probs, values, draws or
carries cannot tell a sound program from a broken one. The collect is
therefore held over the first ``lead_steps`` steps of the first recorded
iteration, where both sides start from the benchmark's weights and zero
carries and the difference has not grown yet: ``lead_logp_gap`` and
``lead_value_gap`` (the largest absolute differences of the log-probs of
the program's actions and of the values, at the sample envs, both
views; a carry's error reaches them through the heads the next step)
and ``lead_tie_gap`` (:mod:`ppo_iter`'s ``tie_gap`` over those steps).
``env_mismatches`` follows the env over every window (the program's
actions replayed, exact whatever the chaos), and the update is held as
:mod:`recurrent_ppo_iter` holds it, from the program's own buffers:
``loss_gap``, ``grad_gap``, ``change_gap``. What it adds to
:mod:`recurrent_ppo_iter` is the model, the reference's cell, that
check and the counts its metric readers read
(:mod:`futbench.counts_lnlstm`).
"""

from __future__ import annotations

import functools
import time

import torch

from futbench import common, counts_lnlstm
from futbench.loops import ppo_iter, recurrent_ppo_iter
from futbench.reference import env as ref_env
from futbench.reference import lnlstm as ref_ln
from futbench.reference import ppo as ref_ppo

GAIN_SPREAD = 0.1     # LayerNorm gains 1 + 0.1 x normal
BIAS_SPREAD = 0.01    # LayerNorm biases 0.01 x normal


def make_weights(gen: torch.Generator, dims, hsize: int, device) -> list:
    """The layer-normalised actor-critic's leaves from the seed:
    :func:`recurrent_ppo_iter.make_weights`'s, then gx, bx, gh, bh ``[4H]``
    and gc, bc ``[H]``, the gains ``1 + 0.1 x normal`` and the biases
    ``0.01 x normal``."""
    w = recurrent_ppo_iter.make_weights(gen, dims, device)
    for n in (4 * hsize, 4 * hsize, hsize):
        w.append(1.0 + GAIN_SPREAD * torch.randn(n, generator=gen, device=device))
        w.append(BIAS_SPREAD * torch.randn(n, generator=gen, device=device))
    return w


def step_gaps(ref: dict, got: dict) -> dict:
    """The first recorded iteration's collect, step by step: each step's
    largest absolute difference of the log-probs and of the values over
    the sample envs and both views, and its largest tie distance
    (:func:`ref_ppo.tie_distance`), ``[T]`` each."""
    return {
        "logp": (got["logp"][0] - ref["logp"][0]).abs().amax(-1),
        "value": (got["value"][0] - ref["value"][0]).abs().amax(-1),
        "tie": ref_ppo.tie_distance(ref["idx"][0], got["idx"][0], ref["cdf"][0],
                                    ref["u"][0]).flatten(1).amax(-1)}


class Cell(recurrent_ppo_iter.Cell):
    def __init__(self, config: dict, traffic: dict, ctx):
        if config.get("layer_norm") is not True:
            raise ValueError("recurrent_ppo_iter_ln runs a configuration with "
                             "\"layer_norm\": true")
        super().__init__(config, traffic, ctx)

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
        self.w0 = make_weights(gen, self.dims, self.hsize, dev)
        self.sf0, self.si0 = ref_env.initial_state(gen, self.ref, self.n_envs, dev)
        model = RecurrentActorCritic(self.ref.players_per_team, ref_env.obs_size(self.ref),
                                     self.config["hidden"], self.hsize, device=dev,
                                     layer_norm=self.config["layer_norm"])
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

    def compare(self, ref: dict, got: dict, control: bool = False) -> list:
        """The numbers of the module docstring, each with its limit."""
        lim, n = self.traffic["limits"], self.traffic["lead_steps"]
        g = {"env_mismatches": 0 if control else ref["env_mismatches"]}
        for name, gaps in step_gaps(ref, got).items():
            g[f"lead_{name}_gap"] = gaps[:n].max().item()
        g["loss_gap"] = max(abs(a - b) / max(abs(b), 1e-12)
                            for a, b in zip(got["losses"], ref["losses"]))
        g["grad_gap"], g["change_gap"] = ppo_iter.leaf_gaps(
            ref["m1"], got["m1"], [a - b for a, b in zip(ref["w_end"], self.w0)],
            [a - b for a, b in zip(got["w_end"], self.w0)])
        return [(name, value, lim[name]) for name, value in g.items()]

    def _collect(self, kept, state, carry, seed, w, mode, out):
        """Replay the sample envs through one recorded collect with the
        program's actions, the reference's layer-normalised LSTM on its own
        carries (:meth:`recurrent_ppo_iter.Cell._collect` on this cell);
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
            logits, value, c, h = ref_ln.forward(w, x, c, h, mode)
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
        out["last_v"].append(ref_ln.forward(w, x, c, h, mode)[1])
        out["carry"].append(torch.stack([c, h]))
        out["env_mismatches"] += bad
        return state, (c, h)

    def _update(self, kept, w, opt, perms, mode) -> float:
        """The reference's GAE and BPTT update of the layer-normalised cell
        on one recorded window, from the carries it started with; returns
        the mean loss."""
        dev = self.ctx.device
        g = 2 * self.ref.players_per_team
        on = {k: kept[k].to(dev) for k in recurrent_ppo_iter.TRAJ + ("last_v",)}
        adv, ret = ref_ppo.gae(on["reward"], on["value"], on["done"], on["last_v"],
                               self.cfg["gamma"], self.cfg["gae_lambda"])
        c0, h0 = (c.reshape(2 * self.n_envs, -1).to(dev) for c in kept["c0"])
        buf = dict(obs=on["obs"], done=on["done"],
                   idx=ref_ppo.unpack(on["dirs"], on["acts"], g), logp=on["logp"],
                   value=on["value"], adv=adv, ret=ret, c0=c0, h0=h0)
        return ref_ln.update(w, opt, buf, perms, self.cfg, mode)

    def work(self) -> dict:
        ppt, b, t = self.ref.players_per_team, self.n_envs, self.n_steps
        f_pad = -(-ref_env.obs_size(self.ref) // 8) * 8
        return counts_lnlstm.work(ppt, ref_env.obs_size(self.ref), self.config["hidden"],
                                  self.hsize, ppt * 2 * ref_env.N_CHOICES, f_pad, b, t,
                                  self.shares, self.cfg, self.ref.substeps,
                                  self.ref.solver_iterations)
