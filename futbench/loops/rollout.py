"""Traffic kind ``rollout``: the random-policy rollout on the
``fused_rollout`` kernel (K1a), a closed loop of whole calls.

Each call runs ``steps`` steps of ``envs`` envs with auto-reset in one
launch (``ops.fused_rollout``, a fresh Philox seed a call), chained on
the state the call before returned, and ends when its mean team-0
reward is on the host, as a user's loop that reads its rewards has it.

The check replays one call of the window, drawn from the seed, on a
sample of ``check_envs`` envs drawn from the seed: the reference steps
them from that call's input state with the kernel's Philox stream, and
every float and integer of their output state and of their ``[T]``
rewards must equal the kernel's bits (``mismatches``, limit 0).
"""

from __future__ import annotations

import time

import torch

from futbench import common, counts
from futbench.reference import env as ref_env


class Cell:
    def __init__(self, config: dict, traffic: dict, ctx):
        self.ctx, self.traffic = ctx, traffic
        self.params = common.program_params(config)
        self.ref = common.ref_params(config)
        self.n_envs, self.n_steps = traffic["envs"], traffic["steps"]
        self.steps_per_call = self.n_envs * self.n_steps
        self.words = ctx.words(4)
        ref_env.exact_sqrt(ctx.device.type == "cuda")

    def setup(self) -> None:
        t0 = time.time()
        from gym_futbol_tpu_torch import ops

        self.ops = ops
        self.setup_parts = {"program imported": time.time() - t0}
        gen = torch.Generator(device=self.ctx.device).manual_seed(self.words[0])
        self.sf, self.si = ref_env.initial_state(gen, self.ref, self.n_envs,
                                                 self.ctx.device)
        rng = torch.Generator().manual_seed(self.words[1])
        self.call_seeds = torch.randint(0, 2**31 - 1, (1 << 16,), generator=rng).tolist()
        self.k = 0
        self.check_at = self.traffic["warmup_calls"] + int(torch.randint(
            0, self.traffic["check_within"], (), generator=rng))
        self.envs = common.sample(self.words[2], self.n_envs, self.traffic["check_envs"])
        self.record = None
        self.setup_parts["inputs made"] = time.time() - t0
        for _ in range(self.traffic["warmup_calls"]):
            self.call()
        self.setup_parts["warm-up calls (the first loads the kernels)"] = time.time() - t0

    def call(self) -> float:
        seed = self.call_seeds[self.k % len(self.call_seeds)]
        sf, si, rew = self.ops.fused_rollout(self.sf, self.si, seed, self.params,
                                             self.n_steps)
        result = rew.mean().item()
        self.last = (self.sf, self.si, seed, sf, si, rew)
        if self.k == self.check_at:
            self.record = self.last
        self.sf, self.si = sf, si
        self.k += 1
        return result

    traced_call = call

    def release(self) -> None:
        # a window that ended before the drawn call checks its last one
        record = self.record or self.last
        cols = torch.tensor(self.envs, device=record[0].device)
        self.record = tuple(x[:, cols].cpu() if torch.is_tensor(x) else x
                            for x in record)
        del self.sf, self.si, self.last

    def replay(self, dtype=torch.float32):
        """The reference's output for the recorded call's sample."""
        sf_in, si_in, seed, _, _, _ = self.record
        ref_env.reset_active()
        return ref_env.random_rollout(
            sf_in, si_in, seed, self.ref, self.n_steps, torch.tensor(self.envs),
            math_device=self.ctx.device, dtype=dtype)

    def check(self, control: bool = False) -> list:
        """``control``: the reference computed in bfloat16 stands in the
        program's place (the control run of the harness's tests)."""
        want = self.replay()
        got = self.replay(torch.bfloat16) if control else self.record[3:]
        bad = sum(common.mismatches(a, b) for a, b in zip(got, want))
        self.shares = {
            "pairs_env": ref_env.ACTIVE["pairs"] / ref_env.ACTIVE["env_substeps"],
            "walls_env": ref_env.ACTIVE["walls"] / ref_env.ACTIVE["env_substeps"]}
        return [("mismatches", bad, self.traffic["limits"]["mismatches"])]

    def work(self) -> dict:
        ms, by = counts.k1a_bound(self.ref.players_per_team, self.n_envs,
                                  self.n_steps, self.shares, self.ref.substeps,
                                  self.ref.solver_iterations)
        return {"bounds": {"k1a": (ms, by)}, "shares": self.shares}
