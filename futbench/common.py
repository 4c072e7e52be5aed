"""What the timed loops share: a configuration read into the program's
settings and the reference's, and the sample of envs a check replays."""

from __future__ import annotations

import numpy as np

from futbench.reference import env as ref_env


def ref_params(config: dict) -> ref_env.Params:
    return ref_env.Params.from_config(config["players_per_team"],
                                      config.get("env_params", {}))


def program_params(config: dict):
    """The program's ``EnvParams`` for the configuration."""
    from gym_futbol_tpu_torch.types import EnvParams, RewardConfig

    kw = dict(config.get("env_params", {}))
    if "rewards" in kw:
        kw["rewards"] = RewardConfig(**kw["rewards"])
    return EnvParams(players_per_team=config["players_per_team"], **kw)


def sample(word: int, n: int, k: int) -> list[int]:
    """``k`` distinct indices of ``range(n)`` drawn from ``word``, sorted."""
    rng = np.random.default_rng(word)
    return sorted(int(i) for i in rng.choice(n, size=min(k, n), replace=False))


def mismatches(a, b) -> int:
    """Entries where two tensors differ (signed zeros equal)."""
    return int((a != b).sum().item())
