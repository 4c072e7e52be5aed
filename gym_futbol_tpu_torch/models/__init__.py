"""Policy networks (counterpart of :mod:`gym_futbol_tpu.models`)."""

from .policy import (  # noqa: F401
    ActorCritic,
    action_log_prob_and_entropy,
    action_log_prob_and_entropy_packed,
    init_params,
    make_normalized_policy_fn,
    make_policy_fn,
    pack_actions,
    sample_actions,
)
