"""Hand-written CUDA kernels for the hot path, each beside its plain
PyTorch version. Kernels build at first use (see :mod:`._build`)."""

from .fused_rollout import (  # noqa: F401
    LAUNCHES,
    fused_rollout,
    fused_rollout_reference,
    fused_rollout_replay,
    n_draws_per_step,
    pack_state,
    reset_launch_counts,
    unpack_state,
)
from .fused_actor import (  # noqa: F401
    fused_selfplay_rollout,
    fused_selfplay_rollout_reference,
    init_mlp,
)
from .fused_collect import (  # noqa: F401
    flatten_actor_critic,
    fused_collect,
    fused_collect_reference,
)
from .fused_update import (  # noqa: F401
    fused_minibatch_grad,
    fused_minibatch_grad_reference,
    unflatten_actor_critic,
)
