"""Hand-written CUDA kernels for the hot path, each beside its plain
PyTorch version. Kernels build at first use (see :mod:`._build`).

Layout, imports pointing down only:

    fused_{collect,actor,recurrent,update,bptt}  one kernel each
    _policy        what the policy kernels K2, K4, K5 (and K6) share
    fused_rollout  K1; the env state, constants and draws of every kernel
    _build         library, launches and their counts, the card's limits
"""

from ._build import LAUNCHES, reset_launch_counts  # noqa: F401
from .fused_rollout import (  # noqa: F401
    fused_rollout,
    fused_rollout_reference,
    fused_rollout_replay,
    n_draws_per_step,
    pack_state,
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
from .fused_recurrent import (  # noqa: F401
    flatten_recurrent_actor_critic,
    fused_recurrent_collect,
    fused_recurrent_collect_reference,
)
from .fused_update import (  # noqa: F401
    fused_minibatch_grad,
    fused_minibatch_grad_reference,
    unflatten_actor_critic,
)
from .fused_bptt import fused_lstm_bptt  # noqa: F401
