"""Operations, bytes and least times of the work a cell asks for.

The counts are of the work these inputs need, whatever implements it:
each input byte read once and each output byte written once; the env
step's floating-point operations counted by hand from the published
step, at the mean number of contact constraints active per env and
substep in the cell's own data (an inactive constraint's update is a
no-op that needs no work); the MLP's products at two operations per
multiply-add. The rules, rewards and draws are left out of the step's
count, so every bound here is at most the true least time.

Peaks: one NVIDIA H100 SXM, dense, at the 700 W limit (NVIDIA's data
sheet): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32 on the
CUDA cores, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_PER_S = 67e12
BF16_PER_S = 989e12


def bound(n_bytes: float, f32_ops: float = 0.0, bf16_ops: float = 0.0):
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the operations over their type's peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = f32_ops / F32_PER_S + bf16_ops / BF16_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def env_step_ops(ppt: int, substeps: int = 5, solver_iterations: int = 10,
                 shares: dict | None = None) -> int:
    """Floating-point operations of one env step: per solver iteration 40
    per body-pair update (normal and friction impulses) and 11 per (wall,
    body) update; per substep 20 per pair (contact set-up) and 40 per
    body (wall set-up, integration). ``shares`` ``{"pairs_env",
    "walls_env"}``: the mean number of pairs and (wall, body) constraints
    active per env and substep; without it every one is updated."""
    nb = 2 * ppt + 1
    pairs = nb * (nb - 1) // 2
    upd_pairs, upd_walls = ((pairs, 4 * nb) if shares is None
                            else (shares["pairs_env"], shares["walls_env"]))
    return round(substeps * (solver_iterations * (40 * upd_pairs + 11 * upd_walls)
                             + 20 * pairs + 40 * nb))


def mlp_dims(obs: int, hidden, n_logits: int) -> list[tuple[int, int]]:
    """(in, out) of each product: the torso, the logits head, the value
    head last."""
    dims = [obs, *hidden]
    return [*zip(dims[:-1], dims[1:]), (dims[-1], n_logits), (dims[-1], 1)]


def mlp_ops(dims) -> int:
    """One forward per sample: two operations per multiply-add, one per
    bias (activations and sampling left out)."""
    return sum(2 * a * b + b for a, b in dims)


def mlp_macs(dims) -> int:
    return sum(a * b for a, b in dims)


def state_bytes(ppt: int, n_envs: int) -> int:
    """The packed env state: 4 floats a body, 4 ints an env."""
    return 4 * (4 * (2 * ppt + 1) + 4) * n_envs


def k1a_bound(ppt: int, n_envs: int, n_steps: int, shares: dict,
              substeps: int = 5, solver_iterations: int = 10):
    """K1a's least ms for a whole rollout: the state read and written
    once, the ``[T, B]`` rewards written once; the env step's float32
    operations at ``shares``."""
    n_bytes = 2 * state_bytes(ppt, n_envs) + 4 * n_steps * n_envs
    ops = env_step_ops(ppt, substeps, solver_iterations, shares)
    return bound(n_bytes, n_envs * n_steps * ops)


def k2_ops(ppt: int, dims, shares: dict, substeps: int = 5,
           solver_iterations: int = 10) -> tuple[int, int]:
    """(operations, of them bf16) per env-step of the collect: the env
    step at ``shares`` and both views' MLP, of which the torso's and the
    logits head's products run on the tensor cores."""
    ops_all = (env_step_ops(ppt, substeps, solver_iterations, shares)
               + 2 * mlp_ops(dims))
    ops_bf16 = 2 * sum(2 * a * b for a, b in dims[:-1])
    return ops_all, ops_bf16


def k2_bound(ppt: int, dims, f_pad: int, n_envs: int, n_steps: int,
             shares: dict, substeps: int = 5, solver_iterations: int = 10):
    """K2's least ms for a whole collect: the state read and written and
    the weights read once, the ``[F_pad, 2BT]`` obs buffer, its per-step
    rows (two action words, logp, value, reward, done) and the bootstrap
    values written once; the operations of :func:`k2_ops`."""
    ops_all, ops_bf16 = k2_ops(ppt, dims, shares, substeps, solver_iterations)
    weight_bytes = 4 * sum(a * b + b for a, b in dims)
    n_bytes = (2 * state_bytes(ppt, n_envs) + weight_bytes
               + 4 * 2 * n_envs * (f_pad * n_steps + 6 * n_steps + 1))
    work = n_envs * n_steps
    return bound(n_bytes, work * (ops_all - ops_bf16), work * ops_bf16)


def k3_macs(dims) -> tuple[int, int]:
    """(bf16, f32) multiply-adds per sample of one minibatch gradient:
    the torso and logits head forward, their backward (dh and dW of the
    logits head and of every layer but the first, whose dW alone is
    needed) on the tensor cores; the value head's v, dh and dW in
    float32."""
    layers = dims[:-2]
    head = dims[-2]
    layer_macs = sum(a * b for a, b in layers)
    head_macs = head[0] * head[1]
    bf16 = (layer_macs + head_macs) + 2 * head_macs + 2 * layer_macs - layers[0][0] * layers[0][1]
    return bf16, 3 * dims[-1][0]


def k3_bound(dims, f_pad: int, m: int, mb_blocks: int):
    """K3's least ms on one minibatch of ``m`` samples in ``mb_blocks``
    blocks: the minibatch's obs columns, per-sample rows and block
    indices read once, the weights read and the gradients written once;
    :func:`k3_macs` at two operations each."""
    bf16, f32 = k3_macs(dims)
    weight_bytes = 4 * sum(a * b + b for a, b in dims)
    n_bytes = f_pad * m * 4 + 6 * m * 4 + mb_blocks * 4 + 2 * weight_bytes + 16
    return bound(n_bytes, 2 * f32 * m, 2 * bf16 * m)


def ppo_model_flops(dims, n_samples: int, epochs: int) -> float:
    """Model FLOPs of one PPO iteration over ``n_samples`` (both views of
    every env-step): the collect's forward of each sample, and per epoch
    the update's forward and backward of each (2 + 4 operations a
    multiply-add)."""
    macs = mlp_macs(dims)
    return 2.0 * macs * n_samples + 6.0 * macs * n_samples * epochs
