"""The plain actor-critic, sampling, GAE, clipped-surrogate loss and
optimiser that the benchmark holds the program's PPO iteration to.

Plain PyTorch under autograd, written from the published method
(Schulman et al. 2017, arXiv:1707.06347; GAE, arXiv:1506.02438; Adam,
arXiv:1412.6980, in optax's form after a global-norm clip). It imports
nothing of the program. Weights are a list of leaves ``[W1, b1, ...,
Wl, bl, Wv, bv]``, each ``W`` ``[in, out]`` and ``b`` ``[out]``: a tanh
torso, a logits head of five-way groups (a direction and an act per
player) and a value head.

``mode`` sets the precision of the torso's and the logits head's
products: ``"bf16"`` rounds both operands to bfloat16 and sums in
float32 (the configuration's precision), ``"fp8"`` rounds them to
float8 e4m3 (the control), ``"f32"`` rounds nothing. The value head reads
the unrounded torso in float32 in every mode. Products run in float32
with TF32 off.
"""

from __future__ import annotations

import torch

N_CHOICES = 5
_ROUND = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _rounded(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "f32":
        return x
    return x.to(_ROUND[mode]).to(torch.float32)


def forward(w: list, x: torch.Tensor, mode: str):
    """``x`` ``[S, F]`` -> (logits ``[S, G*5]``, value ``[S]``)."""
    h = x.float()
    n_torso = len(w) // 2 - 2
    for li in range(n_torso):
        h = torch.tanh(_rounded(h, mode) @ _rounded(w[2 * li], mode) + w[2 * li + 1])
    logits = _rounded(h, mode) @ _rounded(w[-4], mode) + w[-3]
    value = (h @ w[-2] + w[-1])[:, 0]
    return logits, value


def unpack(dirs: torch.Tensor, acts: torch.Tensor, n_groups: int) -> torch.Tensor:
    """Packed actions (3 bits a player) -> group indices ``[..., G]``,
    groups ordered (player, slot): slot 0 the direction, 1 the act."""
    cols = []
    for g in range(n_groups):
        packed = dirs if g % 2 == 0 else acts
        cols.append((packed >> (3 * (g // 2))) & 7)
    return torch.stack(cols, -1).long()


def logp_entropy(logits: torch.Tensor, idx: torch.Tensor):
    """Joint log-prob of group indices ``[S, G]`` and the summed entropy."""
    lg = logits.reshape(*logits.shape[:-1], -1, N_CHOICES)
    logp = torch.log_softmax(lg, -1)
    taken = logp.gather(-1, idx[..., None])[..., 0].sum(-1)
    entropy = -(logp.exp() * logp).sum(-1).sum(-1)
    return taken, entropy


def sample(logits: torch.Tensor, u: torch.Tensor):
    """Inverse-CDF sampling of each group with uniforms ``u`` ``[S, G]``:
    (indices ``[S, G]``, the CDF at each boundary ``[S, G, 4]``)."""
    lg = logits.reshape(*logits.shape[:-1], -1, N_CHOICES).double()
    p = torch.softmax(lg, -1)
    cdf = p.cumsum(-1)[..., :N_CHOICES - 1]
    idx = (u.double()[..., None] > cdf).sum(-1)
    return idx, cdf


def tie_distance(idx_ref, idx_prog, cdf, u) -> torch.Tensor:
    """For each group, how far the uniform lies from the CDF boundaries
    between the reference's and the program's choice (0 where they
    agree): a choice that a rounding can flip lies within a hair of one."""
    lo = torch.minimum(idx_ref, idx_prog)
    hi = torch.maximum(idx_ref, idx_prog)
    b_lo = cdf.gather(-1, lo.clamp(max=N_CHOICES - 2)[..., None])[..., 0]
    b_hi = cdf.gather(-1, (hi - 1).clamp(min=0)[..., None])[..., 0]
    ud = u.double()
    dist = torch.maximum((ud - b_lo).abs(), (ud - b_hi).abs())
    return torch.where(idx_ref == idx_prog, torch.zeros_like(dist), dist)


def gae(reward, value, done, last_value, gamma: float, lam: float):
    """Generalised advantage estimation over ``[T, N]`` rows, backwards
    from the bootstrap value ``[N]``: (advantages, returns)."""
    adv = torch.empty_like(value)
    acc = torch.zeros_like(last_value)
    nxt = last_value
    for t in reversed(range(value.shape[0])):
        nonterminal = 1.0 - done[t].to(value.dtype)
        delta = reward[t] + gamma * nxt * nonterminal - value[t]
        acc = delta + gamma * lam * nonterminal * acc
        adv[t] = acc
        nxt = value[t]
    return adv, adv + value


def flatten_views(x: torch.Tensor) -> torch.Tensor:
    """``[T, 2B]`` rows (team-0 view then team-1) -> ``[N]`` samples in
    (view, step, env) order, the order of the feature-major obs buffer."""
    t, b2 = x.shape
    return x.reshape(t, 2, b2 // 2).transpose(0, 1).reshape(t * b2)


def ppo_loss(w, obs, idx, logp_old, value_old, adv, ret, cfg: dict, mode: str):
    """The clipped-surrogate loss of one minibatch (obs ``[S, F]``):
    advantages normalised over the minibatch (population std + 1e-8),
    the policy term, the clipped value term, an entropy bonus."""
    logits, value = forward(w, obs, mode)
    logp, entropy = logp_entropy(logits, idx)
    ratio = torch.exp(logp - logp_old)
    adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    eps = cfg["clip_eps"]
    pg = -torch.minimum(ratio * adv_n, torch.clamp(ratio, 1 - eps, 1 + eps) * adv_n).mean()
    v_clip = value_old + torch.clamp(value - value_old, -eps, eps)
    v_loss = 0.5 * torch.maximum((value - ret) ** 2, (v_clip - ret) ** 2).mean()
    return pg + cfg["vf_coef"] * v_loss - cfg["ent_coef"] * entropy.mean()


class Adam:
    """optax's ``chain(clip_by_global_norm(c), adam(lr, 0.9, 0.999,
    1e-8))``, leaf by leaf."""

    def __init__(self, w: list, lr: float, max_norm: float):
        self.lr, self.max_norm, self.count = lr, max_norm, 0
        self.m = [torch.zeros_like(x) for x in w]
        self.v = [torch.zeros_like(x) for x in w]

    @torch.no_grad()
    def step(self, w: list, grads: list) -> None:
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        scale = torch.where(norm < self.max_norm, 1.0, self.max_norm / norm)
        self.count += 1
        c1 = 1 - 0.9 ** self.count
        c2 = 1 - 0.999 ** self.count
        for x, g, m, v in zip(w, grads, self.m, self.v):
            g = g * scale
            m.mul_(0.9).add_(0.1 * g)
            v.mul_(0.999).add_(0.001 * g * g)
            x.sub_(self.lr * (m / c1) / (torch.sqrt(v / c2) + 1e-8))


def update(w: list, opt: Adam, buf: dict, perms: torch.Tensor, cfg: dict,
           mode: str, group=None) -> float:
    """``epochs`` x ``minibatches`` steps over one iteration's buffer,
    the minibatches whole blocks of ``shuffle_block`` consecutive samples
    in each epoch's block permutation ``perms[e]``. ``buf``: ``obs``
    feature-major ``[F_pad, N]``; ``idx`` ``[N, G]``; ``logp``,
    ``value``, ``adv``, ``ret`` ``[N]``, all on the device the update
    runs on. With ``group`` (a ``torch.distributed`` group over which the
    envs are split) each step's gradients and loss are averaged over the
    ranks before the step. Updates ``w`` in place; returns the mean loss."""
    n = buf["logp"].numel()
    block = cfg["shuffle_block"]
    n_blocks = n // block
    mb_blocks = n_blocks // cfg["minibatches"]
    f = w[0].shape[0]
    losses = []
    for perm in perms:
        for mb in perm[: cfg["minibatches"] * mb_blocks].reshape(cfg["minibatches"], mb_blocks):
            cols = (mb[:, None] * block + torch.arange(block, device=mb.device)).reshape(-1)
            obs = buf["obs"][:f, cols].T
            leaves = [x.detach().requires_grad_(True) for x in w]
            loss = ppo_loss(leaves, obs, buf["idx"][cols], buf["logp"][cols],
                            buf["value"][cols], buf["adv"][cols], buf["ret"][cols],
                            cfg, mode)
            grads = [*torch.autograd.grad(loss, leaves), loss.detach()]
            if group is not None:
                import torch.distributed as dist

                for g in grads:
                    dist.all_reduce(g, group=group)
                    g.div_(dist.get_world_size(group))
            opt.step(w, grads[:-1])
            losses.append(grads[-1])
    return torch.stack(losses).mean().item()
