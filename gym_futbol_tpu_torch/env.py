"""The batched FutbolEnv core in PyTorch: observe, reset and step.

Counterpart of :mod:`gym_futbol_tpu.env`. Every function works on a
batch: the JAX package's ``vmap`` axis is the leading dimension here.

STEP ORDER (normative, as in the JAX package):

    1. decode actions -> per-body forces
    2. resolve possession bids
    3. owner pass/shoot -> ball impulse, release
    4. physics: substeps x (integrate, solve, move)
    5. dribble carry: ball follows owner
    6. goal detection on the post-physics ball
    7. out-of-bounds clamp
    8. shaped rewards (pre-step vs post-step, pre-kickoff positions)
    9. kickoff re-placement where a goal occurred
   10. t += 1; done = t >= max_steps (and, with auto-reset, a fresh
       episode where done that reuses step 9's kickoff draw)
   11. observation build

The step takes its random draws explicitly: the kick angle ``theta``
(a standard normal already scaled by ``kick_noise``) and the kickoff
noise in [-1, 1] per body and coordinate. :func:`sample_step_noise`
draws them from a ``torch.Generator``.

OBSERVATION SPEC: ``[B, 4*n_bodies + 2]``; all positions (x, y per body,
ball first) normalized by width/height, then all velocities normalized
by max_speed, then ``[team0_owns, team1_owns]``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import game
from .physics import physics_step_scalars, to_dtype
from .types import EnvParams, EnvState, StepOutput


def observe(state: EnvState, params: EnvParams) -> torch.Tensor:
    """OBSERVATION SPEC above."""
    dtype = state.pos.dtype
    b = state.pos.shape[0]
    scale_p = torch.tensor([params.width, params.height], dtype=dtype,
                           device=state.pos.device)
    p = (state.pos / scale_p).reshape(b, -1)
    v = (state.vel / to_dtype(params.max_speed, dtype)).reshape(b, -1)
    ppt = params.players_per_team
    owner_p = state.possession - 1
    owns0 = ((state.possession > 0) & (owner_p < ppt)).to(dtype)
    owns1 = ((state.possession > 0) & (owner_p >= ppt)).to(dtype)
    return torch.cat([p, v, owns0[:, None], owns1[:, None]], dim=1)


def obs_size(params: EnvParams) -> int:
    return 4 * params.n_bodies + 2


def mirror_obs(obs: torch.Tensor, params: EnvParams) -> torch.Tensor:
    """Present team 1 with a team-0 view: position x -> 1 - x, velocity
    x -> -vx, the team blocks swapped (ball, team 1, team 0) and the two
    possession flags swapped, so one policy can play either side.
    ``obs``: ``[.., 4*n_bodies + 2]`` (OBSERVATION SPEC)."""
    n = params.n_bodies
    ppt = params.players_per_team
    order = [0, *range(1 + ppt, 1 + 2 * ppt), *range(1, 1 + ppt)]
    lead = obs.shape[:-1]
    pos = obs[..., :2 * n].reshape(*lead, n, 2)[..., order, :]
    vel = obs[..., 2 * n:4 * n].reshape(*lead, n, 2)[..., order, :]
    pos = torch.stack([1.0 - pos[..., 0], pos[..., 1]], -1)
    vel = torch.stack([-vel[..., 0], vel[..., 1]], -1)
    flags = obs[..., 4 * n:].flip(-1)
    return torch.cat([pos.reshape(*lead, 2 * n), vel.reshape(*lead, 2 * n),
                      flags], -1)


def mirror_dir(d: torch.Tensor) -> torch.Tensor:
    """A direction index in the other frame: left and right (2 <-> 4)
    swap."""
    return torch.where(d == 2, 4, torch.where(d == 4, 2, d))


def mirror_actions(actions: torch.Tensor) -> torch.Tensor:
    """Map team actions between the mirrored frame and the world frame:
    the directions of slot 0 mirror (:func:`mirror_dir`); the act slot is
    frame-independent. ``actions``: ``[.., n, 2]`` int."""
    return torch.stack([mirror_dir(actions[..., 0]), actions[..., 1]], -1)


def kickoff_positions(noise: torch.Tensor, params: EnvParams) -> torch.Tensor:
    """Kickoff placement from noise ``[B, n_bodies, 2]`` in [-1, 1]:
    returns positions ``[B, n_bodies, 2]`` (velocities are zero)."""
    n = params.n_bodies
    px, py = game.kickoff_scalars(
        [noise[:, i, 0] for i in range(n)], [noise[:, i, 1] for i in range(n)],
        params, noise.dtype,
    )
    return torch.stack([torch.stack(px, 1), torch.stack(py, 1)], -1)


def reset(
    generator: torch.Generator, params: EnvParams, n_envs: int,
    device: torch.device | str = "cuda", dtype=torch.float32,
) -> tuple[EnvState, torch.Tensor]:
    """A fresh batch of ``n_envs`` episodes. Returns (state, obs)."""
    noise = torch.rand((n_envs, params.n_bodies, 2), generator=generator,
                       dtype=dtype, device=device) * 2.0 - 1.0
    pos = kickoff_positions(noise, params)
    state = EnvState(
        pos=pos,
        vel=torch.zeros_like(pos),
        possession=torch.full((n_envs,), -1, dtype=torch.int32, device=device),
        score=torch.zeros((n_envs, 2), dtype=torch.int32, device=device),
        t=torch.zeros((n_envs,), dtype=torch.int32, device=device),
    )
    return state, observe(state, params)


def sample_step_noise(
    generator: torch.Generator, params: EnvParams, n_envs: int,
    device: torch.device | str | None = None, dtype=torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The draws one step consumes: (theta ``[B]``, kickoff noise
    ``[B, n_bodies, 2]`` in [-1, 1))."""
    theta = torch.randn((n_envs,), generator=generator, dtype=dtype,
                        device=device) * to_dtype(params.kick_noise, dtype)
    noise = torch.rand((n_envs, params.n_bodies, 2), generator=generator,
                       dtype=dtype, device=device) * 2.0 - 1.0
    return theta, noise


class ScalarStep(NamedTuple):
    """One step's results in scalar-SSA form (per-body lists of ``[B]``
    tensors)."""

    px: list
    py: list
    vx: list
    vy: list
    possession: torch.Tensor
    score0: torch.Tensor
    score1: torch.Tensor
    t: torch.Tensor
    r0: torch.Tensor
    r1: torch.Tensor
    goal0: torch.Tensor
    goal1: torch.Tensor
    ball_clamped: torch.Tensor
    done: torch.Tensor
    kickoff_x: list            # this step's kickoff placement draw
    kickoff_y: list


def step_scalars(px, py, vx, vy, possession, score0, score1, t,
                 dirs, acts, theta, noise_x, noise_y,
                 params: EnvParams) -> ScalarStep:
    """Steps 1-10 of the STEP ORDER in scalar-SSA form, the terminal
    transition (no fresh episode where done; see
    :func:`auto_reset_scalars`). The shape of ``_fused_step`` in the JAX
    package's fused-rollout kernel."""
    dtype = px[0].dtype
    n = params.n_bodies
    px, py, vx, vy = list(px), list(py), list(vx), list(vy)
    px_before, py_before = list(px), list(py)

    # 1-3: intent
    fx, fy = game.decode_forces_scalars(dirs, acts, params, dtype)
    possession = game.update_possession_scalars(
        px, py, possession, acts, params, dtype
    )
    dvx, dvy, possession = game.apply_kick_scalars(
        px, py, vx, vy, possession, acts, theta, params, dtype
    )
    vx[0] = vx[0] + dvx
    vy[0] = vy[0] + dvy

    # 4-5: dynamics
    px, py, vx, vy = physics_step_scalars(px, py, vx, vy, fx, fy, params, dtype)
    px[0], py[0], vx[0], vy[0] = game.apply_dribble_scalars(
        px, py, vx, vy, possession, dirs, params, dtype
    )

    # 6-7: goals and bounds
    goal0, goal1 = game.detect_goal_scalars(px[0], py[0], params)
    px, py, vx, vy, ball_clamped = game.clamp_oob_scalars(
        px, py, vx, vy, params, dtype
    )

    # 8: rewards from pre-kickoff positions
    r0, r1 = game.shaped_rewards_scalars(
        px_before, py_before, px, py, possession, goal0, goal1,
        ball_clamped, params, dtype,
    )

    # 9: kickoff re-placement where a goal occurred
    kox, koy = game.kickoff_scalars(noise_x, noise_y, params, dtype)
    any_goal = goal0 | goal1
    for i in range(n):
        px[i] = torch.where(any_goal, kox[i], px[i])
        py[i] = torch.where(any_goal, koy[i], py[i])
        vx[i] = torch.where(any_goal, 0.0, vx[i])
        vy[i] = torch.where(any_goal, 0.0, vy[i])
    possession = torch.where(any_goal, -1, possession)
    score0 = score0 + goal0.to(torch.int32)
    score1 = score1 + goal1.to(torch.int32)

    # 10: clock
    t = t + 1
    done = t >= params.max_steps
    return ScalarStep(px, py, vx, vy, possession, score0, score1, t, r0, r1,
                      goal0, goal1, ball_clamped, done, kox, koy)


def auto_reset_scalars(s: ScalarStep) -> ScalarStep:
    """The carried state after ``s``: a fresh episode where done, reusing
    the step's own kickoff draw (a new episode's first state is a
    kickoff placement)."""
    done = s.done
    return s._replace(
        px=[torch.where(done, k, x) for k, x in zip(s.kickoff_x, s.px)],
        py=[torch.where(done, k, y) for k, y in zip(s.kickoff_y, s.py)],
        vx=[torch.where(done, 0.0, v) for v in s.vx],
        vy=[torch.where(done, 0.0, v) for v in s.vy],
        possession=torch.where(done, -1, s.possession),
        score0=torch.where(done, 0, s.score0),
        score1=torch.where(done, 0, s.score1),
        t=torch.where(done, 0, s.t),
    )


def step(
    state: EnvState, actions: torch.Tensor, theta: torch.Tensor,
    noise: torch.Tensor, params: EnvParams, auto_reset: bool = False,
) -> tuple[EnvState, StepOutput]:
    """One batched step (STEP ORDER above) with explicit draws.

    ``actions``: ``[B, n_players, 2]`` int (direction, act) per player.
    ``theta``: ``[B]`` kick angle noise. ``noise``: ``[B, n_bodies, 2]``
    kickoff noise in [-1, 1].

    With ``auto_reset=True`` the carried state is a fresh episode where
    ``done``; ``reward``/``done``/``info`` report the terminal
    transition and ``obs`` follows the carried state.
    """
    n = params.n_bodies
    pos, vel = state.pos, state.vel
    dirs, acts = game.split_actions(actions, params)
    s = step_scalars(
        [pos[:, i, 0] for i in range(n)], [pos[:, i, 1] for i in range(n)],
        [vel[:, i, 0] for i in range(n)], [vel[:, i, 1] for i in range(n)],
        state.possession, state.score[:, 0], state.score[:, 1], state.t,
        dirs, acts, theta,
        [noise[:, i, 0] for i in range(n)], [noise[:, i, 1] for i in range(n)],
        params,
    )
    info = {
        "score": torch.stack([s.score0, s.score1], -1),
        "possession": s.possession,
        "goal": torch.stack([s.goal0, s.goal1], -1),
        "ball_oob": s.ball_clamped,
        "t": s.t,
    }
    c = auto_reset_scalars(s) if auto_reset else s
    new_state = EnvState(
        pos=torch.stack([torch.stack(c.px, 1), torch.stack(c.py, 1)], -1),
        vel=torch.stack([torch.stack(c.vx, 1), torch.stack(c.vy, 1)], -1),
        possession=c.possession,
        score=torch.stack([c.score0, c.score1], -1),
        t=c.t,
    )
    out = StepOutput(
        obs=observe(new_state, params),
        reward=s.r0,
        team_reward=torch.stack([s.r0, s.r1], -1),
        done=s.done,
        info=info,
    )
    return new_state, out


# ---------------------------------------------------------------------------
# Gym-style wrapper (one env, host loop)
# ---------------------------------------------------------------------------


class FutbolEnv:
    """A stateful, Gym-convention wrapper over one env: the reference's
    class surface, as the JAX package's ``FutbolEnv`` gives it:
    ``reset() -> obs``, ``step(a) -> (obs, reward, done, info)``,
    ``render()``, ``action_space``, ``observation_space``. No auto-reset:
    after ``done`` the episode's clock runs on until ``reset()``.

    The env is a batch of one on ``device`` (the card unless ``"cpu"``);
    ``obs``, ``reward`` and ``info``'s values come back without the batch
    axis, ``done`` as a bool. Kick and kickoff noise are drawn from the
    env's own generator (:attr:`generator`, seeded by ``seed``). For
    throughput use :mod:`gym_futbol_tpu_torch.vector` or the kernels:
    one plain step here launches tens of thousands of small operations."""

    def __init__(self, params: EnvParams | None = None, seed: int = 0,
                 dtype=torch.float32, device: torch.device | str = "cuda"):
        from .spaces import Box, MultiDiscrete

        self.params = params or EnvParams()
        self.dtype = dtype
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._state: EnvState | None = None
        self.action_space = MultiDiscrete([[5, 5]] * self.params.n_players,
                                          device=self.device)
        self.observation_space = Box(-float("inf"), float("inf"),
                                     shape=(obs_size(self.params),), dtype=dtype,
                                     device=self.device)

    def seed(self, seed: int) -> None:
        self.generator.manual_seed(seed)

    def reset(self) -> torch.Tensor:
        self._state, obs = reset(self.generator, self.params, 1, self.device,
                                 self.dtype)
        return obs[0]

    def step(self, actions):
        """``actions``: ``[n_players, 2]`` ints (direction, act) per player.
        Returns (obs ``[obs_dim]``, reward (team 0's, 0-dim), done, info)."""
        if self._state is None:
            raise RuntimeError("call reset() before step()")
        a = torch.as_tensor(actions, dtype=torch.int32, device=self.device
                            ).reshape(1, self.params.n_players, 2)
        theta, noise = sample_step_noise(self.generator, self.params, 1,
                                         self.device, self.dtype)
        self._state, out = step(self._state, a, theta, noise, self.params)
        return (out.obs[0], out.reward[0], bool(out.done[0]),
                {k: v[0] for k, v in out.info.items()})

    @property
    def state(self) -> EnvState | None:
        """The env's state without the batch axis (``pos`` ``[n_bodies,
        2]``, ``possession`` and ``t`` 0-dim, ``score`` ``[2]``), or None
        before ``reset()``."""
        if self._state is None:
            return None
        s = self._state
        return EnvState(pos=s.pos[0], vel=s.vel[0], possession=s.possession[0],
                        score=s.score[0], t=s.t[0])

    def render(self, mode: str = "rgb_array"):
        from .render import render_state

        return render_state(self.state, self.params, mode=mode)
