"""Drawing a FutbolEnv state: an RGB frame, ASCII art, episode videos.

Counterpart of :mod:`gym_futbol_tpu.render`, frame for frame: the same
matplotlib figure (pixel-equal on the same positions) when matplotlib
imports, else ASCII art. Which of the two draws is a choice of host-side
drawing library, not of device: the state is copied to the host once per
frame and the env's work stays where it ran.
"""

from __future__ import annotations

import numpy as np
import torch

from .types import EnvParams, EnvState


def _host(state: EnvState):
    """(pos ``[n_bodies, 2]`` float numpy, score ``[2]``, t) of a single
    env's state on the host."""
    return (state.pos.detach().cpu().numpy(), state.score.cpu().numpy(),
            int(state.t))


def render_state(state: EnvState, params: EnvParams, mode: str = "rgb_array"):
    """Draw one env's state (``FutbolEnv.state``: no batch axis).

    mode="rgb_array" -> an HxWx3 uint8 numpy array (matplotlib; ASCII art
                        when it does not import).
    mode="ansi"      -> ASCII art, a string.
    mode="human"     -> prints the ASCII frame and returns None (gym's
                        convention, headless).
    """
    if mode == "human":
        print(_ascii(state, params))
        return None
    if mode == "ansi":
        return _ascii(state, params)
    try:
        return _mpl_rgb(state, params)
    except ImportError:
        return _ascii(state, params)


def _mpl_rgb(state: EnvState, params: EnvParams) -> np.ndarray:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Circle, Rectangle

    pos, sc, t = _host(state)
    w, h = params.width, params.height
    fig, ax = plt.subplots(figsize=(6, 6 * h / w), dpi=100)
    ax.add_patch(Rectangle((0, 0), w, h, facecolor="#2e7d32", zorder=0))
    for x0 in (-8, w):                                    # goal mouths
        ax.add_patch(Rectangle((x0, params.goal_y_lo), 8, params.goal_size,
                               facecolor="white", alpha=0.6, zorder=1))
    ax.plot([w / 2, w / 2], [0, h], color="white", lw=1, zorder=1)

    ppt = params.players_per_team
    ax.add_patch(Circle(pos[0], params.ball_radius, color="white", zorder=3))
    for i in range(1, 1 + ppt):
        ax.add_patch(Circle(pos[i], params.player_radius, color="#1565c0", zorder=2))
    for i in range(1 + ppt, 1 + 2 * ppt):
        ax.add_patch(Circle(pos[i], params.player_radius, color="#c62828", zorder=2))

    ax.set_title(f"{int(sc[0])} : {int(sc[1])}   t={t}")
    ax.set_xlim(-10, w + 10)
    ax.set_ylim(-10, h + 10)
    ax.set_aspect("equal")
    ax.axis("off")
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[:, :, :3].copy()
    plt.close(fig)
    return buf


def render_episode(
    params: EnvParams,
    policy=None,
    seed: int = 0,
    n_steps: int | None = None,
    every: int = 1,
    device: torch.device | str = "cuda",
) -> list[np.ndarray]:
    """Play one episode of a :class:`~gym_futbol_tpu_torch.env.FutbolEnv`
    on ``device`` and draw every ``every``-th frame (the first included),
    stopping at ``done`` or after ``n_steps`` (default ``max_steps``).
    ``policy(generator, obs [1, obs_dim]) -> actions [1, n_players, 2]``,
    the batched policy convention (default uniform random), draws from
    the env's generator. Returns HxWx3 uint8 frames."""
    from .env import FutbolEnv
    from .vector import random_policy

    policy = policy or random_policy(params)
    n_steps = n_steps or params.max_steps
    env = FutbolEnv(params, seed=seed, device=device)
    obs = env.reset()
    frames = [render_state(env.state, params)]
    for i in range(n_steps):
        actions = policy(env.generator, obs[None])[0]
        obs, _, done, _ = env.step(actions)
        if (i + 1) % every == 0:
            frames.append(render_state(env.state, params))
        if done:
            break
    return frames


def save_video(frames: list[np.ndarray], path: str, fps: int = 20) -> str:
    """Write frames to an animated GIF (PIL). Returns the path."""
    from PIL import Image

    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=max(1, int(1000 / fps)), loop=0)
    return path


def _ascii(state: EnvState, params: EnvParams, cols: int = 60,
           rows: int = 20) -> str:
    grid = [["." for _ in range(cols)] for _ in range(rows)]
    pos, sc, t = _host(state)
    ppt = params.players_per_team

    def put(p, ch):
        c = int(np.clip(p[0] / params.width * (cols - 1), 0, cols - 1))
        r = int(np.clip((1 - p[1] / params.height) * (rows - 1), 0, rows - 1))
        grid[r][c] = ch

    for i in range(1, 1 + ppt):
        put(pos[i], "A")
    for i in range(1 + ppt, 1 + 2 * ppt):
        put(pos[i], "B")
    put(pos[0], "o")
    head = f"score {int(sc[0])}:{int(sc[1])} t={t}"
    return head + "\n" + "\n".join("".join(r) for r in grid)
