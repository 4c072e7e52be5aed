"""The port's physics step against the JAX package's, float32.

Game-like random states (many circle and wall contacts active) and
forces come from numpy and go to both
``gym_futbol_tpu.physics.physics_step`` (vmapped) and its port.

The two are not bitwise equal: XLA on the CPU contracts ``a*b + c``
into fused multiply-adds (about a quarter of such f32 results differ
in the last bit from separately rounded ones) and its ``rsqrt`` is not
IEEE ``1/sqrt``; the port rounds every operation, as the CUDA kernel
does. The sequential solver spreads those last-bit differences over
every body in contact, about 5e-4 at most in velocities of scale 150
to 500 (16 seeds measured). Positions are held to rtol 1e-5 / atol
1e-4, velocities to rtol 1e-5 / atol 2e-3 (64 f32 ulps at the 500 speed
clamp). The float64 port is held to 1e-9 against the C++ oracle in
``test_torch_oracle.py``.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from gym_futbol_tpu import EnvParams as JEnvParams  # noqa: E402
from gym_futbol_tpu.physics import physics_step as jax_physics_step  # noqa: E402
from gym_futbol_tpu_torch.interop import params_from_reference  # noqa: E402
from gym_futbol_tpu_torch.physics import physics_step  # noqa: E402

from _torch_cases import random_bodies, random_forces  # noqa: E402

B = 64


@pytest.mark.parametrize("ppt", [1, 2, 5])
def test_physics_step_matches_jax(ppt):
    ref = JEnvParams(players_per_team=ppt)
    params = params_from_reference(ref)
    rng = np.random.default_rng(100 + ppt)
    pos, vel = random_bodies(rng, params, B)
    forces = random_forces(rng, params, B)

    jpos, jvel = jax.vmap(lambda p, v, f: jax_physics_step(p, v, f, ref))(
        pos, vel, forces)
    tpos, tvel = physics_step(torch.from_numpy(pos), torch.from_numpy(vel),
                              torch.from_numpy(forces), params)

    assert tpos.dtype == torch.float32 and tpos.shape == pos.shape
    np.testing.assert_allclose(tpos.numpy(), np.asarray(jpos),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tvel.numpy(), np.asarray(jvel),
                               rtol=1e-5, atol=2e-3)
    # the case exercises the solver: many pairs start in contact
    i, j = np.triu_indices(params.n_bodies, 1)
    gap = np.linalg.norm(pos[:, i] - pos[:, j], axis=-1) - 2 * params.player_radius
    assert (gap < 0).sum() >= B
