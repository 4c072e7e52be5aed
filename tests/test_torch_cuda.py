"""The CUDA kernel against its plain PyTorch version on the card.

Needs a CUDA device and nvcc; skips without a card (a hand-written
kernel has no CPU mode). Imports nothing of JAX, so it runs where only
PyTorch is installed, without this directory's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Replay, table and Philox modes at 2v2 (zero-noise and custom params)
and 5v5: pos/vel rtol 1e-4 / atol 1e-3, rewards rtol 1e-4 / atol 1e-4,
integer state exact (the kernel rounds every operation as the plain
version does, so on the card the two agree bitwise in practice).
"""

import importlib

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from gym_futbol_tpu_torch import EnvParams, RewardConfig, ops, vector  # noqa: E402

from _torch_cases import custom_params, random_actions  # noqa: E402

tfr = importlib.import_module("gym_futbol_tpu_torch.ops.fused_rollout")

CUSTOM = custom_params(EnvParams, RewardConfig)
B, T = 256, 9


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("params", [
    CUSTOM.replace(kick_noise=0.0, placement_noise=0.0), CUSTOM,
    EnvParams(players_per_team=5, max_steps=5),
], ids=["custom-zero-noise", "custom", "5v5"])
def test_kernel_matches_plain(cuda, params):
    gen = torch.Generator(device=cuda).manual_seed(2)
    state, _ = vector.reset_batch(gen, params, B, device=cuda)
    sf, si = ops.pack_state(state, params)
    acts = torch.from_numpy(
        random_actions(np.random.default_rng(1), params, (T, B))
        .reshape(T, B, -1).transpose(0, 2, 1).copy()).to(cuda)
    u = torch.rand((T, tfr.n_draws_per_step(params), B), generator=gen,
                   device=cuda)
    before = dict(ops.LAUNCHES)
    cases = [
        (ops.fused_rollout_replay(sf, si, acts, params),
         tfr.fused_rollout_reference(sf, si, params, actions=acts)),
        (ops.fused_rollout(sf, si, 0, params, T, uniforms=u),
         tfr.fused_rollout_reference(sf, si, params, uniforms=u)),
        (ops.fused_rollout(sf, si, 77, params, T),
         tfr.fused_rollout_reference(sf, si, params, T, seed=77)),
    ]
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_rollout"] == before["fused_rollout"] + 2
    assert ops.LAUNCHES["fused_rollout_replay"] == before["fused_rollout_replay"] + 1
    for (ksf, ksi, krew), (psf, psi, prew) in cases:
        assert ksf.device.type == "cuda" and krew.shape == (T, B)
        torch.testing.assert_close(ksf, psf, rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(krew, prew, rtol=1e-4, atol=1e-4)
        assert torch.equal(ksi, psi)


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda):
    params = EnvParams()
    gen = torch.Generator(device=cuda).manual_seed(0)
    state, _ = vector.reset_batch(gen, params, 64, device=cuda)
    sf, si = ops.pack_state(state, params)
    with pytest.raises(ValueError):
        ops.fused_rollout(sf[:, ::2], si[:, ::2], 0, params, 2)  # strided
    p6 = params.replace(players_per_team=6)   # the kernel stops at 5v5
    state6, _ = vector.reset_batch(gen, p6, 64, device=cuda)
    with pytest.raises(ValueError):
        ops.fused_rollout(*ops.pack_state(state6, p6), 0, p6, 2)
