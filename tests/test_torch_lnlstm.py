"""The port's layer-normalised LSTM (stable-baselines' ``MlpLnLstmPolicy``
cell, ``RecurrentActorCritic(..., layer_norm=True)``) against the
benchmark's plain reference ``futbench/reference/lnlstm.py`` (plain torch
in float32, which imports nothing of the port) on the host, on seeded
random weights with every LayerNorm leaf and bias moved off its start:
``unroll`` on both routes (float32 autograd, and K6's LayerNorm plain
versions behind ``compute_dtype=torch.bfloat16``), ``recurrent_ppo_loss``
and every leaf's gradient (the cell's nine among them), one
``update_epochs_recurrent`` call, and K5's LayerNorm plain version
teacher-forced; then the mechanism's edges: a zero carry, the gate
order, padded units, the plain cell unchanged, the refusals.

Tolerances, with their reasons (as ``test_torch_recurrent_reference.py``):

* float32 autograd route, unroll and loss: the port normalises with
  ``nn.LayerNorm`` and sums the cell's two normalised products apart, the
  reference with its own mean and variance: float32 rounding in another
  order, atol 2e-5 on logits, values and carries (order 1), rel 1e-5 on
  the loss, gradients rtol 1e-4 / atol 1e-6;
* K6's route: every product split into bf16 hi + lo terms (about 2^-16
  relative, ``ops.fused_bptt.split_mm``) and the statistics as ``E[y^2] -
  E[y]^2``: atol 1e-4 on the unroll, gradients within 1e-3 of each
  leaf's norm (rel L2);
* the parameters after Adam's steps: the norm of the difference of the
  two changes within 1e-3 of the reference change's norm (Adam divides
  each entry's gradient by its own running size);
* K5's plain version: the env bitwise, the float32 mode atol 2e-5, the
  bfloat16 mode 1e-2 with near ties allowed (2e-2), as the plain cell's
  test.
"""

import contextlib
import io
import json

import pytest
import torch

torch.set_num_threads(1)

from futbench.reference import env as ref_env  # noqa: E402
from futbench.reference import lnlstm as ref_ln  # noqa: E402
from futbench.reference import ppo as ref_ppo  # noqa: E402
from futbench.reference import recurrent as ref_rec  # noqa: E402
from gym_futbol_tpu_torch import EnvParams, a2c, obs_size, ppo  # noqa: E402
from gym_futbol_tpu_torch import recurrent_ppo as rppo  # noqa: E402
from gym_futbol_tpu_torch import train as ttrain  # noqa: E402
from gym_futbol_tpu_torch.models.recurrent import RecurrentActorCritic  # noqa: E402
from gym_futbol_tpu_torch.ops import fused_bptt as fb  # noqa: E402
from gym_futbol_tpu_torch.ops import fused_recurrent as tfr  # noqa: E402
from gym_futbol_tpu_torch.ops._policy import unit_major  # noqa: E402

from test_torch_recurrent_reference import _window, leaves  # noqa: E402


@pytest.fixture(autouse=True)
def host_sqrt():
    ref_env.exact_sqrt(False)
    yield
    ref_env.exact_sqrt(True)


def ln_model(ppt, hidden, hs, seed):
    """A seeded layer-normalised model whose biases are non-zero and whose
    LayerNorm gains and biases are moved off 1 and 0."""
    gen = torch.Generator().manual_seed(seed)
    model = RecurrentActorCritic(ppt, obs_size(EnvParams(players_per_team=ppt)), hidden,
                                 hs, generator=gen, device="cpu", layer_norm=True)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("ln_"):
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
            elif name.endswith("bias"):
                p.normal_(0.0, 0.1, generator=gen)
    return model, gen


def _unroll_case(hs, gen, obs_dim, t=9, s=5):
    obs = torch.randn(t, s, obs_dim, generator=gen)
    done = torch.rand(t, s, generator=gen) < 0.25
    done[2, 0] = done[5, 3] = True
    c0, h0 = (torch.randn(s, hs, generator=gen) * 0.5 for _ in range(2))
    c0[1] = h0[1] = 0.0                          # a zero carry
    return obs, done, c0, h0


@pytest.mark.parametrize("route,hs,atol", [
    (torch.float32, 256, 2e-5), (torch.bfloat16, 256, 1e-4), (torch.bfloat16, 12, 1e-4)],
    ids=["f32-H256", "k6-H256", "k6-H12"])
def test_unroll_matches_reference(route, hs, atol):
    """3v3, torso (64, 64), 5 sequences over 9 steps from non-zero (and
    one zero) carries, episodes ending inside the window; at
    ``MlpLnLstmPolicy``'s H = 256 and at H = 12 (the kernels pad it to
    16)."""
    model, gen = ln_model(3, (64, 64), hs, 0)
    obs, done, c0, h0 = _unroll_case(hs, gen, model.obs_dim)
    with torch.no_grad():
        carry, (logits, value) = model.unroll((c0, h0), obs, done, compute_dtype=route)
        ref_logits, ref_value = ref_ln.unroll(leaves(model), obs, done, c0, h0, "f32")
    torch.testing.assert_close(logits, ref_logits, rtol=0, atol=atol)
    torch.testing.assert_close(value, ref_value, rtol=0, atol=atol)
    c, h = c0, h0
    w = leaves(model)
    for k in range(obs.shape[0]):
        c, h = ref_ln.cell(w, ref_rec.torso(ref_ln.plain(w), obs[k], "f32"), c, h, "f32")
        keep = (~done[k]).float()[:, None]
        c, h = c * keep, h * keep
    torch.testing.assert_close(carry[0], c, rtol=0, atol=atol)
    torch.testing.assert_close(carry[1], h, rtol=0, atol=atol)


@pytest.mark.parametrize("route", [torch.float32, torch.bfloat16], ids=["f32", "k6"])
@pytest.mark.parametrize("ppt", [1, 3])
def test_loss_and_grads_match_reference(ppt, route):
    """One minibatch of whole sequences, T = 6, H = 12: the loss and every
    leaf's gradient, the six LayerNorm leaves and the three biases apart
    among them."""
    model, gen = ln_model(ppt, (16,), 12, ppt)
    cfg = rppo.RecurrentPPOConfig(rollout_steps=6)
    traj, adv, ret, carry, seq = _window(ppt, 12, 6, 24, gen)
    loss, _ = rppo.recurrent_ppo_loss(model, traj, carry, adv, ret, cfg,
                                      compute_dtype=route)
    loss.backward()
    w = [x.requires_grad_(True) for x in leaves(model)]
    ref = ref_ln.ppo_loss(w, seq, vars(cfg), "f32")
    grads = torch.autograd.grad(ref, w)
    names = [n for n, _ in model.named_parameters()]
    assert names[-6:] == ["ln_i.weight", "ln_i.bias", "ln_h.weight", "ln_h.bias",
                          "ln_c.weight", "ln_c.bias"]
    assert loss.item() == pytest.approx(ref.item(), rel=1e-5)
    for name, got, want in zip(names, leaves(model, grads=True), grads, strict=True):
        assert want.norm() > 0, name
        if route == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
        else:
            assert ((got - want).norm() / want.norm()).item() <= 1e-3, name


@pytest.mark.parametrize("route", [torch.float32, torch.bfloat16], ids=["f32", "k6"])
def test_update_epochs_match_reference(route):
    """One ``update_epochs_recurrent`` call at 3v3, 2 epochs x 2
    minibatches of blocks of 8 sequences on given permutations, T = 6,
    H = 12, from the optimiser's first step: the mean loss, and each
    leaf's change."""
    model, gen = ln_model(3, (16,), 12, 13)
    cfg = rppo.RecurrentPPOConfig(rollout_steps=6, epochs=2, minibatches=2,
                                  shuffle_block=8, lr=2.5e-4)
    traj, adv, ret, carry, seq = _window(3, 12, 6, 32, gen)
    perms = torch.stack([torch.randperm(4, generator=gen) for _ in range(2)])
    w0 = leaves(model)
    opt = rppo.make_optimizer(model, cfg)
    metrics = rppo.update_epochs_recurrent(model, opt, traj, carry, adv, ret, gen, cfg,
                                           perms=perms, compute_dtype=route)
    w = [x.clone() for x in w0]
    ref_loss = ref_ln.update(w, ref_ppo.Adam(w, cfg.lr, cfg.max_grad_norm), seq, perms,
                             vars(cfg), "f32")
    assert metrics["loss"].item() == pytest.approx(ref_loss, rel=1e-5)
    for got, want, start in zip(leaves(model), w, w0, strict=True):
        d_got, d_want = got - start, want - start
        assert d_want.norm() > 0
        assert (d_got - d_want).norm() <= 1e-3 * d_want.norm()


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_plain_k5_collect_teacher_forced(mode):
    """K5's LayerNorm plain version, 2v2, 24 envs, T = 10, torso (16,),
    H = 12, from non-zero carries (two envs' zero), on a uniforms table,
    episodes ending in the window; the reference replays it with the
    collect's own actions."""
    ppt, b, t_len, hs = 2, 24, 10, 12
    params = EnvParams(players_per_team=ppt, max_steps=7)
    p = ref_env.Params.from_config(ppt, {"max_steps": 7})
    model, gen = ln_model(ppt, (16,), hs, 3)
    sf, si = ref_env.initial_state(gen, p, b, "cpu")
    cc, hh = (torch.randn(2, hs, b, generator=gen) * 0.5 for _ in range(2))
    cc[:, :, :2] = hh[:, :, :2] = 0.0
    u = torch.rand((t_len, tfr.n_draws_per_step(params), b), generator=gen)
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[mode]
    (sf1, si1, obs, dirs, acts, logp, value, reward, done, last_v, c1,
     h1) = tfr.fused_recurrent_collect_reference(
        sf, si, tfr.flatten_recurrent_actor_critic(model), cc, hh, params,
        uniforms=u, compute_dtype=dtype, ln=tfr.layer_norm_leaves(model))
    assert done.any()
    w, g, f = leaves(model), 2 * ppt, obs_size(params)
    state = ref_env.state_from_packed(sf, si, p.n_bodies)
    cos_t, sin_t, nx, ny = ref_env.step_noise(u, p, 2 * g, "cpu")
    c, h = (x.permute(0, 2, 1).reshape(2 * b, hs) for x in (cc, hh))
    ties, tol = [], 1e-2 if mode == "bf16" else 2e-5
    for k in range(t_len):
        x = torch.cat([ref_env.observation(state, p, mirror=False),
                       ref_env.observation(state, p, mirror=True)], 1)
        assert torch.equal(x, torch.cat([obs[0, :f, k], obs[1, :f, k]], 1))
        logits, v, c, h = ref_ln.forward(w, x.T, c, h, mode)
        ia = ref_ppo.unpack(dirs[k].reshape(2 * b), acts[k].reshape(2 * b), g)
        lp, _ = ref_ppo.logp_entropy(logits, ia)
        torch.testing.assert_close(logp[k].reshape(2 * b), lp, rtol=0, atol=tol)
        torch.testing.assert_close(value[k].reshape(2 * b), v, rtol=0, atol=tol)
        uv = torch.cat([u[k, :g], u[k, g:2 * g]], 1).T
        idx, cdf = ref_ppo.sample(logits, uv)
        ties.append(ref_ppo.tie_distance(idx, ia, cdf, uv).max().item())
        dd = [ia[:b, 2 * q].int() for q in range(ppt)] + [
            ref_env.mirror_dir(ia[b:, 2 * q]).int() for q in range(ppt)]
        aa = [ia[:b, 2 * q + 1].int() for q in range(ppt)] + [
            ia[b:, 2 * q + 1].int() for q in range(ppt)]
        state, r0, r1, dn = ref_env.step(state, dd, aa, cos_t[k], sin_t[k], list(nx[k]),
                                         list(ny[k]), p)
        assert torch.equal(torch.stack([r0, r1]).float(), reward[k])
        assert torch.equal(torch.stack([dn, dn]).int(), done[k])
        keep = (1.0 - torch.cat([dn, dn]).float())[:, None]
        c, h = c * keep, h * keep
    end = ref_env.packed(state)
    assert torch.equal(end[0], sf1) and torch.equal(end[1], si1)
    assert max(ties) <= (2e-2 if mode == "bf16" else 1e-4)
    x = torch.cat([ref_env.observation(state, p, mirror=False),
                   ref_env.observation(state, p, mirror=True)], 1)
    torch.testing.assert_close(last_v.reshape(2 * b), ref_ln.forward(w, x.T, c, h, mode)[1],
                               rtol=0, atol=tol)
    torch.testing.assert_close(c1.permute(0, 2, 1).reshape(2 * b, hs), c, rtol=0, atol=tol)
    torch.testing.assert_close(h1.permute(0, 2, 1).reshape(2 * b, hs), h, rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# The mechanism's edges
# ---------------------------------------------------------------------------


def test_zero_carry_gives_bh_exactly():
    """At an episode's start h Wh is a zero row: its LayerNorm is exactly
    ``bh`` (mean 0, variance 0, 1 / sqrt(1e-5) times 0), finite, with no
    amplified rounding, on every route: the model's ``nn.LayerNorm``,
    K6's plain forward (y, its statistics, the pre-activations) and K5's
    plain version (:func:`ops.fused_recurrent._ln_rows`)."""
    model, gen = ln_model(2, (16,), 12, 21)
    z = torch.zeros(3, 12)
    out = model.ln_h(torch.nn.functional.linear(z, model.cell_h.weight))
    assert torch.equal(out, model.ln_h.bias.detach().expand(3, -1))
    zrows = tfr._ln_rows(torch.zeros(48, 5), model.ln_h.weight.detach(),
                         model.ln_h.bias.detach())
    assert torch.equal(zrows, model.ln_h.bias.detach()[:, None].expand(-1, 5))
    hs, s = 12, 4
    a = torch.randn(2, s, hs, 4, generator=gen)
    ghu, bhu = (unit_major(v.detach()).reshape(hs, 4) for v in (model.ln_h.weight,
                                                           model.ln_h.bias))
    gc, bc = model.ln_c.weight.detach(), model.ln_c.bias.detach()
    zero = torch.zeros(s, hs)
    gates, c_all, h_all, hprev, y, st_h, st_c, _, _ = fb.bptt_ln_forward_reference(
        a, model.cell_h.weight, ghu, bhu, gc, bc, zero, zero, torch.zeros(2, s))
    assert torch.equal(y[0], torch.zeros(s, hs, 4)) and torch.equal(st_h[0, :, 0],
                                                                     torch.zeros(s))
    pre = a[0] + bhu
    want = torch.stack([fb.sigmoid(pre[..., 0]), fb.sigmoid(pre[..., 1]),
                        fb._tanh(pre[..., 2]), fb.sigmoid(pre[..., 3])], -1)
    assert torch.equal(gates[0], want)
    assert all(torch.isfinite(x).all() for x in (gates, c_all, h_all, y, st_h, st_c))


def _sb_lstm_step(t, h, c, wx, wh, b, gx, bx, gh, bh, gc, bc):
    """stable-baselines' ``tf_layers.lstm(..., layer_norm=True)`` step, its
    own gate order (i, f, o, u) and its ``_ln``."""
    def ln(y, g, bb):
        mu = y.mean(1, keepdim=True)
        var = ((y - mu) ** 2).mean(1, keepdim=True)
        return (y - mu) / torch.sqrt(var + 1e-5) * g + bb

    z = ln(t @ wx, gx, bx) + ln(h @ wh, gh, bh) + b
    i, f, o, u = z.chunk(4, 1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(u)
    return c, torch.sigmoid(o) * torch.tanh(ln(c, gc, bc))


def test_gate_order_against_stable_baselines():
    """The port's (i, f, g, o) cell with ``Wi``, ``Wh``, ``b``, ``gx``,
    ``bx``, ``gh``, ``bh`` permuted from stable-baselines' (i, f, o, g)
    order is stable-baselines' step: LayerNorm over the whole row does not
    see the columns' order."""
    model, gen = ln_model(2, (16,), 12, 5)
    hs = 12
    t = torch.randn(7, 16, generator=gen)
    c, h = (torch.randn(7, hs, generator=gen) for _ in range(2))
    # stable-baselines' blocks i, f, o, u -> the port's i, f, g(=u), o
    sb_to_port = torch.cat([torch.arange(hs) + k * hs for k in (0, 1, 3, 2)])
    port_to_sb = torch.argsort(sb_to_port)
    sb = [v.detach()[..., port_to_sb] for v in (
        model.cell_i.weight.T, model.cell_h.weight.T, model.cell_h.bias,
        model.ln_i.weight, model.ln_i.bias, model.ln_h.weight, model.ln_h.bias)]
    want = _sb_lstm_step(t, h, c, *sb, model.ln_c.weight.detach(), model.ln_c.bias.detach())
    with torch.no_grad():
        got = model._cell(model._input_side(t), c, h)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-6)


@pytest.mark.parametrize("hs", [12, 100])
def test_padded_units_out_of_the_statistics(hs):
    """H not a multiple of 16: the kernels' LayerNorm vectors are zero at a
    padded unit's gate columns and past H (K5's f32 vector, K6's gate
    order), the padded columns of the products are zero, and statistics
    summed over the padded row and counted over the real 4H (or H) are
    the plain versions' over the real row."""
    model, gen = ln_model(3, (64, 64), hs, 8)
    hp = -(-hs // 16) * 16
    params = EnvParams(players_per_team=3)
    w, ln = tfr.flatten_recurrent_actor_critic(model), tfr.layer_norm_leaves(model)
    _, fv, _, wv_off = tfr.recurrent_tc_pack(w, params, ln)
    off = wv_off + hp + 2
    order = tfr.recurrent_gate_order(hs)
    pad = order < 0
    vecs = fv[off:off + 16 * hp].reshape(4, 4 * hp)
    for k in range(4):
        assert (vecs[k][pad] == 0).all()
        assert torch.equal(vecs[k][~pad], ln[k][order[~pad]])
    gc_bc = fv[off + 16 * hp:off + 18 * hp].reshape(2, hp)
    assert torch.equal(gc_bc[:, :hs], torch.stack(ln[4:])) and (gc_bc[:, hs:] == 0).all()
    assert fv.numel() == off + 18 * hp
    assert (fb._gate_cols(ln[2], hs)[pad] == 0).all()
    y = torch.randn(4 * hs, 6, generator=gen)
    padded = torch.zeros(4 * hp, 6)
    padded[~pad] = y[order[~pad]]
    mu, r = padded.sum(0) / (4 * hs), None
    var = ((padded * padded).sum(0) / (4 * hs) - mu * mu).clamp_min(0.0)
    r = 1.0 / torch.sqrt(var + 1e-5)
    want = tfr._ln_rows(y, torch.ones(4 * hs), torch.zeros(4 * hs))
    torch.testing.assert_close((y - mu) * r, want, rtol=0, atol=1e-6)


def test_plain_cell_unchanged():
    """``layer_norm=False`` is the plain cell: the same leaves in the same
    order drawn from the generator as before LayerNorm existed (the
    first draws of a fresh generator), no LayerNorm module, and its
    forward and unroll bitwise the plain formula ``lstm_cell(cell_h(h) +
    cell_i(t))``."""
    from gym_futbol_tpu_torch.models.recurrent import lstm_cell

    gen = torch.Generator().manual_seed(4)
    model = RecurrentActorCritic(2, obs_size(EnvParams(players_per_team=2)), (16,), 12,
                                 generator=gen, device="cpu")
    assert [n for n, _ in model.named_parameters()] == [
        "torso.0.weight", "torso.0.bias", "cell_i.weight", "cell_h.weight", "cell_h.bias",
        "logits.weight", "logits.bias", "value.weight", "value.bias"]
    assert model.layer_norms() == () and tfr.layer_norm_leaves(model) is None
    twin = RecurrentActorCritic(2, model.obs_dim, (16,), 12,
                                generator=torch.Generator().manual_seed(4), device="cpu",
                                layer_norm=True)
    for a, b in zip(model.parameters(), twin.parameters()):   # LayerNorm draws nothing
        assert torch.equal(a, b)
    obs = torch.randn(5, 6, model.obs_dim, generator=gen)
    done = torch.rand(5, 6, generator=gen) < 0.3
    c, h = (torch.randn(6, 12, generator=gen) for _ in range(2))
    with torch.no_grad():
        (c1, h1), (lg, v) = model((c, h), obs[0])
        cw, hw = lstm_cell(model.cell_h(h) + model.cell_i(model._torso(obs[0])), c)
        assert torch.equal(c1, cw) and torch.equal(h1, hw)
        carry, (lg, v) = model.unroll((c, h), obs, done)
        hs_ = []
        for k in range(5):
            c, h = lstm_cell(model.cell_h(h) + model.cell_i(model._torso(obs[k])), c)
            hs_.append(h)
            keep = (1.0 - done[k].float())[:, None]
            c, h = c * keep, h * keep
        assert torch.equal(lg, model.logits(torch.stack(hs_)))
        assert torch.equal(carry[0], c) and torch.equal(carry[1], h)


def test_refusals_name_the_route():
    """K6's LayerNorm route refuses an LSTM size it does not take, naming
    the float32 route; K5's float32 route refuses LayerNorm, naming the
    bfloat16 one; recurrent A2C refuses the layer-normalised model, naming
    its float32 collect."""
    model, gen = ln_model(2, (16,), 6, 2)
    t = torch.randn(3, 4, 16, generator=gen)
    ln = [p for m in model.layer_norms() for p in (m.weight, m.bias)]
    with pytest.raises(ValueError, match=r"compute_dtype=torch\.float32"):
        fb.fused_lnlstm_bptt(t, model.cell_i.weight, model.cell_h.weight,
                             model.cell_h.bias, ln, (torch.zeros(4, 6),) * 2,
                             torch.zeros(3, 4, dtype=torch.bool))
    params = EnvParams(players_per_team=2)
    model8, gen = ln_model(2, (16,), 8, 2)
    p = ref_env.Params.from_config(2, {})
    sf, si = ref_env.initial_state(gen, p, 8, "cpu")
    cc = torch.zeros(2, 8, 8)
    with pytest.raises(ValueError, match=r"float32 route.*compute_dtype=torch\.bfloat16"):
        tfr.fused_recurrent_collect(sf, si, tfr.flatten_recurrent_actor_critic(model8), cc,
                                    cc, 0, params, 2, compute_dtype=torch.float32,
                                    ln=tfr.layer_norm_leaves(model8))
    cfg = a2c.A2CConfig(rollout_steps=2)
    runner = a2c.init_recurrent_runner(gen, model8, params, cfg, 8)
    with pytest.raises(ValueError, match="float32 route"):
        a2c.train_iteration_recurrent(runner, params, cfg)


def test_cli_lstm_layer_norm():
    """``--lstm-layer-norm`` with ``--recurrent`` trains the
    layer-normalised model by recurrent PPO (K5's and K6's plain
    versions on the host behind ``--fused-collect``); with ``--algo a2c``
    or without ``--recurrent`` it is refused, naming why."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runner = ttrain.main(["--device", "cpu", "--recurrent", "--lstm-layer-norm",
                              "--fused-collect", "--ppt", "2", "--iters", "1", "--envs",
                              "32", "--hidden", "16", "--lstm-size", "8", "--max-steps",
                              "20", "--rollout-steps", "4"])
    assert runner.model.layer_norm and len(runner.model.layer_norms()) == 3
    lines = [json.loads(s) for s in out.getvalue().splitlines()]
    assert lines[-1]["done"] is True and "loss" in lines[0]
    with pytest.raises(SystemExit, match="float32 route"):
        ttrain.main(["--device", "cpu", "--recurrent", "--lstm-layer-norm", "--algo",
                     "a2c"])
    with pytest.raises(SystemExit, match="--recurrent"):
        ttrain.main(["--device", "cpu", "--lstm-layer-norm"])


def test_layer_norm_leaves_train():
    """The six LayerNorm leaves reach the optimiser and move in one
    update, each of the three biases on its own."""
    model, gen = ln_model(3, (16,), 12, 9)
    cfg = rppo.RecurrentPPOConfig(rollout_steps=6, epochs=1, minibatches=1,
                                  shuffle_block=8)
    traj, adv, ret, carry, _ = _window(3, 12, 6, 8, gen)
    opt = rppo.make_optimizer(model, cfg)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    rppo.update_epochs_recurrent(model, opt, traj, carry, adv, ret, gen, cfg)
    for name, p in model.named_parameters():
        assert not torch.equal(before[name], p), name
    assert isinstance(traj, ppo.Transition)
