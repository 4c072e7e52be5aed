"""K6 (``ops.fused_bptt``), the recurrent PPO update's LSTM recurrence,
through its plain PyTorch version on the host: against the benchmark's
plain reference (``futbench/reference/recurrent.py``) in its ``"f32"``
mode, whose result K6 is held to (``unroll`` with episodes ending inside
the window at stable-baselines' ``MlpLstmPolicy`` widths,
``recurrent_ppo_loss`` and its per-leaf gradients, one
``update_epochs_recurrent`` call at 1v1 and 3v3), its backward against
autograd through the same forward, the split products, the weight and
operand packing and the saved state's fragment order as the kernels
read them, the routes ``compute_dtype`` picks and the shapes the kernels
refuse; the LayerNorm node's backward tail: its plan, and its plain
version bitwise the three ``native_layer_norm_backward`` calls and the
split it stands for.

Tolerances, with their reasons. K6's products take each operand as two
bf16 terms and leave out the product of the two low terms
(:func:`fb.split_mm`): about 2^-16 relative, where the reference's own
bf16 mode is 2^-8 off. Each bound below sits about ten times above K6's
reading here and ten times or more under the bf16 mode's, so that a
route that lost a term would fail it:

* the unroll: logits, values and carries within 2e-5 (K6 2.4e-6, bf16
  2.2e-3; all of order 1);
* the loss: rel 1e-5 (K6 1.5e-7; bf16 2.3e-5 to 2.3e-4);
* the gradients: per leaf, the norm of the difference within 5e-5 of
  the reference's norm (K6 4.5e-6, bf16 4.5e-3 to 5.1e-3);
* after Adam's steps, per leaf: the difference of the two changes within
  5e-4 of the reference change's norm (K6 3.7e-5, bf16 0.025 to 0.039;
  Adam divides each entry by its own running size, so a small gradient's
  rounding moves its entry by up to ``lr``);
* the backward against autograd through the float32 forward: 5e-5
  relative;
* :func:`fb.split_mm` against float64: 2^-14 relative, a single bf16
  product over 2^-9;
* the grouped log-probs the recurrent loss takes against the row form:
  1e-5 (Z and the sums reduced in another order).
"""

import pytest
import torch

torch.set_num_threads(1)

from futbench.reference import ppo as ref_ppo  # noqa: E402
from futbench.reference import recurrent as ref_rec  # noqa: E402
from gym_futbol_tpu_torch import EnvParams, obs_size, ppo  # noqa: E402
from gym_futbol_tpu_torch import recurrent_ppo as rppo  # noqa: E402
from gym_futbol_tpu_torch.models.recurrent import RecurrentActorCritic  # noqa: E402
from gym_futbol_tpu_torch.ops import fused_bptt as fb  # noqa: E402
from gym_futbol_tpu_torch.ops._policy import recurrent_gate_order  # noqa: E402

BF16 = torch.bfloat16


def leaves(model: RecurrentActorCritic, grads: bool = False) -> list:
    """The model's parameters (or their ``.grad``) as the reference's
    leaves: ``W`` ``[in, out]``."""
    out = []
    for p in model.parameters():
        x = (p.grad if grads else p).detach()
        out.append((x.T if x.dim() == 2 else x).clone())
    return out


def model_with_biases(ppt, hidden, hs, seed):
    """A seeded model whose biases are non-zero (flax zeroes them)."""
    gen = torch.Generator().manual_seed(seed)
    model = RecurrentActorCritic(ppt, obs_size(EnvParams(players_per_team=ppt)), hidden,
                                 hs, generator=gen, device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.1, generator=gen)
    return model, gen


def _window(ppt, hs, t, s, gen):
    """A recurrent window of ``s`` sequences: the fields the loss reads,
    as the program holds them and as the reference's ``seq``."""
    g = 2 * ppt
    f = obs_size(EnvParams(players_per_team=ppt))
    idx = torch.randint(0, 5, (t, s, g), generator=gen)
    dirs = sum(idx[..., 2 * q] << (3 * q) for q in range(ppt)).int()
    acts = sum(idx[..., 2 * q + 1] << (3 * q) for q in range(ppt)).int()
    traj = ppo.Transition(
        obs=torch.randn(t, s, f, generator=gen), dirs=dirs, acts=acts,
        logp=-torch.rand(t, s, generator=gen) * 6 - 2,
        value=torch.randn(t, s, generator=gen), reward=torch.randn(t, s, generator=gen),
        done=torch.rand(t, s, generator=gen) < 0.2)
    adv, ret = torch.randn(t, s, generator=gen), torch.randn(t, s, generator=gen)
    c0, h0 = (torch.randn(s, hs, generator=gen) * 0.5 for _ in range(2))
    seq = dict(obs=traj.obs, done=traj.done, idx=idx, logp=traj.logp, value=traj.value,
               adv=adv, ret=ret, c0=c0, h0=h0)
    return traj, adv, ret, (c0, h0), seq


def rel(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


@pytest.mark.parametrize("seed", [0, 1])
def test_unroll_bf16_matches_reference(seed):
    """3v3, torso (64, 64), H = 256, 5 sequences over 9 steps from
    non-zero carries, episodes ending inside the window: logits, values
    and the carry after the window on the bf16 route (K6) against the
    reference's float32 unroll."""
    model, gen = model_with_biases(3, (64, 64), 256, seed)
    t, s = 9, 5
    obs = torch.randn(t, s, model.obs_dim, generator=gen)
    done = torch.rand(t, s, generator=gen) < 0.25
    done[2, 0] = done[5, 3] = True
    c0, h0 = (torch.randn(s, 256, generator=gen) * 0.5 for _ in range(2))
    with torch.no_grad():
        carry, (logits, value) = model.unroll((c0, h0), obs, done, compute_dtype=BF16)
        ref_logits, ref_value = ref_rec.unroll(leaves(model), obs, done, c0, h0, "f32")
    torch.testing.assert_close(logits, ref_logits, rtol=0, atol=2e-5)
    torch.testing.assert_close(value, ref_value, rtol=0, atol=2e-5)
    c, h, w = c0, h0, leaves(model)
    for k in range(t):
        c, h = ref_rec.cell(w, ref_rec.torso(w, obs[k], "f32"), c, h, "f32")
        keep = (~done[k]).float()[:, None]
        c, h = c * keep, h * keep
    torch.testing.assert_close(carry[0], c, rtol=0, atol=2e-5)
    torch.testing.assert_close(carry[1], h, rtol=0, atol=2e-5)
    assert not torch.equal(logits, model.unroll((c0, h0), obs, done)[1][0])


@pytest.mark.parametrize("ppt", [1, 3])
def test_loss_and_grads_bf16_match_reference(ppt):
    """One minibatch of whole sequences, T = 6, H = 12: the loss and each
    leaf's gradient on K6's plain version against the reference's
    float32 loss."""
    model, gen = model_with_biases(ppt, (16,), 12, ppt)
    cfg = rppo.RecurrentPPOConfig(rollout_steps=6)
    traj, adv, ret, carry, seq = _window(ppt, 12, 6, 24, gen)
    loss, _ = rppo.recurrent_ppo_loss(model, traj, carry, adv, ret, cfg,
                                      compute_dtype=BF16)
    loss.backward()
    w = [x.requires_grad_(True) for x in leaves(model)]
    ref = ref_rec.ppo_loss(w, seq, vars(cfg), "f32")
    grads = torch.autograd.grad(ref, w)
    assert loss.item() == pytest.approx(ref.item(), rel=1e-5)
    for got, want in zip(leaves(model, grads=True), grads, strict=True):
        assert rel(got, want) <= 5e-5


@pytest.mark.parametrize("ppt", [1, 3])
def test_update_epochs_bf16_match_reference(ppt):
    """One ``update_epochs_recurrent`` call on its default route (bf16:
    K6), 2 epochs x 2 minibatches of blocks of 8 sequences on given
    permutations, T = 6, H = 12, against the reference's float32 update:
    the mean loss, and each leaf's change."""
    model, gen = model_with_biases(ppt, (16,), 12, 10 + ppt)
    cfg = rppo.RecurrentPPOConfig(rollout_steps=6, epochs=2, minibatches=2,
                                  shuffle_block=8, lr=2.5e-4)
    traj, adv, ret, carry, seq = _window(ppt, 12, 6, 32, gen)
    perms = torch.stack([torch.randperm(4, generator=gen) for _ in range(2)])
    w0 = leaves(model)
    opt = rppo.make_optimizer(model, cfg)
    metrics = rppo.update_epochs_recurrent(model, opt, traj, carry, adv, ret, gen, cfg,
                                           perms=perms)
    w = [x.clone() for x in w0]
    ref_loss = ref_rec.update(w, ref_ppo.Adam(w, cfg.lr, cfg.max_grad_norm), seq, perms,
                              vars(cfg), "f32")
    assert metrics["loss"].item() == pytest.approx(ref_loss, rel=1e-5)
    for got, want, start in zip(leaves(model), w, w0, strict=True):
        d_got, d_want = got - start, want - start
        assert d_want.norm() > 0
        assert (d_got - d_want).norm() <= 5e-4 * d_want.norm()


def test_backward_matches_autograd():
    """K6's plain forward and backward against autograd through the
    float32 recurrence: ``t``'s and the three weights' gradients, 9
    steps, 7 sequences, H = 12, resets inside the window."""
    gen = torch.Generator().manual_seed(3)
    t_len, s, n_t, hs = 9, 7, 20, 12
    t = torch.randn(t_len, s, n_t, generator=gen).tanh().requires_grad_(True)
    w_i = (torch.randn(4 * hs, n_t, generator=gen) * 0.3).requires_grad_(True)
    w_h = (torch.randn(4 * hs, hs, generator=gen) * 0.3).requires_grad_(True)
    b_h = (torch.randn(4 * hs, generator=gen) * 0.1).requires_grad_(True)
    c0, h0 = (torch.randn(s, hs, generator=gen) * 0.5 for _ in range(2))
    done = torch.rand(t_len, s, generator=gen) < 0.3
    weight = torch.randn(t_len, s, hs, generator=gen)
    h_all, _ = fb.fused_lstm_bptt(t, w_i, w_h, b_h, (c0, h0), done)
    got = torch.autograd.grad((h_all * weight).sum(), (t, w_i, w_h, b_h))

    wc = torch.cat([w_i.t(), w_h.t()])
    c, h, hs_all = c0, h0, []
    for k in range(t_len):
        i, f, g, o = (torch.cat([t[k], h], 1) @ wc + b_h).chunk(4, 1)
        i, f, g, o = i.sigmoid(), f.sigmoid(), g.tanh(), o.sigmoid()
        c = f * c + i * g
        hs_all.append(o * c.tanh())
        keep = (~done[k]).float()[:, None]
        c, h = c * keep, hs_all[-1] * keep
    ref_h = torch.stack(hs_all)
    torch.testing.assert_close(h_all, ref_h, rtol=0, atol=1e-5)
    want = torch.autograd.grad((ref_h * weight).sum(), (t, w_i, w_h, b_h))
    for a, b in zip(got, want, strict=True):
        assert rel(a, b) <= 5e-5


def test_saved_state_and_carry():
    """The plain forward's outputs: h_{t-1} is the carry each step read
    (h0 first, zero after a reset), the gates unit-major, the carry
    after the window c and h of the last step times its keep."""
    gen = torch.Generator().manual_seed(4)
    t_len, s, n_t, hs = 5, 6, 16, 8
    t = torch.randn(t_len, s, n_t, generator=gen)
    w_i, w_h = torch.randn(4 * hs, n_t, generator=gen), torch.randn(4 * hs, hs, generator=gen)
    b_h = torch.randn(4 * hs, generator=gen)
    c0, h0 = torch.randn(s, hs, generator=gen), torch.randn(s, hs, generator=gen)
    done = torch.zeros(t_len, s, dtype=torch.uint8)
    done[1, 2] = done[4, 0] = 1
    gates, c_all, h_all, hprev, c, h = fb.bptt_forward_reference(
        t, w_i, w_h, b_h, c0, h0, done)
    assert gates.shape == (t_len, s, hs, 4) and hprev.dtype == torch.float32
    assert torch.equal(hprev[0], h0) and torch.equal(hprev[3], h_all[2])
    assert not hprev[2, 2].any() and hprev[2, 1].any()
    torch.testing.assert_close(h_all[1], gates[1, ..., 3] * fb._tanh(c_all[1]))
    assert torch.equal(c[0], torch.zeros(hs)) and torch.equal(c[1], c_all[-1, 1])
    assert torch.equal(h[1], h_all[-1, 1])


def _unpack(frag, kp, np_):
    """The inverse of ``ops._policy.tc_fragments``: ``[kp, np_]``."""
    return (frag.reshape(kp // 16, np_ // 16, 8, 4, 2, 2, 2).permute(0, 5, 3, 6, 1, 4, 2)
            .reshape(kp, np_).float())


def test_pack_fragments_read_back():
    """:func:`fb.bptt_pack`'s fragments as the kernels' lanes read them:
    the forward's B operand is ``[Wi; 0; Wh; 0]`` with K5's gate columns,
    the backward's Wh^T with unit-major rows and its columns paired by
    octet (chunk j: units 8 j .. and hp / 2 + 8 j ..), each as hi = bf16(w)
    and lo = bf16(w - hi); H = 20 (padded to 32), a torso 20 wide (padded
    to 32)."""
    gen = torch.Generator().manual_seed(5)
    hs, n_t, kt, hp = 20, 20, 32, 32
    w_i, w_h = torch.randn(4 * hs, n_t, generator=gen), torch.randn(4 * hs, hs, generator=gen)
    b_h = torch.randn(4 * hs, generator=gen)
    (f_hi, f_lo), bias, (b_hi, b_lo) = fb.bptt_pack(w_i, w_h, b_h, kt)

    def hi_lo(x):
        hi = x.to(BF16).float()
        return hi, (x - hi).to(BF16).float()

    order = recurrent_gate_order(hs)
    bh, bl = _unpack(f_hi, kt + hp, 4 * hp), _unpack(f_lo, kt + hp, 4 * hp)
    for n, col in enumerate(order.tolist()):
        if col < 0:
            assert not bh[:, n].any() and not bl[:, n].any() and bias[n] == 0
            continue
        for x, pair in ((bh, 0), (bl, 1)):
            assert torch.equal(x[:n_t, n], hi_lo(w_i[col])[pair])
            assert not x[n_t:kt, n].any() and not x[kt + hs:, n].any()
            assert torch.equal(x[kt:kt + hs, n], hi_lo(w_h[col])[pair])
        assert bias[n] == b_h[col]
    bbh, bbl = _unpack(b_hi, 4 * hp, hp), _unpack(b_lo, 4 * hp, hp)
    for n in range(hp):
        u = 8 * (n // 16) + n % 8 + (hp // 2 if n % 16 >= 8 else 0)
        if u >= hs:
            assert not bbh[:, n].any() and not bbl[:, n].any()
            continue
        for u2 in range(hs):
            for gate in range(4):
                w = w_h[gate * hs + u2, u]
                assert bbh[4 * u2 + gate, n] == hi_lo(w)[0]
                assert bbl[4 * u2 + gate, n] == hi_lo(w)[1]
        assert not bbh[4 * hs:, n].any()


def test_t_fragments_read_back():
    """:func:`fb.t_fragments` of t's two terms against the A-fragment
    index of mma.sync's m16n8k16 (lane 4 g + t: registers rows g, g + 8 x
    columns 2 t, 2 t + 1, then 2 t + 8, 2 t + 9), hi and lo summing to t
    within 2^-16; a ragged batch (70 sequences: two blocks) and a torso
    20 wide (kt 32)."""
    gen = torch.Generator().manual_seed(9)
    t_len, n_seq, n_t, kt = 2, 70, 20, 32
    t = torch.randn(t_len, n_seq, n_t, generator=gen)
    frag = fb.t_fragments(fb._split(t), kt)
    assert frag.shape == (t_len, 2, kt // 16, 4, 2, 8, 4, 2, 2, 2)
    flat = frag.reshape(t_len, 2, kt // 16, 4, 2, 32, 8).float()
    got = torch.zeros(t_len, 2, 128, kt)
    for blk in range(2):
        for kk in range(kt // 16):
            for m in range(4):
                for lane in range(32):
                    g, tq = lane // 4, lane % 4
                    for r, (dr, dc) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
                        for pair in range(2):
                            row, col = 64 * blk + 16 * m + g + dr, 16 * kk + 2 * tq + dc + pair
                            v = flat[:, blk, kk, m, :, lane, 2 * r + pair]
                            got[:, 0, row, col] = v[:, 0]
                            got[:, 1, row, col] = v[:, 1]
    hi, lo = got[:, 0], got[:, 1]
    assert torch.equal(hi[:, :n_seq, :n_t], t.to(BF16).float())
    assert not hi[:, n_seq:].any() and not hi[:, :, n_t:].any() and not lo[:, :, n_t:].any()
    torch.testing.assert_close(hi[:, :n_seq, :n_t] + lo[:, :n_seq, :n_t], t, rtol=2**-16,
                               atol=0)


def test_fragment_rows_inverts_the_kernels_order():
    """:func:`fb.fragment_rows` against the kernels' index of the saved
    state (``frag_at`` in ``csrc/fused_bptt_tc.cu``): entry (step, block,
    octet o, mh = 2 m + hh, lane = 4 g + t, jl) is row 64 block + 16 m +
    8 hh + g, unit 8 o + 2 t + jl; a ragged batch and padded units."""
    t_len, n_seq, hs = 2, 70, 12
    plan = fb.bptt_plan(16, hs, n_seq)
    nblk, n_oct = plan["blocks"], plan["hp"] // 8
    x = torch.empty((t_len, nblk, n_oct, 8, 32, 2, 3))
    for step in range(t_len):
        for blk in range(nblk):
            for o in range(n_oct):
                for mh in range(8):
                    for lane in range(32):
                        for jl in range(2):
                            row = 64 * blk + 16 * (mh // 2) + 8 * (mh % 2) + lane // 4
                            unit = 8 * o + 2 * (lane % 4) + jl
                            x[step, blk, o, mh, lane, jl] = torch.tensor(
                                [step, row, unit], dtype=torch.float32)
    y = fb.fragment_rows(x, n_seq, hs)
    assert y.shape == (t_len, n_seq, hs, 3)
    want = torch.stack(torch.meshgrid(torch.arange(t_len), torch.arange(n_seq),
                                      torch.arange(hs), indexing="ij"), -1).float()
    assert torch.equal(y, want)


def test_plan():
    """The cell's shape fits the shared memory of one block with room,
    whatever the torso's width; blocks of 64 sequences, the last ragged."""
    plan = fb.bptt_plan(64, 256, 8192)
    assert (plan["kt"], plan["hp"], plan["blocks"]) == (64, 256, 128)
    assert plan["smem_forward"] == 4 * 64 * 264 * 2 + 64 * 264 * 4 == 202752
    assert plan["smem_backward"] == 2 * 64 * 520 * 2 + 64 * 264 * 4 == 200704
    assert fb.bptt_plan(20, 12, 1000)["blocks"] == 16
    wide = fb.bptt_plan(1024, 256, 64)
    assert (wide["smem_forward"], wide["smem_backward"]) == (202752, 200704)


def test_ln_tail_plan():
    """LayerNorm's backward tail: 32, 64 or 128 threads a row by H, two
    units of the 4H columns and four of c' a thread covering every unit
    from H = 4 to 256; four blocks an SM, fewer where the rows run out;
    one partial row of 14 H floats a block."""
    plan = fb.ln_tail_plan(256, 8192 * 128)
    assert plan == {"threads_per_row": 128, "rows_per_block": 1, "blocks": 528,
                    "sums": 3584}
    assert fb.ln_tail_plan(100, 999) == {"threads_per_row": 64, "rows_per_block": 2,
                                         "blocks": 500, "sums": 1400}
    assert fb.ln_tail_plan(64, 5)["blocks"] == 2
    for hs in range(4, 257, 4):
        p = fb.ln_tail_plan(hs, 1000)
        tpr = p["threads_per_row"]
        assert 2 * tpr >= hs and (tpr == 32 or tpr < hs) and tpr * p["rows_per_block"] == 128


@pytest.mark.parametrize("fault", ["x-rows", "c-layout", "stats-dtype", "strided"])
def test_ln_tail_kernel_refuses_bad_inputs(fault):
    """The tail kernel's wrapper checks every tensor against the node's
    saved shapes, dtype and layout before any pointer reaches the kernel:
    each fault raises, and nothing is launched."""
    from gym_futbol_tpu_torch import ops

    t_len, n_seq, hs = 2, 70, 12
    n, hp = t_len * n_seq, 16
    ins = dict(dpre=torch.zeros(t_len, n_seq, hs, 4), x=torch.zeros(n, 4 * hs),
               mux=torch.zeros(n, 1), rx=torch.ones(n, 1), gxu=torch.ones(4 * hs),
               y=torch.zeros(t_len, n_seq, hs, 4), st_h=torch.zeros(t_len, n_seq, 2),
               dn=torch.zeros(t_len, n_seq, hs),
               c_all=torch.zeros(t_len, 2, hp // 8, 8, 32, 2),
               st_c=torch.zeros(t_len, n_seq, 2))
    if fault == "x-rows":
        ins["x"] = torch.zeros(n + 1, 4 * hs)
    elif fault == "c-layout":
        ins["c_all"] = torch.zeros(t_len, n_seq, hs)
    elif fault == "stats-dtype":
        ins["st_h"] = ins["st_h"].double()
    else:
        ins["y"] = torch.zeros(t_len, hs, n_seq, 4).transpose(1, 2)
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="the tail's"):
        fb._ln_tail_kernel(*ins.values())
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("hs", [256, 100], ids=["H256", "padded-H100"])
def test_ln_tail_reference_is_the_three_calls(hs):
    """:func:`fb.ln_tail_reference`, the node's CPU route, gives exactly
    what the node computed before it: three ``native_layer_norm_backward``
    calls (t Wi's input, gain and bias gradients; h Wh's gain and bias;
    c''s gain and bias) and dx split in two bf16 terms; its one db is each
    of the first two calls' bias gradients, bitwise."""
    gen = torch.Generator().manual_seed(hs)
    n, g4 = 3 * 37, 4 * hs

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen) * scale + shift

    dpre, x, y = randn(n, g4, scale=1e-2), randn(n, g4, scale=0.7), randn(n, g4, shift=0.2)
    dn, c_rows = randn(n, hs, scale=1e-2), randn(n, hs, scale=0.5)
    gxu, bxu, ghu = randn(g4, scale=0.1, shift=1.0), randn(g4, scale=0.1), \
        randn(g4, scale=0.1, shift=1.0)
    gc, bc = randn(hs, scale=0.1, shift=1.0), randn(hs, scale=0.1)
    _, mux, rx = torch.native_layer_norm(x, [g4], gxu, bxu, 1e-5)
    st_h = torch.stack([y.mean(1), 1.0 / (y.var(1, unbiased=False) + 1e-5).sqrt()], 1)
    st_c = torch.stack([c_rows.mean(1), 1.0 / (c_rows.var(1, unbiased=False) + 1e-5).sqrt()], 1)
    ln_bwd = torch.ops.aten.native_layer_norm_backward
    dx, dgx, dbx = ln_bwd(dpre, x, [g4], mux, rx, gxu, bxu, [True, True, True])
    _, dgh, dbh = ln_bwd(dpre, y, [g4], st_h[:, :1].contiguous(), st_h[:, 1:].contiguous(),
                         ghu, bxu, [False, True, True])
    _, dgc, dbc = ln_bwd(dn, c_rows, [hs], st_c[:, :1].contiguous(),
                         st_c[:, 1:].contiguous(), gc, bc, [False, True, True])
    hi = dx.to(torch.bfloat16)
    lo = (dx - hi).to(torch.bfloat16)
    got = fb.ln_tail_reference(dpre, x, mux, rx, gxu, bxu, y, st_h, ghu, dn, c_rows, st_c,
                               gc, bc)
    assert torch.equal(got[0][0], hi) and torch.equal(got[0][1], lo)
    for a, b in zip(got[1:], (dgx, dbx, dgh, dgc, dbc)):
        assert torch.equal(a, b)
    assert torch.equal(got[2], dbh)


@pytest.mark.parametrize("hs", [6, 260, 0])
def test_refused_shapes_name_the_float32_route(hs):
    """H not a multiple of 4, or 4H over 1024, raises naming the float32
    route; so does the model's bf16 unroll."""
    with pytest.raises(ValueError, match=r"compute_dtype=torch\.float32"):
        fb.check_bptt_shape(hs)
    if hs:
        model = RecurrentActorCritic(1, obs_size(EnvParams(players_per_team=1)), (8,), hs,
                                     device="cpu")
        obs = torch.zeros(2, 3, model.obs_dim)
        carry = model.initial_carry(3)
        with pytest.raises(ValueError, match=r"compute_dtype=torch\.float32"):
            model.unroll(carry, obs, torch.zeros(2, 3, dtype=torch.bool),
                         compute_dtype=BF16)


def test_input_checks():
    """Shapes, dtypes and devices the wrapper refuses."""
    t = torch.zeros(3, 4, 8)
    w_i, w_h, b_h = torch.zeros(16, 8), torch.zeros(16, 4), torch.zeros(16)
    carry, done = (torch.zeros(4, 4), torch.zeros(4, 4)), torch.zeros(3, 4)
    fb.fused_lstm_bptt(t, w_i, w_h, b_h, carry, done)
    with pytest.raises(ValueError, match="w_i"):
        fb.fused_lstm_bptt(t, torch.zeros(16, 9), w_h, b_h, carry, done)
    with pytest.raises(ValueError, match="done"):
        fb.fused_lstm_bptt(t, w_i, w_h, b_h, carry, torch.zeros(3, 5))
    with pytest.raises(TypeError, match="float32"):
        fb.fused_lstm_bptt(t.double(), w_i, w_h, b_h, carry, done)


def test_routes():
    """``compute_dtype`` None and float32 are the same autograd loop,
    bitwise; bf16 differs from it, and counts no kernel launch on the
    CPU; other dtypes are refused by the unroll and the update."""
    from gym_futbol_tpu_torch import ops

    model, gen = model_with_biases(2, (16,), 8, 7)
    obs = torch.randn(4, 6, model.obs_dim, generator=gen)
    done = torch.rand(4, 6, generator=gen) < 0.3
    carry = tuple(torch.randn(6, 8, generator=gen) for _ in range(2))
    with torch.no_grad():
        base = model.unroll(carry, obs, done)
        f32 = model.unroll(carry, obs, done, compute_dtype=torch.float32)
        launches = ops.LAUNCHES["fused_lstm_bptt"]
        bf = model.unroll(carry, obs, done, compute_dtype=BF16)
    assert ops.LAUNCHES["fused_lstm_bptt"] == launches
    assert all(torch.equal(a, b) for a, b in zip(base[1], f32[1]))
    assert all(torch.equal(a, b) for a, b in zip(base[0], f32[0]))
    assert not torch.equal(base[1][0], bf[1][0])
    with pytest.raises(ValueError, match="compute_dtype"):
        model.unroll(carry, obs, done, compute_dtype=torch.float16)
    cfg = rppo.RecurrentPPOConfig(rollout_steps=4, shuffle_block=2, minibatches=3)
    traj, adv, ret, c, _ = _window(2, 8, 4, 6, gen)
    with pytest.raises(ValueError, match="compute_dtype"):
        rppo.update_epochs_recurrent(model, rppo.make_optimizer(model, cfg), traj, c, adv,
                                     ret, gen, cfg, compute_dtype=torch.float16)


def test_split_mm_near_float32():
    """:func:`fb.split_mm` against the float64 product: within 2^-14 of
    the largest entry, where one bf16 product of the same operands is
    over 2^-9 off; each operand's two terms sum to it within 2^-16."""
    gen = torch.Generator().manual_seed(10)
    a, b = torch.randn(64, 320, generator=gen), torch.randn(320, 96, generator=gen) * 0.1
    want = a.double() @ b.double()
    scale = want.abs().max().item()
    got = fb.split_mm(a, b)
    one = a.to(BF16).float() @ b.to(BF16).float()
    assert (got.double() - want).abs().max().item() <= 2 ** -14 * scale
    assert (one.double() - want).abs().max().item() > 2 ** -9 * scale
    for x in (a, b):
        hi, lo = fb._split(x)
        assert hi.dtype == lo.dtype == BF16
        torch.testing.assert_close(hi.float() + lo.float(), x, rtol=2**-16, atol=0)


@pytest.mark.parametrize("ppt", [1, 3])
def test_grouped_log_probs_match_row_form(ppt):
    """The recurrent loss's log-probs and entropies
    (``action_log_prob_and_entropy_grouped``) against the row form the
    collect and A2C take, values and gradients of the logits, with packed
    indices past the 5 choices (they take choice 0's): float32 rounding
    of Z's and the sums' other order apart, 1e-5."""
    from gym_futbol_tpu_torch.models.policy import (
        action_log_prob_and_entropy_grouped,
        action_log_prob_and_entropy_packed,
    )

    gen = torch.Generator().manual_seed(8)
    logits = (torch.randn(4, 7, 10 * ppt, generator=gen) * 3).requires_grad_(True)
    dirs = torch.randint(0, 2 ** (3 * ppt), (4, 7), generator=gen, dtype=torch.int32)
    acts = torch.randint(0, 2 ** (3 * ppt), (4, 7), generator=gen, dtype=torch.int32)
    assert ((dirs & 7) > 4).any()
    weights = torch.randn(2, 4, 7, generator=gen)
    got = action_log_prob_and_entropy_grouped(logits, dirs, acts)
    want = action_log_prob_and_entropy_packed(logits, dirs, acts)
    for a, b in zip(got, want, strict=True):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    g_got = torch.autograd.grad(sum((w * x).sum() for w, x in zip(weights, got)), logits)[0]
    g_want = torch.autograd.grad(sum((w * x).sum() for w, x in zip(weights, want)), logits)[0]
    torch.testing.assert_close(g_got, g_want, rtol=1e-5, atol=1e-5)
