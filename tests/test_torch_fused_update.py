"""K3's tensor-core route without a card: the zero padding its kernels
rely on, through the plain version, and the wrapper's planning helper
(``ops.fused_update.update_plan``: route, padded sizes, W2's layout,
shared memory, grids, buffers) with its refusals.

Padding bounds: torso widths padded with zero units leave every
gradient, sliced back, within 1e-6 rel-L2 of the unpadded one (float32
and bfloat16: the pad units add exact zeros; only the matrix products'
summation order may change); a logits head padded with zero columns
gives the same logits and the same dh = Wl dlogits when dlogits gets
zero pad rows (1e-6).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

tfu = importlib.import_module("gym_futbol_tpu_torch.ops.fused_update")
_build = importlib.import_module("gym_futbol_tpu_torch.ops._build")

BLOCK = 128


def _case(ppt, hidden, n_blocks=3, idx=(2, 0), seed=0):
    """Flat actor-critic weights (nonzero biases) and one minibatch, made
    with numpy from a seed."""
    rng = np.random.default_rng(seed)
    f = 4 * (2 * ppt + 1) + 2
    f_pad = -(-f // 8) * 8
    dims = [f, *hidden]
    shapes = list(zip(dims[:-1], dims[1:])) + [(dims[-1], 10 * ppt),
                                               (dims[-1], 1)]
    w = []
    for a, b in shapes:
        w.append(torch.from_numpy(rng.normal(0, a ** -0.5, (a, b)).astype(np.float32)))
        w.append(torch.from_numpy(rng.normal(0, 0.1, (b, 1)).astype(np.float32)))
    n = n_blocks * BLOCK
    obs = np.zeros((f_pad, n), np.float32)
    obs[:f] = rng.normal(0, 1, (f, n))

    def packed():
        a = rng.integers(0, 5, (ppt, n_blocks, BLOCK))
        return torch.from_numpy(sum(a[q] << (3 * q) for q in range(ppt)).astype(np.int32))

    def rows(scale=1.0):
        return torch.from_numpy(rng.normal(0, scale, (n_blocks, BLOCK)).astype(np.float32))

    idx = torch.tensor(idx, dtype=torch.int32)
    adv = rows()[idx.long()]
    adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    args = (tuple(w), torch.from_numpy(obs), packed(), packed(),
            -rows().abs() * 2 * ppt, rows(), rows(), adv_n, idx)
    kw = dict(n_torso=len(hidden), clip_eps=0.2, vf_coef=0.5, ent_coef=0.01,
              block=BLOCK)
    return args, kw


def _rel(a, b):
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


@pytest.mark.parametrize("ppt,hidden", [(2, (32, 16)), (3, (256,)), (5, (40,))],
                         ids=["2v2-32-16", "3v3-256", "5v5-40"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_torso_padding_is_exact(ppt, hidden, dtype):
    """The plain version on torso widths padded as the tensor-core
    kernels pad them (padded_weights) gives the unpadded gradients."""
    args, kw = _case(ppt, hidden)
    w = args[0]
    n_torso = len(hidden)
    plan = tfu.update_plan(args[1].shape[0], hidden, w[-4].shape[1],
                           len(args[-1]) * BLOCK)
    assert plan["route"] == "tensor_cores"
    pw = tfu.padded_weights(w, n_torso, plan)
    wp = [pw["w1"][:w[0].shape[0]], pw["b1"][:, None]]
    if n_torso == 2:
        wp += [pw["w2"], pw["b2"][:, None]]
    # the logits head keeps its G*5 columns: only its rows (the last
    # torso width) are padded here
    g5 = w[-4].shape[1]
    wp += [pw["wl"][:, :g5], pw["bl"][:g5, None], pw["wv"][:, None],
           pw["bv"][:, None]]
    want, want_m = tfu.fused_minibatch_grad_reference(*args, **kw, compute_dtype=dtype)
    got, got_m = tfu.fused_minibatch_grad_reference(tuple(wp), *args[1:], **kw,
                                                    compute_dtype=dtype)
    for g, ref in zip(got, want):
        assert (g[tuple(slice(0, n) for n in ref.shape)] != 0).any() or (ref == 0).all()
        assert _rel(g[tuple(slice(0, n) for n in ref.shape)], ref) <= 1e-6
        pad = g.clone()
        pad[tuple(slice(0, n) for n in ref.shape)] = 0
        assert (pad == 0).all()         # pad units get zero gradients
    for k in tfu.METRICS:
        assert abs(got_m[k].item() - want_m[k].item()) <= 1e-6 * abs(want_m[k].item())


@pytest.mark.parametrize("g", [2, 6, 10])
def test_head_padding_is_exact(g):
    """Zero logit columns (G*5 up to a multiple of 16) change neither the
    logits nor dh = Wl dlogits, bf16 operands and float32 sums as the
    kernels take them."""
    rng = np.random.default_rng(g)
    h, m = 64, 256
    g5 = 5 * g
    g5p = -(-g5 // 16) * 16
    wl = torch.from_numpy(rng.normal(0, 0.1, (h, g5)).astype(np.float32))
    act = torch.from_numpy(np.tanh(rng.normal(0, 1, (h, m))).astype(np.float32))
    dl = torch.from_numpy(rng.normal(0, 1e-3, (g5, m)).astype(np.float32))
    wl_p = torch.zeros(h, g5p)
    wl_p[:, :g5] = wl
    dl_p = torch.zeros(g5p, m)
    dl_p[:g5] = dl

    def rnd(a):
        return a.to(torch.bfloat16).to(torch.float32)

    logits_p = rnd(wl_p).T @ rnd(act)
    assert _rel(logits_p[:g5], rnd(wl).T @ rnd(act)) <= 1e-6
    assert (logits_p[g5:] == 0).all()
    assert _rel(rnd(wl_p) @ rnd(dl_p), rnd(wl) @ rnd(dl)) <= 1e-6
    assert _rel((rnd(act) @ rnd(dl_p).T)[:, :g5], rnd(act) @ rnd(dl).T) <= 1e-6


def test_plan_at_config_4():
    """Bench config 4's minibatch (3v3, F_pad 32, hidden (256, 256), G = 6,
    2^20 samples): the tensor cores, every size as the kernels carve it."""
    p = tfu.update_plan(32, (256, 256), 30, 1 << 20)
    assert p["route"] == "tensor_cores"
    assert (p["f1p"], p["h1p"], p["h2p"], p["hp"], p["g5p"]) == (32, 256, 256, 256, 32)
    # forward: bf16 W1, W2, Wl (rows padded by 8), obs, h, dlogits tiles;
    # float32 logits, biases, value head, per-sample rows
    halves = 32 * 256 + 256 * 256 + 256 * 40 + 32 * 64 + 256 * 64 + 32 * 64
    floats = 32 * 64 + 256 + 256 + 32 + 256 + 16 * 64 + 8 * 64 + 2 * 6 * 64
    assert p["smem_fwd"] == 2 * halves + 4 * floats <= 232448
    assert p["smem_bwd"] == 2 * (2 * 32 * 64 + 2 * 256 * 64 + 64 * 256 + 32 * 64
                                 + 2 * 64 * 64) + 4 * (64 + 128)
    assert p["n_chunks"] == p["fwd_blocks"] == 256
    assert p["bwd_blocks"] == 256 * 4 and p["tiles_per_chunk"] == 64
    assert p["e_fwd"] == 256 * 32 + 32 + 2 * 256 + 8
    assert p["e_bwd"] == 32 * 256 + 256 + 256 * 256
    assert p["fwd_offsets"] == dict(dwl=0, dbl=8192, dwv=8224, dbv=8480, db=8484,
                                    met=8740)
    assert p["bwd_offsets"] == dict(dw1=0, db1=8192, dw2=8448)
    assert p["dz_shape"] == (256, 1 << 20) and p["xb_shape"] == (32, 1 << 20)
    assert p["partial_floats"] == 256 * (p["e_fwd"] + p["e_bwd"])


def test_plan_at_config_5():
    """Bench config 5's minibatch (5v5, F_pad 48, hidden (256, 256), G = 10,
    2^21 samples): the tensor cores with W2 streamed through a ring of two
    64-row slabs (resident, the forward block would need 270,592 bytes),
    every size as the kernels carve it."""
    p = tfu.update_plan(48, (256, 256), 50, 1 << 21)
    assert p["route"] == "tensor_cores" and p["w2_layout"] == "streamed"
    assert (p["f1p"], p["h1p"], p["h2p"], p["hp"], p["g5p"]) == (48, 256, 256, 256, 64)
    # the ring: two slabs [64][256] of W2 in bf16
    assert p["w2_ring_bytes"] == 2 * 64 * 256 * 2 == 65536
    # forward: bf16 W1, W2's ring, Wl (rows padded by 8), obs, h, dlogits
    # tiles; float32 logits, biases, value head, per-sample rows
    halves = 48 * 256 + 2 * 64 * 256 + 256 * 72 + 48 * 64 + 256 * 64 + 64 * 64
    floats = 64 * 64 + 256 + 256 + 64 + 256 + 16 * 64 + 8 * 64 + 2 * 10 * 64
    assert p["smem_fwd"] == 2 * halves + 4 * floats == 205056 <= 232448
    resident = 2 * (halves - 2 * 64 * 256 + 256 * 256) + 4 * floats
    assert resident == 270592 > 232448
    assert p["smem_bwd"] == 2 * (2 * 48 * 64 + 2 * 256 * 64 + 64 * 256 + 48 * 64
                                 + 2 * 64 * 64) + 4 * (64 + 128) == 133888
    assert p["n_chunks"] == p["fwd_blocks"] == 512
    assert p["bwd_blocks"] == 512 * 4 == 2048 and p["tiles_per_chunk"] == 64
    assert p["e_fwd"] == 256 * 64 + 64 + 2 * 256 + 8
    assert p["e_bwd"] == 48 * 256 + 256 + 256 * 256
    assert p["fwd_offsets"] == dict(dwl=0, dbl=16384, dwv=16448, dbv=16704,
                                    db=16708, met=16964)
    assert p["bwd_offsets"] == dict(dw1=0, db1=12288, dw2=12544)
    assert p["dz_shape"] == (256, 1 << 21) and p["xb_shape"] == (48, 1 << 21)
    assert p["partial_floats"] == 512 * (p["e_fwd"] + p["e_bwd"])


@pytest.mark.parametrize("f_dim,widths,g5,m,route,padded,layout", [
    (24, (48, 40), 20, 384, "tensor_cores", (32, 64, 64, 32), "resident"),
    (48, (128, 128), 50, 1024, "tensor_cores", (48, 128, 128, 64), "resident"),
    (24, (16,), 20, 256, "tensor_cores", (32, 64, 0, 32), None),
    (32, (100,), 30, 768, "tensor_cores", (32, 128, 0, 32), None),
    (48, (256, 256), 50, 1024, "tensor_cores", (48, 256, 256, 64), "streamed"),
    (40, (256, 256), 40, 1024, "tensor_cores", (48, 256, 256, 48), "streamed"),
    (32, (256, 256, 256), 30, 1024, "cuda_cores", None, None),  # three layers
    (32, (512,), 30, 1024, "cuda_cores", None, None),         # wider than 256
    (48, (256, 256), 50, 1 << 21, "tensor_cores", (48, 256, 256, 64), "streamed"),
], ids=["2v2-48-40", "5v5-128", "2v2-16", "3v3-100", "5v5-256", "4v4-256",
        "three-layers", "wide", "ppo_iter.5v5"])
def test_plan_routes(f_dim, widths, g5, m, route, padded, layout):
    """Torso widths pad to multiples of 64, G*5 and F to multiples of 16;
    W2 stays resident where the forward block fits shared memory and is
    streamed where only that fits (4v4 and 5v5 at (256, 256)); what the
    tensor-core kernels cannot hold takes the CUDA-core chain, as does
    every float32 call."""
    p = tfu.update_plan(f_dim, widths, g5, m)
    assert p["route"] == route
    assert p["n_chunks"] == -(-m // tfu.CHUNK)
    if padded:
        assert (p["f1p"], p["h1p"], p["h2p"], p["g5p"]) == padded
        assert p["w2_layout"] == layout
        assert p["w2_ring_bytes"] == (4 * 64 * padded[2] if layout == "streamed"
                                      else 0)
        assert p["smem_fwd"] <= 232448 and p["bwd_blocks"] == p["n_chunks"] * (
            p["h1p"] // 64)
    assert tfu.update_plan(f_dim, widths, g5, m, torch.float32)["route"] == "cuda_cores"


def test_plan_streams_w2_where_resident_does_not_fit(monkeypatch):
    """With less shared memory than config 4's resident forward block
    (229,504 bytes) but more than its streamed one (163,968), the plan
    streams W2: the way a test forces the streamed layout where both fit.
    Every other size stays as at config 4."""
    chosen = tfu.update_plan(32, (256, 256), 30, 1 << 20)
    monkeypatch.setattr(_build, "SMEM_BYTES", 200000)
    forced = tfu.update_plan(32, (256, 256), 30, 1 << 20)
    assert chosen["w2_layout"] == "resident" and forced["w2_layout"] == "streamed"
    assert (chosen["smem_fwd"], forced["smem_fwd"]) == (229504, 163968)
    assert chosen["smem_fwd"] - forced["smem_fwd"] == 2 * (256 * 256 - 2 * 64 * 256)
    assert forced["w2_ring_bytes"] == 65536 and chosen["w2_ring_bytes"] == 0
    assert {k: v for k, v in forced.items()
            if k not in ("w2_layout", "w2_ring_bytes", "smem_fwd")} == {
        k: v for k, v in chosen.items()
        if k not in ("w2_layout", "w2_ring_bytes", "smem_fwd")}
    # below the streamed block, the chain
    monkeypatch.setattr(_build, "SMEM_BYTES", 160000)
    assert tfu.update_plan(32, (256, 256), 30, 1 << 20)["route"] == "cuda_cores"


def test_plan_refusals():
    with pytest.raises(ValueError, match="action groups"):
        tfu.update_plan(32, (64,), 35, 256)           # G = 7
    with pytest.raises(ValueError, match="action groups"):
        tfu.update_plan(32, (64,), 31, 256)           # not G*5
    with pytest.raises(ValueError, match="shared memory"):
        tfu.update_plan(32, (4096,), 20, 256)         # the CUDA-core loss kernel
    with pytest.raises(ValueError):
        tfu.update_plan(32, (64,), 20, 200)           # not whole lanes
    with pytest.raises(ValueError):
        tfu.update_plan(32, (), 20, 256)              # no torso
