// Recurrent (LSTM) self-play experience collection for NVIDIA Hopper
// (sm_90a), CUDA C++, the bf16 route: the torso, the cell and the logits
// head on the tensor cores, the env step on every warp.
//
// Replaces, as fused_recurrent.cu does, the Pallas TPU kernel
// fused_recurrent_collect (gym_futbol_tpu/ops/fused_recurrent.py, body
// _recurrent_kernel, cell _lstm_cell). fused_recurrent.cu keeps the
// exact-f32 route (the parity mode); this file rounds as the TPU kernel
// does on its chip, where an f32 dot_general runs as one bf16 pass: the
// operands of every product of the torso, the cell ([t; h] x [n_t + H,
// 4H]) and the logits head are rounded to bf16 and the products summed in
// f32; the bias adds, the gates' sigmoid and tanh, the carries c and h
// (f32 in device memory), sampling and the value head ([H, 1], exact f32
// on the TPU, on the unrounded h') stay f32. The plain version in that
// mode is fused_recurrent_collect_reference(..., compute_dtype=
// torch.bfloat16) in ops/fused_recurrent.py.
//
// What held the f32 route back (PERF.md §5-§6): lane l of warp 0 alone
// owns and steps each block's 32 envs while four warps share every dense
// layer through shared-memory columns; each multiply and add a separate
// FP32 instruction; the cell's [t; h] x [256, 512] product 94% of the
// 278k multiply-adds per env-step (3v3, hidden (128,), H = 128).
//
// Design, fused_policy_tc.cu's (K2) carried to the cell. Each thread owns
// one env for the whole window and steps it; each warp runs both views'
// forward for its own 32 envs on mma.sync.m16n8k16 (envs are M, outputs
// N, inputs K); warps share only the read-only weights, so the rollout
// loop has no block barrier. Per view:
// - the warp's envs take the M rows so that the rows of a lane's C
//   fragment (g + 8 hh + 16 m) are four consecutive envs (4 g + 2 m + hh,
//   env_row): the lane moves its carries, f32 [H, B] rows in device
//   memory, as one float4 per unit;
// - the obs goes through the torso as in K2, the last torso layer's bf16
//   output into the columns [0, kt) of the warp's cell tile xc, and the
//   view's h, rounded, into its columns [kt, kt + hp), each lane staging
//   the units and envs it will own in the cell, so the cell reads [t; h]
//   as one K = kt + hp operand through ldmatrix;
// - the cell runs in 64-column groups, 16 units each. The host orders
//   the 4 hp gate columns (ops/fused_recurrent.py recurrent_gate_order)
//   so that in n16 chunk j of group q the C fragment of lane (g, t) holds
//   gates i, f (columns 2t, 2t+1 of the chunk's first n8 tile) and g, o
//   (the same of its second) of unit 16 q + 8 (j / 2) + 2 t + j % 2, for
//   rows g and g + 8 of each m16 tile. The lane then runs the cell for
//   its unit and rows in registers (c read and c', h' written in f32):
//   no gate column exists anywhere. Over the group's four chunks the lane
//   holds h' of units 2t, 2t+1, 8+2t, 9+2t: packed to bf16 that is the
//   A fragment of the logits head's k16 step q, and the unrounded h'
//   feeds the f32 value head;
// - the logits (f32, with bias) and the value go through a small tile to
//   their env's thread, which samples as the f32 route does (same draws).
// Weights are bf16 B fragments packed on the host in mma order
// (ops.fused_actor.tc_fragments), zero-padded (K to 16, torso N to 32,
// H to hp, a multiple of 16, the logits to 16: exact), in the order
// torso, logits head, cell. The cell's fragments alone are 262,144 bytes
// at H = 128, more than a block's 232,448 of shared memory, so the plan
// (ops/fused_recurrent.py recurrent_tc_plan) keeps a prefix of the buffer
// resident in shared memory (copied once per block before the only
// barrier: the torso, the head and as much of the cell as fits beside
// the tiles) and the rest is read from L2 through L1, each lane choosing
// per 16-byte unit.
//
// Bound (chip_smoke.py phase 16, H100 SXM peaks, 700 W): per env-step
// both views' products on the tensor cores in bf16, the env step (at the
// measured share of active contacts), biases and value head in f32. At
// 3v3, hidden (128,), H = 128 the products, 2 x 2 x (32 x 128 + 256 x 512
// + 128 x 32) multiply-adds, are most of it: operations bound it, not
// bytes (the carries, c and h [2, H, B] f32, read and written each step,
// 33.5 MB at 16384 envs, stay in L2). The kernel runs far above that
// bound: with one thread per env a 16384-env batch gives each SM four
// warps, so the latency of the env step, the gates' sigmoid and tanh, the
// carries' loads and the streamed part of the cell's weights is hidden
// by little else (PERF.md §6).
//
// LayerNorm (stable-baselines' layer-normalised cell, MlpLnLstmPolicy:
// gates = LN(t Wi; gx, bx) + LN(h Wh; gh, bh) + b, h' = o tanh(LN(c';
// gc, bc))): the kernel's body takes it as a compile-time flag, and its
// instantiation is recurrent_ln_tc_kernel. Each product is normalised
// over its whole 4H row, and c' over its H units, before any unit's use,
// while the cell runs group by group; a warp owns its envs' rows whole,
// so every reduction stays in the warp (the quad's __shfl_xor_sync). The
// design, three passes over the groups:
// - pass 1 runs the group's products as the plain cell does, but t Wi
//   (its first kt / 16 k-steps) and h Wh (the rest) into two
//   accumulators, and sums each row's values and squares of both;
// - pass 2 runs the products again (nothing holds 4H columns of 32 rows
//   between the passes: the tiles do not, and registers hold one
//   group's), normalises each with its row's mean and 1 / sqrt(var +
//   1e-5) (var = E[y^2] - E[y]^2, clamped at 0, over the real 4H columns:
//   a padded unit's columns are zero), adds b, runs the gates and c', and
//   writes c' and the o gate to the view's carry rows (c' is what the
//   plain cell writes there; the o gate waits in h's place), summing c'
//   and c'^2 for each row;
// - pass 3 reads them back, normalises c', writes h' over the o gate and
//   feeds the heads group by group as the plain cell does.
// The bootstrap forward, which stores no carry, writes them to a scratch
// [2, 2, H, B] instead. The LayerNorm vectors (gx, bx, gh, bh in the gate
// columns' order, gc, bc per unit) follow the value head in the f32
// vector; statistics, normalisation, gains and biases are f32.
//
// C interface for ctypes; the entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "policy_common.cuh"

namespace {

using namespace futbol;
using bf16 = __nv_bfloat16;

constexpr int kRecMaxThreads = 128;  // 1-4 warps a block, 32 envs a warp
constexpr int kRecSmemLimit = 232448;

// The net: torso layers 0 .. n_torso - 1 (tanh), the cell (layer n_torso:
// kp = kt + hp inputs [t; h], np = 4 hp gate columns in the kernel's
// order) and the logits head (layer n_torso + 1: kp = hp). Per layer kp,
// np, the fragments' offset w_off (16-byte units) and the f32 bias's
// b_off. The f32 value head at wv_off: hp weights (zero past H), then its
// bias.
struct RecNet {
  int n_torso, hsize, hp;
  int kp[kMaxLayers], np[kMaxLayers], w_off[kMaxLayers], b_off[kMaxLayers];
  int wv_off;
};

// Envs per block (32 a warp), the fragment units resident in shared
// memory (a prefix of the buffer), each warp's three tiles' bytes and row
// strides (bf16 elements): t[0] (the obs, even torso layers but the last,
// and the f32 logits tile), t[1] (odd torso layers but the last), xc (the
// cell's input [t | h]).
struct RecPlan {
  int envs, n_res, t_bytes[3], ld[3];
};

struct RecTiles {
  bf16* t[2];
  bf16* xc;
  int ld[2], ldc;
  float* lg;
};

// One view's carries, [H, B] rows: read from *_src, written to *_dst
// (null: not written).
struct Carry {
  const float* c_src;
  const float* h_src;
  float* c_dst;
  float* h_dst;
};

// Both views' carries, [2, H, B] each: the input, never written, and the
// output, which holds the carries from the end of step 0 on.
struct CarryIO {
  const float* c_in;
  const float* h_in;
  float* c_out;
  float* h_out;
};

// Where the fragments live: ws the shared-memory copy of the first n_res
// units, wg the whole buffer in device memory.
struct Frags {
  const uint4* ws;
  const uint4* wg;
  int n_res;
  // a layer of n units from w_off: resident when all of it is
  __device__ __forceinline__ const uint4* layer(int w_off, int n) const {
    return (w_off + n <= n_res ? ws : wg) + w_off;
  }
  __device__ __forceinline__ uint4 unit(int i) const {
    return *((i < n_res ? ws : wg) + i);
  }
};

// The LayerNorm instantiation's own arguments: the LayerNorm vectors'
// offset in the f32 vector, and the bootstrap forward's scratch.
struct RecLn {
  int off;
  float* scr;
};

__device__ __forceinline__ float gate_sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// A row's (sum, sum of squares) over the quad, as (mean, 1 / sqrt(var +
// eps)) over n columns.
__device__ __forceinline__ float2 quad_stats(float2 p, int n) {
  p.x += __shfl_xor_sync(0xffffffffu, p.x, 1);
  p.y += __shfl_xor_sync(0xffffffffu, p.y, 1);
  p.x += __shfl_xor_sync(0xffffffffu, p.x, 2);
  p.y += __shfl_xor_sync(0xffffffffu, p.y, 2);
  const float nf = static_cast<float>(n);
  const float mu = p.x / nf;
  return make_float2(mu, 1.0f / sqrtf(fmaxf(p.y / nf - mu * mu, 0.0f) + 1e-5f));
}

// One group pass's products (pass 1 and 2 of the LayerNorm cell): t Wi
// into ax, h Wh into ay.
__device__ __forceinline__ void ln_products(float (&ax)[2][4][4], float (&ay)[2][4][4],
                                            const bf16* xa, int ldc, const Frags& fr,
                                            int w_off, int njc, int jj0, int nkt, int nk,
                                            int lane) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ax[m][j][e] = ay[m][j][e] = 0.0f;
#pragma unroll 2
  for (int kk = 0; kk < nkt; ++kk) {
    unsigned a[2][4];
    ldsm_x4(a[0], xa + kk * 16);
    ldsm_x4(a[1], xa + 16 * ldc + kk * 16);
    const int i0 = w_off + (kk * njc + jj0) * 32 + lane;
    mma_chunk(ax, a, fr.unit(i0), fr.unit(i0 + 32));
  }
#pragma unroll 2
  for (int kk = nkt; kk < nk; ++kk) {
    unsigned a[2][4];
    ldsm_x4(a[0], xa + kk * 16);
    ldsm_x4(a[1], xa + 16 * ldc + kk * 16);
    const int i0 = w_off + (kk * njc + jj0) * 32 + lane;
    mma_chunk(ay, a, fr.unit(i0), fr.unit(i0 + 32));
  }
}

// LN(v; g, b) with the row's statistics st = (mean, 1 / sqrt(var + eps)).
__device__ __forceinline__ float ln1(float v, float2 st, float g, float b) {
  return g * ((v - st.x) * st.y) + b;
}

// The M row of the warp's env e (0..31): lane (g, t) of an mma C fragment
// holds rows g + 8 hh + 16 m, which are envs 4 g + 2 m + hh, four
// consecutive envs, so its carries move as one float4 per unit.
__device__ __forceinline__ int env_row(int e) {
  return (e >> 2) + 8 * (e & 1) + 16 * ((e >> 1) & 1);
}

__device__ __forceinline__ float part(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Row u of a [H, B] carry at envs e0 .. e0 + 3 (zero past the batch's end
// or where u is a padded unit); one 16-byte load where the four are
// in the batch and 16-byte aligned (B % 4 == 0).
__device__ __forceinline__ float4 carry4(const float* p, int u, int hsize, int e0,
                                         int B) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (u >= hsize || e0 >= B) return v;
  const float* r = p + static_cast<size_t>(u) * B + e0;
  if ((reinterpret_cast<uintptr_t>(r) & 15) == 0 && e0 + 3 < B)
    return *reinterpret_cast<const float4*>(r);
  v.x = r[0];
  v.y = e0 + 1 < B ? r[1] : 0.0f;
  v.z = e0 + 2 < B ? r[2] : 0.0f;
  v.w = e0 + 3 < B ? r[3] : 0.0f;
  return v;
}

__device__ __forceinline__ void store4(float* p, int u, int hsize, int e0, int B,
                                       const float4& v) {
  if (u >= hsize || e0 >= B) return;
  float* r = p + static_cast<size_t>(u) * B + e0;
  if ((reinterpret_cast<uintptr_t>(r) & 15) == 0 && e0 + 3 < B) {
    *reinterpret_cast<float4*>(r) = v;
    return;
  }
  r[0] = v.x;
  if (e0 + 1 < B) r[1] = v.y;
  if (e0 + 2 < B) r[2] = v.z;
  if (e0 + 3 < B) r[3] = v.w;
}

// One view's forward for the warp (module note): returns the f32 tile
// whose row o, column lane is logit o of the lane's env, the value at row
// np_head.
template <int NB, bool MIRROR, bool LN>
__device__ __forceinline__ const float* rec_view_forward(
    const Env<NB>& e, bool owner, const ObsConsts& oc, float* obs, size_t row_stride,
    int f_pad, const Frags& fr, const float* __restrict__ fv, const RecNet& n,
    const RecTiles& wt, const Carry& cr, int B, int b0, int lane, const RecLn& ln) {
  constexpr int KK0 = (4 * NB + 2 + 15) / 16;
  constexpr int NLJ = ((NB - 1) * kChoices + 15) / 16 * 2;
  const int g = lane >> 2, t = lane & 3;
  const int e0 = b0 + 4 * g;   // the envs of the lane's C-fragment rows
  const int nt = n.n_torso, cl = nt, hl = nt + 1;
  const int kt = n.kp[cl] - n.hp;
  unsigned x0[KK0][2][4];
  obs_fragments<NB, MIRROR>(e, owner, oc, obs, row_stride, f_pad, wt.t[0], wt.ld[0],
                            env_row(lane), lane, x0);
  // the view's h, rounded, into the cell tile after t: lane (g, t) stages
  // the units the cell gives it (16 q + 8 half + 2 t + jl) for its four
  // envs, one float4 per unit
#pragma unroll 1
  for (int q = 0; q < n.hp / 16; ++q) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int u = 16 * q + 8 * half + 2 * t;
      const float4 h0 = carry4(cr.h_src, u, n.hsize, e0, B);
      const float4 h1 = carry4(cr.h_src, u + 1, n.hsize, e0, B);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        *reinterpret_cast<unsigned*>(wt.xc + (g + 8 * (k & 1) + 16 * (k >> 1)) * wt.ldc +
                                     kt + u) = pack_bf16(part(h0, k), part(h1, k));
    }
  }
  // the torso, its last layer into xc's first kt columns
#pragma unroll 1
  for (int l = 0; l < nt; ++l) {
    const int nj = n.np[l] / 16;
    const uint4* W = fr.layer(n.w_off[l], n.kp[l] * n.np[l] / 8);
    bf16* Y = l == nt - 1 ? wt.xc : wt.t[l & 1];
    const int ldy = l == nt - 1 ? wt.ldc : wt.ld[l & 1];
#pragma unroll 1
    for (int c = 0; c < n.np[l] / kNc; ++c) {
      float acc[2][4][4] = {};
      if (l == 0)
        chunk_from_regs<KK0>(acc, x0, W, nj, c, lane);
      else
        chunk_from_tile(acc, wt.t[(l - 1) & 1], wt.ld[(l - 1) & 1], n.kp[l], W, nj, c,
                        lane);
      bias_tanh(acc, fv + n.b_off[l], c, lane);
      store_chunk(acc, Y, ldy, c, lane);
    }
    __syncwarp();
  }
  // the cell, 16 units a group, each group's h' one k16 step of the heads
  const int njc = n.np[cl] / 16;
  const float* __restrict__ cb = fv + n.b_off[cl];
  const float* __restrict__ wv = fv + n.wv_off;
  const uint4* Wl = fr.layer(n.w_off[hl], n.kp[hl] * n.np[hl] / 8);
  float hacc[2][NLJ][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NLJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) hacc[m][j][q] = 0.0f;
  float vpart[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  const int q8 = lane >> 3, r8 = lane & 7;
  const bf16* xa = wt.xc + ((q8 & 1) * 8 + r8) * wt.ldc + (q8 >> 1) * 8;
  if constexpr (LN) {
    const int nk = n.kp[cl] / 16, nkt = kt / 16, g4 = 4 * n.hp;
    // gx, bx, gh, bh [4 hp] in the gate columns' order, then gc, bc [hp]
    const float* __restrict__ lv = fv + ln.off;
    // pass 1: each row's sums of t Wi and of h Wh
    float2 sx[2][2], sy[2][2];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) sx[m][hh] = sy[m][hh] = make_float2(0.0f, 0.0f);
#pragma unroll 1
    for (int q = 0; q < n.hp / 16; ++q) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float ax[2][4][4], ay[2][4][4];
        ln_products(ax, ay, xa, wt.ldc, fr, n.w_off[cl], njc, 4 * q + 2 * half, nkt, nk,
                    lane);
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
              for (int e2 = 0; e2 < 2; ++e2) {
                const float x = ax[m][j][2 * hh + e2], y = ay[m][j][2 * hh + e2];
                sx[m][hh].x += x;
                sx[m][hh].y += x * x;
                sy[m][hh].x += y;
                sy[m][hh].y += y * y;
              }
      }
    }
    float2 stx[2][2], sty[2][2], sc[2][2];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        stx[m][hh] = quad_stats(sx[m][hh], 4 * n.hsize);
        sty[m][hh] = quad_stats(sy[m][hh], 4 * n.hsize);
        sc[m][hh] = make_float2(0.0f, 0.0f);
      }
    // pass 2: the gates and c'; c' and the o gate to the carry rows
#pragma unroll 1
    for (int q = 0; q < n.hp / 16; ++q) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int jj0 = 4 * q + 2 * half;
        const int u0 = 16 * q + 8 * half + 2 * t;
        const float4 cold[2] = {carry4(cr.c_src, u0, n.hsize, e0, B),
                                carry4(cr.c_src, u0 + 1, n.hsize, e0, B)};
        float ax[2][4][4], ay[2][4][4];
        ln_products(ax, ay, xa, wt.ldc, fr, n.w_off[cl], njc, jj0, nkt, nk, lane);
#pragma unroll
        for (int jl = 0; jl < 2; ++jl) {
          const int u = u0 + jl;
          const int col = 16 * (jj0 + jl) + 2 * t;   // i, f; + 8: g, o
          float2 v[5][2];   // b, gx, bx, gh, bh: (i, f) and (g, o)
#pragma unroll
          for (int w = 0; w < 5; ++w) {
            const float* base = w == 0 ? cb : lv + (w - 1) * g4;
            v[w][0] = __ldg(reinterpret_cast<const float2*>(base + col));
            v[w][1] = __ldg(reinterpret_cast<const float2*>(base + col + 8));
          }
          float cn[4], on[4];
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int k = 2 * m + hh;
              float pre[4];
#pragma unroll
              for (int gq = 0; gq < 4; ++gq) {
                const int j = 2 * jl + (gq >> 1), ee = 2 * hh + (gq & 1);
                const float2 gx = v[1][gq >> 1], bx = v[2][gq >> 1];
                const float2 gh = v[3][gq >> 1], bh = v[4][gq >> 1];
                const float2 bb = v[0][gq >> 1];
                const bool second = gq & 1;
                pre[gq] = (ln1(ax[m][j][ee], stx[m][hh], second ? gx.y : gx.x,
                               second ? bx.y : bx.x) +
                           ln1(ay[m][j][ee], sty[m][hh], second ? gh.y : gh.x,
                               second ? bh.y : bh.x)) +
                          (second ? bb.y : bb.x);
              }
              const float gi = gate_sigmoid(pre[0]);
              const float gf = gate_sigmoid(pre[1]);
              const float gg = tanhf(pre[2]);
              on[k] = gate_sigmoid(pre[3]);
              cn[k] = gf * part(cold[jl], k) + gi * gg;
              sc[m][hh].x += cn[k];
              sc[m][hh].y += cn[k] * cn[k];
            }
          store4(cr.c_dst, u, n.hsize, e0, B, make_float4(cn[0], cn[1], cn[2], cn[3]));
          store4(cr.h_dst, u, n.hsize, e0, B, make_float4(on[0], on[1], on[2], on[3]));
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) sc[m][hh] = quad_stats(sc[m][hh], n.hsize);
    // pass 3: h' from LN(c') and the o gate, the heads group by group
#pragma unroll 1
    for (int q = 0; q < n.hp / 16; ++q) {
      unsigned ah[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int u0 = 16 * q + 8 * half + 2 * t;
        float hv[2][2][2];   // h' [m][hh][jl]
#pragma unroll
        for (int jl = 0; jl < 2; ++jl) {
          const int u = u0 + jl;
          const float4 c4 = carry4(cr.c_dst, u, n.hsize, e0, B);
          const float4 o4 = carry4(cr.h_dst, u, n.hsize, e0, B);
          const float gc = u < n.hsize ? __ldg(lv + 4 * g4 + u) : 0.0f;
          const float bc = u < n.hsize ? __ldg(lv + 4 * g4 + n.hp + u) : 0.0f;
          const float wvu = __ldg(wv + u);
          float hn[4];
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int k = 2 * m + hh;
              hn[k] = part(o4, k) * tanhf(ln1(part(c4, k), sc[m][hh], gc, bc));
              hv[m][hh][jl] = hn[k];
              vpart[m][hh] = vpart[m][hh] + hn[k] * wvu;
            }
          store4(cr.h_dst, u, n.hsize, e0, B, make_float4(hn[0], hn[1], hn[2], hn[3]));
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            ah[m][2 * half + hh] = pack_bf16(hv[m][hh][0], hv[m][hh][1]);
      }
      head_step<NLJ>(hacc, ah, Wl, q, lane);
    }
  } else {
#pragma unroll 1
  for (int q = 0; q < n.hp / 16; ++q) {
    unsigned ah[2][4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int jj0 = 4 * q + 2 * half;   // the pass's two n16 chunks
      // the old c of the lane's two units and four envs, loaded early
      const int u0 = 16 * q + 8 * half + 2 * t;
      const float4 cold[2] = {carry4(cr.c_src, u0, n.hsize, e0, B),
                              carry4(cr.c_src, u0 + 1, n.hsize, e0, B)};
      float acc[2][4][4] = {};
#pragma unroll 2
      for (int kk = 0; kk < n.kp[cl] / 16; ++kk) {
        unsigned a[2][4];
        ldsm_x4(a[0], xa + kk * 16);
        ldsm_x4(a[1], xa + 16 * wt.ldc + kk * 16);
        const int i0 = n.w_off[cl] + (kk * njc + jj0) * 32 + lane;
        mma_chunk(acc, a, fr.unit(i0), fr.unit(i0 + 32));
      }
      float hv[2][2][2];   // h' [m][hh][jl]
#pragma unroll
      for (int jl = 0; jl < 2; ++jl) {
        const int u = u0 + jl;
        const int col = 16 * (jj0 + jl) + 2 * t;   // i, f; + 8: g, o
        const float2 bif = __ldg(reinterpret_cast<const float2*>(cb + col));
        const float2 bgo = __ldg(reinterpret_cast<const float2*>(cb + col + 8));
        const float wvu = __ldg(wv + u);
        float cn[4], hn[4];   // env 4 g + k, k = 2 m + hh: row 16 m + g + 8 hh
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int k = 2 * m + hh;
            const float gi = gate_sigmoid(acc[m][2 * jl][2 * hh] + bif.x);
            const float gf = gate_sigmoid(acc[m][2 * jl][2 * hh + 1] + bif.y);
            const float gg = tanhf(acc[m][2 * jl + 1][2 * hh] + bgo.x);
            const float go = gate_sigmoid(acc[m][2 * jl + 1][2 * hh + 1] + bgo.y);
            cn[k] = gf * part(cold[jl], k) + gi * gg;
            hn[k] = go * tanhf(cn[k]);
            hv[m][hh][jl] = hn[k];
            vpart[m][hh] = vpart[m][hh] + hn[k] * wvu;
          }
        if (cr.c_dst != nullptr) {
          store4(cr.c_dst, u, n.hsize, e0, B, make_float4(cn[0], cn[1], cn[2], cn[3]));
          store4(cr.h_dst, u, n.hsize, e0, B, make_float4(hn[0], hn[1], hn[2], hn[3]));
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          ah[m][2 * half + hh] = pack_bf16(hv[m][hh][0], hv[m][hh][1]);
    }
    head_step<NLJ>(hacc, ah, Wl, q, lane);
  }
  }
  __syncwarp();   // every read of the tiles is done: lg aliases t[0]
  heads_out<NLJ>(hacc, vpart, fv + n.b_off[hl], true, __ldg(wv + n.hp), n.np[hl],
                 wt.lg, lane);
  return wt.lg;
}

// ---------------------------------------------------------------------------
// Kernel: plan.envs threads and envs per block, thread i owning env
// blockIdx.x * plan.envs + i.
// ---------------------------------------------------------------------------

template <int NB, bool LN>
__device__ __forceinline__ void recurrent_body(
    const float* __restrict__ sf_in, const int* __restrict__ si_in,
    float* __restrict__ sf_out, int* __restrict__ si_out, const uint4* __restrict__ wfrag,
    const float* __restrict__ fv, const RecNet& net, const RecPlan& plan, const CarryIO& io,
    const CollectOut& out, const float* __restrict__ table, uint32_t seed, int B, int T,
    int f_pad, const Consts& c, const Ints& k, const ObsConsts& oc, const RecLn& ln) {
  constexpr int NPL = NB - 1;
  constexpr int ND = 2 * NPL + 2 + 2 * NB;
  constexpr int G = NPL;
  extern __shared__ __align__(16) unsigned char smem_rec[];
  uint4* ws = reinterpret_cast<uint4*>(smem_rec);
  for (int i = threadIdx.x; i < plan.n_res; i += blockDim.x) ws[i] = __ldg(wfrag + i);
  __syncthreads();   // the block's only barrier
  const Frags fr{ws, wfrag, plan.n_res};
  unsigned char* mine = smem_rec + static_cast<size_t>(plan.n_res) * sizeof(uint4) +
                        (threadIdx.x >> 5) *
                            (plan.t_bytes[0] + plan.t_bytes[1] + plan.t_bytes[2]);
  RecTiles wt;
  wt.t[0] = reinterpret_cast<bf16*>(mine);
  wt.t[1] = reinterpret_cast<bf16*>(mine + plan.t_bytes[0]);
  wt.xc = reinterpret_cast<bf16*>(mine + plan.t_bytes[0] + plan.t_bytes[1]);
  wt.ld[0] = plan.ld[0];
  wt.ld[1] = plan.ld[1];
  wt.ldc = plan.ld[2];
  wt.lg = reinterpret_cast<float*>(mine);
  const int lane = threadIdx.x & 31;
  const int b0 = blockIdx.x * plan.envs + (threadIdx.x & ~31);
  if (b0 >= B) return;   // no env in this warp
  const int b = b0 + lane;
  const bool owner = b < B;
  const int row = env_row(lane);                          // the env's M row
  const int vrow = net.np[net.n_torso + 1] * 32 + row;    // its value in the tile
  const size_t row_stride = static_cast<size_t>(T) * B;
  const size_t view = static_cast<size_t>(net.hsize) * B;
  Env<NB> e;
  if (owner) load_env<NB>(e, sf_in, si_in, B, b);
#pragma unroll 1
  for (int step = 0; step < T; ++step) {
    int ia[G], ib[G];
    float lp[2], val[2];
    float* o0 = owner ? out.obs + static_cast<size_t>(step) * B + b : nullptr;
    const float* c_src = step == 0 ? io.c_in : io.c_out;
    const float* h_src = step == 0 ? io.h_in : io.h_out;
    const float* y = rec_view_forward<NB, false, LN>(
        e, owner, oc, o0, row_stride, f_pad, fr, fv, net, wt,
        Carry{c_src, h_src, io.c_out, io.h_out}, B, b0, lane, ln);
    if (owner) {
      lp[0] = sample_groups<G, 0>(y + row, table, seed, ND, B, step, b, ia);
      val[0] = y[vrow];
    }
    y = rec_view_forward<NB, true, LN>(
        e, owner, oc, owner ? o0 + f_pad * row_stride : nullptr, row_stride, f_pad, fr,
        fv, net, wt, Carry{c_src + view, h_src + view, io.c_out + view, io.h_out + view},
        B, b0, lane, ln);
    if (owner) {
      lp[1] = sample_groups<G, G>(y + row, table, seed, ND, B, step, b, ib);
      val[1] = y[vrow];
      int dp[2], ap[2];
      pack<G>(ia, dp[0], ap[0]);
      pack<G>(ib, dp[1], ap[1]);
      int dirs[NPL], acts[NPL];
      joint_action<NPL>(ia, ib, dirs, acts);
      const EnvDraws<NB> draws{table, seed, ND, B, step, b, c.kick_noise};
      bool goal0, goal1;
      float r[2];
      r[0] = step_dynamics<NB>(e, dirs, acts, draws, c, k, goal0, goal1, r[1]);
      const int done = step_finish<NB>(e, goal0, goal1, draws, c, k) ? 1 : 0;
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const size_t i = (static_cast<size_t>(step) * 2 + v) * B + b;
        out.dirs[i] = dp[v];
        out.acts[i] = ap[v];
        out.logp[i] = lp[v];
        out.value[i] = val[v];
        out.reward[i] = r[v];
        out.done[i] = done;
      }
      if (done) {
        // both views' carries zeroed where the episode ended (the next
        // step's readers are lanes of this warp, after its __syncwarp)
        for (size_t q = b; q < 2 * view; q += B) {
          io.c_out[q] = 0.0f;
          io.h_out[q] = 0.0f;
        }
      }
    }
  }
  // bootstrap values of the carried state on the carried carries; the
  // cell's carry advance is not stored (LN: c' and the o gate go to the
  // scratch, [c', o][view][H][B])
  const float* y = rec_view_forward<NB, false, LN>(
      e, owner, oc, nullptr, 0, 0, fr, fv, net, wt,
      Carry{io.c_out, io.h_out, LN ? ln.scr : nullptr, LN ? ln.scr + 2 * view : nullptr},
      B, b0, lane, ln);
  if (owner) out.last_value[b] = y[vrow];
  y = rec_view_forward<NB, true, LN>(
      e, owner, oc, nullptr, 0, 0, fr, fv, net, wt,
      Carry{io.c_out + view, io.h_out + view, LN ? ln.scr + view : nullptr,
            LN ? ln.scr + 3 * view : nullptr},
      B, b0, lane, ln);
  if (owner) {
    out.last_value[static_cast<size_t>(B) + b] = y[vrow];
    store_env<NB>(e, sf_out, si_out, B, b);
  }
}

template <int NB>
__global__ void __launch_bounds__(kRecMaxThreads)
recurrent_tc_kernel(const float* __restrict__ sf_in, const int* __restrict__ si_in,
                    float* __restrict__ sf_out, int* __restrict__ si_out,
                    const uint4* __restrict__ wfrag, const float* __restrict__ fv,
                    RecNet net, RecPlan plan, CarryIO io, CollectOut out,
                    const float* __restrict__ table, uint32_t seed, int B, int T,
                    int f_pad, Consts c, Ints k, ObsConsts oc) {
  recurrent_body<NB, false>(sf_in, si_in, sf_out, si_out, wfrag, fv, net, plan, io, out,
                            table, seed, B, T, f_pad, c, k, oc, RecLn{0, nullptr});
}

template <int NB>
__global__ void __launch_bounds__(kRecMaxThreads)
recurrent_ln_tc_kernel(const float* __restrict__ sf_in, const int* __restrict__ si_in,
                       float* __restrict__ sf_out, int* __restrict__ si_out,
                       const uint4* __restrict__ wfrag, const float* __restrict__ fv,
                       RecNet net, RecPlan plan, CarryIO io, CollectOut out,
                       const float* __restrict__ table, uint32_t seed, int B, int T,
                       int f_pad, Consts c, Ints k, ObsConsts oc, RecLn ln) {
  recurrent_body<NB, true>(sf_in, si_in, sf_out, si_out, wfrag, fv, net, plan, io, out,
                           table, seed, B, T, f_pad, c, k, oc, ln);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// The net from [n_torso + 2, 4] ints (kp, np, w_off, b_off); false where
// it breaks the kernel's layout for n_bodies.
bool make_rec_net(const int* dims, int n_torso, int hsize, int wv_off, int n_bodies,
                  int n_frag, RecNet& n) {
  const int k0 = (4 * n_bodies + 2 + 15) / 16 * 16;
  const int head_np = ((n_bodies - 1) * kChoices + 15) / 16 * 16;
  if (n_torso < 1 || n_torso + 2 > kMaxLayers || hsize < 4 || hsize % 4 != 0)
    return false;
  n.n_torso = n_torso;
  n.hsize = hsize;
  n.hp = (hsize + 15) / 16 * 16;
  n.wv_off = wv_off;
  for (int l = 0; l < n_torso + 2; ++l) {
    n.kp[l] = dims[4 * l];
    n.np[l] = dims[4 * l + 1];
    n.w_off[l] = dims[4 * l + 2];
    n.b_off[l] = dims[4 * l + 3];
    if (n.w_off[l] < 0 || n.b_off[l] < 0 || n.b_off[l] % 2 != 0 ||
        n.w_off[l] + n.kp[l] * n.np[l] / 8 > n_frag)
      return false;
    bool ok;
    if (l < n_torso)
      ok = n.kp[l] == (l == 0 ? k0 : n.np[l - 1]) && n.np[l] >= kNc && n.np[l] % kNc == 0;
    else if (l == n_torso)
      ok = n.kp[l] == n.np[l - 1] + n.hp && n.np[l] == 4 * n.hp;
    else
      ok = n.kp[l] == n.hp && n.np[l] == head_np;
    if (!ok) return false;
  }
  return wv_off >= 0;
}

// The plan must fit the card and hold what this net puts in its tiles.
bool rec_plan_ok(const RecNet& n, const RecPlan& p, int n_bodies, int n_frag,
                 size_t& smem) {
  const int k0 = (4 * n_bodies + 2 + 15) / 16 * 16;
  if (p.envs < 32 || p.envs > kRecMaxThreads || p.envs % 32 != 0 || p.n_res < 0 ||
      p.n_res > n_frag)
    return false;
  for (int i = 0; i < 3; ++i)
    if (p.ld[i] % 8 != 0 || p.t_bytes[i] % 16 != 0 || p.t_bytes[i] < 64 * p.ld[i])
      return false;
  bool ok = p.ld[0] >= k0 && (n.np[n.n_torso + 1] + 1) * 32 * 4 <= p.t_bytes[0] &&
            p.ld[2] >= n.kp[n.n_torso];
  for (int l = 0; l + 1 < n.n_torso; ++l) ok = ok && p.ld[l & 1] >= n.np[l];
  smem = static_cast<size_t>(p.n_res) * sizeof(uint4) +
         static_cast<size_t>(p.envs / 32) * (p.t_bytes[0] + p.t_bytes[1] + p.t_bytes[2]);
  return ok && smem <= static_cast<size_t>(kRecSmemLimit);
}

// The entry's launch, plain or LayerNorm (ln: its vectors' offset and
// the scratch, unused by the plain kernel).
template <bool LN>
int launch_recurrent(const float* sf_in, const int* si_in, float* sf_out, int* si_out,
                     const void* wfrag, int n_frag, const float* fv, const int* dims,
                     int n_torso, int hsize, int wv_off, RecLn ln, const int* plan_ints,
                     const float* c_in, const float* h_in, float* c_out, float* h_out,
                     float* obs, int* dirs, int* acts, float* logp, float* value,
                     float* reward, int* done, float* last_value, const float* table,
                     unsigned int seed, int n_bodies, int B, int T, int f_pad, int substeps,
                     int iterations, int max_steps, const float* consts, int n_consts,
                     const float* obs_consts, void* stream) {
  RecNet net;
  const RecPlan plan{plan_ints[0],
                     plan_ints[1],
                     {plan_ints[2], plan_ints[3], plan_ints[4]},
                     {plan_ints[5], plan_ints[6], plan_ints[7]}};
  size_t smem = 0;
  if (n_consts != kNumConsts || B <= 0 || T < 1 || n_bodies < 3 || n_bodies > 11 ||
      f_pad < 4 * n_bodies + 2 ||
      !make_rec_net(dims, n_torso, hsize, wv_off, n_bodies, n_frag, net) ||
      !rec_plan_ok(net, plan, n_bodies, n_frag, smem))
    return cudaErrorInvalidValue;
  if (LN && (ln.off < wv_off + net.hp + 2 || ln.off % 2 != 0 || ln.scr == nullptr))
    return cudaErrorInvalidValue;
  Consts c;
  std::memcpy(&c, consts, sizeof(Consts));
  const Ints k{substeps, iterations, max_steps};
  const ObsConsts oc{obs_consts[0], obs_consts[1], obs_consts[2]};
  const CarryIO io{c_in, h_in, c_out, h_out};
  const CollectOut out{obs, dirs, acts, logp, value, reward, done, last_value};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + plan.envs - 1) / plan.envs);
  const uint4* w = static_cast<const uint4*>(wfrag);
  cudaError_t err = cudaErrorInvalidValue;
  switch (n_bodies) {
#define FUTBOL_CASE(NB)                                                              \
  case NB:                                                                           \
    if constexpr (LN) {                                                              \
      err = cudaFuncSetAttribute(recurrent_ln_tc_kernel<NB>,                         \
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,        \
                                 static_cast<int>(smem));                            \
      if (err != cudaSuccess) return err;                                            \
      recurrent_ln_tc_kernel<NB><<<grid, plan.envs, smem, s>>>(                      \
          sf_in, si_in, sf_out, si_out, w, fv, net, plan, io, out, table, seed, B, T, \
          f_pad, c, k, oc, ln);                                                      \
    } else {                                                                         \
      err = cudaFuncSetAttribute(recurrent_tc_kernel<NB>,                            \
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,        \
                                 static_cast<int>(smem));                            \
      if (err != cudaSuccess) return err;                                            \
      recurrent_tc_kernel<NB><<<grid, plan.envs, smem, s>>>(                         \
          sf_in, si_in, sf_out, si_out, w, fv, net, plan, io, out, table, seed, B, T, \
          f_pad, c, k, oc);                                                          \
    }                                                                                \
    break;
    FUTBOL_CASE(3)
    FUTBOL_CASE(5)
    FUTBOL_CASE(7)
    FUTBOL_CASE(9)
    FUTBOL_CASE(11)
#undef FUTBOL_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int futbol_fused_recurrent_tc(const float* sf_in, const int* si_in, float* sf_out,
                              int* si_out, const void* wfrag, int n_frag, const float* fv,
                              const int* dims, int n_torso, int hsize, int wv_off,
                              const int* plan_ints, const float* c_in, const float* h_in,
                              float* c_out, float* h_out, float* obs, int* dirs,
                              int* acts, float* logp, float* value, float* reward,
                              int* done, float* last_value, const float* table,
                              unsigned int seed, int n_bodies, int B, int T, int f_pad,
                              int substeps, int iterations, int max_steps,
                              const float* consts, int n_consts, const float* obs_consts,
                              void* stream) {
  return launch_recurrent<false>(
      sf_in, si_in, sf_out, si_out, wfrag, n_frag, fv, dims, n_torso, hsize, wv_off,
      RecLn{0, nullptr}, plan_ints, c_in, h_in, c_out, h_out, obs, dirs, acts, logp, value,
      reward, done, last_value, table, seed, n_bodies, B, T, f_pad, substeps, iterations,
      max_steps, consts, n_consts, obs_consts, stream);
}

// The LayerNorm instantiation: as futbol_fused_recurrent_tc, with the
// LayerNorm vectors at ln_off of fv (after the value head: gx, bx, gh, bh
// [4 hp] in the gate columns' order, gc, bc [hp]) and a scratch f32 [2,
// 2, H, B] for the bootstrap forward's c' and o gates.
int futbol_fused_recurrent_ln_tc(const float* sf_in, const int* si_in, float* sf_out,
                                 int* si_out, const void* wfrag, int n_frag,
                                 const float* fv, const int* dims, int n_torso, int hsize,
                                 int wv_off, int ln_off, float* scratch,
                                 const int* plan_ints, const float* c_in, const float* h_in,
                                 float* c_out, float* h_out, float* obs, int* dirs,
                                 int* acts, float* logp, float* value, float* reward,
                                 int* done, float* last_value, const float* table,
                                 unsigned int seed, int n_bodies, int B, int T, int f_pad,
                                 int substeps, int iterations, int max_steps,
                                 const float* consts, int n_consts, const float* obs_consts,
                                 void* stream) {
  return launch_recurrent<true>(
      sf_in, si_in, sf_out, si_out, wfrag, n_frag, fv, dims, n_torso, hsize, wv_off,
      RecLn{ln_off, scratch}, plan_ints, c_in, h_in, c_out, h_out, obs, dirs, acts, logp,
      value, reward, done, last_value, table, seed, n_bodies, B, T, f_pad, substeps,
      iterations, max_steps, consts, n_consts, obs_consts, stream);
}

}  // extern "C"
