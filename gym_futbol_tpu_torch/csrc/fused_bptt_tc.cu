// The LSTM recurrence of the recurrent PPO update (backpropagation
// through time), forward and backward, for NVIDIA Hopper (sm_90a), CUDA
// C++: K6, two kernels, bptt_forward_kernel and bptt_backward_kernel.
//
// Replaces no TPU kernel: the JAX package's recurrent update
// (gym_futbol_tpu/recurrent_ppo.py) runs the cell through jax.grad and
// XLA. Here autograd ran it as ~45 small launches a step, float32 SGEMM
// on the CUDA cores and the gate math element by element (PERF.md §5);
// these kernels take the recurrence, the products on the tensor cores.
// The wrapper and the plain PyTorch version of both kernels, with the
// same roundings, are in ops/fused_bptt.py.
//
// Rounding: the update is held to float32's result. Each operand of the
// step's products goes to the tensor cores as two bf16 terms, x = hi +
// lo (hi = bf16(x), lo = bf16(x - hi)), and a product is three mma.sync
// products summed in f32: lo_a hi_b + hi_a lo_b + hi_a hi_b (lo_a lo_b,
// about 2^-16 of the product, is left out), about 2^-16 relative where
// one bf16 product is 2^-8. A single bf16 product a step moved the
// update's weights, over three iterations, further than the benchmark's
// float32 check admits. The bias add, the gates' sigmoid and tanh, the
// carries c and h, dc, dh and dgates are f32; h_{t-1} and dgates leave
// for the weight gradients' products (outside, on cuBLAS, three bf16
// products each) as their two bf16 terms. sigmoid(x) = 1 / (1 +
// exp(-x)) and tanh(x) = 2 sigmoid(2 x) - 1, from the hardware
// exponential and reciprocal (__expf, __fdividef: a few ulp; libm's expf
// and tanhf made the forward's loop body too long to run from the
// instruction cache, 2x slower in all).
//
// Bound (chip_smoke.py phase 24, H100 SXM peaks, 700 W): per minibatch
// of S sequences over T steps the function needs 2 S T (kt + H) 4H
// operations forward and 2 S T 4H H backward, three bf16 products each
// here, and its own inputs and outputs: t read, every h written, the
// heads' dh read, dgates written (hi and lo). The design adds its saved
// state (the activated gates and c, f32, written once and read once, and
// h_{t-1}, hi and lo).
//
// Design. A block of 16 warps owns a slab of kRows = 64 sequences for
// the whole window and walks the steps inside the kernel (t = 0 .. T-1
// forward, T-1 .. 0 backward), so the carries never leave the SM between
// steps: h_{t-1} (hi and lo tiles) and dgates_t (hi and lo tiles) wait in
// shared memory as the next product's A operand (mma.sync.m16n8k16
// through ldmatrix, the block's 64 rows as four m16 tiles), c and dc in
// shared memory, dh in registers.
// - Forward: the product's A is [t_t; h_{t-1}]: t_t's fragments (hi and
//   lo) come packed on the host in the A-fragment order and are read
//   from L2 (each warp the block's 16 KB a step), h_{t-1}'s from two
//   shared tiles, so shared memory does not grow with the torso. The
//   gate columns are K5's order (ops/fused_recurrent.py
//   recurrent_gate_order), so the C fragment of lane (g, t) over the two
//   n16 chunks of octet o (units 8 o .. 8 o + 7) holds i, f, g, o of
//   units 8 o + 2 t + {0, 1} for rows g + 8 hh + 16 m: the lane runs the
//   cell for them in registers. h_t leaves as hi and lo into the other
//   pair of tiles; one barrier a step.
// - Backward: dh_{t-1} = dgates_t Wh^T, the product's K rows unit-major
//   (row 4 u + gate). Its A, dgates_t as hi and lo over all 4H, does not
//   fit in shared memory beside dc at H 256, so the step runs in two
//   halves of the units: warp q owns octet q of each half (units 8 q ..
//   and H / 2 + 8 q ..); per half, the gate math of the half's units
//   into the tile, then the product over the half's K rows into both of
//   the warp's output octets (Wh^T's columns paired on the host so that
//   one n16 chunk holds both). Four barriers a step; the dh of the step
//   after waits in registers beside the new one.
// - The saved gates and c are written in the lanes' own order (fragment
//   order, fused_bptt.py fragment_rows), so that each warp writes and
//   reads 1 KB runs; h, h_{t-1}, the heads' dh and dgates keep the
//   [T, S, H] layout the products around the kernels read.
// - The weights are bf16 B fragments (hi and lo) packed on the host in
//   mma order (ops.fused_actor.tc_fragments), 1.25 MB forward and 1 MB
//   backward at H 256, read from L2 every step; each block starts its
//   k-loop at its own k-step, so the blocks do not all ask the same
//   lines of L2 at once (measured on the single-product design: 17% off
//   the backward).
// - The gates are saved, not recomputed: a recomputing backward needs
//   the forward's operand tiles beside its dgates tiles and dc, more
//   than shared memory holds.
//
// LayerNorm (stable-baselines' layer-normalised cell, MlpLnLstmPolicy:
// gates = LN(t Wi; gx, bx) + LN(h Wh; gh, bh) + b, h = o tanh(LN(c'; gc,
// bc))): both kernels' bodies take it as a compile-time flag, and their
// LayerNorm instantiations are bptt_ln_forward_kernel and
// bptt_ln_backward_kernel. t Wi does not depend on the carry: it and its
// LayerNorm run outside over the whole window (ops/fused_bptt.py) and
// arrive as the gates' input side a_t (with b), f32 [T, S, H, 4]
// unit-major. LayerNorm needs each row's statistics over all 4H columns
// of h Wh before any unit's gate math, and over all H units of c' before
// any h', while the block's 16 warps own octets of units. The design:
// - Forward, three passes over the warp's octets a step. Pass 1 runs the
//   product h_{t-1} Wh (K = hp; the plain kernel's k-loop with no t
//   rows), writes y = h_{t-1} Wh to device memory (unit-major [T, S, H,
//   4], f32: saved for the backward and re-read by the same lane in pass
//   2, mostly from L2), and sums each of its rows' y and y^2. The sums go
//   through the quad (__shfl_xor_sync) and one shared-memory slot per
//   warp and row; after a barrier each of 64 threads adds its row's 16
//   slots and writes the row's mean and 1 / sqrt(var + 1e-5) (var =
//   E[y^2] - E[y]^2, clamped at 0; the real 4H columns only: a padded
//   unit's columns are zero) to shared memory and to the saved
//   statistics. Pass 2 normalises y, adds a_t, runs the gates and c'
//   (the plain cell's), writes the gates and c' as the plain kernel does
//   and sums c' and c'^2 the same way; pass 3 normalises c' (from the
//   shared carry tile) and reads the o gate back to make h'. Five
//   barriers a step where the plain kernel has one; the recomputation of
//   the product (a second pass of mma.sync) is what the saved y avoids.
// - Backward, LayerNorm's backward through c' and through h Wh adds the
//   row sums of dĉ and dĉ ĉ (over H) and of dŷ and dŷ ŷ (over 4H), each
//   reduced as the forward's statistics: a pass over both halves' units
//   for the first (dn, the gradient of LN(c')'s output, written for the
//   gains' gradients), a second for the pre-activation gradients dpre
//   (written f32: LayerNorm's backward of t Wi and the gains' and biases'
//   gradients run outside) and dc, then the plain kernel's two halves,
//   each making dy (y's gradient, from dpre re-read) into the A tile of
//   dh_{t-1} = dy_t Wh^T. Eight barriers a step where the plain has four.
// - A padded unit's gains and biases are zero, so its gates are those of
//   the plain kernel's zero columns and its c' and h' stay 0; every write
//   past S or H is skipped.
//
// C interface for ctypes; each entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "policy_common.cuh"

namespace {

using futbol::ldsm_x4;
using futbol::mma_bf16;
using futbol::pack_bf16;
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;          // sequences a block
constexpr int kWarps = 16;         // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kSmemLimit = 232448;
constexpr int kMaxUnits = 256;     // H (4H <= 1024): at most two octets a warp
constexpr float kLnEps = 1e-5f;    // stable-baselines' tf_layers._ln

// The LayerNorm forward's own arguments (module note); unused by the plain
// instantiation.
struct LnFwd {
  const float4* xin;   // [T, S, H] (i, f, g, o): LN(t Wi; gx, bx) + b
  const float* gh;     // [4 hp] in the gate columns' order, zero at padding
  const float* gc;     // [H]
  const float* bc;
  float4* y;           // [T, S, H] (i, f, g, o): h_{t-1} Wh before its norm
  float2* st_h;        // [T, S]: (mean, 1 / sqrt(var + eps)) of y's row
  float2* st_c;        // [T, S]: the same of c'
};

// The LayerNorm backward's own arguments.
struct LnBwd {
  const float4* y;
  const float2* st_h;
  const float2* st_c;
  const float4* gh;    // [H] (i, f, g, o), unit-major
  const float* gc;     // [H]
  const float* bc;
  float4* dpre;        // [T, S, H] (i, f, g, o): the gates' pre-activations'
  float* dn;           // [T, S, H]: LN(c')'s output's gradient
};

__device__ __forceinline__ float sigmoid_f(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}

__device__ __forceinline__ float tanh_f(float x) {
  return 2.0f * sigmoid_f(2.0f * x) - 1.0f;
}

// (x, y) as two bf16 pairs: hi = bf16(x, y), lo = bf16 of what hi leaves.
__device__ __forceinline__ void split_bf16(float x, float y, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

// d += (ah + al)(bh + bl) less al bl, on one m16n8k16 tile.
__device__ __forceinline__ void mma3(float (&d)[4], const unsigned (&ah)[4],
                                     const unsigned (&al)[4], unsigned bh0, unsigned bh1,
                                     unsigned bl0, unsigned bl1) {
  mma_bf16(d, al, bh0, bh1);
  mma_bf16(d, ah, bl0, bl1);
  mma_bf16(d, ah, bh0, bh1);
}

// This lane's row address for ldmatrix.x4 over a 16 x 16 tile.
__device__ __forceinline__ const bf16* lane_rows(const bf16* tile, int ld, int lane) {
  const int q = lane >> 3, r = lane & 7;
  return tile + ((q & 1) * 8 + r) * ld + (q >> 1) * 8;
}

// Where the saved state of octet o (units 8 o ..), rows 16 m + 8 hh + g
// (mh = 2 m + hh) and lane 4 g + t of block blk at `step` starts: two
// entries, units 8 o + 2 t + jl.
__device__ __forceinline__ size_t frag_at(int step, int blk, int nblk, int n_oct, int o,
                                          int mh, int lane) {
  return ((((static_cast<size_t>(step) * nblk + blk) * n_oct + o) * 8 + mh) * 32 + lane) *
         2;
}

// 1 where the lane's row 16 m + g + 8 hh carries its state past `step`
// (in the batch and its episode not done there), else 0.
__device__ __forceinline__ void keep_rows(float (&keep)[4][2],
                                          const unsigned char* __restrict__ done,
                                          int step, int row0, int S, int g) {
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int s = row0 + 16 * m + g + 8 * hh;
      keep[m][hh] =
          (s < S && done[static_cast<size_t>(step) * S + s] == 0) ? 1.0f : 0.0f;
    }
}

// Each lane's partial sums (x, y) of its rows 16 m + g + 8 hh, summed over
// the quad, into the warp's slot of each row: red[warp][row].
__device__ __forceinline__ void row_partials(const float2 (&p)[4][2], float2* red,
                                             int warp, int lane) {
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float x = p[m][hh].x, y = p[m][hh].y;
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      y += __shfl_xor_sync(0xffffffffu, y, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      y += __shfl_xor_sync(0xffffffffu, y, 2);
      if ((lane & 3) == 0) red[warp * kRows + 16 * m + (lane >> 2) + 8 * hh] = make_float2(x, y);
    }
}

// Thread r < 64: the means over n columns of row r's two sums, from the
// warps' slots. STATS: as (mean, 1 / sqrt(var + eps)) of a LayerNorm,
// also written to out at the row's sequence.
template <bool STATS>
__device__ __forceinline__ void row_means(const float2* red, float2* stat, int n,
                                          float2* out, size_t base, int row0, int S) {
  if (threadIdx.x < kRows) {
    const int r = threadIdx.x;
    float a = 0.0f, b = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float2 v = red[w * kRows + r];
      a += v.x;
      b += v.y;
    }
    const float nf = static_cast<float>(n);
    float2 v = make_float2(a / nf, b / nf);
    if (STATS) {
      v.y = 1.0f / sqrtf(fmaxf(v.y - v.x * v.x, 0.0f) + kLnEps);
      if (row0 + r < S) out[base + row0 + r] = v;
    }
    stat[r] = v;
  }
}

// ---------------------------------------------------------------------------
// Forward: gates_t = [t_t; h_{t-1}] [Wi; Wh] + b, the cell, the carry
// zeroed where done[t]. Writes the activated gates and c_t (fragment
// order), h_t before the reset, h_{t-1} (hi, lo) and the carry after the
// window.
// ---------------------------------------------------------------------------

// The LayerNorm forward's step after pass 1 (module note): y's
// statistics, pass 2 (the gates and c', c''s sums), c''s statistics,
// pass 3 (h', the carry's reset, h_t into the next tiles).
__device__ __forceinline__ void ln_cell_passes(
    const float* __restrict__ bh, float* __restrict__ c_all, float4* __restrict__ gates,
    float* __restrict__ h_all, bf16* __restrict__ hp_hi, bf16* __restrict__ hp_lo,
    float* __restrict__ h_last, float* cs, bf16* hnext, float2* red, float2* stat,
    float2 (&part)[4][2], const float (&keep)[4][2], const LnFwd& ln, int step,
    size_t base, int blk, int nblk, int row0, int S, int T, int hs, int hp, int warp,
    int lane) {
  const int ldh = hp + 8, ldc = hp + 8;
  const int g = lane >> 2, tq = lane & 3, n_oct = hp / 8;
  row_partials(part, red, warp, lane);
  __syncthreads();
  row_means<true>(red, stat, 4 * hs, ln.st_h, base, row0, S);
  __syncthreads();
#pragma unroll
  for (int m = 0; m < 4; ++m) part[m][0] = part[m][1] = make_float2(0.0f, 0.0f);
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 1
  for (int o = warp; o < n_oct; o += kWarps) {
    const int u0 = 8 * o + 2 * tq;
    float2 gif[2], ggo[2], bif[2], bgo[2];
#pragma unroll
    for (int jl = 0; jl < 2; ++jl) {
      const int col = 32 * o + 16 * jl + 2 * tq;   // i, f; + 8: g, o
      gif[jl] = __ldg(reinterpret_cast<const float2*>(ln.gh + col));
      ggo[jl] = __ldg(reinterpret_cast<const float2*>(ln.gh + col + 8));
      bif[jl] = __ldg(reinterpret_cast<const float2*>(bh + col));
      bgo[jl] = __ldg(reinterpret_cast<const float2*>(bh + col + 8));
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 16 * m + g + 8 * hh;
        const int s = row0 + r;
        const bool ok = s < S && u0 < hs;
        const float2 st = stat[r];
        float2* cr = reinterpret_cast<float2*>(cs + r * ldc + u0);
        const float2 cold = *cr;
        float cn[2];
        float4 gv[2];
#pragma unroll
        for (int jl = 0; jl < 2; ++jl) {
          const size_t at = (base + s) * hs + u0 + jl;
          const float4 y4 = ok ? ln.y[at] : zero4;
          const float4 a4 = ok ? __ldg(ln.xin + at) : zero4;
          const float gi = sigmoid_f(a4.x + (gif[jl].x * ((y4.x - st.x) * st.y) + bif[jl].x));
          const float gf = sigmoid_f(a4.y + (gif[jl].y * ((y4.y - st.x) * st.y) + bif[jl].y));
          const float gg = tanh_f(a4.z + (ggo[jl].x * ((y4.z - st.x) * st.y) + bgo[jl].x));
          const float go = sigmoid_f(a4.w + (ggo[jl].y * ((y4.w - st.x) * st.y) + bgo[jl].y));
          gv[jl] = make_float4(gi, gf, gg, go);
          cn[jl] = gf * (jl ? cold.y : cold.x) + gi * gg;
          part[m][hh].x += cn[jl];
          part[m][hh].y += cn[jl] * cn[jl];
        }
        *cr = make_float2(cn[0], cn[1]);   // c', reset in pass 3
        const size_t fi = frag_at(step, blk, nblk, n_oct, o, 2 * m + hh, lane);
        gates[fi] = gv[0];
        gates[fi + 1] = gv[1];
        *reinterpret_cast<float2*>(c_all + fi) = make_float2(cn[0], cn[1]);
      }
  }
  row_partials(part, red, warp, lane);
  __syncthreads();
  row_means<true>(red, stat + kRows, hs, ln.st_c, base, row0, S);
  __syncthreads();
#pragma unroll 1
  for (int o = warp; o < n_oct; o += kWarps) {
    const int u0 = 8 * o + 2 * tq;
    const float2 zero2 = make_float2(0.0f, 0.0f);
    const float2 gc = u0 < hs ? __ldg(reinterpret_cast<const float2*>(ln.gc + u0)) : zero2;
    const float2 bc = u0 < hs ? __ldg(reinterpret_cast<const float2*>(ln.bc + u0)) : zero2;
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 16 * m + g + 8 * hh;
        const int s = row0 + r;
        const float2 st = stat[kRows + r];
        float2* cr = reinterpret_cast<float2*>(cs + r * ldc + u0);
        const float2 cn = *cr;
        const size_t fi = frag_at(step, blk, nblk, n_oct, o, 2 * m + hh, lane);
        const float hn0 = gates[fi].w * tanh_f(gc.x * ((cn.x - st.x) * st.y) + bc.x);
        const float hn1 = gates[fi + 1].w * tanh_f(gc.y * ((cn.y - st.x) * st.y) + bc.y);
        const float k = keep[m][hh];
        *cr = make_float2(cn.x * k, cn.y * k);
        const float hk0 = hn0 * k, hk1 = hn1 * k;
        unsigned hi, lo;
        split_bf16(hk0, hk1, hi, lo);
        *reinterpret_cast<unsigned*>(hnext + r * ldh + u0) = hi;
        *reinterpret_cast<unsigned*>(hnext + (kRows + r) * ldh + u0) = lo;
        if (s < S && u0 < hs) {
          const size_t at = (base + s) * hs + u0;
          *reinterpret_cast<float2*>(h_all + at) = make_float2(hn0, hn1);
          if (step + 1 < T) {
            *reinterpret_cast<unsigned*>(hp_hi + at + static_cast<size_t>(S) * hs) = hi;
            *reinterpret_cast<unsigned*>(hp_lo + at + static_cast<size_t>(S) * hs) = lo;
          } else {
            *reinterpret_cast<float2*>(h_last + static_cast<size_t>(s) * hs + u0) =
                make_float2(hk0, hk1);
          }
        }
      }
  }
}

// LN: the LayerNorm instantiation (module note; kt = 0, tfrag unused, the
// bias is bh).
template <bool LN>
__device__ __forceinline__ void bptt_forward_body(
    const uint4* __restrict__ tfrag, const uint4* __restrict__ wf_hi,
    const uint4* __restrict__ wf_lo, const float* __restrict__ bias,
    const unsigned char* __restrict__ done, const float* __restrict__ c0,
    const float* __restrict__ h0, float4* __restrict__ gates, float* __restrict__ c_all,
    float* __restrict__ h_all, bf16* __restrict__ hp_hi, bf16* __restrict__ hp_lo,
    float* __restrict__ c_last, float* __restrict__ h_last, int S, int T, int kt, int hs,
    int hp, const LnFwd& ln) {
  extern __shared__ __align__(16) unsigned char smem_bptt_f[];
  const int ldh = hp + 8, ldc = hp + 8;
  // h_{t-1}: [2 buffers][hi, lo][64][ldh] bf16, then c [64][ldc] f32
  bf16* const hts = reinterpret_cast<bf16*>(smem_bptt_f);
  float* const cs = reinterpret_cast<float*>(hts + 4 * kRows * ldh);
  // LN: the warps' row sums [16][64], then the rows' statistics of y and c'
  float2* const red = reinterpret_cast<float2*>(cs + kRows * ldc);
  float2* const stat = red + kWarps * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int blk = blockIdx.x, nblk = gridDim.x, row0 = blk * kRows;
  const int n_oct = hp / 8, nj = hp / 4, nkt = LN ? 0 : kt / 16, nk = nkt + hp / 16;
  const int kofs = blk % nk;
  // step 0's h_{t-1}: h0 (hi and lo into buffer 0 and into hp_hi, hp_lo); c0
  for (int i = threadIdx.x; i < kRows * hp / 2; i += kThreads) {
    const int r = i / (hp / 2), u = 2 * (i - r * (hp / 2));
    const int s = row0 + r;
    const bool ok = s < S && u < hs;
    const size_t at = static_cast<size_t>(s) * hs + u;
    const float x = ok ? h0[at] : 0.0f, y = ok ? h0[at + 1] : 0.0f;
    unsigned hi, lo;
    split_bf16(x, y, hi, lo);
    *reinterpret_cast<unsigned*>(hts + r * ldh + u) = hi;
    *reinterpret_cast<unsigned*>(hts + (kRows + r) * ldh + u) = lo;
    if (ok) {
      *reinterpret_cast<unsigned*>(hp_hi + at) = hi;
      *reinterpret_cast<unsigned*>(hp_lo + at) = lo;
    }
    *reinterpret_cast<float2*>(cs + r * ldc + u) =
        ok ? make_float2(c0[at], c0[at + 1]) : make_float2(0.0f, 0.0f);
  }
  __syncthreads();
#pragma unroll 1
  for (int step = 0; step < T; ++step) {
    const bf16* const hcur = hts + 2 * (step & 1) * kRows * ldh;
    bf16* const hnext = hts + 2 * ((step & 1) ^ 1) * kRows * ldh;
    const bf16* const ah_rows = lane_rows(hcur, ldh, lane);
    const bf16* const al_rows = lane_rows(hcur + kRows * ldh, ldh, lane);
    // t_t's A fragments: [kt / 16][4 m][hi, lo][32 lanes] uint4
    const uint4* const tf =
        tfrag + (static_cast<size_t>(step) * nblk + blk) * nkt * 256 + lane;
    float keep[4][2];
    keep_rows(keep, done, step, row0, S, g);
    const size_t base = static_cast<size_t>(step) * S;
    float2 part[4][2];   // LN: the lane's row sums
    if constexpr (LN) {
#pragma unroll
      for (int m = 0; m < 4; ++m) part[m][0] = part[m][1] = make_float2(0.0f, 0.0f);
    }
#pragma unroll 1
    for (int o = warp; o < n_oct; o += kWarps) {
      float acc[4][4][4];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.0f;
      // chunks 2 o, 2 o + 1: i, f | g, o of units 8 o + 2 t + jl
#pragma unroll 2
      for (int k2 = 0; k2 < nk; ++k2) {
        const int kk = k2 + kofs < nk ? k2 + kofs : k2 + kofs - nk;
        const size_t wi = (static_cast<size_t>(kk) * nj + 2 * o) * 32 + lane;
        const uint4 bh0 = __ldg(wf_hi + wi), bh1 = __ldg(wf_hi + wi + 32);
        const uint4 bl0 = __ldg(wf_lo + wi), bl1 = __ldg(wf_lo + wi + 32);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          unsigned ah[4], al[4];
          if (kk < nkt) {
            const uint4 vh = __ldg(tf + (kk * 4 + m) * 64);
            const uint4 vl = __ldg(tf + (kk * 4 + m) * 64 + 32);
            ah[0] = vh.x, ah[1] = vh.y, ah[2] = vh.z, ah[3] = vh.w;
            al[0] = vl.x, al[1] = vl.y, al[2] = vl.z, al[3] = vl.w;
          } else {
            ldsm_x4(ah, ah_rows + 16 * m * ldh + 16 * (kk - nkt));
            ldsm_x4(al, al_rows + 16 * m * ldh + 16 * (kk - nkt));
          }
          mma3(acc[m][0], ah, al, bh0.x, bh0.y, bl0.x, bl0.y);
          mma3(acc[m][1], ah, al, bh0.z, bh0.w, bl0.z, bl0.w);
          mma3(acc[m][2], ah, al, bh1.x, bh1.y, bl1.x, bl1.y);
          mma3(acc[m][3], ah, al, bh1.z, bh1.w, bl1.z, bl1.w);
        }
      }
      const int u0 = 8 * o + 2 * tq;
      if constexpr (LN) {
        // pass 1: y saved, its rows' sums
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int s = row0 + 16 * m + g + 8 * hh;
#pragma unroll
            for (int jl = 0; jl < 2; ++jl) {
              const float4 y4 =
                  make_float4(acc[m][2 * jl][2 * hh], acc[m][2 * jl][2 * hh + 1],
                              acc[m][2 * jl + 1][2 * hh], acc[m][2 * jl + 1][2 * hh + 1]);
              part[m][hh].x += (y4.x + y4.y) + (y4.z + y4.w);
              part[m][hh].y += (y4.x * y4.x + y4.y * y4.y) + (y4.z * y4.z + y4.w * y4.w);
              if (s < S && u0 < hs) ln.y[(base + s) * hs + u0 + jl] = y4;
            }
          }
        continue;
      }
      float2 bif[2], bgo[2];
#pragma unroll
      for (int jl = 0; jl < 2; ++jl) {
        const int col = 32 * o + 16 * jl + 2 * tq;   // i, f; + 8: g, o
        bif[jl] = __ldg(reinterpret_cast<const float2*>(bias + col));
        bgo[jl] = __ldg(reinterpret_cast<const float2*>(bias + col + 8));
      }
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = 16 * m + g + 8 * hh;
          const int s = row0 + r;
          float2* cr = reinterpret_cast<float2*>(cs + r * ldc + u0);
          const float2 cold = *cr;
          float cn[2], hn[2];
          float4 gv[2];
#pragma unroll
          for (int jl = 0; jl < 2; ++jl) {
            const float gi = sigmoid_f(acc[m][2 * jl][2 * hh] + bif[jl].x);
            const float gf = sigmoid_f(acc[m][2 * jl][2 * hh + 1] + bif[jl].y);
            const float gg = tanh_f(acc[m][2 * jl + 1][2 * hh] + bgo[jl].x);
            const float go = sigmoid_f(acc[m][2 * jl + 1][2 * hh + 1] + bgo[jl].y);
            gv[jl] = make_float4(gi, gf, gg, go);
            cn[jl] = gf * (jl ? cold.y : cold.x) + gi * gg;
            hn[jl] = go * tanh_f(cn[jl]);
          }
          const float k = keep[m][hh];
          *cr = make_float2(cn[0] * k, cn[1] * k);
          const float hk0 = hn[0] * k, hk1 = hn[1] * k;
          unsigned hi, lo;
          split_bf16(hk0, hk1, hi, lo);
          *reinterpret_cast<unsigned*>(hnext + r * ldh + u0) = hi;
          *reinterpret_cast<unsigned*>(hnext + (kRows + r) * ldh + u0) = lo;
          const size_t fi = frag_at(step, blk, nblk, n_oct, o, 2 * m + hh, lane);
          gates[fi] = gv[0];
          gates[fi + 1] = gv[1];
          *reinterpret_cast<float2*>(c_all + fi) = make_float2(cn[0], cn[1]);
          if (s < S && u0 < hs) {
            const size_t at = (base + s) * hs + u0;
            *reinterpret_cast<float2*>(h_all + at) = make_float2(hn[0], hn[1]);
            if (step + 1 < T) {
              *reinterpret_cast<unsigned*>(hp_hi + at + static_cast<size_t>(S) * hs) = hi;
              *reinterpret_cast<unsigned*>(hp_lo + at + static_cast<size_t>(S) * hs) = lo;
            } else {
              *reinterpret_cast<float2*>(h_last + static_cast<size_t>(s) * hs + u0) =
                  make_float2(hk0, hk1);
            }
          }
        }
    }
    if constexpr (LN) ln_cell_passes(bias, c_all, gates, h_all, hp_hi, hp_lo, h_last, cs,
                                     hnext, red, stat, part, keep, ln, step, base, blk,
                                     nblk, row0, S, T, hs, hp, warp, lane);
    __syncthreads();   // h_t is in the other tiles; these are free
  }
  for (int i = threadIdx.x; i < kRows * hp / 2; i += kThreads) {
    const int r = i / (hp / 2), u = 2 * (i - r * (hp / 2));
    const int s = row0 + r;
    if (s < S && u < hs)
      *reinterpret_cast<float2*>(c_last + static_cast<size_t>(s) * hs + u) =
          *reinterpret_cast<const float2*>(cs + r * ldc + u);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
bptt_forward_kernel(const uint4* __restrict__ tfrag, const uint4* __restrict__ wf_hi,
                    const uint4* __restrict__ wf_lo, const float* __restrict__ bias,
                    const unsigned char* __restrict__ done, const float* __restrict__ c0,
                    const float* __restrict__ h0, float4* __restrict__ gates,
                    float* __restrict__ c_all, float* __restrict__ h_all,
                    bf16* __restrict__ hp_hi, bf16* __restrict__ hp_lo,
                    float* __restrict__ c_last, float* __restrict__ h_last, int S, int T,
                    int kt, int hs, int hp) {
  bptt_forward_body<false>(tfrag, wf_hi, wf_lo, bias, done, c0, h0, gates, c_all, h_all,
                           hp_hi, hp_lo, c_last, h_last, S, T, kt, hs, hp, LnFwd{});
}

__global__ void __launch_bounds__(kThreads, 1)
bptt_ln_forward_kernel(const uint4* __restrict__ wf_hi, const uint4* __restrict__ wf_lo,
                       const float* __restrict__ bh, const unsigned char* __restrict__ done,
                       const float* __restrict__ c0, const float* __restrict__ h0,
                       float4* __restrict__ gates, float* __restrict__ c_all,
                       float* __restrict__ h_all, bf16* __restrict__ hp_hi,
                       bf16* __restrict__ hp_lo, float* __restrict__ c_last,
                       float* __restrict__ h_last, int S, int T, int hs, int hp,
                       const LnFwd ln) {
  bptt_forward_body<true>(nullptr, wf_hi, wf_lo, bh, done, c0, h0, gates, c_all, h_all,
                          hp_hi, hp_lo, c_last, h_last, S, T, 0, hs, hp, ln);
}

// ---------------------------------------------------------------------------
// Backward: from the gradient of every h_t (the heads'), t = T-1 .. 0,
// the pre-activation gradients dgates_t (hi, lo) and the carries' dc, dh
// through the resets; dh_{t-1} = dgates_t Wh^T on the tensor cores, in
// two halves of the units.
// ---------------------------------------------------------------------------

// The LayerNorm backward's loads for the lane's units u0, u0 + 1 of row
// r at `step`: the saved gates, c', c_{t-1} (reset), the heads' dh and
// the gradient reaching h_t (dh), and LN(c')'s normalised input ĉ, tanh
// of its output tn, and dn.
struct LnUnits {
  float4 gv[2];
  float cp[2], dh[2], chat[2], tn[2], dn[2];
};

__device__ __forceinline__ LnUnits ln_units(const float4* __restrict__ gates,
                                            const float* __restrict__ c_all,
                                            const float* __restrict__ c0,
                                            const float* __restrict__ dh_all,
                                            float2 dhn, float2 sc, float2 gc,
                                            float2 bc, float k, float kp, int step,
                                            size_t base, size_t fi, size_t fi_prev, int s,
                                            int u0, int hs, bool ok) {
  LnUnits v;
  v.gv[0] = gates[fi];
  v.gv[1] = gates[fi + 1];
  const float2 ct = *reinterpret_cast<const float2*>(c_all + fi);
  float2 cp = make_float2(0.0f, 0.0f), dha = make_float2(0.0f, 0.0f);
  if (step > 0) {
    cp = *reinterpret_cast<const float2*>(c_all + fi_prev);
    cp.x = cp.x * kp;
    cp.y = cp.y * kp;
  } else if (ok) {
    cp = *reinterpret_cast<const float2*>(c0 + static_cast<size_t>(s) * hs + u0);
  }
  if (ok) dha = *reinterpret_cast<const float2*>(dh_all + (base + s) * hs + u0);
#pragma unroll
  for (int jl = 0; jl < 2; ++jl) {
    v.cp[jl] = jl ? cp.y : cp.x;
    v.dh[jl] = (jl ? dha.y : dha.x) + k * (jl ? dhn.y : dhn.x);
    v.chat[jl] = ((jl ? ct.y : ct.x) - sc.x) * sc.y;
    v.tn[jl] = tanh_f((jl ? gc.y : gc.x) * v.chat[jl] + (jl ? bc.y : bc.x));
    v.dn[jl] = ok ? v.dh[jl] * v.gv[jl].w * (1.0f - v.tn[jl] * v.tn[jl]) : 0.0f;
  }
  return v;
}

// The LayerNorm backward's step before the two halves' products (module
// note): dn and the row means of (dĉ, dĉ ĉ); then dpre and dc, and the
// row means of (dŷ, dŷ ŷ) into stat[kRows ..].
__device__ __forceinline__ void ln_backward_passes(
    const float4* __restrict__ gates, const float* __restrict__ c_all,
    const float* __restrict__ c0, const float* __restrict__ dh_all, float* dcs, float2* red,
    float2* stat, const float (&dhn)[4][2][4], const float (&keep)[4][2],
    const float (&keep_prev)[4][2], const LnBwd& ln, int step, size_t base, int blk,
    int nblk, int row0, int S, int hs, int hp, int warp, int lane) {
  const int ldc = hp + 8;
  const int g = lane >> 2, tq = lane & 3, n_oct = hp / 8, half_oct = n_oct / 2;
  const float2 zero2 = make_float2(0.0f, 0.0f);
  float2 part[4][2];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int m = 0; m < 4; ++m) part[m][0] = part[m][1] = zero2;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (warp >= half_oct) break;
      const int o = hf * half_oct + warp;
      const int u0 = 8 * o + 2 * tq;
      const bool uok = u0 < hs;
      const float2 gc = uok ? __ldg(reinterpret_cast<const float2*>(ln.gc + u0)) : zero2;
      const float2 bc = uok ? __ldg(reinterpret_cast<const float2*>(ln.bc + u0)) : zero2;
      const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float4 gh[2] = {zero4, zero4};
      if (pass == 1 && uok) {
        gh[0] = __ldg(ln.gh + u0);
        gh[1] = __ldg(ln.gh + u0 + 1);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = 16 * m + g + 8 * hh;
          const int s = row0 + r;
          const bool ok = s < S && uok;
          const float2 sc = s < S ? ln.st_c[base + s] : zero2;
          const size_t fi = frag_at(step, blk, nblk, n_oct, o, 2 * m + hh, lane);
          const size_t fp = step > 0 ? frag_at(step - 1, blk, nblk, n_oct, o, 2 * m + hh, lane)
                                     : 0;
          const LnUnits v =
              ln_units(gates, c_all, c0, dh_all,
                       make_float2(dhn[m][hf][2 * hh], dhn[m][hf][2 * hh + 1]), sc, gc, bc,
                       keep[m][hh],
                       keep_prev[m][hh], step, base, fi, fp, s, u0, hs, ok);
          if (pass == 0) {
#pragma unroll
            for (int jl = 0; jl < 2; ++jl) {
              const float dchat = v.dn[jl] * (jl ? gc.y : gc.x);
              part[m][hh].x += dchat;
              part[m][hh].y += dchat * v.chat[jl];
            }
            if (ok)
              *reinterpret_cast<float2*>(ln.dn + (base + s) * hs + u0) =
                  make_float2(v.dn[0], v.dn[1]);
            continue;
          }
          const float2 mc = stat[r];
          const float2 sh = s < S ? ln.st_h[base + s] : zero2;
          float2* dcr = reinterpret_cast<float2*>(dcs + r * ldc + u0);
          const float2 dco = *dcr;
          float dcn[2];
#pragma unroll
          for (int jl = 0; jl < 2; ++jl) {
            const float4 gt = v.gv[jl];
            const float dchat = v.dn[jl] * (jl ? gc.y : gc.x);
            const float dcv =
                keep[m][hh] * (jl ? dco.y : dco.x) +
                ((dchat - mc.x) - v.chat[jl] * mc.y) * sc.y;
            float4 d = make_float4(dcv * gt.z * (gt.x * (1.0f - gt.x)),
                                   dcv * v.cp[jl] * (gt.y * (1.0f - gt.y)),
                                   dcv * gt.x * (1.0f - gt.z * gt.z),
                                   v.dh[jl] * v.tn[jl] * (gt.w * (1.0f - gt.w)));
            if (!ok) d = zero4;
            dcn[jl] = ok ? dcv * gt.y : 0.0f;
            const size_t at = (base + s) * hs + u0 + jl;
            const float4 y4 = ok ? ln.y[at] : zero4;
            const float4 yh = make_float4((y4.x - sh.x) * sh.y, (y4.y - sh.x) * sh.y,
                                          (y4.z - sh.x) * sh.y, (y4.w - sh.x) * sh.y);
            const float4 dy = make_float4(d.x * gh[jl].x, d.y * gh[jl].y, d.z * gh[jl].z,
                                          d.w * gh[jl].w);
            part[m][hh].x += (dy.x + dy.y) + (dy.z + dy.w);
            part[m][hh].y += (dy.x * yh.x + dy.y * yh.y) + (dy.z * yh.z + dy.w * yh.w);
            if (ok) ln.dpre[at] = d;
          }
          *dcr = make_float2(dcn[0], dcn[1]);
        }
    }
    row_partials(part, red, warp, lane);
    __syncthreads();
    row_means<false>(red, stat + pass * kRows, pass ? 4 * hs : hs, nullptr, 0, row0, S);
    __syncthreads();
  }
}

// The LayerNorm backward's dy for the lane's units u0, u0 + 1 of row r,
// from dpre and y (both re-read) and its row's means: its hi and lo terms
// into the half's A tile (units ul ..) and to dy_hi, dy_lo.
__device__ __forceinline__ void ln_dy_tile(bf16* dhi, bf16* dlo, uint4* __restrict__ dy_hi,
                                           uint4* __restrict__ dy_lo, const float2* stat,
                                           const LnBwd& ln, size_t base, int r, int s,
                                           bool ok, int ldd, int u0, int ul, int hs) {
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float2 md = stat[kRows + r];
  unsigned hi[4], lo[4];
#pragma unroll
  for (int jl = 0; jl < 2; ++jl) {
    float4 dy = zero4;
    if (ok) {
      const size_t at = (base + s) * hs + u0 + jl;
      const float2 st = ln.st_h[base + s];
      const float4 d = ln.dpre[at], y4 = ln.y[at], g4 = __ldg(ln.gh + u0 + jl);
      const float4 yh = make_float4((y4.x - st.x) * st.y, (y4.y - st.x) * st.y,
                                    (y4.z - st.x) * st.y, (y4.w - st.x) * st.y);
      dy = make_float4(((d.x * g4.x - md.x) - yh.x * md.y) * st.y,
                       ((d.y * g4.y - md.x) - yh.y * md.y) * st.y,
                       ((d.z * g4.z - md.x) - yh.z * md.y) * st.y,
                       ((d.w * g4.w - md.x) - yh.w * md.y) * st.y);
    }
    split_bf16(dy.x, dy.y, hi[2 * jl], lo[2 * jl]);
    split_bf16(dy.z, dy.w, hi[2 * jl + 1], lo[2 * jl + 1]);
  }
  const uint4 vh = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  const uint4 vl = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  *reinterpret_cast<uint4*>(dhi + r * ldd + 4 * ul) = vh;
  *reinterpret_cast<uint4*>(dlo + r * ldd + 4 * ul) = vl;
  if (ok) {
    dy_hi[((base + s) * hs + u0) / 2] = vh;
    dy_lo[((base + s) * hs + u0) / 2] = vl;
  }
}

// LN: the LayerNorm instantiation (module note): dg_hi, dg_lo take dy,
// the gradient of h_{t-1} Wh, where the plain kernel's take dgates.
template <bool LN>
__device__ __forceinline__ void bptt_backward_body(
    const float4* __restrict__ gates, const float* __restrict__ c_all,
    const float* __restrict__ c0, const unsigned char* __restrict__ done,
    const float* __restrict__ dh_all, const uint4* __restrict__ wb_hi,
    const uint4* __restrict__ wb_lo, uint4* __restrict__ dg_hi, uint4* __restrict__ dg_lo,
    int S, int T, int hs, int hp, const LnBwd& ln) {
  extern __shared__ __align__(16) unsigned char smem_bptt_b[];
  const int ldd = 2 * hp + 8, ldc = hp + 8;
  // dgates of half the units: [hi, lo][64][ldd] bf16, then dc [64][ldc] f32
  bf16* const dhi = reinterpret_cast<bf16*>(smem_bptt_b);
  bf16* const dlo = dhi + kRows * ldd;
  float* const dcs = reinterpret_cast<float*>(dlo + kRows * ldd);
  // LN: the warps' row sums [16][64], then the rows' means of (dĉ, dĉ ĉ)
  // and of (dŷ, dŷ ŷ)
  float2* const red = reinterpret_cast<float2*>(dcs + kRows * ldc);
  float2* const stat = red + kWarps * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* const ah_rows = lane_rows(dhi, ldd, lane);
  const bf16* const al_rows = lane_rows(dlo, ldd, lane);
  const int g = lane >> 2, tq = lane & 3;
  const int blk = blockIdx.x, nblk = gridDim.x, row0 = blk * kRows;
  const int n_oct = hp / 8, half_oct = n_oct / 2, nj = hp / 16, nkh = hp / 8;
  const int kofs = blk % nkh;
  const int q = warp;                      // octet q of each half
  const bool active = q < half_oct;
  // [m][half][2 hh + jl]: dh from the step after (dhn) and the one this
  // step's product makes (acc)
  float dhn[4][2][4], acc[4][2][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 4; ++e) dhn[m][hf][e] = acc[m][hf][e] = 0.0f;
  for (int i = threadIdx.x; i < kRows * ldc; i += kThreads) dcs[i] = 0.0f;
  __syncthreads();
#pragma unroll 1
  for (int step = T - 1; step >= 0; --step) {
    float keep[4][2], keep_prev[4][2];
    keep_rows(keep, done, step, row0, S, g);
    if (step > 0) {
      keep_rows(keep_prev, done, step - 1, row0, S, g);
    } else {
#pragma unroll
      for (int m = 0; m < 4; ++m) keep_prev[m][0] = keep_prev[m][1] = 1.0f;
    }
    const size_t base = static_cast<size_t>(step) * S;
    if constexpr (LN)
      ln_backward_passes(gates, c_all, c0, dh_all, dcs, red, stat, dhn, keep, keep_prev, ln,
                         step, base, blk, nblk, row0, S, hs, hp, warp, lane);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (active) {
        const int o = hf * half_oct + q;
        const int u0 = 8 * o + 2 * tq, ul = 8 * q + 2 * tq;
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = 16 * m + g + 8 * hh;
            const int s = row0 + r;
            const bool ok = s < S && u0 < hs;
            if constexpr (LN) {
              ln_dy_tile(dhi, dlo, dg_hi, dg_lo, stat, ln, base, r, s, ok, ldd, u0, ul, hs);
              continue;
            }
            const size_t fi = frag_at(step, blk, nblk, n_oct, o, 2 * m + hh, lane);
            const float4 gv[2] = {gates[fi], gates[fi + 1]};
            const float2 ct = *reinterpret_cast<const float2*>(c_all + fi);
            float2 cp = make_float2(0.0f, 0.0f), dha = make_float2(0.0f, 0.0f);
            if (step > 0) {
              cp = *reinterpret_cast<const float2*>(
                  c_all + frag_at(step - 1, blk, nblk, n_oct, o, 2 * m + hh, lane));
              cp.x = cp.x * keep_prev[m][hh];
              cp.y = cp.y * keep_prev[m][hh];
            } else if (ok) {
              cp = *reinterpret_cast<const float2*>(c0 + static_cast<size_t>(s) * hs + u0);
            }
            if (ok) dha = *reinterpret_cast<const float2*>(dh_all + (base + s) * hs + u0);
            float2* dcr = reinterpret_cast<float2*>(dcs + r * ldc + u0);
            const float2 dco = *dcr;
            float dcn[2];
            float4 d[2];
            unsigned hi[4], lo[4];   // dgates of units u0, u0 + 1: i, f | g, o
#pragma unroll
            for (int jl = 0; jl < 2; ++jl) {
              const float4 gt = gv[jl];
              const float k = keep[m][hh];
              const float dh = (jl ? dha.y : dha.x) + k * dhn[m][hf][2 * hh + jl];
              const float tc = tanh_f(jl ? ct.y : ct.x);
              const float dcv = k * (jl ? dco.y : dco.x) + dh * gt.w * (1.0f - tc * tc);
              d[jl] = make_float4(dcv * gt.z * (gt.x * (1.0f - gt.x)),
                                  dcv * (jl ? cp.y : cp.x) * (gt.y * (1.0f - gt.y)),
                                  dcv * gt.x * (1.0f - gt.z * gt.z),
                                  dh * tc * (gt.w * (1.0f - gt.w)));
              dcn[jl] = dcv * gt.y;
              split_bf16(d[jl].x, d[jl].y, hi[2 * jl], lo[2 * jl]);
              split_bf16(d[jl].z, d[jl].w, hi[2 * jl + 1], lo[2 * jl + 1]);
            }
            *dcr = make_float2(dcn[0], dcn[1]);
            const uint4 vh = make_uint4(hi[0], hi[1], hi[2], hi[3]);
            const uint4 vl = make_uint4(lo[0], lo[1], lo[2], lo[3]);
            *reinterpret_cast<uint4*>(dhi + r * ldd + 4 * ul) = vh;
            *reinterpret_cast<uint4*>(dlo + r * ldd + 4 * ul) = vl;
            if (ok) {
              dg_hi[((base + s) * hs + u0) / 2] = vh;
              dg_lo[((base + s) * hs + u0) / 2] = vl;
            }
          }
      }
      __syncthreads();   // the half's dgates_t are in the tiles
      if (step > 0 && active) {
        if (hf == 0) {
#pragma unroll
          for (int m = 0; m < 4; ++m)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.0f;
        }
#pragma unroll 2
        for (int k2 = 0; k2 < nkh; ++k2) {
          const int kk = k2 + kofs < nkh ? k2 + kofs : k2 + kofs - nkh;
          const size_t wi = (static_cast<size_t>(hf * nkh + kk) * nj + q) * 32 + lane;
          const uint4 bh = __ldg(wb_hi + wi), bl = __ldg(wb_lo + wi);
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            unsigned ah[4], al[4];
            ldsm_x4(ah, ah_rows + 16 * m * ldd + 16 * kk);
            ldsm_x4(al, al_rows + 16 * m * ldd + 16 * kk);
            mma3(acc[m][0], ah, al, bh.x, bh.y, bl.x, bl.y);
            mma3(acc[m][1], ah, al, bh.z, bh.w, bl.z, bl.w);
          }
        }
      }
      __syncthreads();   // every read of the tiles is done
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dhn[m][j][e] = acc[m][j][e];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
bptt_backward_kernel(const float4* __restrict__ gates, const float* __restrict__ c_all,
                     const float* __restrict__ c0, const unsigned char* __restrict__ done,
                     const float* __restrict__ dh_all, const uint4* __restrict__ wb_hi,
                     const uint4* __restrict__ wb_lo, uint4* __restrict__ dg_hi,
                     uint4* __restrict__ dg_lo, int S, int T, int hs, int hp) {
  bptt_backward_body<false>(gates, c_all, c0, done, dh_all, wb_hi, wb_lo, dg_hi, dg_lo, S,
                            T, hs, hp, LnBwd{});
}

__global__ void __launch_bounds__(kThreads, 1)
bptt_ln_backward_kernel(const float4* __restrict__ gates, const float* __restrict__ c_all,
                        const float* __restrict__ c0, const unsigned char* __restrict__ done,
                        const float* __restrict__ dh_all, const uint4* __restrict__ wb_hi,
                        const uint4* __restrict__ wb_lo, uint4* __restrict__ dy_hi,
                        uint4* __restrict__ dy_lo, int S, int T, int hs, int hp,
                        const LnBwd ln) {
  bptt_backward_body<true>(gates, c_all, c0, done, dh_all, wb_hi, wb_lo, dy_hi, dy_lo, S, T,
                           hs, hp, ln);
}

bool shape_ok(int S, int T, int hs) {
  return S >= 1 && T >= 1 && hs >= 4 && hs % 4 == 0 && hs <= kMaxUnits;
}

size_t forward_smem(int hp) {
  return 4 * static_cast<size_t>(kRows) * (hp + 8) * sizeof(bf16) +
         static_cast<size_t>(kRows) * (hp + 8) * sizeof(float);
}

size_t backward_smem(int hp) {
  return 2 * static_cast<size_t>(kRows) * (2 * hp + 8) * sizeof(bf16) +
         static_cast<size_t>(kRows) * (hp + 8) * sizeof(float);
}

// LayerNorm's shared memory after either kernel's: the warps' row sums
// and two sets of the rows' statistics.
constexpr size_t kLnSmem = static_cast<size_t>(kWarps + 2) * kRows * sizeof(float2);

}  // namespace

extern "C" {

// t's A fragments: [T, ceil(S / 64), kt / 16, 4, 2 (hi, lo), 32] 16-byte
// units. Forward fragments (hi and lo, n_frag 16-byte units each):
// [kt + hp, 4 hp] (Wi's rows, zero rows to kt, Wh's rows, zero rows to
// hp; K5's gate columns). The saved gates and c: [T, ceil(S / 64), hp /
// 8, 8, 32, 2] entries of 4 and 1 floats (fragment order).
int futbol_bptt_forward_tc(const void* tfrag, const void* wf_hi, const void* wf_lo,
                           int n_frag, const float* bias, const unsigned char* done,
                           const float* c0, const float* h0, float* gates, float* c_all,
                           float* h_all, void* hp_hi, void* hp_lo, float* c_last,
                           float* h_last, int S, int T, int kt, int hs, void* stream) {
  if (!shape_ok(S, T, hs) || kt < 16 || kt % 16 != 0) return cudaErrorInvalidValue;
  const int hp = (hs + 15) / 16 * 16;
  const size_t smem = forward_smem(hp);
  if (n_frag != (kt + hp) * 4 * hp / 8 || smem > static_cast<size_t>(kSmemLimit))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bptt_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  bptt_forward_kernel<<<(S + kRows - 1) / kRows, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(tfrag), static_cast<const uint4*>(wf_hi),
      static_cast<const uint4*>(wf_lo), bias, done, c0, h0, reinterpret_cast<float4*>(gates),
      c_all, h_all, static_cast<bf16*>(hp_hi), static_cast<bf16*>(hp_lo), c_last, h_last,
      S, T, kt, hs, hp);
  return cudaGetLastError();
}

// Backward fragments (hi and lo, n_frag 16-byte units each): Wh^T as [4
// hp, hp], row 4 u' + gate; n16 chunk j's columns units 8 j .. 8 j + 7
// and hp / 2 + 8 j .. hp / 2 + 8 j + 7. dgates: hi and lo, bf16 [T, S,
// H, 4].
int futbol_bptt_backward_tc(const float* gates, const float* c_all, const float* c0,
                            const unsigned char* done, const float* dh_all,
                            const void* wb_hi, const void* wb_lo, int n_frag, void* dg_hi,
                            void* dg_lo, int S, int T, int hs, void* stream) {
  if (!shape_ok(S, T, hs)) return cudaErrorInvalidValue;
  const int hp = (hs + 15) / 16 * 16;
  const size_t smem = backward_smem(hp);
  if (n_frag != 4 * hp * hp / 8 || smem > static_cast<size_t>(kSmemLimit))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bptt_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  bptt_backward_kernel<<<(S + kRows - 1) / kRows, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(gates), c_all, c0, done, dh_all,
      static_cast<const uint4*>(wb_hi), static_cast<const uint4*>(wb_lo),
      static_cast<uint4*>(dg_hi), static_cast<uint4*>(dg_lo), S, T, hs, hp);
  return cudaGetLastError();
}

// The LayerNorm forward (module note): the gates' input side xin, f32 [T,
// S, H, 4]; Wh's fragments alone ([hp, 4 hp], kt = 0); gh and bh in the
// gate columns' order [4 hp], gc and bc [H]; besides the plain kernel's
// outputs, y = h_{t-1} Wh [T, S, H, 4] and the statistics of y's and c''s
// rows, float2 [T, S] each.
int futbol_bptt_ln_forward_tc(const void* xin, const void* wf_hi, const void* wf_lo,
                              int n_frag, const float* gh, const float* bh, const float* gc,
                              const float* bc, const unsigned char* done, const float* c0,
                              const float* h0, float* gates, float* c_all, float* h_all,
                              void* hp_hi, void* hp_lo, float* c_last, float* h_last,
                              void* y, void* st_h, void* st_c, int S, int T, int hs,
                              void* stream) {
  if (!shape_ok(S, T, hs)) return cudaErrorInvalidValue;
  const int hp = (hs + 15) / 16 * 16;
  const size_t smem = forward_smem(hp) + kLnSmem;
  if (n_frag != hp * 4 * hp / 8 || smem > static_cast<size_t>(kSmemLimit))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(bptt_ln_forward_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const LnFwd ln{static_cast<const float4*>(xin), gh, gc, bc, static_cast<float4*>(y),
                 static_cast<float2*>(st_h), static_cast<float2*>(st_c)};
  bptt_ln_forward_kernel<<<(S + kRows - 1) / kRows, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(wf_hi), static_cast<const uint4*>(wf_lo), bh, done, c0, h0,
      reinterpret_cast<float4*>(gates), c_all, h_all, static_cast<bf16*>(hp_hi),
      static_cast<bf16*>(hp_lo), c_last, h_last, S, T, hs, hp, ln);
  return cudaGetLastError();
}

// The LayerNorm backward (module note): the forward's gates, c', y and
// statistics, gh [H, 4] unit-major, gc and bc [H]; dy (hi, lo: bf16 [T,
// S, H, 4]) where the plain kernel writes dgates, dpre f32 [T, S, H, 4]
// and dn f32 [T, S, H].
int futbol_bptt_ln_backward_tc(const float* gates, const float* c_all, const float* c0,
                               const unsigned char* done, const float* dh_all,
                               const void* wb_hi, const void* wb_lo, int n_frag, void* dy_hi,
                               void* dy_lo, const void* y, const void* st_h,
                               const void* st_c, const void* gh, const float* gc,
                               const float* bc, void* dpre, float* dn, int S, int T, int hs,
                               void* stream) {
  if (!shape_ok(S, T, hs)) return cudaErrorInvalidValue;
  const int hp = (hs + 15) / 16 * 16;
  const size_t smem = backward_smem(hp) + kLnSmem;
  if (n_frag != 4 * hp * hp / 8 || smem > static_cast<size_t>(kSmemLimit))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(bptt_ln_backward_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const LnBwd ln{static_cast<const float4*>(y), static_cast<const float2*>(st_h),
                 static_cast<const float2*>(st_c), static_cast<const float4*>(gh), gc, bc,
                 static_cast<float4*>(dpre), dn};
  bptt_ln_backward_kernel<<<(S + kRows - 1) / kRows, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(gates), c_all, c0, done, dh_all,
      static_cast<const uint4*>(wb_hi), static_cast<const uint4*>(wb_lo),
      static_cast<uint4*>(dy_hi), static_cast<uint4*>(dy_lo), S, T, hs, hp, ln);
  return cudaGetLastError();
}

}  // extern "C"
