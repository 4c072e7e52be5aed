// Device helpers of the policy kernels (fused_policy.cu: collect_kernel,
// selfplay_kernel; fused_recurrent.cu: recurrent_kernel): one block of
// kBlock envs (lane l of warp 0 owns env blockIdx.x * kBlock + l) and
// kWarps warps sharing each dense layer over the envs' activation columns
// in dynamic shared memory, laid out [row][env] so a warp's accesses hit
// 32 distinct banks.
//
// Every product and sum is rounded as the plain PyTorch versions round
// them (ops/fused_actor.py dense_rows): build with --fmad=false.
//
// At the end, the tensor-core helpers of the bf16 route
// (fused_policy_tc.cu): ldmatrix and mma.sync.m16n8k16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "futbol_step.cuh"

namespace futbol {

constexpr int kBlock = 32;      // envs per block: one per lane of warp 0
constexpr int kWarps = 4;       // warps per block, sharing each dense layer
constexpr int kThreads = kWarps * kBlock;
constexpr int kChunk = 16;      // outputs per register tile
constexpr int kMaxLayers = 8;   // dense layers per MLP
constexpr int kChoices = 5;     // every action slot is a 5-way choice

// A flat MLP: layer l reads in[l] inputs and writes out_pad[l] outputs
// (the true width padded with zero columns to a multiple of kChunk);
// W_l is [in, out_pad] row-major at w_off[l], b_l [out_pad] at b_off[l].
struct Mlp {
  int n_layers;
  int in[kMaxLayers], out_pad[kMaxLayers], w_off[kMaxLayers], b_off[kMaxLayers];
};

// Observation scales, f32 reciprocals formed on the host.
struct ObsConsts {
  float inv_w, inv_h, inv_s;
};

// One env's activation column: row r at col[r * kBlock].
struct Column {
  float* a;
  float* b;
};

// y = x @ W + b over one env's column (x and y distinct), tanh if asked,
// for the output chunks o0 = o_begin, o_begin + o_step, ...
__device__ __forceinline__ void dense(const float* __restrict__ w,
                                      const float* __restrict__ bias, int in,
                                      int out_pad, const float* x, float* y,
                                      bool apply_tanh, int o_begin, int o_step) {
#pragma unroll 1
  for (int o0 = o_begin; o0 < out_pad; o0 += o_step) {
    float acc[kChunk];
    const float x0 = x[0];
#pragma unroll
    for (int q = 0; q < kChunk / 4; ++q) {
      const float4 wv = __ldg(reinterpret_cast<const float4*>(w + o0) + q);
      acc[4 * q] = wv.x * x0;
      acc[4 * q + 1] = wv.y * x0;
      acc[4 * q + 2] = wv.z * x0;
      acc[4 * q + 3] = wv.w * x0;
    }
#pragma unroll 4
    for (int k = 1; k < in; ++k) {
      const float xk = x[k * kBlock];
      const float4* row =
          reinterpret_cast<const float4*>(w + static_cast<size_t>(k) * out_pad + o0);
#pragma unroll
      for (int q = 0; q < kChunk / 4; ++q) {
        const float4 wv = __ldg(row + q);
        acc[4 * q] = acc[4 * q] + wv.x * xk;
        acc[4 * q + 1] = acc[4 * q + 1] + wv.y * xk;
        acc[4 * q + 2] = acc[4 * q + 2] + wv.z * xk;
        acc[4 * q + 3] = acc[4 * q + 3] + wv.w * xk;
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const float v = acc[j] + __ldg(bias + o0 + j);
      y[(o0 + j) * kBlock] = apply_tanh ? tanhf(v) : v;
    }
  }
}

// Body i of the view: the world body, or in the mirrored (team-1) view
// the ball, then team 1's players, then team 0's.
template <int NB, bool MIRROR>
__device__ __forceinline__ int view_body(int j) {
  constexpr int PPT = (NB - 1) / 2;
  return !MIRROR || j == 0 ? j : (j <= PPT ? j + PPT : j - PPT);
}

// The observation of one view (env.observe, or env.mirror_obs of it for
// MIRROR) as F = 4 * NB + 2 values, positions scaled by the reciprocals
// as _obs_matrix scales them.
template <int NB, bool MIRROR>
__device__ __forceinline__ void view_obs(const Env<NB>& e, const ObsConsts& oc,
                                         float (&v)[4 * NB + 2]) {
  constexpr int PPT = (NB - 1) / 2;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int i = view_body<NB, MIRROR>(j);
    const float px = e.px[i] * oc.inv_w;
    v[2 * j] = MIRROR ? 1.0f - px : px;
    v[2 * j + 1] = e.py[i] * oc.inv_h;
    const float vx = e.vx[i] * oc.inv_s;
    v[2 * NB + 2 * j] = MIRROR ? -vx : vx;
    v[2 * NB + 2 * j + 1] = e.vy[i] * oc.inv_s;
  }
  const int owner_p = e.poss - 1;
  const float owns0 = (e.poss > 0 && owner_p < PPT) ? 1.0f : 0.0f;
  const float owns1 = (e.poss > 0 && owner_p >= PPT) ? 1.0f : 0.0f;
  v[4 * NB] = MIRROR ? owns1 : owns0;
  v[4 * NB + 1] = MIRROR ? owns0 : owns1;
}

// view_obs into rows 0..F-1 of `x`. With `obs` non-null, also row f to
// obs[f * row_stride], zeros in rows F..f_pad-1.
template <int NB, bool MIRROR>
__device__ __forceinline__ void build_obs(const Env<NB>& e, const ObsConsts& oc,
                                          float* x, float* __restrict__ obs,
                                          size_t row_stride, int f_pad) {
  constexpr int F = 4 * NB + 2;
  float v[F];
  view_obs<NB, MIRROR>(e, oc, v);
#pragma unroll
  for (int f = 0; f < F; ++f) x[f * kBlock] = v[f];
  if (obs != nullptr) {
#pragma unroll
    for (int f = 0; f < F; ++f) obs[f * row_stride] = v[f];
    for (int f = F; f < f_pad; ++f) obs[f * row_stride] = 0.0f;
  }
}

// Inverse-CDF sampling of the G groups of 5 logits in rows g*5+i of
// `logits`, with draw d0 + g for group g (sample_with_logp). Returns the
// joint log-prob of the sampled indices.
template <int G>
__device__ __forceinline__ float sample_groups(const float* logits,
                                               const float* __restrict__ table,
                                               uint32_t seed, int n_draws, int B,
                                               int step, int b, int d0,
                                               int (&idx)[G]) {
  float logp = 0.0f;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float l[kChoices], ex[kChoices];
#pragma unroll
    for (int i = 0; i < kChoices; ++i) l[i] = logits[(g * kChoices + i) * kBlock];
    float m = l[0];
#pragma unroll
    for (int i = 1; i < kChoices; ++i) m = fmaxf(m, l[i]);
#pragma unroll
    for (int i = 0; i < kChoices; ++i) ex[i] = expf(l[i] - m);
    float z = ex[0];
#pragma unroll
    for (int i = 1; i < kChoices; ++i) z = z + ex[i];
    const float logz = logf(z);
    const float u = uniform_draw(table, seed, n_draws, B, step, b, d0 + g) * z;
    float cum = ex[0];
    int k = u > cum ? 1 : 0;
#pragma unroll
    for (int i = 1; i < kChoices - 1; ++i) {
      cum = cum + ex[i];
      k += u > cum ? 1 : 0;
    }
    float taken = l[0] - m - logz;
#pragma unroll
    for (int i = 1; i < kChoices; ++i) taken = k == i ? l[i] - m - logz : taken;
    idx[g] = k;
    logp = g == 0 ? taken : logp + taken;
  }
  return logp;
}

// The world-frame joint action from both views' samples: team 0 as
// sampled, team 1's directions un-mirrored (left <-> right).
template <int NPL>
__device__ __forceinline__ void joint_action(const int (&ia)[NPL],
                                             const int (&ib)[NPL],
                                             int (&dirs)[NPL], int (&acts)[NPL]) {
  constexpr int PPT = NPL / 2;
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int d = ib[2 * p];
    dirs[p] = ia[2 * p];
    acts[p] = ia[2 * p + 1];
    dirs[PPT + p] = d == 2 ? 4 : (d == 4 ? 2 : d);
    acts[PPT + p] = ib[2 * p + 1];
  }
}

// Dirs and acts of one view packed at 3 bits per player.
template <int NPL>
__device__ __forceinline__ void pack(const int (&idx)[NPL], int& dpack, int& apack) {
  dpack = 0;
  apack = 0;
#pragma unroll
  for (int p = 0; p < NPL / 2; ++p) {
    dpack |= idx[2 * p] << (3 * p);
    apack |= idx[2 * p + 1] << (3 * p);
  }
}

// The kick angle and kickoff noise of a step: draws 2G.. of the step.
template <int NB>
__device__ __forceinline__ float env_noise(const float* __restrict__ table,
                                           uint32_t seed, int n_draws, int B,
                                           int step, int b, float kick_noise,
                                           float (&nzx)[NB], float (&nzy)[NB]) {
  constexpr int D = 2 * (NB - 1);
  const float theta = normal_from(uniform_draw(table, seed, n_draws, B, step, b, D),
                                  uniform_draw(table, seed, n_draws, B, step, b, D + 1)) *
                      kick_noise;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    nzx[i] = pm1_from(uniform_draw(table, seed, n_draws, B, step, b, D + 2 + i));
    nzy[i] = pm1_from(uniform_draw(table, seed, n_draws, B, step, b, D + 2 + NB + i));
  }
  return theta;
}

// The per-step trajectory buffer of a collect.
struct CollectOut {
  float* obs;       // [2, f_pad, T, B]
  int* dirs;        // [T, 2, B] packed, each view in its own frame
  int* acts;        // [T, 2, B]
  float* logp;      // [T, 2, B]
  float* value;     // [T, 2, B]
  float* reward;    // [T, 2, B], view k carries team k's reward
  int* done;        // [T, 2, B]
  float* last_value;  // [2, B]
};

// Host side: the MLP table from [n_layers, 4] ints (in, out_pad, w_off,
// b_off); false if it does not fit the kernels' limits. `rows` becomes at
// least the widest layer output.
inline bool make_mlp(const int* dims, int n_layers, Mlp& m, int& rows) {
  if (n_layers < 1 || n_layers > kMaxLayers) return false;
  m.n_layers = n_layers;
  for (int l = 0; l < n_layers; ++l) {
    m.in[l] = dims[4 * l];
    m.out_pad[l] = dims[4 * l + 1];
    m.w_off[l] = dims[4 * l + 2];
    m.b_off[l] = dims[4 * l + 3];
    if (m.in[l] < 1 || m.out_pad[l] < kChunk || m.out_pad[l] % kChunk != 0 ||
        m.w_off[l] % 4 != 0)
      return false;
    if (l > 0 && m.in[l] > m.out_pad[l - 1]) return false;
    rows = m.out_pad[l] > rows ? m.out_pad[l] : rows;
  }
  return true;
}

// Sets the kernel's dynamic shared memory limit to `columns` rows of
// kBlock floats; an error for a plan the card cannot hold.
template <typename K>
cudaError_t prepare(K kernel, int columns, size_t& smem_bytes) {
  smem_bytes = static_cast<size_t>(columns) * kBlock * sizeof(float);
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes));
}

// ---------------------------------------------------------------------------
// Tensor-core helpers (bf16 operands, f32 sums)
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices from shared memory, lane l naming row l % 8
// of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

// d += a b on one m16n8k16 tile: bf16 operands, f32 sums. a is the A
// fragment of a row-major 16 x 16 tile, (b0, b1) the B fragment of a
// 16 x 8 one; d [e] is element (g + 8 (e / 2), 2 t + e % 2) of D, with
// g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16 (to nearest even) in one register, x in
// the low half.
__device__ __forceinline__ unsigned pack_bf16(float x, float y) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const unsigned*>(&p);
}

}  // namespace futbol
