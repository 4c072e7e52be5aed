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
// At the end, the tensor-core helpers of the bf16 routes
// (fused_policy_tc.cu, fused_recurrent_tc.cu): ldmatrix, mma.sync.m16n8k16,
// a layer's 32-output chunk, a head's k16 step and its f32 outputs, and a
// view's obs as the first layer's A fragments.

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
// `logits`, with draw D0 + g for group g (sample_with_logp). Returns the
// joint log-prob of the sampled indices.
template <int G, int D0>
__device__ __forceinline__ float sample_groups(const float* logits,
                                               const float* __restrict__ table,
                                               uint32_t seed, int n_draws, int B,
                                               int step, int b, int (&idx)[G]) {
  float ug[G];
  draw_range<D0, G>(table, seed, n_draws, B, step, b, ug);
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
    const float u = ug[g] * z;
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

constexpr int kNc = 32;   // hidden-layer outputs per tensor-core chunk

// acc[m][0..3] += a[m] B for the four n8 tiles of one chunk.
__device__ __forceinline__ void mma_chunk(float (&acc)[2][4][4], const unsigned (&a)[2][4],
                                          const uint4& b0, const uint4& b1) {
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    mma_bf16(acc[m][0], a[m], b0.x, b0.y);
    mma_bf16(acc[m][1], a[m], b0.z, b0.w);
    mma_bf16(acc[m][2], a[m], b1.x, b1.y);
    mma_bf16(acc[m][3], a[m], b1.z, b1.w);
  }
}

// Chunk c of a layer (outputs 32 c ..) over the warp's 32 rows: from the
// obs fragments in registers, or from a tile of row stride ld.
template <int KK0>
__device__ __forceinline__ void chunk_from_regs(float (&acc)[2][4][4],
                                                const unsigned (&x0)[KK0][2][4],
                                                const uint4* W, int nj, int c, int lane) {
#pragma unroll
  for (int kk = 0; kk < KK0; ++kk) {
    const uint4* w = W + (kk * nj + 2 * c) * 32 + lane;
    mma_chunk(acc, x0[kk], w[0], w[32]);
  }
}

__device__ __forceinline__ void chunk_from_tile(float (&acc)[2][4][4], const __nv_bfloat16* X,
                                                int ld, int kp, const uint4* W, int nj,
                                                int c, int lane) {
  const int q = lane >> 3, r = lane & 7;
  const __nv_bfloat16* xa = X + ((q & 1) * 8 + r) * ld + (q >> 1) * 8;
#pragma unroll 2
  for (int kk = 0; kk < kp / 16; ++kk) {
    unsigned a[2][4];
    ldsm_x4(a[0], xa + kk * 16);
    ldsm_x4(a[1], xa + 16 * ld + kk * 16);
    const uint4* w = W + (kk * nj + 2 * c) * 32 + lane;
    mma_chunk(acc, a, w[0], w[32]);
  }
}

// tanh(acc + bias) of chunk c, in place (f32).
__device__ __forceinline__ void bias_tanh(float (&acc)[2][4][4], const float* __restrict__ bias,
                                          int c, int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 bb =
        __ldg(reinterpret_cast<const float2*>(bias + kNc * c + 8 * j + 2 * (lane & 3)));
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc[m][j][2 * h] = tanhf(acc[m][j][2 * h] + bb.x);
        acc[m][j][2 * h + 1] = tanhf(acc[m][j][2 * h + 1] + bb.y);
      }
  }
}

// Chunk c's activations as bf16 pairs into tile Y (row stride ld).
__device__ __forceinline__ void store_chunk(const float (&h)[2][4][4], __nv_bfloat16* Y, int ld,
                                            int c, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<unsigned*>(Y + (16 * m + g + 8 * hh) * ld + kNc * c + 8 * j +
                                     2 * t) = pack_bf16(h[m][j][2 * hh], h[m][j][2 * hh + 1]);
}

// hacc += A Wl over one k16 step ks of the head, A's fragments in a.
template <int NLJ>
__device__ __forceinline__ void head_step(float (&hacc)[2][NLJ][4], const unsigned (&a)[2][4],
                                          const uint4* Wl, int ks, int lane) {
  const uint4* w = Wl + ks * (NLJ / 2) * 32 + lane;
#pragma unroll
  for (int jj = 0; jj < NLJ / 2; ++jj) {
    const uint4 b = w[jj * 32];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      mma_bf16(hacc[m][2 * jj], a[m], b.x, b.y);
      mma_bf16(hacc[m][2 * jj + 1], a[m], b.z, b.w);
    }
  }
}

// A head's f32 outputs into the warp's tile lg ([np_head + 1][32]: row o,
// column r is output o of the warp's env r): the logits hacc plus their
// bias bl, and, with has_value, the value at row np_head from the lanes'
// partial sums vpart (over the lane's outputs of the last layer; summed
// over the four lanes of each row, then its bias bv).
template <int NLJ>
__device__ __forceinline__ void heads_out(const float (&hacc)[2][NLJ][4],
                                          const float (&vpart)[2][2],
                                          const float* __restrict__ bl, bool has_value,
                                          float bv, int np_head, float* lg, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NLJ; ++j) {
    const int col = 8 * j + 2 * t;
    const float2 bb = __ldg(reinterpret_cast<const float2*>(bl + col));
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = 16 * m + g + 8 * hh;
        lg[col * 32 + row] = hacc[m][j][2 * hh] + bb.x;
        lg[(col + 1) * 32 + row] = hacc[m][j][2 * hh + 1] + bb.y;
      }
  }
  if (has_value) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float v = vpart[m][hh];
        v = v + __shfl_xor_sync(0xffffffffu, v, 1);
        v = v + __shfl_xor_sync(0xffffffffu, v, 2);
        if (t == 0) lg[np_head * 32 + 16 * m + g + 8 * hh] = v + bv;
      }
  }
  __syncwarp();
}

// Each thread's env obs of one view (zeros without an env; with `obs`
// non-null also the f32 obs, rows F..f_pad-1 zero, as build_obs writes
// it), staged as bf16 row `row` (the thread's env's M row) of the warp's
// tile `t` (row stride ld), then loaded as the A fragments x0 of the
// first layer; t is free again after.
template <int NB, bool MIRROR>
__device__ __forceinline__ void obs_fragments(const Env<NB>& e, bool owner,
                                              const ObsConsts& oc, float* obs,
                                              size_t row_stride, int f_pad,
                                              __nv_bfloat16* t, int ld, int row,
                                              int lane,
                                              unsigned (&x0)[(4 * NB + 2 + 15) / 16][2][4]) {
  constexpr int F = 4 * NB + 2;
  constexpr int KK0 = (F + 15) / 16;
  float v[F];
  if (owner) {
    view_obs<NB, MIRROR>(e, oc, v);
    if (obs != nullptr) {
#pragma unroll
      for (int f = 0; f < F; ++f) obs[f * row_stride] = v[f];
      for (int f = F; f < f_pad; ++f) obs[f * row_stride] = 0.0f;
    }
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = 0.0f;
  }
  __syncwarp();   // the last view's outputs have been read
  __nv_bfloat16* mine = t + row * ld;
#pragma unroll
  for (int k = 0; k < 16 * KK0; k += 2)
    *reinterpret_cast<unsigned*>(mine + k) =
        pack_bf16(k < F ? v[k] : 0.0f, k + 1 < F ? v[k + 1] : 0.0f);
  __syncwarp();
  const int q = lane >> 3, r = lane & 7;
  const __nv_bfloat16* xa = t + ((q & 1) * 8 + r) * ld + (q >> 1) * 8;
#pragma unroll
  for (int kk = 0; kk < KK0; ++kk) {
    ldsm_x4(x0[kk][0], xa + kk * 16);
    ldsm_x4(x0[kk][1], xa + 16 * ld + kk * 16);
  }
  __syncwarp();   // t is free for the first layer's outputs
}

}  // namespace futbol
