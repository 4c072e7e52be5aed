// One PPO minibatch gradient for NVIDIA Hopper (sm_90a), CUDA C++: the
// actor-critic forward, the clipped-surrogate loss and the hand-written
// backward as a short chain of kernels on one stream.
//
// Replaces the Pallas TPU kernel fused_minibatch_grad
// (gym_futbol_tpu/ops/fused_update.py, body _update_kernel). The plain
// PyTorch version is fused_minibatch_grad_reference (ops/fused_update.py),
// with the same rounding points.
//
// Design. The TPU kernel keeps a [hidden, block] activation slab per layer
// in VMEM and walks the minibatch one block at a time, accumulating the
// gradients in place. An SM's shared memory holds a fraction of such a
// slab, and blocks of a CUDA grid run in no order, so here each layer's
// activations live in device memory ([width, M] for the M samples of the
// minibatch; ~1 GB per 256-wide layer at M = 2^20, ~10 GB of traffic per
// call) and the work is five kinds of kernel:
// - rows_gemm_kernel: C[r, s] = epi(sum_k A(r, k) * B[k, s]) for the torso
//   forward (A = W^T, epilogue tanh(acc + b)) and the backward dh = W dz
//   (epilogue dz' = acc * (1 - h^2), written over h in place). A 128-sample
//   by BR-row tile per block, k in steps of 32 through shared memory, an
//   8 x 8 register tile per thread. The first layer reads the obs columns
//   through the block indices: column idx[s / block] * block + s % block,
//   so the minibatch is never copied.
// - head_loss_kernel: one thread per sample. The logits and value heads,
//   the row-form log-softmax, taken log-prob, entropy, ratio, both clips,
//   dlogits [G5, M] and dvalue [M], the heads' backward
//   dh = Wl dlogits + wv dvalue with the tanh' epilogue giving the last
//   torso layer's dz, and per-block partial sums of the four metrics.
//   The heads' weights sit in shared memory, read as broadcasts.
// - outer_gemm_kernel: dW[a, b] = sum_s X[a, s] * D[b, s] over the samples.
//   The samples split in fixed chunks of `chunk`; each block writes one
//   chunk's tile to a partials buffer.
// - rowdot_kernel: per chunk, sum_s X[r, s] (* w[s]): the biases' gradients
//   and the value head's dW.
// - reduce_kernel: the partials summed over the chunks in a fixed order.
// No atomics: the result is the same from run to run.
//
// Precision, matching the TPU kernel's rounding points: in bf16 mode every
// operand of a layer product (obs, activations, W, dlogits, dz) is rounded
// to bfloat16 (round to nearest even) as it is loaded and the products are
// summed in float32 with explicit __fmaf_rn (exact products of bf16
// values, so one rounding per step as in float32 accumulation); the value
// head's products stay float32, as do the loss math and tanh' (on the
// float32 activation). In f32 mode every product is float32 (no TF32).
//
// What bounds it: 2 * (81,152 + 154,624) = 471,552 operations per sample
// at bench config 4 (3v3, hidden (256, 256)), 4.9e11 per 2^20-sample
// minibatch, against ~160 MB of obs and per-sample rows: compute-bound
// (0.50 ms on the tensor cores in bf16, 7.4 ms on the FP32 CUDA cores).
// This first version runs both modes on the CUDA cores; the bf16 products
// on the tensor cores (wgmma) and the fusion of the layers are later work.
//
// C interface for ctypes; the entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBK = 32;            // k (or sample) step through shared memory
constexpr int kBS = 128;           // samples per rows_gemm tile
constexpr int kLossThreads = 256;  // samples per head_loss block
constexpr int kRowThreads = 256;   // threads per rowdot block
constexpr int kReduceLanes = 32;   // lanes of chunks per reduce block
constexpr int kChoices = 5;        // every action slot is a 5-way choice

enum Epilogue { kTanhBias = 0, kDtanh = 1 };

template <bool kBf16>
__device__ __forceinline__ float op(float x) {
  if (kBf16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

// Column of the B (or X) matrix for minibatch sample s.
__device__ __forceinline__ long long sample_col(int s, const int* idx,
                                                int block) {
  if (idx == nullptr) return s;
  return static_cast<long long>(idx[s / block]) * block + s % block;
}

// C[r, s] = epi(sum_k A[r * a_rs + k * a_ks] * B(k, s)), r < R, k < K,
// s < M (M a multiple of kBS). B(k, s) = B[k * ldb + sample_col(s)].
// kTanhBias: C = tanh(acc + bias[r]); kDtanh: C = acc * (1 - h * h) with
// h the value C holds before (in place).
template <int BR, bool kBf16, int kEpi>
__global__ void __launch_bounds__((BR / 8) * (kBS / 8))
rows_gemm_kernel(const float* __restrict__ A, int a_rs, int a_ks,
                 const float* __restrict__ B, long long ldb,
                 const int* __restrict__ idx, int block,
                 const float* __restrict__ bias, float* C, int R, int K,
                 int M) {
  constexpr int kTS = kBS / 8;            // threads along the samples
  constexpr int kThreads = (BR / 8) * kTS;
  __shared__ __align__(16) float As[kBK][BR + 4];
  __shared__ __align__(16) float Bs[kBK][kBS];
  const int t = threadIdx.x;
  const int tr = t / kTS, ts = t % kTS;
  const int r0 = blockIdx.y * BR;
  const int s0 = blockIdx.x * kBS;
  const long long col0 = sample_col(s0, idx, block);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = t; e < kBK * BR; e += kThreads) {
      const int kk = e / BR, r = e % BR;
      const int gr = r0 + r, gk = k0 + kk;
      As[kk][r] = (gr < R && gk < K)
                      ? op<kBf16>(A[static_cast<long long>(gr) * a_rs +
                                    static_cast<long long>(gk) * a_ks])
                      : 0.0f;
    }
    for (int e = t; e < kBK * (kBS / 4); e += kThreads) {
      const int kk = e / (kBS / 4), c4 = e % (kBS / 4);
      const int gk = k0 + kk;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (gk < K)
        v = *reinterpret_cast<const float4*>(B + gk * ldb + col0 + 4 * c4);
      Bs[kk][4 * c4 + 0] = op<kBf16>(v.x);
      Bs[kk][4 * c4 + 1] = op<kBf16>(v.y);
      Bs[kk][4 * c4 + 2] = op<kBf16>(v.z);
      Bs[kk][4 * c4 + 3] = op<kBf16>(v.w);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][tr * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][BR / 2 + tr * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][ts * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][kBS / 2 + ts * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + (i < 4 ? tr * 4 + i : BR / 2 + tr * 4 + i - 4);
    if (r >= R) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int s = s0 + half * (kBS / 2) + ts * 4;
      float4* out = reinterpret_cast<float4*>(C + static_cast<long long>(r) * M + s);
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = acc[i][half * 4 + j];
      if (kEpi == kTanhBias) {
        const float br = bias[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = tanhf(v[j] + br);
      } else {
        const float4 h = *out;
        v[0] = v[0] * (1.0f - h.x * h.x);
        v[1] = v[1] * (1.0f - h.y * h.y);
        v[2] = v[2] * (1.0f - h.z * h.z);
        v[3] = v[3] * (1.0f - h.w * h.w);
      }
      *out = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// partial[c][a][b] = sum over the samples s of chunk c of X(a, s) * D[b, s],
// X(a, s) = X[a * ldx + sample_col(s)], D [Bd, M] row-major; a < A, b < Bd.
// Grid: (tiles of BA x BB, chunks).
template <int BA, int BB, bool kBf16>
__global__ void __launch_bounds__((BA / 8) * (BB / 8))
outer_gemm_kernel(const float* __restrict__ X, long long ldx,
                  const int* __restrict__ idx, int block,
                  const float* __restrict__ D, int A, int Bd, int M, int chunk,
                  float* __restrict__ partial) {
  constexpr int kTB = BB / 8;
  constexpr int kThreads = (BA / 8) * kTB;
  __shared__ __align__(16) float Xs[kBK][BA + 4];
  __shared__ __align__(16) float Ds[kBK][BB + 4];
  const int t = threadIdx.x;
  const int ta = t / kTB, tb = t % kTB;
  const int tiles_b = (Bd + BB - 1) / BB;
  const int a0 = (blockIdx.x / tiles_b) * BA;
  const int b0 = (blockIdx.x % tiles_b) * BB;
  const int c = blockIdx.y;
  const int s_begin = c * chunk;
  const int s_end = min(M, s_begin + chunk);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int s0 = s_begin; s0 < s_end; s0 += kBK) {
    // a kBK-sample step never crosses a block of `block` >= 128 samples
    const long long col0 = sample_col(s0, idx, block);
    for (int e = t; e < kBK * BA; e += kThreads) {
      const int a = e / kBK, kk = e % kBK;
      const int ga = a0 + a;
      Xs[kk][a] = ga < A ? op<kBf16>(X[ga * ldx + col0 + kk]) : 0.0f;
    }
    for (int e = t; e < kBK * BB; e += kThreads) {
      const int b = e / kBK, kk = e % kBK;
      const int gb = b0 + b;
      Ds[kk][b] = gb < Bd ? op<kBf16>(D[static_cast<long long>(gb) * M + s0 + kk])
                          : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float x[8], d[8];
      const float4 x0 = *reinterpret_cast<const float4*>(&Xs[kk][ta * 4]);
      const float4 x1 = *reinterpret_cast<const float4*>(&Xs[kk][BA / 2 + ta * 4]);
      const float4 d0 = *reinterpret_cast<const float4*>(&Ds[kk][tb * 4]);
      const float4 d1 = *reinterpret_cast<const float4*>(&Ds[kk][BB / 2 + tb * 4]);
      x[0] = x0.x; x[1] = x0.y; x[2] = x0.z; x[3] = x0.w;
      x[4] = x1.x; x[5] = x1.y; x[6] = x1.z; x[7] = x1.w;
      d[0] = d0.x; d[1] = d0.y; d[2] = d0.z; d[3] = d0.w;
      d[4] = d1.x; d[5] = d1.y; d[6] = d1.z; d[7] = d1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(x[i], d[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = partial + static_cast<long long>(c) * A * Bd;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int a = a0 + (i < 4 ? ta * 4 + i : BA / 2 + ta * 4 + i - 4);
    if (a >= A) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int b = b0 + (j < 4 ? tb * 4 + j : BB / 2 + tb * 4 + j - 4);
      if (b < Bd) out[static_cast<long long>(a) * Bd + b] = acc[i][j];
    }
  }
}

// Fixed-order sum of v over the block's kRowThreads threads; returns it in
// thread 0. `buf` holds kRowThreads floats.
__device__ float block_sum(float v, float* buf) {
  const int t = threadIdx.x;
  buf[t] = v;
  __syncthreads();
  for (int stride = kRowThreads / 2; stride > 0; stride >>= 1) {
    if (t < stride) buf[t] = buf[t] + buf[t + stride];
    __syncthreads();
  }
  const float total = buf[0];
  __syncthreads();
  return total;
}

// partial[c][r] = sum over the samples s of chunk c of X[r, s] (* w[s]).
// Grid: (chunks, R).
__global__ void __launch_bounds__(kRowThreads)
rowdot_kernel(const float* __restrict__ X, const float* __restrict__ w,
              int R, int M, int chunk, float* __restrict__ partial) {
  __shared__ float buf[kRowThreads];
  const int c = blockIdx.x, r = blockIdx.y;
  const int s_end = min(M, (c + 1) * chunk);
  const float* row = X + static_cast<long long>(r) * M;
  float sum = 0.0f;
  for (int s = c * chunk + threadIdx.x; s < s_end; s += kRowThreads)
    sum = w == nullptr ? sum + row[s] : __fmaf_rn(row[s], w[s], sum);
  const float total = block_sum(sum, buf);
  if (threadIdx.x == 0) partial[static_cast<long long>(c) * R + r] = total;
}

// out[e] = sum_{c < n_chunks} partial[c * E + e], e < E_out, in a fixed
// order. A block takes 32 neighbouring elements (threadIdx.x, so a warp
// reads 32 neighbours of one chunk) and kReduceLanes lanes of chunks
// (threadIdx.y: chunks y, y + kReduceLanes, ... in ascending order); the
// lanes' sums are then added in ascending y.
__global__ void __launch_bounds__(32 * kReduceLanes)
reduce_kernel(const float* __restrict__ partial, int n_chunks, long long E,
              long long E_out, float* __restrict__ out) {
  __shared__ float buf[kReduceLanes][32];
  const long long e = static_cast<long long>(blockIdx.x) * 32 + threadIdx.x;
  float sum = 0.0f;
  if (e < E_out)
    for (int c = threadIdx.y; c < n_chunks; c += kReduceLanes)
      sum = sum + partial[c * E + e];
  buf[threadIdx.y][threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.y == 0 && e < E_out) {
    float total = buf[0][threadIdx.x];
    for (int q = 1; q < kReduceLanes; ++q) total = total + buf[q][threadIdx.x];
    out[e] = total;
  }
}

// One thread per minibatch sample s (module comment). Shared memory: the
// logits head [H, G5] (rounded in bf16 mode), then the value head [H].
template <int G, bool kBf16>
__global__ void __launch_bounds__(kLossThreads)
head_loss_kernel(const float* __restrict__ h, const float* __restrict__ wl,
                 const float* __restrict__ bl, const float* __restrict__ wv,
                 const float* __restrict__ bv, int H, int M, int block,
                 const int* __restrict__ idx, const int* __restrict__ dirs,
                 const int* __restrict__ acts, const float* __restrict__ logp_old,
                 const float* __restrict__ value_old,
                 const float* __restrict__ ret, const float* __restrict__ adv,
                 float eps, float c_pg, float c_v, float c_ent,
                 float* __restrict__ dlogits, float* __restrict__ dvalue,
                 float* __restrict__ dz, float* __restrict__ metric_partial) {
  constexpr int G5 = G * kChoices;
  extern __shared__ __align__(16) float smem[];
  __shared__ float buf[kRowThreads];
  float* s_wl = smem;
  float* s_wv = smem + H * G5;
  const int t = threadIdx.x;
  for (int e = t; e < H * G5; e += kLossThreads) s_wl[e] = op<kBf16>(wl[e]);
  for (int e = t; e < H; e += kLossThreads) s_wv[e] = wv[e];
  __syncthreads();

  const int s = blockIdx.x * kLossThreads + t;
  float m_pg = 0.0f, m_v = 0.0f, m_ent = 0.0f, m_kl = 0.0f;
  if (s < M) {
    // ---- heads forward ----
    float lg[G5];
#pragma unroll
    for (int k = 0; k < G5; ++k) lg[k] = 0.0f;
    float v = 0.0f;
    for (int j = 0; j < H; ++j) {
      const float hj = h[static_cast<long long>(j) * M + s];
      const float hr = op<kBf16>(hj);
      const float* wrow = s_wl + j * G5;
#pragma unroll
      for (int k = 0; k < G5; ++k) lg[k] = __fmaf_rn(wrow[k], hr, lg[k]);
      v = __fmaf_rn(s_wv[j], hj, v);
    }
#pragma unroll
    for (int k = 0; k < G5; ++k) lg[k] = lg[k] + bl[k];
    v = v + bv[0];

    // ---- loss math: lg becomes log-probs, p the probabilities ----
    const long long col = sample_col(s, idx, block);
    const int dpk = dirs[col], apk = acts[col];
    const float lo = 1.0f - eps, hi = 1.0f + eps;
    float p[G5];
    int a_g[G];
    float logp_tot = 0.0f, ent_tot = 0.0f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float* r = lg + g * kChoices;
      float mx = r[0];
#pragma unroll
      for (int k = 1; k < kChoices; ++k) mx = fmaxf(mx, r[k]);
      float e[kChoices];
#pragma unroll
      for (int k = 0; k < kChoices; ++k) e[k] = expf(r[k] - mx);
      float z = e[0];
#pragma unroll
      for (int k = 1; k < kChoices; ++k) z = z + e[k];
      const float inv_z = 1.0f / z;
      const float logz = logf(z);
#pragma unroll
      for (int k = 0; k < kChoices; ++k) {
        r[k] = r[k] - mx - logz;
        p[g * kChoices + k] = e[k] * inv_z;
      }
      const int packed = (g % 2 == 0) ? dpk : apk;
      const int a = (packed >> (3 * (g / 2))) & 7;
      float taken = r[0];
      float ent = -p[g * kChoices] * r[0];
#pragma unroll
      for (int k = 1; k < kChoices; ++k) {
        taken = (a == k) ? r[k] : taken;
        ent = ent - p[g * kChoices + k] * r[k];
      }
      a_g[g] = a;
      logp_tot = g == 0 ? taken : logp_tot + taken;
      ent_tot = g == 0 ? ent : ent_tot + ent;
    }
    const float lp_old = logp_old[col];
    const float a_n = adv[s];
    const float ratio = expf(logp_tot - lp_old);
    const float pg1 = ratio * a_n;
    const float pg2 = fminf(fmaxf(ratio, lo), hi) * a_n;
    const float inclip = (ratio >= lo && ratio <= hi) ? 1.0f : 0.0f;
    const float pick = pg1 <= pg2 ? 1.0f : inclip;
    const float dlogp = -c_pg * a_n * ratio * pick;

    const float vo = value_old[col];
    const float dv_raw = v - vo;
    const float v_cl = vo + fminf(fmaxf(dv_raw, -eps), eps);
    const float e1 = v - ret[col], e2 = v_cl - ret[col];
    const float inclip_v = (dv_raw >= -eps && dv_raw <= eps) ? 1.0f : 0.0f;
    const float dval = c_v * (e1 * e1 >= e2 * e2 ? e1 : e2 * inclip_v);

    m_pg = -fminf(pg1, pg2);
    m_v = 0.5f * fmaxf(e1 * e1, e2 * e2);
    m_ent = ent_tot;
    m_kl = (ratio - 1.0f) - (logp_tot - lp_old);

    // ---- dlogits; p becomes the rounded dlogits for the heads' backward
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float* lp = lg + g * kChoices;
      float* pg = p + g * kChoices;
      float h_g = 0.0f;
#pragma unroll
      for (int k = 0; k < kChoices; ++k) h_g = h_g - pg[k] * lp[k];
#pragma unroll
      for (int k = 0; k < kChoices; ++k) {
        const float onehot = a_g[g] == k ? 1.0f : 0.0f;
        const float dl = dlogp * (onehot - pg[k]) + c_ent * pg[k] * (lp[k] + h_g);
        dlogits[static_cast<long long>(g * kChoices + k) * M + s] = dl;
        pg[k] = op<kBf16>(dl);
      }
    }
    dvalue[s] = dval;

    // ---- heads backward: dh = Wl dlogits + wv dvalue, dz = dh (1 - h^2)
    for (int j = 0; j < H; ++j) {
      const float* wrow = s_wl + j * G5;
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < G5; ++k) acc = __fmaf_rn(wrow[k], p[k], acc);
      const float dh = acc + s_wv[j] * dval;
      const long long at = static_cast<long long>(j) * M + s;
      const float hj = h[at];
      dz[at] = dh * (1.0f - hj * hj);
    }
  }
  const float sums[4] = {m_pg, m_v, m_ent, m_kl};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float total = block_sum(sums[q], buf);
    if (t == 0) metric_partial[blockIdx.x * 4 + q] = total;
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <bool kBf16>
void launch_rows_gemm(int epi, const float* A, int a_rs, int a_ks,
                      const float* B, long long ldb, const int* idx, int block,
                      const float* bias, float* C, int R, int K, int M,
                      cudaStream_t stream) {
  const bool narrow = R <= 32;
  const dim3 grid(M / kBS, (R + (narrow ? 32 : 128) - 1) / (narrow ? 32 : 128));
  if (narrow && epi == kTanhBias)
    rows_gemm_kernel<32, kBf16, kTanhBias><<<grid, 4 * 16, 0, stream>>>(
        A, a_rs, a_ks, B, ldb, idx, block, bias, C, R, K, M);
  else if (narrow)
    rows_gemm_kernel<32, kBf16, kDtanh><<<grid, 4 * 16, 0, stream>>>(
        A, a_rs, a_ks, B, ldb, idx, block, bias, C, R, K, M);
  else if (epi == kTanhBias)
    rows_gemm_kernel<128, kBf16, kTanhBias><<<grid, 16 * 16, 0, stream>>>(
        A, a_rs, a_ks, B, ldb, idx, block, bias, C, R, K, M);
  else
    rows_gemm_kernel<128, kBf16, kDtanh><<<grid, 16 * 16, 0, stream>>>(
        A, a_rs, a_ks, B, ldb, idx, block, bias, C, R, K, M);
}

template <int BA, int BB, bool kBf16>
void launch_outer(const float* X, long long ldx, const int* idx, int block,
                  const float* D, int A, int Bd, int M, int chunk,
                  float* partial, cudaStream_t stream) {
  const int tiles = ((A + BA - 1) / BA) * ((Bd + BB - 1) / BB);
  const dim3 grid(tiles, (M + chunk - 1) / chunk);
  outer_gemm_kernel<BA, BB, kBf16><<<grid, (BA / 8) * (BB / 8), 0, stream>>>(
      X, ldx, idx, block, D, A, Bd, M, chunk, partial);
}

template <bool kBf16>
void launch_outer_any(const float* X, long long ldx, const int* idx, int block,
                      const float* D, int A, int Bd, int M, int chunk,
                      float* partial, cudaStream_t stream) {
  const bool na = A <= 32, nb = Bd <= 32;
  if (na && nb)
    launch_outer<32, 32, kBf16>(X, ldx, idx, block, D, A, Bd, M, chunk, partial, stream);
  else if (na)
    launch_outer<32, 128, kBf16>(X, ldx, idx, block, D, A, Bd, M, chunk, partial, stream);
  else if (nb)
    launch_outer<128, 32, kBf16>(X, ldx, idx, block, D, A, Bd, M, chunk, partial, stream);
  else
    launch_outer<128, 128, kBf16>(X, ldx, idx, block, D, A, Bd, M, chunk, partial, stream);
}

// Sum partial [n_chunks, E] over the chunks into out [E_out].
void launch_reduce(const float* partial, int n_chunks, long long E,
                   long long E_out, float* out, cudaStream_t stream) {
  reduce_kernel<<<static_cast<unsigned>((E_out + 31) / 32), dim3(32, kReduceLanes),
                  0, stream>>>(partial, n_chunks, E, E_out, out);
}

// Row sums (w == nullptr) or row dot products with w of X [R, M] into out [R].
void launch_rowdot(const float* X, const float* w, int R, int M, int chunk,
                   float* partial, float* out, cudaStream_t stream) {
  const int n_chunks = (M + chunk - 1) / chunk;
  rowdot_kernel<<<dim3(n_chunks, R), kRowThreads, 0, stream>>>(X, w, R, M, chunk,
                                                               partial);
  launch_reduce(partial, n_chunks, R, R, out, stream);
}

template <int G, bool kBf16>
cudaError_t launch_head_loss(const float* h, const float* const* w, int n_torso,
                             int H, int M, int block, const int* idx,
                             const int* dirs, const int* acts, const float* logp,
                             const float* value, const float* ret,
                             const float* adv, float eps, float c_pg, float c_v,
                             float c_ent, float* dlogits, float* dvalue,
                             float* dz, float* metric_partial,
                             cudaStream_t stream) {
  auto kernel = head_loss_kernel<G, kBf16>;
  const size_t smem = static_cast<size_t>(H) * (G * kChoices + 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned blocks = (M + kLossThreads - 1) / kLossThreads;
  kernel<<<blocks, kLossThreads, smem, stream>>>(
      h, w[2 * n_torso], w[2 * n_torso + 1], w[2 * n_torso + 2],
      w[2 * n_torso + 3], H, M, block, idx, dirs, acts, logp, value, ret, adv,
      eps, c_pg, c_v, c_ent, dlogits, dvalue, dz, metric_partial);
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t head_loss_any(int G, const float* h, const float* const* w,
                          int n_torso, int H, int M, int block, const int* idx,
                          const int* dirs, const int* acts, const float* logp,
                          const float* value, const float* ret, const float* adv,
                          float eps, float c_pg, float c_v, float c_ent,
                          float* dlogits, float* dvalue, float* dz,
                          float* metric_partial, cudaStream_t stream) {
#define FUTBOL_HEAD_LOSS(NG)                                                   \
  case NG:                                                                     \
    return launch_head_loss<NG, kBf16>(h, w, n_torso, H, M, block, idx, dirs,  \
                                       acts, logp, value, ret, adv, eps, c_pg, \
                                       c_v, c_ent, dlogits, dvalue, dz,        \
                                       metric_partial, stream);
  switch (G) {
    FUTBOL_HEAD_LOSS(2)
    FUTBOL_HEAD_LOSS(4)
    FUTBOL_HEAD_LOSS(6)
    FUTBOL_HEAD_LOSS(8)
    FUTBOL_HEAD_LOSS(10)
    default:
      return cudaErrorInvalidValue;
  }
#undef FUTBOL_HEAD_LOSS
}

#define FUTBOL_CHECK()                                \
  do {                                                \
    const cudaError_t e_ = cudaGetLastError();        \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)

template <bool kBf16>
int fused_update(const float* const* w, float* const* grads, const int* dims,
                 int n_torso, int f, int g5, const float* obs, long long n_cols,
                 const int* idx, int mb_blocks, int block, const int* dirs,
                 const int* acts, const float* logp, const float* value,
                 const float* ret, const float* adv_n, float eps, float c_pg,
                 float c_v, float c_ent, float* const* act_bufs, float* dz,
                 float* dlogits, float* dvalue, float* partial,
                 long long partial_size, int chunk, float* metrics,
                 cudaStream_t stream) {
  const int M = mb_blocks * block;
  const int n_chunks = (M + chunk - 1) / chunk;
  const int H = dims[n_torso];
  // the partials: per chunk, each layer's [in, out] tile sums, the heads'
  // [H, G5] and the row sums; per loss block, the 4 metrics
  long long part = static_cast<long long>(H) * g5;
  part = part > H ? part : H;
  for (int l = 0; l < n_torso; ++l) {
    const long long p = static_cast<long long>(dims[l]) * dims[l + 1];
    part = part > p ? part : p;
  }
  const long long loss = (static_cast<long long>(M) + kLossThreads - 1) / kLossThreads * 4;
  const long long need = n_chunks * part > loss ? n_chunks * part : loss;
  if (partial_size < need) return static_cast<int>(cudaErrorInvalidValue);

  // ---- torso forward ----
  for (int l = 0; l < n_torso; ++l) {
    const bool first = l == 0;
    launch_rows_gemm<kBf16>(kTanhBias, w[2 * l], 1, dims[l + 1],
                            first ? obs : act_bufs[l - 1], first ? n_cols : M,
                            first ? idx : nullptr, block, w[2 * l + 1],
                            act_bufs[l], dims[l + 1], dims[l], M, stream);
    FUTBOL_CHECK();
  }
  // ---- heads, loss, heads' backward; the metric sums ----
  const float* h_last = act_bufs[n_torso - 1];
  cudaError_t err = head_loss_any<kBf16>(
      g5 / kChoices, h_last, w, n_torso, H, M, block, idx, dirs, acts, logp,
      value, ret, adv_n, eps, c_pg, c_v, c_ent, dlogits, dvalue, dz, partial,
      stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_reduce(partial, (M + kLossThreads - 1) / kLossThreads, 4, 4, metrics,
                stream);
  FUTBOL_CHECK();
  // ---- the heads' gradients ----
  launch_outer_any<kBf16>(h_last, M, nullptr, block, dlogits, H, g5, M, chunk,
                          partial, stream);
  launch_reduce(partial, n_chunks, static_cast<long long>(H) * g5,
                static_cast<long long>(H) * g5, grads[2 * n_torso], stream);
  launch_rowdot(dlogits, nullptr, g5, M, chunk, partial, grads[2 * n_torso + 1],
                stream);
  launch_rowdot(h_last, dvalue, H, M, chunk, partial, grads[2 * n_torso + 2],
                stream);
  launch_rowdot(dvalue, nullptr, 1, M, chunk, partial, grads[2 * n_torso + 3],
                stream);
  FUTBOL_CHECK();
  // ---- the torso's gradients, last layer first; dz of layer l - 1 is
  // written over the activations of layer l - 1 once their dW is done ----
  float* dz_cur = dz;
  for (int l = n_torso - 1; l >= 0; --l) {
    const bool first = l == 0;
    const int A = dims[l], Bd = dims[l + 1];
    launch_outer_any<kBf16>(first ? obs : act_bufs[l - 1], first ? n_cols : M,
                            first ? idx : nullptr, block, dz_cur, A, Bd, M,
                            chunk, partial, stream);
    // dW1 keeps the obs's first f rows only (the pad rows are dropped)
    launch_reduce(partial, n_chunks, static_cast<long long>(A) * Bd,
                  static_cast<long long>(first ? f : A) * Bd, grads[2 * l],
                  stream);
    launch_rowdot(dz_cur, nullptr, Bd, M, chunk, partial, grads[2 * l + 1],
                  stream);
    FUTBOL_CHECK();
    if (!first) {
      launch_rows_gemm<kBf16>(kDtanh, w[2 * l], Bd, 1, dz_cur, M, nullptr,
                              block, nullptr, act_bufs[l - 1], A, Bd, M, stream);
      FUTBOL_CHECK();
      dz_cur = act_bufs[l - 1];
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int futbol_fused_update(const float* const* w, float* const* grads,
                        const int* dims, int n_torso, int f, int g5,
                        const float* obs, long long n_cols, const int* idx,
                        int mb_blocks, int block, const int* dirs,
                        const int* acts, const float* logp, const float* value,
                        const float* ret, const float* adv_n, float eps,
                        float c_pg, float c_v, float c_ent, int bf16,
                        float* const* act_bufs, float* dz, float* dlogits,
                        float* dvalue, float* partial, long long partial_size,
                        int chunk, float* metrics, cudaStream_t stream) {
  if (n_torso < 1 || block % kBS != 0 || chunk % kBK != 0 || g5 % kChoices != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    return fused_update<true>(w, grads, dims, n_torso, f, g5, obs, n_cols, idx,
                              mb_blocks, block, dirs, acts, logp, value, ret,
                              adv_n, eps, c_pg, c_v, c_ent, act_bufs, dz,
                              dlogits, dvalue, partial, partial_size, chunk,
                              metrics, stream);
  return fused_update<false>(w, grads, dims, n_torso, f, g5, obs, n_cols, idx,
                             mb_blocks, block, dirs, acts, logp, value, ret,
                             adv_n, eps, c_pg, c_v, c_ent, act_bufs, dz,
                             dlogits, dvalue, partial, partial_size, chunk,
                             metrics, stream);
}

}  // extern "C"
