// One PPO minibatch gradient for NVIDIA Hopper (sm_90a), CUDA C++: the
// actor-critic forward, the clipped-surrogate loss and the hand-written
// backward. Two routes: bf16 on the tensor cores (two kernels, the main
// path) and a chain of CUDA-core kernels (float32, and bf16 beyond the
// tensor-core kernels' shapes).
//
// Replaces the Pallas TPU kernel fused_minibatch_grad
// (gym_futbol_tpu/ops/fused_update.py, body _update_kernel). The plain
// PyTorch version is fused_minibatch_grad_reference (ops/fused_update.py),
// with the same rounding points.
//
// The TPU kernel keeps a [hidden, block] activation slab per layer in VMEM
// and walks the minibatch one block at a time, accumulating the gradients
// in place. Blocks of a CUDA grid run in no order, so here the samples
// split in fixed chunks of `chunk`, each chunk's sums go to a partials
// buffer, and reduce_kernel adds the partials over the chunks in a fixed
// order. No atomics: the result is the same from run to run.
//
// Tensor cores (torsos of one or two layers up to 256 wide, bf16;
// futbol_fused_update_tc). What bounds it: 2 * 235,776 bf16 operations
// per sample at bench config 4 (3v3, hidden (256, 256)), 4.9e11 per
// 2^20-sample minibatch, 0.50 ms at the tensor cores' peak; the bytes
// that must move are ~160 MB. At bench config 5 (5v5, the same torso):
// 2 * 258,560 per sample, 1.10 ms per 2^21-sample minibatch; streaming W2
// adds 128 KB of L2 reads per 64-sample tile (~4.3 GB a minibatch). The
// design keeps the activations on chip:
// - round_obs_kernel: the minibatch's obs columns, gathered through the
//   block indices and rounded to bf16 (xb [f1p][M]), for both kernels.
// - tc_forward_kernel, one block of 16 warps per chunk, the weights in
//   shared memory as bf16 (W1, W2, the logits head; zero-padded so that
//   the torso widths are multiples of 64 and G*5 of 16, which is exact).
//   W2 is resident where the whole block fits in 232,448 bytes (3v3 at
//   (256, 256)); where it does not (4v4 and 5v5 at (256, 256): W2 alone
//   is 128 KB) it is streamed: 64-row slabs of W2 pass through a ring of
//   two slots, each tile's layer 2 running slab by slab in the resident
//   order of its k steps (the same bits). A tile's first two slabs are
//   copied during the tile before; slab j + 2 is copied while slab j + 1
//   is multiplied. The slabs come from L2 for every tile.
//   Per tile of 64 samples (a tile never crosses a shuffle block; its xb
//   columns and per-sample rows arrive by cp.async during the tile
//   before): layer 1, tanh, layer 2, tanh (the last layer's float32 h
//   stays in the registers of the warp that made it), the value head
//   (float32), the logits, the loss (each (group, sample) pair's
//   log-softmax, then per sample the ratio and the clips), dlogits, dh =
//   Wl dlogits + wv dvalue and dz = dh (1 - h^2) on the float32 h, dWl,
//   dWv and the biases' sums. Writes the bf16 dz of the last layer,
//   nothing else per sample.
// - tc_backward_kernel, one block per (chunk, 64-unit slab of layer 1):
//   the tiles of xb and dz arrive by cp.async one tile ahead; h1 of the
//   slab is recomputed from xb with the forward's instruction (the same
//   bits, a 3.5% addition), dh1 = W2 dz2 with the tanh' epilogue, then
//   dW2, db1 and dW1 over the samples.
// The torso's products (layers 1 and 2, h1 again, dh1, dW2, dW1) are
// wgmma (m64nNk16, bf16 x bf16 -> f32, asynchronous, one warpgroup per 64
// rows) on 128B-swizzled shared tiles, read MN-major or K-major as each
// product wants, so no weight or tile is ever transposed: W2 [in, out]
// serves the forward (A MN-major) and dh1 = W2 dz2 (A K-major) alike, and
// one dz2 tile is B for dh1 (MN-major) and for dW2 (K-major). The heads'
// narrow products (the logits, dh = Wl dlogits, dWl) are mma.sync.m16n8k16
// through ldmatrix (.trans where the stored layout is k-major). Shared
// tiles are XOR-swizzled by 16-byte group (the layout wgmma's 128B
// swizzle reads), so the 8 rows an ldmatrix reads never share a bank.
//
// CUDA-core chain (futbol_fused_update), five kinds of kernel over
// activations in device memory ([width, M] float32 per layer):
// - rows_gemm_kernel: C[r, s] = epi(sum_k A(r, k) * B[k, s]) for the torso
//   forward (A = W^T, epilogue tanh(acc + b)) and the backward dh = W dz
//   (epilogue dz' = acc * (1 - h^2), written over h in place). A 128-sample
//   by BR-row tile per block, k in steps of 32 through shared memory, an
//   8 x 8 register tile per thread. The first layer reads the obs columns
//   through the block indices: column idx[s / block] * block + s % block,
//   so the minibatch is never copied.
// - head_loss_kernel: one thread per sample: the heads, the loss, dlogits
//   [G5, M], dvalue [M] and the heads' backward into the last layer's dz.
// - outer_gemm_kernel: dW[a, b] = sum_s X[a, s] * D[b, s] per chunk.
// - rowdot_kernel: per chunk, sum_s X[r, s] (* w[s]): the biases' gradients
//   and the value head's dW.
// - reduce_kernel: the partials summed over the chunks.
//
// Precision, matching the TPU kernel's rounding points: in bf16 every
// operand of a layer product (obs, activations, W, dlogits, dz) is rounded
// to bfloat16 (round to nearest even) and the products are summed in
// float32 (the tensor cores' order of the sums; on the CUDA cores explicit
// __fmaf_rn of the exact bf16 products); the value head's products stay
// float32, as do the loss math and tanh' (on the float32 activation). In
// float32 every product is float32 (no TF32).
//
// C interface for ctypes; each entry point returns cudaGetLastError().

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

// ---------------------------------------------------------------------------
// The bf16 path on the tensor cores (module comment, "Tensor cores")
// ---------------------------------------------------------------------------

constexpr int kTS = 64;           // samples per tile
constexpr int kFwdThreads = 512;  // 16 warps per forward block
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kTcThreads = 256;   // 8 warps per backward block
constexpr int kSlab = 64;         // first-layer units per backward block
// The forward's W2: none (one-layer torsos), resident in shared memory,
// or streamed through a ring of two slabs of kSlab rows [kSlab][h2p].
constexpr int kNoW2 = 0, kW2Resident = 1, kW2Streamed = 2;

using bf16 = __nv_bfloat16;

// A bf16 [rows][ld] tile in shared memory. Swizzled tiles (ld a multiple
// of 64) keep 16-byte group c of row r at group c ^ (r & 7); padded tiles
// have ld = width + 8. Either way the 8 rows an ldmatrix reads at one
// column group fall in 8 different bank groups.
struct Tile {
  bf16* p;
  int ld;
  bool swz;
};

__device__ __forceinline__ int toff(const Tile& t, int r, int c) {
  return t.swz ? r * t.ld + ((((c >> 3) ^ (r & 7)) << 3) | (c & 7)) : r * t.ld + c;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(unsigned (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)) : "memory");
}

// d += a b on one m16n8k16 tile: bf16 operands, float32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// wgmma (sm_90a) reads its operands from shared memory through
// descriptors. This one is for a bf16 tile in the 128B-swizzle layout:
// 128-byte rows whose 16-byte groups are XOR-swizzled by (row & 7), as
// Tile does at ld = 64, in 1024-byte atoms of 8 rows (the stride byte
// offset). An MN-major operand has one k a row (64 m or n), a K-major one
// 64 k a row (one m or n); no operand spans two 64-wide blocks along a
// row, so the leading byte offset is unused (1). The tile must start on a
// 1024-byte boundary.
__device__ __forceinline__ unsigned long long wgmma_desc(const bf16* p) {
  return static_cast<unsigned long long>((smem_addr(p) & 0x3FFFF) >> 4) | 1ull << 16 |
         static_cast<unsigned long long>(1024 >> 4) << 32 | 1ull << 62;
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous product.
template <int J>
__device__ __forceinline__ void reg_fence(float (&d)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// Before a batch of wgmma (after the accumulators' reg_fence), and after
// it: commit and wait until the batch is done.
__device__ __forceinline__ void wgmma_begin() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_end() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// One warpgroup's D [64 x 64] += A [64 x 16] B [16 x 64], both operands
// MN-major. d [j][e] is element (16 (warp % 4) + g + 8 (e / 2), 8 j + 2 t
// + e % 2) of D: mma.sync's m16n8 fragment, repeated.
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[8][4], unsigned long long da,
                                               unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

// The same for a 64 x 32 tile, d [4][4]. kTA / kTB are 1 for an MN-major
// operand, 0 for a K-major one: 128-byte rows of 64 k per m (or n), the
// same swizzle and atoms, so that a step of 16 k is 32 bytes along a row.
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_64x32x16(float (&d)[4][4], unsigned long long da,
                                               unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(1), "n"(kTA), "n"(kTB)
      : "memory");
}

// And for a 64 x 16 tile, d [2][4].
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_64x16x16(float (&d)[2][4], unsigned long long da,
                                               unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "l"(da), "l"(db), "r"(1), "n"(kTA), "n"(kTB)
      : "memory");
}

// C [64 x 64] (in d) += A^T B over k < K for one warpgroup: A [K][64] and
// B [K][64] MN-major tiles as wgmma_desc takes them.
__device__ __forceinline__ void warpgroup_mma(float (&d)[8][4], const bf16* A,
                                              const bf16* B, int K) {
  const unsigned long long da = wgmma_desc(A), db = wgmma_desc(B);
  reg_fence(d);
  wgmma_begin();
  for (int k0 = 0; k0 < K; k0 += 16)   // 16 rows of 128 bytes: 2048 bytes
    wgmma_64x64x16(d, da + (k0 << 3), db + (k0 << 3));
  wgmma_end();
  reg_fence(d);
}

// Orders this thread's earlier shared-memory stores before later reads of
// the same bytes by wgmma (the async proxy); a barrier must follow.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The A operand of a 16 x 16 step at (m0, k0), stored [m][k] or, kTrans,
// [k][m]. Lane l names row l % 8 of 8 x 8 matrix l / 8; the matrices are
// (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15), (8-15, 8-15).
template <bool kTrans>
__device__ __forceinline__ void load_a(unsigned (&a)[4], const Tile& t, int m0,
                                       int k0, int lane) {
  const int q = lane >> 3, r = lane & 7;
  if (kTrans)
    ldsm_x4_t(a, t.p + toff(t, k0 + (q >> 1) * 8 + r, m0 + (q & 1) * 8));
  else
    ldsm_x4(a, t.p + toff(t, m0 + (q & 1) * 8 + r, k0 + (q >> 1) * 8));
}

// The B operands of two n8 tiles at (k0, n0) and (k0, n0 + 8), stored
// [k][n] (kTrans) or [n][k]: b[0], b[1] for the first, b[2], b[3] for the
// second.
template <bool kTrans>
__device__ __forceinline__ void load_b2(unsigned (&b)[4], const Tile& t, int k0,
                                        int n0, int lane) {
  const int q = lane >> 3, r = lane & 7;
  if (kTrans)
    ldsm_x4_t(b, t.p + toff(t, k0 + (q & 1) * 8 + r, n0 + (q >> 1) * 8));
  else
    ldsm_x4(b, t.p + toff(t, n0 + (q >> 1) * 8 + r, k0 + (q & 1) * 8));
}

template <bool kTrans>
__device__ __forceinline__ void load_b1(unsigned (&b)[2], const Tile& t, int k0,
                                        int n0, int lane) {
  const int q = (lane >> 3) & 1, r = lane & 7;
  if (kTrans)
    ldsm_x2_t(b, t.p + toff(t, k0 + q * 8 + r, n0));
  else
    ldsm_x2(b, t.p + toff(t, n0 + r, k0 + q * 8));
}

// One warp's share of C += A B over k < K (a multiple of 16) on mma.sync:
// m16 tiles at rows m0[i] (those with mv[i]), n8 tiles at columns n0 + 8 j
// for j < NJ (1 or even). acc[i][j][e] is element (m0[i] + g + 8 (e / 2),
// n0 + 8 j + 2 t + e % 2) with g = lane / 4, t = lane % 4.
template <int MI, int NJ, bool kTA, bool kTB>
__device__ __forceinline__ void warp_mma(float (&acc)[MI][NJ][4], const Tile& A,
                                         const int (&m0)[MI], const bool (&mv)[MI],
                                         const Tile& B, int n0, int K, int lane) {
  for (int k0 = 0; k0 < K; k0 += 16) {
    unsigned a[MI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
      if (mv[i]) load_a<kTA>(a[i], A, m0[i], k0, lane);
    if constexpr (NJ == 1) {
      unsigned b[2];
      load_b1<kTB>(b, B, k0, n0, lane);
#pragma unroll
      for (int i = 0; i < MI; ++i)
        if (mv[i]) mma_bf16(acc[i][0], a[i], b[0], b[1]);
    } else {
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        unsigned b[4];
        load_b2<kTB>(b, B, k0, n0 + 8 * j, lane);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          if (!mv[i]) continue;
          mma_bf16(acc[i][j], a[i], b[0], b[1]);
          mma_bf16(acc[i][j + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
}

template <int MI, int NJ>
__device__ __forceinline__ void zero_acc(float (&acc)[MI][NJ][4]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
}

// Two neighbouring elements of a tile (c even) as one 32-bit store.
__device__ __forceinline__ void store_pair(const Tile& t, int r, int c, float x,
                                           float y) {
  *reinterpret_cast<__nv_bfloat162*>(t.p + toff(t, r, c)) = __floats2bfloat162_rn(x, y);
}

// Copy a [rows][cols] bf16 matrix (row stride ld_src, cols a multiple of
// 8) from device memory into a tile, 16 bytes at a time.
__device__ __forceinline__ void copy_in(const Tile& t, const bf16* src,
                                        long long ld_src, int rows, int cols) {
  const int groups = cols / 8;
  for (int e = threadIdx.x; e < rows * groups; e += blockDim.x) {
    const int r = e / groups, c = (e % groups) * 8;
    *reinterpret_cast<uint4*>(t.p + toff(t, r, c)) =
        *reinterpret_cast<const uint4*>(src + r * ld_src + c);
  }
}

// The same copy with cp.async (16 bytes each, through L2 only): the caller
// commits and waits.
__device__ __forceinline__ void copy_in_async(const Tile& t, const bf16* src,
                                              long long ld_src, int rows, int cols) {
  const int groups = cols / 8;
  for (int e = threadIdx.x; e < rows * groups; e += blockDim.x) {
    const int r = e / groups, c = (e % groups) * 8;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(t.p + toff(t, r, c))),
                 "l"(src + r * ld_src + c)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// xb [f1p][M]: the obs columns of the minibatch in its order, rounded to
// bf16, rows f_pad.. zero; eight samples a thread (they never cross a
// shuffle block). Both tensor-core kernels read their obs tiles from it.
__global__ void __launch_bounds__(256) round_obs_kernel(const float* obs, long long n_cols,
                                                        int f_pad, int f1p, const int* idx,
                                                        int block, int M, bf16* xb) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int per_row = M / 8;
  if (e >= static_cast<long long>(f1p) * per_row) return;
  const int r = static_cast<int>(e / per_row), s = static_cast<int>(e % per_row) * 8;
  __nv_bfloat162 p[4];
  float4 v0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), v1 = v0;
  if (r < f_pad) {
    const float* src = obs + r * n_cols + sample_col(s, idx, block);
    v0 = *reinterpret_cast<const float4*>(src);
    v1 = *reinterpret_cast<const float4*>(src + 4);
  }
  p[0] = __floats2bfloat162_rn(v0.x, v0.y);
  p[1] = __floats2bfloat162_rn(v0.z, v0.w);
  p[2] = __floats2bfloat162_rn(v1.x, v1.y);
  p[3] = __floats2bfloat162_rn(v1.z, v1.w);
  *reinterpret_cast<uint4*>(xb + static_cast<long long>(r) * M + s) =
      *reinterpret_cast<const uint4*>(p);
}

struct TcArgs {
  const bf16* w1;   // [f1p][h1p]: W1 rounded, zero-padded
  const bf16* w2;   // [h1p][h2p] (two-layer torsos)
  const bf16* wl;   // [hp][g5p]: the logits head
  const float* b1;  // [h1p]
  const float* b2;  // [h2p]
  const float* bl;  // [g5p]
  const float* wv;  // [hp]: the value head, float32
  const float* bv;  // [1]
  int f_pad, f1p, h1p, h2p, hp, g5p;
  const float* obs;
  long long n_cols;
  const int* idx;
  int block, M, chunk;
  const int* dirs;
  const int* acts;
  const float* logp;
  const float* value;
  const float* ret;
  const float* adv;
  float eps, c_pg, c_v, c_ent;
  bf16* dz;          // [hp][M]: the last torso layer's dz
  bf16* xb;          // [f1p][M]: the rounded obs in minibatch order
  float* part_fwd;   // [chunks][e_fwd]
  int e_fwd;
  float* part_bwd;   // [chunks][e_bwd]
  int e_bwd;
};

// Offsets in a forward partial: dWl [hp][g5p], dbl [g5p], dWv [hp], dbv
// (4 floats), the last layer's db [hp], the metrics [4].
struct FwdLayout {
  int dwl, dbl, dwv, dbv, db, met, size;
  __host__ __device__ FwdLayout(int hp, int g5p)
      : dwl(0), dbl(hp * g5p), dwv(dbl + g5p), dbv(dwv + hp), db(dbv + 4),
        met(db + hp), size(met + 4) {}
};

// Offsets in a backward partial: dW1 [f1p][h1p], then for two-layer
// torsos db1 [h1p] and dW2 [h1p][h2p].
struct BwdLayout {
  int dw1, db1, dw2, size;
  __host__ __device__ BwdLayout(int f1p, int h1p, int h2p, bool two)
      : dw1(0), db1(f1p * h1p), dw2(db1 + h1p),
        size(two ? dw2 + h1p * h2p : db1) {}
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared memory of the forward block, in bytes (the carve-up at its top).
__host__ __device__ inline size_t fwd_smem(int f1p, int h1p, int h2p, int hp,
                                           int g, int w2) {
  const int hmax = h1p > h2p ? h1p : h2p;
  const int g5p = round_up(g * kChoices, 16);
  const int w2_halves = w2 == kW2Resident ? h1p * h2p
                      : w2 == kW2Streamed ? 2 * kSlab * h2p : 0;
  const size_t halves = static_cast<size_t>(f1p) * h1p + w2_halves +
                        hp * (g5p + 8) + f1p * kTS + hmax * kTS + g5p * kTS;
  const size_t floats = static_cast<size_t>(g5p) * kTS + h1p + (w2 ? h2p : 0) +
                        g5p + hp + kFwdWarps * kTS + 8 * kTS + 2 * g * kTS;
  return halves * 2 + floats * 4;
}

// Shared memory of the backward block, in bytes.
__host__ __device__ inline size_t bwd_smem(int f1p, int h2p, bool two) {
  const size_t halves =
      2 * static_cast<size_t>(f1p) * kTS +
      (two ? 2 * h2p * kTS + kSlab * h2p + f1p * kSlab + 2 * kSlab * kTS
           : 2 * kSlab * kTS);
  return halves * 2 + (kSlab + 8 * 16) * 4;
}

// Log-softmax of one 5-way action group in place (r becomes the
// log-probs) and its probabilities p, as the plain version computes them.
__device__ __forceinline__ void group_softmax(float (&r)[kChoices],
                                              float (&p)[kChoices]) {
  float mx = r[0];
#pragma unroll
  for (int k = 1; k < kChoices; ++k) mx = fmaxf(mx, r[k]);
  float ex[kChoices];
#pragma unroll
  for (int k = 0; k < kChoices; ++k) ex[k] = expf(r[k] - mx);
  float z = ex[0];
#pragma unroll
  for (int k = 1; k < kChoices; ++k) z = z + ex[k];
  const float inv_z = 1.0f / z;
  const float logz = logf(z);
#pragma unroll
  for (int k = 0; k < kChoices; ++k) {
    r[k] = r[k] - mx - logz;
    p[k] = ex[k] * inv_z;
  }
}

// Group gi's logits of tile sample sl (s_lg [G5P][kTS] plus the bias) into
// r; returns the action the sample took in that group (packed directions
// s_dpk, actions s_apk).
__device__ __forceinline__ int group_logits(float (&r)[kChoices], const float* s_lg,
                                            const float* s_bl, int gi, int sl,
                                            const int* s_dpk, const int* s_apk) {
#pragma unroll
  for (int k = 0; k < kChoices; ++k)
    r[k] = s_lg[(gi * kChoices + k) * kTS + sl] + s_bl[gi * kChoices + k];
  const int packed = (gi % 2 == 0) ? s_dpk[sl] : s_apk[sl];
  return (packed >> (3 * (gi / 2))) & 7;
}

// Forward, loss and the heads' backward for the samples of one chunk
// (blockIdx.x), kTS at a time, the weights in shared memory (W2 resident
// or streamed, kW2). Sixteen warps of at most 128 registers: four
// warpgroups, warpgroup q making rows 64 q .. 64 q + 63 of each torso
// layer (wgmma), so warp w holds rows 16 w .. 16 w + 15 for all kTS
// samples and keeps the last layer's float32 activations in its registers
// from the forward to tanh' (dh = Wl dlogits takes the same fragment
// layout on mma.sync). Writes the bf16 dz of the last layer and the
// chunk's partial sums (FwdLayout).
template <int G, int kW2>
__global__ void __launch_bounds__(kFwdThreads, 1) tc_forward_kernel(TcArgs a) {
  constexpr bool kTwo = kW2 != kNoW2;
  constexpr int G5 = G * kChoices;
  constexpr int G5P = (G5 + 15) / 16 * 16;
  constexpr int NT = G5P / 8;        // n8 tiles of the heads' dW
  constexpr int MTL = G5P / 16;      // m16 tiles of the logits
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int f1p = a.f1p, h1p = a.h1p, h2p = a.h2p, hp = a.hp;
  const int hmax = h1p > h2p ? h1p : h2p;
  bf16* hp_ptr = reinterpret_cast<bf16*>(smem_raw);
  // W1 and W2 as column blocks [f1p][64] and [h1p][64], MN-major for wgmma
  // (every tile here starts on a 1024-byte boundary: each size is a
  // multiple). Streamed, W2's ring: two slots of h2p / 64 blocks
  // [kSlab][64], slot s holding slabs s, s + 2, .. of each tile.
  bf16* const w1s = hp_ptr;
  hp_ptr += f1p * h1p;
  bf16* const w2s = hp_ptr;
  if (kW2 == kW2Resident) hp_ptr += h1p * h2p;
  if (kW2 == kW2Streamed) hp_ptr += 2 * kSlab * h2p;
  const Tile tWl{hp_ptr, G5P + 8, false};
  hp_ptr += hp * (G5P + 8);
  const Tile tX{hp_ptr, kTS, true};
  hp_ptr += f1p * kTS;
  const Tile tH{hp_ptr, kTS, true};
  hp_ptr += hmax * kTS;
  const Tile tDl{hp_ptr, kTS, true};
  hp_ptr += G5P * kTS;
  float* s_lg = reinterpret_cast<float*>(hp_ptr);   // [G5P][kTS]
  float* s_b1 = s_lg + G5P * kTS;
  float* s_b2 = s_b1 + h1p;
  float* s_bl = s_b2 + (kTwo ? h2p : 0);
  float* s_wv = s_bl + G5P;
  float* s_vp = s_wv + hp;                          // [kFwdWarps][kTS]
  float* s_dv = s_vp + kFwdWarps * kTS;             // [kTS]
  float* s_dlogp = s_dv + kTS;                      // [kTS]
  float* s_taken = s_dlogp + kTS;                   // [G][kTS]
  float* s_ent = s_taken + G * kTS;                 // [G][kTS]
  // the tile's per-sample inputs: old log-prob, old value, return,
  // advantage, packed directions and actions
  float* s_lpo = s_ent + G * kTS;
  float* s_vo = s_lpo + kTS;
  float* s_ret = s_vo + kTS;
  float* s_adv = s_ret + kTS;
  int* s_dpk = reinterpret_cast<int*>(s_adv + kTS);
  int* s_apk = s_dpk + kTS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  if ((smem_addr(smem_raw) & 1023u) != 0) __trap();   // wgmma_desc
  for (int q = 0; q < h1p / 64; ++q)
    copy_in(Tile{w1s + q * f1p * 64, 64, true}, a.w1 + q * 64, h1p, f1p, 64);
  if (kW2 == kW2Resident)
    for (int q = 0; q < h2p / 64; ++q)
      copy_in(Tile{w2s + q * h1p * 64, 64, true}, a.w2 + q * 64, h2p, h1p, 64);
  fence_async_shared();
  for (int e = tid; e < hp * (G5P / 8); e += kFwdThreads) {
    const int r = e / (G5P / 8), c = (e % (G5P / 8)) * 8;
    *reinterpret_cast<uint4*>(tWl.p + toff(tWl, r, c)) =
        *reinterpret_cast<const uint4*>(a.wl + r * G5P + c);
  }
  for (int e = tid; e < G5P * kTS; e += kFwdThreads)
    tDl.p[e] = __float2bfloat16_rn(0.0f);
  for (int e = tid; e < h1p; e += kFwdThreads) s_b1[e] = a.b1[e];
  if (kTwo)
    for (int e = tid; e < h2p; e += kFwdThreads) s_b2[e] = a.b2[e];
  for (int e = tid; e < G5P; e += kFwdThreads) s_bl[e] = a.bl[e];
  for (int e = tid; e < hp; e += kFwdThreads) s_wv[e] = a.wv[e];
  const float* b_last = kTwo ? s_b2 : s_b1;
  const float bv = a.bv[0];

  const int m0[1] = {16 * warp};
  const bool mv1[1] = {m0[0] < h1p};
  const bool mvl[1] = {m0[0] < hp};
  // the logits: warp w takes samples 8 (w % 8) .. + 7 of the m16 tiles i
  // with i % 2 == w / 8
  const int n_lg = 8 * (warp & 7);
  int ml0[MTL];
  bool mlv[MTL];
#pragma unroll
  for (int i = 0; i < MTL; ++i) {
    ml0[i] = 16 * i;
    mlv[i] = i % 2 == (warp >> 3);
  }

  // running sums over the chunk
  float dwl[1][NT][4];
  zero_acc(dwl);
  float db_run[2] = {0.0f, 0.0f};
  float dwv_run[2] = {0.0f, 0.0f};
  float m_pg = 0.0f, m_v = 0.0f, m_ent = 0.0f, m_kl = 0.0f;
  float dbl_run = 0.0f, dbv_run = 0.0f;

  const int s_begin = blockIdx.x * a.chunk;
  const int s_end = min(a.M, s_begin + a.chunk);
  // A tile's obs (from xb) and per-sample rows arrive by cp.async, issued
  // during the previous tile as soon as their buffers are free. The rows
  // (old log-prob, old value, return, advantage, packed directions and
  // actions) are contiguous at s_lpo, 16 bytes a thread.
  auto prefetch_obs = [&](int s) {
    copy_in_async(tX, a.xb + s, a.M, f1p, kTS);
    cp_async_commit();
  };
  auto prefetch_rows = [&](int s) {
    if (tid < 6 * (kTS / 4)) {
      const int q = tid / (kTS / 4), c = (tid % (kTS / 4)) * 4;
      const long long col = sample_col(s, a.idx, a.block) + c;
      const void* src = q == 0 ? static_cast<const void*>(a.logp + col)
                      : q == 1 ? static_cast<const void*>(a.value + col)
                      : q == 2 ? static_cast<const void*>(a.ret + col)
                      : q == 3 ? static_cast<const void*>(a.adv + s + c)
                      : q == 4 ? static_cast<const void*>(a.dirs + col)
                               : static_cast<const void*>(a.acts + col);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_addr(s_lpo + q * kTS + c)),
                   "l"(src)
                   : "memory");
    }
    cp_async_commit();
  };
  // Streamed W2: slab j (rows kSlab j .. + kSlab - 1, every column) into
  // slot j % 2 as h2p / 64 blocks [kSlab][64], 16 bytes a thread.
  const int n_w2 = h1p / kSlab;
  auto prefetch_w2 = [&](int j) {
    bf16* const slot = w2s + (j & 1) * kSlab * h2p;
    const bf16* const src = a.w2 + static_cast<long long>(j) * kSlab * h2p;
    const int groups = h2p / 8;
    for (int e = tid; e < kSlab * groups; e += kFwdThreads) {
      const int r = e / groups, c = (e % groups) * 8;
      const Tile t{slot + (c >> 6) * kSlab * 64, 64, true};
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_addr(t.p + toff(t, r, c & 63))),
                   "l"(src + r * h2p + c)
                   : "memory");
    }
    cp_async_commit();
  };
  auto prefetch_w2_first = [&]() {   // a tile's slabs 0 and 1
    prefetch_w2(0);
    if (n_w2 > 1) prefetch_w2(1);
  };
  prefetch_obs(s_begin);
  prefetch_rows(s_begin);
  if (kW2 == kW2Streamed) prefetch_w2_first();
  float h[1][8][4];
  for (int s0 = s_begin; s0 < s_end; s0 += kTS) {
    const bool more = s0 + kTS < s_end;
    cp_async_wait<0>();
    fence_async_shared();   // the obs tile, for wgmma
    __syncthreads();   // this tile's inputs have landed; the last one is done
    // ---- torso: h = tanh(W^T x + b), the last layer kept in registers;
    // warpgroup q makes rows 64 q .. 64 q + 63, warp w of them 16 w ..
    zero_acc(h);
    if (mv1[0]) warpgroup_mma(h[0], w1s + (warp >> 2) * f1p * 64, tX.p, f1p);
    if (kTwo) {
      if (mv1[0]) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = m0[0] + g + 8 * hh, c = 8 * j + 2 * t4;
            store_pair(tH, r, c, tanhf(h[0][j][2 * hh] + s_b1[r]),
                       tanhf(h[0][j][2 * hh + 1] + s_b1[r]));
          }
      }
      fence_async_shared();
      __syncthreads();
      zero_acc(h);
      if (kW2 == kW2Resident) {
        if (mvl[0]) warpgroup_mma(h[0], w2s + (warp >> 2) * h1p * 64, tH.p, h1p);
      } else {
        // slab by slab over k, in the resident order of the k steps:
        // slabs 0 and 1 landed with the tile's inputs; slab j + 1 is
        // copied into the slot of slab j - 1 while slab j is multiplied
        for (int j = 0; j < n_w2; ++j) {
          if (j > 0) {
            cp_async_wait<0>();
            fence_async_shared();   // slab j, for wgmma
            __syncthreads();   // slab j has landed; every warp is done with j - 1
            if (j + 1 < n_w2) prefetch_w2(j + 1);
          }
          if (mvl[0])
            warpgroup_mma(h[0], w2s + (j & 1) * kSlab * h2p + (warp >> 2) * kSlab * 64,
                          tH.p + j * kSlab * kTS, kSlab);
        }
      }
      __syncthreads();   // every warp is done reading h1 (and W2's ring)
      if (kW2 == kW2Streamed && more) prefetch_w2_first();
    }
    float vp[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) vp[j][0] = vp[j][1] = 0.0f;
    if (mvl[0]) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = m0[0] + g + 8 * hh, c = 8 * j + 2 * t4;
          const float x0 = tanhf(h[0][j][2 * hh] + b_last[r]);
          const float x1 = tanhf(h[0][j][2 * hh + 1] + b_last[r]);
          h[0][j][2 * hh] = x0;
          h[0][j][2 * hh + 1] = x1;
          store_pair(tH, r, c, x0, x1);
          vp[j][0] = vp[j][0] + s_wv[r] * x0;
          vp[j][1] = vp[j][1] + s_wv[r] * x1;
        }
    }
    // the value head: this warp's rows summed over the lanes of a column
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float v = vp[j][c];
        v = v + __shfl_xor_sync(0xffffffffu, v, 4);
        v = v + __shfl_xor_sync(0xffffffffu, v, 8);
        v = v + __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) s_vp[warp * kTS + 8 * j + 2 * t4 + c] = v;
      }
    __syncthreads();
    if (more) prefetch_obs(s0 + kTS);   // layer 1 is done with the obs tile
    // ---- logits [G5P][kTS]
    {
      float lg[MTL][1][4];
      zero_acc(lg);
      warp_mma<MTL, 1, true, true>(lg, tWl, ml0, mlv, tH, n_lg, hp, lane);
#pragma unroll
      for (int i = 0; i < MTL; ++i) {
        if (!mlv[i]) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s_lg[(16 * i + g + 8 * (e >> 1)) * kTS + n_lg + 2 * t4 + (e & 1)] =
              lg[i][0][e];
      }
    }
    __syncthreads();
    // ---- the loss: each (group, sample) pair's log-softmax, taken
    // log-prob and entropy; then per sample the ratio, the clips and the
    // value loss; then each pair's dlogits (its log-softmax recomputed by
    // the same code, so the same bits)
    for (int pi = tid; pi < G * kTS; pi += kFwdThreads) {
      const int gi = pi / kTS, sl = pi % kTS;
      float r[kChoices], p[kChoices];
      const int act = group_logits(r, s_lg, s_bl, gi, sl, s_dpk, s_apk);
      group_softmax(r, p);
      float taken = r[0];
      float ent = -p[0] * r[0];
#pragma unroll
      for (int k = 1; k < kChoices; ++k) {
        taken = (act == k) ? r[k] : taken;
        ent = ent - p[k] * r[k];
      }
      s_taken[gi * kTS + sl] = taken;
      s_ent[gi * kTS + sl] = ent;
    }
    __syncthreads();
    if (tid < kTS) {
      float logp_tot = s_taken[tid], ent_tot = s_ent[tid];
#pragma unroll
      for (int gi = 1; gi < G; ++gi) {
        logp_tot = logp_tot + s_taken[gi * kTS + tid];
        ent_tot = ent_tot + s_ent[gi * kTS + tid];
      }
      float v = s_vp[tid];
#pragma unroll
      for (int w = 1; w < kFwdWarps; ++w) v = v + s_vp[w * kTS + tid];
      v = v + bv;
      const float lo = 1.0f - a.eps, hi = 1.0f + a.eps;
      const float lp_old = s_lpo[tid];
      const float a_n = s_adv[tid];
      const float ratio = expf(logp_tot - lp_old);
      const float pg1 = ratio * a_n;
      const float pg2 = fminf(fmaxf(ratio, lo), hi) * a_n;
      const float inclip = (ratio >= lo && ratio <= hi) ? 1.0f : 0.0f;
      const float pick = pg1 <= pg2 ? 1.0f : inclip;
      const float vo = s_vo[tid];
      const float dv_raw = v - vo;
      const float v_cl = vo + fminf(fmaxf(dv_raw, -a.eps), a.eps);
      const float e1 = v - s_ret[tid], e2 = v_cl - s_ret[tid];
      const float inclip_v = (dv_raw >= -a.eps && dv_raw <= a.eps) ? 1.0f : 0.0f;
      s_dlogp[tid] = -a.c_pg * a_n * ratio * pick;
      s_dv[tid] = a.c_v * (e1 * e1 >= e2 * e2 ? e1 : e2 * inclip_v);
      m_pg = m_pg + -fminf(pg1, pg2);
      m_v = m_v + 0.5f * fmaxf(e1 * e1, e2 * e2);
      m_ent = m_ent + ent_tot;
      m_kl = m_kl + ((ratio - 1.0f) - (logp_tot - lp_old));
    }
    __syncthreads();
    for (int pi = tid; pi < G * kTS; pi += kFwdThreads) {
      const int gi = pi / kTS, sl = pi % kTS;
      float r[kChoices], p[kChoices];
      const int act = group_logits(r, s_lg, s_bl, gi, sl, s_dpk, s_apk);
      group_softmax(r, p);
      const float dlogp = s_dlogp[sl];
      float h_g = 0.0f;
#pragma unroll
      for (int k = 0; k < kChoices; ++k) h_g = h_g - p[k] * r[k];
#pragma unroll
      for (int k = 0; k < kChoices; ++k) {
        const float onehot = act == k ? 1.0f : 0.0f;
        const float dl = dlogp * (onehot - p[k]) + a.c_ent * p[k] * (r[k] + h_g);
        const int row = gi * kChoices + k;
        s_lg[row * kTS + sl] = dl;
        tDl.p[toff(tDl, row, sl)] = __float2bfloat16_rn(dl);
      }
    }
    __syncthreads();
    if (more) prefetch_rows(s0 + kTS);   // the loss is done with the rows
    // ---- the heads' gradients and backward
    if (tid < G5) {
      float sum = 0.0f;
      for (int s = 0; s < kTS; ++s) sum = sum + s_lg[tid * kTS + s];
      dbl_run = dbl_run + sum;
    } else if (tid == kFwdThreads - 1) {
      float sum = 0.0f;
      for (int s = 0; s < kTS; ++s) sum = sum + s_dv[s];
      dbv_run = dbv_run + sum;
    }
    {
      float dh[1][8][4];
      zero_acc(dh);
      warp_mma<1, 8, false, true>(dh, tWl, m0, mvl, tDl, 0, G5P, lane);
      // dz = (Wl dlogits + wv dvalue) (1 - h^2), h float32
      if (mvl[0]) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = m0[0] + g + 8 * (e >> 1), c = 8 * j + 2 * t4 + (e & 1);
            const float dv = s_dv[c], hv = h[0][j][e];
            const float z = (dh[0][j][e] + s_wv[r] * dv) * (1.0f - hv * hv);
            db_run[e >> 1] = db_run[e >> 1] + z;
            dwv_run[e >> 1] = dwv_run[e >> 1] + hv * dv;
            h[0][j][e] = z;   // h now holds dz
          }
      }
    }
    // dWl += h dlogits^T over this tile's samples
    warp_mma<1, NT, false, false>(dwl, tH, m0, mvl, tDl, 0, kTS, lane);
    __syncthreads();   // every warp is done reading h
    if (mvl[0]) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          store_pair(tH, m0[0] + g + 8 * hh, 8 * j + 2 * t4, h[0][j][2 * hh],
                     h[0][j][2 * hh + 1]);
    }
    __syncthreads();
    for (int e = tid; e < hp * (kTS / 8); e += kFwdThreads) {
      const int r = e / (kTS / 8), c = (e % (kTS / 8)) * 8;
      *reinterpret_cast<uint4*>(a.dz + static_cast<long long>(r) * a.M + s0 + c) =
          *reinterpret_cast<const uint4*>(tH.p + toff(tH, r, c));
    }
  }

  // ---- the chunk's partial sums, in a fixed order
  const FwdLayout L(hp, G5P);
  float* part = a.part_fwd + static_cast<long long>(blockIdx.x) * a.e_fwd;
  if (mvl[0]) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[L.dwl + (m0[0] + g + 8 * (e >> 1)) * G5P + 8 * j + 2 * t4 + (e & 1)] =
            dwl[0][j][e];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float db = db_run[hh], dw = dwv_run[hh];
      db = db + __shfl_xor_sync(0xffffffffu, db, 1);
      db = db + __shfl_xor_sync(0xffffffffu, db, 2);
      dw = dw + __shfl_xor_sync(0xffffffffu, dw, 1);
      dw = dw + __shfl_xor_sync(0xffffffffu, dw, 2);
      if (t4 == 0) {
        part[L.db + m0[0] + g + 8 * hh] = db;
        part[L.dwv + m0[0] + g + 8 * hh] = dw;
      }
    }
  }
  if (tid < G5P) part[L.dbl + tid] = tid < G5 ? dbl_run : 0.0f;
  if (tid == kFwdThreads - 1) part[L.dbv] = dbv_run;
  __syncthreads();
  const float sums[4] = {m_pg, m_v, m_ent, m_kl};
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (tid < kTS) s_vp[q * kTS + tid] = sums[q];
  __syncthreads();
  if (tid < 4) {
    float total = 0.0f;
    for (int s = 0; s < kTS; ++s) total = total + s_vp[tid * kTS + s];
    part[L.met + tid] = total;
  }
}

// The torso's weight gradients for one chunk of samples (blockIdx.x /
// n_slabs) and one slab of kSlab first-layer units (blockIdx.x % n_slabs,
// so a chunk's slabs run side by side and share its tiles in L2). Each
// tile's rounded obs (the forward's xb) and dz arrive by cp.async one tile
// ahead, into the other of two buffers. Two-layer torsos: h1 of the slab
// recomputed from the obs with the forward's instruction (the same bits),
// dh1 = W2 dz2 for its rows, dz1 = dh1 (1 - h1^2), then dW2 [slab
// rows][h2p] += h1 dz2^T, db1 and dW1 [f1p][slab] += x dz1^T. One-layer
// torsos: dz1 is the forward's dz; only dW1. Every product is wgmma with
// the slab's 64 rows as M, warpgroup q taking samples 32 q .. + 31 of h1
// and dh1, columns q h2p / 2 .. of dW2 and the 16-wide column blocks q and
// q + 2 of dW1^T [slab][f1p]; warp w holds rows 16 (w % 4) .. + 15.
template <bool kTwo>
__global__ void __launch_bounds__(kTcThreads, 1) tc_backward_kernel(TcArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int f1p = a.f1p, h1p = a.h1p, h2p = a.h2p;
  const int n_slabs = h1p / kSlab;
  const int chunk_id = blockIdx.x / n_slabs, slab = blockIdx.x % n_slabs;
  const int u0 = slab * kSlab;
  // two buffers of (obs tile, dz tile): dz2 [h2p][kTS] or dz1 [kSlab][kTS]
  const int dz_rows = kTwo ? h2p : kSlab;
  bf16* hp_ptr = reinterpret_cast<bf16*>(smem_raw);
  const int buf_halves = (f1p + dz_rows) * kTS;     // one (obs, dz) buffer
  hp_ptr += 2 * buf_halves;
  // rows u0.. of W2 as h2p / 64 blocks [kSlab][64], K-major for wgmma
  // (every tile here starts on a 1024-byte boundary)
  bf16* const w2k = hp_ptr;
  const Tile tW1{w2k + kSlab * h2p, kSlab, true};      // columns u0.. of W1
  const Tile tH1{tW1.p + f1p * kSlab, kTS, true};
  const Tile tDz1c{tH1.p + kSlab * kTS, kTS, true};    // dz1, computed
  if (kTwo) hp_ptr += kSlab * h2p + f1p * kSlab + 2 * kSlab * kTS;
  float* s_b1 = reinterpret_cast<float*>(hp_ptr);   // [kSlab]
  float* s_red = s_b1 + kSlab;                      // [8][16]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  if ((smem_addr(smem_raw) & 1023u) != 0) __trap();   // wgmma_desc
  const int s_begin = chunk_id * a.chunk;
  const int s_end = min(a.M, s_begin + a.chunk);
  const bf16* dz_src = a.dz + (kTwo ? 0 : static_cast<long long>(u0) * a.M);
  bf16* const base = reinterpret_cast<bf16*>(smem_raw);
  auto x_tile = [&](int b) { return Tile{base + b * buf_halves, kTS, true}; };
  auto dz_tile = [&](int b) { return Tile{base + b * buf_halves + f1p * kTS, kTS, true}; };
  auto prefetch = [&](int s0, int b) {
    copy_in_async(x_tile(b), a.xb + s0, a.M, f1p, kTS);
    copy_in_async(dz_tile(b), dz_src + s0, a.M, dz_rows, kTS);
    cp_async_commit();
  };
  prefetch(s_begin, 0);
  if (kTwo) {
    for (int kb = 0; kb < h2p / 64; ++kb)
      copy_in(Tile{w2k + kb * kSlab * 64, 64, true},
              a.w2 + static_cast<long long>(u0) * h2p + kb * 64, h2p, kSlab, 64);
    copy_in(tW1, a.w1 + u0, h1p, f1p, kSlab);
    for (int e = tid; e < kSlab; e += kTcThreads) s_b1[e] = a.b1[u0 + e];
  }
  const int mi = warp & 3, half = warp >> 2;
  const int nb2 = h2p / 64;            // dW2 n32 blocks per warpgroup
  // dW1^T [slab][f1p] in n16 blocks, block i to warpgroup i % 2
  const int nb1 = f1p / 16;
  float dw2[4][4][4];
  float dw1[2][2][4];
  zero_acc(dw2);
  zero_acc(dw1);
  float db1[2] = {0.0f, 0.0f};

  int buf = 0;
  for (int s0 = s_begin; s0 < s_end; s0 += kTS, buf ^= 1) {
    if (s0 + kTS < s_end) {
      prefetch(s0 + kTS, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();   // the landed tiles (and W2), for wgmma
    __syncthreads();   // this tile's buffers have landed for every thread
    const Tile tX_ = x_tile(buf);
    const Tile tDz_ = dz_tile(buf);
    if (kTwo) {
      // h1 = W1^T x (the forward's instruction, so the same bits) and dh1 =
      // W2 dz2 for samples 32 half .. + 31 (64 bytes into each row of the
      // MN-major x and dz2 tiles): A the MN-major W1 slab, then the K-major
      // W2 blocks
      float hv[4][4], dh[4][4];
      {
        const unsigned long long dw = wgmma_desc(tW1.p), dx = wgmma_desc(tX_.p) + 4 * half;
        const unsigned long long da = wgmma_desc(w2k), db = wgmma_desc(tDz_.p) + 4 * half;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) hv[j][e] = dh[j][e] = 0.0f;
        reg_fence(hv);
        reg_fence(dh);
        wgmma_begin();
        for (int k0 = 0; k0 < f1p; k0 += 16)
          wgmma_64x32x16<1, 1>(hv, dw + (k0 << 3), dx + (k0 << 3));
        for (int k0 = 0; k0 < h2p; k0 += 16)
          wgmma_64x32x16<0, 1>(dh, da + (k0 >> 6) * (kSlab * 64 * 2 >> 4) + ((k0 & 63) >> 3),
                               db + (k0 << 3));
        wgmma_end();
        reg_fence(hv);
        reg_fence(dh);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = 16 * mi + g + 8 * hh, c = 32 * half + 8 * j + 2 * t4;
          const float x0 = tanhf(hv[j][2 * hh] + s_b1[r]);
          const float x1 = tanhf(hv[j][2 * hh + 1] + s_b1[r]);
          store_pair(tH1, r, c, x0, x1);
          const float z0 = dh[j][2 * hh] * (1.0f - x0 * x0);
          const float z1 = dh[j][2 * hh + 1] * (1.0f - x1 * x1);
          db1[hh] = db1[hh] + z0;
          db1[hh] = db1[hh] + z1;
          store_pair(tDz1c, r, c, z0, z1);
        }
      fence_async_shared();   // h1 and dz1, for wgmma
      __syncthreads();
    }
    // dW2 [slab][h2p] += h1 dz2^T (two-layer torsos): A the K-major h1
    // tile, B the dz2 tile read K-major (its rows are the columns of dW2),
    // 32 columns a block. dW1^T [slab][f1p] += dz1 x^T: A the K-major dz1
    // tile (one-layer torsos: the forward's dz), B the x tile read K-major.
    {
      const unsigned long long dh1 = wgmma_desc(tH1.p);
      const unsigned long long dz2 = wgmma_desc(tDz_.p + half * (h2p / 2) * kTS);
      const unsigned long long dz1 = wgmma_desc(kTwo ? tDz1c.p : tDz_.p);
      const unsigned long long dx = wgmma_desc(tX_.p);
#pragma unroll
      for (int b = 0; b < 4; ++b) reg_fence(dw2[b]);
      reg_fence(dw1[0]);
      reg_fence(dw1[1]);
      wgmma_begin();
#pragma unroll
      for (int k0 = 0; k0 < kTS; k0 += 16) {   // 16 k: 32 bytes along a row
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (kTwo && b < nb2)
            wgmma_64x32x16<0, 0>(dw2[b], dh1 + (k0 >> 3),
                                 dz2 + b * (32 * 128 >> 4) + (k0 >> 3));
        // blocks half and half + 2 with no branch (a branch on the warp
        // would make ptxas serialize every wgmma here); a block past f1p
        // reads other rows of the same buffer and is not written out
#pragma unroll
        for (int li = 0; li < 2; ++li)
          wgmma_64x16x16<0, 0>(dw1[li], dz1 + (k0 >> 3),
                               dx + (2 * li + half) * (16 * 128 >> 4) + (k0 >> 3));
      }
      wgmma_end();
#pragma unroll
      for (int b = 0; b < 4; ++b) reg_fence(dw2[b]);
      reg_fence(dw1[0]);
      reg_fence(dw1[1]);
    }
    __syncthreads();   // every warp is done with this tile's buffers
  }

  // ---- the partial sums of this chunk and slab
  const BwdLayout L(f1p, h1p, h2p, kTwo);
  float* part = a.part_bwd + static_cast<long long>(chunk_id) * a.e_bwd;
#pragma unroll
  for (int li = 0; li < 2; ++li) {
    if (2 * li + half >= nb1) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[L.dw1 + (16 * (2 * li + half) + 8 * j + 2 * t4 + (e & 1)) * h1p + u0 +
             16 * mi + g + 8 * (e >> 1)] = dw1[li][j][e];
  }
  if (kTwo) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (b >= nb2) break;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part[L.dw2 + (u0 + 16 * mi + g + 8 * (e >> 1)) * h2p + half * (h2p / 2) +
               32 * b + 8 * j + 2 * t4 + (e & 1)] = dw2[b][j][e];
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float v = db1[hh];
      v = v + __shfl_xor_sync(0xffffffffu, v, 1);
      v = v + __shfl_xor_sync(0xffffffffu, v, 2);
      if (t4 == 0) s_red[warp * 16 + g + 8 * hh] = v;
    }
    __syncthreads();
    if (tid < kSlab) {
      const int w0 = tid / 16, r = tid % 16;
      part[L.db1 + u0 + tid] = s_red[w0 * 16 + r] + s_red[(w0 + 4) * 16 + r];
    }
  }
}

template <int G, int kW2>
cudaError_t launch_tc(const TcArgs& a, int n_chunks, cudaStream_t stream) {
  constexpr bool kTwo = kW2 != kNoW2;
  const size_t smem_f = fwd_smem(a.f1p, a.h1p, a.h2p, a.hp, G, kW2);
  const size_t smem_b = bwd_smem(a.f1p, a.h2p, kTwo);
  cudaError_t err = cudaFuncSetAttribute(tc_forward_kernel<G, kW2>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_f));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(tc_backward_kernel<kTwo>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_b));
  if (err != cudaSuccess) return err;
  const long long n_xb = static_cast<long long>(a.f1p) * (a.M / 8);
  round_obs_kernel<<<static_cast<unsigned>((n_xb + 255) / 256), 256, 0, stream>>>(
      a.obs, a.n_cols, a.f_pad, a.f1p, a.idx, a.block, a.M, a.xb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tc_forward_kernel<G, kW2><<<n_chunks, kFwdThreads, smem_f, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tc_backward_kernel<kTwo><<<n_chunks * (a.h1p / kSlab), kTcThreads, smem_b, stream>>>(a);
  return cudaGetLastError();
}

template <int kW2>
cudaError_t launch_tc_any(int G, const TcArgs& a, int n_chunks, cudaStream_t stream) {
  switch (G) {
    case 2: return launch_tc<2, kW2>(a, n_chunks, stream);
    case 4: return launch_tc<4, kW2>(a, n_chunks, stream);
    case 6: return launch_tc<6, kW2>(a, n_chunks, stream);
    case 8: return launch_tc<8, kW2>(a, n_chunks, stream);
    case 10: return launch_tc<10, kW2>(a, n_chunks, stream);
    default: return cudaErrorInvalidValue;
  }
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

// The bf16 path on the tensor cores for torsos of one or two layers.
// Weights arrive rounded and zero-padded (w1 [f1p][h1p], w2 [h1p][h2p],
// wl [hp][g5p] bf16; b1, b2, bl, wv float32 padded alike), h2p = 0 for one
// layer; w2_stream 1 streams W2 through the forward's ring, 0 keeps it
// resident (two-layer torsos). dz is bf16 [hp][M]; part_fwd / part_bwd
// hold one FwdLayout / BwdLayout per chunk, summed in a fixed order into
// out_fwd / out_bwd.
int futbol_fused_update_tc(const void* w1, const void* w2, const void* wl,
                           const float* b1, const float* b2, const float* bl,
                           const float* wv, const float* bv, int f_pad, int f1p,
                           int h1p, int h2p, int g, int w2_stream, const float* obs,
                           long long n_cols, const int* idx, int mb_blocks,
                           int block, const int* dirs, const int* acts,
                           const float* logp, const float* value,
                           const float* ret, const float* adv_n, float eps,
                           float c_pg, float c_v, float c_ent, void* dz,
                           void* xb, float* part_fwd, float* part_bwd, int chunk,
                           float* out_fwd, float* out_bwd, cudaStream_t stream) {
  const bool two = h2p > 0;
  const int hp = two ? h2p : h1p;
  const int g5p = round_up(g * kChoices, 16);
  if (block % 128 != 0 || chunk % kTS != 0 || f1p % 16 != 0 || f1p > 64 ||
      f_pad > f1p || h1p % kSlab != 0 || h1p < kSlab || h1p > 256 ||
      h2p % kSlab != 0 || h2p > 256 || (w2_stream && !two))
    return static_cast<int>(cudaErrorInvalidValue);
  const int M = mb_blocks * block;
  const int n_chunks = (M + chunk - 1) / chunk;
  const FwdLayout lf(hp, g5p);
  const BwdLayout lb(f1p, h1p, h2p, two);
  TcArgs a;
  a.w1 = static_cast<const bf16*>(w1);
  a.w2 = static_cast<const bf16*>(w2);
  a.wl = static_cast<const bf16*>(wl);
  a.b1 = b1;
  a.b2 = b2;
  a.bl = bl;
  a.wv = wv;
  a.bv = bv;
  a.f_pad = f_pad;
  a.f1p = f1p;
  a.h1p = h1p;
  a.h2p = h2p;
  a.hp = hp;
  a.g5p = g5p;
  a.obs = obs;
  a.n_cols = n_cols;
  a.idx = idx;
  a.block = block;
  a.M = M;
  a.chunk = chunk;
  a.dirs = dirs;
  a.acts = acts;
  a.logp = logp;
  a.value = value;
  a.ret = ret;
  a.adv = adv_n;
  a.eps = eps;
  a.c_pg = c_pg;
  a.c_v = c_v;
  a.c_ent = c_ent;
  a.dz = static_cast<bf16*>(dz);
  a.xb = static_cast<bf16*>(xb);
  a.part_fwd = part_fwd;
  a.e_fwd = lf.size;
  a.part_bwd = part_bwd;
  a.e_bwd = lb.size;
  cudaError_t err = !two        ? launch_tc_any<kNoW2>(g, a, n_chunks, stream)
                    : w2_stream ? launch_tc_any<kW2Streamed>(g, a, n_chunks, stream)
                                : launch_tc_any<kW2Resident>(g, a, n_chunks, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_reduce(part_fwd, n_chunks, lf.size, lf.size, out_fwd, stream);
  launch_reduce(part_bwd, n_chunks, lb.size, lb.size, out_bwd, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
