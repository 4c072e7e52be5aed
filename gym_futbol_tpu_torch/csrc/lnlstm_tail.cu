// LayerNorm's backward tail of the layer-normalised LSTM's BPTT node, for
// NVIDIA Hopper (sm_90a), CUDA C++: lnlstm_tail_kernel and
// lnlstm_tail_sum_kernel.
//
// Replaces no TPU kernel: the JAX package's recurrent update
// differentiates the cell with jax.grad. After K6-LN's backward kernel
// (fused_bptt_tc.cu) the node (ops/fused_bptt.py, _LnLstmBptt.backward)
// owes, over the window's n = T S rows:
// - t Wi's LayerNorm input gradient, dx = rx (gd - mean(gd) - x^
//   mean(gd x^)), gd = gx dpre, x^ = (x - mux) rx, the means over the
//   row's 4H columns, handed to the products of dWi and dt as its two
//   bf16 terms (hi = bf16(dx), lo = bf16(dx - hi), fused_bptt._split);
// - the six LayerNorm parameters' gradients, column sums over the rows:
//   dgx = sum dpre x^, dgh = sum dpre y^ (y^ from the saved y = h Wh and
//   its statistics), db = sum dpre (the gradient of b, bx and bh alike:
//   all three add to the same pre-activation), dgc = sum dn c^ and dbc =
//   sum dn (c^ from the saved c' and its statistics).
// PyTorch ran this as three native_layer_norm_backward calls, a copy of
// c' out of the forward kernel's fragment order and the split of an f32
// dx: dpre read three times, dx written in f32 and read back (~58 GB a
// minibatch of 8192 sequences x 128 steps at H = 256, PERF.md §6).
//
// Bound: bytes. One pass reads dpre, x and y once ([n, 4H] f32 each), dn
// and c' once ([n, H] f32), each row's four statistics, and writes dx as
// two bf16 [n, 4H]: ~19.4 GB at the cell's shape, 5.8 ms at 3.35 TB/s.
// The operations (~20 a column) are far below the card's rate.
//
// Design. A block of 128 threads walks rows, blocks striding over them; a
// row's threads (32, 64 or 128, by H) each own two units, the float4 of
// a unit's four gate columns (i, f, g, o: the columns are unit-major), so
// a warp's loads and stores of a row are 512- and 256-byte runs. Thread
// t of a row also owns units 4 t .. 4 t + 3 of c' and dn: c' is read in
// place from the forward kernel's fragment order, where a row's eight
// units of an octet are 32 contiguous bytes (one sector). The row's two
// sums (gd, gd x^) go through the warp's shuffles and one shared slot per
// warp (two sets, alternating by row, so one barrier a row). A thread's
// loads of its next row are issued before this row's barrier, so a row's
// ~16 KB a block are in flight while the one before is reduced and
// written: at four blocks of 128 registers a thread an SM, 6.67 ms a
// minibatch of the cell against 7.80 without (one H100, PERF.md §6).
// Each thread keeps its columns' five sums in registers across its rows,
// in f32; at the end the block's row groups add theirs in a fixed order
// and the block writes one partial row [14 H] of floats. lnlstm_tail_sum_kernel
// adds the blocks' partials in a fixed order: no atomics, so a run
// repeats bitwise on a card (the grid is fixed by the caller).
//
// C interface for ctypes; the entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;      // a block
constexpr int kUnits = 2;          // units of the 4H columns a thread owns in a row
constexpr int kMaxUnits = 256;     // H (4H <= 1024)
constexpr int kSums = 3 * kUnits + 2;   // float4 sums a thread keeps
constexpr int kSumWarps = 8;       // warps a block of the sum over blocks
constexpr int kBlocksPerSm = 4;    // 128 registers a thread (fused_bptt.TAIL_BLOCKS_PER_SM)

// Threads a row: the least of 32, 64, 128 whose kUnits units a thread
// cover H.
__host__ __device__ __forceinline__ int row_threads(int hs) {
  return hs <= 32 * kUnits ? 32 : hs <= 64 * kUnits ? 64 : 128;
}

struct TailArgs {
  const float4* dpre;   // [n, H] (i, f, g, o): the gates' pre-activation gradient
  const float4* x;      // [n, H] (i, f, g, o): t Wi before its LayerNorm
  const float* mux;     // [n]: x's row mean
  const float* rx;      // [n]: x's row 1 / sqrt(var + eps)
  const float4* gx;     // [H] (i, f, g, o): t Wi's LayerNorm gain
  const float4* y;      // [n, H] (i, f, g, o): h_{t-1} Wh before its LayerNorm
  const float2* st_h;   // [n]: y's row (mean, 1 / sqrt(var + eps))
  const float4* dn;     // [n, H / 4]: LN(c')'s output's gradient
  const float4* c;      // c' in fragment order [T, ceil(S / 64), hp / 8, 64 rows, 2]
  const float2* st_c;   // [n]: c''s row (mean, 1 / sqrt(var + eps))
  uint2* dx_hi;         // [n, H]: dx's four bf16 hi terms of a unit
  uint2* dx_lo;         // [n, H]: and its lo terms
  float4* dx32;         // [n, H]: dx in f32 too, where not null
  float4* part;         // [gridDim.x, 14 H / 4]: dgx, db, dgh [4H] each, dgc, dbc [H]
  long long n;          // rows, T S
  int S, hs, nblk, n_oct;
};

__device__ __forceinline__ float4 sub_mul(float4 v, float m, float r) {
  return make_float4((v.x - m) * r, (v.y - m) * r, (v.z - m) * r, (v.w - m) * r);
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

__device__ __forceinline__ void add4(float4& acc, float4 v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

// Two f32 values as bf16 (hi), and bf16 of what hi leaves (lo).
__device__ __forceinline__ void split2(float a, float b, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// A row's inputs as thread t of its group reads them: its units' dpre, x
// and y, its four units of dn and c', and the row's statistics.
struct RowIn {
  float4 d[kUnits], x[kUnits], y[kUnits], dn, c;
  float mu, rs;
  float2 sh, sc;
};

__device__ __forceinline__ void load_row(RowIn& in, const TailArgs& a, long long r, int t,
                                         int tpr, const bool (&own)[kUnits], bool own_c) {
  in.mu = __ldg(a.mux + r);
  in.rs = __ldg(a.rx + r);
  in.sh = __ldg(a.st_h + r);
#pragma unroll
  for (int j = 0; j < kUnits; ++j) {
    if (!own[j]) continue;
    const size_t at = static_cast<size_t>(r) * a.hs + t + j * tpr;
    in.d[j] = __ldg(a.dpre + at);
    in.x[j] = __ldg(a.x + at);
    in.y[j] = __ldg(a.y + at);
  }
  if (own_c) {
    // c' of units 4 t .. 4 t + 3: octet t / 2, half t % 2, at the row's
    // 32 bytes of the octet (fragment order: row 16 m + 8 hh + g's
    // octet entries are mh = 2 m + hh, lanes 4 g .. 4 g + 3, jl)
    const long long step = r / a.S;
    const int s = static_cast<int>(r - step * a.S);
    const size_t at = ((static_cast<size_t>(step) * a.nblk + s / 64) * a.n_oct + t / 2) * 128 +
                      (s % 64) * 2 + t % 2;
    in.sc = __ldg(a.st_c + r);
    in.dn = __ldg(a.dn + static_cast<size_t>(r) * (a.hs / 4) + t);
    in.c = __ldg(a.c + at);
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm) lnlstm_tail_kernel(const TailArgs a) {
  __shared__ float2 row_sum[2][kThreads / 32];
  __shared__ float4 group_sum[kSums * (kThreads - 32)];
  const int tpr = row_threads(a.hs);
  const int groups = kThreads / tpr, wpr = tpr / 32;
  const int grp = threadIdx.x / tpr, t = threadIdx.x % tpr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hs = a.hs;
  bool own[kUnits];
  float4 gx[kUnits];
#pragma unroll
  for (int j = 0; j < kUnits; ++j) {
    own[j] = t + j * tpr < hs;
    gx[j] = own[j] ? __ldg(a.gx + t + j * tpr) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const bool own_c = 4 * t < hs;
  float4 sums[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) sums[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float inv = 1.0f / static_cast<float>(4 * hs);
  const long long stride = static_cast<long long>(gridDim.x) * groups;
  RowIn in;
  if (static_cast<long long>(blockIdx.x) * groups + grp < a.n)
    load_row(in, a, static_cast<long long>(blockIdx.x) * groups + grp, t, tpr, own, own_c);
  int set = 0;
  for (long long base = static_cast<long long>(blockIdx.x) * groups; base < a.n;
       base += stride, set ^= 1) {
    const long long r = base + grp;
    const bool row = r < a.n;
    float4 d[kUnits], xh[kUnits];
    const float rs = in.rs;
    float s1 = 0.f, s2 = 0.f;
    if (row) {
#pragma unroll
      for (int j = 0; j < kUnits; ++j) {
        if (!own[j]) continue;
        d[j] = in.d[j];
        xh[j] = sub_mul(in.x[j], in.mu, rs);
        const float4 yh = sub_mul(in.y[j], in.sh.x, in.sh.y);
        const float4 gd = mul4(gx[j], d[j]);
        const float4 gdx = mul4(gd, xh[j]);
        s1 += ((gd.x + gd.y) + (gd.z + gd.w));
        s2 += ((gdx.x + gdx.y) + (gdx.z + gdx.w));
        add4(sums[3 * j], mul4(d[j], xh[j]));
        add4(sums[3 * j + 1], d[j]);
        add4(sums[3 * j + 2], mul4(d[j], yh));
      }
      if (own_c) {
        add4(sums[3 * kUnits], mul4(in.dn, sub_mul(in.c, in.sc.x, in.sc.y)));
        add4(sums[3 * kUnits + 1], in.dn);
      }
    }
    // the next row's loads fly while this row is reduced and written
    if (r + stride < a.n) load_row(in, a, r + stride, t, tpr, own, own_c);
#pragma unroll
    for (int o = 16; o > 0; o /= 2) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    if (lane == 0) row_sum[set][warp] = make_float2(s1, s2);
    __syncthreads();
    if (row) {
      float m1 = 0.f, m2 = 0.f;
      for (int w = 0; w < wpr; ++w) {
        const float2 v = row_sum[set][grp * wpr + w];
        m1 += v.x;
        m2 += v.y;
      }
      m1 *= inv;
      m2 *= inv;
#pragma unroll
      for (int j = 0; j < kUnits; ++j) {
        if (!own[j]) continue;
        const size_t at = static_cast<size_t>(r) * hs + t + j * tpr;
        const float4 gd = mul4(gx[j], d[j]);
        const float4 dx = make_float4(rs * ((gd.x - m1) - xh[j].x * m2),
                                      rs * ((gd.y - m1) - xh[j].y * m2),
                                      rs * ((gd.z - m1) - xh[j].z * m2),
                                      rs * ((gd.w - m1) - xh[j].w * m2));
        uint2 hi, lo;
        split2(dx.x, dx.y, hi.x, lo.x);
        split2(dx.z, dx.w, hi.y, lo.y);
        a.dx_hi[at] = hi;
        a.dx_lo[at] = lo;
        if (a.dx32 != nullptr) a.dx32[at] = dx;
      }
    }
  }
  // The block's row groups' sums, group 0's then the others' in order.
  if (grp > 0) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) group_sum[k * (kThreads - 32) + threadIdx.x - tpr] = sums[k];
  }
  __syncthreads();
  if (grp > 0) return;
  for (int g = 1; g < groups; ++g) {
#pragma unroll
    for (int k = 0; k < kSums; ++k)
      add4(sums[k], group_sum[k * (kThreads - 32) + (g - 1) * tpr + t]);
  }
  float4* out = a.part + static_cast<size_t>(blockIdx.x) * (14 * hs / 4);
#pragma unroll
  for (int j = 0; j < kUnits; ++j) {
    if (!own[j]) continue;
    const int u = t + j * tpr;
    out[u] = sums[3 * j];                   // dgx
    out[hs + u] = sums[3 * j + 1];          // db
    out[2 * hs + u] = sums[3 * j + 2];      // dgh
  }
  if (own_c) {
    out[3 * hs + t] = sums[3 * kUnits];                 // dgc
    out[3 * hs + hs / 4 + t] = sums[3 * kUnits + 1];    // dbc
  }
}

// out[c] = sum over p of part[p][c], p in order within each of the
// block's warps (warp w: p = w, w + 8, ...), then the warps in order.
__global__ void __launch_bounds__(32 * kSumWarps)
    lnlstm_tail_sum_kernel(const float* __restrict__ part, float* __restrict__ out, int P,
                           int C) {
  __shared__ float acc[kSumWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < C)
    for (int p = warp; p < P; p += kSumWarps) s += part[static_cast<size_t>(p) * C + c];
  acc[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < C) {
    float v = acc[0][lane];
    for (int w = 1; w < kSumWarps; ++w) v += acc[w][lane];
    out[c] = v;
  }
}

}  // namespace

extern "C" {

// dpre, x, y: f32 [T, S, 4H] (unit-major columns); mux, rx: f32 [T S];
// gx: f32 [4H] unit-major; st_h, st_c: f32 [T, S, 2]; dn: f32 [T, S, H];
// c: c' in the forward kernel's fragment order; dx_hi, dx_lo: bf16 [T, S,
// 4H]; dx32: f32 [T, S, 4H] or null; part: f32 [blocks, 14 H]; sums: f32
// [14 H] (dgx, db, dgh unit-major [4H] each, then dgc, dbc [H]).
int futbol_lnlstm_tail(const void* dpre, const void* x, const float* mux, const float* rx,
                       const void* gx, const void* y, const void* st_h, const void* dn,
                       const void* c, const void* st_c, void* dx_hi, void* dx_lo, void* dx32,
                       float* part, float* sums, int S, int T, int hs, int blocks,
                       void* stream) {
  if (S < 1 || T < 1 || hs < 4 || hs % 4 != 0 || hs > kMaxUnits || blocks < 1)
    return cudaErrorInvalidValue;
  const int hp = (hs + 15) / 16 * 16;
  const TailArgs a{static_cast<const float4*>(dpre), static_cast<const float4*>(x), mux, rx,
                   static_cast<const float4*>(gx), static_cast<const float4*>(y),
                   static_cast<const float2*>(st_h), static_cast<const float4*>(dn),
                   static_cast<const float4*>(c), static_cast<const float2*>(st_c),
                   static_cast<uint2*>(dx_hi), static_cast<uint2*>(dx_lo),
                   static_cast<float4*>(dx32), reinterpret_cast<float4*>(part),
                   static_cast<long long>(T) * S, S, hs, (S + 63) / 64, hp / 8};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  lnlstm_tail_kernel<<<blocks, kThreads, 0, st>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int C = 14 * hs;
  lnlstm_tail_sum_kernel<<<(C + 31) / 32, 32 * kSumWarps, 0, st>>>(part, sums, blocks, C);
  return cudaGetLastError();
}

}  // extern "C"
