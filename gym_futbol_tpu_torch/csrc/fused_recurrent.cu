// Recurrent (LSTM) self-play experience collection for NVIDIA Hopper
// (sm_90a), CUDA C++: the recurrent actor-critic's forward, action
// sampling, the env step and the carry resets in one launch.
//
// Replaces the Pallas TPU kernel fused_recurrent_collect
// (gym_futbol_tpu/ops/fused_recurrent.py, body _recurrent_kernel, cell
// _lstm_cell): the PPO / A2C collect of fused_policy.cu's collect_kernel
// with flax's OptimizedLSTMCell between the torso and the heads. Each
// step, both views go through the tanh torso, the cell on the view's own
// (c, h) carry (gates i, f, g, o; c' = s(f) c + s(i) tanh(g),
// h' = s(o) tanh(c'), s(x) = 1 / (1 + exp(-x))) and the logits and value
// heads; the kernel samples each view's actions, steps the env with
// auto-reset and zeroes both views' carries where the episode ended.
// After the loop, the bootstrap values: a forward of the carried state
// on the carried carries whose own carry advance is not stored. The plain
// PyTorch version is fused_recurrent_collect_reference
// (ops/fused_recurrent.py), operation for operation.
//
// Design: collect_kernel's (policy_common.cuh). Lane l of warp 0 owns env
// blockIdx.x * 32 + l, its state in registers; four warps share each
// dense layer over the envs' activation columns in dynamic shared memory.
// What is new:
// - The cell is one dense layer over the column [t; h] (the torso's
//   output t, then h), its 4H gate columns reordered on the host to unit
//   major (column 4u + g is gate g of unit u). A 16-output register tile
//   is then four units' four gates: the tile's thread sums them as dense()
//   sums any layer (inputs in order, the bias last) and runs the cell for
//   its four units in registers, so no [4H] gate column exists anywhere.
//   The plain version sums each gate in the same order.
// - The carries live in device memory, not in shared memory: the output
//   buffers carry_c, carry_h [2, H, B] (step 0 reads the input carries,
//   which stay unchanged: the BPTT update needs them). With lane = env
//   every row is one coalesced 128-byte line. Each view's h rows are
//   copied into a shared column before its torso (whose barrier orders the
//   copy before the cell reads it); h' goes to another column, read by the
//   heads, and to device memory; c is read and written by the tile's
//   thread only. Shared memory is then (2 * rows + H) columns of 32
//   floats, 48 KB at 3v3 with hidden (128,), H = 128, against 96 KB more
//   if the carries of both views lived there.
// - Resets: warp 0's owner zeroes the env's 4H carry rows after the step
//   where it ended; every other thread reads them only after the next
//   barrier.
//
// What bounds it: 2 * (sum of in * out) multiply-adds per env step, 278k
// at 3v3 with hidden (128,), H = 128 (the cell's [t; h] x [256, 512] is
// 94% of it), as separate FP32 mul and add (no FMA). Bytes are ~1% of
// that time. So it is bound by FP32 issue at the occupancy that 255
// registers a thread and 48 KB per block allow.
//
// C interface for ctypes; the entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstring>

#include "policy_common.cuh"

namespace {

using namespace futbol;

__device__ __forceinline__ float gate_sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// One view's carries, [H, B] rows: read from *_src, written to *_dst
// (null: not written).
struct Carry {
  const float* c_src;
  const float* h_src;
  float* c_dst;
  float* h_dst;
};

// The cell over the column [t; h] (n_t rows of `t`, then hsize rows of
// `h`) for the output chunks o0 = o_begin, o_begin + o_step, ... of its
// 4 * hsize unit-major gate columns. Each chunk is four units u: their c
// is read from cr.c_src, h' goes to row u of `y` and, with cr.c_dst set,
// c' and h' to cr.c_dst and cr.h_dst.
__device__ __forceinline__ void lstm_cell(const float* __restrict__ w,
                                          const float* __restrict__ bias, int n_t,
                                          int hsize, const float* t, const float* h,
                                          float* y, const Carry& cr, int B, int b,
                                          int o_begin, int o_step) {
  const int out = 4 * hsize;
#pragma unroll 1
  for (int o0 = o_begin; o0 < out; o0 += o_step) {
    float acc[kChunk];
    const float x0 = t[0];
#pragma unroll
    for (int q = 0; q < kChunk / 4; ++q) {
      const float4 wv = __ldg(reinterpret_cast<const float4*>(w + o0) + q);
      acc[4 * q] = wv.x * x0;
      acc[4 * q + 1] = wv.y * x0;
      acc[4 * q + 2] = wv.z * x0;
      acc[4 * q + 3] = wv.w * x0;
    }
#pragma unroll 1
    for (int part = 0; part < 2; ++part) {
      const float* x = part == 0 ? t : h;
      const int k0 = part == 0 ? 1 : 0;
      const int n = part == 0 ? n_t : hsize;
      const float* wp = w + static_cast<size_t>(part == 0 ? 0 : n_t) * out + o0;
#pragma unroll 4
      for (int k = k0; k < n; ++k) {
        const float xk = x[k * kBlock];
        const float4* row = reinterpret_cast<const float4*>(wp + static_cast<size_t>(k) * out);
#pragma unroll
        for (int q = 0; q < kChunk / 4; ++q) {
          const float4 wv = __ldg(row + q);
          acc[4 * q] = acc[4 * q] + wv.x * xk;
          acc[4 * q + 1] = acc[4 * q + 1] + wv.y * xk;
          acc[4 * q + 2] = acc[4 * q + 2] + wv.z * xk;
          acc[4 * q + 3] = acc[4 * q + 3] + wv.w * xk;
        }
      }
    }
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < kChunk / 4; ++j) {
      const int u = o0 / 4 + j;
      const float gi = gate_sigmoid(acc[4 * j] + __ldg(bias + o0 + 4 * j));
      const float gf = gate_sigmoid(acc[4 * j + 1] + __ldg(bias + o0 + 4 * j + 1));
      const float gg = tanhf(acc[4 * j + 2] + __ldg(bias + o0 + 4 * j + 2));
      const float go = gate_sigmoid(acc[4 * j + 3] + __ldg(bias + o0 + 4 * j + 3));
      const size_t r = static_cast<size_t>(u) * B + b;
      const float c = gf * cr.c_src[r] + gi * gg;
      const float hn = go * tanhf(c);
      y[u * kBlock] = hn;
      if (cr.c_dst != nullptr) {
        cr.c_dst[r] = c;
        cr.h_dst[r] = hn;
      }
    }
  }
}

// One view's forward, called by every thread of the block after the
// barrier that follows the owner's build_obs into col.a: the view's h
// rows into `hc`, the torso (tanh after every layer) ping-ponging between
// col.a and col.b, the cell (h' into the buffer the torso left free) and
// the heads (logits, then value, into the torso's output buffer, which is
// returned).
__device__ __forceinline__ const float* recurrent_forward(const float* __restrict__ w,
                                                          const Mlp& m, int hsize,
                                                          Column col, float* hc,
                                                          const Carry& cr, int B, int b,
                                                          int warp) {
  if (b < B) {
    for (int u = warp; u < hsize; u += kWarps)
      hc[u * kBlock] = cr.h_src[static_cast<size_t>(u) * B + b];
  }
  const int cell = m.n_layers - 2;
  float* x = col.a;
  float* y = col.b;
  for (int l = 0; l < cell; ++l) {
    dense(w + m.w_off[l], w + m.b_off[l], m.in[l], m.out_pad[l], x, y, true,
          warp * kChunk, kWarps * kChunk);
    __syncthreads();
    float* t = x;
    x = y;
    y = t;
  }
  lstm_cell(w + m.w_off[cell], w + m.b_off[cell], m.in[cell] - hsize, hsize, x, hc,
            y, cr, B, b, warp * kChunk, kWarps * kChunk);
  __syncthreads();
  dense(w + m.w_off[cell + 1], w + m.b_off[cell + 1], hsize, m.out_pad[cell + 1], y,
        x, false, warp * kChunk, kWarps * kChunk);
  __syncthreads();
  return x;
}

// Both views' carries, [2, H, B] each: the input, never written, and the
// output, which holds the carries from the end of step 0 on.
struct CarryIO {
  const float* c_in;
  const float* h_in;
  float* c_out;
  float* h_out;
};

// One block's whole collect (the body of recurrent_kernel), shared out as
// in fused_policy.cu's collect_block.
template <int NB>
__device__ __forceinline__ void recurrent_block(float* smem, int rows, int hsize,
                                                const float* __restrict__ sf_in,
                                                const int* __restrict__ si_in,
                                                float* __restrict__ sf_out,
                                                int* __restrict__ si_out,
                                                const float* __restrict__ w, const Mlp& m,
                                                const CarryIO& io, const CollectOut& out,
                                                const float* __restrict__ table,
                                                uint32_t seed, int B, int T, int f_pad,
                                                const Consts& c, const Ints& k,
                                                const ObsConsts& oc) {
  constexpr int NPL = NB - 1;
  constexpr int ND = 2 * NPL + 2 + 2 * NB;
  constexpr int G = NPL;  // 2 * players_per_team groups per view
  const int lane = threadIdx.x % kBlock, warp = threadIdx.x / kBlock;
  const int b = blockIdx.x * kBlock + lane;
  const bool owner = warp == 0 && b < B;
  const Column col{smem + lane, smem + rows * kBlock + lane};
  float* hc = smem + 2 * rows * kBlock + lane;
  const size_t row_stride = static_cast<size_t>(T) * B;
  const size_t view = static_cast<size_t>(hsize) * B;
  Env<NB> e;
  if (owner) load_env<NB>(e, sf_in, si_in, B, b);
#pragma unroll 1
  for (int step = 0; step < T; ++step) {
    int ia[G], ib[G];
    float lp[2], val[2];
    float* o0 = out.obs + static_cast<size_t>(step) * B + b;
    const float* c_src = step == 0 ? io.c_in : io.c_out;
    const float* h_src = step == 0 ? io.h_in : io.h_out;
    if (owner) build_obs<NB, false>(e, oc, col.a, o0, row_stride, f_pad);
    __syncthreads();
    const float* y = recurrent_forward(
        w, m, hsize, col, hc, Carry{c_src, h_src, io.c_out, io.h_out}, B, b, warp);
    if (owner) {
      lp[0] = sample_groups<G, 0>(y, table, seed, ND, B, step, b, ia);
      val[0] = y[G * kChoices * kBlock];
      build_obs<NB, true>(e, oc, col.a, o0 + f_pad * row_stride, row_stride, f_pad);
    }
    __syncthreads();
    y = recurrent_forward(w, m, hsize, col, hc,
                          Carry{c_src + view, h_src + view, io.c_out + view,
                                io.h_out + view},
                          B, b, warp);
    if (owner) {
      lp[1] = sample_groups<G, G>(y, table, seed, ND, B, step, b, ib);
      val[1] = y[G * kChoices * kBlock];
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
        // both views' carries zeroed where the episode ended
        for (size_t q = b; q < 2 * view; q += B) {
          io.c_out[q] = 0.0f;
          io.h_out[q] = 0.0f;
        }
      }
    }
  }
  // bootstrap values of the carried state on the carried carries; the
  // cell's carry advance is not stored
  if (owner) build_obs<NB, false>(e, oc, col.a, nullptr, 0, 0);
  __syncthreads();
  const float* y = recurrent_forward(
      w, m, hsize, col, hc, Carry{io.c_out, io.h_out, nullptr, nullptr}, B, b, warp);
  if (owner) {
    out.last_value[b] = y[G * kChoices * kBlock];
    build_obs<NB, true>(e, oc, col.a, nullptr, 0, 0);
  }
  __syncthreads();
  y = recurrent_forward(w, m, hsize, col, hc,
                        Carry{io.c_out + view, io.h_out + view, nullptr, nullptr}, B,
                        b, warp);
  if (owner) {
    out.last_value[static_cast<size_t>(B) + b] = y[G * kChoices * kBlock];
    store_env<NB>(e, sf_out, si_out, B, b);
  }
}

// kBlock envs and kThreads threads per block; (2 * rows + hsize) * kBlock
// floats of dynamic shared memory (two activation buffers per env and its
// h column).
template <int NB>
__global__ void __launch_bounds__(kThreads)
recurrent_kernel(const float* __restrict__ sf_in, const int* __restrict__ si_in,
                 float* __restrict__ sf_out, int* __restrict__ si_out,
                 const float* __restrict__ w, Mlp m, int rows, int hsize, CarryIO io,
                 CollectOut out, const float* __restrict__ table, uint32_t seed, int B,
                 int T, int f_pad, Consts c, Ints k, ObsConsts oc) {
  extern __shared__ float smem[];
  recurrent_block<NB>(smem, rows, hsize, sf_in, si_in, sf_out, si_out, w, m, io, out,
                      table, seed, B, T, f_pad, c, k, oc);
}

// Host side: the plan from the [n_torso + 2, 4] layer table (torso layers,
// the cell with in = n_t + H and out_pad = 4H, the heads with in = H);
// false if it does not fit the kernel. `rows` becomes the widest column
// (the obs, a torso output, h', the heads' outputs).
bool make_recurrent(const int* dims, int n_torso, int hsize, Mlp& m, int& rows) {
  if (n_torso < 1 || n_torso + 2 > kMaxLayers || hsize < 4 || hsize % 4 != 0 ||
      !make_mlp(dims, n_torso, m, rows))
    return false;
  const int cell = n_torso, heads = n_torso + 1;
  for (int l = cell; l <= heads; ++l) {
    m.in[l] = dims[4 * l];
    m.out_pad[l] = dims[4 * l + 1];
    m.w_off[l] = dims[4 * l + 2];
    m.b_off[l] = dims[4 * l + 3];
    if (m.out_pad[l] < kChunk || m.out_pad[l] % kChunk != 0 || m.w_off[l] % 4 != 0)
      return false;
  }
  const int n_t = m.in[cell] - hsize;
  if (n_t < 1 || n_t > m.out_pad[cell - 1] || m.out_pad[cell] != 4 * hsize ||
      m.in[heads] != hsize)
    return false;
  m.n_layers = n_torso + 2;
  rows = hsize > rows ? hsize : rows;
  rows = m.out_pad[heads] > rows ? m.out_pad[heads] : rows;
  return true;
}

}  // namespace

extern "C" {

int futbol_fused_recurrent(const float* sf_in, const int* si_in, float* sf_out,
                           int* si_out, const float* weights, const int* dims,
                           int n_torso, int hsize, const float* c_in, const float* h_in,
                           float* c_out, float* h_out, float* obs, int* dirs, int* acts,
                           float* logp, float* value, float* reward, int* done,
                           float* last_value, const float* table, unsigned int seed,
                           int n_bodies, int B, int T, int f_pad, int substeps,
                           int iterations, int max_steps, const float* consts,
                           int n_consts, const float* obs_consts, void* stream) {
  Mlp m;
  int rows = 4 * n_bodies + 2;
  if (n_consts != kNumConsts || B <= 0 || T < 1 ||
      !make_recurrent(dims, n_torso, hsize, m, rows) || m.in[0] != 4 * n_bodies + 2 ||
      f_pad < m.in[0] || m.out_pad[n_torso + 1] < (n_bodies - 1) * kChoices + 1)
    return cudaErrorInvalidValue;
  Consts c;
  std::memcpy(&c, consts, sizeof(Consts));
  const Ints k{substeps, iterations, max_steps};
  const ObsConsts oc{obs_consts[0], obs_consts[1], obs_consts[2]};
  const CarryIO io{c_in, h_in, c_out, h_out};
  const CollectOut out{obs, dirs, acts, logp, value, reward, done, last_value};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + kBlock - 1) / kBlock);
  size_t smem = 0;
  cudaError_t err = cudaErrorInvalidValue;
  switch (n_bodies) {
#define FUTBOL_CASE(NB)                                                          \
  case NB:                                                                       \
    err = prepare(recurrent_kernel<NB>, 2 * rows + hsize, smem);                 \
    if (err != cudaSuccess) return err;                                          \
    recurrent_kernel<NB><<<grid, kThreads, smem, s>>>(                             \
        sf_in, si_in, sf_out, si_out, weights, m, rows, hsize, io, out, table,    \
        seed, B, T, f_pad, c, k, oc);                                            \
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

}  // extern "C"
