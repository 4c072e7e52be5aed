// Self-play policy rollouts for NVIDIA Hopper (sm_90a), CUDA C++: the
// policy forward, action sampling and the env step in one launch.
//
// Replaces two Pallas TPU kernels:
// - fused_collect (gym_futbol_tpu/ops/fused_collect.py, body
//   _collect_kernel): PPO experience collection. Each step, both views
//   (team 0, and team 1 in its mirrored frame) go through one per-team
//   actor-critic (tanh torso, logits head, value head); the kernel samples
//   each view's actions with their joint log-prob, un-mirrors team 1's
//   directions, steps the env with auto-reset and writes the trajectory
//   buffer; after the loop, the bootstrap values of the carried state.
// - fused_selfplay_rollout (gym_futbol_tpu/ops/fused_actor.py, body
//   _selfplay_kernel): policy-vs-policy play, team 0 on MLP A and team 1
//   on MLP B (tanh between layers, none after the last); writes the
//   team-0 reward per step and the per-env goal totals.
// The plain PyTorch versions are fused_collect_reference
// (ops/fused_collect.py) and fused_selfplay_rollout_reference
// (ops/fused_actor.py), operation for operation.
//
// Design. Lane l of warp 0 owns env blockIdx.x * 32 + l for the whole
// rollout, its state in registers as in fused_rollout.cu, and the step
// is futbol_step.cuh's. The MLP needs a column of activations per env
// (obs, then each layer's output), too large for registers, so the
// block keeps its 32 envs' columns in two ping-pong buffers in dynamic
// shared memory, laid out [row][env] so a warp's accesses hit 32
// distinct banks. Four warps share each dense layer: warp w computes
// output chunks w, w + 4, ... of kChunk outputs for all 32 envs (lane =
// env), in registers: for each input k in ascending order,
// acc[j] = acc[j] + W[k][o0 + j] * x[k]; the bias is added last, then
// tanh where the layer is not the last; a barrier closes each layer.
// That order is the plain version's, and with --fmad=false every product
// and sum is rounded as it is there. Warp 0 alone builds the obs,
// samples the actions and steps the env while warps 1-3 wait at the
// next barrier. Threads without an env (past B, the ragged edge) take
// part in every barrier and skip the rest.
//
// Against the design this started from: the weights are not staged
// through shared memory. Every thread of a warp reads the same weights
// at the same time (lanes are envs), so a warp's weight load is one
// broadcast served from L1/L2 (the flat weights, 327 KB at hidden
// (256, 256), stay resident in the 50 MB L2). Four warps share the
// layers because bench config 6's 4096 envs make only 128 blocks of 32:
// with one warp per block, each SM's single warp would wait on its
// weight loads with no other warp to hide the latency.
//
// What bounds it: the MLP is 2 * (sum of in * out) multiply-adds per env
// step, 162k at 3v3 with hidden (256, 256), done as separate FP32 mul and
// add (no FMA); the shared-memory columns (2 * rows * 4 bytes per env, 2
// KB at width 256) and 255 registers per thread cap a block's residency
// (two blocks per SM at width 256). So it is bound by FP32 issue and
// load latency at low occupancy, not by bytes.
//
// Draws per step (Philox of futbol_step.cuh, or the uniforms table):
// view 0's G = 2 * players_per_team group uniforms, view 1's G, the two
// uniforms of the kick angle, kickoff x per body, kickoff y per body.
//
// C interface for ctypes; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstring>

#include "futbol_step.cuh"

namespace {

using namespace futbol;

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
// MIRROR) into rows 0..F-1 of `x`, F = 4 * NB + 2, positions scaled by
// the reciprocals as _obs_matrix scales them. With `obs` non-null, also
// row f to obs[f * row_stride], zeros in rows F..f_pad-1.
template <int NB, bool MIRROR>
__device__ __forceinline__ void build_obs(const Env<NB>& e, const ObsConsts& oc,
                                          float* x, float* __restrict__ obs,
                                          size_t row_stride, int f_pad) {
  constexpr int PPT = (NB - 1) / 2;
  constexpr int F = 4 * NB + 2;
  float v[F];
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
#pragma unroll
  for (int f = 0; f < F; ++f) x[f * kBlock] = v[f];
  if (obs != nullptr) {
#pragma unroll
    for (int f = 0; f < F; ++f) obs[f * row_stride] = v[f];
    for (int f = F; f < f_pad; ++f) obs[f * row_stride] = 0.0f;
  }
}

// The MLP over the column whose rows 0..in[0]-1 hold the input (in
// col.a), computed by the block's warps together: warp w takes output
// chunks w, w + kWarps, ... of every layer, with a barrier after each
// layer. Called by every thread of the block; returns the buffer holding
// the last layer's outputs.
__device__ __forceinline__ const float* mlp_forward(const float* __restrict__ w,
                                                    const Mlp& m, Column col,
                                                    int warp) {
  float* x = col.a;
  float* y = col.b;
  for (int l = 0; l < m.n_layers; ++l) {
    dense(w + m.w_off[l], w + m.b_off[l], m.in[l], m.out_pad[l], x, y,
          l < m.n_layers - 1, warp * kChunk, kWarps * kChunk);
    __syncthreads();
    float* t = x;
    x = y;
    y = t;
  }
  return x;
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

// One block's whole collect (the body of collect_kernel), run by all its
// threads: lane l of warp 0 owns env blockIdx.x * kBlock + l and alone
// builds its obs, samples, steps it and stores; every warp joins each
// dense layer. Threads without an env (past B) take part in every
// barrier and skip the rest.
template <int NB>
__device__ __forceinline__ void collect_block(float* smem, int rows,
                                              const float* __restrict__ sf_in,
                                              const int* __restrict__ si_in,
                                              float* __restrict__ sf_out,
                                              int* __restrict__ si_out,
                                              const float* __restrict__ w, const Mlp& m,
                                              const CollectOut& out,
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
  const size_t row_stride = static_cast<size_t>(T) * B;
  Env<NB> e;
  if (owner) load_env<NB>(e, sf_in, si_in, B, b);
#pragma unroll 1
  for (int step = 0; step < T; ++step) {
    int ia[G], ib[G];
    float lp[2], val[2];
    float* o0 = out.obs + static_cast<size_t>(step) * B + b;
    if (owner) build_obs<NB, false>(e, oc, col.a, o0, row_stride, f_pad);
    __syncthreads();
    const float* y = mlp_forward(w, m, col, warp);
    if (owner) {
      lp[0] = sample_groups<G>(y, table, seed, ND, B, step, b, 0, ia);
      val[0] = y[G * kChoices * kBlock];
      build_obs<NB, true>(e, oc, col.a, o0 + f_pad * row_stride, row_stride, f_pad);
    }
    __syncthreads();
    y = mlp_forward(w, m, col, warp);
    if (owner) {
      lp[1] = sample_groups<G>(y, table, seed, ND, B, step, b, G, ib);
      val[1] = y[G * kChoices * kBlock];
      int dp[2], ap[2];
      pack<G>(ia, dp[0], ap[0]);
      pack<G>(ib, dp[1], ap[1]);
      int dirs[NPL], acts[NPL];
      joint_action<NPL>(ia, ib, dirs, acts);
      float nzx[NB], nzy[NB];
      const float theta =
          env_noise<NB>(table, seed, ND, B, step, b, c.kick_noise, nzx, nzy);
      bool goal0, goal1;
      float r[2];
      r[0] = step_dynamics<NB>(e, dirs, acts, theta, c, k, goal0, goal1, r[1]);
      const int done = step_finish<NB>(e, goal0, goal1, nzx, nzy, c, k) ? 1 : 0;
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
    }
  }
  // bootstrap values of the carried (post-reset) state
  if (owner) build_obs<NB, false>(e, oc, col.a, nullptr, 0, 0);
  __syncthreads();
  const float* y = mlp_forward(w, m, col, warp);
  if (owner) {
    out.last_value[b] = y[G * kChoices * kBlock];
    build_obs<NB, true>(e, oc, col.a, nullptr, 0, 0);
  }
  __syncthreads();
  y = mlp_forward(w, m, col, warp);
  if (owner) {
    out.last_value[static_cast<size_t>(B) + b] = y[G * kChoices * kBlock];
    store_env<NB>(e, sf_out, si_out, B, b);
  }
}

// One block's whole policy-vs-policy rollout (the body of
// selfplay_kernel), shared out as in collect_block. With
// `dirs_out`/`acts_out` non-null, also each view's packed actions
// [T, 2, B] in its own frame.
template <int NB>
__device__ __forceinline__ void selfplay_block(float* smem, int rows,
                                               const float* __restrict__ sf_in,
                                               const int* __restrict__ si_in,
                                               float* __restrict__ sf_out,
                                               int* __restrict__ si_out,
                                               const float* __restrict__ wa, const Mlp& ma,
                                               const float* __restrict__ wb, const Mlp& mb,
                                               float* __restrict__ reward,
                                               int* __restrict__ goals,
                                               int* __restrict__ dirs_out,
                                               int* __restrict__ acts_out,
                                               const float* __restrict__ table,
                                               uint32_t seed, int B, int T,
                                               const Consts& c, const Ints& k,
                                               const ObsConsts& oc) {
  constexpr int NPL = NB - 1;
  constexpr int ND = 2 * NPL + 2 + 2 * NB;
  constexpr int G = NPL;
  const int lane = threadIdx.x % kBlock, warp = threadIdx.x / kBlock;
  const int b = blockIdx.x * kBlock + lane;
  const bool owner = warp == 0 && b < B;
  const Column col{smem + lane, smem + rows * kBlock + lane};
  Env<NB> e;
  if (owner) load_env<NB>(e, sf_in, si_in, B, b);
  int g0 = 0, g1 = 0;
#pragma unroll 1
  for (int step = 0; step < T; ++step) {
    int ia[G], ib[G];
    if (owner) build_obs<NB, false>(e, oc, col.a, nullptr, 0, 0);
    __syncthreads();
    const float* y = mlp_forward(wa, ma, col, warp);
    if (owner) {
      sample_groups<G>(y, table, seed, ND, B, step, b, 0, ia);
      build_obs<NB, true>(e, oc, col.a, nullptr, 0, 0);
    }
    __syncthreads();
    y = mlp_forward(wb, mb, col, warp);
    if (owner) {
      sample_groups<G>(y, table, seed, ND, B, step, b, G, ib);
      if (dirs_out != nullptr) {
        int dp, ap;
        const size_t i = static_cast<size_t>(step) * 2 * B + b;
        pack<G>(ia, dp, ap);
        dirs_out[i] = dp;
        acts_out[i] = ap;
        pack<G>(ib, dp, ap);
        dirs_out[i + B] = dp;
        acts_out[i + B] = ap;
      }
      int dirs[NPL], acts[NPL];
      joint_action<NPL>(ia, ib, dirs, acts);
      float nzx[NB], nzy[NB];
      const float theta =
          env_noise<NB>(table, seed, ND, B, step, b, c.kick_noise, nzx, nzy);
      bool goal0, goal1;
      float r1;
      reward[static_cast<size_t>(step) * B + b] =
          step_dynamics<NB>(e, dirs, acts, theta, c, k, goal0, goal1, r1);
      g0 += goal0 ? 1 : 0;
      g1 += goal1 ? 1 : 0;
      step_finish<NB>(e, goal0, goal1, nzx, nzy, c, k);
    }
  }
  if (owner) {
    goals[b] = g0;
    goals[static_cast<size_t>(B) + b] = g1;
    store_env<NB>(e, sf_out, si_out, B, b);
  }
}

// ---------------------------------------------------------------------------
// Kernels: kBlock envs and kThreads threads per block, 2 * rows * kBlock
// floats of dynamic shared memory (each env's two column buffers).
// ---------------------------------------------------------------------------

template <int NB>
__global__ void __launch_bounds__(kThreads)
collect_kernel(const float* __restrict__ sf_in, const int* __restrict__ si_in,
               float* __restrict__ sf_out, int* __restrict__ si_out,
               const float* __restrict__ w, Mlp m, int rows, CollectOut out,
               const float* __restrict__ table, uint32_t seed, int B, int T,
               int f_pad, Consts c, Ints k, ObsConsts oc) {
  extern __shared__ float smem[];
  collect_block<NB>(smem, rows, sf_in, si_in, sf_out, si_out, w, m, out, table,
                    seed, B, T, f_pad, c, k, oc);
}

template <int NB>
__global__ void __launch_bounds__(kThreads)
selfplay_kernel(const float* __restrict__ sf_in, const int* __restrict__ si_in,
                float* __restrict__ sf_out, int* __restrict__ si_out,
                const float* __restrict__ wa, Mlp ma, const float* __restrict__ wb,
                Mlp mb, int rows, float* __restrict__ reward, int* __restrict__ goals,
                int* __restrict__ dirs_out, int* __restrict__ acts_out,
                const float* __restrict__ table, uint32_t seed, int B, int T,
                Consts c, Ints k, ObsConsts oc) {
  extern __shared__ float smem[];
  selfplay_block<NB>(smem, rows, sf_in, si_in, sf_out, si_out, wa, ma, wb, mb,
                     reward, goals, dirs_out, acts_out, table, seed, B, T, c, k, oc);
}

// Host side: the MLP table from [n_layers, 4] ints (in, out_pad, w_off,
// b_off); false if it does not fit the kernel's limits.
bool make_mlp(const int* dims, int n_layers, Mlp& m, int& rows) {
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

// Sets the kernel's dynamic shared memory limit to the plan's size; an
// error for a plan the card cannot hold.
template <typename K>
cudaError_t prepare(K kernel, int rows, size_t& smem_bytes) {
  smem_bytes = 2 * static_cast<size_t>(rows) * kBlock * sizeof(float);
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes));
}

}  // namespace

extern "C" {

int futbol_fused_collect(const float* sf_in, const int* si_in, float* sf_out,
                         int* si_out, const float* weights, const int* dims,
                         int n_layers, float* obs, int* dirs, int* acts,
                         float* logp, float* value, float* reward, int* done,
                         float* last_value, const float* table, unsigned int seed,
                         int n_bodies, int B, int T, int f_pad, int substeps,
                         int iterations, int max_steps, const float* consts,
                         int n_consts, const float* obs_consts, void* stream) {
  Mlp m;
  int rows = 4 * n_bodies + 2;
  if (n_consts != kNumConsts || B <= 0 || T < 1 || !make_mlp(dims, n_layers, m, rows) ||
      m.in[0] != 4 * n_bodies + 2 || f_pad < m.in[0] ||
      m.out_pad[n_layers - 1] < (n_bodies - 1) * kChoices + 1)
    return cudaErrorInvalidValue;
  Consts c;
  std::memcpy(&c, consts, sizeof(Consts));
  const Ints k{substeps, iterations, max_steps};
  const ObsConsts oc{obs_consts[0], obs_consts[1], obs_consts[2]};
  const CollectOut out{obs, dirs, acts, logp, value, reward, done, last_value};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + kBlock - 1) / kBlock);
  size_t smem = 0;
  cudaError_t err = cudaErrorInvalidValue;
  switch (n_bodies) {
#define FUTBOL_CASE(NB)                                                          \
  case NB:                                                                       \
    err = prepare(collect_kernel<NB>, rows, smem);                               \
    if (err != cudaSuccess) return err;                                          \
    collect_kernel<NB><<<grid, kThreads, smem, s>>>(sf_in, si_in, sf_out, si_out,  \
                                                  weights, m, rows, out, table,  \
                                                  seed, B, T, f_pad, c, k, oc);  \
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

int futbol_fused_selfplay(const float* sf_in, const int* si_in, float* sf_out,
                          int* si_out, const float* weights_a, const int* dims_a,
                          const float* weights_b, const int* dims_b, int n_layers,
                          float* reward, int* goals, int* dirs, int* acts,
                          const float* table, unsigned int seed, int n_bodies, int B,
                          int T, int substeps, int iterations, int max_steps,
                          const float* consts, int n_consts, const float* obs_consts,
                          void* stream) {
  Mlp ma, mb;
  int rows = 4 * n_bodies + 2;
  const int n_logits = (n_bodies - 1) * kChoices;
  if (n_consts != kNumConsts || B <= 0 || T < 1 ||
      !make_mlp(dims_a, n_layers, ma, rows) || !make_mlp(dims_b, n_layers, mb, rows) ||
      ma.in[0] != 4 * n_bodies + 2 || mb.in[0] != ma.in[0] ||
      ma.out_pad[n_layers - 1] < n_logits || mb.out_pad[n_layers - 1] < n_logits ||
      (dirs == nullptr) != (acts == nullptr))
    return cudaErrorInvalidValue;
  Consts c;
  std::memcpy(&c, consts, sizeof(Consts));
  const Ints k{substeps, iterations, max_steps};
  const ObsConsts oc{obs_consts[0], obs_consts[1], obs_consts[2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + kBlock - 1) / kBlock);
  size_t smem = 0;
  cudaError_t err = cudaErrorInvalidValue;
  switch (n_bodies) {
#define FUTBOL_CASE(NB)                                                          \
  case NB:                                                                       \
    err = prepare(selfplay_kernel<NB>, rows, smem);                              \
    if (err != cudaSuccess) return err;                                          \
    selfplay_kernel<NB><<<grid, kThreads, smem, s>>>(                              \
        sf_in, si_in, sf_out, si_out, weights_a, ma, weights_b, mb, rows,        \
        reward, goals, dirs, acts, table, seed, B, T, c, k, oc);                 \
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
