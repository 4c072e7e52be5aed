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
// (ops/fused_actor.py), operation for operation, with
// compute_dtype=torch.float32: this file is the exact-f32 route (the
// parity mode); the main path's bf16 route, with the layer products on
// the tensor cores, is fused_policy_tc.cu.
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
// The device helpers shared with fused_recurrent.cu (dense, build_obs,
// sample_groups, joint_action, pack) are in policy_common.cuh.
//
// C interface for ctypes; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstring>

#include "policy_common.cuh"

namespace {

using namespace futbol;

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
      lp[0] = sample_groups<G, 0>(y, table, seed, ND, B, step, b, ia);
      val[0] = y[G * kChoices * kBlock];
      build_obs<NB, true>(e, oc, col.a, o0 + f_pad * row_stride, row_stride, f_pad);
    }
    __syncthreads();
    y = mlp_forward(w, m, col, warp);
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
      sample_groups<G, 0>(y, table, seed, ND, B, step, b, ia);
      build_obs<NB, true>(e, oc, col.a, nullptr, 0, 0);
    }
    __syncthreads();
    y = mlp_forward(wb, mb, col, warp);
    if (owner) {
      sample_groups<G, G>(y, table, seed, ND, B, step, b, ib);
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
      const EnvDraws<NB> draws{table, seed, ND, B, step, b, c.kick_noise};
      bool goal0, goal1;
      float r1;
      reward[static_cast<size_t>(step) * B + b] =
          step_dynamics<NB>(e, dirs, acts, draws, c, k, goal0, goal1, r1);
      g0 += goal0 ? 1 : 0;
      g1 += goal1 ? 1 : 0;
      step_finish<NB>(e, goal0, goal1, draws, c, k);
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
    err = prepare(collect_kernel<NB>, 2 * rows, smem);                           \
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
    err = prepare(selfplay_kernel<NB>, 2 * rows, smem);                          \
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
