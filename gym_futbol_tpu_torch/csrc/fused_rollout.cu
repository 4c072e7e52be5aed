// Fused T-step FutbolEnv rollout for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernels of gym_futbol_tpu/ops/fused_rollout.py:
// fused_rollout (body _random_rollout_kernel, step _fused_step) and
// fused_rollout_replay (body _replay_rollout_kernel). The step is the
// scalar-SSA pipeline of gym_futbol_tpu_torch/env.py step_scalars with
// auto-reset, operation for operation in float32; the plain PyTorch
// version of this file is fused_rollout_reference in
// gym_futbol_tpu_torch/ops/fused_rollout.py.
//
// Design. One thread owns one env for the whole rollout: it loads its
// 4*n_bodies floats and 4 ints once (thread b reads row r at r*B + b, so
// a warp's loads coalesce), runs all T steps in registers, writes one
// reward per step, and stores the state at the end: one launch per
// rollout. Each step runs a sequential contact solver (all body pairs in
// a fixed order, solver_iterations x substeps times), so the work is a
// long dependent chain of scalar FP32 operations per env. It is bound by
// neither bytes (a few hundred bytes per env per rollout) nor tensor
// cores, but by the latency of dependent scalar FP32 instructions and
// the rate at which the SMs dispatch them. The body count is a
// template parameter so the body and pair loops unroll and their values
// live in registers; the T, substep and iteration loops stay runtime
// loops to bound code size and build time. Most of that chain is the
// contact solver's sweep over every body pair and (wall, body) pair, and
// most of those constraints touch nothing in a given substep: the step
// runs only the updates that some lane of the warp needs (futbol_step.cuh,
// culling), and draws only what it reads, one Philox per four draws.
// A lane past the batch's end has left the kernel; the warp's votes
// count only the lanes still in it.
//
// The replay runs G lanes per env instead (replay_lanes_kernel,
// futbol_step_lanes.cuh): the env's set-up, integration and per-body
// work spread over its group, and each env walking only its own list of
// active constraints, so a warp does the longest of its 32 / G envs'
// solver work, not the union of 32; or, where that measured faster, one
// thread per env as above (replay_rollout_kernel, G = 0).
// ops/fused_rollout.py replay_plan picks G and the block per team size
// and batch.
//
// The step, its floating-point rules and the Philox draws are shared
// with the policy kernels in futbol_step.cuh. Random mode draws from
// Philox, or from a uniforms table f32 [T, n_draws, B] when given, so the
// kernel and the plain version can consume identical draws.
//
// C interface for ctypes; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstring>

#include "futbol_step.cuh"
#include "futbol_step_lanes.cuh"

namespace {

using namespace futbol;

// 32 threads per block: at B = 4096 this gives 128 blocks, one warp on
// each of 128 of the 132 SMs; larger blocks would leave SMs idle.
constexpr int kBlock = 32;
// The lanes replay's largest block (replay_plan's threads).
constexpr int kMaxLaneThreads = 256;

// Random-policy rollout: draws from Philox, or from `table` when given.
template <int NB>
__global__ void __launch_bounds__(kBlock)
random_rollout_kernel(const float* __restrict__ sf_in, const int* __restrict__ si_in,
                      float* __restrict__ sf_out, int* __restrict__ si_out,
                      float* __restrict__ reward, const float* __restrict__ table,
                      uint32_t seed, int B, int T, Consts c, Ints k) {
  constexpr int NPL = NB - 1;
  constexpr int ND = 2 * NPL + 2 + 2 * NB;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Env<NB> e;
  load_env<NB>(e, sf_in, si_in, B, b);
#pragma unroll 1
  for (int step = 0; step < T; ++step) {
    int dirs[NPL], acts[NPL];
    float u[2 * NPL];
    draw_range<0, 2 * NPL>(table, seed, ND, B, step, b, u);
#pragma unroll
    for (int p = 0; p < NPL; ++p) {
      dirs[p] = randint5_from(u[p]);
      acts[p] = randint5_from(u[NPL + p]);
    }
    const EnvDraws<NB> draws{table, seed, ND, B, step, b, c.kick_noise};
    bool goal0, goal1;
    float r1;
    reward[static_cast<size_t>(step) * B + b] =
        step_dynamics<NB>(e, dirs, acts, draws, c, k, goal0, goal1, r1);
    step_finish<NB>(e, goal0, goal1, draws, c, k);
  }
  store_env<NB>(e, sf_out, si_out, B, b);
}

// Replay rollout: given actions [T, 2*n_players, B] (dir, act per
// player), zero kick and kickoff noise. One thread per env, the culled
// sweep of futbol_step.cuh (the warp's union of active constraints):
// replay_plan's lanes 0, where it measured faster than the lanes kernel
// below; PR 1's kernel, 32 threads a block.
template <int NB>
__global__ void __launch_bounds__(kBlock)
replay_rollout_kernel(const float* __restrict__ sf_in, const int* __restrict__ si_in,
                      float* __restrict__ sf_out, int* __restrict__ si_out,
                      float* __restrict__ reward, const int* __restrict__ actions,
                      int B, int T, Consts c, Ints k) {
  constexpr int NPL = NB - 1;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Env<NB> e;
  load_env<NB>(e, sf_in, si_in, B, b);
  const NoDraws<NB> none;
#pragma unroll 1
  for (int step = 0; step < T; ++step) {
    int dirs[NPL], acts[NPL];
    const int* a = actions + static_cast<size_t>(step) * 2 * NPL * B + b;
#pragma unroll
    for (int p = 0; p < NPL; ++p) {
      dirs[p] = __ldg(a + static_cast<size_t>(2 * p) * B);
      acts[p] = __ldg(a + static_cast<size_t>(2 * p + 1) * B);
    }
    bool goal0, goal1;
    float r1;
    reward[static_cast<size_t>(step) * B + b] =
        step_dynamics<NB>(e, dirs, acts, none, c, k, goal0, goal1, r1);
    step_finish<NB>(e, goal0, goal1, none, c, k);
  }
  store_env<NB>(e, sf_out, si_out, B, b);
}

// The same replay with G lanes per env (futbol_step_lanes.cuh):
// blockDim.x / G envs a block, env e of the block on threads
// [e * G, (e + 1) * G), each env's EnvSlots record in dynamic shared
// memory. Every lane of the group loads the env and its actions and runs
// the rules alike; the physics is spread over the group; the group's
// first lane writes the rewards and the final state. A group past the
// batch's end leaves after the block's one barrier.
template <int NB, int G>
__global__ void __launch_bounds__(kMaxLaneThreads)
replay_lanes_kernel(const float* __restrict__ sf_in, const int* __restrict__ si_in,
                    float* __restrict__ sf_out, int* __restrict__ si_out,
                    float* __restrict__ reward, const int* __restrict__ actions,
                    int B, int T, Consts c, Ints k) {
  constexpr int NPL = NB - 1;
  extern __shared__ float slots[];
  __shared__ unsigned char pair_ij[EnvSlots<NB>::kPairs];
  fill_pair_table<NB>(pair_ij);
  __syncthreads();
  const int g = threadIdx.x % G;
  const int e_blk = threadIdx.x / G;
  const int b = blockIdx.x * (blockDim.x / G) + e_blk;
  if (b >= B) return;
  const LanePhysics<NB, G> phys{slots + e_blk * EnvSlots<NB>::kStride, pair_ij, g,
                                group_mask<G>()};
  Env<NB> e;
  load_env<NB>(e, sf_in, si_in, B, b);
  const NoDraws<NB> none;
#pragma unroll 1
  for (int step = 0; step < T; ++step) {
    int dirs[NPL], acts[NPL];
    const int* a = actions + static_cast<size_t>(step) * 2 * NPL * B + b;
#pragma unroll
    for (int p = 0; p < NPL; ++p) {
      dirs[p] = __ldg(a + static_cast<size_t>(2 * p) * B);
      acts[p] = __ldg(a + static_cast<size_t>(2 * p + 1) * B);
    }
    bool goal0, goal1;
    float r1;
    const float r0 = step_dynamics<NB>(e, dirs, acts, none, c, k, goal0, goal1, r1, phys);
    if (g == 0) reward[static_cast<size_t>(step) * B + b] = r0;
    step_finish<NB>(e, goal0, goal1, none, c, k);
  }
  if (g == 0) store_env<NB>(e, sf_out, si_out, B, b);
}

// Launches replay_lanes_kernel<NB, G> with `threads` a block.
template <int NB, int G>
int launch_replay_lanes(const float* sf_in, const int* si_in, float* sf_out,
                        int* si_out, float* reward, const int* actions, int B, int T,
                        const Consts& c, const Ints& k, int threads, cudaStream_t s) {
  const int envs = threads / G;
  const size_t smem = static_cast<size_t>(envs) * EnvSlots<NB>::kStride * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        replay_lanes_kernel<NB, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  replay_lanes_kernel<NB, G><<<(B + envs - 1) / envs, threads, smem, s>>>(
      sf_in, si_in, sf_out, si_out, reward, actions, B, T, c, k);
  return cudaGetLastError();
}

inline dim3 grid_for(int B) { return dim3((B + kBlock - 1) / kBlock); }

}  // namespace

extern "C" {

int futbol_kernel_num_consts() { return kNumConsts; }

int futbol_fused_rollout_random(const float* sf_in, const int* si_in,
                                float* sf_out, int* si_out, float* reward,
                                const float* table, unsigned int seed,
                                int n_bodies, int B, int T, int substeps,
                                int iterations, int max_steps,
                                const float* consts, int n_consts,
                                void* stream) {
  if (n_consts != kNumConsts || B <= 0 || T < 0) return cudaErrorInvalidValue;
  Consts c;
  std::memcpy(&c, consts, sizeof(Consts));
  const Ints k{substeps, iterations, max_steps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_bodies) {
#define FUTBOL_CASE(NB)                                                     \
  case NB:                                                                  \
    random_rollout_kernel<NB><<<grid_for(B), kBlock, 0, s>>>(               \
        sf_in, si_in, sf_out, si_out, reward, table, seed, B, T, c, k);     \
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

int futbol_fused_rollout_replay(const float* sf_in, const int* si_in,
                                float* sf_out, int* si_out, float* reward,
                                const int* actions, int n_bodies, int B, int T,
                                int substeps, int iterations, int max_steps,
                                const float* consts, int n_consts, int lanes,
                                int threads, void* stream) {
  if (n_consts != kNumConsts || B <= 0 || T < 0) return cudaErrorInvalidValue;
  if (threads < 32 || threads > kMaxLaneThreads || threads % 32 != 0)
    return cudaErrorInvalidValue;
  Consts c;
  std::memcpy(&c, consts, sizeof(Consts));
  const Ints k{substeps, iterations, max_steps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FUTBOL_LANES(NB)                                                      \
  case NB:                                                                    \
    switch (lanes) {                                                          \
      case 0:                                                                 \
        if (threads != kBlock) return cudaErrorInvalidValue;                  \
        replay_rollout_kernel<NB><<<grid_for(B), kBlock, 0, s>>>(             \
            sf_in, si_in, sf_out, si_out, reward, actions, B, T, c, k);       \
        return cudaGetLastError();                                            \
      case 2: return launch_replay_lanes<NB, 2>(sf_in, si_in, sf_out, si_out, \
                                                reward, actions, B, T, c, k,  \
                                                threads, s);                  \
      case 4: return launch_replay_lanes<NB, 4>(sf_in, si_in, sf_out, si_out, \
                                                reward, actions, B, T, c, k,  \
                                                threads, s);                  \
      case 8: return launch_replay_lanes<NB, 8>(sf_in, si_in, sf_out, si_out, \
                                                reward, actions, B, T, c, k,  \
                                                threads, s);                  \
      default: return cudaErrorInvalidValue;                                  \
    }
  switch (n_bodies) {
    FUTBOL_LANES(3)
    FUTBOL_LANES(5)
    FUTBOL_LANES(7)
    FUTBOL_LANES(9)
    FUTBOL_LANES(11)
    default:
      return cudaErrorInvalidValue;
  }
#undef FUTBOL_LANES
}

}  // extern "C"
