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
// Design. Each env runs the whole rollout inside one launch: it loads
// its 4*n_bodies floats and 4 ints once, runs all T steps on chip,
// writes one reward per step, and stores the state at the end. Each step
// runs a sequential contact solver (every active body pair and (wall,
// body) pair in a fixed order, solver_iterations x substeps times), so
// the work is a long dependent chain of scalar FP32 operations per env,
// bound by neither bytes (a few hundred bytes per env per rollout) nor
// tensor cores, but by the latency of dependent scalar FP32 instructions
// and the rate at which the SMs dispatch them.
//
// Both modes (random_rollout_kernel and replay_rollout_kernel, each a
// template on the body count NB and the lanes per env G, over one body,
// rollout) run G lanes per env (G = 2, 4, 8; futbol_step_lanes.cuh):
// env e of a block on threads [e * G, (e + 1) * G), its positions,
// velocities and per-constraint solver state in an EnvSlots record in
// shared memory; the env's integration and set-up spread over its group,
// and the group's first lane walking the env's own list of active
// constraints, so a warp does the longest of its 32 / G envs' solver
// work, not the union of 32, and a batch of B envs fills G * B / 32
// warps, enough to hide the chain's latency where one thread per env
// gives an SM one warp. Every lane of a group loads the env, takes its
// actions (random mode: draws keyed by the env, the same bits on every
// lane) and runs the rules alike; the first lane writes the rewards and
// the final state.
//
// Where it measured faster, one thread per env instead (G = 0, the
// original design): the env in registers, 32 threads a block, the step's
// culled solver running each update that some lane of the warp needs
// (futbol_step.cuh, culling), a lane past the batch's end out of the
// warp's votes. ops/fused_rollout.py rollout_plan picks G and the block
// per team size and batch for both modes; the C entries take (lanes,
// threads) and refuse any other layout. Both modes draw only what they
// read, one Philox per four draws.
//
// The step, its floating-point rules and the Philox draws are shared
// with the policy kernels in futbol_step.cuh. Random mode draws from
// Philox, or from a uniforms table f32 [T, n_draws, B] when given, so the
// kernel and the plain version can consume identical draws.
//
// C interface for ctypes; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstring>
#include <type_traits>

#include "futbol_step.cuh"
#include "futbol_step_lanes.cuh"

namespace {

using namespace futbol;

// The one-thread-per-env block (G = 0): at B = 4096, 128 blocks, one
// warp on each of 128 of the 132 SMs.
constexpr int kBlock = 32;
// The lanes route's largest block (the plan's threads).
constexpr int kMaxLaneThreads = 256;

// A layout the kernels take: one thread per env in kBlock threads, or 2,
// 4 or 8 lanes an env in whole warps up to kMaxLaneThreads.
inline bool layout_ok(int lanes, int threads) {
  if (threads < 32 || threads > kMaxLaneThreads || threads % 32 != 0) return false;
  return lanes == 0 ? threads == kBlock : lanes == 2 || lanes == 4 || lanes == 8;
}

// Where a rollout's actions come from (at: step `step` of env b). Random
// mode: the step's 2 * (NB - 1) action draws, from Philox keyed by the
// env or from the uniforms table (every lane of a group draws the same
// bits), and the env's own kick and kickoff draws. The kick noise is read
// from `c` at each step, not held across the loop: held, it costs the
// one-thread kernels registers (more spills from 3v3 on).
template <int NB>
struct RandomActions {
  static constexpr int NPL = NB - 1;
  static constexpr int ND = 2 * NPL + 2 + 2 * NB;
  const float* table;
  uint32_t seed;
  __device__ __forceinline__ EnvDraws<NB> at(const Consts& c, int B, int step, int b,
                                             int (&dirs)[NPL], int (&acts)[NPL]) const {
    float u[2 * NPL];
    draw_range<0, 2 * NPL>(table, seed, ND, B, step, b, u);
#pragma unroll
    for (int p = 0; p < NPL; ++p) {
      dirs[p] = randint5_from(u[p]);
      acts[p] = randint5_from(u[NPL + p]);
    }
    return EnvDraws<NB>{table, seed, ND, B, step, b, c.kick_noise};
  }
};

// Replay mode: actions [T, 2*n_players, B] (dir, act per player), zero
// kick and kickoff noise.
template <int NB>
struct ReplayActions {
  static constexpr int NPL = NB - 1;
  const int* actions;
  __device__ __forceinline__ NoDraws<NB> at(const Consts&, int B, int step, int b,
                                            int (&dirs)[NPL], int (&acts)[NPL]) const {
    const int* a = actions + static_cast<size_t>(step) * 2 * NPL * B + b;
#pragma unroll
    for (int p = 0; p < NPL; ++p) {
      dirs[p] = __ldg(a + static_cast<size_t>(2 * p) * B);
      acts[p] = __ldg(a + static_cast<size_t>(2 * p + 1) * B);
    }
    return NoDraws<NB>();
  }
};

// Env b's T steps with step 4 run by `phys`; `writer`: this thread writes
// the rewards and the final state.
template <int NB, class Actions, class Phys>
__device__ __forceinline__ void run_env(const float* __restrict__ sf_in,
                                        const int* __restrict__ si_in,
                                        float* __restrict__ sf_out, int* __restrict__ si_out,
                                        float* __restrict__ reward, const Actions& actions,
                                        int B, int T, const Consts& c, const Ints& k, int b,
                                        bool writer, const Phys& phys) {
  constexpr int NPL = NB - 1;
  Env<NB> e;
  load_env<NB>(e, sf_in, si_in, B, b);
#pragma unroll 1
  for (int step = 0; step < T; ++step) {
    int dirs[NPL], acts[NPL];
    const auto draws = actions.at(c, B, step, b, dirs, acts);
    bool goal0, goal1;
    float r1;
    const float r0 = step_dynamics<NB>(e, dirs, acts, draws, c, k, goal0, goal1, r1, phys);
    if (writer) reward[static_cast<size_t>(step) * B + b] = r0;
    step_finish<NB>(e, goal0, goal1, draws, c, k);
  }
  if (writer) store_env<NB>(e, sf_out, si_out, B, b);
}

// The rollout body of both modes. G = 0: one thread per env (the file's
// head note), kBlock threads a block, the env in registers and
// futbol_step.cuh's culled sweep. G = 2, 4, 8: G lanes per env
// (futbol_step_lanes.cuh), blockDim.x / G envs a block, env e of the
// block on threads [e * G, (e + 1) * G), each env's EnvSlots record in
// dynamic shared memory; every lane of a group loads the env, takes its
// actions and runs the rules alike, the physics is spread over the group,
// and the group's first lane writes; a group past the batch's end leaves
// after the block's one barrier.
template <int NB, int G, class Actions>
__device__ __forceinline__ void rollout(const float* __restrict__ sf_in,
                                        const int* __restrict__ si_in,
                                        float* __restrict__ sf_out, int* __restrict__ si_out,
                                        float* __restrict__ reward, const Actions& actions,
                                        int B, int T, const Consts& c, const Ints& k) {
  if constexpr (G == 0) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    run_env<NB>(sf_in, si_in, sf_out, si_out, reward, actions, B, T, c, k, b, true,
                SweepPhysics<NB, true>());
  } else {
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
    run_env<NB>(sf_in, si_in, sf_out, si_out, reward, actions, B, T, c, k, b, g == 0, phys);
  }
}

// Random-policy rollout: draws from Philox, or from `table` when given.
template <int NB, int G>
__global__ void __launch_bounds__(G == 0 ? kBlock : kMaxLaneThreads)
random_rollout_kernel(const float* __restrict__ sf_in, const int* __restrict__ si_in,
                      float* __restrict__ sf_out, int* __restrict__ si_out,
                      float* __restrict__ reward, const float* __restrict__ table,
                      uint32_t seed, int B, int T, Consts c, Ints k) {
  rollout<NB, G>(sf_in, si_in, sf_out, si_out, reward,
                 RandomActions<NB>{table, seed}, B, T, c, k);
}

// Replay rollout: given actions, zero kick and kickoff noise.
template <int NB, int G>
__global__ void __launch_bounds__(G == 0 ? kBlock : kMaxLaneThreads)
replay_rollout_kernel(const float* __restrict__ sf_in, const int* __restrict__ si_in,
                      float* __restrict__ sf_out, int* __restrict__ si_out,
                      float* __restrict__ reward, const int* __restrict__ actions,
                      int B, int T, Consts c, Ints k) {
  rollout<NB, G>(sf_in, si_in, sf_out, si_out, reward, ReplayActions<NB>{actions}, B, T,
                 c, k);
}

// Launches a rollout kernel with `threads` a block: threads / G envs a
// block, each env's record in dynamic shared memory; G = 0, one env a
// thread and no shared memory.
template <int NB, int G, class... P, class... A>
int launch(void (*kernel)(P...), int B, int threads, cudaStream_t s, A... args) {
  int envs = threads;
  size_t smem = 0;
  if constexpr (G > 0) {
    envs = threads / G;
    smem = static_cast<size_t>(envs) * EnvSlots<NB>::kStride * sizeof(float);
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<(B + envs - 1) / envs, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

template <int NB>
using Nb = std::integral_constant<int, NB>;

// route(Nb<NB>(), Nb<G>()) for a body count and a lanes count the kernels
// are built for; cudaErrorInvalidValue for any other.
template <int NB, class F>
int by_lanes(int lanes, const F& route) {
  switch (lanes) {
    case 0: return route(Nb<NB>(), Nb<0>());
    case 2: return route(Nb<NB>(), Nb<2>());
    case 4: return route(Nb<NB>(), Nb<4>());
    case 8: return route(Nb<NB>(), Nb<8>());
    default: return cudaErrorInvalidValue;
  }
}

template <class F>
int by_route(int n_bodies, int lanes, const F& route) {
  switch (n_bodies) {
    case 3: return by_lanes<3>(lanes, route);
    case 5: return by_lanes<5>(lanes, route);
    case 7: return by_lanes<7>(lanes, route);
    case 9: return by_lanes<9>(lanes, route);
    case 11: return by_lanes<11>(lanes, route);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int futbol_kernel_num_consts() { return kNumConsts; }

int futbol_fused_rollout_random(const float* sf_in, const int* si_in,
                                float* sf_out, int* si_out, float* reward,
                                const float* table, unsigned int seed,
                                int n_bodies, int B, int T, int substeps,
                                int iterations, int max_steps,
                                const float* consts, int n_consts, int lanes,
                                int threads, void* stream) {
  if (n_consts != kNumConsts || B <= 0 || T < 0 || !layout_ok(lanes, threads))
    return cudaErrorInvalidValue;
  Consts c;
  std::memcpy(&c, consts, sizeof(Consts));
  const Ints k{substeps, iterations, max_steps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_route(n_bodies, lanes, [&](auto nb, auto g) {
    constexpr int NB = decltype(nb)::value, G = decltype(g)::value;
    return launch<NB, G>(random_rollout_kernel<NB, G>, B, threads, s, sf_in, si_in, sf_out,
                         si_out, reward, table, seed, B, T, c, k);
  });
}

int futbol_fused_rollout_replay(const float* sf_in, const int* si_in,
                                float* sf_out, int* si_out, float* reward,
                                const int* actions, int n_bodies, int B, int T,
                                int substeps, int iterations, int max_steps,
                                const float* consts, int n_consts, int lanes,
                                int threads, void* stream) {
  if (n_consts != kNumConsts || B <= 0 || T < 0 || !layout_ok(lanes, threads))
    return cudaErrorInvalidValue;
  Consts c;
  std::memcpy(&c, consts, sizeof(Consts));
  const Ints k{substeps, iterations, max_steps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_route(n_bodies, lanes, [&](auto nb, auto g) {
    constexpr int NB = decltype(nb)::value, G = decltype(g)::value;
    return launch<NB, G>(replay_rollout_kernel<NB, G>, B, threads, s, sf_in, si_in, sf_out,
                         si_out, reward, actions, B, T, c, k);
  });
}

}  // extern "C"
