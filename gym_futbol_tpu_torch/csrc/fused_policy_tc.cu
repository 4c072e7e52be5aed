// Self-play policy rollouts for NVIDIA Hopper (sm_90a), CUDA C++, the
// bf16 route: the policy's layer products on the tensor cores, the env
// step on every warp.
//
// Replaces, as fused_policy.cu does, two Pallas TPU kernels:
// - fused_collect (gym_futbol_tpu/ops/fused_collect.py, _collect_kernel):
//   PPO collection, both views through one actor-critic per step, then
//   sampling, the env step with auto-reset and the trajectory buffer;
// - fused_selfplay_rollout (gym_futbol_tpu/ops/fused_actor.py,
//   _selfplay_kernel): team 0 on MLP A, team 1 on MLP B.
// fused_policy.cu keeps the exact-f32 route (the parity mode); this file
// rounds as the TPU kernels do on their chip, where an f32 dot_general
// runs as one bf16 pass: the operands of every layer product of the torso
// and the logits head (the obs, each tanh activation, each weight) are
// rounded to bf16 and the products summed in f32; the bias adds, tanh,
// sampling and the value head ([H, 1], exact f32 on the TPU) stay f32.
// The plain versions in that mode are fused_collect_reference and
// fused_selfplay_rollout_reference with compute_dtype=torch.bfloat16.
//
// What held the f32 route back (PERF.md §5-§6): each thread is one env
// and each layer a chain of separate f32 multiplies and adds (no FMA),
// four __ldg weight broadcasts per 16 multiply-adds, 255 registers with
// spills at 3v3, and warp 0 alone building the obs, sampling and stepping
// its block's 32 envs while warps 1-3 waited at a barrier.
//
// Design. Each thread owns one env for the whole rollout, its state in
// registers (futbol_step.cuh's step_dynamics / step_finish),
// and each warp runs the MLP for its own 32 envs on mma.sync.m16n8k16:
// the envs are the M rows (two m16 tiles), the layer outputs N, the inputs
// K. Warps share nothing but the read-only weights, so the rollout loop
// has no block barrier: every warp steps its envs while the others run
// their layers. Per view, a thread writes its env's bf16 obs row into its
// warp's tile (rows without an env are zero), the warp loads the obs
// fragments with ldmatrix, and the hidden layers run in 32-output chunks:
// bias, tanh, then bf16 pairs back into the tile, which the next layer
// reads through ldmatrix. The last hidden layer never reaches shared
// memory: each chunk's f32 accumulators, after bias and tanh, feed the f32
// value head, and, packed to bf16, are directly the A fragments of the
// logits head's next two k-steps (an m16n8 accumulator pair is an m16k16
// A fragment). The logits (f32, with bias) and the value go through a
// small tile to their env's thread, which samples from them as the f32
// route does. Weights are bf16 B fragments packed on the host in mma
// order (one 16-byte load per lane per k16 x n16 step, no ldmatrix, no
// bank conflicts), zero-padded (K to 16, hidden N to 32, the logits to
// 16: exact). The wrapper's plan (ops/fused_actor.py tc_plan) keeps them
// resident in shared memory, copied once per block before the only
// barrier, or, where they do not fit beside the tiles, streams them from
// L2 through L1 with the same loads; and picks 32-128 envs per block so
// that no SM is left empty (config 6's 4096 envs: 32 a block).
//
// Bound (chip_smoke.py phase 10, bound(), H100 SXM peaks, 700 W): per
// env-step the products of both views on the tensor cores in bf16, the
// env step (its solver updates at the measured share of active
// contacts), biases and value head in f32; both kernels are bound by
// operations, config 4 (3v3, 16384 envs, hidden (256, 256)) mostly by
// its 323,584 bf16 product operations. On the card the env step alone
// (fused_rollout at the same batch) takes about half of this kernel's
// time: with one thread per env and 16384 envs there are four warps per
// SM to hide its latency (PERF.md §6).
//
// Draws per step as fused_policy.cu (draw_range: Philox or the table).
// C interface for ctypes; each entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

#include "policy_common.cuh"

namespace {

using namespace futbol;
using bf16 = __nv_bfloat16;

constexpr int kTcMaxThreads = 128;  // 1-4 warps a block, 32 envs a warp
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use

// One MLP: n_hidden tanh layers, then the head (layer n_hidden, no tanh).
// Layer l reads kp[l] inputs and writes np[l] outputs, both padded with
// zero weights (kp to 16, hidden np to kNc, the head's np to 16). Its
// weights are bf16 B fragments, uint4 (kk * np / 16 + jj) * 32 + lane from
// w_off[l]: k-step kk, output pair jj, and per lane g * 4 + t the b0, b1
// of outputs 16 jj + g and 16 jj + 8 + g (ops/fused_actor.py
// tc_fragments); its f32 bias at b_off[l]. wv_off: the f32 value head
// (np of the last hidden layer, then its bias) or -1.
struct TcNet {
  int n_hidden;
  int kp[kMaxLayers], np[kMaxLayers], w_off[kMaxLayers], b_off[kMaxLayers];
  int wv_off;
};

// A warp's two activation tiles [32][ld] bf16 in shared memory (t[0] also
// stages the obs; t[1] is used from three hidden layers on) and the f32
// [np_head + 1][32] logits-and-value tile, which aliases t[0].
struct WarpTiles {
  bf16* t[2];
  int ld[2];
  float* lg;
};

// The block's layout: envs per block (32 a warp), weights resident or
// streamed, each warp's tile bytes and row strides (ops/fused_actor.py
// tc_plan).
struct TcPlan {
  int envs, resident, t_bytes[2], ld[2];
};

// The MLP of one view for the warp's 32 rows: x0 the obs fragments
// (already out of the tiles). Returns the f32 tile whose row o, column
// lane is output o of the lane's env (the value at row np_head).
template <int KK0, int NLJ>
__device__ __forceinline__ const float* tc_mlp(const unsigned (&x0)[KK0][2][4],
                                               const uint4* W, const float* __restrict__ fv,
                                               const TcNet& n, const WarpTiles& wt,
                                               int lane) {
  const int nh = n.n_hidden;
  const int t = lane & 3;
  const uint4* Wl = W + n.w_off[nh];
  float hacc[2][NLJ][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NLJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[m][j][e] = 0.0f;
  float vpart[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  if (nh == 0) {
#pragma unroll
    for (int kk = 0; kk < KK0; ++kk) head_step<NLJ>(hacc, x0[kk], Wl, kk, lane);
  }
  // hidden layers before the last: chunks into the tiles
#pragma unroll 1
  for (int l = 0; l < nh - 1; ++l) {
    const int nj = n.np[l] / 16;
#pragma unroll 1
    for (int c = 0; c < n.np[l] / kNc; ++c) {
      float acc[2][4][4] = {};
      if (l == 0)
        chunk_from_regs<KK0>(acc, x0, W + n.w_off[0], nj, c, lane);
      else
        chunk_from_tile(acc, wt.t[(l - 1) & 1], wt.ld[(l - 1) & 1], n.kp[l],
                        W + n.w_off[l], nj, c, lane);
      bias_tanh(acc, fv + n.b_off[l], c, lane);
      store_chunk(acc, wt.t[l & 1], wt.ld[l & 1], c, lane);
    }
    __syncwarp();
  }
  // the last hidden layer, chunk by chunk into the value and logits heads
  if (nh > 0) {
    const int l = nh - 1, nj = n.np[l] / 16;
    const float* wv = n.wv_off >= 0 ? fv + n.wv_off : nullptr;
#pragma unroll 1
    for (int c = 0; c < n.np[l] / kNc; ++c) {
      float acc[2][4][4] = {};
      if (l == 0)
        chunk_from_regs<KK0>(acc, x0, W + n.w_off[0], nj, c, lane);
      else
        chunk_from_tile(acc, wt.t[(l - 1) & 1], wt.ld[(l - 1) & 1], n.kp[l],
                        W + n.w_off[l], nj, c, lane);
      bias_tanh(acc, fv + n.b_off[l], c, lane);
      if (wv != nullptr) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 w2 =
              __ldg(reinterpret_cast<const float2*>(wv + kNc * c + 8 * j + 2 * t));
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              vpart[m][hh] = vpart[m][hh] + acc[m][j][2 * hh] * w2.x;
              vpart[m][hh] = vpart[m][hh] + acc[m][j][2 * hh + 1] * w2.y;
            }
        }
      }
      // an m16n8 accumulator pair is the A fragment of an m16k16 step
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        unsigned a[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          a[m][0] = pack_bf16(acc[m][2 * ks][0], acc[m][2 * ks][1]);
          a[m][1] = pack_bf16(acc[m][2 * ks][2], acc[m][2 * ks][3]);
          a[m][2] = pack_bf16(acc[m][2 * ks + 1][0], acc[m][2 * ks + 1][1]);
          a[m][3] = pack_bf16(acc[m][2 * ks + 1][2], acc[m][2 * ks + 1][3]);
        }
        head_step<NLJ>(hacc, a, Wl, 2 * c + ks, lane);
      }
    }
  }
  __syncwarp();   // every read of the tiles is done: lg aliases t[0]
  heads_out<NLJ>(hacc, vpart, fv + n.b_off[nh], n.wv_off >= 0,
                 n.wv_off >= 0 ? __ldg(fv + n.wv_off + n.np[nh - 1]) : 0.0f, n.np[nh],
                 wt.lg, lane);
  return wt.lg;
}

// One view's forward for the warp: the obs fragments (obs_fragments),
// then tc_mlp.
template <int NB, bool MIRROR>
__device__ __forceinline__ const float* view_forward(const Env<NB>& e, bool owner,
                                                     const ObsConsts& oc, float* obs,
                                                     size_t row_stride, int f_pad,
                                                     const uint4* W, const float* fv,
                                                     const TcNet& n, const WarpTiles& wt,
                                                     int lane) {
  constexpr int KK0 = (4 * NB + 2 + 15) / 16;
  constexpr int NLJ = ((NB - 1) * kChoices + 15) / 16 * 2;
  unsigned x0[KK0][2][4];
  obs_fragments<NB, MIRROR>(e, owner, oc, obs, row_stride, f_pad, wt.t[0], wt.ld[0],
                            lane, lane, x0);
  return tc_mlp<KK0, NLJ>(x0, W, fv, n, wt, lane);
}

// The block's start: the weights copied into shared memory when they are
// resident (the block's only barrier), and this warp's tiles.
__device__ __forceinline__ const uint4* block_start(const uint4* __restrict__ wfrag,
                                                    int n_frag, const TcPlan& p,
                                                    unsigned char* smem, WarpTiles& wt) {
  const uint4* W = wfrag;
  unsigned char* tiles = smem;
  if (p.resident) {
    uint4* ws = reinterpret_cast<uint4*>(smem);
    for (int i = threadIdx.x; i < n_frag; i += blockDim.x) ws[i] = __ldg(wfrag + i);
    W = ws;
    tiles += static_cast<size_t>(n_frag) * sizeof(uint4);
    __syncthreads();
  }
  unsigned char* mine = tiles + (threadIdx.x >> 5) * (p.t_bytes[0] + p.t_bytes[1]);
  wt.t[0] = reinterpret_cast<bf16*>(mine);
  wt.t[1] = reinterpret_cast<bf16*>(mine + p.t_bytes[0]);
  wt.ld[0] = p.ld[0];
  wt.ld[1] = p.ld[1];
  wt.lg = reinterpret_cast<float*>(mine);
  return W;
}

// ---------------------------------------------------------------------------
// Kernels: plan.envs threads and envs per block, thread i owning env
// blockIdx.x * plan.envs + i.
// ---------------------------------------------------------------------------

// The collect's env step runs culled (futbol_step.cuh's solve_contacts)
// at the team sizes where that measured faster on the H100 (PERF.md §6):
// from 4v4 on, where a warp's union holds under a tenth of the pairs and
// walls, and at 1v1. 2v2 and 3v3 run the unculled sweep, 3% and 20%
// faster there. futbol_collect_tc_culls reports the choice.
constexpr int kCullFromBodies = 9;

__host__ __device__ constexpr bool collect_culls(int n_bodies) {
  return n_bodies == 3 || n_bodies >= kCullFromBodies;
}

template <int NB>
__global__ void __launch_bounds__(kTcMaxThreads)
collect_tc_kernel(const float* __restrict__ sf_in, const int* __restrict__ si_in,
                  float* __restrict__ sf_out, int* __restrict__ si_out,
                  const uint4* __restrict__ wfrag, int n_frag, const float* __restrict__ fv,
                  TcNet net, TcPlan plan, CollectOut out, const float* __restrict__ table,
                  uint32_t seed, int B, int T, int f_pad, Consts c, Ints k, ObsConsts oc) {
  constexpr int NPL = NB - 1;
  constexpr int ND = 2 * NPL + 2 + 2 * NB;
  constexpr int G = NPL;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  WarpTiles wt;
  const uint4* W = block_start(wfrag, n_frag, plan, smem_tc, wt);
  const int lane = threadIdx.x & 31;
  if (blockIdx.x * plan.envs + (threadIdx.x & ~31) >= B) return;   // no env in this warp
  const int b = blockIdx.x * plan.envs + threadIdx.x;
  const bool owner = b < B;
  const int vrow = net.np[net.n_hidden] * 32 + lane;   // the value in the f32 tile
  const size_t row_stride = static_cast<size_t>(T) * B;
  Env<NB> e;
  if (owner) load_env<NB>(e, sf_in, si_in, B, b);
#pragma unroll 1
  for (int step = 0; step < T; ++step) {
    int ia[G], ib[G];
    float lp[2], val[2];
    float* o0 = owner ? out.obs + static_cast<size_t>(step) * B + b : nullptr;
    const float* y = view_forward<NB, false>(e, owner, oc, o0, row_stride, f_pad, W, fv,
                                             net, wt, lane);
    if (owner) {
      lp[0] = sample_groups<G, 0>(y + lane, table, seed, ND, B, step, b, ia);
      val[0] = y[vrow];
    }
    y = view_forward<NB, true>(e, owner, oc, owner ? o0 + f_pad * row_stride : nullptr,
                               row_stride, f_pad, W, fv, net, wt, lane);
    if (owner) {
      lp[1] = sample_groups<G, G>(y + lane, table, seed, ND, B, step, b, ib);
      val[1] = y[vrow];
      int dp[2], ap[2];
      pack<G>(ia, dp[0], ap[0]);
      pack<G>(ib, dp[1], ap[1]);
      int dirs[NPL], acts[NPL];
      joint_action<NPL>(ia, ib, dirs, acts);
      const EnvDraws<NB> draws{table, seed, ND, B, step, b, c.kick_noise};
      bool goal0, goal1;
      float r[2];
      // culled or not by the team size (collect_culls)
      r[0] = step_dynamics<NB, collect_culls(NB)>(e, dirs, acts, draws, c, k, goal0,
                                                  goal1, r[1]);
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
  const float* y =
      view_forward<NB, false>(e, owner, oc, nullptr, 0, 0, W, fv, net, wt, lane);
  if (owner) out.last_value[b] = y[vrow];
  y = view_forward<NB, true>(e, owner, oc, nullptr, 0, 0, W, fv, net, wt, lane);
  if (owner) {
    out.last_value[static_cast<size_t>(B) + b] = y[vrow];
    store_env<NB>(e, sf_out, si_out, B, b);
  }
}

template <int NB>
__global__ void __launch_bounds__(kTcMaxThreads)
selfplay_tc_kernel(const float* __restrict__ sf_in, const int* __restrict__ si_in,
                   float* __restrict__ sf_out, int* __restrict__ si_out,
                   const uint4* __restrict__ wfrag, int n_frag, const float* __restrict__ fv,
                   TcNet na, TcNet nb, TcPlan plan, float* __restrict__ reward,
                   int* __restrict__ goals, int* __restrict__ dirs_out,
                   int* __restrict__ acts_out, const float* __restrict__ table,
                   uint32_t seed, int B, int T, Consts c, Ints k, ObsConsts oc) {
  constexpr int NPL = NB - 1;
  constexpr int ND = 2 * NPL + 2 + 2 * NB;
  constexpr int G = NPL;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  WarpTiles wt;
  const uint4* W = block_start(wfrag, n_frag, plan, smem_tc, wt);
  const int lane = threadIdx.x & 31;
  if (blockIdx.x * plan.envs + (threadIdx.x & ~31) >= B) return;   // no env in this warp
  const int b = blockIdx.x * plan.envs + threadIdx.x;
  const bool owner = b < B;
  Env<NB> e;
  if (owner) load_env<NB>(e, sf_in, si_in, B, b);
  int g0 = 0, g1 = 0;
#pragma unroll 1
  for (int step = 0; step < T; ++step) {
    int ia[G], ib[G];
    const float* y =
        view_forward<NB, false>(e, owner, oc, nullptr, 0, 0, W, fv, na, wt, lane);
    if (owner) sample_groups<G, 0>(y + lane, table, seed, ND, B, step, b, ia);
    y = view_forward<NB, true>(e, owner, oc, nullptr, 0, 0, W, fv, nb, wt, lane);
    if (owner) {
      sample_groups<G, G>(y + lane, table, seed, ND, B, step, b, ib);
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
// Host side
// ---------------------------------------------------------------------------

// The net from [n_layers, 4] ints (kp, np, w_off, b_off), the head last;
// false where it breaks the kernel's layout for n_bodies.
bool make_tc_net(const int* dims, int n_layers, int wv_off, int n_bodies, int n_frag,
                 TcNet& n) {
  const int kk0 = (4 * n_bodies + 2 + 15) / 16;
  const int head_np = ((n_bodies - 1) * kChoices + 15) / 16 * 16;
  if (n_layers < 1 || n_layers > kMaxLayers) return false;
  n.n_hidden = n_layers - 1;
  n.wv_off = wv_off;
  for (int l = 0; l < n_layers; ++l) {
    n.kp[l] = dims[4 * l];
    n.np[l] = dims[4 * l + 1];
    n.w_off[l] = dims[4 * l + 2];
    n.b_off[l] = dims[4 * l + 3];
    const bool head = l == n.n_hidden;
    if (n.kp[l] != (l == 0 ? 16 * kk0 : n.np[l - 1]) || n.w_off[l] < 0 ||
        n.b_off[l] < 0 || n.b_off[l] % 2 != 0 ||
        n.w_off[l] + n.kp[l] * n.np[l] / 8 > n_frag ||   // 8 bf16 a uint4
        (head ? n.np[l] != head_np : (n.np[l] < kNc || n.np[l] % kNc != 0)))
      return false;
  }
  return wv_off == -1 || (n.n_hidden > 0 && wv_off % 2 == 0);
}

// The tiles must hold what this net puts there (TcPlan from the wrapper).
bool tiles_fit(const TcNet& n, const TcPlan& p, int n_bodies) {
  const int k0 = (4 * n_bodies + 2 + 15) / 16 * 16;
  bool ok = p.ld[0] >= k0 && 64 * p.ld[0] <= p.t_bytes[0] &&
            (n.np[n.n_hidden] + 1) * 32 * 4 <= p.t_bytes[0];
  for (int l = 0; l + 1 < n.n_hidden; ++l)
    ok = ok && p.ld[l & 1] >= n.np[l] && 64 * p.ld[l & 1] <= p.t_bytes[l & 1];
  return ok;
}

bool plan_ok(const TcPlan& p, int n_frag, size_t& smem) {
  if (p.envs < 32 || p.envs > kTcMaxThreads || p.envs % 32 != 0 || p.ld[0] % 8 != 0 ||
      p.ld[1] % 8 != 0 || p.t_bytes[0] % 16 != 0 || p.t_bytes[1] % 16 != 0 ||
      p.t_bytes[0] <= 0 || p.t_bytes[1] < 0)
    return false;
  smem = (p.resident ? static_cast<size_t>(n_frag) * sizeof(uint4) : 0) +
         static_cast<size_t>(p.envs / 32) * (p.t_bytes[0] + p.t_bytes[1]);
  return smem <= static_cast<size_t>(kSmemLimit);
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" {

// 1 where collect_tc_kernel<n_bodies> runs the culled env step, else 0.
int futbol_collect_tc_culls(int n_bodies) { return collect_culls(n_bodies) ? 1 : 0; }

int futbol_fused_collect_tc(const float* sf_in, const int* si_in, float* sf_out,
                            int* si_out, const void* wfrag, int n_frag, const float* fv,
                            const int* dims, int n_layers, int wv_off, const int* plan_ints,
                            float* obs, int* dirs, int* acts, float* logp, float* value,
                            float* reward, int* done, float* last_value,
                            const float* table, unsigned int seed, int n_bodies, int B,
                            int T, int f_pad, int substeps, int iterations,
                            int max_steps, const float* consts, int n_consts,
                            const float* obs_consts, void* stream) {
  TcNet net;
  const TcPlan plan{plan_ints[0], plan_ints[1], {plan_ints[2], plan_ints[3]},
                    {plan_ints[4], plan_ints[5]}};
  size_t smem = 0;
  if (n_consts != kNumConsts || B <= 0 || T < 1 || n_bodies < 3 || n_bodies > 11 ||
      f_pad < 4 * n_bodies + 2 || wv_off < 0 ||
      !make_tc_net(dims, n_layers, wv_off, n_bodies, n_frag, net) ||
      !plan_ok(plan, n_frag, smem) || !tiles_fit(net, plan, n_bodies))
    return cudaErrorInvalidValue;
  Consts c;
  std::memcpy(&c, consts, sizeof(Consts));
  const Ints k{substeps, iterations, max_steps};
  const ObsConsts oc{obs_consts[0], obs_consts[1], obs_consts[2]};
  const CollectOut out{obs, dirs, acts, logp, value, reward, done, last_value};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + plan.envs - 1) / plan.envs);
  const uint4* w = static_cast<const uint4*>(wfrag);
  cudaError_t err = cudaErrorInvalidValue;
  switch (n_bodies) {
#define FUTBOL_CASE(NB)                                                           \
  case NB:                                                                        \
    err = set_smem(collect_tc_kernel<NB>, smem);                                  \
    if (err != cudaSuccess) return err;                                           \
    collect_tc_kernel<NB><<<grid, plan.envs, smem, s>>>(                          \
        sf_in, si_in, sf_out, si_out, w, n_frag, fv, net, plan, out, table, seed, \
        B, T, f_pad, c, k, oc);                                                   \
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

int futbol_fused_selfplay_tc(const float* sf_in, const int* si_in, float* sf_out,
                             int* si_out, const void* wfrag, int n_frag, const float* fv,
                             const int* dims_a, const int* dims_b, int n_layers,
                             const int* plan_ints, float* reward, int* goals, int* dirs,
                             int* acts, const float* table, unsigned int seed,
                             int n_bodies, int B, int T, int substeps, int iterations,
                             int max_steps, const float* consts, int n_consts,
                             const float* obs_consts, void* stream) {
  TcNet na, nb;
  const TcPlan plan{plan_ints[0], plan_ints[1], {plan_ints[2], plan_ints[3]},
                    {plan_ints[4], plan_ints[5]}};
  size_t smem = 0;
  if (n_consts != kNumConsts || B <= 0 || T < 1 || n_bodies < 3 || n_bodies > 11 ||
      !make_tc_net(dims_a, n_layers, -1, n_bodies, n_frag, na) ||
      !make_tc_net(dims_b, n_layers, -1, n_bodies, n_frag, nb) ||
      !plan_ok(plan, n_frag, smem) || !tiles_fit(na, plan, n_bodies) ||
      !tiles_fit(nb, plan, n_bodies) || (dirs == nullptr) != (acts == nullptr))
    return cudaErrorInvalidValue;
  Consts c;
  std::memcpy(&c, consts, sizeof(Consts));
  const Ints k{substeps, iterations, max_steps};
  const ObsConsts oc{obs_consts[0], obs_consts[1], obs_consts[2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + plan.envs - 1) / plan.envs);
  const uint4* w = static_cast<const uint4*>(wfrag);
  cudaError_t err = cudaErrorInvalidValue;
  switch (n_bodies) {
#define FUTBOL_CASE(NB)                                                           \
  case NB:                                                                        \
    err = set_smem(selfplay_tc_kernel<NB>, smem);                                 \
    if (err != cudaSuccess) return err;                                           \
    selfplay_tc_kernel<NB><<<grid, plan.envs, smem, s>>>(                         \
        sf_in, si_in, sf_out, si_out, w, n_frag, fv, na, nb, plan, reward, goals, \
        dirs, acts, table, seed, B, T, c, k, oc);                                 \
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
