// The env step's physics for G lanes per env (G in 2, 4, 8), with
// per-env contact lists: both rollouts' step at G > 0 (fused_rollout.cu,
// random_rollout_kernel and replay_rollout_kernel). The rules, rewards and auto-reset stay
// futbol_step.cuh's step_dynamics / step_finish, run alike on every lane
// of the env's group; only the physics (step 4) is replaced, through
// step_dynamics' Phys parameter, by LanePhysics below.
//
// Why. futbol_step.cuh's culled solve runs, for every lane of a warp, each
// update that ANY of the warp's 32 envs needs; envs' contacts are mostly
// disjoint, so a warp does the sum of its envs' solver work. And one
// thread per env holds every pair's set-up state in registers (5 x 55
// floats at 5v5), which spills.
//
// Design.
// - An env's group of G consecutive lanes shares its state in shared
//   memory (EnvSlots: positions, velocities, the per-substep force term,
//   and per pair and per (wall, body) the set-up values and the
//   accumulators, indexed by the constraint's plain index).
// - Spread over the group: velocity integration and position update (body
//   i on lane i % G), the pair set-up (pair p on lane p % G, its 1/sqrt
//   and products) and the wall set-up (body i's four walls on lane i % G).
//   Each lane sets the bits of its active constraints; a butterfly of
//   __shfl_xor_sync over the group ORs them into the env's masks.
// - The env's list is its mask: the set bits in increasing order are its
//   active pairs in the plain sweep's (i, j) order, then its walls in
//   (w, i) order. The group's first lane walks it, solver_iterations
//   times, with one generic pair update and one generic wall update whose
//   body indices come from the bit; the other lanes of the group wait at
//   the next __syncwarp. A warp so walks each list up to the longest of
//   its 32 / G envs' lists; an env whose list has ended is masked off.
// - Exactness: an inactive update is an exact no-op up to the sign of a
//   zero (futbol_step.cuh, culling), so walking only an env's own active
//   constraints in the plain order gives the plain sweep's values; the
//   generic updates are the sweep's operations on the same operands, the
//   per-wall sign choices made by selects between the same expressions.
//   Signed zeros compare equal.
// - Skipped math: a body slower than max_speed * (1 - 2^-17) keeps its
//   velocity through the speed clamp (the clamp's scale, min(1,
//   max_speed / |v|) in float32, rounds to more than 1), and a pair
//   farther apart than (r_i + r_j) * (1 + 2^-17) is inactive (its
//   float32 distance stays above r_i + r_j): both decided from the
//   squares the sweep computes anyway, so the 1 / sqrtf and the rest are
//   skipped there. The margin is far above the few ulps of rounding in
//   either, so the outcome is the sweep's; where a square is not below
//   (above) its bound, or is NaN, the full computation runs.
//
// Build without fast math and with --fmad=false, as futbol_step.cuh says.

#pragma once

#include <type_traits>

#include "futbol_step.cuh"

namespace futbol {

// The lanes of this lane's group of G (G divides 16, groups aligned).
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  static_assert(G >= 1 && 16 % G == 0, "G lanes per env: 1, 2, 4, 8 or 16");
  const unsigned lane = threadIdx.x & 31u;
  return ((1u << G) - 1u) << (lane & ~static_cast<unsigned>(G - 1));
}

// The OR of m over the group (a butterfly of G - 1 shuffles' depth log2 G).
template <int G, class M>
__device__ __forceinline__ M group_or(M m, unsigned gmask) {
#pragma unroll
  for (int o = 1; o < G; o <<= 1) m |= __shfl_xor_sync(gmask, m, o);
  return m;
}

// The relative margin of the skipped-math bounds (the head note).
constexpr float kMargin = 1.0f / 65536.0f;

// A mask of N bits: 32 where it fits, else 64.
template <int N>
using MaskOf = typename std::conditional<(N <= 32), unsigned, unsigned long long>::type;

__device__ __forceinline__ int lowest_bit(unsigned m) { return __ffs(m) - 1; }
__device__ __forceinline__ int lowest_bit(unsigned long long m) {
  return __ffsll(static_cast<long long>(m)) - 1;
}

// One env's shared-memory record, in floats: body rows, then per pair
// (p = i * NB - i * (i + 1) / 2 + j - i - 1) and per wall bit (w * NB + i).
// The stride is odd, so the group's lanes and the warp's envs fall in
// different banks.
template <int NB>
struct EnvSlots {
  static constexpr int kPairs = NB * (NB - 1) / 2;
  static constexpr int kWalls = 4 * NB;
  static constexpr int PX = 0, PY = NB, VX = 2 * NB, VY = 3 * NB;
  static constexpr int AX = 4 * NB, AY = 5 * NB;  // f * inv_m * dt_sub
  static constexpr int NX = 6 * NB, NY = NX + kPairs, BMV = NY + kPairs;
  static constexpr int JN = BMV + kPairs, JT = JN + kPairs;
  static constexpr int WN = JT + kPairs, JV = WN + kWalls, JTV = JV + kWalls;
  static constexpr int kFloats = JTV + kWalls;
  static constexpr int kStride = kFloats | 1;
};

// Pair p's bodies, i in the low nibble and j in the high one (NB <= 15),
// written by the block's threads before its first __syncthreads.
template <int NB>
__device__ __forceinline__ void fill_pair_table(unsigned char* pair_ij) {
  for (int p = threadIdx.x; p < EnvSlots<NB>::kPairs; p += blockDim.x) {
    int i = 0, first = 0;
    while (p >= first + NB - 1 - i) {
      first += NB - 1 - i;
      ++i;
    }
    pair_ij[p] = static_cast<unsigned char>(i | (i + 1 + p - first) << 4);
  }
}

// Step 4 (physics) of step_dynamics for the env whose record starts at
// `s`, on lane g of its group.
template <int NB, int G>
struct LanePhysics {
  using S = EnvSlots<NB>;
  using PairMask = MaskOf<S::kPairs>;
  using WallMask = MaskOf<S::kWalls>;

  float* s;
  const unsigned char* pair_ij;
  int g;
  unsigned gmask;

  __device__ __forceinline__ float& at(int row, int idx) const { return s[row + idx]; }

  __device__ __forceinline__ void operator()(float (&px)[NB], float (&py)[NB],
                                             float (&vx)[NB], float (&vy)[NB],
                                             const float (&fx)[NB],
                                             const float (&fy)[NB],
                                             const Consts& c, const Ints& k) const {
    // every lane holds the env's registers; body i's lane stores them
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      if (i % G != g) continue;
      const float inv_m = i == 0 ? c.inv_m_ball : c.inv_m_player;
      at(S::PX, i) = px[i];
      at(S::PY, i) = py[i];
      at(S::VX, i) = vx[i];
      at(S::VY, i) = vy[i];
      at(S::AX, i) = fx[i] * inv_m * c.dt_sub;
      at(S::AY, i) = fy[i] * inv_m * c.dt_sub;
    }
    // squared speeds below which the clamp's scale is 1, and squared
    // distances above which a pair is inactive, whatever the rounding of
    // the 1 / sqrtf that decides them (the margin, 2^-16, is far above
    // those few ulps): skip that math there (the file's head note)
    const float slow2 = c.max_speed * c.max_speed * (1.0f - kMargin);
    const float far_bp = c.rr_bp * c.rr_bp * (1.0f + kMargin);
    const float far_pp = c.rr_pp * c.rr_pp * (1.0f + kMargin);
#pragma unroll 1
    for (int sub = 0; sub < k.substeps; ++sub) {
      __syncwarp(gmask);
      integrate(c, slow2);
      __syncwarp(gmask);
      PairMask pair_on = setup_pairs(c, far_bp, far_pp);
      WallMask wall_on = setup_walls(c);
      pair_on = group_or<G>(pair_on, gmask);
      wall_on = group_or<G>(wall_on, gmask);
      __syncwarp(gmask);
      if (g == 0) solve(pair_on, wall_on, c, k.iterations);
      __syncwarp(gmask);
#pragma unroll
      for (int q = 0; q < (NB + G - 1) / G; ++q) {
        const int i = g + q * G;
        if (i < NB) {
          at(S::PX, i) = at(S::PX, i) + at(S::VX, i) * c.dt_sub;
          at(S::PY, i) = at(S::PY, i) + at(S::VY, i) * c.dt_sub;
        }
      }
    }
    __syncwarp(gmask);
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      px[i] = at(S::PX, i);
      py[i] = at(S::PY, i);
      vx[i] = at(S::VX, i);
      vy[i] = at(S::VY, i);
    }
    __syncwarp(gmask);  // the next step's stores wait for every lane's reads
  }

  // physics_step's velocity integration and speed clamp, body i on lane i % G
  __device__ __forceinline__ void integrate(const Consts& c, float slow2) const {
#pragma unroll
    for (int q = 0; q < (NB + G - 1) / G; ++q) {
      const int i = g + q * G;
      if (i >= NB) continue;
      const float nvx = at(S::VX, i) * c.damp + at(S::AX, i);
      const float nvy = at(S::VY, i) * c.damp + at(S::AY, i);
      const float s2 = nvx * nvx + nvy * nvy;
      float scale = 1.0f;
      if (!(s2 < slow2))
        scale = fminf(1.0f, c.max_speed * (1.0f / sqrtf(fmaxf(s2, 1e-12f))));
      at(S::VX, i) = nvx * scale;
      at(S::VY, i) = nvy * scale;
    }
  }

  // solve_contacts' pair set-up, pair p on lane p % G; returns this lane's
  // active pairs' bits and stores their slots
  __device__ __forceinline__ PairMask setup_pairs(const Consts& c, float far_bp,
                                                  float far_pp) const {
    PairMask on = 0;
#pragma unroll
    for (int q = 0; q < (S::kPairs + G - 1) / G; ++q) {
      const int p = g + q * G;
      if (p >= S::kPairs) continue;
      const int i = pair_ij[p] & 15, j = pair_ij[p] >> 4;
      const float dpx = at(S::PX, j) - at(S::PX, i);
      const float dpy = at(S::PY, j) - at(S::PY, i);
      const float d2 = dpx * dpx + dpy * dpy;
      if (d2 >= (i == 0 ? far_bp : far_pp)) continue;
      const float inv_d = 1.0f / sqrtf(fmaxf(d2, 1e-12f));
      const float dist = d2 * inv_d;
      const float pen = (i == 0 ? c.rr_bp : c.rr_pp) - dist;
      if (!(pen > 0.0f)) continue;
      const float nx = dpx * inv_d;
      const float ny = dpy * inv_d;
      const float vrn0 = (at(S::VX, j) - at(S::VX, i)) * nx +
                         (at(S::VY, j) - at(S::VY, i)) * ny;
      const float bounce = (i == 0 ? c.e_bp : c.e_pp) * fminf(vrn0, 0.0f);
      const float vbias = c.bias_coef * fmaxf(pen - c.slop, 0.0f);
      at(S::NX, p) = nx;
      at(S::NY, p) = ny;
      at(S::BMV, p) = bounce - vbias;
      at(S::JN, p) = 0.0f;
      at(S::JT, p) = 0.0f;
      on |= PairMask(1) << p;
    }
    return on;
  }

  // solve_contacts' wall set-up, body i's four walls on lane i % G
  __device__ __forceinline__ WallMask setup_walls(const Consts& c) const {
    WallMask on = 0;
#pragma unroll
    for (int q = 0; q < (NB + G - 1) / G; ++q) {
      const int i = g + q * G;
      if (i >= NB) continue;
      const float x = at(S::PX, i), y = at(S::PY, i);
      const float vxi = at(S::VX, i), vyi = at(S::VY, i);
      const float r = i == 0 ? c.r_ball : c.r_player;
      float d[4] = {r - y, r - (c.height - y), r - x, r - (c.width - x)};
      if (i == 0 && y >= c.goal_y_lo && y <= c.goal_y_hi) {
        d[2] = -1.0f;  // the ball passes through the goal mouth
        d[3] = -1.0f;
      }
      const float e_w = i == 0 ? c.ew_ball : c.ew_player;
      const float vrn0_w[4] = {vyi, -vyi, vxi, -vxi};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        if (!(d[w] > 0.0f)) continue;
        const float wbounce = e_w * fminf(vrn0_w[w], 0.0f);
        const float wvbias = c.bias_coef * fmaxf(d[w] - c.slop, 0.0f);
        at(S::WN, w * NB + i) = wvbias - wbounce;
        at(S::JV, w * NB + i) = 0.0f;
        at(S::JTV, w * NB + i) = 0.0f;
        on |= WallMask(1) << (w * NB + i);
      }
    }
    return on;
  }

  // solve_contacts' iterations over the env's lists: its active pairs in
  // (i, j) order, then its active walls in (w, i) order
  __device__ __forceinline__ void solve(PairMask pair_on, WallMask wall_on,
                                        const Consts& c, int iterations) const {
    if (!pair_on && !wall_on) return;  // most envs, most substeps
#pragma unroll 1
    for (int it = 0; it < iterations; ++it) {
#pragma unroll 1
      for (PairMask m = pair_on; m; m &= m - 1) {
        const int p = lowest_bit(m);
        const int i = pair_ij[p] & 15, j = pair_ij[p] >> 4;
        const float inv_mi = i == 0 ? c.inv_m_ball : c.inv_m_player;
        const float nkn = i == 0 ? c.nkn_bp : c.nkn_pp;
        const float nx = at(S::NX, p), ny = at(S::NY, p);
        const float jn = at(S::JN, p), jt = at(S::JT, p);
        float vxi = at(S::VX, i), vyi = at(S::VY, i);
        float vxj = at(S::VX, j), vyj = at(S::VY, j);
        const float nxi = nx * inv_mi, nyi = ny * inv_mi;
        const float nxj = nx * c.inv_m_player, nyj = ny * c.inv_m_player;
        const float vrn = (vxj - vxi) * nx + (vyj - vyi) * ny;
        const float jn_new = fmaxf(jn + nkn * (vrn + at(S::BMV, p)), 0.0f);
        const float dj = jn_new - jn;
        vxi = vxi - dj * nxi;
        vyi = vyi - dj * nyi;
        vxj = vxj + dj * nxj;
        vyj = vyj + dj * nyj;
        // friction, tangent (-ny, nx)
        const float vrt = (vyj - vyi) * nx - (vxj - vxi) * ny;
        float djt = nkn * vrt;
        const float lim = c.mu * jn_new;
        const float jt_new = clampf(jt + djt, -lim, lim);
        djt = jt_new - jt;
        at(S::JN, p) = jn_new;
        at(S::JT, p) = jt_new;
        at(S::VX, i) = vxi + djt * nyi;
        at(S::VY, i) = vyi - djt * nxi;
        at(S::VX, j) = vxj - djt * nyj;
        at(S::VY, j) = vyj + djt * nxj;
      }
#pragma unroll 1
      for (WallMask m = wall_on; m; m &= m - 1) {
        const int bit = lowest_bit(m);
        const int w = bit / NB, i = bit - w * NB;
        // walls 0, 1 (bottom, top) act on vy with friction on vx; 2, 3
        // (left, right) the other way round. a: the normal axis, b: the
        // tangent one.
        const bool vert = w < 2;
        const bool plus_n = w == 0 || w == 2;   // dv0 = wn - a, a += dv
        const bool minus_t = w == 0 || w == 3;  // dvt0 = b, b -= dvt
        float a = vert ? at(S::VY, i) : at(S::VX, i);
        float b = vert ? at(S::VX, i) : at(S::VY, i);
        const float wn = at(S::WN, bit), jv = at(S::JV, bit), jtv = at(S::JTV, bit);
        const float dv0 = plus_n ? wn - a : wn + a;
        const float jv_new = fmaxf(jv + dv0, 0.0f);
        const float dv = jv_new - jv;
        a = plus_n ? a + dv : a - dv;
        const float dvt0 = minus_t ? b : -b;
        const float limv = c.mu * jv_new;
        const float jt_new = clampf(jtv + dvt0, -limv, limv);
        const float dvt = jt_new - jtv;
        b = minus_t ? b - dvt : b + dvt;
        at(S::JV, bit) = jv_new;
        at(S::JTV, bit) = jt_new;
        at(S::VX, i) = vert ? b : a;
        at(S::VY, i) = vert ? a : b;
      }
    }
  }
};

}  // namespace futbol
