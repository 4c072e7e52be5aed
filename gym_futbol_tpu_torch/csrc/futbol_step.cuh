// The FutbolEnv step as CUDA device code, shared by every kernel of the
// package (fused_rollout.cu, fused_policy.cu, fused_recurrent.cu).
//
// The step is the scalar-SSA pipeline of gym_futbol_tpu_torch/env.py
// step_scalars with auto-reset, operation for operation in float32, for
// one env per thread: the body count NB is a template parameter so the
// body and pair loops unroll and their values live in registers. Every
// float constant arrives at run time in `Consts`, formed on the host as
// the JAX package forms it (ops/fused_rollout.py kernel_constants).
//
// Floating point: build without fast math and with --fmad=false, so that
// no a*b+c is contracted into an FMA the plain PyTorch version never
// does; 1/sqrt is 1.0f / sqrtf(x), not rsqrtf.
//
// Randomness: Philox4x32-10. Key (seed, 0), counter (env index, step,
// draw group, 0); each group of four 32-bit words gives four uniforms
// (uint32 >> 8) * 2^-24, with an unsigned shift. Draw d of a step is word
// d % 4 of group d / 4. A uniforms table f32 [T, n_draws, B] may replace
// Philox, so a kernel and its plain version can consume identical draws.
// A kernel computes one Philox per group of four draws it reads
// (draw_range), and the env's own draws only where they are read: the
// kick angle where some lane of the warp kicks, the kickoff placement
// where some lane re-places its bodies (EnvDraws). Draws are indexed, so
// skipping one changes no other.
//
// Culling (solve_contacts): an inactive pair (pen <= 0, bmv = 1e20) or
// wall (d <= 0, wn = -1e20) update is an exact no-op on the velocities
// and accumulators, up to the sign of a zero, and activity is fixed for a
// substep. Each substep, every lane builds bitmasks of its active pairs
// and walls and the warp ORs them (warp_union, over the lanes that run
// the step); each update runs under a warp-uniform branch on the union's
// bit, so a lane whose own bit is clear still runs it as a no-op and the
// order of operations never changes: the result is the plain version's,
// bitwise (signed zeros compare equal). The branch is warp-uniform, so the
// warp stays converged for the mma.sync of the kernels that inline the
// step. step_dynamics' CULL parameter turns it off where it measured
// slower: fused_policy_tc.cu's collect_tc_kernel chooses it by team size
// (collect_culls: culled at 1v1 and from 4v4 on, not at 2v2-3v3). The
// replay kernel replaces the physics (step_dynamics' Phys parameter) by
// futbol_step_lanes.cuh's: G lanes per env and per-env contact lists.

#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace futbol {

// Field order is KERNEL_CONSTANT_NAMES in ops/fused_rollout.py.
struct Consts {
  // physics
  float dt_sub, damp, max_speed, inv_m_ball, inv_m_player, r_ball, r_player;
  float rr_bp, rr_pp, nkn_bp, nkn_pp, e_bp, e_pp, ew_ball, ew_player;
  float mu, slop, bias_coef, width, height, goal_y_lo, goal_y_hi;
  // game rules
  float move_force, move_force_dash, possession_radius, half_height;
  float shoot_power, pass_power, ball_mass, dribble_offset;
  float clamp_x_ball, clamp_y_ball, clamp_x_player, clamp_y_player;
  float kick_amp, center_x, base_x0, base_x1, y0[5], kick_noise;
  // rewards
  float r_time, r_goal, r_concede, r_btg, r_ptb, r_poss, r_oob;
};
constexpr int kNumConsts = sizeof(Consts) / sizeof(float);

struct Ints {
  int substeps, iterations, max_steps;
};

constexpr int ACT_DASH = 1, ACT_PRESS = 2, ACT_PASS = 3, ACT_SHOOT = 4;

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, ctr.x);
    const uint32_t lo0 = 0xD2511F53u * ctr.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, ctr.z);
    const uint32_t lo1 = 0xCD9E8D57u * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ k0, lo1, hi0 ^ ctr.w ^ k1, lo0);
  }
  return ctr;
}

// Draws LO .. LO + N - 1 of step `step` for env b into u: from the table,
// or one Philox per group of four draws that the range touches.
template <int LO, int N>
__device__ __forceinline__ void draw_range(const float* __restrict__ table,
                                           uint32_t seed, int n_draws, int B,
                                           int step, int b, float (&u)[N]) {
  if (table != nullptr) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      u[i] = __ldg(&table[(static_cast<size_t>(step) * n_draws + LO + i) * B + b]);
    return;
  }
#pragma unroll
  for (int g = LO / 4; g <= (LO + N - 1) / 4; ++g) {
    const uint4 r = philox4x32_10(
        make_uint4(static_cast<uint32_t>(b), static_cast<uint32_t>(step),
                   static_cast<uint32_t>(g), 0u),
        seed, 0u);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int d = 4 * g + q;
      if (d >= LO && d < LO + N)
        u[d - LO] = static_cast<float>(w[q] >> 8) * (1.0f / 16777216.0f);
    }
  }
}

// Votes over the lanes of the warp that run this call (every lane of a
// warp that executes the step together; a lane that has left, or skips
// the step, adds nothing and reads nothing).
__device__ __forceinline__ bool warp_any(bool p) {
  return __any_sync(__activemask(), p);
}

__device__ __forceinline__ int randint5_from(float u) {
  return static_cast<int>(floorf(u * 5.0f));
}

__device__ __forceinline__ float normal_from(float u1, float u2) {
  u1 = fmaxf(u1, 1e-7f);
  const float r = sqrtf(-2.0f * logf(u1));
  return r * cosf(6.28318530717958647692f * u2);
}

__device__ __forceinline__ float pm1_from(float u) { return u * 2.0f - 1.0f; }

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// The env's own draws of one step, after the 2 * (NB - 1) action draws:
// the kick angle's two, then kickoff x and y per body. Drawn only when
// asked (step_dynamics, step_finish ask where some lane of the warp needs
// them).
template <int NB>
struct EnvDraws {
  static constexpr int D = 2 * (NB - 1);
  const float* table;
  uint32_t seed;
  int n_draws, B, step, b;
  float kick_noise;
  __device__ __forceinline__ float kick_angle() const {
    float u[2];
    draw_range<D, 2>(table, seed, n_draws, B, step, b, u);
    return normal_from(u[0], u[1]) * kick_noise;
  }
  __device__ __forceinline__ void kickoff(float (&nzx)[NB], float (&nzy)[NB]) const {
    float u[2 * NB];
    draw_range<D + 2, 2 * NB>(table, seed, n_draws, B, step, b, u);
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      nzx[i] = pm1_from(u[i]);
      nzy[i] = pm1_from(u[NB + i]);
    }
  }
};

// No noise: a kick goes straight, the kickoff places without jitter
// (the replay rollout).
template <int NB>
struct NoDraws {
  __device__ __forceinline__ float kick_angle() const { return 0.0f; }
  __device__ __forceinline__ void kickoff(float (&nzx)[NB], float (&nzy)[NB]) const {
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      nzx[i] = 0.0f;
      nzy[i] = 0.0f;
    }
  }
};

__device__ __forceinline__ float dir_x(int d) {
  return d == 2 ? 1.0f : (d == 4 ? -1.0f : 0.0f);
}
__device__ __forceinline__ float dir_y(int d) {
  return d == 1 ? 1.0f : (d == 3 ? -1.0f : 0.0f);
}

// ---------------------------------------------------------------------------
// Physics (gym_futbol_tpu_torch/physics.py)
// ---------------------------------------------------------------------------

// The union of N-bit masks (N <= 64) over the lanes of the warp that run
// this call, as warp_any votes.
template <int N>
__device__ __forceinline__ uint64_t warp_union(uint64_t m) {
  const unsigned lanes = __activemask();
  const uint64_t lo = __reduce_or_sync(lanes, static_cast<uint32_t>(m));
  if (N <= 32) return lo;
  return lo | static_cast<uint64_t>(__reduce_or_sync(lanes, static_cast<uint32_t>(m >> 32)))
                  << 32;
}

// One substep's contact solve. With CULL, the warp runs only the pair and
// wall updates that some lane of it needs (the file's head note).
template <int NB, bool CULL>
__device__ __forceinline__ void solve_contacts(const float (&px)[NB],
                                               const float (&py)[NB],
                                               float (&vx)[NB], float (&vy)[NB],
                                               const Consts& c, int iterations) {
  constexpr int NPAIR = NB * (NB - 1) / 2;
  static_assert(NPAIR <= 64 && 4 * NB <= 64, "activity masks hold 64 bits");
  float nx_p[NPAIR], ny_p[NPAIR], bmv_p[NPAIR], jn[NPAIR], jt[NPAIR];
  uint64_t pair_on = 0, wall_on = 0;   // this lane's active pairs, walls
#pragma unroll
  for (int i = 0; i < NB; ++i) {
#pragma unroll
    for (int j = i + 1; j < NB; ++j) {
      const int p = i * NB - i * (i + 1) / 2 + (j - i - 1);
      const float dpx = px[j] - px[i];
      const float dpy = py[j] - py[i];
      const float d2 = dpx * dpx + dpy * dpy;
      const float inv_d = 1.0f / sqrtf(fmaxf(d2, 1e-12f));
      const float dist = d2 * inv_d;
      const float pen = (i == 0 ? c.rr_bp : c.rr_pp) - dist;
      const float nx = dpx * inv_d;
      const float ny = dpy * inv_d;
      const float vrn0 = (vx[j] - vx[i]) * nx + (vy[j] - vy[i]) * ny;
      const float bounce = (i == 0 ? c.e_bp : c.e_pp) * fminf(vrn0, 0.0f);
      const float vbias = c.bias_coef * fmaxf(pen - c.slop, 0.0f);
      nx_p[p] = nx;
      ny_p[p] = ny;
      bmv_p[p] = pen > 0.0f ? bounce - vbias : 1e20f;
      pair_on |= pen > 0.0f ? 1ull << p : 0ull;
      jn[p] = 0.0f;
      jt[p] = 0.0f;
    }
  }

  // Walls [bottom, top, left, right], stored negated (v_bias - bounce)
  // with the inactive sentinel -1e20; accumulators in velocity units.
  float wn[4][NB], jv[4][NB], jtv[4][NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const float r = i == 0 ? c.r_ball : c.r_player;
    float d[4] = {r - py[i], r - (c.height - py[i]), r - px[i],
                  r - (c.width - px[i])};
    if (i == 0 && py[0] >= c.goal_y_lo && py[0] <= c.goal_y_hi) {
      d[2] = -1.0f;  // the ball passes through the goal mouth
      d[3] = -1.0f;
    }
    const float e_w = i == 0 ? c.ew_ball : c.ew_player;
    const float vrn0_w[4] = {vy[i], -vy[i], vx[i], -vx[i]};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float wbounce = e_w * fminf(vrn0_w[w], 0.0f);
      const float wvbias = c.bias_coef * fmaxf(d[w] - c.slop, 0.0f);
      wn[w][i] = d[w] > 0.0f ? wvbias - wbounce : -1e20f;
      wall_on |= d[w] > 0.0f ? 1ull << (w * NB + i) : 0ull;
      jv[w][i] = 0.0f;
      jtv[w][i] = 0.0f;
    }
  }

  // the warp's union: an update runs where any lane needs it
  if (CULL) {
    pair_on = warp_union<NPAIR>(pair_on);
    wall_on = warp_union<4 * NB>(wall_on);
  } else {
    pair_on = ~0ull;
    wall_on = ~0ull;
  }

#pragma unroll 1
  for (int it = 0; it < iterations; ++it) {
#pragma unroll
    for (int i = 0; i < NB; ++i) {
#pragma unroll
      for (int j = i + 1; j < NB; ++j) {
        const int p = i * NB - i * (i + 1) / 2 + (j - i - 1);
        if (!((pair_on >> p) & 1ull)) continue;
        const float inv_mi = i == 0 ? c.inv_m_ball : c.inv_m_player;
        const float nkn = i == 0 ? c.nkn_bp : c.nkn_pp;
        const float nx = nx_p[p], ny = ny_p[p];
        const float nxi = nx * inv_mi, nyi = ny * inv_mi;
        const float nxj = nx * c.inv_m_player, nyj = ny * c.inv_m_player;
        const float vrn = (vx[j] - vx[i]) * nx + (vy[j] - vy[i]) * ny;
        const float jn_new = fmaxf(jn[p] + nkn * (vrn + bmv_p[p]), 0.0f);
        const float dj = jn_new - jn[p];
        jn[p] = jn_new;
        vx[i] = vx[i] - dj * nxi;
        vy[i] = vy[i] - dj * nyi;
        vx[j] = vx[j] + dj * nxj;
        vy[j] = vy[j] + dj * nyj;
        // friction, tangent (-ny, nx)
        const float vrt = (vy[j] - vy[i]) * nx - (vx[j] - vx[i]) * ny;
        float djt = nkn * vrt;
        const float lim = c.mu * jn_new;
        const float jt_new = clampf(jt[p] + djt, -lim, lim);
        djt = jt_new - jt[p];
        jt[p] = jt_new;
        vx[i] = vx[i] + djt * nyi;
        vy[i] = vy[i] - djt * nxi;
        vx[j] = vx[j] - djt * nyj;
        vy[j] = vy[j] + djt * nxj;
      }
    }
#pragma unroll
    for (int w = 0; w < 4; ++w) {
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        if (!((wall_on >> (w * NB + i)) & 1ull)) continue;
        float dv0;
        if (w == 0) dv0 = wn[w][i] - vy[i];
        else if (w == 1) dv0 = wn[w][i] + vy[i];
        else if (w == 2) dv0 = wn[w][i] - vx[i];
        else dv0 = wn[w][i] + vx[i];
        const float jv_new = fmaxf(jv[w][i] + dv0, 0.0f);
        const float dv = jv_new - jv[w][i];
        jv[w][i] = jv_new;
        if (w == 0) vy[i] = vy[i] + dv;
        else if (w == 1) vy[i] = vy[i] - dv;
        else if (w == 2) vx[i] = vx[i] + dv;
        else vx[i] = vx[i] - dv;
        float dvt0;
        if (w == 0) dvt0 = vx[i];
        else if (w == 1) dvt0 = -vx[i];
        else if (w == 2) dvt0 = -vy[i];
        else dvt0 = vy[i];
        const float limv = c.mu * jv_new;
        const float jt_new = clampf(jtv[w][i] + dvt0, -limv, limv);
        const float dvt = jt_new - jtv[w][i];
        jtv[w][i] = jt_new;
        if (w == 0) vx[i] = vx[i] - dvt;
        else if (w == 1) vx[i] = vx[i] + dvt;
        else if (w == 2) vy[i] = vy[i] + dvt;
        else vy[i] = vy[i] - dvt;
      }
    }
  }
}

template <int NB, bool CULL>
__device__ __forceinline__ void physics_step(float (&px)[NB], float (&py)[NB],
                                             float (&vx)[NB], float (&vy)[NB],
                                             const float (&fx)[NB],
                                             const float (&fy)[NB],
                                             const Consts& c, const Ints& k) {
#pragma unroll 1
  for (int s = 0; s < k.substeps; ++s) {
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const float inv_m = i == 0 ? c.inv_m_ball : c.inv_m_player;
      const float nvx = vx[i] * c.damp + fx[i] * inv_m * c.dt_sub;
      const float nvy = vy[i] * c.damp + fy[i] * inv_m * c.dt_sub;
      const float s2 = nvx * nvx + nvy * nvy;
      const float scale =
          fminf(1.0f, c.max_speed * (1.0f / sqrtf(fmaxf(s2, 1e-12f))));
      vx[i] = nvx * scale;
      vy[i] = nvy * scale;
    }
    solve_contacts<NB, CULL>(px, py, vx, vy, c, k.iterations);
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      px[i] = px[i] + vx[i] * c.dt_sub;
      py[i] = py[i] + vy[i] * c.dt_sub;
    }
  }
}

// ---------------------------------------------------------------------------
// Game rules and the step (gym_futbol_tpu_torch/game.py, env.py)
// ---------------------------------------------------------------------------

template <int NB>
struct Env {
  float px[NB], py[NB], vx[NB], vy[NB];
  int poss, s0, s1, t;
};

// Step 8: the shaped reward of team TEAM (game.shaped_rewards_scalars) from
// the pre-step positions (px0, py0) and the post-step env.
template <int NB, int TEAM>
__device__ __forceinline__ float team_reward(const float (&px0)[NB],
                                             const float (&py0)[NB],
                                             const Env<NB>& e, bool goal0,
                                             bool goal1, bool ball_clamped,
                                             const Consts& c) {
  constexpr int PPT = (NB - 1) / 2;
  const bool scored = TEAM == 0 ? goal0 : goal1;
  const bool conceded = TEAM == 0 ? goal1 : goal0;
  float r = c.r_time;
  r = r + (scored ? c.r_goal : 0.0f);
  r = r + (conceded ? c.r_concede : 0.0f);
  {
    const float gx = TEAM == 0 ? c.width : 0.0f;
    const float dx0 = px0[0] - gx, dy0 = py0[0] - c.half_height;
    const float dx1 = e.px[0] - gx, dy1 = e.py[0] - c.half_height;
    const float d0 = sqrtf(dx0 * dx0 + dy0 * dy0);
    const float d1 = sqrtf(dx1 * dx1 + dy1 * dy1);
    r = r + c.r_btg * (d0 - d1);
  }
  {
    float p0 = 0.0f, p1 = 0.0f;
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      const int b = 1 + TEAM * PPT + q;
      const float ax = px0[b] - px0[0], ay = py0[b] - py0[0];
      const float bx1 = e.px[b] - e.px[0], by1 = e.py[b] - e.py[0];
      const float da = sqrtf(ax * ax + ay * ay);
      const float db = sqrtf(bx1 * bx1 + by1 * by1);
      p0 = q == 0 ? da : fminf(p0, da);
      p1 = q == 0 ? db : fminf(p1, db);
    }
    r = r + c.r_ptb * (p0 - p1);
  }
  const int owner_p = e.poss - 1;
  const bool owns =
      e.poss > 0 && owner_p >= TEAM * PPT && owner_p < (TEAM + 1) * PPT;
  r = r + (owns ? c.r_poss : 0.0f);
  r = r + (ball_clamped ? c.r_oob : 0.0f);
  return r;
}

// Step 4 as one thread per env runs it: physics_step.
template <int NB, bool CULL>
struct SweepPhysics {
  __device__ __forceinline__ void operator()(float (&px)[NB], float (&py)[NB],
                                             float (&vx)[NB], float (&vy)[NB],
                                             const float (&fx)[NB],
                                             const float (&fy)[NB],
                                             const Consts& c, const Ints& k) const {
    physics_step<NB, CULL>(px, py, vx, vy, fx, fy, c, k);
  }
};

// Steps 1-8 of the STEP ORDER: intent, physics, dribble, goals, bounds,
// rewards. Returns the team-0 reward; sets the goal flags and the team-1
// reward `r1` (dead code, removed by the compiler, where unused). The kick
// angle comes from draws.kick_angle(), asked where some lane of the warp
// kicks (EnvDraws or NoDraws). CULL: solve_contacts'. `phys` runs step 4
// (SweepPhysics, or futbol_step_lanes.cuh's LanePhysics).
template <int NB, bool CULL = true, class Draws, class Phys = SweepPhysics<NB, CULL>>
__device__ __forceinline__ float step_dynamics(Env<NB>& e,
                                               const int (&dirs)[NB - 1],
                                               const int (&acts)[NB - 1],
                                               const Draws& draws, const Consts& c,
                                               const Ints& k, bool& goal0,
                                               bool& goal1, float& r1,
                                               const Phys& phys = Phys()) {
  constexpr int NPL = NB - 1;
  constexpr int PPT = NPL / 2;
  float px0[NB], py0[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    px0[i] = e.px[i];
    py0[i] = e.py[i];
  }

  // 1: decode actions -> forces
  float fx[NB], fy[NB];
  fx[0] = 0.0f;
  fy[0] = 0.0f;
#pragma unroll
  for (int p = 0; p < NPL; ++p) {
    const float mag = acts[p] == ACT_DASH ? c.move_force_dash : c.move_force;
    fx[p + 1] = dir_x(dirs[p]) * mag;
    fy[p + 1] = dir_y(dirs[p]) * mag;
  }

  // 2: possession bids
  const float bx = e.px[0], by = e.py[0];
  {
    int best = 0;
    float best_d = FLT_MAX;
    bool any_bid = false;
    int owner_within = 0;
    const int owner_player = e.poss - 1;
#pragma unroll
    for (int p = 0; p < NPL; ++p) {
      const float dx = e.px[1 + p] - bx;
      const float dy = e.py[1 + p] - by;
      const float dp = sqrtf(dx * dx + dy * dy);
      const bool within = dp <= c.possession_radius;
      const bool bid = acts[p] == ACT_PRESS && within;
      const float bd = bid ? dp : FLT_MAX;
      if (p == 0) {
        best_d = bd;
        owner_within = within ? 1 : 0;
      } else {
        if (bd < best_d) {
          best = p;
          best_d = bd;
        }
        if (owner_player == p) owner_within = within ? 1 : 0;
      }
      any_bid = any_bid || bid;
    }
    const int keep = (e.poss > 0 && owner_within > 0) ? e.poss : -1;
    e.poss = any_bid ? best + 1 : keep;
  }

  // 3: owner's pass / shoot
  {
    const bool has_owner = e.poss > 0;
    const int owner_p = min(max(e.poss - 1, 0), NPL - 1);
    int owner_act = acts[0];
#pragma unroll
    for (int p = 1; p < NPL; ++p) owner_act = owner_p == p ? acts[p] : owner_act;
    const bool do_pass = has_owner && owner_act == ACT_PASS;
    const bool do_shoot = has_owner && owner_act == ACT_SHOOT;
    float ox = e.px[0], oy = e.py[0];
#pragma unroll
    for (int b = 1; b <= NPL; ++b) {
      ox = e.poss == b ? e.px[b] : ox;
      oy = e.poss == b ? e.py[b] : oy;
    }
    const int owner_team = owner_p >= PPT ? 1 : 0;
    const float goal_x = owner_team == 0 ? c.width : 0.0f;
    float sdx = goal_x - bx;
    float sdy = c.half_height - by;
    const float snorm = fmaxf(sqrtf(sdx * sdx + sdy * sdy), 1e-9f);
    sdx = sdx / snorm;
    sdy = sdy / snorm;

    float mate_d = FLT_MAX, mx = e.px[1], my = e.py[1];
    bool has_mate = false;
#pragma unroll
    for (int p = 0; p < NPL; ++p) {
      const int team_p = p >= PPT ? 1 : 0;
      const float dx = e.px[1 + p] - ox;
      const float dy = e.py[1 + p] - oy;
      const bool is_mate = owner_team == team_p && owner_p != p;
      const float dp = is_mate ? sqrtf(dx * dx + dy * dy) : FLT_MAX;
      if (dp < mate_d) {
        mx = e.px[1 + p];
        my = e.py[1 + p];
        mate_d = dp;
      }
      has_mate = has_mate || is_mate;
    }
    float pdx = mx - bx;
    float pdy = my - by;
    const float pnorm = fmaxf(sqrtf(pdx * pdx + pdy * pdy), 1e-9f);
    pdx = pdx / pnorm;
    pdy = pdy / pnorm;
    if (!has_mate) {
      pdx = sdx;
      pdy = sdy;
    }
    const bool kicked = do_pass || do_shoot;
    // the angle is read only where the lane kicks
    const float theta = warp_any(kicked) ? draws.kick_angle() : 0.0f;
    const float cs = cosf(theta), sn = sinf(theta);
    const float kdx = do_shoot ? cs * sdx - sn * sdy : cs * pdx - sn * pdy;
    const float kdy = do_shoot ? sn * sdx + cs * sdy : sn * pdx + cs * pdy;
    const float power = do_shoot ? c.shoot_power : c.pass_power;
    const float impulse = kicked ? power : 0.0f;
    const float dvx = kicked ? kdx * impulse / c.ball_mass : 0.0f;
    const float dvy = kicked ? kdy * impulse / c.ball_mass : 0.0f;
    if (kicked) e.poss = -1;
    e.vx[0] = e.vx[0] + dvx;
    e.vy[0] = e.vy[0] + dvy;
  }

  // 4: physics
  phys(e.px, e.py, e.vx, e.vy, fx, fy, c, k);

  // 5: dribble carry
  {
    const bool has_owner = e.poss > 0;
    const int owner_p = min(max(e.poss - 1, 0), NPL - 1);
    int direction = dirs[0];
#pragma unroll
    for (int p = 1; p < NPL; ++p) direction = owner_p == p ? dirs[p] : direction;
    const float ux = dir_x(direction), uy = dir_y(direction);
    const float fbx = owner_p >= PPT ? -1.0f : 1.0f;
    const bool moving = ux != 0.0f || uy != 0.0f;
    const float cdx = moving ? ux : fbx;
    const float cdy = moving ? uy : 0.0f;
    float ox = e.px[0], oy = e.py[0], ovx = e.vx[0], ovy = e.vy[0];
#pragma unroll
    for (int b = 1; b <= NPL; ++b) {
      const bool is_b = e.poss == b;
      ox = is_b ? e.px[b] : ox;
      oy = is_b ? e.py[b] : oy;
      ovx = is_b ? e.vx[b] : ovx;
      ovy = is_b ? e.vy[b] : ovy;
    }
    if (has_owner) {
      e.px[0] = ox + cdx * c.dribble_offset;
      e.py[0] = oy + cdy * c.dribble_offset;
      e.vx[0] = ovx;
      e.vy[0] = ovy;
    }
  }

  // 6: goals; 7: out-of-bounds clamp
  const bool in_mouth = e.py[0] >= c.goal_y_lo && e.py[0] <= c.goal_y_hi;
  goal0 = e.px[0] > c.width && in_mouth;
  goal1 = e.px[0] < 0.0f && in_mouth;
  bool ball_clamped = false;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const float r = i == 0 ? c.r_ball : c.r_player;
    float cx = clampf(e.px[i], r, i == 0 ? c.clamp_x_ball : c.clamp_x_player);
    const float cy = clampf(e.py[i], r, i == 0 ? c.clamp_y_ball : c.clamp_y_player);
    if (i == 0 && in_mouth) cx = e.px[0];
    const bool moved_x = fabsf(cx - e.px[i]) > 0.0f;
    const bool moved_y = fabsf(cy - e.py[i]) > 0.0f;
    if (moved_x) e.vx[i] = 0.0f;
    if (moved_y) e.vy[i] = 0.0f;
    e.px[i] = cx;
    e.py[i] = cy;
    if (i == 0) ball_clamped = moved_x || moved_y;
  }

  // 8: shaped rewards from the pre-step and post-step positions
  r1 = team_reward<NB, 1>(px0, py0, e, goal0, goal1, ball_clamped, c);
  return team_reward<NB, 0>(px0, py0, e, goal0, goal1, ball_clamped, c);
}

// Steps 9-10: kickoff re-placement where a goal occurred, clock, and a
// fresh episode where done that reuses the same kickoff draw. Returns
// done (the clock reached max_steps). The kickoff draws come from
// draws.kickoff(), asked where some lane of the warp re-places.
template <int NB, class Draws>
__device__ __forceinline__ bool step_finish(Env<NB>& e, bool goal0, bool goal1,
                                            const Draws& draws, const Consts& c,
                                            const Ints& k) {
  constexpr int PPT = (NB - 1) / 2;
  const bool any_goal = goal0 || goal1;
  e.s0 += goal0 ? 1 : 0;
  e.s1 += goal1 ? 1 : 0;
  e.t += 1;
  const bool done = e.t >= k.max_steps;
  const bool place = any_goal || done;
  if (warp_any(place)) {
    float nzx[NB], nzy[NB];
    draws.kickoff(nzx, nzy);
    float kox[NB], koy[NB];
    kox[0] = c.center_x + nzx[0] * c.kick_amp;
    koy[0] = c.half_height + nzy[0] * c.kick_amp;
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      kox[1 + q] = c.base_x0 + nzx[1 + q] * c.kick_amp;
      koy[1 + q] = c.y0[q] + nzy[1 + q] * c.kick_amp;
      kox[1 + PPT + q] = c.base_x1 + nzx[1 + PPT + q] * c.kick_amp;
      koy[1 + PPT + q] = c.y0[q] + nzy[1 + PPT + q] * c.kick_amp;
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      e.px[i] = place ? kox[i] : e.px[i];
      e.py[i] = place ? koy[i] : e.py[i];
      e.vx[i] = place ? 0.0f : e.vx[i];
      e.vy[i] = place ? 0.0f : e.vy[i];
    }
  }
  if (place) e.poss = -1;
  if (done) {
    e.s0 = 0;
    e.s1 = 0;
    e.t = 0;
  }
  return done;
}

template <int NB>
__device__ __forceinline__ void load_env(Env<NB>& e, const float* __restrict__ sf,
                                         const int* __restrict__ si, int B, int b) {
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    e.px[i] = sf[static_cast<size_t>(i) * B + b];
    e.py[i] = sf[static_cast<size_t>(NB + i) * B + b];
    e.vx[i] = sf[static_cast<size_t>(2 * NB + i) * B + b];
    e.vy[i] = sf[static_cast<size_t>(3 * NB + i) * B + b];
  }
  e.poss = si[b];
  e.s0 = si[static_cast<size_t>(B) + b];
  e.s1 = si[2 * static_cast<size_t>(B) + b];
  e.t = si[3 * static_cast<size_t>(B) + b];
}

template <int NB>
__device__ __forceinline__ void store_env(const Env<NB>& e, float* __restrict__ sf,
                                          int* __restrict__ si, int B, int b) {
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    sf[static_cast<size_t>(i) * B + b] = e.px[i];
    sf[static_cast<size_t>(NB + i) * B + b] = e.py[i];
    sf[static_cast<size_t>(2 * NB + i) * B + b] = e.vx[i];
    sf[static_cast<size_t>(3 * NB + i) * B + b] = e.vy[i];
  }
  si[b] = e.poss;
  si[static_cast<size_t>(B) + b] = e.s0;
  si[2 * static_cast<size_t>(B) + b] = e.s1;
  si[3 * static_cast<size_t>(B) + b] = e.t;
}

}  // namespace futbol
