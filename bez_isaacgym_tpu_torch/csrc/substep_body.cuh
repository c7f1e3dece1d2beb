// One physics substep (h = dt / substeps) for one environment, as a
// schedule of lane blocks for one warp.
//
// Replaces the TPU kernel `_substep_kernel` in
// bez_isaacgym_tpu/ops/pallas_step.py:126 (launched through
// `make_pallas_step_fn`).  It computes what that kernel computes, stage by
// stage: forward kinematics; body velocities and qdd=0 bias accelerations;
// penalty plane contacts with smooth Coulomb friction, foot-sensor slot sums
// and 16 implicit-damping moments per body; ball-plane and ball-vs-box
// contacts; the upper triangle of the nv x nv mass matrix (plus contact
// damping, Stable-PD and joint-friction diagonals) and its right-hand side;
// a joints-first Cholesky solve with sqrt(max(d, 1e-9)) pivots; and
// semi-implicit Euler with velocity caps, per-env joint limits and exp-map
// quaternions for base and ball.
//
// What bounds it on an H100: at the rooflines, the bytes.  Each env reads
// and writes 356 floats (1,424 bytes) and needs some 1.4e4 flops with no
// contact active (ops/substep.py::flop_terms), so at B = 8192 the byte
// bound, ~3.5 us, is above the FP32 bound, ~1.7 us.  What keeps the kernel
// far above that bound is the length of one env's dependent schedule and
// the instructions the SM's schedulers issue for it, not the memory: the
// first version (one thread per env) walked ~2e4 dependent operations
// through an 8.6 KB local-memory stack frame and filled 16 of the 132 SMs at
// B = 2048.
//
// The design: one warp per env.  The per-env state (frames, velocities,
// contact moments, G times the Jacobian columns, the packed H and its
// factor) lives in a shared-memory tile, not in local memory; a block of E
// warps takes E envs, so B = 2048 gives 256 blocks.  Each stage is one or
// more lane blocks: a block's items (bodies of one tree level, contact
// bodies, boxes, Jacobian columns, H and rhs entries, the rows of one
// column of every limb, DOFs) are spread over the lanes, write disjoint
// locations and read only what earlier blocks wrote; __syncwarp() ends each
// block.  Every loop around blocks (tree levels, elimination steps) is
// uniform across the lanes, and ops/substep.py lays the work lists out in
// the tables.  Sums keep the order of the one-thread version: a contact
// body's points, a box's body, an H entry's bodies and a DOF's torque terms
// are each summed by one lane in ascending order, and every factor entry
// takes the dense elimination's updates in its order, so no atomics are
// needed.
//
// The schedule is __host__ __device__: on the card each lane runs its own
// items; compiled for the host, one thread runs each block's items in turn
// (forward, or last to first to expose a read across lanes that lacks a
// barrier), so the CPU tests build it with g++ and hold it against the plain
// PyTorch version.

#pragma once

#include <math.h>
#include <stddef.h>

#ifdef __CUDACC__
#define BEZ_HD __host__ __device__ __forceinline__
#else
#define BEZ_HD inline
#endif

#define BEZ_MAX_NB 24
#define BEZ_MAX_NV (BEZ_MAX_NB - 1 + 6)
#define BEZ_MAX_NC 256
#define BEZ_MAX_BOX 32
#define BEZ_MAX_SLOT (BEZ_MAX_NB * BEZ_MAX_NV)
#define BEZ_MAX_ITEM (BEZ_MAX_NV * (BEZ_MAX_NV + 1) / 2 + BEZ_MAX_NV)
#define BEZ_MAX_PAIR 2048
#define BEZ_MAX_CHOL 512
#define BEZ_MAX_BACK 320
#define BEZ_N_SENS 8
#define BEZ_N_MOM 16
#define BEZ_WARP 32
// Envs per block: one warp each.  B = 2048 then gives 256 blocks, at least
// one on every SM of an H100.
#define BEZ_ENVS_PER_BLOCK 8

// Unroll hint for nvcc; the host build ignores it.
#ifdef __CUDACC__
#define BEZ_PRAGMA(x) _Pragma(#x)
#define BEZ_UNROLL(n) BEZ_PRAGMA(unroll n)
#else
#define BEZ_UNROLL(n)
#endif

// Model topology and scene constants.  Every field is 4 bytes wide, so the
// layout has no padding; ops/substep.py builds and mirrors it field for
// field.
// - Tree level l holds the bodies level_body[level_off[l] .. level_off[l +
//   1]) (level 0 is the base).
// - Contact points are sorted by body (stably): body b owns the points
//   [cp_off[b], cp_off[b + 1]).
// - A slot is one Jacobian column of one body: slot_code = body | column << 8
//   (columns: 6 base, then the DOFs), the body's slots ascending by column.
// - An item is one entry of H or of the right-hand side: item_dst is its
//   place in the H | rhs array (H packed, then rhs in joints-first order),
//   item_col the column whose angular part it uses, item_joint its DOF where
//   a joint term enters (rhs of a DOF, diagonal of H), else -1.  Its terms
//   are pair[item_off[i] .. item_off[i + 1]), one per body in body order:
//   body | slot << 16 for H (the slot of its later column), body | body <<
//   16 for the rhs.  Items are sorted by descending term count, so the
//   lanes share them evenly.
// - Limb i holds the DOFs [limb_off[i], limb_off[i + 1]): the DOFs below one
//   child of the base.  DOFs of two limbs move no body in common.
// - Step s of the limbs' elimination is chol_item[chol_off[s] ..
//   chol_off[s + 1]): j | r << 8 | k_last << 16, column j of a limb on its
//   row r (the limb's rows from j, then the base rows), updating columns up
//   to k_last.  Step s of their back substitution is back_item[back_off[s]
//   .. back_off[s + 1]): r | k << 8, row r of a limb on its column k <= r.
struct SubstepTables {
  int nb, nq, nc, nbox, has_ball, n_level, n_slot, n_item, n_limb,
      n_chol_step, n_back_step;
  float h;
  float kn, cn, vt_eps, ball_kn, ball_cn;
  float ball_radius, ball_mass, ball_inertia, ball_rolling_friction;
  float max_joint_vel, max_base_lin_vel, max_base_ang_vel, max_ball_vel;
  float friction_vel_scale;
  int parent[BEZ_MAX_NB];
  int level_off[BEZ_MAX_NB + 1];
  int level_body[BEZ_MAX_NB];
  int cp_off[BEZ_MAX_NB + 1];
  int limb_off[BEZ_MAX_NB + 1];
  int chol_off[BEZ_MAX_NB + 1];
  int chol_item[BEZ_MAX_CHOL];
  int back_off[BEZ_MAX_NB + 1];
  int back_item[BEZ_MAX_BACK];
  int slot_code[BEZ_MAX_SLOT];
  int item_dst[BEZ_MAX_ITEM];
  int item_col[BEZ_MAX_ITEM];
  int item_joint[BEZ_MAX_ITEM];
  int item_off[BEZ_MAX_ITEM + 1];
  int pair[BEZ_MAX_PAIR];
  float tree_pos[BEZ_MAX_NB][3];
  float tree_rot[BEZ_MAX_NB][9];       // row-major
  float axis[BEZ_MAX_NB][3];           // per DOF
  float com[BEZ_MAX_NB][3];
  float mass[BEZ_MAX_NB];
  float inertia[BEZ_MAX_NB][9];
  int cp_sensor[BEZ_MAX_NC];
  float cp_pos[BEZ_MAX_NC][3];
  int box_body[BEZ_MAX_BOX];
  float box_pos[BEZ_MAX_BOX][3];
  float box_rot[BEZ_MAX_BOX][9];
  float box_half[BEZ_MAX_BOX][3];
};

struct V3 {
  float x, y, z;
};

BEZ_HD V3 v3(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
BEZ_HD V3 load3(const float* p) { return v3(p[0], p[1], p[2]); }
BEZ_HD void store3(float* p, V3 v) {
  p[0] = v.x;
  p[1] = v.y;
  p[2] = v.z;
}
BEZ_HD V3 operator+(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
BEZ_HD V3 operator-(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
BEZ_HD V3 operator*(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
BEZ_HD float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
BEZ_HD V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}
// M x and M^T x for a row-major 3x3 M.
BEZ_HD V3 mv(const float* M, V3 x) {
  return v3(M[0] * x.x + M[1] * x.y + M[2] * x.z,
            M[3] * x.x + M[4] * x.y + M[5] * x.z,
            M[6] * x.x + M[7] * x.y + M[8] * x.z);
}
BEZ_HD V3 mtv(const float* M, V3 x) {
  return v3(M[0] * x.x + M[3] * x.y + M[6] * x.z,
            M[1] * x.x + M[4] * x.y + M[7] * x.z,
            M[2] * x.x + M[5] * x.y + M[8] * x.z);
}
BEZ_HD void mm(const float* A, const float* B, float* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] +
                     A[3 * i + 2] * B[6 + j];
}
BEZ_HD float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}
// q_new = normalize(exp(w h / 2) * q), xyzw, with the zero-angle guard of
// the TPU kernel (sinc = 0.5 h below 1e-9 rad/s).
BEZ_HD void quat_step(const float* q, V3 w, float h, float* out) {
  const float ang = sqrtf(dot(w, w));
  const float half = 0.5f * ang * h;
  const float sinc = ang > 1e-9f ? sinf(half) / fmaxf(ang, 1e-9f) : 0.5f * h;
  const float dx = w.x * sinc, dy = w.y * sinc, dz = w.z * sinc;
  const float dw = cosf(half);
  const float qx = q[0], qy = q[1], qz = q[2], qw = q[3];
  const float nx = dw * qx + dx * qw + dy * qz - dz * qy;
  const float ny = dw * qy - dx * qz + dy * qw + dz * qx;
  const float nz = dw * qz + dx * qy - dy * qx + dz * qw;
  const float nw = dw * qw - dx * qx - dy * qy - dz * qz;
  const float inv = 1.0f / fmaxf(sqrtf(nx * nx + ny * ny + nz * nz + nw * nw),
                                 1e-9f);
  out[0] = nx * inv;
  out[1] = ny * inv;
  out[2] = nz * inv;
  out[3] = nw * inv;
}

// Row offsets of the (rows, B) structure-of-arrays buffers.  State rows:
// q, qd, base_pos, base_quat, base_u, ball_pos, ball_quat, ball_vel,
// ball_ang.  Param rows: kp, kd, effort, armature, joint_friction,
// mass_scale, mu, gravity, targets, dof_lower, dof_upper.  Output rows: the
// new state, 8 foot-sensor normals, nb x 3 body contact forces.
BEZ_HD int bez_state_rows(int nq) { return 2 * nq + 26; }
BEZ_HD int bez_param_rows(int nq, int nb) { return 8 * nq + nb + 4; }
BEZ_HD int bez_out_rows(int nq, int nb) { return 2 * nq + 34 + 3 * nb; }

// Packed lower triangle, row-major: (i, j) with j <= i.
BEZ_HD int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// One env's lanes: a warp.  each(n, f) runs f(k) for the n items of one
// lane block and ends the block with a barrier over the warp.
struct Lanes {
  int lane;      // on the card: this thread's lane
  bool reverse;  // on the host: run each block's items last to first
  template <class F>
  BEZ_HD void each(int n, F f) const {
#ifdef __CUDA_ARCH__
    for (int k = lane; k < n; k += BEZ_WARP) f(k);
    __syncwarp();
#else
    for (int k = 0; k < n; ++k) f(reverse ? n - 1 - k : k);
#endif
  }
};

// Float offsets of one env's shared-memory tile.  The inputs come first
// (state rows, then param rows), then the state every stage keeps (rhs
// right after H: the H | rhs array of the items); the last area is reused: frames, velocities, joint rotations and
// the boxes' forces (R, W, Vc, Rj, box) until the wrenches are formed, then
// the Jacobian slots until H is built, then the output tile.
struct Layout {
  int sin, pin, P, C, AXW, A0, F, N, Wm, sens, box, ball, H, rhs, y, u,
      inv_d, R, W, Vc, Rj, slot, out, size;
};

BEZ_HD int imax(int a, int b) { return a > b ? a : b; }

BEZ_HD Layout bez_layout(const SubstepTables& M) {
  const int nb = M.nb, nq = M.nq, nv = nq + 6;
  Layout L;
  int o = 0;
  L.sin = o;
  o += bez_state_rows(nq);
  L.pin = o;
  o += bez_param_rows(nq, nb);
  L.P = o;
  o += 3 * nb;
  L.C = o;
  o += 3 * nb;
  L.AXW = o;
  o += 3 * nq;
  L.A0 = o;    // per body AL0, AC0; then f_net, n_net
  o += 6 * nb;
  L.F = o;
  o += 3 * nb;
  L.N = o;
  o += 3 * nb;
  L.Wm = o;    // then the damped inertia G
  o += BEZ_N_MOM * nb;
  L.sens = o;
  o += BEZ_N_SENS;
  L.ball = o;  // ball force, ball torque
  o += 6;
  L.H = o;
  o += nv * (nv + 1) / 2;
  L.rhs = o;
  o += nv;
  L.y = o;
  o += nv;
  L.u = o;
  o += nv;
  L.inv_d = o;
  o += nv;
  L.R = o;
  L.W = o + 9 * nb;
  L.Vc = o + 12 * nb;
  L.Rj = o + 15 * nb;  // per DOF: tree_rot Rj(q), tree_rot axis
  // Per box: its force on the ball, torque on its body, torque on the ball.
  L.box = L.Rj + 12 * nq;
  L.slot = o;  // per slot: G times the column, linear then angular part
  L.out = o;
  o += imax(imax(15 * nb + 12 * nq + 9 * M.nbox, 6 * M.n_slot),
            bez_out_rows(nq, nb));
  // An odd stride puts consecutive envs of the staging loops in distinct
  // shared-memory banks.
  L.size = o | 1;
  return L;
}

// Thread t of the block's E * BEZ_WARP copies, for env t % E of envs
// env0 .. env0 + n_env - 1, every BEZ_WARP-th input row from row t / E
// of the (rows, B) buffers into the env's tile: consecutive threads take
// consecutive envs of a row, and each thread's loads are independent of
// one another.
BEZ_HD void bez_stage_in(const SubstepTables& M, const Layout& L, int E,
                         int t, int env0, int n_env, int B,
                         const float* __restrict__ state_in,
                         const float* __restrict__ params_in,
                         float* __restrict__ tiles) {
  const int e = t % E, r0 = t / E;
  if (e >= n_env) return;
  float* tile = tiles + e * L.size;
  const float* src = state_in + env0 + e;
  BEZ_UNROLL(4)
  for (int r = r0; r < bez_state_rows(M.nq); r += BEZ_WARP)
    tile[L.sin + r] = src[(size_t)r * B];
  src = params_in + env0 + e;
  BEZ_UNROLL(8)
  for (int r = r0; r < bez_param_rows(M.nq, M.nb); r += BEZ_WARP)
    tile[L.pin + r] = src[(size_t)r * B];
}

// The output rows back from the tiles, the same way.
BEZ_HD void bez_stage_out(const SubstepTables& M, const Layout& L, int E,
                          int t, int env0, int n_env, int B,
                          const float* __restrict__ tiles,
                          float* __restrict__ out) {
  const int e = t % E, r0 = t / E;
  if (e >= n_env) return;
  const float* tile = tiles + e * L.size;
  float* dst = out + env0 + e;
  BEZ_UNROLL(8)
  for (int r = r0; r < bez_out_rows(M.nq, M.nb); r += BEZ_WARP)
    dst[(size_t)r * B] = tile[L.out + r];
}

// Angular part of original Jacobian column c: zero for the base linear
// columns, e_k for the base angular ones, the world axis of a DOF.
BEZ_HD V3 col_ang(int c, const float* AXW) {
  if (c < 3) return v3(0.f, 0.f, 0.f);
  if (c < 6) return v3(c == 3, c == 4, c == 5);
  return load3(AXW + 3 * (c - 6));
}

// The damped inertia G = [[A, Bm], [Bm^T, E]] of a body, full 3x3 blocks,
// from its 15 stored entries (A diagonal, Bm with a zero diagonal).
BEZ_HD void load_G(const float* g, float* A, float* Bm, float* E) {
  for (int k = 0; k < 9; ++k) A[k] = 0.f;
  A[0] = g[0];
  A[4] = g[1];
  A[8] = g[2];
  Bm[0] = 0.f;
  Bm[1] = g[3];
  Bm[2] = g[4];
  Bm[3] = g[5];
  Bm[4] = 0.f;
  Bm[5] = g[6];
  Bm[6] = g[7];
  Bm[7] = g[8];
  Bm[8] = 0.f;
  E[0] = g[9];
  E[4] = g[10];
  E[8] = g[11];
  E[1] = E[3] = g[12];
  E[2] = E[6] = g[13];
  E[5] = E[7] = g[14];
}

// One substep for the env whose tile is s: inputs at L.sin / L.pin, outputs
// left at L.out.
BEZ_HD void bez_substep_warp(const Lanes& W, const SubstepTables& M,
                             const Layout& L, float* s) {
  const int nb = M.nb, nq = M.nq, nv = nq + 6;
  const float h = M.h;
  const int s_qd = nq, s_bpos = 2 * nq, s_bquat = 2 * nq + 3,
            s_bu = 2 * nq + 7, s_ballp = 2 * nq + 13, s_ballq = 2 * nq + 16,
            s_ballv = 2 * nq + 20, s_ballw = 2 * nq + 23;
  const int p_kd = nq, p_eff = 2 * nq, p_arm = 3 * nq, p_jf = 4 * nq,
            p_ms = 5 * nq, p_mu = 5 * nq + nb, p_grav = 5 * nq + nb + 1,
            p_tgt = 5 * nq + nb + 4, p_lo = 6 * nq + nb + 4,
            p_hi = 7 * nq + nb + 4;
  const int o_sens = bez_state_rows(nq), o_bcf = o_sens + BEZ_N_SENS;
  const float* sin = s + L.sin;
  const float* pin = s + L.pin;
  float* R = s + L.R;
  float* P = s + L.P;
  float* C = s + L.C;
  float* AXW = s + L.AXW;
  float* Wv = s + L.W;
  float* Vc = s + L.Vc;
  float* Rjs = s + L.Rj;
  float* A0 = s + L.A0;
  float* F = s + L.F;
  float* N = s + L.N;
  float* Wm = s + L.Wm;
  float* sens = s + L.sens;
  float* bx = s + L.box;
  float* ball = s + L.ball;
  float* slot = s + L.slot;
  float* H = s + L.H;
  float* rhs = s + L.rhs;
  float* y = s + L.y;
  float* u = s + L.u;
  float* inv_d = s + L.inv_d;
  float* out = s + L.out;
  const V3 grav = load3(pin + p_grav);
  const float mu = pin[p_mu];
  const float kn = M.kn, cn = M.cn, eps2 = M.vt_eps * M.vt_eps;

  // ---------------- FK, velocities, bias accelerations: level by level ---
  // The base (item 0); for every DOF d (items 1..nq), its body's fixed
  // rotation times the joint's rotation about its axis, T_d = tree_rot Rj(q),
  // and the axis in the parent's frame, tree_rot axis, so each level below
  // takes one product with its parent's frame; the sensor sums cleared.
  W.each(1 + nq + BEZ_N_SENS, [&](int k) {
    if (k > nq) {
      sens[k - 1 - nq] = 0.f;
      return;
    }
    if (k > 0) {
      const int d = k - 1;
      const float ax = M.axis[d][0], ay = M.axis[d][1], az = M.axis[d][2];
      const float q = sin[d];
      float sn, c;
      sincosf(q, &sn, &c);
      const float t = 1.0f - c;
      float Rj[9];
      Rj[0] = c + ax * ax * t;
      Rj[1] = ax * ay * t - az * sn;
      Rj[2] = ax * az * t + ay * sn;
      Rj[3] = ay * ax * t + az * sn;
      Rj[4] = c + ay * ay * t;
      Rj[5] = ay * az * t - ax * sn;
      Rj[6] = az * ax * t - ay * sn;
      Rj[7] = az * ay * t + ax * sn;
      Rj[8] = c + az * az * t;
      mm(M.tree_rot[d + 1], Rj, Rjs + 12 * d);
      store3(Rjs + 12 * d + 9, mv(M.tree_rot[d + 1], load3(M.axis[d])));
      return;
    }
    const float x = sin[s_bquat], yq = sin[s_bquat + 1],
                z = sin[s_bquat + 2], w = sin[s_bquat + 3];
    const float sc = 2.0f / fmaxf(x * x + yq * yq + z * z + w * w, 1e-12f);
    float* R0 = R;
    R0[0] = 1 - sc * (yq * yq + z * z);
    R0[1] = sc * (x * yq - z * w);
    R0[2] = sc * (x * z + yq * w);
    R0[3] = sc * (x * yq + z * w);
    R0[4] = 1 - sc * (x * x + z * z);
    R0[5] = sc * (yq * z - x * w);
    R0[6] = sc * (x * z - yq * w);
    R0[7] = sc * (yq * z + x * w);
    R0[8] = 1 - sc * (x * x + yq * yq);
    const V3 p0 = load3(sin + s_bpos);
    const V3 c0 = p0 + mv(R0, load3(M.com[0]));
    store3(P, p0);
    store3(C, c0);
    const V3 v0 = load3(sin + s_bu), w0 = load3(sin + s_bu + 3);
    const V3 r0 = c0 - p0;
    store3(Wv, w0);
    store3(Vc, v0 + cross(w0, r0));
    store3(A0, v3(0.f, 0.f, 0.f));
    store3(A0 + 3, cross(w0, cross(w0, r0)));
  });
  // The anchor of DOF d is the origin of body d + 1.
  for (int l = 1; l < M.n_level; ++l) {
    const int first = M.level_off[l];
    W.each(M.level_off[l + 1] - first, [&](int k) {
      const int b = M.level_body[first + k], p = M.parent[b], d = b - 1;
      const float* Rp = R + 9 * p;
      const V3 Pb = load3(P + 3 * p) + mv(Rp, load3(M.tree_pos[b]));
      float* Rb = R + 9 * b;
      mm(Rp, Rjs + 12 * d, Rb);
      const V3 axw = mv(Rp, load3(Rjs + 12 * d + 9));
      const V3 Cb = Pb + mv(Rb, load3(M.com[b]));
      store3(P + 3 * b, Pb);
      store3(AXW + 3 * d, axw);
      store3(C + 3 * b, Cb);
      const V3 Wp = load3(Wv + 3 * p), Cp = load3(C + 3 * p);
      const V3 AL0p = load3(A0 + 6 * p);
      const V3 aq = axw * sin[s_qd + d];
      const V3 Wb = Wp + aq;
      const V3 r_pa = Pb - Cp, r_ac = Cb - Pb;
      const V3 AL0b = AL0p + cross(Wp, aq);
      const V3 a_anchor = load3(A0 + 6 * p + 3) + cross(AL0p, r_pa) +
                          cross(Wp, cross(Wp, r_pa));
      store3(Wv + 3 * b, Wb);
      store3(Vc + 3 * b,
             load3(Vc + 3 * p) + cross(Wp, r_pa) + cross(Wb, r_ac));
      store3(A0 + 6 * b, AL0b);
      store3(A0 + 6 * b + 3,
             a_anchor + cross(AL0b, r_ac) + cross(Wb, cross(Wb, r_ac)));
    });
  }

  // ---------------- plane contacts: one lane per body -----------------------
  // A sensor slot's points all lie on one body (checked by ops/substep.py),
  // so each slot sum has one writer.
  W.each(nb, [&](int b) {
    const float* Rb = R + 9 * b;
    const V3 Pb = load3(P + 3 * b), Cb = load3(C + 3 * b);
    const V3 Vb = load3(Vc + 3 * b), Wb = load3(Wv + 3 * b);
    V3 Fb = v3(0.f, 0.f, 0.f), Nb = v3(0.f, 0.f, 0.f);
    float m[BEZ_N_MOM];
    for (int k = 0; k < BEZ_N_MOM; ++k) m[k] = 0.f;
    BEZ_UNROLL(4)
    for (int c = M.cp_off[b]; c < M.cp_off[b + 1]; ++c) {
      const V3 pw = Pb + mv(Rb, load3(M.cp_pos[c]));
      const V3 r = pw - Cb;
      const V3 vp = Vb + cross(Wb, r);
      const float pen = -pw.z;
      const bool active = pen > 0.f;
      const float fn = active ? fmaxf(kn * pen - cn * vp.z, 0.f) : 0.f;
      // sqrt(|vt|^2 + eps^2): the smooth friction direction.
      const float vt_norm = sqrtf(vp.x * vp.x + vp.y * vp.y + eps2);
      const float scale = -mu * fn / vt_norm;
      const V3 f = v3(vp.x * scale, vp.y * scale, fn);
      Fb = Fb + f;
      Nb = Nb + cross(r, f);
      const int sl = M.cp_sensor[c];
      if (sl >= 0) sens[sl] += fn;
      // Implicit damping moments.
      const float fn_est = active ? fmaxf(kn * pen, 0.f) : 0.f;
      const float d_t = mu * fn_est / vt_norm;
      const float g = (active ? cn : 0.f) - d_t;
      const float x = r.x, yy = r.y, z = r.z;
      m[0] += d_t;
      m[1] += d_t * x;
      m[2] += d_t * yy;
      m[3] += d_t * z;
      m[4] += d_t * x * x;
      m[5] += d_t * yy * yy;
      m[6] += d_t * z * z;
      m[7] += d_t * x * yy;
      m[8] += d_t * x * z;
      m[9] += d_t * yy * z;
      m[10] += g;
      m[11] += g * x;
      m[12] += g * yy;
      m[13] += g * x * x;
      m[14] += g * yy * yy;
      m[15] += g * x * yy;
    }
    store3(F + 3 * b, Fb);
    store3(N + 3 * b, Nb);
    for (int k = 0; k < BEZ_N_MOM; ++k) Wm[BEZ_N_MOM * b + k] = m[k];
  });

  // ---------------- ball ----------------------------------------------------
  const V3 ballp = load3(sin + s_ballp);
  const V3 ballv = load3(sin + s_ballv);
  const V3 ballw = load3(sin + s_ballw);
  const float rad = M.ball_radius, bkn = M.ball_kn, bcn = M.ball_cn;
  if (M.has_ball) {
    // Sphere vs each robot collision box: one lane per box.
    W.each(M.nbox, [&](int k) {
      const int b = M.box_body[k];
      const float* Rb = R + 9 * b;
      const V3 box_c = load3(P + 3 * b) + mv(Rb, load3(M.box_pos[k]));
      float Rbox[9];
      mm(Rb, M.box_rot[k], Rbox);
      const V3 local = mtv(Rbox, ballp - box_c);
      const V3 cl = v3(clampf(local.x, -M.box_half[k][0], M.box_half[k][0]),
                       clampf(local.y, -M.box_half[k][1], M.box_half[k][1]),
                       clampf(local.z, -M.box_half[k][2], M.box_half[k][2]));
      const V3 closest = box_c + mv(Rbox, cl);
      const V3 delta = ballp - closest;
      const float dist = sqrtf(dot(delta, delta) + 1e-12f);
      const V3 nrm = dist > 1e-6f ? delta * (1.0f / (dist + 1e-9f))
                                  : v3(0.f, 0.f, 1.f);
      const float bpen = rad - dist;
      const V3 vbp = ballv + cross(ballw, closest - ballp);
      const V3 rb = closest - load3(C + 3 * b);
      const V3 vrp = load3(Vc + 3 * b) + cross(load3(Wv + 3 * b), rb);
      const V3 rel = vbp - vrp;
      const float vn = dot(rel, nrm);
      const float bfn = bpen > 0.f ? fmaxf(bkn * bpen - bcn * vn, 0.f) : 0.f;
      const V3 vt = rel - nrm * vn;
      const float vtn = sqrtf(dot(vt, vt) + eps2);
      const V3 fb = nrm * bfn - vt * (mu * bfn / vtn);
      store3(bx + 9 * k, fb);
      store3(bx + 9 * k + 3, cross(rb, fb));
      store3(bx + 9 * k + 6, cross(closest - ballp, fb));
    });
    // The boxes' reactions on their bodies (items 0..nb-1), and the ball's
    // plane contact, box forces and gravity (item nb), each in box order.
    W.each(nb + 1, [&](int b) {
      if (b < nb) {
        V3 Fb = load3(F + 3 * b), Nb = load3(N + 3 * b);
        for (int k = 0; k < M.nbox; ++k) {
          if (M.box_body[k] != b) continue;
          Fb = Fb - load3(bx + 9 * k);
          Nb = Nb - load3(bx + 9 * k + 3);
        }
        store3(F + 3 * b, Fb);
        store3(N + 3 * b, Nb);
        return;
      }
      // Sphere vs plane.
      const float pen = rad - ballp.z;
      const V3 off = v3(0.f, 0.f, -rad);
      const V3 vp = ballv + cross(ballw, off);
      const float fn = pen > 0.f ? fmaxf(bkn * pen - bcn * vp.z, 0.f) : 0.f;
      const float vt_norm = sqrtf(vp.x * vp.x + vp.y * vp.y + eps2);
      const float sc = -mu * fn / vt_norm;
      const V3 fpl = v3(vp.x * sc, vp.y * sc, fn);
      V3 ball_F = v3(0.f, 0.f, 0.f) + fpl;
      V3 ball_N = v3(0.f, 0.f, 0.f) + cross(off, fpl);
      // Rolling resistance, smooth at zero spin.
      const float wn = sqrtf(dot(ballw, ballw) + 1e-12f);
      ball_N = ball_N + ballw * (-M.ball_rolling_friction * fn * rad / wn);
      for (int k = 0; k < M.nbox; ++k) {
        ball_F = ball_F + load3(bx + 9 * k);
        ball_N = ball_N + load3(bx + 9 * k + 6);
      }
      store3(ball, ball_F + grav * M.ball_mass);
      store3(ball + 3, ball_N);
    });
  }

  // ---------------- damped inertia and wrench: one lane per body ----------
  // G = [[A, Bm], [Bm^T, E]] (spatial inertia plus h * contact damping)
  // replaces the body's moments; f_net = F - m (a0 - g) and n_net = N - I
  // alpha0 - w x I w replace its AL0 and AC0.
  W.each(nb, [&](int b) {
    const float ms = pin[p_ms + b];
    const float m_b = M.mass[b] * ms;
    const float* Rb = R + 9 * b;
    float RI[9], Iw[9], Rt[9];
    mm(Rb, M.inertia[b], RI);
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) Rt[3 * r + c] = Rb[3 * c + r];
    mm(RI, Rt, Iw);
    for (int k = 0; k < 9; ++k) Iw[k] *= ms;
    float m[BEZ_N_MOM];
    for (int k = 0; k < BEZ_N_MOM; ++k) m[k] = Wm[BEZ_N_MOM * b + k];
    float* g = Wm + BEZ_N_MOM * b;
    g[0] = h * m[0] + m_b;
    g[1] = h * m[0] + m_b;
    g[2] = h * (m[0] + m[10]) + m_b;
    g[3] = h * m[3];
    g[4] = -h * m[2];
    g[5] = -h * m[3];
    g[6] = h * m[1];
    g[7] = h * (m[2] + m[12]);
    g[8] = -h * (m[1] + m[11]);
    g[9] = h * (m[6] + m[5] + m[14]) + Iw[0];
    g[10] = h * (m[6] + m[4] + m[13]) + Iw[4];
    g[11] = h * (m[4] + m[5]) + Iw[8];
    g[12] = -h * (m[7] + m[15]) + Iw[1];
    g[13] = -h * m[8] + Iw[2];
    g[14] = -h * m[9] + Iw[5];
    const V3 Wb = load3(Wv + 3 * b);
    const V3 f_net = load3(F + 3 * b) - (load3(A0 + 6 * b + 3) - grav) * m_b;
    const V3 n_net = load3(N + 3 * b) - mv(Iw, load3(A0 + 6 * b)) -
                     cross(Wb, mv(Iw, Wb));
    store3(A0 + 6 * b, f_net);
    store3(A0 + 6 * b + 3, n_net);
  });

  // ---------------- Jacobian columns and G times them: one lane per slot --
  W.each(M.n_slot, [&](int k) {
    const int b = M.slot_code[k] & 0xff, c = M.slot_code[k] >> 8;
    const V3 Cb = load3(C + 3 * b);
    V3 lin, ang;
    if (c < 6) {
      const int e = c < 3 ? c : c - 3;
      const V3 ek = v3(e == 0, e == 1, e == 2);
      lin = c < 3 ? ek : cross(ek, Cb - load3(P));
      ang = c < 3 ? v3(0.f, 0.f, 0.f) : ek;
    } else {
      const int d = c - 6;
      ang = load3(AXW + 3 * d);
      lin = cross(ang, Cb - load3(P + 3 * (d + 1)));
    }
    float A[9], Bm[9], E[9];
    load_G(Wm + BEZ_N_MOM * b, A, Bm, E);
    float* sl = slot + 6 * k;
    store3(sl, mv(A, lin) + mv(Bm, ang));
    store3(sl + 3, mtv(Bm, lin) + mv(E, ang));
  });

  // ---------------- H and the right-hand side: one lane per item ----------
  // An H entry sums lin_c1 . (G col_c2)_lin + ang_c1 . (G col_c2)_ang over
  // the bodies both columns move, in body order (c1 <= c2 in the original
  // column order), then a DOF's diagonal adds the armature, implicit
  // Stable-PD and joint friction.  A right-hand side row starts from the
  // DOF's Stable-PD torque less its friction, then sums lin . f_net + ang .
  // n_net over the bodies its column moves.  rhs follows H in the tile, so
  // item_dst indexes both.
  const int ntri = nv * (nv + 1) / 2;
  W.each(M.n_item, [&](int i) {
    const int dst = M.item_dst[i], j = M.item_joint[i], c = M.item_col[i];
    const int first = M.item_off[i], last = M.item_off[i + 1];
    // Column c on body b: angular part ang, linear part e_c for a base
    // linear column, else ang x (C_b - anchor), anchored at the base origin
    // or at the DOF's body origin.  The term's second factor: G times the
    // other column's slot for H, the body's (f_net, n_net) for the rhs.
    const V3 ang = col_ang(c, AXW);
    const V3 anchor = load3(P + (c < 6 ? 0 : 3 * (c - 5)));
    const V3 e_c = v3(c == 0, c == 1, c == 2);
    const bool is_h = dst < ntri;
    const float* x2 = is_h ? slot : A0;
    float acc = 0.f;
    if (!is_h && j >= 0) {
      const float kp = pin[j], kd = pin[p_kd + j], eff = pin[p_eff + j];
      const float q = sin[j], qd = sin[s_qd + j];
      const float t_pd = clampf(
          kp * (pin[p_tgt + j] - q) - (h * kp + kd) * qd, -eff, eff);
      const float c_fric = pin[p_jf + j] / (fabsf(qd) + M.friction_vel_scale);
      acc = t_pd - c_fric * qd;
    }
    BEZ_UNROLL(4)
    for (int k = first; k < last; ++k) {
      const int pr = M.pair[k];
      const V3 lin =
          c < 3 ? e_c : cross(ang, load3(C + 3 * (pr & 0xffff)) - anchor);
      const float* a2 = x2 + 6 * (pr >> 16);
      acc += dot(lin, load3(a2)) + dot(ang, load3(a2 + 3));
    }
    if (is_h && j >= 0) {
      const float kp = pin[j], kd = pin[p_kd + j];
      const float c_fric =
          pin[p_jf + j] / (fabsf(sin[s_qd + j]) + M.friction_vel_scale);
      acc += pin[p_arm + j] + h * (h * kp + kd + c_fric);
    }
    H[dst] = acc;
  });

  // ---------------- Cholesky and L y = rhs ---------------------------------
  // Joints of two limbs move no body in common, so H's joint block is block
  // diagonal by limb, and so is its factor.  Each step of chol_item
  // eliminates one column of every limb side by side, over the limb's later
  // rows and the 6 base rows; then the base rows' Schur complement and
  // right-hand side take their sums over all joint columns in ascending
  // order; then the 6 base columns.  Every entry takes the updates of the
  // dense right-looking elimination in the same order; only the updates by
  // the zeros between limbs, which change nothing, are skipped.
  // Below the diagonal H keeps the unscaled column: L[r][j] = H[r][j] *
  // inv_d[j] is formed where it is read, so no block has to scale a column
  // that another item of the same block reads.  inv_d[j] = 1 / sqrt(max(d,
  // 1e-9)) is taken by whichever item last updates H[j][j].
  auto pivot = [&](int j) {
    inv_d[j] = 1.0f / sqrtf(fmaxf(H[tri(j, j)], 1e-9f));
  };
  // Column j on row r: row j takes y_j; a later row r updates its entries
  // in columns j+1 .. k_last and its rhs (a base row's rhs takes the joint
  // columns in one sum, below), and row j+1 then takes its pivot.
  auto eliminate = [&](int j, int r, int k_last) {
    const float id = inv_d[j];
    const float yj = rhs[j] * id;
    if (r == j) {
      y[j] = yj;
      return;
    }
    const float lrj = H[tri(r, j)] * id;
    for (int k = j + 1; k <= k_last; ++k)
      H[tri(r, k)] -= lrj * (H[tri(k, j)] * id);
    if (r < nq || j >= nq) rhs[r] -= lrj * yj;
    if (r == j + 1 && k_last >= r) pivot(r);
  };
  W.each(M.n_limb, [&](int i) { pivot(M.limb_off[i]); });
  for (int st = 0; st < M.n_chol_step; ++st) {
    const int first = M.chol_off[st];
    W.each(M.chol_off[st + 1] - first, [&](int k) {
      const int code = M.chol_item[first + k];
      eliminate(code & 0xff, (code >> 8) & 0xff, code >> 16);
    });
  }
  // Base rows: 21 Schur entries (r >= c; the first base pivot after its
  // entry), then 6 right-hand sides.
  W.each(27, [&](int k) {
    if (k < 21) {
      int rr = 0;
      while (k > rr) k -= ++rr;
      const int r = nq + rr, c = nq + k;
      float acc = H[tri(r, c)];
      BEZ_UNROLL(6)
      for (int j = 0; j < nq; ++j)
        acc -= (H[tri(r, j)] * inv_d[j]) * (H[tri(c, j)] * inv_d[j]);
      H[tri(r, c)] = acc;
      if (r == nq) pivot(nq);
    } else {
      const int r = nq + k - 21;
      float acc = rhs[r];
      BEZ_UNROLL(6)
      for (int j = 0; j < nq; ++j) acc -= (H[tri(r, j)] * inv_d[j]) * y[j];
      rhs[r] = acc;
    }
  });
  for (int j = nq; j < nv; ++j)
    W.each(nv - j, [&](int k) { eliminate(j, j + k, j + k); });

  // ---------------- L^T u = y, row by row from the last --------------------
  // The base rows among themselves (one lane), their terms in every joint
  // row (one lane per joint, rows in descending order), then each step of
  // back_item: one row of every limb side by side.
  W.each(1, [&](int) {
    for (int r = nv - 1; r >= nq; --r) {
      const float ur = y[r] * inv_d[r];
      u[r] = ur;
      for (int k = nq; k < r; ++k) y[k] -= (H[tri(r, k)] * inv_d[k]) * ur;
    }
  });
  W.each(nq, [&](int k) {
    float acc = y[k];
    for (int r = nv - 1; r >= nq; --r)
      acc -= (H[tri(r, k)] * inv_d[k]) * u[r];
    y[k] = acc;
  });
  for (int st = 0; st < M.n_back_step; ++st) {
    const int first = M.back_off[st];
    W.each(M.back_off[st + 1] - first, [&](int i) {
      const int code = M.back_item[first + i], r = code & 0xff, k = code >> 8;
      const float ur = y[r] * inv_d[r];
      if (k == r)
        u[r] = ur;
      else
        y[k] -= (H[tri(r, k)] * inv_d[k]) * ur;
    });
  }
  // udot in the original order: base = u[nq..nq+5], joints = u[0..nq-1].

  // ---------------- integrate ----------------------------------------------
  // Items: the joints, the base, the ball, the sensor sums, the body forces.
  W.each(nq + 2 + BEZ_N_SENS + 3 * nb, [&](int k) {
    if (k < nq) {
      const int j = k;
      const float cap = M.max_joint_vel;
      float qdn = clampf(sin[s_qd + j] + h * u[j], -cap, cap);
      const float qn = sin[j] + h * qdn;
      const float lo = pin[p_lo + j], hi = pin[p_hi + j];
      if (qn < lo || qn > hi) qdn = 0.f;
      out[j] = clampf(qn, lo, hi);
      out[s_qd + j] = qdn;
    } else if (k == nq) {
      float u6[6];
      for (int i = 0; i < 6; ++i) {
        const float un = sin[s_bu + i] + h * u[nq + i];
        const float c = i < 3 ? M.max_base_lin_vel : M.max_base_ang_vel;
        u6[i] = clampf(un, -c, c);
        out[s_bu + i] = u6[i];
      }
      out[s_bpos] = sin[s_bpos] + h * u6[0];
      out[s_bpos + 1] = sin[s_bpos + 1] + h * u6[1];
      out[s_bpos + 2] = sin[s_bpos + 2] + h * u6[2];
      quat_step(sin + s_bquat, v3(u6[3], u6[4], u6[5]), h, out + s_bquat);
    } else if (k == nq + 1) {
      if (M.has_ball) {
        const V3 ball_F = load3(ball), ball_N = load3(ball + 3);
        const float bm = M.ball_mass, bi = M.ball_inertia,
                    cb = M.max_ball_vel;
        const V3 bv = v3(clampf(ballv.x + h * ball_F.x / bm, -cb, cb),
                         clampf(ballv.y + h * ball_F.y / bm, -cb, cb),
                         clampf(ballv.z + h * ball_F.z / bm, -cb, cb));
        const V3 bw = v3(ballw.x + h * ball_N.x / bi,
                         ballw.y + h * ball_N.y / bi,
                         ballw.z + h * ball_N.z / bi);
        store3(out + s_ballv, bv);
        store3(out + s_ballw, bw);
        store3(out + s_ballp, ballp + bv * h);
        quat_step(sin + s_ballq, bw, h, out + s_ballq);
      } else {
        for (int i = 0; i < 3; ++i) {
          out[s_ballp + i] = sin[s_ballp + i];
          out[s_ballv + i] = sin[s_ballv + i];
          out[s_ballw + i] = sin[s_ballw + i];
        }
        for (int i = 0; i < 4; ++i) out[s_ballq + i] = sin[s_ballq + i];
      }
    } else if (k < nq + 2 + BEZ_N_SENS) {
      const int i = k - nq - 2;
      out[o_sens + i] = sens[i];
    } else {
      const int i = k - nq - 2 - BEZ_N_SENS;
      out[o_bcf + i] = F[i];
    }
  });
}
