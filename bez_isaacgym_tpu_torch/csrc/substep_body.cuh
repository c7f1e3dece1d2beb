// One physics substep (h = dt / substeps) for one environment.
//
// Replaces the TPU kernel `_substep_kernel` in
// bez_isaacgym_tpu/ops/pallas_step.py (launched through
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
// What bounds it on an H100: neither device memory nor arithmetic at the
// rooflines.  Each env reads and writes 356 floats (1,424 bytes) and needs
// some 1.4e4 flops with no contact active (ops/substep.py::flop_terms), so
// at B = 8192 the byte bound, ~3.5 us, is above the FP32 bound, ~1.7 us.
// The real limit is per-thread state: the mass matrix (300 floats packed
// for nv = 24), the frames (R, P, C per body) and the contact moments do
// not fit in registers and live in local memory (L1/L2 backed).
// Design for this first version: one thread per env, so the (d, B)
// structure-of-arrays layout gives coalesced loads and stores; the robot's
// topology is data (SubstepTables, one device buffer per model) read in
// loops instead of an unrolled per-model body, so one build serves every
// asset variant and compiles in seconds; the ragged tail of B is masked in
// the launcher.  Redesigning the storage (warp-cooperative factorization,
// shared-memory tiles) is left to a later revision measured against this.
//
// The body is __host__ __device__ so the CPU tests can compile it with a
// host C++ compiler and hold it against the plain PyTorch version.

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
#define BEZ_MAX_TRI (BEZ_MAX_NV * (BEZ_MAX_NV + 1) / 2)
#define BEZ_MAX_NC 256
#define BEZ_MAX_BOX 32
#define BEZ_N_SENS 8
#define BEZ_N_MOM 16

// Model topology and scene constants.  Every field is 4 bytes wide, so the
// layout has no padding; ops/substep.py mirrors it field for field.
struct SubstepTables {
  int nb, nq, nc, nbox, has_ball;
  float h;
  float kn, cn, vt_eps, ball_kn, ball_cn;
  float ball_radius, ball_mass, ball_inertia, ball_rolling_friction;
  float max_joint_vel, max_base_lin_vel, max_base_ang_vel, max_ball_vel;
  float friction_vel_scale;
  int parent[BEZ_MAX_NB];
  unsigned int anc_mask[BEZ_MAX_NB];   // bit d: DOF d moves body b
  float tree_pos[BEZ_MAX_NB][3];
  float tree_rot[BEZ_MAX_NB][9];       // row-major
  float axis[BEZ_MAX_NB][3];           // per DOF
  float com[BEZ_MAX_NB][3];
  float mass[BEZ_MAX_NB];
  float inertia[BEZ_MAX_NB][9];
  int cp_body[BEZ_MAX_NC];
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

BEZ_HD void bez_substep_env(const SubstepTables& M,
                            const float* __restrict__ state_in,
                            const float* __restrict__ params_in,
                            float* __restrict__ out, int i, int ld) {
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
#define SIN(r) state_in[(size_t)(r) * ld + i]
#define PIN(r) params_in[(size_t)(r) * ld + i]
#define OUT(r) out[(size_t)(r) * ld + i]

  float q[BEZ_MAX_NB], qd[BEZ_MAX_NB];
  for (int j = 0; j < nq; ++j) {
    q[j] = SIN(j);
    qd[j] = SIN(s_qd + j);
  }
  const V3 base_pos = v3(SIN(s_bpos), SIN(s_bpos + 1), SIN(s_bpos + 2));
  float bq[4];
  for (int k = 0; k < 4; ++k) bq[k] = SIN(s_bquat + k);
  const V3 v0 = v3(SIN(s_bu), SIN(s_bu + 1), SIN(s_bu + 2));
  const V3 w0 = v3(SIN(s_bu + 3), SIN(s_bu + 4), SIN(s_bu + 5));
  const V3 grav = v3(PIN(p_grav), PIN(p_grav + 1), PIN(p_grav + 2));
  const float mu = PIN(p_mu);

  // ---------------- FK ------------------------------------------------------
  float R[BEZ_MAX_NB][9];
  V3 P[BEZ_MAX_NB], C[BEZ_MAX_NB], AXW[BEZ_MAX_NB];
  {
    const float x = bq[0], y = bq[1], z = bq[2], w = bq[3];
    const float s = 2.0f / fmaxf(x * x + y * y + z * z + w * w, 1e-12f);
    float* R0 = R[0];
    R0[0] = 1 - s * (y * y + z * z);
    R0[1] = s * (x * y - z * w);
    R0[2] = s * (x * z + y * w);
    R0[3] = s * (x * y + z * w);
    R0[4] = 1 - s * (x * x + z * z);
    R0[5] = s * (y * z - x * w);
    R0[6] = s * (x * z - y * w);
    R0[7] = s * (y * z + x * w);
    R0[8] = 1 - s * (x * x + y * y);
  }
  P[0] = base_pos;
  for (int b = 1; b < nb; ++b) {
    const int p = M.parent[b], d = b - 1;
    P[b] = P[p] + mv(R[p], load3(M.tree_pos[b]));
    float Rpre[9], Rj[9];
    mm(R[p], M.tree_rot[b], Rpre);
    const float ax = M.axis[d][0], ay = M.axis[d][1], az = M.axis[d][2];
    const float c = cosf(q[d]), s = sinf(q[d]), t = 1.0f - c;
    Rj[0] = c + ax * ax * t;
    Rj[1] = ax * ay * t - az * s;
    Rj[2] = ax * az * t + ay * s;
    Rj[3] = ay * ax * t + az * s;
    Rj[4] = c + ay * ay * t;
    Rj[5] = ay * az * t - ax * s;
    Rj[6] = az * ax * t - ay * s;
    Rj[7] = az * ay * t + ax * s;
    Rj[8] = c + az * az * t;
    mm(Rpre, Rj, R[b]);
    AXW[d] = mv(Rpre, load3(M.axis[d]));
  }
  for (int b = 0; b < nb; ++b) C[b] = P[b] + mv(R[b], load3(M.com[b]));

  // ---------------- body velocities and qdd=0 bias accelerations -----------
  // The anchor of DOF d is the origin of body d + 1.
  V3 W[BEZ_MAX_NB], Vc[BEZ_MAX_NB], AL0[BEZ_MAX_NB], AC0[BEZ_MAX_NB];
  {
    const V3 r0 = C[0] - P[0];
    W[0] = w0;
    Vc[0] = v0 + cross(w0, r0);
    AL0[0] = v3(0.f, 0.f, 0.f);
    AC0[0] = cross(w0, cross(w0, r0));
  }
  for (int b = 1; b < nb; ++b) {
    const int p = M.parent[b], d = b - 1;
    const V3 aq = AXW[d] * qd[d];
    W[b] = W[p] + aq;
    const V3 r_pa = P[b] - C[p], r_ac = C[b] - P[b];
    Vc[b] = Vc[p] + cross(W[p], r_pa) + cross(W[b], r_ac);
    AL0[b] = AL0[p] + cross(W[p], aq);
    const V3 a_anchor =
        AC0[p] + cross(AL0[p], r_pa) + cross(W[p], cross(W[p], r_pa));
    AC0[b] = a_anchor + cross(AL0[b], r_ac) + cross(W[b], cross(W[b], r_ac));
  }

  // ---------------- plane contacts ------------------------------------------
  const float kn = M.kn, cn = M.cn, eps2 = M.vt_eps * M.vt_eps;
  V3 F[BEZ_MAX_NB], N[BEZ_MAX_NB];
  float Wm[BEZ_MAX_NB][BEZ_N_MOM];
  float sens[BEZ_N_SENS];
  for (int b = 0; b < nb; ++b) {
    F[b] = v3(0.f, 0.f, 0.f);
    N[b] = v3(0.f, 0.f, 0.f);
    for (int k = 0; k < BEZ_N_MOM; ++k) Wm[b][k] = 0.f;
  }
  for (int k = 0; k < BEZ_N_SENS; ++k) sens[k] = 0.f;
  for (int c = 0; c < M.nc; ++c) {
    const int b = M.cp_body[c];
    const V3 pw = P[b] + mv(R[b], load3(M.cp_pos[c]));
    const V3 r = pw - C[b];
    const V3 vp = Vc[b] + cross(W[b], r);
    const float pen = -pw.z;
    const bool active = pen > 0.f;
    const float fn = active ? fmaxf(kn * pen - cn * vp.z, 0.f) : 0.f;
    // sqrt(|vt|^2 + eps^2): the smooth friction direction.
    const float vt_norm = sqrtf(vp.x * vp.x + vp.y * vp.y + eps2);
    const float scale = -mu * fn / vt_norm;
    const V3 f = v3(vp.x * scale, vp.y * scale, fn);
    F[b] = F[b] + f;
    N[b] = N[b] + cross(r, f);
    const int slot = M.cp_sensor[c];
    if (slot >= 0) sens[slot] += fn;
    // Implicit damping moments.
    const float fn_est = active ? fmaxf(kn * pen, 0.f) : 0.f;
    const float d_t = mu * fn_est / vt_norm;
    const float g = (active ? cn : 0.f) - d_t;
    const float x = r.x, y = r.y, z = r.z;
    float* m = Wm[b];
    m[0] += d_t;
    m[1] += d_t * x;
    m[2] += d_t * y;
    m[3] += d_t * z;
    m[4] += d_t * x * x;
    m[5] += d_t * y * y;
    m[6] += d_t * z * z;
    m[7] += d_t * x * y;
    m[8] += d_t * x * z;
    m[9] += d_t * y * z;
    m[10] += g;
    m[11] += g * x;
    m[12] += g * y;
    m[13] += g * x * x;
    m[14] += g * y * y;
    m[15] += g * x * y;
  }

  // ---------------- ball ----------------------------------------------------
  const V3 ballp = v3(SIN(s_ballp), SIN(s_ballp + 1), SIN(s_ballp + 2));
  const V3 ballv = v3(SIN(s_ballv), SIN(s_ballv + 1), SIN(s_ballv + 2));
  const V3 ballw = v3(SIN(s_ballw), SIN(s_ballw + 1), SIN(s_ballw + 2));
  V3 ball_F = v3(0.f, 0.f, 0.f), ball_N = v3(0.f, 0.f, 0.f);
  if (M.has_ball) {
    const float rad = M.ball_radius, bkn = M.ball_kn, bcn = M.ball_cn;
    // Sphere vs plane.
    const float pen = rad - ballp.z;
    const V3 off = v3(0.f, 0.f, -rad);
    const V3 vp = ballv + cross(ballw, off);
    const float fn = pen > 0.f ? fmaxf(bkn * pen - bcn * vp.z, 0.f) : 0.f;
    const float vt_norm = sqrtf(vp.x * vp.x + vp.y * vp.y + eps2);
    const float s = -mu * fn / vt_norm;
    const V3 fpl = v3(vp.x * s, vp.y * s, fn);
    ball_F = ball_F + fpl;
    ball_N = ball_N + cross(off, fpl);
    // Rolling resistance, smooth at zero spin.
    const float wn = sqrtf(dot(ballw, ballw) + 1e-12f);
    ball_N = ball_N + ballw * (-M.ball_rolling_friction * fn * rad / wn);
    // Sphere vs each robot collision box.
    for (int k = 0; k < M.nbox; ++k) {
      const int b = M.box_body[k];
      const V3 box_c = P[b] + mv(R[b], load3(M.box_pos[k]));
      float Rbox[9];
      mm(R[b], M.box_rot[k], Rbox);
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
      const V3 rb = closest - C[b];
      const V3 vrp = Vc[b] + cross(W[b], rb);
      const V3 rel = vbp - vrp;
      const float vn = dot(rel, nrm);
      const float bfn = bpen > 0.f ? fmaxf(bkn * bpen - bcn * vn, 0.f) : 0.f;
      const V3 vt = rel - nrm * vn;
      const float vtn = sqrtf(dot(vt, vt) + eps2);
      const V3 fb = nrm * bfn - vt * (mu * bfn / vtn);
      ball_F = ball_F + fb;
      ball_N = ball_N + cross(closest - ballp, fb);
      F[b] = F[b] - fb;
      N[b] = N[b] - cross(rb, fb);
    }
    ball_F = ball_F + grav * M.ball_mass;
  }

  // ---------------- mass matrix and right-hand side ------------------------
  // H is built in the joints-first elimination order (joint DOFs, then the
  // base), as a packed lower triangle: only H[c1][c2] for c1 <= c2 in the
  // original column order is computed, then stored at its permuted place.
  float L[BEZ_MAX_TRI];
  float tau[BEZ_MAX_NV];
  for (int k = 0; k < nv * (nv + 1) / 2; ++k) L[k] = 0.f;
  for (int k = 0; k < 6; ++k) tau[k] = 0.f;
  float c_fric[BEZ_MAX_NB];
  for (int j = 0; j < nq; ++j) {
    const float kp = PIN(j), kd = PIN(p_kd + j), eff = PIN(p_eff + j);
    const float t_pd = clampf(kp * (PIN(p_tgt + j) - q[j]) - (h * kp + kd) * qd[j],
                              -eff, eff);
    c_fric[j] = PIN(p_jf + j) / (fabsf(qd[j]) + M.friction_vel_scale);
    tau[6 + j] = t_pd - c_fric[j] * qd[j];
  }
  for (int b = 0; b < nb; ++b) {
    // Active Jacobian columns of body b: the 6 base columns, then its
    // ancestor DOFs in ascending order.
    int col[BEZ_MAX_NV];
    V3 lin[BEZ_MAX_NV], ang[BEZ_MAX_NV];
    const V3 rb0 = C[b] - P[0];
    for (int k = 0; k < 3; ++k) {
      const V3 e = v3(k == 0, k == 1, k == 2);
      col[k] = k;
      lin[k] = e;
      ang[k] = v3(0.f, 0.f, 0.f);
      col[3 + k] = 3 + k;
      lin[3 + k] = cross(e, rb0);
      ang[3 + k] = e;
    }
    int n = 6;
    const unsigned int mask = M.anc_mask[b];
    for (int d = 0; d < nq; ++d) {
      if (!((mask >> d) & 1u)) continue;
      col[n] = 6 + d;
      lin[n] = cross(AXW[d], C[b] - P[d + 1]);
      ang[n] = AXW[d];
      ++n;
    }
    // Spatial inertia plus h * contact damping: G = [[A, B], [B^T, E]].
    const float ms = PIN(p_ms + b);
    const float m_b = M.mass[b] * ms;
    float RI[9], Iw[9], Rt[9];
    mm(R[b], M.inertia[b], RI);
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) Rt[3 * r + c] = R[b][3 * c + r];
    mm(RI, Rt, Iw);
    for (int k = 0; k < 9; ++k) Iw[k] *= ms;
    const float* m = Wm[b];
    const float A[9] = {h * m[0] + m_b, 0.f, 0.f,
                        0.f, h * m[0] + m_b, 0.f,
                        0.f, 0.f, h * (m[0] + m[10]) + m_b};
    const float Bm[9] = {0.f, h * m[3], -h * m[2],
                         -h * m[3], 0.f, h * m[1],
                         h * (m[2] + m[12]), -h * (m[1] + m[11]), 0.f};
    const float e01 = -h * (m[7] + m[15]) + Iw[1];
    const float e02 = -h * m[8] + Iw[2];
    const float e12 = -h * m[9] + Iw[5];
    const float E[9] = {h * (m[6] + m[5] + m[14]) + Iw[0], e01, e02,
                        e01, h * (m[6] + m[4] + m[13]) + Iw[4], e12,
                        e02, e12, h * (m[4] + m[5]) + Iw[8]};
    // Wrench: f_net = F - m (a0 - g); n_net = N - I alpha0 - w x I w.
    const V3 f_net = F[b] - (AC0[b] - grav) * m_b;
    const V3 n_net = N[b] - mv(Iw, AL0[b]) - cross(W[b], mv(Iw, W[b]));
    V3 top[BEZ_MAX_NV], bot[BEZ_MAX_NV];
    for (int a = 0; a < n; ++a) {
      top[a] = mv(A, lin[a]) + mv(Bm, ang[a]);
      bot[a] = mtv(Bm, lin[a]) + mv(E, ang[a]);
    }
    for (int a = 0; a < n; ++a) {
      const int c1 = col[a];
      tau[c1] += dot(lin[a], f_net) + dot(ang[a], n_net);
      const int p1 = c1 < 6 ? nq + c1 : c1 - 6;
      for (int a2 = a; a2 < n; ++a2) {
        const int c2 = col[a2];
        const int p2 = c2 < 6 ? nq + c2 : c2 - 6;
        const float val = dot(lin[a], top[a2]) + dot(ang[a], bot[a2]);
        L[p1 > p2 ? tri(p1, p2) : tri(p2, p1)] += val;
      }
    }
  }
  // Armature, implicit Stable-PD and joint-friction diagonal.
  for (int j = 0; j < nq; ++j) {
    const float kp = PIN(j), kd = PIN(p_kd + j);
    L[tri(j, j)] += PIN(p_arm + j) + h * (h * kp + kd + c_fric[j]);
  }

  // ---------------- Cholesky solve (joints-first order) --------------------
  float inv_d[BEZ_MAX_NV], x[BEZ_MAX_NV];
  for (int j = 0; j < nv; ++j) {
    const float dj = sqrtf(fmaxf(L[tri(j, j)], 1e-9f));
    const float id = 1.0f / dj;
    inv_d[j] = id;
    L[tri(j, j)] = dj;
    for (int r = j + 1; r < nv; ++r) L[tri(r, j)] *= id;
    for (int r = j + 1; r < nv; ++r) {
      const float lrj = L[tri(r, j)];
      for (int k = j + 1; k <= r; ++k) L[tri(r, k)] -= lrj * L[tri(k, j)];
    }
  }
  for (int k = 0; k < nv; ++k) x[k] = tau[k < nq ? 6 + k : k - nq];
  for (int j = 0; j < nv; ++j) {        // L y = b
    const float yj = x[j] * inv_d[j];
    x[j] = yj;
    for (int r = j + 1; r < nv; ++r) x[r] -= L[tri(r, j)] * yj;
  }
  for (int r = nv - 1; r >= 0; --r) {   // L^T x = y
    const float xr = x[r] * inv_d[r];
    x[r] = xr;
    for (int k = 0; k < r; ++k) x[k] -= L[tri(r, k)] * xr;
  }
  // udot in the original order: base = x[nq..nq+5], joints = x[0..nq-1].

  // ---------------- integrate -----------------------------------------------
  const float cap = M.max_joint_vel;
  for (int j = 0; j < nq; ++j) {
    float qdn = clampf(qd[j] + h * x[j], -cap, cap);
    const float qn = q[j] + h * qdn;
    const float lo = PIN(p_lo + j), hi = PIN(p_hi + j);
    if (qn < lo || qn > hi) qdn = 0.f;
    OUT(j) = clampf(qn, lo, hi);
    OUT(s_qd + j) = qdn;
  }
  float u6[6];
  for (int k = 0; k < 6; ++k) {
    const float un = SIN(s_bu + k) + h * x[nq + k];
    const float c = k < 3 ? M.max_base_lin_vel : M.max_base_ang_vel;
    u6[k] = clampf(un, -c, c);
    OUT(s_bu + k) = u6[k];
  }
  OUT(s_bpos) = base_pos.x + h * u6[0];
  OUT(s_bpos + 1) = base_pos.y + h * u6[1];
  OUT(s_bpos + 2) = base_pos.z + h * u6[2];
  float nq4[4];
  quat_step(bq, v3(u6[3], u6[4], u6[5]), h, nq4);
  for (int k = 0; k < 4; ++k) OUT(s_bquat + k) = nq4[k];

  float ballq[4];
  for (int k = 0; k < 4; ++k) ballq[k] = SIN(s_ballq + k);
  if (M.has_ball) {
    const float bm = M.ball_mass, bi = M.ball_inertia, cb = M.max_ball_vel;
    const V3 bv = v3(clampf(ballv.x + h * ball_F.x / bm, -cb, cb),
                     clampf(ballv.y + h * ball_F.y / bm, -cb, cb),
                     clampf(ballv.z + h * ball_F.z / bm, -cb, cb));
    const V3 bw = v3(ballw.x + h * ball_N.x / bi, ballw.y + h * ball_N.y / bi,
                     ballw.z + h * ball_N.z / bi);
    const V3 bp = ballp + bv * h;
    OUT(s_ballv) = bv.x;
    OUT(s_ballv + 1) = bv.y;
    OUT(s_ballv + 2) = bv.z;
    OUT(s_ballw) = bw.x;
    OUT(s_ballw + 1) = bw.y;
    OUT(s_ballw + 2) = bw.z;
    OUT(s_ballp) = bp.x;
    OUT(s_ballp + 1) = bp.y;
    OUT(s_ballp + 2) = bp.z;
    float nb4[4];
    quat_step(ballq, bw, h, nb4);
    for (int k = 0; k < 4; ++k) OUT(s_ballq + k) = nb4[k];
  } else {
    for (int k = 0; k < 3; ++k) {
      OUT(s_ballp + k) = SIN(s_ballp + k);
      OUT(s_ballv + k) = SIN(s_ballv + k);
      OUT(s_ballw + k) = SIN(s_ballw + k);
    }
    for (int k = 0; k < 4; ++k) OUT(s_ballq + k) = ballq[k];
  }

  for (int k = 0; k < BEZ_N_SENS; ++k) OUT(o_sens + k) = sens[k];
  for (int b = 0; b < nb; ++b) {
    OUT(o_bcf + 3 * b) = F[b].x;
    OUT(o_bcf + 3 * b + 1) = F[b].y;
    OUT(o_bcf + 3 * b + 2) = F[b].z;
  }
#undef SIN
#undef PIN
#undef OUT
}
