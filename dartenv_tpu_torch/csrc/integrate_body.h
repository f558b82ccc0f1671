// The position update of one env, shared by the CUDA kernel (integrate.cu)
// and its host build (integrate_host.cpp): dynamics/batched.
// integrate_positions written out per env, in its operation order.
//
//   every column          q + dq * dt
//   BALL / FREE rotation  so3_log_quat(quat_mul(so3_exp_quat(w),
//                                               so3_exp_quat(dw * dt)))
//   FREE translation      p + (so3_exp(w) @ v) * dt, with the old w
//
// Every sum is taken left to right, as the plain version's three-term
// sums; the Taylor branches (theta2 < 1e-12, vn2 < 1e-12), the w < 0
// short-geodesic flip and the clamps are math/spatial.py's.  A clamp is
// written with comparisons so that a NaN passes through it as it does
// through torch.clamp.  Built with -fmad=false (nvcc) or -ffp-contract=off
// (g++): products and sums round separately, like the plain version.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define IG_FN __device__ __forceinline__
#else
#define IG_FN static inline
#endif

// math/spatial._EPS ** 2 and the Taylor threshold, rounded to float32 as
// PyTorch rounds a Python scalar against a float32 tensor
#define IG_EPS2 ((float)(1e-9 * 1e-9))
#define IG_SMALL ((float)1e-12)

IG_FN float ig_norm2(float x, float y, float z) {
    return x * x + y * y + z * z;
}

// so3_exp_quat: rotation vector -> unit quaternion (w, x, y, z)
IG_FN void ig_exp_quat(const float w[3], float out[4]) {
    const float theta2 = ig_norm2(w[0], w[1], w[2]);
    const float theta = sqrtf(theta2 + IG_EPS2);
    float s, c;
    if (theta2 < IG_SMALL) {
        s = 0.5f - theta2 / 48.0f;
        c = 1.0f - theta2 / 8.0f;
    } else {
        s = sinf(0.5f * theta) / theta;
        c = cosf(0.5f * theta);
    }
    out[0] = c;
    out[1] = w[0] * s;
    out[2] = w[1] * s;
    out[3] = w[2] * s;
}

// quat_mul (Hamilton product, wxyz)
IG_FN void ig_quat_mul(const float a[4], const float b[4], float o[4]) {
    o[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
    o[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
    o[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
    o[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

// so3_log_quat: unit quaternion -> rotation vector
IG_FN void ig_log_quat(const float q[4], float out[3]) {
    const bool flip = q[0] < 0.0f;          // the short geodesic
    const float q0 = flip ? -q[0] : q[0];
    const float v0 = flip ? -q[1] : q[1];
    const float v1 = flip ? -q[2] : q[2];
    const float v2 = flip ? -q[3] : q[3];
    const float w = q0 < -1.0f ? -1.0f : (q0 > 1.0f ? 1.0f : q0);
    const float vn2 = ig_norm2(v0, v1, v2);
    const float vn = sqrtf(vn2 + IG_EPS2);
    const float angle = 2.0f * atan2f(vn, w);
    const float scale = vn2 < IG_SMALL ? 2.0f / (w < 0.5f ? 0.5f : w)
                                       : angle / vn;
    out[0] = v0 * scale;
    out[1] = v1 * scale;
    out[2] = v2 * scale;
}

// so3_exp: rotation vector -> row-major 3x3 rotation, eye + a K + b K K
// with K = skew(w) and K K summed over its three terms, zeros included
IG_FN void ig_exp_mat(const float w[3], float R[9]) {
    const float theta2 = ig_norm2(w[0], w[1], w[2]);
    const float theta = sqrtf(theta2 + IG_EPS2);
    float a, b;
    if (theta2 < IG_SMALL) {
        a = 1.0f - theta2 / 6.0f;
        b = 0.5f - theta2 / 24.0f;
    } else {
        a = sinf(theta) / theta;
        b = (1.0f - cosf(theta)) / theta2;
    }
    const float K[9] = {0.0f, -w[2], w[1], w[2], 0.0f, -w[0],
                        -w[1], w[0], 0.0f};
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            const float kk = K[3 * i] * K[j] + K[3 * i + 1] * K[3 + j]
                             + K[3 * i + 2] * K[6 + j];
            R[3 * i + j] = ((i == j ? 1.0f : 0.0f) + a * K[3 * i + j])
                           + b * kk;
        }
}

// One env's q_new (n floats) from its q, dq.  jt: G pairs (q_start,
// is_free) of the model's BALL and FREE joints; dt as float32.
IG_FN void ig_env(const float* q, const float* dq, float* out, int n,
                  const int* jt, int G, float dt) {
    for (int c = 0; c < n; ++c) out[c] = q[c] + dq[c] * dt;
    for (int g = 0; g < G; ++g) {
        const int s = jt[2 * g];
        const float w[3] = {q[s], q[s + 1], q[s + 2]};
        const float dw[3] = {dq[s] * dt, dq[s + 1] * dt, dq[s + 2] * dt};
        float qa[4], qb[4], qm[4];
        ig_exp_quat(w, qa);
        ig_exp_quat(dw, qb);
        ig_quat_mul(qa, qb, qm);
        ig_log_quat(qm, out + s);
        if (jt[2 * g + 1]) {
            float R[9];
            ig_exp_mat(w, R);
            for (int k = 0; k < 3; ++k) {
                const float v = R[3 * k] * dq[s + 3]
                                + R[3 * k + 1] * dq[s + 4]
                                + R[3 * k + 2] * dq[s + 5];
                out[s + 3 + k] = q[s + 3 + k] + v * dt;
            }
        }
    }
}
