// Fused rigid-foot contact rollout for NVIDIA Hopper (sm_90a), f32.
//
// Replaces the TPU kernel blf_tpu/ops/pallas/rollout.py::_rollout_kernel
// (entry foot_rollout_fused). For every lane of a fleet, `steps` forward-Euler
// steps of a rigid foot on the continuous spring-damper patch:
//
//     (f, tau) = closed-form patch wrench of the pose, twist and null pose
//     vdot = f / m + g
//     wdot = R I^-1 R' (tau - w x (R I R' w))        diagonal body inertia
//     Rdot = w^ R + rho/2 ((R R')^-1 - I) R           adjugate 3x3 inverse
//     x   += dt xdot
//
// in the reference kernel's order, component by component
// (rollout.py:94-159). A lane holding a NaN keeps it in its own outputs and
// touches no other lane: lanes share nothing but the scalars.
//
// What bounds it on an H100: operations. A lane-step is 376 floating-point
// operations (an FMA counted as two) on 40 values that never leave
// registers; a lane reads 22 floats (the state, the two null-rotation
// columns and the null position, k, b) and writes 18, once for the whole
// horizon: 65536 lanes move 10-13 MB, 4 us at 3.35 TB/s, against some
// 2.5e10 operations at (65536 lanes, 1000 steps), 0.37 ms at the H100 SXM
// data sheet's 67 TFLOP/s f32.
//
// What held the first version of this kernel (on an NVIDIA H100 80GB HBM3
// at 700.00 W, PERF.md section 6): not latency. At (65536 lanes, 1000 steps)
// it ran 0.93 ms, and twice and four times the lanes (31 and 62 warps an SM
// where 65536 lanes give 15.5) took 1.69 and 3.28 ms: 9 and 12 % less a
// lane-step, so more warps in flight would buy little. Its time went to the
// instructions it issues, seven IEEE divisions a step among them (each some
// ten instructions and a branch). At 10 steps, the identification's
// segment, the launch took 0.023 ms on the card and its wrapper 0.093 ms on
// the host, half of it building the scalars' device tensor.
//
// Design:
//  * One thread a lane, 128 threads a block, no shared memory. The lane's 18
//    state values, its null pose (the two columns of R0 the wrench reads, and
//    p0) and its k and b stay in registers for all `steps`.
//  * The eight scalars (L, W, mass, I1..3, rho, dt) come by value, a
//    FootScalars argument, as do k and b when they are one value for every
//    lane: a launch copies nothing to the device and allocates nothing but
//    its output.
//  * Divisions by the constants m and I_i are multiplications by their
//    reciprocals, formed once a lane in IEEE division: 6 of the 7 divisions
//    of a step go (1 / det stays an IEEE division). The rounding moves by at
//    most 1.5 ulp a quotient; the damped rollout stays within 2e-5 of the
//    plain version (PERF.md section 6).
//  * Lane-major (B, ...) arrays, as the caller holds them: each lane loads
//    and stores its own 12- and 36-byte records once; a transpose would cost
//    more than it saves on 10-13 MB. The four outputs lie in one buffer of
//    18 B floats (p, R, v, w one after another).
//  * The null pose and the two coefficients are each either per lane or one
//    value for all lanes, so a broadcast never materialises.
//  * Every lane is checked against B: any batch, no padding.
//  * No -use_fast_math; nvcc's default FMA contraction stays.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC -Xptxas -v (no -use_fast_math).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr float GRAVITY_Z = -9.81f;

}  // namespace

// The scalars of a rollout, by value, in the order of the plain version's
// (8,) tensor (ops/cuda/rollout.py: FootScalars).
struct FootScalars {
    float length, width, mass, inertia[3], baumgarte_rho, dt;
};

namespace {

__device__ __forceinline__ void cross(const float a[3], const float b[3], float out[3]) {
    out[0] = a[1] * b[2] - a[2] * b[1];
    out[1] = a[2] * b[0] - a[0] * b[2];
    out[2] = a[0] * b[1] - a[1] * b[0];
}

// r row-major, R[i][j] = r[3i + j]
__device__ __forceinline__ void mat_vec(const float r[9], const float v[3], float out[3]) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
        out[i] = r[3 * i] * v[0] + r[3 * i + 1] * v[1] + r[3 * i + 2] * v[2];
}

__device__ __forceinline__ void mat_t_vec(const float r[9], const float v[3], float out[3]) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
        out[j] = r[j] * v[0] + r[3 + j] * v[1] + r[6 + j] * v[2];
}

__global__ void __launch_bounds__(THREADS)
foot_rollout_kernel(const float* __restrict__ p_in, const float* __restrict__ r_in,
                    const float* __restrict__ v_in, const float* __restrict__ w_in,
                    const float* __restrict__ p0_in, const float* __restrict__ r0_in,
                    const float* __restrict__ k_in, const float* __restrict__ b_in,
                    const FootScalars scal, float k_value, float b_value,
                    float* __restrict__ out, long long B, int steps, int p0_lanes,
                    int r0_lanes, int k_lanes, int b_lanes) {
    const long long lane = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (lane >= B) return;

    const float L = scal.length, Wd = scal.width, mass = scal.mass;
    const float I1 = scal.inertia[0], I2 = scal.inertia[1], I3 = scal.inertia[2];
    const float rho = scal.baumgarte_rho, dt = scal.dt;
    const float area = L * Wd;
    const float L2 = L * L, W2 = Wd * Wd;
    const float area12 = area / 12.0f;
    const float half_rho = 0.5f * rho;
    const float inv_mass = 1.0f / mass;
    const float inv_I1 = 1.0f / I1, inv_I2 = 1.0f / I2, inv_I3 = 1.0f / I3;

    const float k = k_lanes ? k_in[lane] : k_value;
    const float b = b_lanes ? b_in[lane] : b_value;
    const float* p0p = p0_in + (p0_lanes ? 3 * lane : 0);
    const float* r0p = r0_in + (r0_lanes ? 9 * lane : 0);
    const float p0[3] = {p0p[0], p0p[1], p0p[2]};
    const float r0e1[3] = {r0p[0], r0p[3], r0p[6]};
    const float r0e2[3] = {r0p[1], r0p[4], r0p[7]};

    float p[3], r[9], v[3], w[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        p[i] = p_in[3 * lane + i];
        v[i] = v_in[3 * lane + i];
        w[i] = w_in[3 * lane + i];
    }
#pragma unroll
    for (int i = 0; i < 9; ++i) r[i] = r_in[9 * lane + i];

    for (int step = 0; step < steps; ++step) {
        // -- the closed-form patch wrench ---------------------------------
        const float ar33 = fabsf(r[8]);
        const float fscale = ar33 * area;
        float f[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) f[i] = fscale * (k * (p0[i] - p[i]) - b * v[i]);
        const float re1[3] = {r[0], r[3], r[6]};
        const float re2[3] = {r[1], r[4], r[7]};
        float t1[3], t2[3], e1w[3], e2w[3], e1r0[3], e2r0[3];
        cross(re1, w, t1);
        cross(re1, t1, e1w);
        cross(re2, w, t2);
        cross(re2, t2, e2w);
        cross(re1, r0e1, e1r0);
        cross(re2, r0e2, e2r0);
        const float tscale = ar33 * area12;
        float tau[3];
#pragma unroll
        for (int i = 0; i < 3; ++i)
            tau[i] = tscale * (L2 * (b * e1w[i] + k * e1r0[i])
                               + W2 * (b * e2w[i] + k * e2r0[i]));

        // -- Newton-Euler with diagonal body inertia ----------------------
        const float v_dot[3] = {f[0] * inv_mass, f[1] * inv_mass,
                                f[2] * inv_mass + GRAVITY_Z};
        float u[3], iww[3], gyro[3], te[3], ut[3], w_dot[3];
        mat_t_vec(r, w, u);
        const float iu[3] = {I1 * u[0], I2 * u[1], I3 * u[2]};
        mat_vec(r, iu, iww);
        cross(w, iww, gyro);
#pragma unroll
        for (int i = 0; i < 3; ++i) te[i] = tau[i] - gyro[i];
        mat_t_vec(r, te, ut);
        const float ui[3] = {ut[0] * inv_I1, ut[1] * inv_I2, ut[2] * inv_I3};
        mat_vec(r, ui, w_dot);

        // -- Rdot = w^ R + rho/2 (S^-1 - I) R, S = R R' (adjugate) --------
        const float s00 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
        const float s01 = r[0] * r[3] + r[1] * r[4] + r[2] * r[5];
        const float s02 = r[0] * r[6] + r[1] * r[7] + r[2] * r[8];
        const float s11 = r[3] * r[3] + r[4] * r[4] + r[5] * r[5];
        const float s12 = r[3] * r[6] + r[4] * r[7] + r[5] * r[8];
        const float s22 = r[6] * r[6] + r[7] * r[7] + r[8] * r[8];
        const float c00 = s11 * s22 - s12 * s12;
        const float c01 = s02 * s12 - s01 * s22;
        const float c02 = s01 * s12 - s02 * s11;
        const float c11 = s00 * s22 - s02 * s02;
        const float c12 = s01 * s02 - s00 * s12;
        const float c22 = s00 * s11 - s01 * s01;
        const float det = s00 * c00 + s01 * c01 + s02 * c02;
        const float inv = 1.0f / det;
        const float m[3][3] = {{c00 * inv - 1.0f, c01 * inv, c02 * inv},
                               {c01 * inv, c11 * inv - 1.0f, c12 * inv},
                               {c02 * inv, c12 * inv, c22 * inv - 1.0f}};
        float r_dot[9];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
            for (int j = 0; j < 3; ++j) {
                const float col[3] = {r[j], r[3 + j], r[6 + j]};
                const float wxr = w[(i + 1) % 3] * col[(i + 2) % 3]
                                  - w[(i + 2) % 3] * col[(i + 1) % 3];
                const float corr = m[i][0] * r[j] + m[i][1] * r[3 + j] + m[i][2] * r[6 + j];
                r_dot[3 * i + j] = wxr + half_rho * corr;
            }
        }

        // -- forward Euler, x += dt xdot ------------------------------------
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            p[i] = p[i] + dt * v[i];
            v[i] = v[i] + dt * v_dot[i];
            w[i] = w[i] + dt * w_dot[i];
        }
#pragma unroll
        for (int i = 0; i < 9; ++i) r[i] = r[i] + dt * r_dot[i];
    }

    float* p_out = out;
    float* r_out = out + 3 * B;
    float* v_out = out + 12 * B;
    float* w_out = out + 15 * B;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        p_out[3 * lane + i] = p[i];
        v_out[3 * lane + i] = v[i];
        w_out[3 * lane + i] = w[i];
    }
#pragma unroll
    for (int i = 0; i < 9; ++i) r_out[9 * lane + i] = r[i];
}

}  // namespace

extern "C" {

const char* blf_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

int blf_foot_scalars_bytes() { return (int)sizeof(FootScalars); }

// Roll B lanes `steps` Euler steps on `stream`. Every pointer is a device
// pointer to contiguous f32 data: the state p (B, 3), R (B, 3, 3), v (B, 3),
// w (B, 3); the null pose p0 and R0, each per lane (its *_lanes flag 1:
// (B, 3), (B, 3, 3)) or one pose for all (flag 0: (3,), (3, 3)); k and b per
// lane ((B,), flag 1; else k_value / b_value, and the pointer is not read);
// out (18 B): p, R, v, w of the final state one after another. Returns the
// CUDA error code of the launch (0 on success), -2 for a bad batch or step
// count. Does not synchronise.
int blf_foot_rollout_f32(const float* p, const float* R, const float* v, const float* w,
                         const float* p0, const float* R0, const float* k, const float* b,
                         FootScalars scal, float k_value, float b_value, float* out,
                         long long B, int steps, int p0_lanes, int r0_lanes, int k_lanes,
                         int b_lanes, void* stream) {
    if (B < 1 || steps < 0) return -2;
    const long long blocks = (B + THREADS - 1) / THREADS;
    if (blocks > 2147483647LL) return -2;
    foot_rollout_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        p, R, v, w, p0, R0, k, b, scal, k_value, b_value, out, B, steps, p0_lanes, r0_lanes,
        k_lanes, b_lanes);
    return (int)cudaGetLastError();
}

}  // extern "C"
