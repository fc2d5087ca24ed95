// Fused shared-operator v-space ADMM stage for NVIDIA Hopper (sm_90a), f32.
//
// Replaces the TPU kernel blf_tpu/ops/pallas/admm.py::_stage_kernel_t (entry
// admm_stage_t / admm_stage, matmul="f32"). One launch runs `iters`
// iterations, at a fixed per-lane penalty multiplier s, of
//
//     z  = clip(v, l, u)
//     w  = rho * (2 z - v)
//     t  = G2^T w                       (n outputs, contraction over m)
//     tau = (t - gq / s) * s / (1 + s d)
//     v += alpha (G2 tau - z)           (m outputs, contraction over n)
//
// for every lane of a fleet that shares one operator G2 (m, n). Both products
// of an iteration are computed here, in this kernel's body; v and tau never
// leave the SM between the first and the last iteration.
//
// What bounds it on an H100: operations. A stage does 4*m*n flops a lane an
// iteration and moves (4m + 3n + 1) floats a lane once; at (m, n, iters) =
// (192, 128, 25) that is 2.5 Mflop against 4.6 KB a lane, some 530 flop a
// byte, far above the card's f32 balance of about 20. So the design spends
// its effort on the FMA pipe and none on the device-memory traffic.
//
// Why the FMA units and not the tensor cores. The reference's "f32" is six
// bf16 passes a product (Precision.HIGHEST); the same passes on wgmma ran the
// stage in 3.4 ms where this kernel's first version took 8.0 and agreed
// with the plain version to 4.5e-6 (this kernel: 2.5e-6), but the fleet tick
// on them left 1-3 % of its lanes unconverged on its hardest ticks, 3 to 5,
// against at most 0.02 % on round-to-nearest FMA sums (PERF.md section 6;
// NVIDIA H100 80GB HBM3, 700.00 W). The tensor cores' f32 accumulation
// truncates; which of its effects moves the tick is not identified.
//
// What held the first version (one 32-lane tile on 256 threads; on the card
// above, 8.0 ms at (192, 128), B 98304): its products were 90 % of its time
// (a copy without them took 0.85 ms) at 45 % of the FMA peak, with one block
// of 8 warps an SM, two a scheduler, to hide the shared-memory loads that feed
// them; its 187 KB of shared memory let no second block in.
//
// Design (each choice with its reason):
//  * One block of 512 threads, 16 warps an SM, works on a tile of 32 lanes:
//    two halves of 256 threads split the contraction of each product, the
//    first half over m's (or n's) first half, the second over the rest, each
//    with the first version's register micro-tiles (4 n-rows x 4 lanes in
//    G2^T w, ceil(m/32) m-rows x 4 lanes in G2 tau; each 16-byte shared load
//    feeds 4 or 16 FMAs). Twice the warps with the same loads an FMA, at the
//    cost of one exchange of partial sums a product through shared memory.
//  * Each half owns half of the outputs: two rows of each of its n-row quads
//    of t, and half of its m-rows of v. A half writes the partial sums of
//    the other's rows, the other adds them to its own (a + b, round-to-
//    nearest, the same whichever half adds). So v, z and the gains
//    s/(1 + s d), gq/s are held once, by their owner: under 128 registers.
//    The half is a template parameter, so every register index is fixed at
//    compile time.
//  * The operator is resident in shared memory, ONE copy for both products
//    (rho is applied as an m-vector), rows padded by 4 floats so that the
//    rows a warp reads together fall on different banks.
//  * Four barriers an iteration: after w, after the partials of t, after
//    tau, after the partials of G2 tau.
//  * Both product loops unrolled 4 deep: 7.0 ms at (192, 128) where 4 / 2
//    gave 7.2, 8 / 2 7.3 and 2 / 2 8.0 (NVIDIA H100 80GB HBM3, 700.00 W;
//    PERF.md section 6); 128 registers, none spilled.
//  * s/(1+s d) and gq/s are formed once per stage, in IEEE division.
//  * clip is written with comparisons and passes on a NaN of v, l or u, as
//    jnp.clip and torch.minimum(torch.maximum()) do; fminf/fmaxf would swallow
//    it. Lanes never mix, so a poisoned lane poisons nothing else.
//  * The last tile is masked: lanes past B are loaded as zeros (s = 1) and
//    never stored, so any B >= 1 is taken.
//
// The shape (m, n) is a compile-time constant (-DADMM_M=.. -DADMM_N=..):
// ops/cuda/_build.py compiles one library per shape at first use. n must be a
// multiple of 4 and the tile must fit in 227 KB of shared memory.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (no -use_fast_math).

#include <cuda_runtime.h>

#ifndef ADMM_M
#error "compile with -DADMM_M=<rows of G2>"
#endif
#ifndef ADMM_N
#error "compile with -DADMM_N=<columns of G2>"
#endif

namespace {

constexpr int M = ADMM_M;
constexpr int N = ADMM_N;
constexpr int L = 32;             // lanes per block
constexpr int THREADS = 512;      // two halves of 32 row groups x 8 lane groups
constexpr int NP = N + 4;         // padded row stride of the operator
constexpr int MJ = (M + 31) / 32;     // m-rows of a row group: rg + 32 j
constexpr int MJ0 = (MJ + 1) / 2;     // half 0 owns j < MJ0, half 1 the rest
constexpr int NJ = (N + 127) / 128;   // n-row quads of a row group: 4 rg + 128 j
constexpr bool M_FULL = (M % 32 == 0);
constexpr bool N_FULL = (N % 128 == 0);
constexpr int KM = M / 2;             // G2^T w: half 0 sums over m in [0, KM), half 1 the rest
constexpr int KN = N / 8 * 4;         // G2 tau: half 0 over n in [0, KN), half 1 the rest
constexpr int PR = M > N ? M : N;     // rows of the partial sums
constexpr int SMEM_FLOATS = M * NP + 3 * M * L + N * L + PR * L;
constexpr size_t SMEM_BYTES = sizeof(float) * (size_t)SMEM_FLOATS;

static_assert(N % 4 == 0, "n must be a multiple of 4");
static_assert(M >= 1 && N >= 4, "empty operator");
static_assert(SMEM_BYTES <= 232448, "tile does not fit in shared memory");

// Every thread of the block: a named barrier, so that the two halves may
// reach it from their own code.
__device__ __forceinline__ void block_barrier() {
    asm volatile("bar.sync 1, %0;\n" :: "n"(THREADS) : "memory");
}

// min(max(v, l), u) in which a NaN in any operand gives NaN.
__device__ __forceinline__ float clip_nan(float v, float l, float u) {
    float z = (v < l) ? l : v;
    z = (z > u) ? u : z;
    return (l != l || u != u) ? (l + u) : z;
}

// Copy a tile of a lane-major (B, R) array into shared memory as [R][L].
// The tile is one contiguous run of nl*R floats in device memory.
template <int R>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          long long lane0, int nl, float fill) {
    const float* base = src + lane0 * R;
    for (int e = threadIdx.x; e < L * R; e += THREADS) {
        int ll = e / R, r = e - ll * R;
        dst[r * L + ll] = (ll < nl) ? base[e] : fill;
    }
}

template <int R>
__device__ __forceinline__ void store_tile(float* __restrict__ dst, const float* src,
                                           long long lane0, int nl) {
    float* base = dst + lane0 * R;
    for (int e = threadIdx.x; e < nl * R; e += THREADS) {
        int ll = e / R, r = e - ll * R;
        base[e] = src[r * L + ll];
    }
}

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float (&x)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

// The stage as half H of the block sees it, from the staged tile to v's
// rows written back to sW. Half H owns m-rows rg + 32 j for j in [J0, J0 +
// JH) and the n-rows 4 rg + 128 j + 2 H + i2 (i2 < 2) of t.
template <int H>
__device__ __forceinline__ void half_stage(float* smem, const float* __restrict__ s_in,
                                           const float* __restrict__ d_in,
                                           const float* __restrict__ rho_in, long long lane0,
                                           int nl, int iters, float alpha) {
    constexpr int J0 = H ? MJ0 : 0;
    constexpr int JH = H ? MJ - MJ0 : MJ0;
    constexpr int JA = JH > 0 ? JH : 1;          // array extent
    constexpr int KB1 = H ? KM : 0, KE1 = H ? M : KM;
    constexpr int KB2 = H ? KN : 0, KE2 = H ? N : KN;
    float* sG = smem;                 // [M][NP] operator
    float* sL = sG + M * NP;          // [M][L]  lower bounds
    float* sU = sL + M * L;           // [M][L]  upper bounds
    float* sW = sU + M * L;           // [M][L]  w (and staging of v)
    float* sT = sW + M * L;           // [N][L]  tau (and staging of gq)
    float* sP = sT + N * L;           // [PR][L] partial sums handed to the other half

    const int tid = threadIdx.x & 255;
    const int lg = tid & 7;           // lane group: lanes 4 lg .. 4 lg + 3
    const int rg = tid >> 3;          // row group 0..31
    const int c0 = 4 * lg;

    // per-thread state: v and z of this half's m-rows, the gains of its n-rows
    float v[JA][4], z[JA][4], rho[JA];
#pragma unroll
    for (int jj = 0; jj < JA; ++jj) {
        const int mi = rg + 32 * (J0 + jj);
        if (jj < JH && (M_FULL || mi < M)) {
            const float4 x = ld4(sW + mi * L + c0);
            v[jj][0] = x.x; v[jj][1] = x.y; v[jj][2] = x.z; v[jj][3] = x.w;
            rho[jj] = rho_in[mi];
        } else {
            v[jj][0] = v[jj][1] = v[jj][2] = v[jj][3] = 0.0f;
            rho[jj] = 0.0f;
        }
        z[jj][0] = z[jj][1] = z[jj][2] = z[jj][3] = 0.0f;
    }
    float s[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
        s[c] = (c0 + c < nl) ? s_in[lane0 + c0 + c] : 1.0f;
    float gqs[NJ][2][4], sdinv[NJ][2][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2) {
            const int ni = 4 * rg + 128 * j + 2 * H + i2;
            const bool ok = N_FULL || ni < N;
            const float dn = ok ? d_in[ni] : 0.0f;
            float4 g = ok ? ld4(sT + ni * L + c0) : make_float4(0.f, 0.f, 0.f, 0.f);
            const float gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                gqs[j][i2][c] = gv[c] / s[c];
                sdinv[j][i2][c] = s[c] / (1.0f + s[c] * dn);
            }
        }
    }
    block_barrier();   // staging reads done before sW / sT are overwritten

    for (int it = 0; it < iters; ++it) {
        // z = clip(v, l, u); w = rho (2 z - v), this half's m-rows
#pragma unroll
        for (int jj = 0; jj < JH; ++jj) {
            const int mi = rg + 32 * (J0 + jj);
            if (M_FULL || mi < M) {
                const float4 lo = ld4(sL + mi * L + c0);
                const float4 hi = ld4(sU + mi * L + c0);
                z[jj][0] = clip_nan(v[jj][0], lo.x, hi.x);
                z[jj][1] = clip_nan(v[jj][1], lo.y, hi.y);
                z[jj][2] = clip_nan(v[jj][2], lo.z, hi.z);
                z[jj][3] = clip_nan(v[jj][3], lo.w, hi.w);
                float w[4];
#pragma unroll
                for (int c = 0; c < 4; ++c) w[c] = rho[jj] * (2.0f * z[jj][c] - v[jj][c]);
                st4(sW + mi * L + c0, w);
            }
        }
        block_barrier();

        // t = G2^T w : rows 4 rg + 128 j + i, this half's share of m
        {
            float acc[NJ][4][4];
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int c = 0; c < 4; ++c) acc[j][i][c] = 0.0f;
#pragma unroll 4
            for (int k = KB1; k < KE1; ++k) {
                const float4 w = ld4(sW + k * L + c0);
#pragma unroll
                for (int j = 0; j < NJ; ++j) {
                    const int nb = 4 * rg + 128 * j;
                    if (N_FULL || nb < N) {
                        const float4 g = ld4(sG + k * NP + nb);
                        const float gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
                        for (int i = 0; i < 4; ++i) {
                            acc[j][i][0] = fmaf(gv[i], w.x, acc[j][i][0]);
                            acc[j][i][1] = fmaf(gv[i], w.y, acc[j][i][1]);
                            acc[j][i][2] = fmaf(gv[i], w.z, acc[j][i][2]);
                            acc[j][i][3] = fmaf(gv[i], w.w, acc[j][i][3]);
                        }
                    }
                }
            }
            // the other half's two rows of each quad go to it through sP
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const int nb = 4 * rg + 128 * j;
                if (N_FULL || nb < N) {
#pragma unroll
                    for (int i2 = 0; i2 < 2; ++i2)
                        st4(sP + (nb + 2 * (1 - H) + i2) * L + c0, acc[j][2 * (1 - H) + i2]);
                }
            }
            block_barrier();
            // tau = (t - gq/s) * s/(1 + s d), this half's rows of each quad
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const int nb = 4 * rg + 128 * j;
                if (N_FULL || nb < N) {
#pragma unroll
                    for (int i2 = 0; i2 < 2; ++i2) {
                        const int ni = nb + 2 * H + i2;
                        const float4 o = ld4(sP + ni * L + c0);
                        const float ov[4] = {o.x, o.y, o.z, o.w};
                        float t[4];
#pragma unroll
                        for (int c = 0; c < 4; ++c)
                            t[c] = (acc[j][2 * H + i2][c] + ov[c] - gqs[j][i2][c]) *
                                   sdinv[j][i2][c];
                        st4(sT + ni * L + c0, t);
                    }
                }
            }
        }
        block_barrier();

        // v += alpha (G2 tau - z) : rows rg + 32 j, this half's share of n
        {
            float acc[MJ][4];
#pragma unroll
            for (int j = 0; j < MJ; ++j)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[j][c] = 0.0f;
#pragma unroll 4
            for (int k0 = KB2; k0 < KE2; k0 += 4) {
                const float4 t0 = ld4(sT + (k0 + 0) * L + c0);
                const float4 t1 = ld4(sT + (k0 + 1) * L + c0);
                const float4 t2 = ld4(sT + (k0 + 2) * L + c0);
                const float4 t3 = ld4(sT + (k0 + 3) * L + c0);
#pragma unroll
                for (int j = 0; j < MJ; ++j) {
                    const int mi = rg + 32 * j;
                    if (M_FULL || mi < M) {
                        const float4 g = ld4(sG + mi * NP + k0);
                        acc[j][0] = fmaf(g.x, t0.x, acc[j][0]);
                        acc[j][1] = fmaf(g.x, t0.y, acc[j][1]);
                        acc[j][2] = fmaf(g.x, t0.z, acc[j][2]);
                        acc[j][3] = fmaf(g.x, t0.w, acc[j][3]);
                        acc[j][0] = fmaf(g.y, t1.x, acc[j][0]);
                        acc[j][1] = fmaf(g.y, t1.y, acc[j][1]);
                        acc[j][2] = fmaf(g.y, t1.z, acc[j][2]);
                        acc[j][3] = fmaf(g.y, t1.w, acc[j][3]);
                        acc[j][0] = fmaf(g.z, t2.x, acc[j][0]);
                        acc[j][1] = fmaf(g.z, t2.y, acc[j][1]);
                        acc[j][2] = fmaf(g.z, t2.z, acc[j][2]);
                        acc[j][3] = fmaf(g.z, t2.w, acc[j][3]);
                        acc[j][0] = fmaf(g.w, t3.x, acc[j][0]);
                        acc[j][1] = fmaf(g.w, t3.y, acc[j][1]);
                        acc[j][2] = fmaf(g.w, t3.z, acc[j][2]);
                        acc[j][3] = fmaf(g.w, t3.w, acc[j][3]);
                    }
                }
            }
            // the other half's m-rows go to it through sP
#pragma unroll
            for (int j = 0; j < MJ; ++j) {
                const int mi = rg + 32 * j;
                if ((j >= J0 && j < J0 + JH) || !(M_FULL || mi < M)) continue;
                st4(sP + mi * L + c0, acc[j]);
            }
            block_barrier();
#pragma unroll
            for (int jj = 0; jj < JH; ++jj) {
                const int mi = rg + 32 * (J0 + jj);
                if (M_FULL || mi < M) {
                    const float4 o = ld4(sP + mi * L + c0);
                    const float ov[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
                    for (int c = 0; c < 4; ++c)
                        v[jj][c] += alpha * (acc[J0 + jj][c] + ov[c] - z[jj][c]);
                }
            }
        }
        // No barrier here: the next w is written over what this iteration's
        // G2^T w read before its exchange barrier; the next partials go to sP
        // after the next iteration's first barrier, which every thread
        // reaches only after it has read its partials here.
    }

    // v -> sW; tau is already in sT
#pragma unroll
    for (int jj = 0; jj < JH; ++jj) {
        const int mi = rg + 32 * (J0 + jj);
        if (M_FULL || mi < M) st4(sW + mi * L + c0, v[jj]);
    }
}

__global__ void __launch_bounds__(THREADS, 1)
admm_stage_kernel(const float* __restrict__ v_in, const float* __restrict__ s_in,
                  const float* __restrict__ gq_in, const float* __restrict__ l_in,
                  const float* __restrict__ u_in, const float* __restrict__ G2,
                  const float* __restrict__ d_in, const float* __restrict__ rho_in,
                  float* __restrict__ v_out, float* __restrict__ tau_out,
                  long long B, int iters, float alpha) {
    extern __shared__ __align__(16) float smem[];
    float* sG = smem;                 // [M][NP] operator
    float* sL = sG + M * NP;          // [M][L]  lower bounds
    float* sU = sL + M * L;           // [M][L]  upper bounds
    float* sW = sU + M * L;           // [M][L]  w (and staging of v)
    float* sT = sW + M * L;           // [N][L]  tau (and staging of gq)
    const long long lane0 = (long long)blockIdx.x * L;
    const int nl = (int)((B - lane0 < L) ? (B - lane0) : L);

    // operator -> shared memory, 16 bytes at a time
    for (int e = threadIdx.x; e < M * (N / 4); e += THREADS) {
        int r = e / (N / 4), c = e - r * (N / 4);
        *reinterpret_cast<float4*>(sG + r * NP + 4 * c) = ld4(G2 + (size_t)r * N + 4 * c);
    }
    load_tile<M>(sL, l_in, lane0, nl, 0.0f);
    load_tile<M>(sU, u_in, lane0, nl, 0.0f);
    load_tile<M>(sW, v_in, lane0, nl, 0.0f);
    load_tile<N>(sT, gq_in, lane0, nl, 0.0f);
    __syncthreads();

    if (threadIdx.x < 256)            // warp-uniform: the halves are warps 0-7 and 8-15
        half_stage<0>(smem, s_in, d_in, rho_in, lane0, nl, iters, alpha);
    else
        half_stage<1>(smem, s_in, d_in, rho_in, lane0, nl, iters, alpha);
    block_barrier();
    store_tile<M>(v_out, sW, lane0, nl);
    store_tile<N>(tau_out, sT, lane0, nl);
}

}  // namespace

extern "C" {

int blf_admm_stage_smem_bytes() { return (int)SMEM_BYTES; }

const char* blf_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Launch one stage on `stream`. All pointers are device pointers to contiguous
// f32 arrays: v, l, u (B, m); gq (B, n); s (B,); G2 (m, n), 16-byte aligned;
// d (n,); rho (m,); outputs v_out (B, m), tau_out (B, n). Returns the CUDA error
// code of the launch (0 on success), or -1 for a shape other than the one
// compiled, -2 for a bad batch or iteration count. Does not synchronise.
int blf_admm_stage_f32(const float* v, const float* s, const float* gq,
                       const float* l, const float* u, const float* G2,
                       const float* d, const float* rho, float* v_out,
                       float* tau_out, long long B, int m, int n, int iters,
                       float alpha, void* stream) {
    if (m != M || n != N) return -1;
    if (B < 1 || iters < 1) return -2;
    cudaError_t err = cudaFuncSetAttribute(
        admm_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (B + L - 1) / L;
    if (blocks > 2147483647LL) return -2;
    admm_stage_kernel<<<(unsigned)blocks, THREADS, SMEM_BYTES,
                        (cudaStream_t)stream>>>(
        v, s, gq, l, u, G2, d, rho, v_out, tau_out, B, iters, alpha);
    return (int)cudaGetLastError();
}

}  // extern "C"
