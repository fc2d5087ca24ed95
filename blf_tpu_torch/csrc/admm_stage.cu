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
// Design (which of the two layouts of the operator was taken, and why):
//  * The operator is resident in shared memory, ONE copy for both products
//    (rho is applied as an m-vector, so no second, rho-scaled transposed copy
//    is needed). Streaming it from L2 instead would cost 96 KB of L2 reads
//    per iteration per block, about as many bytes as the FMAs consume
//    operands, so the resident copy was taken. Rows are padded by 4 floats:
//    the second product walks G2 down its rows with 16-byte loads, and the
//    pad puts the rows a warp touches together on different banks.
//  * A block owns a tile of 32 lanes and has 256 threads = 32 row groups x 8
//    lane groups of 4 lanes. Every thread keeps a register micro-tile: 4 n-rows
//    x 4 lanes in the first product, ceil(m/32) m-rows x 4 lanes in the second;
//    each shared-memory operand is a 16-byte load that feeds 4 or 16 FMAs.
//  * v lives in registers for the whole stage (the thread that produces a
//    patch of G2 tau owns the same patch of v); l and u sit in shared memory;
//    w and tau pass through shared memory between the products, two
//    __syncthreads() an iteration.
//  * s/(1+s d) and gq/s are formed once per stage, in IEEE division.
//  * clip is written with comparisons and passes on a NaN of v, l or u, as
//    jnp.clip and torch.minimum(torch.maximum()) do; fminf/fmaxf would swallow
//    it. Lanes never mix, so a poisoned lane poisons nothing else.
//  * The last tile is masked: lanes past B are loaded as zeros (s = 1) and
//    never stored, so any B >= 1 is taken.
//  * At (192, 128) the tile needs 187 KB of shared memory, so one block runs
//    on an SM at a time (8 warps); 98304 lanes are 3072 blocks, 23.3 waves
//    over 132 SMs. Enough for a first kernel; a tensor-core form (wgmma on
//    3xTF32 or bf16 splits), TMA loads and persistent blocks are later work.
//
// The shape (m, n) is a compile-time constant (-DADMM_M=.. -DADMM_N=..):
// ops/cuda/_build.py compiles one library per shape at first use. n must be a multiple
// of 4 and the tile must fit in 227 KB of shared memory.
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
constexpr int THREADS = 256;      // 32 row groups x 8 lane groups
constexpr int NP = N + 4;         // padded row stride of the operator
constexpr int MJ = (M + 31) / 32;     // m-rows per thread: rg + 32 j
constexpr int NJ = (N + 127) / 128;   // n-row quads per thread: 4 rg + 128 j
constexpr bool M_FULL = (M % 32 == 0);
constexpr bool N_FULL = (N % 128 == 0);
constexpr int SMEM_FLOATS = M * NP + 3 * M * L + N * L;
constexpr size_t SMEM_BYTES = sizeof(float) * (size_t)SMEM_FLOATS;

static_assert(N % 4 == 0, "n must be a multiple of 4");
static_assert(M >= 1 && N >= 4, "empty operator");
static_assert(SMEM_BYTES <= 232448, "tile does not fit in shared memory");

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

    const int tid = threadIdx.x;
    const int lg = tid & 7;           // lane group: lanes 4 lg .. 4 lg + 3
    const int rg = tid >> 3;          // row group 0..31
    const int c0 = 4 * lg;
    const long long lane0 = (long long)blockIdx.x * L;
    const int nl = (int)((B - lane0 < L) ? (B - lane0) : L);

    // operator -> shared memory, 16 bytes at a time
    for (int e = tid; e < M * (N / 4); e += THREADS) {
        int r = e / (N / 4), c = e - r * (N / 4);
        *reinterpret_cast<float4*>(sG + r * NP + 4 * c) =
            ld4(G2 + (size_t)r * N + 4 * c);
    }
    load_tile<M>(sL, l_in, lane0, nl, 0.0f);
    load_tile<M>(sU, u_in, lane0, nl, 0.0f);
    load_tile<M>(sW, v_in, lane0, nl, 0.0f);
    load_tile<N>(sT, gq_in, lane0, nl, 0.0f);
    __syncthreads();

    // per-thread state
    float v[MJ][4], rho[MJ];
#pragma unroll
    for (int j = 0; j < MJ; ++j) {
        const int mi = rg + 32 * j;
        if (M_FULL || mi < M) {
            float4 x = ld4(sW + mi * L + c0);
            v[j][0] = x.x; v[j][1] = x.y; v[j][2] = x.z; v[j][3] = x.w;
            rho[j] = rho_in[mi];
        } else {
            v[j][0] = v[j][1] = v[j][2] = v[j][3] = 0.0f;
            rho[j] = 0.0f;
        }
    }
    float s[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
        s[c] = (c0 + c < nl) ? s_in[lane0 + c0 + c] : 1.0f;
    float gqs[NJ][4][4], sdinv[NJ][4][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int ni = 4 * rg + 128 * j + i;
            const bool ok = N_FULL || ni < N;
            const float dn = ok ? d_in[ni] : 0.0f;
            float4 g = ok ? ld4(sT + ni * L + c0) : make_float4(0.f, 0.f, 0.f, 0.f);
            const float gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                gqs[j][i][c] = gv[c] / s[c];
                sdinv[j][i][c] = s[c] / (1.0f + s[c] * dn);
            }
        }
    }
    __syncthreads();   // staging reads done before sW / sT are overwritten

    float z[MJ][4];
    for (int it = 0; it < iters; ++it) {
        // z = clip(v, l, u); w = rho (2 z - v)
#pragma unroll
        for (int j = 0; j < MJ; ++j) {
            const int mi = rg + 32 * j;
            if (M_FULL || mi < M) {
                float4 lo = ld4(sL + mi * L + c0);
                float4 hi = ld4(sU + mi * L + c0);
                z[j][0] = clip_nan(v[j][0], lo.x, hi.x);
                z[j][1] = clip_nan(v[j][1], lo.y, hi.y);
                z[j][2] = clip_nan(v[j][2], lo.z, hi.z);
                z[j][3] = clip_nan(v[j][3], lo.w, hi.w);
                float4 w;
                w.x = rho[j] * (2.0f * z[j][0] - v[j][0]);
                w.y = rho[j] * (2.0f * z[j][1] - v[j][1]);
                w.z = rho[j] * (2.0f * z[j][2] - v[j][2]);
                w.w = rho[j] * (2.0f * z[j][3] - v[j][3]);
                *reinterpret_cast<float4*>(sW + mi * L + c0) = w;
            }
        }
        __syncthreads();

        // t = G2^T w : rows ni = 4 rg + 128 j + i, contraction over m
        {
            float acc[NJ][4][4];
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int c = 0; c < 4; ++c) acc[j][i][c] = 0.0f;
#pragma unroll 4
            for (int k = 0; k < M; ++k) {
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
            // tau = (t - gq/s) * s/(1 + s d)
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const int nb = 4 * rg + 128 * j;
                if (N_FULL || nb < N) {
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        float4 t;
                        t.x = (acc[j][i][0] - gqs[j][i][0]) * sdinv[j][i][0];
                        t.y = (acc[j][i][1] - gqs[j][i][1]) * sdinv[j][i][1];
                        t.z = (acc[j][i][2] - gqs[j][i][2]) * sdinv[j][i][2];
                        t.w = (acc[j][i][3] - gqs[j][i][3]) * sdinv[j][i][3];
                        *reinterpret_cast<float4*>(sT + (nb + i) * L + c0) = t;
                    }
                }
            }
        }
        __syncthreads();

        // v += alpha (G2 tau - z) : rows mi = rg + 32 j, contraction over n
        {
            float acc[MJ][4];
#pragma unroll
            for (int j = 0; j < MJ; ++j)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[j][c] = 0.0f;
#pragma unroll 2
            for (int k0 = 0; k0 < N; k0 += 4) {
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
#pragma unroll
            for (int j = 0; j < MJ; ++j) {
                if (M_FULL || rg + 32 * j < M) {
#pragma unroll
                    for (int c = 0; c < 4; ++c)
                        v[j][c] += alpha * (acc[j][c] - z[j][c]);
                }
            }
        }
        // No barrier here: the next write to sW follows every thread's reads of
        // it (they precede the barrier above), and the next write to sT follows
        // the barrier after the next w step, which every thread reaches only
        // after its reads of sT in this product.
    }

    // v -> sW -> device memory; tau is already in sT
    __syncthreads();
#pragma unroll
    for (int j = 0; j < MJ; ++j) {
        const int mi = rg + 32 * j;
        if (M_FULL || mi < M)
            *reinterpret_cast<float4*>(sW + mi * L + c0) =
                make_float4(v[j][0], v[j][1], v[j][2], v[j][3]);
    }
    __syncthreads();
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
