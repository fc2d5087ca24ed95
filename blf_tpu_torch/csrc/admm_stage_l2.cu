// Fused shared-operator v-space ADMM stage for NVIDIA Hopper (sm_90a), f32,
// for operators that do not fit in shared memory: the operator streams
// through it from L2.
//
// Replaces the TPU kernel blf_tpu/ops/pallas/admm.py::_stage_kernel_t (entry
// admm_stage_t / admm_stage, matmul="f32") at the shapes where the resident
// kernel, csrc/admm_stage.cu, cannot hold G2 and a 32-lane tile in one
// block's 227 KB (past m (n + 4) 4 B + a tile's state; the config-3 gait's
// (960, 384) G2 alone is 1.47 MB). It computes what that kernel computes:
// `iters` iterations, at a fixed per-lane penalty multiplier s, of
//
//     z  = clip(v, l, u)
//     w  = rho * (2 z - v)
//     t  = G2^T w                       (n outputs, contraction over m)
//     tau = (t - gq / s) * s / (1 + s d)
//     v += alpha (G2 tau - z)           (m outputs, contraction over n)
//
// for every lane of a fleet that shares one operator G2 (m, n), both
// products in this kernel's body, returning (v, tau).
//
// What bounds it on an H100: operations, if each block serves enough lanes.
// A lane-iteration is 4 m n flops (1.47 Mflop at (960, 384)); 25 iterations
// of 4096 lanes take 2.25 ms at the f32 peak of 67 TFLOP/s. The operator
// (1.47 MB at (960, 384)) fits in the 50 MB L2, so each block re-reads it
// from L2 every iteration: with L lanes a block, B / L reads of m n 4 B an
// iteration. At L = 32 and one read an iteration (below) that is 188 MB an
// iteration for 4096 lanes, 4.7 GB a stage of 25: under 1 ms at the L2's
// several TB/s, below the FMA bound; at L = 16, or with two reads an
// iteration, it would not be. Each lane's own state (v, l, u over m) is 11.5
// KB, 369 KB for a 32-lane tile: it cannot live in shared memory beside the
// operator's panels, so v lives in device memory (v_out, read and written by
// its owner thread once an iteration), l and u are read from there too.
//
// Design (each choice with its reason):
//  * One block of 512 threads (16 warps, one block an SM) works on a tile of
//    32 lanes through the whole stage.
//  * ONE pass over the operator an iteration, in chunks of MC = 32 rows. The
//    rows of chunk c feed both products: G2[c] tau_prev gives v's rows of c
//    (the previous iteration's second product), from which w's rows of c
//    follow, and G2[c]^T w[c] adds chunk c's share to t (this iteration's
//    first product). So w never needs to be whole in shared memory (123 KB
//    at 32 lanes), only tau (n x 32) and the chunk's w; a stage is iters + 1
//    passes (the first has no second product, the last no first product).
//  * The chunks stream through two buffers with cp.async: the next chunk's
//    copy is in flight while this one is used. Rows past m are zeros.
//  * G2[c] tau: 4 x 4 register micro-tiles (rows r + 8 i, 4 lanes), the
//    contraction over n split 8 ways across the block and the 8 partial
//    sums added in a fixed order by the element's owner, who then updates
//    v, forms z and w, and writes w to shared memory.
//  * G2[c]^T w[c]: each thread accumulates 4 x 4 tiles of t (4 columns of
//    G2 x 4 lanes) over every row of every chunk, in registers; at the end of
//    a pass it forms tau (IEEE divisions, as the plain version) into shared
//    memory. At n = 384 there are 768 such tiles for 512 threads, so a
//    quarter of this product's slots idle.
//  * Strides padded so that a warp's shared-memory accesses fall on distinct
//    banks: chunk rows by n + 4, the partial sums by 34, w's rows by 36.
//  * clip is written with comparisons and passes on a NaN of v, l or u, as
//    jnp.clip does. Lanes never mix, so a poisoned lane poisons nothing else.
//  * The last tile is masked: lanes past B compute on zeros and are never
//    stored, so any B >= 1 is taken.
//
// The shape (m, n) is a compile-time constant (-DADMM_M=.. -DADMM_N=..):
// ops/cuda/_build.py compiles one library per shape at first use. n must be a
// multiple of 4 and the buffers must fit in 227 KB of shared memory (n up to
// about 500, any m).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (no -use_fast_math).

#include <cuda_pipeline.h>
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
constexpr int L = 32;              // lanes per block
constexpr int THREADS = 512;
constexpr int MC = 32;             // operator rows per chunk
constexpr int NCH = (M + MC - 1) / MC;    // chunks per pass
constexpr int NP = N + 4;          // padded row stride of a chunk
constexpr int LW = L + 4;          // padded row stride of the chunk's w
constexpr int MCP = MC + 2;        // padded stride of the partial sums
constexpr int TILES2 = (MC / 4) * (L / 4);     // 4 x 4 tiles of G2[c] tau
constexpr int KS = THREADS / TILES2;           // ways the contraction over n is split
constexpr int KSL = 4 * ((N / 4 + KS - 1) / KS);   // columns of a split, a multiple of 4
constexpr int TILES1 = (N / 4) * (L / 4);      // 4 x 4 tiles of t
constexpr int TQ = (TILES1 + THREADS - 1) / THREADS;   // tiles of t a thread
constexpr int EW = MC * L / THREADS;           // chunk elements a thread updates
constexpr int SMEM_FLOATS = 2 * MC * NP + N * L + MC * LW + KS * L * MCP;
constexpr size_t SMEM_BYTES = sizeof(float) * (size_t)SMEM_FLOATS;

static_assert(N % 4 == 0, "n must be a multiple of 4");
static_assert(M >= 1 && N >= 4, "empty operator");
static_assert(THREADS % TILES2 == 0 && (MC * L) % THREADS == 0, "tile plan");
static_assert(SMEM_BYTES <= 232448, "buffers do not fit in shared memory");

// min(max(v, l), u) in which a NaN in any operand gives NaN.
__device__ __forceinline__ float clip_nan(float v, float l, float u) {
    float z = (v < l) ? l : v;
    z = (z > u) ? u : z;
    return (l != l || u != u) ? (l + u) : z;
}

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

// Start copying chunk `c` of the operator into `dst` ([MC][NP]), 16 bytes a
// thread at a time; rows past m are zeroed.
__device__ __forceinline__ void issue_chunk(float* dst, const float* __restrict__ G2, int c) {
    for (int e = threadIdx.x; e < MC * (N / 4); e += THREADS) {
        const int r = e / (N / 4), q = e - r * (N / 4);
        const int row = c * MC + r;
        float* d = dst + r * NP + 4 * q;
        if (row < M)
            __pipeline_memcpy_async(d, G2 + (size_t)row * N + 4 * q, 16);
        else
            *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __pipeline_commit();
}

__global__ void __launch_bounds__(THREADS, 1)
admm_stage_l2_kernel(const float* __restrict__ v_in, const float* __restrict__ s_in,
                     const float* __restrict__ gq_in, const float* __restrict__ l_in,
                     const float* __restrict__ u_in, const float* __restrict__ G2,
                     const float* __restrict__ d_in, const float* __restrict__ rho_in,
                     float* __restrict__ v_out, float* __restrict__ tau_out,
                     long long B, int iters, float alpha) {
    extern __shared__ __align__(16) float smem[];
    float* sG = smem;                  // [2][MC][NP] operator chunks
    float* sTau = sG + 2 * MC * NP;    // [N][L]      tau of the last finished iteration
    float* sW = sTau + N * L;          // [MC][LW]    w of the chunk
    float* sP = sW + MC * LW;          // [KS][L][MCP] partial sums of G2[c] tau

    const int tid = threadIdx.x;
    const long long lane0 = (long long)blockIdx.x * L;
    const int nl = (int)((B - lane0 < L) ? (B - lane0) : L);

    // G2[c] tau: rows rt + 8 i (i < 4) of the chunk, lanes 4 lt + c, columns
    // [k0, k1) of the contraction
    const int tile2 = tid % TILES2, ks = tid / TILES2;
    const int rt = tile2 % (MC / 4), lt = tile2 / (MC / 4);
    const int k0 = ks * KSL, k1 = (k0 + KSL < N) ? k0 + KSL : N;

    float t[TQ][4][4];
#pragma unroll
    for (int q = 0; q < TQ; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) t[q][i][c] = 0.0f;

    const int steps = (iters + 1) * NCH;
    issue_chunk(sG, G2, 0);
    for (int g = 0; g < steps; ++g) {
        const int pass = g / NCH, ch = g - pass * NCH;
        const float* cG = sG + (g & 1) * MC * NP;
        __pipeline_wait_prior(0);
        __syncthreads();   // chunk g has landed; every thread is done with chunk g - 1
        if (g + 1 < steps) issue_chunk(sG + ((g + 1) & 1) * MC * NP, G2, (g + 1) % NCH);

        if (pass > 0) {
            // partial sums of G2[c] tau over this thread's columns
            float acc[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
#pragma unroll 2
            for (int k = k0; k < k1; k += 4) {
                const float4 t0 = ld4(sTau + (k + 0) * L + 4 * lt);
                const float4 t1 = ld4(sTau + (k + 1) * L + 4 * lt);
                const float4 t2 = ld4(sTau + (k + 2) * L + 4 * lt);
                const float4 t3 = ld4(sTau + (k + 3) * L + 4 * lt);
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float4 gr = ld4(cG + (rt + 8 * i) * NP + k);
                    acc[i][0] = fmaf(gr.x, t0.x, acc[i][0]);
                    acc[i][1] = fmaf(gr.x, t0.y, acc[i][1]);
                    acc[i][2] = fmaf(gr.x, t0.z, acc[i][2]);
                    acc[i][3] = fmaf(gr.x, t0.w, acc[i][3]);
                    acc[i][0] = fmaf(gr.y, t1.x, acc[i][0]);
                    acc[i][1] = fmaf(gr.y, t1.y, acc[i][1]);
                    acc[i][2] = fmaf(gr.y, t1.z, acc[i][2]);
                    acc[i][3] = fmaf(gr.y, t1.w, acc[i][3]);
                    acc[i][0] = fmaf(gr.z, t2.x, acc[i][0]);
                    acc[i][1] = fmaf(gr.z, t2.y, acc[i][1]);
                    acc[i][2] = fmaf(gr.z, t2.z, acc[i][2]);
                    acc[i][3] = fmaf(gr.z, t2.w, acc[i][3]);
                    acc[i][0] = fmaf(gr.w, t3.x, acc[i][0]);
                    acc[i][1] = fmaf(gr.w, t3.y, acc[i][1]);
                    acc[i][2] = fmaf(gr.w, t3.z, acc[i][2]);
                    acc[i][3] = fmaf(gr.w, t3.w, acc[i][3]);
                }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    sP[(ks * L + 4 * lt + c) * MCP + rt + 8 * i] = acc[i][c];
            __syncthreads();
        }

        // the chunk's elements, row fastest (coalesced in the lane-major
        // arrays): v += alpha (G2 tau - z); z = clip(v, l, u); w = rho (2 z - v)
#pragma unroll
        for (int q = 0; q < EW; ++q) {
            const int e = tid + THREADS * q;
            const int r = e % MC, j = e / MC;
            const int row = ch * MC + r;
            float w = 0.0f;
            if (row < M && j < nl) {
                const size_t at = (size_t)(lane0 + j) * M + row;
                const float lo = l_in[at], hi = u_in[at];
                float v = (pass <= 1) ? v_in[at] : v_out[at];
                if (pass > 0) {
                    float sum = sP[j * MCP + r];
#pragma unroll
                    for (int p = 1; p < KS; ++p) sum += sP[(p * L + j) * MCP + r];
                    v = v + alpha * (sum - clip_nan(v, lo, hi));
                    v_out[at] = v;
                }
                w = rho_in[row] * (2.0f * clip_nan(v, lo, hi) - v);
            }
            if (pass < iters) sW[r * LW + j] = w;
        }
        if (pass == iters) continue;
        __syncthreads();

        // t += G2[c]^T w[c]
#pragma unroll
        for (int q = 0; q < TQ; ++q) {
            const int it = tid + THREADS * q;
            if (it < TILES1) {
                const int nq = it / (L / 4), lq = it - nq * (L / 4);
#pragma unroll 4
                for (int r = 0; r < MC; ++r) {
                    const float4 w4 = ld4(sW + r * LW + 4 * lq);
                    const float4 g4 = ld4(cG + r * NP + 4 * nq);
                    const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        t[q][i][0] = fmaf(gv[i], w4.x, t[q][i][0]);
                        t[q][i][1] = fmaf(gv[i], w4.y, t[q][i][1]);
                        t[q][i][2] = fmaf(gv[i], w4.z, t[q][i][2]);
                        t[q][i][3] = fmaf(gv[i], w4.w, t[q][i][3]);
                    }
                }
            }
        }
        if (ch != NCH - 1) continue;

        // end of a pass: tau = (t - gq / s) * s / (1 + s d), into shared
        // memory (and out, after the last iteration); t starts again
#pragma unroll
        for (int q = 0; q < TQ; ++q) {
            const int it = tid + THREADS * q;
            if (it < TILES1) {
                const int nq = it / (L / 4), lq = it - nq * (L / 4);
                float tau[4][4];
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int j = 4 * lq + c;
                    const bool ok = j < nl;
                    const float s = ok ? s_in[lane0 + j] : 1.0f;
                    const float4 gq = ok ? ld4(gq_in + (size_t)(lane0 + j) * N + 4 * nq)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
                    const float gv[4] = {gq.x, gq.y, gq.z, gq.w};
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const float dn = d_in[4 * nq + i];
                        tau[i][c] = (t[q][i][c] - gv[i] / s) * (s / (1.0f + s * dn));
                    }
                    if (ok && pass == iters - 1)
                        *reinterpret_cast<float4*>(tau_out + (size_t)(lane0 + j) * N + 4 * nq) =
                            make_float4(tau[0][c], tau[1][c], tau[2][c], tau[3][c]);
                }
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    *reinterpret_cast<float4*>(sTau + (4 * nq + i) * L + 4 * lq) =
                        make_float4(tau[i][0], tau[i][1], tau[i][2], tau[i][3]);
#pragma unroll
                    for (int c = 0; c < 4; ++c) t[q][i][c] = 0.0f;
                }
            }
        }
    }
}

}  // namespace

extern "C" {

int blf_admm_stage_l2_smem_bytes() { return (int)SMEM_BYTES; }

const char* blf_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Launch one stage on `stream`. All pointers are device pointers to contiguous
// f32 arrays: v, l, u (B, m); gq (B, n), 16-byte aligned; s (B,); G2 (m, n),
// 16-byte aligned; d (n,); rho (m,); outputs v_out (B, m), tau_out (B, n),
// 16-byte aligned, v_out not aliasing v. Returns the CUDA error code of the
// launch (0 on success), or -1 for a shape other than the one compiled, -2 for
// a bad batch or iteration count. Does not synchronise.
int blf_admm_stage_l2(const float* v, const float* s, const float* gq,
                      const float* l, const float* u, const float* G2,
                      const float* d, const float* rho, float* v_out,
                      float* tau_out, long long B, int m, int n, int iters,
                      float alpha, void* stream) {
    if (m != M || n != N) return -1;
    if (B < 1 || iters < 1) return -2;
    cudaError_t err = cudaFuncSetAttribute(
        admm_stage_l2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (B + L - 1) / L;
    if (blocks > 2147483647LL) return -2;
    admm_stage_l2_kernel<<<(unsigned)blocks, THREADS, SMEM_BYTES,
                           (cudaStream_t)stream>>>(
        v, s, gq, l, u, G2, d, rho, v_out, tau_out, B, iters, alpha);
    return (int)cudaGetLastError();
}

}  // extern "C"
