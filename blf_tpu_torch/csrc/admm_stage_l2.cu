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
// What bound the previous design (4 x 4 tiles of t in two rounds; the gait's last
// iterations; NVIDIA H100 80GB HBM3, 700.00 W): 5.88-6.12 ms, some 38 % of
// the FMA bound, and 0.93 of that with half the lanes, so each SM's own work
// binds, not L2. Its second product cut to the 512 tiles one round gives
// (wrong on purpose) took 5.13 ms: the 768 tiles of 4 x 4 at n = 384 ran in
// two rounds on 512 threads, the second on half the warps. Without the
// partial sums' round trip through shared memory it took 5.86, without the
// two barriers that are not the copy's 5.81: neither binds. What is left is
// the shared-memory traffic a FMA costs: 4 x 4 tiles load 2 bytes a FMA.
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
//    copy is in flight while this one is used. Rows past m are zeros. (A
//    producer warp and an mbarrier ring, as csrc/admm_stage_tc_l2.cu has,
//    would save at most the 0.06 ms the barriers cost.)
//  * G2[c] tau: register tiles of R1 = 4 rows (rows rt + 8 i) x 4 lanes, the
//    contraction over n split KS = 8 ways across the block and the partial
//    sums added in a fixed order by the element's owner, who then updates v,
//    forms z and w, and writes w to shared memory. Tiles of 8 rows split 16
//    ways load a quarter fewer bytes a FMA but took longer (5.56 against 5.21
//    ms at (960, 384); 2.80 against 2.61 at (640, 256)): twice the partial
//    sums, and each split half as long.
//  * From n = 256 a chunk's state (v, l, u and rho of its rows) is loaded
//    into registers before G2[c] tau, the loads pinned there (asm volatile),
//    so that their latency runs under that product (8-10 % at (960, 384) and
//    (640, 256)); at (240, 160) the product is too short to cover them and
//    the early loads cost 2-5 %, so there it is loaded where it is used.
//  * G2[c]^T w[c]: each thread accumulates one tile of t, TC columns of G2 x
//    4 lanes, over every row of every chunk, in registers; TC = ceil(n / 64)
//    rounded up to an even number, at least 4, so that the tiles take one
//    round of the 512 threads and load 8 or 16 bytes at a time (at n = 384
//    exactly 512 tiles of 6 x 4, 1.67 bytes a FMA). At the end of a pass it forms tau
//    (IEEE divisions, as the plain version) into shared memory. Columns past
//    n of the last tile read the row's padding or the next row and are never
//    stored.
//  * Strides padded so that a warp's shared-memory accesses fall on distinct
//    banks: chunk rows by n + 4, the partial sums by 34, w's rows by 36.
//  * clip is written with comparisons and passes on a NaN of v, l or u, as
//    jnp.clip does. Lanes never mix, so a poisoned lane poisons nothing else.
//  * The last tile is masked: lanes past B compute on zeros and are never
//    stored, so any B >= 1 is taken.
//
// Measured (PERF.md section 6; NVIDIA H100 80GB HBM3, 700.00 W): at (960,
// 384), B 4096, 25 iterations, 5.29 ms, 43 % of the FMA bound (the previous design: 6.14
// ms, 37 %); in turns 5.24-5.34 against the previous design's 6.13-6.16, and 2.68-2.72
// against 2.96-2.98 at (640, 256); at (240, 160), where the tiles are PR
// 10's, 0.813-0.850 against 0.806-0.817: not faster. Half the lanes take the
// same time: each SM's shared-memory loads (2 bytes a FMA in G2[c] tau, 1.67
// in G2[c]^T w) still bind.
//
// The shape (m, n) is a compile-time constant (-DADMM_M=.. -DADMM_N=..), and
// so are the tiles it picks (ops/cuda/admm.py::l2_plan mirrors them, checked
// at load through blf_admm_stage_l2_plan): ops/cuda/_build.py compiles one
// library per shape at first use. n must be a multiple of 4 and the buffers
// must fit in 227 KB of shared memory (n up to about 500, any m).
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
constexpr int EW = MC * L / THREADS;           // chunk elements a thread updates
// G2[c] tau: tiles of R1 rows x 4 lanes, RG row groups, KS splits of n
constexpr int R1 = 4;
constexpr int RG = MC / R1;
constexpr int TILES2 = RG * (L / 4);
constexpr int KS = THREADS / TILES2;
constexpr int KSL = 4 * ((N / 4 + KS - 1) / KS);   // columns of a split, a multiple of 4
// G2[c]^T w[c]: tiles of TC columns x 4 lanes, NG column groups, one round;
// TC even, for 8-byte loads, and at least 4
constexpr int TC_MIN = ((N + 63) / 64 + 1) / 2 * 2;
constexpr int TC = TC_MIN < 4 ? 4 : TC_MIN;
constexpr int NG = (N + TC - 1) / TC;
constexpr int TILES1 = NG * (L / 4);
constexpr int SMEM_FLOATS = 2 * MC * NP + N * L + MC * LW + KS * L * MCP;
// a chunk's state loaded ahead of G2[c] tau where that product is long
// enough to cover the loads (each split 32 columns or more); where it is not,
// where the state is used
constexpr bool STATE_AHEAD = N >= 256;
constexpr size_t SMEM_BYTES = sizeof(float) * (size_t)SMEM_FLOATS;

static_assert(N % 4 == 0, "n must be a multiple of 4");
static_assert(M >= 1 && N >= 4, "empty operator");
static_assert(THREADS % TILES2 == 0 && (MC * L) % THREADS == 0, "tile plan");
static_assert(TILES1 <= THREADS, "one round of t's tiles");
static_assert(SMEM_BYTES <= 232448, "buffers do not fit in shared memory");

// min(max(v, l), u) in which a NaN in any operand gives NaN.
__device__ __forceinline__ float clip_nan(float v, float l, float u) {
    float z = (v < l) ? l : v;
    z = (z > u) ? u : z;
    return (l != l || u != u) ? (l + u) : z;
}

// A load of device memory made here, not where its value is first used:
// the compiler keeps it ahead of the shared-memory accesses that follow.
// Through the read-only path for the stage's inputs, not for v_out, which
// this kernel writes.
template <bool READ_ONLY>
__device__ __forceinline__ float ld_now(const float* p) {
    float x;
    if constexpr (READ_ONLY)
        asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(x) : "l"(p) : "memory");
    else
        asm volatile("ld.global.f32 %0, [%1];\n" : "=f"(x) : "l"(p) : "memory");
    return x;
}

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

// TC consecutive floats at p (TC even, p 8-byte aligned), 16 bytes at a time
// where TC is a multiple of 4, else 8.
__device__ __forceinline__ void ld_cols(const float* p, float (&g)[TC]) {
    static_assert(TC % 2 == 0, "even column tiles");
    if constexpr (TC % 4 == 0) {
#pragma unroll
        for (int i = 0; i < TC; i += 4) {
            const float4 x = ld4(p + i);
            g[i] = x.x; g[i + 1] = x.y; g[i + 2] = x.z; g[i + 3] = x.w;
        }
    } else {
#pragma unroll
        for (int i = 0; i < TC; i += 2) {
            const float2 x = *reinterpret_cast<const float2*>(p + i);
            g[i] = x.x; g[i + 1] = x.y;
        }
    }
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

    // G2[c] tau: rows rt + RG i (i < R1) of the chunk, lanes 4 lt + c,
    // columns [k0, k1) of the contraction
    const int tile2 = tid % TILES2, ks = tid / TILES2;
    const int rt = tile2 % RG, lt = tile2 / RG;
    const int k0 = ks * KSL, k1 = (k0 + KSL < N) ? k0 + KSL : N;
    // G2[c]^T w[c]: columns TC nq + i (i < TC) of G2, lanes 4 lq + c
    const int nq = tid / (L / 4), lq = tid % (L / 4);
    const bool has_t = tid < TILES1;

    float t[TC][4];
#pragma unroll
    for (int i = 0; i < TC; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) t[i][c] = 0.0f;

    const int steps = (iters + 1) * NCH;
    issue_chunk(sG, G2, 0);
    for (int g = 0; g < steps; ++g) {
        const int pass = g / NCH, ch = g - pass * NCH;
        const float* cG = sG + (g & 1) * MC * NP;
        __pipeline_wait_prior(0);
        __syncthreads();   // chunk g has landed; every thread is done with chunk g - 1
        if (g + 1 < steps) issue_chunk(sG + ((g + 1) & 1) * MC * NP, G2, (g + 1) % NCH);

        // the chunk's state (element e of the chunk: row e % MC, lane e / MC),
        // loaded now so that it lands while G2[c] tau runs
        float sv[EW], sl[EW], su[EW], srho[EW];
#pragma unroll
        for (int q = 0; q < EW && STATE_AHEAD; ++q) {
            const int e = tid + THREADS * q;
            const int r = e % MC, j = e / MC;
            const int row = ch * MC + r;
            const bool ok = row < M && j < nl;
            const size_t at = (size_t)(lane0 + j) * M + row;
            sl[q] = ok ? ld_now<true>(l_in + at) : 0.0f;
            su[q] = ok ? ld_now<true>(u_in + at) : 0.0f;
            sv[q] = ok ? (pass <= 1 ? ld_now<true>(v_in + at) : ld_now<false>(v_out + at)) : 0.0f;
            srho[q] = row < M ? ld_now<true>(rho_in + row) : 0.0f;
        }

        if (pass > 0) {
            // partial sums of G2[c] tau over this thread's columns
            float acc[R1][4];
#pragma unroll
            for (int i = 0; i < R1; ++i)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
#pragma unroll 2
            for (int k = k0; k < k1; k += 4) {
                const float4 t0 = ld4(sTau + (k + 0) * L + 4 * lt);
                const float4 t1 = ld4(sTau + (k + 1) * L + 4 * lt);
                const float4 t2 = ld4(sTau + (k + 2) * L + 4 * lt);
                const float4 t3 = ld4(sTau + (k + 3) * L + 4 * lt);
#pragma unroll
                for (int i = 0; i < R1; ++i) {
                    const float4 gr = ld4(cG + (rt + RG * i) * NP + k);
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
            for (int i = 0; i < R1; ++i)
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    sP[(ks * L + 4 * lt + c) * MCP + rt + RG * i] = acc[i][c];
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
                const float lo = STATE_AHEAD ? sl[q] : l_in[at];
                const float hi = STATE_AHEAD ? su[q] : u_in[at];
                float v = STATE_AHEAD ? sv[q] : ((pass <= 1) ? v_in[at] : v_out[at]);
                if (pass > 0) {
                    float sum = sP[j * MCP + r];
#pragma unroll
                    for (int p = 1; p < KS; ++p) sum += sP[(p * L + j) * MCP + r];
                    v = v + alpha * (sum - clip_nan(v, lo, hi));
                    v_out[at] = v;
                }
                w = (STATE_AHEAD ? srho[q] : rho_in[row]) * (2.0f * clip_nan(v, lo, hi) - v);
            }
            if (pass < iters) sW[r * LW + j] = w;
        }
        if (pass == iters) continue;
        __syncthreads();

        // t += G2[c]^T w[c]
        if (has_t) {
#pragma unroll 4
            for (int r = 0; r < MC; ++r) {
                const float4 w4 = ld4(sW + r * LW + 4 * lq);
                float gv[TC];
                ld_cols(cG + r * NP + TC * nq, gv);
#pragma unroll
                for (int i = 0; i < TC; ++i) {
                    t[i][0] = fmaf(gv[i], w4.x, t[i][0]);
                    t[i][1] = fmaf(gv[i], w4.y, t[i][1]);
                    t[i][2] = fmaf(gv[i], w4.z, t[i][2]);
                    t[i][3] = fmaf(gv[i], w4.w, t[i][3]);
                }
            }
        }
        if (ch != NCH - 1) continue;

        // end of a pass: tau = (t - gq / s) * s / (1 + s d), into shared
        // memory (and out, after the last iteration); t starts again. A
        // tile's columns are read and written TC at a time where all lie
        // within n.
        if (has_t) {
            const bool whole = TC * nq + TC <= N;
            float tau[TC][4];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int j = 4 * lq + c;
                const bool ok = j < nl;
                const float s = ok ? s_in[lane0 + j] : 1.0f;
                const size_t row = (size_t)(lane0 + j) * N + TC * nq;
                float gq[TC];
                if (ok && whole) {
                    ld_cols(gq_in + row, gq);
                } else {
#pragma unroll
                    for (int i = 0; i < TC; ++i)
                        gq[i] = (ok && TC * nq + i < N) ? gq_in[row + i] : 0.0f;
                }
#pragma unroll
                for (int i = 0; i < TC; ++i) {
                    const int col = TC * nq + i;
                    const float dn = col < N ? d_in[col] : 1.0f;
                    tau[i][c] = (t[i][c] - gq[i] / s) * (s / (1.0f + s * dn));
                }
                if (ok && pass == iters - 1) {
                    if (whole) {
#pragma unroll
                        for (int i = 0; i < TC; i += 2)
                            *reinterpret_cast<float2*>(tau_out + row + i) =
                                make_float2(tau[i][c], tau[i + 1][c]);
                    } else {
#pragma unroll
                        for (int i = 0; i < TC; ++i)
                            if (TC * nq + i < N) tau_out[row + i] = tau[i][c];
                    }
                }
            }
#pragma unroll
            for (int i = 0; i < TC; ++i)
                if (TC * nq + i < N)
                    *reinterpret_cast<float4*>(sTau + (TC * nq + i) * L + 4 * lq) =
                        make_float4(tau[i][0], tau[i][1], tau[i][2], tau[i][3]);
#pragma unroll
            for (int i = 0; i < TC; ++i)
#pragma unroll
                for (int c = 0; c < 4; ++c) t[i][c] = 0.0f;
        }
    }
}

}  // namespace

extern "C" {

int blf_admm_stage_l2_smem_bytes() { return (int)SMEM_BYTES; }

// The compiled plan: rows of a tile of G2[c] tau, ways its contraction is
// split, columns of a tile of G2[c]^T w[c] (ops/cuda/admm.py::l2_plan
// mirrors it).
void blf_admm_stage_l2_plan(int* out) {
    out[0] = R1;
    out[1] = KS;
    out[2] = TC;
}

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
