// Fused per-lane v-space ADMM stage for NVIDIA Hopper (sm_90a), f32.
//
// Replaces the TPU kernel blf_tpu/ops/pallas/admm_lane.py:56 _lane_kernel
// (entry admm_lane_stage, pallas_call at :133). One launch runs `iters`
// iterations of
//
//     z  = clip(v, l, u)
//     w  = rho * (2 z - v)
//     x  = Kinv (A^T w - q)
//     v += alpha (A x - z)
//
// for every lane of a fleet in which each lane has its OWN operators A (m, n)
// and Kinv (n, n): the whole-body QP, where A carries the lane's mass matrix
// and contact Jacobians. All three matrix-vector products of an iteration
// are computed here; v, z and x never leave the SM between the first and the
// last iteration.
//
// What bounds it on an H100. A lane's operators are 4 (m n + n^2) bytes
// (38.4 KB at (86, 64)) against 2 (2 m n + n^2) flops an iteration (30
// Kflop), so they must stay on the SM for the whole stage: read from device
// memory once, the stage is bound by the f32 FMA rate (0.277 ms at 150
// iterations and B 4096). The first design of this kernel kept A and Kinv^T
// in shared memory and read one 4-byte operator word per FMA: (2 m n + n^2)
// words, 60.4 KB a lane-iteration, which at 128 bytes a clock is 472
// SM-cycles against 118 cycles of FMAs (15,104 at 128 a clock), a floor of
// 1.11 ms at 150 iterations; six block barriers an iteration between short
// FMA chains came on top (2.58 ms measured). No shared-memory layout helps:
// each operator word is used once a product. Only registers lower the words
// read per FMA.
//
// Design: the operators live in registers.
//  * One block of W warps a lane (W = 8 at (86, 64), 256 threads). Warp w
//    owns the columns [w CW, (w + 1) CW) of A and of Kinv (CW = 8); lane l
//    of every warp owns the rows l, l + 32, ... of A (RL = 3 rows, m padded
//    to 96 with zero rows) and the outputs l, l + 32, ... of x (OL = 2).
//    A thread keeps its RL x CW tile of A (24 floats) and its OL x CW tile of
//    Kinv (16 floats) in registers for the whole stage: the products read no
//    operator word from shared memory at all. 64 registers a thread, four
//    lanes an SM.
//  * A^T w: each thread sums its tile's rows into CW column partials; the 32
//    lanes of a warp (which share the columns) reduce them by recursive
//    halving with shuffles (7 + 2 at CW = 8), after which each group of four
//    lanes holds one column of r = A^T w - q. r goes to the warp's words of
//    shared memory (a warp barrier: the warp alone needs it).
//  * Kinv r: each thread forms the partial of its OL outputs over its warp's
//    columns; the W partials of an output are summed after block barrier 1,
//    in warp order, into the warp's own x columns (a warp barrier).
//  * A x: each thread forms its RL rows over its warp's columns; after block
//    barrier 2 the thread that owns a row (thread t owns rows t, t + 32 W,
//    ...) sums its W partials in warp order, updates v, forms z and w, and
//    publishes w for block barrier 3. v, l, u, rho and z of a row live in
//    its owner's registers only. Three block barriers an iteration, one
//    after each cross-warp exchange.
//  * Shared memory holds only the exchanged vectors (6 KB a lane at
//    (86, 64)) and the staging buffer through which the operators are read
//    from device memory, 32 rows at a time, coalesced, once a stage. The words
//    read an iteration (a broadcast counted once) are w (32 RL a warp), r and
//    x (CW a warp each), the W partials of the warp's x (W CW) and of every
//    row of A x (32 W RL): 8.7 KB a lane-iteration at (86, 64), 68 cycles at
//    128 bytes a clock, not 60.4 KB.
//  * The plan is chosen at compile time from (m, n) and mirrored by
//    ops/cuda/admm_lane.py::lane_plan: W = clamp(ceil(n / 8), 1, 8), so
//    CW <= 32 for every n <= 256; up to 96 operator floats a thread in
//    registers, A's rows first, then Kinv's. Rows and outputs beyond that
//    budget (large shapes) live in shared memory in per-lane slots, read
//    without bank conflicts; nothing is decided at run time. Four warps a
//    lane (a 3 x 16 and a 2 x 16 tile, 125 registers) and two warps were
//    slower; so was leaving the v update to every warp (the rows' state in
//    every warp, W partials read by each).
//  * clip is written with comparisons and passes on a NaN of v, l or u, as
//    jnp.clip and torch.minimum(torch.maximum()) do; +-inf bounds clip as
//    they should. Kinv is not assumed symmetric. A block is one lane, so
//    lanes never mix and any B >= 1 is taken.
//
// The shape (m, n) is a compile-time constant (-DADMM_M=.. -DADMM_N=..):
// ops/cuda/_build.py compiles one library per shape at first use.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (no -use_fast_math).

#include <cuda_runtime.h>

#ifndef ADMM_M
#error "compile with -DADMM_M=<rows of A>"
#endif
#ifndef ADMM_N
#error "compile with -DADMM_N=<columns of A>"
#endif

namespace {

constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
constexpr int pow2_at_least(int x) { return x <= 1 ? 1 : 2 * pow2_at_least((x + 1) / 2); }
constexpr int log2_of(int x) { return x <= 1 ? 0 : 1 + log2_of(x / 2); }
constexpr int clampi(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }

constexpr int M = ADMM_M;
constexpr int N = ADMM_N;
constexpr int W = clampi(cdiv(N, 8), 1, 8);        // warps a lane
constexpr int T = 32 * W;                          // threads a block (one lane)
constexpr int CW = cdiv(N, W);                     // columns a warp owns
constexpr int CWP = pow2_at_least(CW);             // ... padded to a power of two
constexpr int SH = 5 - log2_of(CWP);               // lanes a column after the halving: 1 << SH
constexpr int RL = cdiv(M, 32);                    // rows of A a lane handles
constexpr int OL = cdiv(N, 32);                    // outputs of Kinv a lane handles
constexpr int SRL = cdiv(32 * RL, T);              // rows whose v a thread updates
constexpr int REG_FLOATS = 96;                     // operator floats a thread keeps in registers
constexpr int RLR = (RL < REG_FLOATS / CW) ? RL : REG_FLOATS / CW;       // A rows in registers
constexpr int OLR = (OL < (REG_FLOATS - RLR * CW) / CW) ? OL : (REG_FLOATS - RLR * CW) / CW;
constexpr int RLT = RL - RLR;                      // A rows in shared memory
constexpr int OLT = OL - OLR;                      // Kinv outputs in shared memory
constexpr int XS = (32 * OL > W * CW) ? 32 * OL : W * CW;   // words of a warp's x partials
constexpr int SSTR = N | 1;                        // odd stride of the staging buffer

// shared memory, in floats
constexpr int OFF_R = 0;                           // [W][CWP]   r of the warp's columns
constexpr int OFF_XR = OFF_R + W * CWP;            // [W][CWP]   x of the warp's columns
constexpr int OFF_X = OFF_XR + W * CWP;            // [W][XS]    partial x by warp
constexpr int OFF_AX = OFF_X + W * XS;             // [W][32 RL] partial A x by warp
constexpr int OFF_AT = OFF_AX + W * 32 * RL;       // [W][RLT][CW][32] A rows beyond registers
constexpr int OFF_KT = OFF_AT + W * RLT * CW * 32; // [W][OLT][CW][32] Kinv outputs beyond registers
// [SROWS][SSTR] staging of operator rows, then [32 RL] w: the stage's
// prologue uses the one, its iterations the other
constexpr int OFF_S = OFF_KT + W * OLT * CW * 32;
constexpr int OFF_W = OFF_S;
constexpr int MAX_SMEM_FLOATS = 232448 / 4;
constexpr int maxi(int a, int b) { return a > b ? a : b; }
// operator rows staged at a time: 32, or 8 where 32 would not fit
constexpr int SROWS = (OFF_S + maxi(32 * SSTR, 32 * RL) <= MAX_SMEM_FLOATS) ? 32 : 8;
constexpr int SMEM_FLOATS = OFF_S + maxi(SROWS * SSTR, 32 * RL);
constexpr size_t SMEM_BYTES = sizeof(float) * (size_t)SMEM_FLOATS;

static_assert(M >= 1 && N >= 1, "empty operator");
static_assert(CW <= 32, "a warp owns at most 32 columns (n <= 256 with the default plan)");
static_assert(SMEM_BYTES <= 232448, "the lane's exchange buffers and operator tails do not fit");

constexpr unsigned FULL = 0xffffffffu;

// min(max(v, l), u) in which a NaN in any operand gives NaN.
__device__ __forceinline__ float clip_nan(float v, float l, float u) {
    float z = (v < l) ? l : v;
    z = (z > u) ? u : z;
    return (l != l || u != u) ? (l + u) : z;
}

// Copy rows [row0, row0 + SROWS) of a row-major (rows, N) operator into the
// staging buffer, zero beyond `rows`; the caller brackets it with barriers.
// Every load of a thread is issued before the first store, so their device
// memory latencies overlap.
constexpr int SLOADS = cdiv(SROWS * N, T);         // loads a thread a piece
__device__ __forceinline__ void stage_rows(float* sS, const float* __restrict__ src, int rows,
                                           int row0, int tid) {
    const float* base = src + (size_t)row0 * N;
    const int avail = (rows - row0 < SROWS ? rows - row0 : SROWS) * N;
    float t[SLOADS];
#pragma unroll
    for (int u = 0; u < SLOADS; ++u) {
        const int e = tid + u * T;
        t[u] = (e < avail) ? base[e] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < SLOADS; ++u) {
        const int e = tid + u * T;
        if (e < SROWS * N) {
            const int r = e / N, c = e - r * N;
            sS[r * SSTR + c] = t[u];
        }
    }
}

// Read the warp's CW words of a vector (broadcast), 16 bytes at a time where
// the layout allows.
__device__ __forceinline__ void read_cols(const float* s, float (&out)[CW]) {
    if constexpr (CWP % 4 == 0) {
        const float4* s4 = reinterpret_cast<const float4*>(s);
#pragma unroll
        for (int g = 0; g < CWP / 4; ++g) {
            const float4 t = s4[g];
            if (4 * g + 0 < CW) out[4 * g + 0] = t.x;
            if (4 * g + 1 < CW) out[4 * g + 1] = t.y;
            if (4 * g + 2 < CW) out[4 * g + 2] = t.z;
            if (4 * g + 3 < CW) out[4 * g + 3] = t.w;
        }
    } else {
#pragma unroll
        for (int c = 0; c < CW; ++c) out[c] = s[c];
    }
}

__global__ void __launch_bounds__(T)
admm_lane_kernel(const float* __restrict__ v_in, const float* __restrict__ rho_in,
                 const float* __restrict__ A_in, const float* __restrict__ Kinv_in,
                 const float* __restrict__ q_in, const float* __restrict__ l_in,
                 const float* __restrict__ u_in, float* __restrict__ v_out,
                 float* __restrict__ x_out, int iters, float alpha) {
    extern __shared__ __align__(16) float smem[];
    const int tid = threadIdx.x;
    const int wp = tid >> 5;
    const int ln = tid & 31;
    const size_t lane = blockIdx.x;
    const float* Ab = A_in + lane * (size_t)M * N;
    const float* Kb = Kinv_in + lane * (size_t)N * N;
    float* sR = smem + OFF_R + wp * CWP;
    float* sXr = smem + OFF_XR + wp * CWP;
    float* sX = smem + OFF_X;
    float* sAx = smem + OFF_AX;
    float* sW = smem + OFF_W;
    float* sAt = smem + OFF_AT + wp * RLT * CW * 32;
    float* sKt = smem + OFF_KT + wp * OLT * CW * 32;
    float* sS = smem + OFF_S;
    const int col0 = wp * CW;                      // the warp's first column

    // -- operators into registers (and shared-memory tails), SROWS rows at a
    // time: lane ln takes row 32 ch + ln from the piece that holds it
    float a[RLR > 0 ? RLR : 1][CW];
    float kt[OLR > 0 ? OLR : 1][CW];
    const int piece = ln / SROWS, prow = ln - piece * SROWS;
#pragma unroll
    for (int ch = 0; ch < RL; ++ch) {
#pragma unroll
        for (int pc = 0; pc < 32 / SROWS; ++pc) {
            __syncthreads();
            stage_rows(sS, Ab, M, 32 * ch + pc * SROWS, tid);
            __syncthreads();
            if (piece == pc) {
#pragma unroll
                for (int c = 0; c < CW; ++c) {
                    const float val = (col0 + c < N) ? sS[prow * SSTR + col0 + c] : 0.0f;
                    if (ch < RLR) a[ch < RLR ? ch : 0][c] = val;
                    else sAt[((ch - RLR) * CW + c) * 32 + ln] = val;
                }
            }
        }
    }
#pragma unroll
    for (int ch = 0; ch < OL; ++ch) {
#pragma unroll
        for (int pc = 0; pc < 32 / SROWS; ++pc) {
            __syncthreads();
            stage_rows(sS, Kb, N, 32 * ch + pc * SROWS, tid);
            __syncthreads();
            if (piece == pc) {
#pragma unroll
                for (int c = 0; c < CW; ++c) {
                    const float val = (col0 + c < N) ? sS[prow * SSTR + col0 + c] : 0.0f;
                    if (ch < OLR) kt[ch < OLR ? ch : 0][c] = val;
                    else sKt[((ch - OLR) * CW + c) * 32 + ln] = val;
                }
            }
        }
    }

    // -- per-row state: thread tid updates the rows tid, tid + T, ... (padding
    // rows have v = l = u = rho = 0, hence w = 0), and publishes their w where
    // the staging buffer was, once every thread has read its last piece
    __syncthreads();
    float v[SRL], lo[SRL], hi[SRL], rho[SRL], z[SRL];
#pragma unroll
    for (int k = 0; k < SRL; ++k) {
        const int i = tid + T * k;
        const bool ok = i < M;
        v[k] = ok ? v_in[lane * M + i] : 0.0f;
        lo[k] = ok ? l_in[lane * M + i] : 0.0f;
        hi[k] = ok ? u_in[lane * M + i] : 0.0f;
        rho[k] = ok ? rho_in[lane * M + i] : 0.0f;
        z[k] = clip_nan(v[k], lo[k], hi[k]);
        if (i < 32 * RL) sW[i] = rho[k] * (2.0f * z[k] - v[k]);
    }
    // the column of r this lane holds after the halving, and its q
    const int c_own = ln >> SH;
    const float q_own = (c_own < CW && col0 + c_own < N) ? q_in[lane * N + col0 + c_own] : 0.0f;

    __syncthreads();

    for (int it = 0; it < iters; ++it) {
        // column partials of A^T w over the thread's rows
        float p[CWP];
#pragma unroll
        for (int c = 0; c < CWP; ++c) p[c] = 0.0f;
#pragma unroll
        for (int k = 0; k < RL; ++k) {
            const float w = sW[ln + 32 * k];
#pragma unroll
            for (int c = 0; c < CW; ++c) {
                const float op = (k < RLR) ? a[k < RLR ? k : 0][c]
                                           : sAt[((k - RLR) * CW + c) * 32 + ln];
                p[c] = fmaf(op, w, p[c]);
            }
        }
        // reduce over the 32 lanes: recursive halving, then a butterfly
#pragma unroll
        for (int s = CWP / 2, msk = 16; s >= 1; s >>= 1, msk >>= 1) {
            const bool up = (ln & msk) != 0;
#pragma unroll
            for (int k = 0; k < s; ++k) {
                const float send = up ? p[k] : p[k + s];
                const float keep = up ? p[k + s] : p[k];
                p[k] = keep + __shfl_xor_sync(FULL, send, msk);
            }
        }
#pragma unroll
        for (int msk = (1 << SH) >> 1; msk >= 1; msk >>= 1)
            p[0] += __shfl_xor_sync(FULL, p[0], msk);
        if ((ln & ((1 << SH) - 1)) == 0) sR[c_own] = p[0] - q_own;
        __syncwarp();

        // partial x over the warp's columns: x_i += Kinv[i][col0 + c] r[c]
        {
            float r[CW];
            read_cols(sR, r);
#pragma unroll
            for (int k = 0; k < OL; ++k) {
                float acc = 0.0f;
#pragma unroll
                for (int c = 0; c < CW; ++c) {
                    const float op = (k < OLR) ? kt[k < OLR ? k : 0][c]
                                               : sKt[((k - OLR) * CW + c) * 32 + ln];
                    acc = fmaf(op, r[c], acc);
                }
                sX[wp * XS + ln + 32 * k] = acc;
            }
        }
        __syncthreads();                                           // (1)

        // the warp's own columns of x, summed over the warps in order
        if (ln < CW) {
            float xs = sX[col0 + ln];
#pragma unroll
            for (int g = 1; g < W; ++g) xs += sX[g * XS + col0 + ln];
            sXr[ln] = xs;
        }
        __syncwarp();

        // partial A x over the warp's columns
        {
            float x[CW];
            read_cols(sXr, x);
#pragma unroll
            for (int k = 0; k < RL; ++k) {
                float acc = 0.0f;
#pragma unroll
                for (int c = 0; c < CW; ++c) {
                    const float op = (k < RLR) ? a[k < RLR ? k : 0][c]
                                               : sAt[((k - RLR) * CW + c) * 32 + ln];
                    acc = fmaf(op, x[c], acc);
                }
                sAx[wp * 32 * RL + ln + 32 * k] = acc;
            }
        }
        __syncthreads();                                           // (2)

        // v += alpha (A x - z) on the thread's own rows, the warps' partials
        // summed in order; then z = clip(v, l, u) and w = rho (2 z - v)
#pragma unroll
        for (int k = 0; k < SRL; ++k) {
            const int i = tid + T * k;
            if (i < 32 * RL) {
                float ax = sAx[i];
#pragma unroll
                for (int g = 1; g < W; ++g) ax += sAx[g * 32 * RL + i];
                v[k] += alpha * (ax - z[k]);
                z[k] = clip_nan(v[k], lo[k], hi[k]);
                sW[i] = rho[k] * (2.0f * z[k] - v[k]);
            }
        }
        __syncthreads();                                           // (3)
        // sR and sXr are the warp's own; sX is next written after barrier (2)
        // and sAx after the next barrier (1), sW after the next barrier (2):
        // every reader of each has passed that barrier by then.
    }

#pragma unroll
    for (int k = 0; k < SRL; ++k) {
        const int i = tid + T * k;
        if (i < M) v_out[lane * M + i] = v[k];
    }
    // sXr holds the last iteration's x of the warp's columns
    if (ln < CW && col0 + ln < N) x_out[lane * N + col0 + ln] = sXr[ln];
}

}  // namespace

extern "C" {

// The compile-time plan, in the order of ops/cuda/admm_lane.py::LanePlan:
// warps, columns a warp, rows of A a lane (all, in registers), outputs of
// Kinv a lane (all, in registers), operator rows staged at a time, shared
// bytes.
void blf_admm_lane_plan(int* out) {
    out[0] = W; out[1] = CW; out[2] = RL; out[3] = RLR; out[4] = OL; out[5] = OLR;
    out[6] = SROWS; out[7] = (int)SMEM_BYTES;
}

const char* blf_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Registers a thread, local (spill) bytes a thread and blocks (lanes) an SM
// of the compiled kernel. Returns the CUDA error code (0 on success).
int blf_admm_lane_attributes(int* out) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, admm_lane_kernel);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(admm_lane_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, admm_lane_kernel, T, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    out[0] = attr.numRegs;
    out[1] = (int)attr.localSizeBytes;
    out[2] = blocks;
    return 0;
}

// Launch one stage on `stream`. All pointers are device pointers to contiguous
// f32 arrays: v, rho, l, u (B, m); q (B, n); A (B, m, n); Kinv (B, n, n);
// outputs v_out (B, m), x_out (B, n). Returns the CUDA error code of the launch
// (0 on success), or -1 for a shape other than the one compiled, -2 for a bad
// batch or iteration count. Does not synchronise.
int blf_admm_lane_stage_f32(const float* v, const float* rho, const float* A,
                            const float* Kinv, const float* q, const float* l,
                            const float* u, float* v_out, float* x_out,
                            long long B, int m, int n, int iters, float alpha,
                            void* stream) {
    if (m != M || n != N) return -1;
    if (B < 1 || B > 2147483647LL || iters < 1) return -2;
    cudaError_t err = cudaFuncSetAttribute(
        admm_lane_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    admm_lane_kernel<<<(unsigned)B, T, SMEM_BYTES, (cudaStream_t)stream>>>(
        v, rho, A, Kinv, q, l, u, v_out, x_out, iters, alpha);
    return (int)cudaGetLastError();
}

}  // extern "C"
