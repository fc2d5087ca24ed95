// Batched SPD solve with one right-hand side for NVIDIA Hopper (sm_90a), f32.
//
// Replaces the TPU kernel blf_tpu/ops/pallas/linalg.py:81 _solve_kernel over
// _chol_into (:40; entry cholesky_solve_lane, pallas_call at :175). For every
// matrix K (n, n) and vector b (n) of a batch:
//
//     K = L L^T          left-looking Cholesky, column by column
//     L y = b            forward substitution
//     L^T x = y          backward substitution
//
// all in this kernel's body. A matrix that is not positive definite, or holds
// a NaN or an infinity (a pivot s with !(s > 0) or s = inf), gives NaN in its
// whole x and touches no other lane, as in the reference.
//
// What bounds it on an H100: nothing the card is short of. A lane reads
// n^2 + n floats and writes n (n = 6 on the control stack's path, the 6x6
// wrench-attribution solve: 168 bytes) and does about n^3 / 3 + 2 n^2 flops;
// at B = 4096 the bytes take 0.2 us at 3.35 TB/s, far less than one launch
// (an empty kernel of this grid takes 1.8 us on an H100 at 700 W). Every step
// is a chain of dependent columns or rows: latency, and at n = 6 the launch
// itself. The first design of this kernel (one block of one warp a matrix, a
// block barrier a column, thread 0 walking both substitutions alone,
// cudaFuncSetAttribute at every launch) left 31 of 32 threads idle for most
// of its chain: 8.8 us at (4096, 6) against 4.3 us for this one.
//
// Design:
//  * Small n (n <= N_REG = 20), one thread a matrix. A block of 32 threads
//    (64 and 128 were no faster) stages its 32 matrices and right-hand sides
//    through shared memory with coalesced 16-byte loads (scalar ones if K or
//    b is not 16-byte aligned). Each matrix gets a slot of n^2 + n + 1 floats,
//    K then b: an odd stride, so the threads, each reading its own slot, hit
//    32 distinct banks. Each thread keeps the lower triangle and b in
//    registers (27 floats at n = 6; 249 registers and no spill at n = 20, 748
//    bytes spilled at n = 24), and runs the factorization and both
//    substitutions fully unrolled, in the reference's order (k ascending,
//    each sum formed and then subtracted), with no barrier inside. x goes to
//    the thread's own slot and back out with one coalesced store. Up to
//    n = 20 this beats a warp a matrix at every n measured (n = 16: 12 us
//    against 22 at B = 4096).
//  * Larger n, one warp a matrix, up to four matrices a block, no block
//    barrier. The matrix lives in shared memory once, rows at an odd stride
//    (n, or n + 1 for even n): the 32 rows a warp reads at one column lie on
//    distinct banks. It is loaded eight words a lane at a time (sixteen made
//    the compiler spill at n = 24 and 29). The factorization is
//    chol_lane.cu's: lane l owns rows l, l + 32, ... and keeps each row's
//    running remainder K[i][i] - sum_k<j L[i][k]^2 in a register, so the
//    pivot is handed over by one shuffle; the dot products run on four
//    partial sums. Both substitutions are spread over the warp, column by
//    column: the owner of row j forms y[j] (x[j]) by an IEEE division, one
//    shuffle hands it to every lane, and each lane updates the remainders of
//    its rows. Their sums run in another order than the reference's, within
//    1e-5 of it.
//  * d = 1 / sqrtf(s), L[j][j] = s d, L[i][j] = (K[i][j] - dot) d, and
//    divisions by L[i][i] in the substitutions: IEEE arithmetic (no rsqrtf,
//    no -use_fast_math).
//  * The launch path is light: cudaFuncSetAttribute is called once a device
//    per library, and only when the dynamic shared memory passes 48 KB
//    (n = 20, and the warp path past n = 110).
//
// n is a compile-time constant (-DCHOL_N=..): ops/cuda/_build.py compiles one
// library per n at first use. Every n from 1 to 239 is taken (the warp path
// at n = 239 holds 228 KB of shared memory).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (no -use_fast_math).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#ifndef CHOL_N
#error "compile with -DCHOL_N=<matrix size>"
#endif

namespace {

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

constexpr int N = CHOL_N;
constexpr int NN = N * N;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_DEFAULT = 48 * 1024;        // dynamic shared memory without opt-in

// -- the plan (ops/cuda/linalg.py::solve_plan mirrors it) ---------------------
constexpr int N_REG = 20;                         // the largest n solved one thread a matrix
constexpr bool THREAD_PATH = N <= N_REG;
// thread path: THREADS_T matrices a block, one slot of K then b a matrix
constexpr int THREADS_T = 32;
constexpr int SLOT = NN + N + 1;                  // odd: n (n + 1) is even
// warp path: one warp a matrix, rows at an odd stride, W matrices a block
constexpr int NS = N | 1;
constexpr int W = imax(1, imin(4, SMEM_DEFAULT / (4 * N * NS)));
constexpr int RPL = cdiv(N, 32);                  // rows a lane owns
constexpr int LOAD_BATCH = imin(cdiv(NN, 32), 8);   // loads in flight a lane

constexpr int THREADS = THREAD_PATH ? THREADS_T : 32 * W;
constexpr int MATRICES_PER_BLOCK = THREAD_PATH ? THREADS_T : W;
constexpr int STRIDE = THREAD_PATH ? SLOT : NS;
constexpr size_t SMEM_BYTES = sizeof(float) *
    (THREAD_PATH ? (size_t)THREADS_T * SLOT : (size_t)W * N * NS);

static_assert(N >= 1, "empty matrix");
static_assert(SLOT % 2 == 1 && NS % 2 == 1, "odd strides");
static_assert(THREADS_T % 32 == 0 && THREADS_T <= 1024, "whole warps");
static_assert(SMEM_BYTES <= 232448, "matrix does not fit in shared memory");

// -- small n: one thread a matrix ------------------------------------------

// Copy `count` floats from global `src` (16-byte aligned when `vec`) into the
// slots: element e goes to slot e / per, offset base + e % per.
template <int PER>
__device__ __forceinline__ void stage(float* slots, int base, const float* __restrict__ src,
                                      int count, bool vec, int tid) {
    if (vec) {
        constexpr int VPT = cdiv(THREADS_T * PER, 4 * THREADS_T);   // float4 a thread
        constexpr int BATCH = imin(VPT, 8);
        const int nvec = count >> 2;
        const float4* src4 = reinterpret_cast<const float4*>(src);
        for (int v0 = 0; v0 < VPT; v0 += BATCH) {
            float4 q[BATCH];
#pragma unroll
            for (int u = 0; u < BATCH; ++u) {
                const int v = (v0 + u) * THREADS_T + tid;
                if (v0 + u < VPT && v < nvec) q[u] = __ldg(src4 + v);
            }
#pragma unroll
            for (int u = 0; u < BATCH; ++u) {
                const int v = (v0 + u) * THREADS_T + tid;
                if (v0 + u < VPT && v < nvec) {
                    const float w4[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        const int e = 4 * v + c;
                        slots[(e / PER) * SLOT + base + e % PER] = w4[c];
                    }
                }
            }
        }
        for (int e = 4 * nvec + tid; e < count; e += THREADS_T)
            slots[(e / PER) * SLOT + base + e % PER] = src[e];
    } else {
        for (int e = tid; e < count; e += THREADS_T)
            slots[(e / PER) * SLOT + base + e % PER] = src[e];
    }
}

// Both kernels are templates on whether the plan takes them, so that only the
// one the library launches is compiled with a body.
template <bool ON>
__global__ void __launch_bounds__(THREADS_T)
solve_thread_kernel(const float* __restrict__ K_in, const float* __restrict__ b_in,
                    float* __restrict__ x_out, long long B) {
  if constexpr (ON) {
    extern __shared__ __align__(16) float slots[];     // [THREADS_T][SLOT]
    const int tid = threadIdx.x;
    const long long m0 = (long long)blockIdx.x * THREADS_T;
    const int cnt = (int)((B - m0 < THREADS_T) ? B - m0 : THREADS_T);
    const float* Kb = K_in + m0 * NN;
    const float* bb = b_in + m0 * N;
    float* xb = x_out + m0 * N;

    // m0 is a multiple of 32, so every block's pieces are 16-byte aligned
    // exactly when the arrays are
    stage<NN>(slots, 0, Kb, cnt * NN, (reinterpret_cast<uintptr_t>(K_in) & 15) == 0, tid);
    stage<N>(slots, NN, bb, cnt * N, (reinterpret_cast<uintptr_t>(b_in) & 15) == 0, tid);
    __syncthreads();

    float* my = slots + tid * SLOT;
    if (tid < cnt) {
        float a[N][N];                   // the lower triangle: K, then L
        float r[N];                      // b, then y, then x
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int j = 0; j <= i; ++j) a[i][j] = my[i * N + j];
            r[i] = my[NN + i];
        }
        bool bad = false;
#pragma unroll
        for (int j = 0; j < N; ++j) {
            float acc = 0.0f;
#pragma unroll
            for (int k = 0; k < j; ++k) acc = fmaf(a[j][k], a[j][k], acc);
            const float s = a[j][j] - acc;
            const float d = 1.0f / sqrtf(s);
            bad = bad || !(s > 0.0f) || s == CUDART_INF_F;
            a[j][j] = s * d;
#pragma unroll
            for (int i = j + 1; i < N; ++i) {
                float dot = 0.0f;
#pragma unroll
                for (int k = 0; k < j; ++k) dot = fmaf(a[i][k], a[j][k], dot);
                a[i][j] = (a[i][j] - dot) * d;
            }
        }
#pragma unroll
        for (int i = 0; i < N; ++i) {             // L y = b
            float acc = 0.0f;
#pragma unroll
            for (int k = 0; k < i; ++k) acc = fmaf(a[i][k], r[k], acc);
            r[i] = (r[i] - acc) / a[i][i];
        }
#pragma unroll
        for (int i = N - 1; i >= 0; --i) {        // L^T x = y
            float acc = 0.0f;
#pragma unroll
            for (int k = i + 1; k < N; ++k) acc = fmaf(a[k][i], r[k], acc);
            r[i] = (r[i] - acc) / a[i][i];
        }
#pragma unroll
        for (int i = 0; i < N; ++i) my[i] = bad ? CUDART_NAN_F : r[i];
    }
    __syncthreads();
    for (int e = tid; e < cnt * N; e += THREADS_T) xb[e] = slots[(e / N) * SLOT + e % N];
  }
}

// -- larger n: one warp a matrix -------------------------------------------

template <bool ON>
__global__ void __launch_bounds__(32 * W)
solve_warp_kernel(const float* __restrict__ K_in, const float* __restrict__ b_in,
                  float* __restrict__ x_out, long long B) {
  if constexpr (ON) {
    extern __shared__ __align__(16) float smem[];
    const int ln = threadIdx.x & 31;
    const long long m = (long long)blockIdx.x * W + (threadIdx.x >> 5);
    if (m >= B) return;                           // no block barrier follows
    float* sM = smem + (threadIdx.x >> 5) * N * NS;   // [N][NS], lower triangle
    const float* Kb = K_in + m * NN;
    const float* bb = b_in + m * N;
    float* xb = x_out + m * N;

    // K's lower triangle; loads go out up to LOAD_BATCH a lane before their stores
#pragma unroll 1
    for (int e0 = 0; e0 < NN; e0 += 32 * LOAD_BATCH) {
        float t[LOAD_BATCH];
#pragma unroll
        for (int u = 0; u < LOAD_BATCH; ++u) {
            const int e = e0 + ln + 32 * u;
            t[u] = (e < NN) ? __ldg(Kb + e) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < LOAD_BATCH; ++u) {
            const int e = e0 + ln + 32 * u;
            if (e < NN) {
                const int row = e / N, col = e - row * N;
                if (col <= row) sM[row * NS + col] = t[u];
            }
        }
    }
    float r[RPL];        // b, then y, then x, of the lane's rows
#pragma unroll
    for (int t = 0; t < RPL; ++t) {
        const int i = ln + 32 * t;
        r[t] = (i < N) ? __ldg(bb + i) : 0.0f;
    }
    __syncwarp();

    float dr[RPL];       // running remainders K[i][i] - sum_k<j L[i][k]^2
#pragma unroll
    for (int t = 0; t < RPL; ++t) {
        const int i = ln + 32 * t;
        dr[t] = (i < N) ? sM[i * NS + i] : 1.0f;
    }
    bool bad = false;

    // -- K = L L^T, 32 columns at a time: in block jb the pivot's owner holds it
    // in slot jb, and rows of slots < jb are done
#pragma unroll
    for (int jb = 0; jb < RPL; ++jb) {
        const int jend = imin(32 * jb + 32, N);
        for (int j = 32 * jb; j < jend; ++j) {
            const float s = __shfl_sync(FULL, dr[jb], j & 31);
            const float d = 1.0f / sqrtf(s);
            bad = bad || !(s > 0.0f) || s == CUDART_INF_F;
            const float* pj = sM + j * NS;
#pragma unroll
            for (int t = jb; t < RPL; ++t) {
                const int i = ln + 32 * t;
                if (i > j && i < N) {
                    const float* pi = sM + i * NS;
                    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
                    int k = 0;
#pragma unroll 2
                    for (; k + 4 <= j; k += 4) {
                        a0 = fmaf(pi[k], pj[k], a0);
                        a1 = fmaf(pi[k + 1], pj[k + 1], a1);
                        a2 = fmaf(pi[k + 2], pj[k + 2], a2);
                        a3 = fmaf(pi[k + 3], pj[k + 3], a3);
                    }
                    for (; k < j; ++k) a0 = fmaf(pi[k], pj[k], a0);
                    const float lij = (pi[j] - ((a0 + a1) + (a2 + a3))) * d;
                    sM[i * NS + j] = lij;
                    dr[t] = fmaf(-lij, lij, dr[t]);
                }
            }
            if (ln == (j & 31)) sM[j * NS + j] = s * d;     // L[j][j]
            __syncwarp();
        }
    }

    // -- L y = b, column by column: y[j] from its owner, then every lane's rows
#pragma unroll
    for (int jb = 0; jb < RPL; ++jb) {
        const int jend = imin(32 * jb + 32, N);
        for (int j = 32 * jb; j < jend; ++j) {
            const float yj = __shfl_sync(FULL, r[jb] / sM[j * NS + j], j & 31);
            if (ln == (j & 31)) r[jb] = yj;
#pragma unroll
            for (int t = jb; t < RPL; ++t) {
                const int i = ln + 32 * t;
                if (i > j && i < N) r[t] = fmaf(-sM[i * NS + j], yj, r[t]);
            }
        }
    }
    // -- L^T x = y, from the last column: x[j] from its owner, then rows i < j
#pragma unroll
    for (int jb = RPL - 1; jb >= 0; --jb) {
        const int jend = imin(32 * jb + 32, N);
        for (int j = jend - 1; j >= 32 * jb; --j) {
            const float xj = __shfl_sync(FULL, r[jb] / sM[j * NS + j], j & 31);
            if (ln == (j & 31)) r[jb] = xj;
            const float* pj = sM + j * NS;              // L[j][i] for i < j
#pragma unroll
            for (int t = 0; t <= jb; ++t) {
                const int i = ln + 32 * t;
                if (i < j) r[t] = fmaf(-pj[i], xj, r[t]);
            }
        }
    }
#pragma unroll
    for (int t = 0; t < RPL; ++t) {
        const int i = ln + 32 * t;
        if (i < N) xb[i] = bad ? CUDART_NAN_F : r[t];
    }
  }
}

// nothing: the launch floor (blf_chol_solve_empty)
__global__ void empty_kernel() {}

}  // namespace

extern "C" {

int blf_chol_solve_n() { return N; }

// The compiled plan: path (0 one thread a matrix, 1 one warp a matrix),
// threads a block, matrices a block, the shared-memory stride in floats (a
// thread's slot, or a matrix row) and the dynamic shared bytes a block.
void blf_chol_solve_plan(int* out) {
    out[0] = THREAD_PATH ? 0 : 1;
    out[1] = THREADS;
    out[2] = MATRICES_PER_BLOCK;
    out[3] = STRIDE;
    out[4] = (int)SMEM_BYTES;
}

const char* blf_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

static const void* kernel_fn() {
    return THREAD_PATH ? (const void*)solve_thread_kernel<THREAD_PATH>
                       : (const void*)solve_warp_kernel<!THREAD_PATH>;
}

// Past 48 KB of dynamic shared memory a kernel must opt in, once a device.
static int g_opted_in[64];

static int opt_in() {
    if (SMEM_BYTES <= (size_t)SMEM_DEFAULT) return 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= 64) return -3;
    if (!g_opted_in[dev]) {
        err = cudaFuncSetAttribute(kernel_fn(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)SMEM_BYTES);
        if (err != cudaSuccess) return (int)err;
        g_opted_in[dev] = 1;
    }
    return 0;
}

// The launch floor: an empty kernel launched as blf_chol_solve_f32 launches
// this one (the same grid, block and shared memory). Returns the CUDA error
// code of the launch.
int blf_chol_solve_empty(long long B, void* stream) {
    if (B < 1 || B > 2147483647LL) return -2;
    const int code = opt_in();
    if (code != 0) return code;
    const unsigned blocks = (unsigned)((B + MATRICES_PER_BLOCK - 1) / MATRICES_PER_BLOCK);
    empty_kernel<<<blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

// Registers a thread, local (spill) bytes a thread and blocks an SM of the
// compiled kernel. Returns the CUDA error code (0 on success).
int blf_chol_solve_attributes(int* out) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel_fn());
    if (err != cudaSuccess) return (int)err;
    const int code = opt_in();
    if (code != 0) return code;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel_fn(), THREADS,
                                                        SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    out[0] = attr.numRegs;
    out[1] = (int)attr.localSizeBytes;
    out[2] = blocks;
    return 0;
}

// Solve B systems K x = b on `stream`. K, b and x are device pointers to
// contiguous f32 arrays (B, n, n), (B, n), (B, n). Returns the CUDA error code
// of the launch (0 on success), -1 for an n other than the one compiled, -2
// for a bad batch, -3 for a device ordinal past 63. Does not synchronise.
int blf_chol_solve_f32(const float* K, const float* b, float* x, long long B, int n,
                       void* stream) {
    if (n != N) return -1;
    if (B < 1 || B > 2147483647LL) return -2;
    const int code = opt_in();
    if (code != 0) return code;
    const unsigned blocks = (unsigned)((B + MATRICES_PER_BLOCK - 1) / MATRICES_PER_BLOCK);
    if constexpr (THREAD_PATH)
        solve_thread_kernel<THREAD_PATH><<<blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(K, b, x, B);
    else
        solve_warp_kernel<!THREAD_PATH><<<blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(K, b, x, B);
    return (int)cudaGetLastError();
}

}  // extern "C"
