// Batched SPD solve with one right-hand side for NVIDIA Hopper (sm_90a), f32.
//
// Replaces the TPU kernel blf_tpu/ops/pallas/linalg.py::_solve_kernel over
// _chol_into (entry cholesky_solve_lane). For every matrix K (n, n) and
// vector b (n) of a batch:
//
//     K = L L^T          left-looking Cholesky (chol_common.cuh, shared with
//                        the batched inverse of chol_lane.cu)
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
// at B = 4096 the bytes take 0.2 us at 3.35 TB/s, less than one launch. The
// factorization is a chain of n dependent columns, each a short dot product
// and a barrier: latency, and at n = 6 the launch itself.
//
// Design (a first kernel that is right, not yet a fast one):
//  * One block of one warp (32 threads) per matrix: at n = 6 most threads of
//    K3's 128 would idle, and a one-warp barrier is cheap. K (overwritten by
//    L), L's diagonal, y and x live in shared memory, rows padded to n + 1.
//  * The factorization is chol_common.cuh's, exactly K3's.
//  * The two substitutions are a dependent chain of n rows each; thread 0
//    walks them in the reference's order, y[i] = (b[i] - sum_k<i L[i][k] y[k])
//    / L[i][i] and x[i] = (y[i] - sum_k>i L[k][i] x[k]) / L[i][i].
//  * d = 1 / sqrtf(s), divisions and square roots IEEE (no -use_fast_math).
//
// n is a compile-time constant (-DCHOL_N=..): ops/cuda/_build.py compiles one
// library per n at first use, and rebuilds it when this file or
// chol_common.cuh changes.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (no -use_fast_math).

#include "chol_common.cuh"

#ifndef CHOL_N
#error "compile with -DCHOL_N=<matrix size>"
#endif

namespace {

constexpr int N = CHOL_N;
constexpr int NS = N + 1;            // padded row stride
constexpr int THREADS = 32;
constexpr size_t SMEM_BYTES = sizeof(float) * (size_t)(N * NS + 3 * N);

static_assert(N >= 1, "empty matrix");
static_assert(SMEM_BYTES <= 232448, "matrix does not fit in shared memory");

__global__ void __launch_bounds__(THREADS)
chol_solve_kernel(const float* __restrict__ K_in, const float* __restrict__ b_in,
                  float* __restrict__ x_out) {
    extern __shared__ __align__(16) float smem[];
    float* sL = smem;                 // [N][NS] K; L below the diagonal
    float* sD = sL + N * NS;          // [N]     L[i][i]
    float* sY = sD + N;               // [N]     b, then y
    float* sX = sY + N;               // [N]     x
    __shared__ int bad;

    const int tid = threadIdx.x;
    const float* Kb = K_in + (size_t)blockIdx.x * N * N;
    const float* bb = b_in + (size_t)blockIdx.x * N;
    float* xb = x_out + (size_t)blockIdx.x * N;

    if (tid == 0) bad = 0;
    for (int e = tid; e < N * N; e += THREADS) {
        const int r = e / N, c = e - r * N;
        sL[r * NS + c] = Kb[e];
    }
    for (int i = tid; i < N; i += THREADS) sY[i] = bb[i];
    __syncthreads();

    blf::chol_columns<N, NS, THREADS>(sL, sD, &bad, tid);

    if (tid == 0) {
        for (int i = 0; i < N; ++i) {            // L y = b
            float acc = 0.0f;
            for (int k = 0; k < i; ++k) acc += sL[i * NS + k] * sY[k];
            sY[i] = (sY[i] - acc) / sD[i];
        }
        for (int i = N - 1; i >= 0; --i) {       // L^T x = y
            float acc = 0.0f;
            for (int k = i + 1; k < N; ++k) acc += sL[k * NS + i] * sX[k];
            sX[i] = (sY[i] - acc) / sD[i];
        }
    }
    __syncthreads();

    const bool failed = (bad != 0);
    for (int i = tid; i < N; i += THREADS) xb[i] = failed ? CUDART_NAN_F : sX[i];
}

}  // namespace

extern "C" {

int blf_chol_solve_n() { return N; }

const char* blf_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Solve B systems K x = b on `stream`. K, b and x are device pointers to
// contiguous f32 arrays (B, n, n), (B, n), (B, n). Returns the CUDA error code
// of the launch (0 on success), -1 for an n other than the one compiled, -2
// for a bad batch. Does not synchronise.
int blf_chol_solve_f32(const float* K, const float* b, float* x, long long B, int n,
                       void* stream) {
    if (n != N) return -1;
    if (B < 1 || B > 2147483647LL) return -2;
    cudaError_t err = cudaFuncSetAttribute(
        chol_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    chol_solve_kernel<<<(unsigned)B, THREADS, SMEM_BYTES,
                        (cudaStream_t)stream>>>(K, b, x);
    return (int)cudaGetLastError();
}

}  // extern "C"
