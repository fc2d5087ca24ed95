// Batched inverse of small SPD matrices for NVIDIA Hopper (sm_90a), f32.
//
// Replaces the TPU kernel blf_tpu/ops/pallas/linalg.py::_inverse_kernel over
// _chol_into (entry cholesky_inverse_lane). For every matrix K (n, n) of a
// batch:
//
//     K = L L^T          left-looking Cholesky, column by column
//     Linv = L^-1        forward substitution against the identity
//     Kinv = Linv^T Linv
//
// all three in this kernel's body. A matrix that is not positive definite, or
// holds a NaN or an infinity (a pivot s with !(s > 0) or s = inf), gives NaN
// in its whole output and touches no other matrix: failure stays per-lane
// data, as in the reference.
//
// What bounds it on an H100: bytes, nominally. A matrix is read once and its
// inverse written once, 8 n^2 bytes, against about n^3 flops (1/3 for the
// factor, 1/3 for L^-1, 1/3 for the product): 4 flop a byte at n = 64, under
// the card's f32 balance of 20. What the kernel really waits for is neither:
// the factorization is a chain of n dependent columns, each a short dot
// product and a barrier, so latency sets the time and the cure is to keep
// many matrices in flight on an SM.
//
// Design:
//  * One block of 128 threads per matrix; K (overwritten by L) and Linv live
//    in shared memory, 2 n (n + 1) floats: 33 KB at n = 64, so six blocks
//    share an SM and hide each other's barriers.
//  * Rows are padded by one float: the factorization walks down a column
//    (thread i owns row i), the product walks along rows; with a stride of
//    n + 1 both are free of bank conflicts.
//  * Cholesky, column j (chol_common.cuh, shared with chol_solve.cu): every
//    thread forms the pivot s_j itself (a broadcast read of row j), so the
//    pivot costs no extra barrier; thread i > j then forms L[i][j]. One
//    barrier a column.
//  * L^-1 needs no barrier at all: thread c solves L y = e_c on its own,
//    reading L (fixed by then) and its own column of Linv.
//  * Linv^T Linv: the n^2 outputs are spread over the block, each a dot
//    product over k >= max(i, j) (Linv is lower triangular), written
//    straight to device memory. Both (i, j) and (j, i) run the same products
//    in the same order, so the result is symmetric bit for bit.
//  * d = 1 / sqrtf(s) in IEEE arithmetic (no rsqrtf, no -use_fast_math), and
//    L[j][j] = s d, L[i][j] = (..) d, 1 / L[i][i] as the reference forms them.
//
// An edit of chol_common.cuh rebuilds this library: ops/cuda/_build.py hashes
// the headers a source includes.
//
// n is a compile-time constant (-DCHOL_N=..): ops/cuda/_build.py compiles one
// library per n at first use. Any n >= 1 whose two padded copies fit in
// 227 KB of shared memory is taken (n <= 169).
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
constexpr int THREADS = 128;
constexpr size_t SMEM_BYTES = sizeof(float) * (size_t)(2 * N * NS + N);

static_assert(N >= 1, "empty matrix");
static_assert(SMEM_BYTES <= 232448, "matrix does not fit in shared memory");

__global__ void __launch_bounds__(THREADS)
chol_inverse_kernel(const float* __restrict__ K_in, float* __restrict__ Kinv_out) {
    extern __shared__ __align__(16) float smem[];
    float* sL = smem;                 // [N][NS] K; L below the diagonal
    float* sI = sL + N * NS;          // [N][NS] L^-1 (lower)
    float* sD = sI + N * NS;          // [N]     L[i][i]
    __shared__ int bad;

    const int tid = threadIdx.x;
    const float* Kb = K_in + (size_t)blockIdx.x * N * N;
    float* Ob = Kinv_out + (size_t)blockIdx.x * N * N;

    if (tid == 0) bad = 0;
    for (int e = tid; e < N * N; e += THREADS) {
        const int r = e / N, c = e - r * N;
        sL[r * NS + c] = Kb[e];
        sI[r * NS + c] = 0.0f;
    }
    __syncthreads();

    // -- K = L L^T, left-looking ------------------------------------------
    blf::chol_columns<N, NS, THREADS>(sL, sD, &bad, tid);

    // -- Linv = L^-1: thread c solves L y = e_c, no barrier ------------------
    for (int c = tid; c < N; c += THREADS) {
        for (int i = c; i < N; ++i) {
            float acc = 0.0f;
            for (int k = c; k < i; ++k) acc += sL[i * NS + k] * sI[k * NS + c];
            sI[i * NS + c] = (((i == c) ? 1.0f : 0.0f) - acc) * (1.0f / sD[i]);
        }
    }
    __syncthreads();

    // -- Kinv = Linv^T Linv ------------------------------------------------
    const bool failed = (bad != 0);
    for (int e = tid; e < N * N; e += THREADS) {
        const int i = e / N, j = e - i * N;
        float acc = 0.0f;
        for (int k = (i > j ? i : j); k < N; ++k)
            acc += sI[k * NS + i] * sI[k * NS + j];
        Ob[e] = failed ? CUDART_NAN_F : acc;
    }
}

}  // namespace

extern "C" {

int blf_chol_lane_n() { return N; }

const char* blf_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Invert B matrices on `stream`. K and Kinv are device pointers to contiguous
// f32 arrays (B, n, n). Returns the CUDA error code of the launch (0 on
// success), -1 for an n other than the one compiled, -2 for a bad batch.
// Does not synchronise.
int blf_chol_inverse_f32(const float* K, float* Kinv, long long B, int n,
                         void* stream) {
    if (n != N) return -1;
    if (B < 1 || B > 2147483647LL) return -2;
    cudaError_t err = cudaFuncSetAttribute(
        chol_inverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    chol_inverse_kernel<<<(unsigned)B, THREADS, SMEM_BYTES,
                          (cudaStream_t)stream>>>(K, Kinv);
    return (int)cudaGetLastError();
}

}  // extern "C"
