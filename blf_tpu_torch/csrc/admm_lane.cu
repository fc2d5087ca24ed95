// Fused per-lane v-space ADMM stage for NVIDIA Hopper (sm_90a), f32.
//
// Replaces the TPU kernel blf_tpu/ops/pallas/admm_lane.py::_lane_kernel
// (entry admm_lane_stage). One launch runs `iters` iterations of
//
//     z  = clip(v, l, u)
//     w  = rho * (2 z - v)
//     x  = Kinv (A^T w - q)
//     v += alpha (A x - z)
//
// for every lane of a fleet in which each lane has its OWN operators A (m, n)
// and Kinv (n, n): the whole-body QP, where A carries the lane's mass matrix
// and contact Jacobians. All three matrix-vector products of an iteration
// are computed here, in this kernel's body; v, z and x never leave the SM
// between the first and the last iteration.
//
// What bounds it on an H100: bytes. A lane's operators are 4 (m n + n^2)
// bytes (38.4 KB at (86, 64)) and an iteration does 2 (2 m n + n^2) flops on
// them (30 Kflop): about 0.8 flop a byte of operator an iteration, so a
// design that streamed the operators from device memory every iteration
// would be memory-bound 25 times over. With nothing shared between lanes
// there is no GEMM to tile either. So, as in the TPU kernel, the point is
// residency: A and Kinv are read from device memory ONCE a stage and stay on
// the SM for all its iterations. What the resident kernel then waits for is
// shared memory: every iteration re-reads A twice and Kinv once (60.4 KB a
// lane), one 4-byte word per FMA, and the SM's shared memory delivers 128
// bytes a clock.
//
// Design:
//  * One block of 256 threads per lane; A (row stride n + 1) and Kinv^T (row
//    stride n + 1) in shared memory with the stage's vectors: 41 KB at
//    (86, 64), so five blocks share an SM and overlap each other's barriers.
//  * A^T w and Kinv rhs have n outputs and a long reduction: thread t takes
//    output column t mod n and one of 256 / n slices of the reduction, reads
//    down a column (neighbouring threads, neighbouring words: no bank
//    conflict), and the slices are summed through shared memory. Kinv is
//    stored transposed so that "row i of Kinv" is read down a column too; the
//    kernel never assumes that Kinv is symmetric.
//  * A x has m outputs: thread t takes row t mod m and one of 256 / m slices
//    of the columns; the odd stride n + 1 puts the rows of a warp on
//    different banks.
//  * v, z, l, u, rho stay in the registers of the thread that owns the row.
//  * clip is written with comparisons and passes on a NaN of v, l or u, as
//    jnp.clip and torch.minimum(torch.maximum()) do; +-inf bounds clip as
//    they should. Lanes never mix: a poisoned lane poisons nothing else.
//  * A block per lane means no padding of the batch: any B >= 1 is taken.
//
// The shape (m, n) is a compile-time constant (-DADMM_M=.. -DADMM_N=..):
// ops/cuda/_build.py compiles one library per shape at first use. The lane's
// operators must fit in 227 KB of shared memory.
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

constexpr int M = ADMM_M;
constexpr int N = ADMM_N;
constexpr int T = 256;                     // threads per block
constexpr int NS = N + 1;                  // padded row stride of A and Kinv^T
constexpr int GN = (N >= T) ? 1 : T / N;   // reduction slices, n outputs
constexpr int GM = (M >= T) ? 1 : T / M;   // reduction slices, m outputs
constexpr int CH_M = (M + GN - 1) / GN;    // rows of A per slice in A^T w
constexpr int CH_K = (N + GN - 1) / GN;    // rows of Kinv^T per slice in Kinv rhs
constexpr int CH_X = (N + GM - 1) / GM;    // columns of A per slice in A x
constexpr int RPT = (M + T - 1) / T;       // rows of v a thread owns
constexpr int PART = (GN * N > GM * M) ? GN * N : GM * M;
constexpr int SMEM_FLOATS = M * NS + N * NS + M + 3 * N + PART;
constexpr size_t SMEM_BYTES = sizeof(float) * (size_t)SMEM_FLOATS;

static_assert(M >= 1 && N >= 1, "empty operator");
static_assert(SMEM_BYTES <= 232448, "a lane's operators do not fit in shared memory");

// min(max(v, l), u) in which a NaN in any operand gives NaN.
__device__ __forceinline__ float clip_nan(float v, float l, float u) {
    float z = (v < l) ? l : v;
    z = (z > u) ? u : z;
    return (l != l || u != u) ? (l + u) : z;
}

__global__ void __launch_bounds__(T)
admm_lane_kernel(const float* __restrict__ v_in, const float* __restrict__ rho_in,
                 const float* __restrict__ A_in, const float* __restrict__ Kinv_in,
                 const float* __restrict__ q_in, const float* __restrict__ l_in,
                 const float* __restrict__ u_in, float* __restrict__ v_out,
                 float* __restrict__ x_out, int iters, float alpha) {
    extern __shared__ __align__(16) float smem[];
    float* sA = smem;                 // [M][NS]  A
    float* sK = sA + M * NS;          // [N][NS]  Kinv^T: sK[j][i] = Kinv[i][j]
    float* sW = sK + N * NS;          // [M]      w
    float* sR = sW + M;               // [N]      rhs = A^T w - q
    float* sX = sR + N;               // [N]      x
    float* sQ = sX + N;               // [N]      q
    float* sP = sQ + N;               // [PART]   partial sums of the slices

    const int tid = threadIdx.x;
    const size_t lane = blockIdx.x;
    const float* Ab = A_in + lane * (size_t)(M * N);
    const float* Kb = Kinv_in + lane * (size_t)(N * N);

    for (int e = tid; e < M * N; e += T) {
        const int r = e / N, c = e - r * N;
        sA[r * NS + c] = Ab[e];
    }
    for (int e = tid; e < N * N; e += T) {
        const int i = e / N, j = e - i * N;
        sK[j * NS + i] = Kb[e];
    }
    for (int j = tid; j < N; j += T) sQ[j] = q_in[lane * N + j];

    // rows of v this thread owns: tid, tid + T, ...
    float v[RPT], z[RPT], lo[RPT], hi[RPT], rho[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
        const int i = tid + r * T;
        const bool ok = i < M;
        v[r] = ok ? v_in[lane * M + i] : 0.0f;
        lo[r] = ok ? l_in[lane * M + i] : 0.0f;
        hi[r] = ok ? u_in[lane * M + i] : 0.0f;
        rho[r] = ok ? rho_in[lane * M + i] : 0.0f;
        z[r] = 0.0f;
    }
    // output column and reduction slice of this thread
    const int gn = (N >= T) ? 0 : tid / N;
    const int jn = tid - gn * N;
    const int gm = (M >= T) ? 0 : tid / M;
    const int im = tid - gm * M;
    __syncthreads();

    for (int it = 0; it < iters; ++it) {
        // z = clip(v, l, u); w = rho (2 z - v)
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
            const int i = tid + r * T;
            if (i < M) {
                z[r] = clip_nan(v[r], lo[r], hi[r]);
                sW[i] = rho[r] * (2.0f * z[r] - v[r]);
            }
        }
        __syncthreads();

        // rhs = A^T w - q : column j, rows of slice gn
        if (gn < GN) {
            const int i0 = gn * CH_M;
            const int i1 = (i0 + CH_M < M) ? i0 + CH_M : M;
            for (int j = jn; j < N; j += T) {
                float acc = 0.0f;
                for (int i = i0; i < i1; ++i) acc = fmaf(sA[i * NS + j], sW[i], acc);
                sP[gn * N + j] = acc;
            }
        }
        __syncthreads();
        for (int j = tid; j < N; j += T) {
            float acc = sP[j];
#pragma unroll
            for (int g = 1; g < GN; ++g) acc += sP[g * N + j];
            sR[j] = acc - sQ[j];
        }
        __syncthreads();

        // x = Kinv rhs : output i = jn, columns of slice gn (rows of Kinv^T)
        if (gn < GN) {
            const int k0 = gn * CH_K;
            const int k1 = (k0 + CH_K < N) ? k0 + CH_K : N;
            for (int i = jn; i < N; i += T) {
                float acc = 0.0f;
                for (int k = k0; k < k1; ++k) acc = fmaf(sK[k * NS + i], sR[k], acc);
                sP[gn * N + i] = acc;
            }
        }
        __syncthreads();
        for (int i = tid; i < N; i += T) {
            float acc = sP[i];
#pragma unroll
            for (int g = 1; g < GN; ++g) acc += sP[g * N + i];
            sX[i] = acc;
        }
        __syncthreads();

        // A x : row i, columns of slice gm
        if (gm < GM) {
            const int k0 = gm * CH_X;
            const int k1 = (k0 + CH_X < N) ? k0 + CH_X : N;
            for (int i = im; i < M; i += T) {
                float acc = 0.0f;
                for (int k = k0; k < k1; ++k) acc = fmaf(sA[i * NS + k], sX[k], acc);
                sP[gm * M + i] = acc;
            }
        }
        __syncthreads();

        // v += alpha (A x - z)
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
            const int i = tid + r * T;
            if (i < M) {
                float ax = sP[i];
#pragma unroll
                for (int g = 1; g < GM; ++g) ax += sP[g * M + i];
                v[r] += alpha * (ax - z[r]);
            }
        }
        // No barrier here: the next writes are to sW (last read before the
        // second barrier of this iteration) and, after the next barrier, to
        // sP, which every thread has then finished reading.
    }

#pragma unroll
    for (int r = 0; r < RPT; ++r) {
        const int i = tid + r * T;
        if (i < M) v_out[lane * M + i] = v[r];
    }
    // sX was written before the last two barriers of the last iteration
    for (int i = tid; i < N; i += T) x_out[lane * N + i] = sX[i];
}

}  // namespace

extern "C" {

int blf_admm_lane_smem_bytes() { return (int)SMEM_BYTES; }

const char* blf_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
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
