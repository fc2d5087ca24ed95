// Batched inverse of small SPD matrices for NVIDIA Hopper (sm_90a), f32.
//
// Replaces the TPU kernel blf_tpu/ops/pallas/linalg.py:61 _inverse_kernel
// over _chol_into (:40; entry cholesky_inverse_lane, pallas_call at :136).
// For every matrix K (n, n) of a batch:
//
//     K = L L^T          left-looking Cholesky, column by column
//     Linv = L^-1        forward substitution, row by row
//     Kinv = Linv^T Linv
//
// all three in this kernel's body. A matrix that is not positive definite, or
// holds a NaN or an infinity (a pivot s with !(s > 0) or s = inf), gives NaN
// in its whole output and touches no other matrix: failure stays per-lane
// data, as in the reference.
//
// What bounds it on an H100. A matrix is read once and its inverse written
// once, 8 n^2 bytes, against n^3 / 3 FMAs (n^3 / 6 for the factor, n^3 / 6
// for L^-1, n^3 / 6 for one triangle of the product): 43.7 K FMAs at n = 64,
// 340 SM-cycles at 128 a clock. Neither bytes nor FMAs set the time: every
// phase is a chain of dependent steps (n columns, n rows), so latency does,
// and the cure is short chains and many matrices in flight. The first design
// of this kernel (one block of 128 threads a matrix, six an SM: 0.667 ms at
// n = 64, B 4096, some 255 K cycles a matrix) repeated each pivot in every
// thread, left half of its threads idle in the factor and in L^-1 (thread 0
// walked 2,016 dependent FMAs of L^-1 alone), paid a block barrier a column,
// and formed the product one shared-memory word an FMA.
//
// Design:
//  * One warp a matrix, one matrix a block: no block barrier anywhere, only
//    warp barriers. The matrix lives in shared memory once (n x NS floats,
//    NS the least stride >= n with NS = 4 mod 8: 17 KB at n = 64, 4.5 KB at
//    n = 29), so 12 matrices share an SM at n = 64 and 32 at n = 29, and
//    their chains overlap on the SM's four schedulers (on an H100 at n = 64,
//    B 4096, 6 and 8 an SM took 0.43 and 0.33 ms against 0.28; 22, with two
//    matrices sharing one buffer, only 4 % less: past 12 the SM's issue, not
//    latency, sets the time). L overwrites K's lower triangle and L^-1 overwrites L; the
//    upper triangle is zero.
//  * Cholesky, column j: lane l owns rows l, l + 32, ... For each of them it
//    keeps the running remainder K[i][i] - sum_k<j L[i][k]^2 in a register,
//    so the pivot s_j is formed once, by its row's owner, and handed over by
//    one shuffle; every lane then takes d = 1 / sqrtf(s_j) (IEEE). Rows i > j
//    form L[i][j] = (K[i][j] - L[i][:j] . L[j][:j]) d with 16-byte loads of
//    both rows (the pivot row a broadcast; NS = 4 mod 8 keeps the 8 rows of a
//    load phase on distinct banks) into four partial sums, so a chain is j/4
//    FMAs long. Columns go 32 at a time, so rows already done are left out
//    at compile time, not masked.
//  * L^-1, row i: lane l owns columns l, l + 32, ...: Linv[i][c] = (delta_ic -
//    L[i][c:i] . Linv[c:i][c]) / L[i][i], the row of L a broadcast 16-byte
//    load, the columns of Linv one conflict-free word per lane, four partial
//    sums; 1 / L[i][i] is formed in the factor, off this chain, and kept on
//    the diagonal. Every lane works on every row it can (no thread walks a
//    whole column alone); each row is written after a warp barrier.
//  * Linv^T Linv: the lower triangle in 4 x 4 tiles, handed round-robin in
//    order of decreasing length; a tile is 16 register sums fed by two
//    16-byte loads a step (8 FMAs a load, not 1). Each tile writes (i, j) and
//    (j, i) from the same sum, and a diagonal tile forms (i, j) and (j, i)
//    from the same products in the same order, so the output is symmetric bit
//    for bit. Exact f32 FMAs, no tensor cores.
//  * d = 1 / sqrtf(s) in IEEE arithmetic (no rsqrtf, no -use_fast_math), and
//    L[j][j] = s d, L[i][j] = (..) d, Linv[i][.] = (..) (1 / L[i][i]) as the
//    reference forms them; the sums run in another order.
//
// The batched solve (chol_solve.cu) carries its own factorization: one thread
// a matrix for small n, this kernel's warp form past it.
//
// n is a compile-time constant (-DCHOL_N=..): ops/cuda/_build.py compiles one
// library per n at first use. Any n >= 1 whose matrix fits in 227 KB of
// shared memory is taken (n <= 238).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (no -use_fast_math).

#include <cuda_runtime.h>
#include <math_constants.h>

#ifndef CHOL_N
#error "compile with -DCHOL_N=<matrix size>"
#endif

namespace {

constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

constexpr int N = CHOL_N;
constexpr int NS = N + ((12 - N % 8) % 8);   // least stride >= N with NS = 4 mod 8
constexpr int RPL = cdiv(N, 32);             // rows (columns) a lane owns
constexpr int NB = cdiv(N, 4);               // 4-wide blocks of the product
constexpr int TILES = NB * (NB + 1) / 2;     // lower-triangle tiles
constexpr int LOAD_BATCH = (cdiv(N * N, 32) < 32) ? cdiv(N * N, 32) : 32;  // loads in flight
constexpr size_t SMEM_BYTES = sizeof(float) * (size_t)N * NS;
constexpr unsigned FULL = 0xffffffffu;

static_assert(N >= 1, "empty matrix");
static_assert(NS % 8 == 4 && NS >= 4 * NB, "stride");
static_assert(SMEM_BYTES <= 232448, "matrix does not fit in shared memory");

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__global__ void __launch_bounds__(32)
chol_inverse_kernel(const float* __restrict__ K_in, float* __restrict__ Kinv_out) {
    extern __shared__ __align__(16) float sM[];     // [N][NS]
    const int ln = threadIdx.x;
    const float* Kb = K_in + (size_t)blockIdx.x * N * N;
    float* Ob = Kinv_out + (size_t)blockIdx.x * N * N;

    // K's lower triangle; zero above the diagonal and in the padding. Loads
    // go out up to 32 a lane before their stores, so their latencies overlap.
    for (int e0 = 0; e0 < N * N; e0 += 32 * LOAD_BATCH) {
        float t[LOAD_BATCH];
#pragma unroll
        for (int u = 0; u < LOAD_BATCH; ++u) {
            const int e = e0 + ln + 32 * u;
            t[u] = (e < N * N) ? Kb[e] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < LOAD_BATCH; ++u) {
            const int e = e0 + ln + 32 * u;
            if (e < N * N) {
                const int r = e / N, c = e - r * N;
                sM[r * NS + c] = (c <= r) ? t[u] : 0.0f;
            }
        }
    }
    for (int e = ln; e < N * (NS - N); e += 32) {
        const int r = e / (NS - N);
        sM[r * NS + N + (e - r * (NS - N))] = 0.0f;
    }
    __syncwarp();

    // running remainders K[i][i] - sum_k<j L[i][k]^2 of the lane's rows
    float dr[RPL];
#pragma unroll
    for (int t = 0; t < RPL; ++t) {
        const int i = ln + 32 * t;
        dr[t] = (i < N) ? sM[i * NS + i] : 1.0f;
    }
    bool bad = false;

    // -- K = L L^T, left-looking, 32 columns at a time: in block jb the
    // pivot's owner holds it in slot jb and rows of slots < jb are done
#pragma unroll
    for (int jb = 0; jb < RPL; ++jb) {
        const int jend = (32 * jb + 32 < N) ? 32 * jb + 32 : N;
        for (int j = 32 * jb; j < jend; ++j) {
            const float s = __shfl_sync(FULL, dr[jb], j & 31);   // the pivot, from its owner
            const float d = 1.0f / sqrtf(s);
            bad = bad || !(s > 0.0f) || s == CUDART_INF_F;

            const float* pj = sM + j * NS;
            float acc[RPL][4];
#pragma unroll
            for (int t = jb; t < RPL; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;
            int k = 0;
#pragma unroll 4
            for (; k + 4 <= j; k += 4) {
                const float4 b = ld4(pj + k);
#pragma unroll
                for (int t = jb; t < RPL; ++t) {
                    const int i = ln + 32 * t;
                    if (i > j && i < N) {
                        const float4 a = ld4(sM + i * NS + k);
                        acc[t][0] = fmaf(a.x, b.x, acc[t][0]);
                        acc[t][1] = fmaf(a.y, b.y, acc[t][1]);
                        acc[t][2] = fmaf(a.z, b.z, acc[t][2]);
                        acc[t][3] = fmaf(a.w, b.w, acc[t][3]);
                    }
                }
            }
            for (; k < j; ++k) {
                const float b = pj[k];
#pragma unroll
                for (int t = jb; t < RPL; ++t) {
                    const int i = ln + 32 * t;
                    if (i > j && i < N) acc[t][0] = fmaf(sM[i * NS + k], b, acc[t][0]);
                }
            }
#pragma unroll
            for (int t = jb; t < RPL; ++t) {
                const int i = ln + 32 * t;
                if (i > j && i < N) {
                    const float dot = (acc[t][0] + acc[t][1]) + (acc[t][2] + acc[t][3]);
                    const float lij = (sM[i * NS + j] - dot) * d;
                    sM[i * NS + j] = lij;
                    dr[t] = fmaf(-lij, lij, dr[t]);
                }
            }
            // the diagonal keeps 1 / L[j][j] (L[j][j] = s d), which is all that
            // L^-1 needs of it, formed here off L^-1's chain
            if (ln == (j & 31)) sM[j * NS + j] = 1.0f / (s * d);
            __syncwarp();
        }
    }

    // -- Linv = L^-1 in place, row by row; in block ib the columns of slots
    // < ib are all at or left of the diagonal, those of slots > ib right of it
#pragma unroll
    for (int ib = 0; ib < RPL; ++ib) {
        const int iend = (32 * ib + 32 < N) ? 32 * ib + 32 : N;
        for (int i = 32 * ib; i < iend; ++i) {
            const float* li = sM + i * NS;
            const float inv = li[i];                       // 1 / L[i][i]
            float val[RPL];
#pragma unroll
            for (int t = 0; t <= ib; ++t) {
                const int c = ln + 32 * t;
                val[t] = 0.0f;
                if (t < ib || c <= i) {
                    // Linv[k][c] = 0 for k < c: the sum may start at 32 t
                    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
                    int k = 32 * t;
#pragma unroll 4
                    for (; k + 4 <= i; k += 4) {
                        const float4 l4 = ld4(li + k);
                        a0 = fmaf(l4.x, sM[(k + 0) * NS + c], a0);
                        a1 = fmaf(l4.y, sM[(k + 1) * NS + c], a1);
                        a2 = fmaf(l4.z, sM[(k + 2) * NS + c], a2);
                        a3 = fmaf(l4.w, sM[(k + 3) * NS + c], a3);
                    }
                    for (; k < i; ++k) a0 = fmaf(li[k], sM[k * NS + c], a0);
                    const float dot = (a0 + a1) + (a2 + a3);
                    val[t] = (((c == i) ? 1.0f : 0.0f) - dot) * inv;
                }
            }
            __syncwarp();                  // row i of L is read by all first
#pragma unroll
            for (int t = 0; t <= ib; ++t) {
                const int c = ln + 32 * t;
                if (t < ib || c <= i) sM[i * NS + c] = val[t];
            }
            __syncwarp();
        }
    }

    // -- Kinv = Linv^T Linv, lower-triangle 4 x 4 tiles ----------------------
    for (int tile = ln; tile < TILES; tile += 32) {
        // tile = I (I + 1) / 2 + J, J <= I: row-major, longest first
        int I = (int)((sqrtf(8.0f * tile + 1.0f) - 1.0f) * 0.5f);
        while (I * (I + 1) / 2 > tile) --I;
        while ((I + 1) * (I + 2) / 2 <= tile) ++I;
        const int J = tile - I * (I + 1) / 2;
        float acc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
        // Kinv[i][j] = sum_k>=max(i,j) Linv[k][i] Linv[k][j]; Linv[k][i] = 0 for k < i
#pragma unroll 2
        for (int k = 4 * I; k < N; ++k) {
            const float4 a = ld4(sM + k * NS + 4 * I);
            const float4 b = ld4(sM + k * NS + 4 * J);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
        }
        if (bad) {
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[r][c] = CUDART_NAN_F;
        }
        if constexpr (N % 4 == 0) {
            // rows of the tile and of its mirror image, 16 bytes a store
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                *reinterpret_cast<float4*>(Ob + (4 * I + r) * N + 4 * J) =
                    make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
                if (I != J)
                    *reinterpret_cast<float4*>(Ob + (4 * J + r) * N + 4 * I) =
                        make_float4(acc[0][r], acc[1][r], acc[2][r], acc[3][r]);
            }
        } else {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int i = 4 * I + r;
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int j = 4 * J + c;
                    if (i < N && j < N) {
                        Ob[i * N + j] = acc[r][c];
                        if (I != J) Ob[j * N + i] = acc[r][c];
                    }
                }
            }
        }
    }
}

}  // namespace

extern "C" {

int blf_chol_lane_n() { return N; }

int blf_chol_lane_smem_bytes() { return (int)SMEM_BYTES; }

const char* blf_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Registers a thread, local (spill) bytes a thread and blocks (matrices) an
// SM of the compiled kernel. Returns the CUDA error code (0 on success).
int blf_chol_lane_attributes(int* out) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, chol_inverse_kernel);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(chol_inverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, chol_inverse_kernel, 32,
                                                        SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    out[0] = attr.numRegs;
    out[1] = (int)attr.localSizeBytes;
    out[2] = blocks;
    return 0;
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
    chol_inverse_kernel<<<(unsigned)B, 32, SMEM_BYTES, (cudaStream_t)stream>>>(K, Kinv);
    return (int)cudaGetLastError();
}

}  // extern "C"
