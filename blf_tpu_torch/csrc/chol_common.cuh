// Left-looking Cholesky of one small SPD matrix in shared memory, f32.
//
// The factorization shared by the batched SPD inverse (chol_lane.cu, which
// replaces blf_tpu/ops/pallas/linalg.py::_inverse_kernel) and the batched SPD
// solve (chol_solve.cu, which replaces ::_solve_kernel): both TPU kernels run
// the same _chol_into, and so do these two through this header.
//
// One block factors one matrix. The matrix lies in shared memory, rows padded
// to a stride of NS floats; column j of the factor is formed in place below
// the diagonal:
//
//     s = K[j][j] - sum_k<j L[j][k]^2       every thread forms the pivot itself
//     d = 1 / sqrtf(s)                       (a broadcast read of row j: no
//     L[j][j] = s d  -> diag[j]               extra barrier for the pivot)
//     L[i][j] = (K[i][j] - sum_k<j L[i][k] L[j][k]) d     thread i > j
//
// then one barrier a column. The diagonal of the shared matrix keeps K's
// values; L[j][j] goes to diag[j]. IEEE arithmetic throughout: 1 / sqrtf, no
// rsqrtf, and the files that include this are built without -use_fast_math.
// A pivot with !(s > 0) or s = inf (not positive definite, a NaN or an
// infinity in the matrix) sets *bad: the caller then writes NaN over the
// matrix's whole output, so failure stays per-lane data.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace blf {

template <int N, int NS, int THREADS>
__device__ __forceinline__ void chol_columns(float* sL, float* diag, int* bad, int tid) {
    for (int j = 0; j < N; ++j) {
        // row j of L is final (columns < j), so every thread can form the pivot
        float s = sL[j * NS + j];
        for (int k = 0; k < j; ++k) {
            const float ljk = sL[j * NS + k];
            s -= ljk * ljk;
        }
        const float d = 1.0f / sqrtf(s);
        if (tid == 0) {
            if (!(s > 0.0f) || s == CUDART_INF_F) *bad = 1;
            diag[j] = s * d;
        }
        for (int i = j + 1 + tid; i < N; i += THREADS) {
            float r = sL[i * NS + j];
            for (int k = 0; k < j; ++k) r -= sL[i * NS + k] * sL[j * NS + k];
            sL[i * NS + j] = r * d;
        }
        __syncthreads();   // column j is final before column j + 1 reads it
    }
}

}  // namespace blf
