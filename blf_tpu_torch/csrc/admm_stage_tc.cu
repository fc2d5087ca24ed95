// Fused shared-operator v-space ADMM stage on Hopper's tensor cores (sm_90a):
// the reduced-precision matmul modes "split" and "delta".
//
// Replaces the TPU kernel blf_tpu/ops/pallas/admm.py::_stage_kernel_t (entry
// admm_stage_t / admm_stage) for matmul="split" and matmul="delta"; the exact
// f32 mode is csrc/admm_stage.cu. One launch runs `iters` iterations, at a
// fixed per-lane penalty multiplier s, of
//
//     z   = clip(v, l, u)
//     w   = 2 z - v
//     t   = Gt w                      Gt = (rho . G2)^T, (n, m)
//     tau = (t - gq / s) * s / (1 + s d)
//     v  += alpha (G2 tau - z)
//
// for every lane of a fleet that shares one operator G2 (m, n). Every product
// is a sum of products of bf16 pairs taken on the tensor cores with f32
// accumulation, as the reference's bf16 matrix-unit passes are
// (admm.py:93-135):
//  * the operators are split once, hi = bf16(x), lo = bf16(x - hi), with rho
//    folded into Gt before its split (admm.py:172-176, :326);
//  * "split": every product is A_hi b_hi + A_hi b_lo + A_lo b_hi, b being the
//    iterate's own split (admm.py:234-255);
//  * "delta": iteration 1 takes those 3-pass products; every later one adds
//    A_hi dw + A_lo dw into the f32 carries t_acc and u_acc, with
//    dw = bf16(w - w_prev) and dtau = bf16(tau - tau_prev) (admm.py:197-233).
// A product of two bf16 values is exact in f32, so the kernel parts from its
// plain version (ops/cuda/admm.py) only by the order of its f32 sums. The
// elementwise steps use __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, so no
// multiply-add is contracted where the plain version rounds twice, and
// s/(1 + s d) and gq/s are IEEE divisions (no -use_fast_math).
//
// What bounds it on an H100. One 3-pass product at (m, n, B) = (192, 128,
// 98304) is 3 * 2mnB = 1.45e10 flop; a stage of 25 iterations is 102 passes
// (delta) or 150 (split) of 2mnB flop each, 0.50 / 0.73 ms at the 989 TFLOP/s
// bf16 dense peak. The elementwise work (clip, w, the splits, tau, the v
// update; some 25 f32 operations an element of v or tau an iteration) and the
// device-memory traffic (each input read once, each output written once:
// 4.6 KB a lane) are below that. So the tensor cores bound it, and the design
// feeds them from shared memory and keeps everything else in registers.
//
// Design (each choice with its reason):
//  * wgmma.mma_async m64n16k16, bf16 in, f32 accumulate, both operands read
//    from shared memory through matrix descriptors: it is the only way to the
//    tensor cores' full rate on Hopper.
//  * Batch-minor tiles, as the TPU kernel chose: the operator is wgmma's A
//    (M = its rows, n = 2 x 64 and m = 3 x 64 at horizon 32, so the production
//    shape is 64-aligned on both products), a tile of 16 lanes is N, the
//    contraction is K. Lane-major tiles (lanes as M) would need 64 lanes a
//    warpgroup, and the per-lane state of 64 lanes does not fit in registers.
//  * Layout (a): both bf16 pairs stay in shared memory for the block's life,
//    Gt (n, m) and G2 (m, n), 96 KB each at (192, 128), K-major in wgmma's
//    no-swizzle canonical layout (8 x 16-byte core matrices, 128 contiguous
//    bytes each: a core matrix is read without bank conflicts). Each is
//    loaded and split once a block. Rows past n or m and columns past the
//    16-padded contraction are zero in shared memory only.
//  * Two warpgroups a block (256 threads), each walking its own tiles of 16
//    lanes: one warpgroup's elementwise work overlaps the other's products,
//    and they never wait for each other. "split" gives each a 12 KB operand
//    buffer (the bf16 hi and lo of w, then of tau: 192 + 2 x 12 = 216 KB of
//    the 227), so separate w and tau buffers (20 KB each) do not fit: a
//    warpgroup barrier after each product's wait keeps the buffer's next
//    write behind every warp's reads of it. "delta" has a 6 KB buffer, through
//    which hi and lo pass in turn in its first iteration.
//  * Persistent blocks: one block an SM, min(SMs, tiles / 2) of them, so the
//    operators are loaded and split once an SM, not once a tile. While a tile
//    iterates, its warpgroup asks L2 to prefetch the next tile's v, l, u, gq
//    and s (prefetch.global.L2), so the next tile's loads find them there.
//  * The elementwise work runs in registers on the accumulator fragments: a
//    thread owns the same 4 lanes in both products (wgmma's f32 fragment of
//    m64n16: rows 16 w + g (+ 8), lanes 2 q (+ 1) (+ 8)), with v, l, u, gq/s
//    and s/(1 + s d) for its elements. "delta" also carries t_acc, u_acc and
//    w_prev; to stay within 255 registers without spilling it keeps gq/s in
//    shared memory (8 KB a warpgroup, each thread its own column) and forms
//    tau from t_acc where it is needed.
//  * "delta"'s increments are summed on the tensor cores from zero and added
//    to the f32 carries in round-to-nearest, as the plain version adds them.
//    Accumulated into the carries in place (scale-d = 1), their products lost
//    their low bits against the large carry, always towards zero, and the
//    cold first tick of bench.py's workload converged 91 % of lanes against
//    the plain version's 96 % (PERF.md).
//  * Descriptors and buffer addresses are made where they are used (opaque),
//    not hoisted into registers of their own; registers, shared memory and
//    spills: ptxas -v, PERF.md.
//  * clip is written with comparisons and passes on a NaN of v, l or u, as
//    jnp.clip does; a product never mixes lanes (a lane is a column of B), so
//    a poisoned lane poisons nothing else.
//  * Any B >= 1: lanes past B are loaded as zeros (s = 1) and never stored;
//    the batch is never padded in device memory.
//
// The shape (m, n) and the mode are compile-time constants (-DADMM_M=..
// -DADMM_N=.. -DADMM_DELTA=0|1): ops/cuda/_build.py compiles one library per
// (m, n, mode) at first use.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC -Xptxas -v (no -use_fast_math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef ADMM_M
#error "compile with -DADMM_M=<rows of G2>"
#endif
#ifndef ADMM_N
#error "compile with -DADMM_N=<columns of G2>"
#endif
#ifndef ADMM_DELTA
#error "compile with -DADMM_DELTA=0 (split) or 1 (delta)"
#endif

namespace {

typedef __nv_bfloat16 bf16;

constexpr int M = ADMM_M;
constexpr int N = ADMM_N;
constexpr bool DELTA = ADMM_DELTA != 0;
constexpr int LT = 16;                   // lanes of a tile: wgmma's N
constexpr int WGS = 2;                   // warpgroups a block
constexpr int THREADS = 128 * WGS;
constexpr int MT1 = (N + 63) / 64;       // 64-row tiles of t = Gt w (n rows)
constexpr int MT2 = (M + 63) / 64;       // 64-row tiles of G2 tau (m rows)
constexpr int K1 = (M + 15) / 16 * 16;   // contraction of t, padded to wgmma's k
constexpr int K2 = (N + 15) / 16 * 16;   // contraction of G2 tau
constexpr int KB = K1 > K2 ? K1 : K2;
constexpr int R1 = 64 * MT1;
constexpr int R2 = 64 * MT2;
constexpr int GT_ELEMS = R1 * K1;        // bf16 elements of one half of Gt's pair
constexpr int G2_ELEMS = R2 * K2;
constexpr int B_ELEMS = LT * KB;         // one bf16 operand of LT lanes
// "split" keeps the hi and lo halves of its operand side by side; "delta"
// passes them through one buffer in turn (in iteration 1 only) and keeps
// gq / s of each thread's fragment in shared memory instead of registers
constexpr int B_HALVES = DELTA ? 1 : 2;
constexpr int GQS_FLOATS = DELTA ? MT1 * 8 * 128 : 0;   // a warpgroup's gq / s
constexpr size_t SMEM_BYTES =
    sizeof(bf16) * (2 * (size_t)GT_ELEMS + 2 * (size_t)G2_ELEMS + WGS * B_HALVES * (size_t)B_ELEMS)
    + sizeof(float) * WGS * (size_t)GQS_FLOATS;

static_assert(M >= 1 && N >= 1, "empty operator");
static_assert(SMEM_BYTES <= 232448, "operators and operand buffers do not fit in shared memory");
static_assert(K1 <= 16383 && K2 <= 16383, "stride does not fit a matrix descriptor");

// Element (r, k) of a K-major operand with K (a multiple of 16) columns, in
// wgmma's no-swizzle canonical layout: 8-row x 8-column core matrices of 128
// contiguous bytes, row r % 8 at 16-byte stride inside one; the core matrix
// next along k lies 128 bytes on (LBO), the one next along r K * 16 bytes on
// (SBO).
template <int K>
__device__ __forceinline__ int kmajor(int r, int k) {
    return (((r >> 3) * (K >> 3) + (k >> 3)) << 6) + ((r & 7) << 3) + (k & 7);
}

// Matrix descriptor of a K-major, no-swizzle operand starting at shared
// address `addr`.
template <int K>
__device__ __forceinline__ uint64_t descriptor(uint32_t addr) {
    constexpr uint64_t LBO = 128;                 // bytes to the next core matrix along k
    constexpr uint64_t SBO = (uint64_t)K * 16;    // bytes to the next 8 rows
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((LBO >> 4) << 16) | ((SBO >> 4) << 32);
    // base offset 0 and layout type 0 (no swizzle) in bits 49-51 and 62-63
}

// Shared-memory accesses by 32-bit shared address: a generic pointer of its
// own for each buffer would cost two registers a buffer in the iteration loop.
__device__ __forceinline__ void st_bf16(uint32_t addr, bf16 x) {
    asm volatile("st.shared.b16 [%0], %1;\n" :: "r"(addr), "h"(__bfloat16_as_ushort(x)) : "memory");
}
__device__ __forceinline__ void st_f32(uint32_t addr, float x) {
    asm volatile("st.shared.f32 [%0], %1;\n" :: "r"(addr), "f"(x) : "memory");
}
__device__ __forceinline__ float ld_f32(uint32_t addr) {
    float x;
    asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(addr) : "memory");
    return x;
}

// D (64 x 16, f32) += A (64 x 16) B (16 x 16), bf16, both from shared memory.
__device__ __forceinline__ void wgmma_m64n16k16(float (&d)[8], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Make this thread's ordinary shared-memory stores visible to wgmma's reads.
__device__ __forceinline__ void fence_shared_to_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Barrier of one warpgroup's 128 threads (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void warpgroup_barrier(int id) {
    asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void prefetch_l2(const void* p) {
    asm volatile("prefetch.global.L2 [%0];\n" :: "l"(p));
}

// Keep the compiler from moving accesses of accumulator registers across the
// asynchronous products.
template <int MT>
__device__ __forceinline__ void fence_registers(float (&acc)[MT][8]) {
#pragma unroll
    for (int a = 0; a < MT; ++a)
#pragma unroll
        for (int i = 0; i < 8; ++i) asm volatile("" : "+f"(acc[a][i]) :: "memory");
}

// min(max(v, l), u) in which a NaN in any operand gives NaN.
__device__ __forceinline__ float clip_nan(float v, float l, float u) {
    float z = (v < l) ? l : v;
    z = (z > u) ? u : z;
    return (l != l || u != u) ? (l + u) : z;
}

__device__ __forceinline__ void split(float x, bf16& hi, bf16& lo) {
    hi = __float2bfloat16_rn(x);
    lo = __float2bfloat16_rn(__fsub_rn(x, __bfloat162float(hi)));
}

// An opaque copy of x: values derived from it are computed where they are
// used, never hoisted out of the iteration loop into registers of their own
// (at (192, 128) the hoisted descriptors and buffer addresses would spill).
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
    asm volatile("" : "+l"(x));
    return x;
}
__device__ __forceinline__ int opaque(int x) {
    asm volatile("" : "+r"(x));
    return x;
}

// acc[a] += sum over the NP passes j of A_j B_j, over the MT row tiles of A
// (R rows, K columns) and the K/16 steps of the contraction; issued,
// committed and waited for. Every thread of the warpgroup calls it. A
// descriptor advances by its start address in 16-byte units: by 16 to the
// next k step (two core matrices), by 8 K to the next row tile. Each next
// descriptor is made from the last one after its wgmma (opaque), so that two
// are live at a time and not one for each of the product's wgmmas.
template <int NP, int MT, int K>
__device__ __forceinline__ void product(float (&acc)[MT][8], const uint32_t (&a)[NP],
                                        const uint32_t (&b)[NP]) {
    fence_registers(acc);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int j = 0; j < NP; ++j) {
            uint64_t da = opaque(descriptor<K>(a[j]) + (uint64_t)(8 * K * t));
            uint64_t db = opaque(descriptor<K>(b[j]));
#pragma unroll
            for (int ks = 0; ks < K / 16; ++ks) {
                wgmma_m64n16k16(acc[t], da, db);
                da = opaque(da + 16);
                db = opaque(db + 16);
            }
        }
    wgmma_commit();
    wgmma_wait_all();
    fence_registers(acc);
}

// carry[t] += A_hi b + A_lo b, one row tile at a time: the product of the
// increment is summed on the tensor cores from zero, then added to the f32
// carry in round-to-nearest, as the plain version does. Accumulating it into
// the carry itself (scale-d = 1) drops the low bits of the small increment's
// products against the large carry on every k step, always towards zero: on
// the cold first tick of bench.py's workload that bias left 91 % of lanes
// converged against the plain version's 96 % (PERF.md).
template <int MT, int K>
__device__ __forceinline__ void increment(float (&carry)[MT][8], uint32_t a_hi,
                                          uint32_t a_lo, uint32_t b) {
#pragma unroll
    for (int t = 0; t < MT; ++t) {
        float part[1][8] = {{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}};
        const uint32_t row = 2 * kmajor<K>(64 * t, 0);     // bytes to row tile t
        product<2, 1, K>(part, {a_hi + row, a_lo + row}, {b, b});
#pragma unroll
        for (int i = 0; i < 8; ++i) carry[t][i] = __fadd_rn(carry[t][i], part[0][i]);
    }
}

template <int MT>
__device__ __forceinline__ void zero(float (&acc)[MT][8]) {
#pragma unroll
    for (int a = 0; a < MT; ++a)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[a][i] = 0.0f;
}

// What a warpgroup holds in registers for its tile of LT lanes, in wgmma's
// m64n16 f32 fragment: element i of row tile a is (row 64 a + rbase +
// 8 ((i >> 1) & 1), lane cbase + 8 (i >> 2) + (i & 1)). "delta" carries
// t_acc and u_acc besides w_prev, and keeps below 255 registers without
// spilling by holding gq / s in shared memory and forming tau from t_acc
// where it is used (the same operations on the same values: the same bits
// as a stored tau).
struct Tile {
    float v[MT2][8], lo[MT2][8], up[MT2][8];   // iterate and bounds, m rows
    float t_acc[MT1][8], u_acc[MT2][8];        // the products ("delta": the carries)
    float sdinv[MT1][8];                       // s / (1 + s d), n rows
    float gqs[DELTA ? 1 : MT1][8];             // gq / s ("split")
    float tau[DELTA ? 1 : MT1][8];             // this iteration's tau ("split")
    float w_prev[DELTA ? MT2 : 1][8];          // "delta": the last w
};

struct Operands {
    uint32_t gt_hi, gt_lo, g2_hi, g2_lo;  // the operators' bf16 pairs (shared addresses)
    uint32_t b_hi, b_lo;                  // this warpgroup's operand ("delta": b_hi only)
    uint32_t gqs;                         // "delta": gq / s, [MT1 * 8][128] f32
    int t, rbase, cbase, bar;
};

__device__ __forceinline__ int frag_row(const Operands& o, int a, int i) {
    return 64 * a + o.rbase + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int frag_lane(const Operands& o, int i) {
    return o.cbase + 8 * (i >> 2) + (i & 1);
}
// s / (1 + s d) of row `row` (0 past n), in IEEE arithmetic
__device__ __forceinline__ float spectral_gain(float s, int row, const float* d) {
    return row < N ? __fdiv_rn(s, __fadd_rn(1.0f, __fmul_rn(s, d[row]))) : 0.0f;
}
// tau = (t - gq/s) s/(1 + s d) of element i of row tile a
__device__ __forceinline__ float tau_of(const Tile& x, const Operands& o, int a, int i) {
    const float q = DELTA ? ld_f32(o.gqs + 4 * ((8 * a + i) * 128 + o.t))
                          : x.gqs[DELTA ? 0 : a][i];
    return __fmul_rn(__fsub_rn(x.t_acc[a][i], q), x.sdinv[a][i]);
}

__device__ __forceinline__ float clip_w(const Tile& x, int a, int i, float& z) {
    z = clip_nan(x.v[a][i], x.lo[a][i], x.up[a][i]);
    return __fsub_rn(__fmul_rn(2.0f, z), x.v[a][i]);     // w = 2 z - v
}

// Store this thread's part of the operand, part(a, i, row) being element i of
// row tile a, into the buffer as the K-major bf16 B of a product of
// contraction K; rows past the contraction are not stored. Then make the
// stores visible to wgmma and wait for the warpgroup's other threads.
template <int K, int MT, typename Part>
__device__ __forceinline__ void put(const Operands& o, Part part) {
#pragma unroll
    for (int a = 0; a < MT; ++a)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int row = frag_row(o, a, i);
            if (row < K) part(a, i, 2 * kmajor<K>(frag_lane(o, i), row));
        }
    fence_shared_to_async();
    warpgroup_barrier(o.bar);
}

// One iteration. THREE: 3-pass products of the full w and tau ("split", and
// iteration 1 of "delta"); else 2-pass products of their bf16 increments.
template <bool THREE>
__device__ __forceinline__ void iteration(Tile& x, const Operands& ops, float alpha) {
    Operands o = ops;
    o.rbase = opaque(o.rbase);
    o.cbase = opaque(o.cbase);
    float z;

    // t = Gt w
    if (THREE) zero(x.t_acc);
    if (THREE && !DELTA) {
        put<K1, MT2>(o, [&](int a, int i, int idx) {
            bf16 hi, lo;
            split(clip_w(x, a, i, z), hi, lo);
            st_bf16(o.b_hi + idx, hi);
            st_bf16(o.b_lo + idx, lo);
        });
        product<3, MT1, K1>(x.t_acc, {o.gt_hi, o.gt_hi, o.gt_lo}, {o.b_hi, o.b_lo, o.b_hi});
    } else if (THREE) {
        // one buffer: A_hi w_hi + A_lo w_hi, then A_hi w_lo
        put<K1, MT2>(o, [&](int a, int i, int idx) {
            const float w = clip_w(x, a, i, z);
            st_bf16(o.b_hi + idx, __float2bfloat16_rn(w));
            x.w_prev[DELTA ? a : 0][i] = w;
        });
        product<2, MT1, K1>(x.t_acc, {o.gt_hi, o.gt_lo}, {o.b_hi, o.b_hi});
        warpgroup_barrier(o.bar);
        put<K1, MT2>(o, [&](int a, int i, int idx) {
            bf16 hi, lo;
            split(x.w_prev[DELTA ? a : 0][i], hi, lo);
            st_bf16(o.b_hi + idx, lo);
        });
        product<1, MT1, K1>(x.t_acc, {o.gt_hi}, {o.b_hi});
    } else {
        put<K1, MT2>(o, [&](int a, int i, int idx) {
            const float w = clip_w(x, a, i, z);
            st_bf16(o.b_hi + idx, __float2bfloat16_rn(__fsub_rn(w, x.w_prev[DELTA ? a : 0][i])));
            x.w_prev[DELTA ? a : 0][i] = w;
        });
        // A_hi dw + A_lo dw, summed from zero (see increment); then, once every
        // warp has read the buffer, t_acc += it and dtau = bf16(tau - tau_prev)
        float part[MT1][8];
        zero(part);
        product<2, MT1, K1>(part, {o.gt_hi, o.gt_lo}, {o.b_hi, o.b_hi});
        warpgroup_barrier(o.bar);
        put<K2, MT1>(o, [&](int a, int i, int idx) {
            const float prev = tau_of(x, o, a, i);
            x.t_acc[a][i] = __fadd_rn(x.t_acc[a][i], part[a][i]);
            st_bf16(o.b_hi + idx, __float2bfloat16_rn(__fsub_rn(tau_of(x, o, a, i), prev)));
        });
        // rows past the contraction, never stored, still carry the sum
#pragma unroll
        for (int a = 0; a < MT1; ++a)
#pragma unroll
            for (int i = 0; i < 8; ++i)
                if (frag_row(o, a, i) >= K2) x.t_acc[a][i] = __fadd_rn(x.t_acc[a][i], part[a][i]);
    }
    if (THREE) warpgroup_barrier(o.bar);   // every warp's products have read the buffer

    // tau = (t - gq/s) s/(1 + s d); u = G2 tau
    if (THREE) zero(x.u_acc);
    if (THREE && !DELTA) {
        put<K2, MT1>(o, [&](int a, int i, int idx) {
            x.tau[DELTA ? 0 : a][i] = tau_of(x, o, a, i);
            bf16 hi, lo;
            split(x.tau[DELTA ? 0 : a][i], hi, lo);
            st_bf16(o.b_hi + idx, hi);
            st_bf16(o.b_lo + idx, lo);
        });
        product<3, MT2, K2>(x.u_acc, {o.g2_hi, o.g2_hi, o.g2_lo}, {o.b_hi, o.b_lo, o.b_hi});
    } else if (THREE) {
        put<K2, MT1>(o, [&](int a, int i, int idx) {
            st_bf16(o.b_hi + idx, __float2bfloat16_rn(tau_of(x, o, a, i)));
        });
        product<2, MT2, K2>(x.u_acc, {o.g2_hi, o.g2_lo}, {o.b_hi, o.b_hi});
        warpgroup_barrier(o.bar);
        put<K2, MT1>(o, [&](int a, int i, int idx) {
            bf16 hi, lo;
            split(tau_of(x, o, a, i), hi, lo);
            st_bf16(o.b_hi + idx, lo);
        });
        product<1, MT2, K2>(x.u_acc, {o.g2_hi}, {o.b_hi});
    } else {
        increment<MT2, K2>(x.u_acc, o.g2_hi, o.g2_lo, o.b_hi);
    }
    warpgroup_barrier(o.bar);

    // v += alpha (G2 tau - z)
#pragma unroll
    for (int a = 0; a < MT2; ++a)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            clip_w(x, a, i, z);
            x.v[a][i] = __fadd_rn(x.v[a][i], __fmul_rn(alpha, __fsub_rn(x.u_acc[a][i], z)));
        }
}

// Ask L2 for `bytes` bytes from p on, one 128-byte line a thread at a time.
__device__ __forceinline__ void prefetch_range(const float* p, long long bytes, int t) {
    for (long long off = 128LL * t; off < bytes; off += 128LL * 128)
        prefetch_l2(reinterpret_cast<const char*>(p) + off);
}

__global__ void __launch_bounds__(THREADS, 1)
admm_stage_tc_kernel(const float* __restrict__ v_in, const float* __restrict__ s_in,
                     const float* __restrict__ gq_in, const float* __restrict__ l_in,
                     const float* __restrict__ u_in, const float* __restrict__ G2,
                     const float* __restrict__ d_in, const float* __restrict__ rho_in,
                     float* __restrict__ v_out, float* __restrict__ tau_out,
                     long long B, int iters, float alpha) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    bf16* sGt_hi = reinterpret_cast<bf16*>(smem_raw);   // [R1 x K1] (rho . G2)^T
    bf16* sGt_lo = sGt_hi + GT_ELEMS;
    bf16* sG2_hi = sGt_lo + GT_ELEMS;                   // [R2 x K2] G2
    bf16* sG2_lo = sG2_hi + G2_ELEMS;
    const int wg = threadIdx.x >> 7;

    // The operators, split once a block; reads run along G2's rows.
    for (int e = threadIdx.x; e < GT_ELEMS; e += THREADS) {
        const int k = e / R1, r = e - k * R1;          // Gt[r][k] = rho[k] G2[k][r]
        const float x = (r < N && k < M) ? __fmul_rn(rho_in[k], G2[(size_t)k * N + r]) : 0.0f;
        const int idx = kmajor<K1>(r, k);
        split(x, sGt_hi[idx], sGt_lo[idx]);
    }
    for (int e = threadIdx.x; e < G2_ELEMS; e += THREADS) {
        const int r = e / K2, k = e - r * K2;
        const float x = (r < M && k < N) ? G2[(size_t)r * N + k] : 0.0f;
        const int idx = kmajor<K2>(r, k);
        split(x, sG2_hi[idx], sG2_lo[idx]);
    }
    fence_shared_to_async();
    __syncthreads();

    const int t = threadIdx.x & 127;
    Operands o;
    const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem_raw);
    o.gt_hi = base;
    o.gt_lo = o.gt_hi + 2 * GT_ELEMS;
    o.g2_hi = o.gt_lo + 2 * GT_ELEMS;
    o.g2_lo = o.g2_hi + 2 * G2_ELEMS;
    o.b_hi = o.g2_lo + 2 * G2_ELEMS + 2 * B_HALVES * wg * B_ELEMS;   // [LT x K]
    o.b_lo = DELTA ? o.b_hi : o.b_hi + 2 * B_ELEMS;
    o.gqs = o.g2_lo + 2 * G2_ELEMS + 2 * B_HALVES * WGS * B_ELEMS + 4 * wg * GQS_FLOATS;
    o.t = t;
    o.rbase = 16 * (t >> 5) + ((t & 31) >> 2);
    o.cbase = 2 * (t & 3);
    o.bar = 1 + wg;
    const long long ntiles = (B + LT - 1) / LT;
    const long long step = (long long)gridDim.x * WGS;

    for (long long tile = (long long)blockIdx.x * WGS + wg; tile < ntiles; tile += step) {
        const long long lane0 = tile * LT;
        const int nl = (int)((B - lane0 < LT) ? (B - lane0) : LT);

        // ask L2 for the next tile's inputs while this one iterates
        const long long next0 = (tile + step) * LT;
        if (next0 < B) {
            const long long nn = (B - next0 < LT) ? (B - next0) : LT;
            prefetch_range(v_in + next0 * M, 4 * nn * M, t);
            prefetch_range(l_in + next0 * M, 4 * nn * M, t);
            prefetch_range(u_in + next0 * M, 4 * nn * M, t);
            prefetch_range(gq_in + next0 * N, 4 * nn * N, t);
            prefetch_range(s_in + next0, 4 * nn, t);
        }

        Tile x;
        float s[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int col = o.cbase + 8 * (c >> 1) + (c & 1);
            s[c] = (col < nl) ? s_in[lane0 + col] : 1.0f;
        }
#pragma unroll
        for (int a = 0; a < MT2; ++a)
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const int row = frag_row(o, a, i);
                const int col = frag_lane(o, i);
                const bool ok = row < M && col < nl;
                const size_t off = (size_t)(lane0 + col) * M + row;
                x.v[a][i] = ok ? v_in[off] : 0.0f;
                x.lo[a][i] = ok ? l_in[off] : 0.0f;
                x.up[a][i] = ok ? u_in[off] : 0.0f;
            }
#pragma unroll
        for (int a = 0; a < MT1; ++a)
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const int row = frag_row(o, a, i);
                const int col = frag_lane(o, i);
                const float sc = s[2 * (i >> 2) + (i & 1)];
                const bool ok = row < N && col < nl;
                const float q = ok ? __fdiv_rn(gq_in[(size_t)(lane0 + col) * N + row], sc) : 0.0f;
                if (DELTA)
                    st_f32(o.gqs + 4 * ((8 * a + i) * 128 + t), q);   // read by this thread only
                else
                    x.gqs[DELTA ? 0 : a][i] = q;
                x.sdinv[a][i] = spectral_gain(sc, row, d_in);
            }

        if constexpr (DELTA) {
            iteration<true>(x, o, alpha);
            for (int it = 1; it < iters; ++it) iteration<false>(x, o, alpha);
        } else {
            for (int it = 0; it < iters; ++it) iteration<true>(x, o, alpha);
        }

#pragma unroll
        for (int a = 0; a < MT2; ++a)
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const int row = frag_row(o, a, i);
                const int col = frag_lane(o, i);
                if (row < M && col < nl) v_out[(size_t)(lane0 + col) * M + row] = x.v[a][i];
            }
#pragma unroll
        for (int a = 0; a < MT1; ++a)
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const int row = frag_row(o, a, i);
                const int col = frag_lane(o, i);
                if (row < N && col < nl)
                    tau_out[(size_t)(lane0 + col) * N + row] =
                        DELTA ? tau_of(x, o, a, i) : x.tau[DELTA ? 0 : a][i];
            }
    }
}

}  // namespace

extern "C" {

int blf_admm_stage_tc_smem_bytes() { return (int)SMEM_BYTES; }

int blf_admm_stage_tc_delta() { return DELTA ? 1 : 0; }

const char* blf_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Launch one stage on `stream`. All pointers are device pointers to contiguous
// f32 arrays: v, l, u (B, m); gq (B, n); s (B,); G2 (m, n); d (n,); rho (m,);
// outputs v_out (B, m), tau_out (B, n). `delta` must name the compiled mode.
// Returns the CUDA error code of the launch (0 on success), or -1 for a shape
// or mode other than the one compiled, -2 for a bad batch or iteration count.
// Does not synchronise.
int blf_admm_stage_tc(const float* v, const float* s, const float* gq, const float* l,
                      const float* u, const float* G2, const float* d, const float* rho,
                      float* v_out, float* tau_out, long long B, int m, int n, int delta,
                      int iters, float alpha, void* stream) {
    if (m != M || n != N || (delta != 0) != DELTA) return -1;
    if (B < 1 || iters < 1) return -2;
    cudaError_t err = cudaFuncSetAttribute(
        admm_stage_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    int device = 0, sms = 0;
    err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    const long long pairs = ((B + LT - 1) / LT + WGS - 1) / WGS;
    const long long blocks = pairs < sms ? pairs : sms;
    admm_stage_tc_kernel<<<(unsigned)blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        v, s, gq, l, u, G2, d, rho, v_out, tau_out, B, iters, alpha);
    return (int)cudaGetLastError();
}

}  // extern "C"
