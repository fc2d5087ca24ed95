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
// bf16 dense peak. The elementwise work (some 25 f32 operations an element of
// v or tau an iteration) and the device-memory traffic (4.6 KB a lane) are
// below that.
//
// What held the first version of this kernel (16-lane tiles, two warpgroups
// each on its own tile, every row of its lanes in one warpgroup) to a fifth
// of that bound, measured on the card with copies of it that had a phase
// removed (PERF.md section 6): at (192, 128), B 98304, "delta" 2.34 ms in
// all, its products alone 1.31 ms, its elementwise work and operand staging
// alone 1.18 ms. The products alone ran where the shared-memory reads put
// them: a wgmma m64n16k16 reads a 2 KB operator tile and a 512 B operand tile
// for 8 cycles of tensor-core math, some 20 cycles of the SM's 128 bytes a
// cycle. The elementwise work took as long again, one 16-bit shared store an
// element among it. And the two parts added up: the two warpgroups ran in
// step, so neither hid the other's work.
//
// Design (each choice with its reason):
//  * wgmma.mma_async m64nLk16 with L = 32 lanes (ADMM_LANES), bf16 in, f32
//    accumulate, both operands read from shared memory through matrix
//    descriptors: one 2 KB operator tile now feeds 32 lanes, 24 cycles of
//    reads for 16 of math, against 40 for two 16-lane products.
//  * Batch-minor tiles, as the TPU kernel chose: the operator is wgmma's A
//    (its rows M, 64-row tiles: m = 3 x 64 and n = 2 x 64 at horizon 32), a
//    tile of L lanes is N, the contraction is K.
//  * The block works on one tile of L lanes at a time, its 64-row tiles
//    divided among its warpgroups: warpgroup j owns row tile j of v and of
//    G2 tau (v, l, u, u_acc and delta's w_prev of its rows in registers, 16
//    values each at L = 32) and, where n has one, row tile j of Gt w (t_acc,
//    s/(1 + s d), gq/s). So m/64 warpgroups (n <= m), three at (192, 128);
//    32 lanes' state of every row would not fit one warpgroup. The two that
//    own a row tile of Gt w take 176 registers, the third 152 (setmaxnreg,
//    inside the 3 x 168 the block is launched with: asking for more waits
//    for ever). Each warpgroup's product over its row tile is one commit
//    group (delta's increment included), waited for once: with one row tile
//    a warpgroup there is no other tile's epilogue to run under it.
//  * Operands are staged as bf16 pairs: cvt.rn.bf16x2.f32 packs two lanes,
//    and stmatrix.trans writes four 8 x 8 blocks of the accumulator fragment
//    a warp as the K-major rows of the next product's B (16-byte rows, a
//    core matrix 128 contiguous bytes: no bank conflict). One fence and one
//    barrier an operand.
//  * Layout (a): both bf16 pairs stay in shared memory for the block's life,
//    Gt (n, m) and G2 (m, n), 96 KB each at (192, 128), K-major in wgmma's
//    no-swizzle canonical layout (8 x 16-byte core matrices). Each is loaded
//    and split once a block. Rows past n or m and columns past the
//    16-padded contraction are zero in shared memory only. Beside them the
//    operand buffers: W (w's hi and lo, 2 x 12 KB) and T (tau's hi, 8 KB);
//    tau's lo, where a 3-pass product needs it, goes to W's lo half once
//    every warpgroup of Gt w has waited for its product: 224 KB of the 227.
//  * Barriers: "delta" after its first iteration two an iteration (the
//    operands written); "split" and delta's first iteration four (and one
//    between the Gt w owners before tau's lo reuses W).
//  * Persistent blocks: min(tiles, blocks that fit) of them, so the
//    operators are loaded and split once a block, not once a tile. While a
//    tile iterates, the block asks L2 to prefetch the next tile's v, l, u,
//    gq and s (prefetch.global.L2).
//  * "delta"'s increments are summed on the tensor cores from zero and added
//    to the f32 carries in round-to-nearest, as the plain version adds them.
//    Accumulated into the carries in place (scale-d = 1), their products lost
//    their low bits against the large carry, always towards zero, and the
//    cold first tick of bench.py's workload converged 91 % of lanes against
//    the plain version's 96 % (PERF.md).
//  * clip passes on a NaN of v, l or u, as jnp.clip does (min/max.NaN); a
//    product never mixes lanes (a lane is a column of B), so a poisoned lane
//    poisons nothing else.
//  * Any B >= 1: lanes past B are loaded as zeros (s = 1) and never stored;
//    the batch is never padded in device memory.
//  * An operator of one row tile each way (the stack's (48, 32)) runs on one
//    warpgroup; its stage is latency-bound, so it keeps 16-lane tiles and
//    twice the blocks in flight (ADMM_LANES = 16).
//
// What bounds the redesign (PERF.md section 6): 1.455 ms for delta and 1.853
// for split at (192, 128), B 98304, 34 % and 39.5 % of the bound. Its
// products take half the time; the other half is serial: w's, tau's and v's
// elementwise phases and two to four barriers an iteration between them,
// with one tile in flight and no register room for a second.
//
// The shape (m, n), the mode and the tile width are compile-time constants
// (-DADMM_M=.. -DADMM_N=.. -DADMM_DELTA=0|1 -DADMM_LANES=16|32):
// ops/cuda/_build.py compiles one library per (m, n, mode) at first use.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC -Xptxas -v (no -use_fast_math).

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
#ifndef ADMM_LANES
#error "compile with -DADMM_LANES=16 or 32 (lanes of a tile)"
#endif

namespace {

constexpr int M = ADMM_M;
constexpr int N = ADMM_N;
constexpr bool DELTA = ADMM_DELTA != 0;
constexpr int LT = ADMM_LANES;           // lanes of a tile: wgmma's N
constexpr int NV = LT / 2;               // accumulator values a thread holds of a row tile
constexpr int MT1 = (N + 63) / 64;       // 64-row tiles of t = Gt w (n rows)
constexpr int MT2 = (M + 63) / 64;       // 64-row tiles of G2 tau (m rows)
constexpr int WGS = MT2;                 // warpgroups: one a row tile (n <= m)
constexpr int THREADS = 128 * WGS;
constexpr int K1 = (M + 15) / 16 * 16;   // contraction of t, padded to wgmma's k
constexpr int K2 = (N + 15) / 16 * 16;   // contraction of G2 tau
constexpr int R1 = 64 * MT1;
constexpr int R2 = 64 * MT2;
constexpr int GT_ELEMS = R1 * K1;        // bf16 elements of one half of Gt's pair
constexpr int G2_ELEMS = R2 * K2;
constexpr int W_ELEMS = LT * K1;         // one bf16 half of w
constexpr int T_ELEMS = LT * K2;         // tau's hi
constexpr size_t SMEM_BYTES =
    2 * (2 * (size_t)GT_ELEMS + 2 * (size_t)G2_ELEMS + 2 * (size_t)W_ELEMS + (size_t)T_ELEMS);
// Registers a thread of a warpgroup with a row tile of Gt w, and of one
// without, where both kinds exist among three: setmaxnreg moves registers
// between them inside the 3 x 168 a thread the block was launched with
// (asking for more than was released waits for ever).
constexpr int REG_T = MT1 == 1 ? 200 : 176;
constexpr int REG_U = 152;
static_assert(WGS < 3 || MT1 * REG_T + (WGS - MT1) * REG_U <= 3 * 168, "register split");
// barrier ids: 0 is __syncthreads
constexpr int BAR_ALL = 1;               // every warpgroup of the block
constexpr int BAR_T = 2;                 // the owners of Gt w's row tiles

static_assert(LT == 16 || LT == 32, "tiles of 16 or 32 lanes");
static_assert(M >= 1 && N >= 1, "empty operator");
static_assert(WGS <= 3, "one warpgroup a 64-row tile: at most three of 168 registers");
static_assert(K2 <= K1, "tau's lo passes through w's lo buffer: n <= m");
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

// D (64 x LT, f32) += A (64 x 16) B (16 x LT), bf16, both from shared memory.
template <int V>
__device__ __forceinline__ void wgmma(float (&d)[V], uint64_t da, uint64_t db) {
    static_assert(V == 8 || V == 16, "m64n16 or m64n32");
    if constexpr (V == 8) {
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
    } else {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "setp.ne.b32 p, %18, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
            "%16, %17, p, 1, 1, 0, 0;\n"
            "}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
              "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
            : "l"(da), "l"(db), "r"(1));
    }
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
__device__ __forceinline__ void barrier(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void prefetch_l2(const void* p) {
    asm volatile("prefetch.global.L2 [%0];\n" :: "l"(p));
}

// Four 8 x 8 bf16 blocks of a warp's accumulator fragment, each register two
// lanes of one row (the low half the lower lane), stored transposed: a
// block's row (a lane) becomes 16 contiguous bytes at the address thread
// 8 b + r gives for row r of block b.
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, uint32_t r0, uint32_t r1,
                                                  uint32_t r2, uint32_t r3) {
    asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3) : "memory");
}

// bf16(x0) in the low half, bf16(x1) in the high half, to nearest even
__device__ __forceinline__ uint32_t pack_bf16x2(float x0, float x1) {
    uint32_t r;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(x1), "f"(x0));
    return r;
}
__device__ __forceinline__ float low_of(uint32_t r) { return __uint_as_float(r << 16); }
__device__ __forceinline__ float high_of(uint32_t r) { return __uint_as_float(r & 0xFFFF0000u); }
// hi = bf16(x), lo = bf16(x - hi) of a pair
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
    hi = pack_bf16x2(x0, x1);
    lo = pack_bf16x2(__fsub_rn(x0, low_of(hi)), __fsub_rn(x1, high_of(hi)));
}

// Keep the compiler from moving accesses of accumulator registers across the
// asynchronous products.
__device__ __forceinline__ void fence_registers(float (&acc)[NV]) {
#pragma unroll
    for (int i = 0; i < NV; ++i) asm volatile("" : "+f"(acc[i]) :: "memory");
}

__device__ __forceinline__ void zero(float (&acc)[NV]) {
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[i] = 0.0f;
}

// min(max(v, l), u) in which a NaN in any operand gives NaN, as jnp.clip
// and torch.minimum/maximum: the .NaN forms of min and max, one instruction
// each.
__device__ __forceinline__ float clip_nan(float v, float l, float u) {
    float z;
    asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(z) : "f"(v), "f"(l));
    asm("min.NaN.f32 %0, %1, %2;\n" : "=f"(z) : "f"(z), "f"(u));
    return z;
}

// An opaque copy of x: values derived from it are computed where they are
// used, never hoisted out of the iteration loop into registers of their own.
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
    asm volatile("" : "+l"(x));
    return x;
}

// acc += sum over the NP passes j of A_j B_j: A_j a 64-row tile of an
// operator of contraction K at shared address a[j], B_j the LT-lane operand
// at b[j]; the K/16 steps of each pass issued as one commit group and waited
// for. Every thread of the warpgroup calls it. A descriptor advances by its
// start address in 16-byte units, by 16 to the next k step (two core
// matrices); each next one is made from the last after its wgmma (opaque),
// so that two are live at a time.
template <int NP, int K>
__device__ __forceinline__ void product(float (&acc)[NV], const uint32_t (&a)[NP],
                                        const uint32_t (&b)[NP]) {
    fence_registers(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NP; ++j) {
        uint64_t da = opaque(descriptor<K>(a[j]));
        uint64_t db = opaque(descriptor<K>(b[j]));
#pragma unroll
        for (int ks = 0; ks < K / 16; ++ks) {
            wgmma(acc, da, db);
            da = opaque(da + 16);
            db = opaque(db + 16);
        }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_registers(acc);
}

// What a warpgroup holds in registers for the tile, in wgmma's m64nLT f32
// fragment of its row tile: value i is row 16 warp + g + 8 ((i >> 1) & 1) of
// the tile, lane 8 (i >> 2) + 2 q + (i & 1), for g = lane / 4, q = lane % 4
// of the thread in its warp.
struct Tile {
    float v[NV], lo[NV], up[NV];     // iterate and bounds, its rows of m
    float u_acc[NV];                 // G2 tau ("delta": the carry)
    float t_acc[NV];                 // Gt w ("delta": the carry), its rows of n
    float sdinv[NV], gqs[NV];        // s / (1 + s d), gq / s
    float w_prev[DELTA ? NV : 1];    // "delta": the last w
};

// Where this thread works: its warpgroup, warp and place in the accumulator
// fragment, its warpgroup's operator row tiles and its stmatrix rows (shared
// addresses; the lo halves and the other buffers lie at fixed distances).
// Made from the thread index where it is used, never kept across the loops:
// registers are what the per-lane state needs.
struct Block {
    int wg, warp, g, q;
    uint32_t gt_hi, g2_hi;                 // this warpgroup's row tile of each operator
    uint32_t w_hi;                         // the operand buffers: W hi, W lo, T
    uint32_t st_w, st_t;                   // this thread's stmatrix row in W / T (bytes)
};
constexpr uint32_t GT_LO = 2 * GT_ELEMS;   // bytes from a hi half to its lo half
constexpr uint32_t G2_LO = 2 * G2_ELEMS;
constexpr uint32_t W_LO = 2 * W_ELEMS;     // bytes from W's hi half to its lo half
constexpr uint32_t T_HI = 4 * W_ELEMS;     // ... and to T

__device__ __forceinline__ Block place() {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    uint32_t t;
    asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
    Block o;
    o.wg = __shfl_sync(0xffffffffu, (int)(t >> 7), 0);   // warp-uniform, and seen so
    t &= 127;
    o.warp = t >> 5;
    o.g = (t & 31) >> 2;
    o.q = t & 3;
    const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem_raw);
    o.gt_hi = base + 2 * kmajor<K1>(64 * (o.wg < MT1 ? o.wg : 0), 0);
    o.g2_hi = base + 2 * (2 * GT_ELEMS) + 2 * kmajor<K2>(64 * o.wg, 0);
    o.w_hi = base + 2 * (2 * GT_ELEMS + 2 * G2_ELEMS);  // W [LT x K1] hi, lo; T [LT x K2]
    // stmatrix: thread 8 b + r of a warp gives row r of block b, block b being
    // lanes 8 (b >> 1) .. +7 (of the first four; the next x4 adds 16 lanes)
    // and rows 8 (b & 1) .. +7 of the warp's 16
    const int lane = t & 31, b = lane >> 3, r = lane & 7;
    const int k0 = 64 * o.wg + 16 * o.warp + 8 * (b & 1);
    o.st_w = 2 * kmajor<K1>(8 * (b >> 1) + r, k0 < K1 ? k0 : 0);
    o.st_t = 2 * kmajor<K2>(8 * (b >> 1) + r, k0 < K2 ? k0 : 0);
    return o;
}

__device__ __forceinline__ int row_of(const Block& o, int i) {
    return 64 * o.wg + 16 * o.warp + o.g + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int lane_of(const Block& o, int i) {
    return 8 * (i >> 2) + 2 * o.q + (i & 1);
}

// Store a warp's LT x 16 block of the operand (its 16 rows of the row tile,
// as rows of the contraction K), packed as pairs r[2 j + h] = values
// (4 j + 2 h, 4 j + 2 h + 1) of the fragment, into the K-major buffer at
// `row` (this thread's stmatrix row, see Block) plus `buf`: unless its rows
// lie past the contraction.
template <int K>
__device__ __forceinline__ void store_pairs(const Block& o, uint32_t buf, uint32_t row,
                                            const uint32_t (&r)[NV / 2]) {
    if constexpr (K % 64 != 0)                   // a row tile may reach past K
        if (64 * o.wg + 16 * o.warp >= K) return;    // warp-uniform
    stmatrix_x4_trans(buf + row, r[0], r[1], r[2], r[3]);
    if constexpr (LT == 32)
        stmatrix_x4_trans(buf + row + 2 * 2 * 8 * K, r[4], r[5], r[6], r[7]);
}

// One iteration of a warpgroup that owns a row tile of Gt w (HAS_T) or not.
// FULL: 3-pass products of the full w and tau ("split", and iteration 1 of
// "delta"); else 2-pass products of their bf16 increments.
template <bool HAS_T, bool FULL>
__device__ __forceinline__ void iteration(Tile& x, float alpha) {
    const Block o = place();
    const uint32_t w_lo = o.w_hi + W_LO, t_hi = o.w_hi + T_HI;

    // w = 2 clip(v, l, u) - v: its hi and lo, or its increment
    {
        uint32_t hi[NV / 2], lo[NV / 2];
#pragma unroll
        for (int p = 0; p < NV / 2; ++p) {
            float w[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int i = 2 * p + e;
                const float z = clip_nan(x.v[i], x.lo[i], x.up[i]);
                w[e] = __fsub_rn(__fmul_rn(2.0f, z), x.v[i]);
            }
            if (FULL) {
                split_pair(w[0], w[1], hi[p], lo[p]);
            } else {
                hi[p] = pack_bf16x2(__fsub_rn(w[0], x.w_prev[DELTA ? 2 * p : 0]),
                                    __fsub_rn(w[1], x.w_prev[DELTA ? 2 * p + 1 : 0]));
            }
            if (DELTA) {
                x.w_prev[DELTA ? 2 * p : 0] = w[0];
                x.w_prev[DELTA ? 2 * p + 1 : 0] = w[1];
            }
        }
        store_pairs<K1>(o, o.w_hi, o.st_w, hi);
        if (FULL) store_pairs<K1>(o, w_lo, o.st_w, lo);
        fence_shared_to_async();
    }
    barrier(BAR_ALL, THREADS);

    // t = Gt w, its row tile; tau = (t - gq/s) s/(1 + s d): its hi and lo, or
    // its increment
    if constexpr (HAS_T) {
        if (FULL) {
            zero(x.t_acc);
            product<3, K1>(x.t_acc, {o.gt_hi, o.gt_hi, o.gt_hi + GT_LO}, {o.w_hi, w_lo, o.w_hi});
            // tau's lo goes where w's lo was: once every owner has read it
            barrier(BAR_T, 128 * MT1);
            uint32_t hi[NV / 2], lo[NV / 2];
#pragma unroll
            for (int p = 0; p < NV / 2; ++p) {
                float tau[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int i = 2 * p + e;
                    tau[e] = __fmul_rn(__fsub_rn(x.t_acc[i], x.gqs[i]), x.sdinv[i]);
                }
                split_pair(tau[0], tau[1], hi[p], lo[p]);
            }
            store_pairs<K2>(o, t_hi, o.st_t, hi);
            store_pairs<K2>(o, w_lo, o.st_t, lo);
        } else {
            // A_hi dw + A_lo dw, summed from zero (see the design note), then
            // t_acc += it and dtau = bf16(tau - tau_prev)
            float part[NV];
            zero(part);
            product<2, K1>(part, {o.gt_hi, o.gt_hi + GT_LO}, {o.w_hi, o.w_hi});
            uint32_t d[NV / 2];
#pragma unroll
            for (int p = 0; p < NV / 2; ++p) {
                float dt[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int i = 2 * p + e;
                    const float prev = __fmul_rn(__fsub_rn(x.t_acc[i], x.gqs[i]), x.sdinv[i]);
                    x.t_acc[i] = __fadd_rn(x.t_acc[i], part[i]);
                    dt[e] = __fsub_rn(__fmul_rn(__fsub_rn(x.t_acc[i], x.gqs[i]), x.sdinv[i]),
                                      prev);
                }
                d[p] = pack_bf16x2(dt[0], dt[1]);
            }
            store_pairs<K2>(o, t_hi, o.st_t, d);
        }
        fence_shared_to_async();
    }
    barrier(BAR_ALL, THREADS);

    // u = G2 tau, its row tile; v += alpha (u - z)
    {
        if (FULL) {
            zero(x.u_acc);
            product<3, K2>(x.u_acc, {o.g2_hi, o.g2_hi, o.g2_hi + G2_LO}, {t_hi, w_lo, t_hi});
        } else {
            float part[NV];
            zero(part);
            product<2, K2>(part, {o.g2_hi, o.g2_hi + G2_LO}, {t_hi, t_hi});
#pragma unroll
            for (int i = 0; i < NV; ++i) x.u_acc[i] = __fadd_rn(x.u_acc[i], part[i]);
        }
#pragma unroll
        for (int i = 0; i < NV; ++i) {
            const float z = clip_nan(x.v[i], x.lo[i], x.up[i]);
            x.v[i] = __fadd_rn(x.v[i], __fmul_rn(alpha, __fsub_rn(x.u_acc[i], z)));
        }
    }
    // the next w overwrites W's lo, which this iteration's G2 products read
    if (FULL) barrier(BAR_ALL, THREADS);
}

// Ask L2 for `bytes` bytes from p on, one 128-byte line a thread at a time.
__device__ __forceinline__ void prefetch_range(const float* p, long long bytes) {
    for (long long off = 128LL * threadIdx.x; off < bytes; off += 128LL * THREADS)
        prefetch_l2(reinterpret_cast<const char*>(p) + off);
}

// The block's tiles, one after another, as one warpgroup sees them.
template <bool HAS_T>
__device__ __forceinline__ void tiles(const float* __restrict__ v_in,
                                      const float* __restrict__ s_in,
                                      const float* __restrict__ gq_in,
                                      const float* __restrict__ l_in,
                                      const float* __restrict__ u_in,
                                      const float* __restrict__ d_in, float* __restrict__ v_out,
                                      float* __restrict__ tau_out, long long B, int iters,
                                      float alpha) {
    const int ntiles = (int)((B + LT - 1) / LT);

    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const long long lane0 = (long long)tile * LT;
        const int nl = (int)((B - lane0 < LT) ? (B - lane0) : LT);

        // ask L2 for the next tile's inputs while this one iterates
        const long long next0 = ((long long)tile + gridDim.x) * LT;
        if (next0 < B) {
            const long long nn = (B - next0 < LT) ? (B - next0) : LT;
            prefetch_range(v_in + next0 * M, 4 * nn * M);
            prefetch_range(l_in + next0 * M, 4 * nn * M);
            prefetch_range(u_in + next0 * M, 4 * nn * M);
            prefetch_range(gq_in + next0 * N, 4 * nn * N);
            prefetch_range(s_in + next0, 4 * nn);
        }

        Tile x;
        const Block o = place();
#pragma unroll
        for (int i = 0; i < NV; ++i) {
            const int row = row_of(o, i);
            const int col = lane_of(o, i);
            const bool ok = row < M && col < nl;
            const size_t off = (size_t)(lane0 + col) * M + row;
            x.v[i] = ok ? v_in[off] : 0.0f;
            x.lo[i] = ok ? l_in[off] : 0.0f;
            x.up[i] = ok ? u_in[off] : 0.0f;
            const float sc = col < nl ? s_in[lane0 + col] : 1.0f;
            if (!HAS_T) continue;
            const bool okt = row < N && col < nl;
            x.gqs[i] = okt ? __fdiv_rn(gq_in[(size_t)(lane0 + col) * N + row], sc) : 0.0f;
            x.sdinv[i] = row < N ? __fdiv_rn(sc, __fadd_rn(1.0f, __fmul_rn(sc, d_in[row])))
                                 : 0.0f;
        }

        if constexpr (DELTA) {
            iteration<HAS_T, true>(x, alpha);
            for (int it = 1; it < iters; ++it) iteration<HAS_T, false>(x, alpha);
        } else {
            for (int it = 0; it < iters; ++it) iteration<HAS_T, true>(x, alpha);
        }

        const Block p = place();
#pragma unroll
        for (int i = 0; i < NV; ++i) {
            const int row = row_of(p, i);
            const int col = lane_of(p, i);
            if (row < M && col < nl) v_out[(size_t)(lane0 + col) * M + row] = x.v[i];
            if (HAS_T && row < N && col < nl)
                tau_out[(size_t)(lane0 + col) * N + row] =
                    __fmul_rn(__fsub_rn(x.t_acc[i], x.gqs[i]), x.sdinv[i]);
        }
    }
}

template <bool INC, int REGS>
__device__ __forceinline__ void set_max_registers() {
    if constexpr (INC)
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(REGS));
    else
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(REGS));
}

__global__ void __launch_bounds__(THREADS, 1)
admm_stage_tc_kernel(const float* __restrict__ v_in, const float* __restrict__ s_in,
                     const float* __restrict__ gq_in, const float* __restrict__ l_in,
                     const float* __restrict__ u_in, const float* __restrict__ G2,
                     const float* __restrict__ d_in, const float* __restrict__ rho_in,
                     float* __restrict__ v_out, float* __restrict__ tau_out,
                     long long B, int iters, float alpha) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    uint16_t* sGt_hi = reinterpret_cast<uint16_t*>(smem_raw);   // [R1 x K1] (rho . G2)^T
    uint16_t* sGt_lo = sGt_hi + GT_ELEMS;
    uint16_t* sG2_hi = sGt_lo + GT_ELEMS;                       // [R2 x K2] G2
    uint16_t* sG2_lo = sG2_hi + G2_ELEMS;

    // The operators, split once a block; reads run along G2's rows, several
    // in flight a thread.
#pragma unroll 8
    for (int e = threadIdx.x; e < GT_ELEMS; e += THREADS) {
        const int k = e / R1, r = e - k * R1;          // Gt[r][k] = rho[k] G2[k][r]
        const float x = (r < N && k < M) ? __fmul_rn(rho_in[k], G2[(size_t)k * N + r]) : 0.0f;
        const int idx = kmajor<K1>(r, k);
        uint32_t hi, lo;
        split_pair(x, 0.0f, hi, lo);
        sGt_hi[idx] = (uint16_t)hi;
        sGt_lo[idx] = (uint16_t)lo;
    }
#pragma unroll 8
    for (int e = threadIdx.x; e < G2_ELEMS; e += THREADS) {
        const int r = e / K2, k = e - r * K2;
        const float x = (r < M && k < N) ? G2[(size_t)r * N + k] : 0.0f;
        const int idx = kmajor<K2>(r, k);
        uint32_t hi, lo;
        split_pair(x, 0.0f, hi, lo);
        sG2_hi[idx] = (uint16_t)hi;
        sG2_lo[idx] = (uint16_t)lo;
    }
    fence_shared_to_async();
    __syncthreads();

    const int wg = place().wg;
    // Warpgroups that own a row tile of Gt w carry three more arrays; three
    // warpgroups share 168 registers a thread, so where some own none, those
    // give registers to the owners (setmaxnreg).
    if constexpr (MT1 < WGS) {
        if (wg < MT1) {
            if constexpr (WGS == 3) set_max_registers<true, REG_T>();
            tiles<true>(v_in, s_in, gq_in, l_in, u_in, d_in, v_out, tau_out, B, iters, alpha);
        } else {
            if constexpr (WGS == 3) set_max_registers<false, REG_U>();
            tiles<false>(v_in, s_in, gq_in, l_in, u_in, d_in, v_out, tau_out, B, iters,
                         alpha);
        }
    } else {
        tiles<true>(v_in, s_in, gq_in, l_in, u_in, d_in, v_out, tau_out, B, iters, alpha);
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
    int device = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, admm_stage_tc_kernel, THREADS,
                                                        SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    const long long tiles = (B + LT - 1) / LT;
    const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
    const long long blocks = tiles < fit ? tiles : fit;
    admm_stage_tc_kernel<<<(unsigned)blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        v, s, gq, l, u, G2, d, rho, v_out, tau_out, B, iters, alpha);
    return (int)cudaGetLastError();
}

}  // extern "C"
