// Fused shared-operator v-space ADMM stage on Hopper's tensor cores (sm_90a),
// modes "split" and "delta", for operators that do not fit in shared memory:
// both bf16 operator pairs stream through it from L2.
//
// Replaces the TPU kernel blf_tpu/ops/pallas/admm.py::_stage_kernel_t (entry
// admm_stage_t / admm_stage) for matmul="split" and matmul="delta" at the
// shapes where the resident tensor-core kernel, csrc/admm_stage_tc.cu,
// cannot keep both operator pairs in one block's 227 KB, or gives a 64-row
// tile of G2 more warpgroups than it has (m > 192), or n > m (the config-3
// gait's (960, 384): the pairs alone are 2.95 MB). It computes what that
// kernel computes: `iters` iterations, at a fixed per-lane penalty
// multiplier s, of
//
//     z   = clip(v, l, u)
//     w   = 2 z - v
//     t   = Gt w                      Gt = (rho . G2)^T, (n, m)
//     tau = (t - gq / s) * s / (1 + s d)
//     v  += alpha (G2 tau - z)
//
// for every lane of a fleet that shares one operator G2 (m, n), with every
// product a sum of bf16 x bf16 products taken on the tensor cores (wgmma,
// f32 accumulation), as the reference's matrix-unit passes are
// (admm.py:93-135, :197-255):
//  * the operators are split once, hi = bf16(x), lo = bf16(x - hi), rho
//    folded into Gt before its split;
//  * "split": every product is A_hi b_hi + A_hi b_lo + A_lo b_hi, b being the
//    iterate's own split;
//  * "delta": iteration 1 takes those 3-pass products; every later one adds
//    A_hi db + A_lo db, db = bf16(w - w_prev) or bf16(tau - tau_prev), to the
//    f32 carries t_acc and u_acc. The increments are summed on the tensor
//    cores from zero and added to the carries in round-to-nearest, as the
//    plain version adds them: accumulated into a carry in place, their
//    products lose their low bits against it, always towards zero (the
//    cold first tick of bench.py's workload converged 91 % of lanes that way
//    against 96 %: PERF.md section 6).
// A product of two bf16 values is exact in f32, so the kernel parts from its
// plain version (ops/cuda/admm.py) only by the order of its f32 sums. The
// elementwise steps use __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn (no
// multiply-add contracted where the plain version rounds twice; IEEE
// divisions: no -use_fast_math).
//
// What bounds it on an H100. At (m, n, B) = (960, 384, 4096) one pass of
// 2 m n B flop is 3.02 GFLOP; a stage of 25 iterations is 102 passes (delta)
// or 150 (split): 0.31 / 0.46 ms at the 989 TFLOP/s bf16 dense peak. What
// the stage cannot avoid moving is 18.4 KB a lane (75 MB, 0.023 ms at 3.35
// TB/s). This design moves more (see below): the operator pairs, 2.95 MB,
// from L2 once a pass for each 32-lane tile (128 tiles x 26 passes: 9.8 GB),
// and in "delta" the m-sized lane state through device memory every pass.
//
// Design (each choice with its reason):
//  * A prologue kernel splits G2 and rho . G2 once a stage into a scratch
//    buffer of device memory, as 64 x 64 tiles already in wgmma's no-swizzle
//    K-major canonical layout, each tile's hi and lo halves side by side (16
//    KB): the main kernel copies a tile pair into shared memory as it lies,
//    16 bytes a thread (cp.async), and splits nothing.
//  * One block of two warpgroups works on one tile of L = 32 lanes
//    (ADMM_LANES; wgmma's N) through the whole stage: 4096 lanes on 128 of
//    the 132 SMs. Batch-minor, as the TPU kernel chose: an operator tile is
//    wgmma's A (64 rows), the lane tile is N, the contraction K.
//  * ONE pass over the operators an iteration, as csrc/admm_stage_l2.cu, in
//    chunks of 128 rows of m (two 64-row tiles, one a warpgroup). For chunk
//    c: G2[c] tau_prev gives v's rows of c (the previous iteration's second
//    product, the contraction over all of n), from which z and w of c
//    follow; then Gt[:, c] w[c] adds chunk c's share to t, the contraction
//    over the chunk's rows, summed in registers over the pass (from zero)
//    and turned into tau at the pass's end. A stage is iters + 1 passes (the
//    first has no second product, the last no first product).
//  * Each warpgroup owns one 64-row tile of the chunk (its v, w) and every
//    second 64-row tile of t (RT tiles: 3 at n = 384, 48 accumulator
//    registers a thread at L = 32).
//  * The operator tiles stream through a ring of ADMM_STAGES slots, one tile
//    pair a warpgroup a slot, STAGES - 1 slots in flight ahead of the one in
//    use (cp.async groups). One barrier a slot: it makes the slot's copies
//    visible and frees the slot the next copy overwrites.
//  * On chip: the ring, w's operand of the chunk (hi and lo, 16 KB at L = 32)
//    and tau's operand (hi and lo, 48 KB at n = 384): 192 KB at (960, 384).
//    The per-lane state over m (v, l, u; "delta" also u_acc and w_prev) is
//    read and written by chunk in device memory by its owner thread, 369 KB
//    a tile per array being far past shared memory; v lives in v_out,
//    u_acc and w_prev in a scratch buffer the wrapper allocates. Over n,
//    "delta"'s t_acc (48 KB a tile at n = 384) is read and written once a
//    pass in the same scratch buffer, which leaves the registers to the
//    product's accumulators; s / (1 + s d) and gq / s are recomputed at each
//    pass's end from s, d and gq (the same IEEE divisions every time). A
//    chunk's state is prefetched into L2 while its first product runs, and
//    every load of it is issued before any store (u_acc and w_prev share one
//    buffer, so the compiler would otherwise wait for each store).
//  * Operands are staged as bf16 pairs: cvt.rn.bf16x2.f32 packs two lanes,
//    stmatrix.trans writes four 8 x 8 blocks of the accumulator fragment a
//    warp as K-major rows of the next product's B.
//  * Rows past m or n, and columns past the 64-padded contraction, are zero
//    in the split tiles only; a tile wholly past m is neither copied nor
//    multiplied.
//  * clip passes on a NaN of v, l or u, as jnp.clip does (min/max.NaN); a
//    product never mixes lanes (a lane is a column of B), so a poisoned lane
//    poisons nothing else.
//  * Any B >= 1: lanes past B are read as zeros (s = 1) and never stored.
//  * Past n = 1024 the tile narrows to 16 lanes (half the operand buffers and
//    accumulators), and the ring to as many slots as fit (ops/cuda/admm.py,
//    tc_l2_plan): n up to 2048, any m.
//
// Measured (PERF.md section 6; NVIDIA H100 80GB HBM3, 700.00 W): at (960,
// 384), B 4096, 25 iterations, delta 4.48-4.61 ms and split 3.39-3.45 ms,
// 7 % and 13 % of the bound. Neither the tensor cores nor L2 bind (operator reads at
// 2.0-2.7 TB/s): the 96 ring steps a pass, a barrier and a wgmma wait each,
// and delta's lane state through device memory (3.6 GB a stage) do.
//
// The shape (m, n), the mode, the tile width and the ring depth are
// compile-time constants (-DADMM_M=.. -DADMM_N=.. -DADMM_DELTA=0|1
// -DADMM_LANES=16|32 -DADMM_STAGES=2..4): ops/cuda/_build.py compiles one
// library per (m, n, mode) at first use.
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
#ifndef ADMM_STAGES
#error "compile with -DADMM_STAGES=<slots of the operator ring>"
#endif

namespace {

constexpr int M = ADMM_M;
constexpr int N = ADMM_N;
constexpr bool DELTA = ADMM_DELTA != 0;
constexpr int LT = ADMM_LANES;           // lanes of a tile: wgmma's N
constexpr int NV = LT / 2;               // accumulator values a thread holds of a 64-row tile
constexpr int STAGES = ADMM_STAGES;      // slots of the operator ring
constexpr int WGS = 2;                   // warpgroups of a block
constexpr int THREADS = 128 * WGS;
constexpr int MT1 = (N + 63) / 64;       // 64-row tiles of t (n rows)
constexpr int MT2 = (M + 63) / 64;       // 64-row tiles of v (m rows)
constexpr int NCH = (MT2 + WGS - 1) / WGS;   // chunks a pass, WGS row tiles each
constexpr int MT2P = NCH * WGS;          // row tiles of the split G2, padded to whole chunks
constexpr int RT = (MT1 + WGS - 1) / WGS;    // tiles of t a warpgroup owns
constexpr int K2 = 64 * MT1;             // contraction of G2 tau: n padded to 64
constexpr int KW = 64 * WGS;             // contraction of a chunk's Gt w: its rows
constexpr int TILE = 64 * 64;            // bf16 elements of an operator tile
constexpr uint32_t LO = 2 * TILE;        // bytes from a tile's hi half to its lo half
constexpr uint32_t PAIR = 2 * LO;        // bytes of a tile pair
constexpr uint32_t SLOT = WGS * PAIR;    // bytes of a ring slot
constexpr uint32_t W_HALF = 2 * LT * KW; // bytes of one half (hi or lo) of w's operand
constexpr uint32_t T_HALF = 2 * LT * K2; // ... and of tau's operand
constexpr size_t SMEM_BYTES = (size_t)STAGES * SLOT + 2 * (size_t)W_HALF + 2 * (size_t)T_HALF;
// the split operators in device memory: G2's tile pairs (i, j) row-major over
// (MT2P, MT1), then Gt's (j, i) row-major over (MT1, MT2P)
constexpr long long OPS_TILES = (long long)MT2P * MT1;
constexpr long long OPS_BYTES = 2 * OPS_TILES * PAIR;
constexpr int SPLIT_THREADS = 256;

static_assert(LT == 16 || LT == 32, "tiles of 16 or 32 lanes");
static_assert(M >= 1 && N >= 1, "empty operator");
static_assert(STAGES >= 2 && STAGES <= 8, "ring of 2 to 8 slots");
static_assert(SMEM_BYTES <= 232448, "ring and operand buffers do not fit in shared memory");
static_assert(RT * NV <= 128, "t's accumulators do not fit in registers");
static_assert(K2 <= 16383 && KW <= 16383, "stride does not fit a matrix descriptor");

// Element (r, k) of a K-major operand with K (a multiple of 16) columns, in
// wgmma's no-swizzle canonical layout: 8-row x 8-column core matrices of 128
// contiguous bytes, row r % 8 at 16-byte stride inside one; the core matrix
// next along k lies 128 bytes on (LBO), the one next along r K * 16 bytes on
// (SBO). An operator tile is K = 64.
template <int K>
__host__ __device__ __forceinline__ int kmajor(int r, int k) {
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

// ---- Hopper instructions ---------------------------------------------------

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
// Make this thread's shared-memory writes (ordinary stores, stmatrix and
// completed cp.async copies) visible to wgmma's reads.
__device__ __forceinline__ void fence_shared_to_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void prefetch_l2(const void* p) {
    asm volatile("prefetch.global.L2 [%0];\n" :: "l"(p));
}
// Copy 16 bytes from device memory to shared address `dst`, asynchronously.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most K of this thread's copy groups are in flight.
template <int K>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(K) : "memory");
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

// min(max(v, l), u) in which a NaN in any operand gives NaN, as jnp.clip
// and torch.minimum/maximum: the .NaN forms of min and max.
__device__ __forceinline__ float clip_nan(float v, float l, float u) {
    float z;
    asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(z) : "f"(v), "f"(l));
    asm("min.NaN.f32 %0, %1, %2;\n" : "=f"(z) : "f"(z), "f"(u));
    return z;
}

// An opaque copy of x: values derived from it are computed where they are
// used, never hoisted out of a loop into registers of their own.
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
    asm volatile("" : "+l"(x));
    return x;
}

// Keep the compiler from moving accesses of accumulator registers across the
// asynchronous products.
__device__ __forceinline__ void fence_registers(float (&acc)[NV]) {
#pragma unroll
    for (int i = 0; i < NV; ++i) asm volatile("" : "+f"(acc[i]) :: "memory");
}

// ---- end of Hopper instructions --------------------------------------------

__device__ __forceinline__ float low_of(uint32_t r) { return __uint_as_float(r << 16); }
__device__ __forceinline__ float high_of(uint32_t r) { return __uint_as_float(r & 0xFFFF0000u); }
// hi = bf16(x), lo = bf16(x - hi) of a pair
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
    hi = pack_bf16x2(x0, x1);
    lo = pack_bf16x2(__fsub_rn(x0, low_of(hi)), __fsub_rn(x1, high_of(hi)));
}

__device__ __forceinline__ void zero(float (&acc)[NV]) {
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[i] = 0.0f;
}

// acc += sum over the NP passes j of A_j B_j: A_j a 64 x 64 operator tile at
// shared address a[j], B_j 64 contraction columns of an LT-lane operand of
// KB columns at b[j]; the four k steps of each pass issued as one commit
// group with the others and waited for. Every thread of the warpgroup calls
// it. A descriptor advances by its start address in 16-byte units, by 16 to
// the next k step (two core matrices).
template <int NP, int KB>
__device__ __forceinline__ void product(float (&acc)[NV], const uint32_t (&a)[NP],
                                        const uint32_t (&b)[NP]) {
    fence_registers(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NP; ++j) {
        uint64_t da = opaque(descriptor<64>(a[j]));
        uint64_t db = opaque(descriptor<KB>(b[j]));
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
            wgmma(acc, da, db);
            da = opaque(da + 16);
            db = opaque(db + 16);
        }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_registers(acc);
}

// Where this thread works: its warpgroup, warp, and place (g, q) in the
// accumulator fragment: value i of a 64-row tile is its row 16 warp + g +
// 8 ((i >> 1) & 1), lane 8 (i >> 2) + 2 q + (i & 1).
struct Place {
    int wg, warp, g, q, lane;
};

__device__ __forceinline__ Place place() {
    const int t = (int)threadIdx.x;
    Place o;
    o.wg = __shfl_sync(0xffffffffu, t >> 7, 0);   // warp-uniform, and seen so
    o.warp = (t & 127) >> 5;
    o.lane = t & 31;
    o.g = o.lane >> 2;
    o.q = o.lane & 3;
    return o;
}

__device__ __forceinline__ int row_of(const Place& o, int i) {
    return 16 * o.warp + o.g + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int lane_of(const Place& o, int i) {
    return 8 * (i >> 2) + 2 * o.q + (i & 1);
}

// Store a warp's LT x 16 block of an operand (its 16 rows of a 64-row tile,
// rows `k0` + 16 warp .. + 15 of the contraction K), packed as pairs
// r[2 j + h] = values (4 j + 2 h, 4 j + 2 h + 1) of the fragment, into the
// K-major buffer at shared address `buf`.
template <int K>
__device__ __forceinline__ void store_pairs(const Place& o, uint32_t buf, int k0,
                                            const uint32_t (&r)[NV / 2]) {
    // stmatrix: thread 8 b + r gives row r of block b, block b being lanes
    // 8 (b >> 1) .. +7 (of the first 16; the second x4 adds 16 lanes) and
    // rows 8 (b & 1) .. +7 of the warp's 16
    const int b = o.lane >> 3, rr = o.lane & 7;
    const uint32_t at = buf + 2 * kmajor<K>(8 * (b >> 1) + rr, k0 + 16 * o.warp + 8 * (b & 1));
    stmatrix_x4_trans(at, r[0], r[1], r[2], r[3]);
    if constexpr (LT == 32) stmatrix_x4_trans(at + 2 * 2 * 8 * K, r[4], r[5], r[6], r[7]);
}

// The tile pair warpgroup `g` reads at step `q` of the stage, as a byte
// offset into the split operators, or -1 where it reads none. A chunk of a
// pass whose first product runs has MT1 steps of it (step j: G2 tile
// (WGS c + g, j)), then, where its second product runs, RT * WGS steps
// (step WGS r + k: Gt tile (WGS r + g, WGS c + k)). Pass 0 has only second
// products, pass `iters` only first ones.
__device__ __forceinline__ long long step_source(long long q, int g, int iters) {
    constexpr int S1 = MT1, S2 = RT * WGS;
    int c, idx;
    bool first;
    const long long q0 = (long long)NCH * S2;
    if (q < q0) {
        c = (int)(q / S2);
        idx = (int)(q % S2);
        first = false;
    } else {
        const long long per = (long long)NCH * (S1 + S2);
        const long long pass = 1 + (q - q0) / per, rem = (q - q0) % per;
        if (pass < iters) {
            c = (int)(rem / (S1 + S2));
            idx = (int)(rem % (S1 + S2));
            first = idx < S1;
            if (!first) idx -= S1;
        } else {
            c = (int)(rem / S1);
            idx = (int)(rem % S1);
            first = true;
        }
    }
    if (first) {
        const int i = WGS * c + g;
        return i < MT2 ? ((long long)i * MT1 + idx) * PAIR : -1;
    }
    const int j = WGS * (idx / WGS) + g, i = WGS * c + idx % WGS;
    return (j < MT1 && i < MT2) ? OPS_BYTES / 2 + ((long long)j * MT2P + i) * PAIR : -1;
}

// Start copying step q's tile pairs into its ring slot; one commit group a
// step, empty past the last.
__device__ __forceinline__ void issue_step(const unsigned char* __restrict__ ops, uint32_t ring,
                                           long long q, long long steps, int iters) {
    if (q < steps) {
        const uint32_t slot = ring + (uint32_t)(q % STAGES) * SLOT;
#pragma unroll
        for (int g = 0; g < WGS; ++g) {
            const long long src = step_source(q, g, iters);
            if (src < 0) continue;
#pragma unroll
            for (int e = (int)threadIdx.x; e < (int)(PAIR / 16); e += THREADS)
                cp_async16(slot + g * PAIR + 16 * e, ops + src + 16 * e);
        }
    }
    cp_async_commit();
}

// The prologue: G2 and (rho . G2)^T split into bf16 hi/lo tiles. Thread e
// handles element (r, k) = (e % TILE / 64, e % 64) of tile e / TILE of each.
__global__ void __launch_bounds__(SPLIT_THREADS)
split_operators(const float* __restrict__ G2, const float* __restrict__ rho_in,
                uint16_t* __restrict__ ops) {
    const long long e = (long long)blockIdx.x * SPLIT_THREADS + threadIdx.x;
    if (e >= OPS_TILES * TILE) return;
    const int tile = (int)(e / TILE), rk = (int)(e % TILE);
    const int r = rk >> 6, k = rk & 63;
    const int at = kmajor<64>(r, k);
    uint32_t hi, lo;
    {   // G2 tile (i, j): rows of m, contraction along n
        const int i = tile / MT1, j = tile % MT1;
        const int row = 64 * i + r, col = 64 * j + k;
        const float x = (row < M && col < N) ? G2[(size_t)row * N + col] : 0.0f;
        split_pair(x, 0.0f, hi, lo);
        uint16_t* pair = ops + (size_t)tile * (PAIR / 2);
        pair[at] = (uint16_t)hi;
        pair[TILE + at] = (uint16_t)lo;
    }
    {   // Gt tile (j, i): rows of n, contraction along m; Gt[a][b] = rho[b] G2[b][a]
        const int j = tile / MT2P, i = tile % MT2P;
        const int row = 64 * j + r, col = 64 * i + k;
        const float x = (row < N && col < M) ? __fmul_rn(rho_in[col], G2[(size_t)col * N + row])
                                             : 0.0f;
        split_pair(x, 0.0f, hi, lo);
        uint16_t* pair = ops + (size_t)(OPS_BYTES / 4) + (size_t)tile * (PAIR / 2);
        pair[at] = (uint16_t)hi;
        pair[TILE + at] = (uint16_t)lo;
    }
}

__global__ void __launch_bounds__(THREADS, 1)
admm_stage_tc_l2_kernel(const float* __restrict__ v_in, const float* __restrict__ s_in,
                        const float* __restrict__ gq_in, const float* __restrict__ l_in,
                        const float* __restrict__ u_in, const float* __restrict__ d_in,
                        const unsigned char* __restrict__ ops, float* __restrict__ v_out,
                        float* __restrict__ tau_out, float* __restrict__ scratch, long long B,
                        int iters, float alpha) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    const uint32_t ring = (uint32_t)__cvta_generic_to_shared(smem_raw);   // [STAGES][SLOT]
    const uint32_t w_hi = ring + STAGES * SLOT, w_lo = w_hi + W_HALF;     // [LT x KW] each
    const uint32_t t_hi = w_lo + W_HALF, t_lo = t_hi + T_HALF;            // [LT x K2] each
    // "delta"'s carries: u_acc and w_prev (B, m), t_acc (B, n)
    float* __restrict__ u_acc = scratch;
    float* __restrict__ w_prev = scratch + (size_t)B * M;
    float* __restrict__ t_acc = scratch + 2 * (size_t)B * M;

    const Place o = place();
    const long long lane0 = (long long)blockIdx.x * LT;
    const int nl = (int)((B - lane0 < LT) ? (B - lane0) : LT);
    const long long steps = (long long)iters * NCH * (MT1 + RT * WGS);

    long long q = 0;                  // the next step
#pragma unroll 1
    for (int k = 0; k < STAGES - 1; ++k) issue_step(ops, ring, k, steps, iters);
    // the slot of step q, once its copies have landed and every thread is
    // done with step q - 1, whose slot the copy issued here overwrites
    auto begin_step = [&]() -> uint32_t {
        cp_async_wait<STAGES - 2>();
        fence_shared_to_async();
        __syncthreads();
        issue_step(ops, ring, q + STAGES - 1, steps, iters);
        return ring + (uint32_t)(q++ % STAGES) * SLOT + o.wg * PAIR;
    };

    float acc_t[RT][NV];
#pragma unroll
    for (int r = 0; r < RT; ++r) zero(acc_t[r]);

#pragma unroll 1
    for (int p = 0; p <= iters; ++p) {
#pragma unroll 1
        for (int c = 0; c < NCH; ++c) {
            const int i = WGS * c + o.wg;          // this warpgroup's row tile of v
            const bool mine = i < MT2;             // warpgroup-uniform

            // the chunk's state: into L2 while the first product runs
            if (mine && p >= 1) {
#pragma unroll
                for (int e = 0; e < NV; e += 4) {
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int row = 64 * i + row_of(o, e + 2 * h);
                        const int lane = lane_of(o, e);
                        if (row >= M || lane >= nl) continue;
                        const size_t at = (size_t)(lane0 + lane) * M + row;
                        prefetch_l2(l_in + at);
                        prefetch_l2(u_in + at);
                        prefetch_l2((p == 1 ? v_in : v_out) + at);
                        if (DELTA) {
                            prefetch_l2(w_prev + at);
                            if (p >= 2) prefetch_l2(u_acc + at);
                        }
                    }
                }
            }

            // u = G2[c] tau: this warpgroup's 64 rows, over all of n
            float acc_u[NV];
            zero(acc_u);
            if (p >= 1) {
                const bool full = !DELTA || p == 1;
#pragma unroll 1
                for (int j = 0; j < MT1; ++j) {
                    const uint32_t a = begin_step();
                    if (!mine) continue;
                    const uint32_t b = 1024 * j;    // 64 columns of tau's operand
                    if (full)
                        product<3, K2>(acc_u, {a, a, a + LO}, {t_hi + b, t_lo + b, t_hi + b});
                    else
                        product<2, K2>(acc_u, {a, a + LO}, {t_hi + b, t_hi + b});
                }
            }
            // in pass 0 no barrier of a first product frees w's operand
            if (p == 0 && c > 0) __syncthreads();

            // v += alpha (u - z); then w = 2 clip(v, l, u) - v: its hi and
            // lo, or its increment, into w's operand; every load of the
            // tile's state before any store
            if (mine) {
                const bool full_w = !DELTA || p == 0;
                float v[NV], lb[NV], ub[NV], ua[NV], wp[NV];
#pragma unroll
                for (int e = 0; e < NV; ++e) {
                    const int row = 64 * i + row_of(o, e), lane = lane_of(o, e);
                    const bool ok = row < M && lane < nl;
                    const size_t at = (size_t)(lane0 + lane) * M + row;
                    v[e] = ok ? (p <= 1 ? v_in[at] : v_out[at]) : 0.0f;
                    lb[e] = ok ? l_in[at] : 0.0f;
                    ub[e] = ok ? u_in[at] : 0.0f;
                    ua[e] = (DELTA && p >= 2 && ok) ? u_acc[at] : 0.0f;
                    wp[e] = (DELTA && p > 0 && p < iters && ok) ? w_prev[at] : 0.0f;
                }
                uint32_t hi[NV / 2], lo[NV / 2];
#pragma unroll
                for (int pp = 0; pp < NV / 2; ++pp) {
                    float w2[2];
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int e = 2 * pp + h;
                        const int row = 64 * i + row_of(o, e), lane = lane_of(o, e);
                        const bool ok = row < M && lane < nl;
                        const size_t at = (size_t)(lane0 + lane) * M + row;
                        if (p >= 1) {
                            float uu = acc_u[e];
                            if (DELTA && p >= 2) uu = __fadd_rn(ua[e], uu);
                            if (DELTA && p < iters && ok) u_acc[at] = uu;
                            v[e] = __fadd_rn(v[e], __fmul_rn(alpha, __fsub_rn(
                                uu, clip_nan(v[e], lb[e], ub[e]))));
                            if (ok) v_out[at] = v[e];
                        }
                        w2[h] = 0.0f;
                        if (p < iters) {
                            const float w =
                                __fsub_rn(__fmul_rn(2.0f, clip_nan(v[e], lb[e], ub[e])), v[e]);
                            w2[h] = (DELTA && p > 0) ? __fsub_rn(w, wp[e]) : w;
                            if (DELTA && ok) w_prev[at] = w;
                        }
                    }
                    if (full_w) {
                        split_pair(w2[0], w2[1], hi[pp], lo[pp]);
                    } else {
                        hi[pp] = pack_bf16x2(w2[0], w2[1]);
                        lo[pp] = 0u;
                    }
                }
                if (p < iters) {
                    store_pairs<KW>(o, w_hi, 64 * o.wg, hi);
                    if (full_w) store_pairs<KW>(o, w_lo, 64 * o.wg, lo);
                    fence_shared_to_async();
                }
            }
            if (p == iters) continue;

            // t += Gt[:, c] w[c]: this warpgroup's tiles of t, over the chunk
            {
                const bool full = !DELTA || p == 0;
#pragma unroll
                for (int r = 0; r < RT; ++r) {
#pragma unroll
                    for (int k = 0; k < WGS; ++k) {
                        const uint32_t a = begin_step();
                        if (WGS * r + o.wg >= MT1 || WGS * c + k >= MT2) continue;
                        const uint32_t b = 1024 * k;    // the chunk's k-th 64 rows
                        if (full)
                            product<3, KW>(acc_t[r], {a, a, a + LO},
                                           {w_hi + b, w_lo + b, w_hi + b});
                        else
                            product<2, KW>(acc_t[r], {a, a + LO}, {w_hi + b, w_hi + b});
                    }
                }
            }
            if (c != NCH - 1) continue;

            // the pass's end: tau = (t - gq / s) s / (1 + s d) ("delta": the
            // carry t_acc += the pass's sum) into tau's operand, its hi and
            // lo or its increment; out after the last iteration
            const bool full_t = !DELTA || p == 0;
#pragma unroll
            for (int r = 0; r < RT; ++r) {
                const int j = WGS * r + o.wg;
                if (j >= MT1) continue;
                // every load before any store, as above
                float gqs[NV], sdinv[NV], old[NV];
#pragma unroll
                for (int e = 0; e < NV; ++e) {
                    const int row = 64 * j + row_of(o, e), lane = lane_of(o, e);
                    const bool okr = row < N, ok = okr && lane < nl;
                    const size_t at = (size_t)(lane0 + lane) * N + row;
                    const float sc = lane < nl ? s_in[lane0 + lane] : 1.0f;
                    gqs[e] = ok ? __fdiv_rn(gq_in[at], sc) : 0.0f;
                    sdinv[e] = okr ? __fdiv_rn(sc, __fadd_rn(1.0f, __fmul_rn(sc, d_in[row])))
                                   : 0.0f;
                    old[e] = (DELTA && p > 0 && ok) ? t_acc[at] : 0.0f;
                }
                uint32_t hi[NV / 2], lo[NV / 2];
#pragma unroll
                for (int pp = 0; pp < NV / 2; ++pp) {
                    float x2[2];
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int e = 2 * pp + h;
                        const int row = 64 * j + row_of(o, e), lane = lane_of(o, e);
                        const bool ok = row < N && lane < nl;
                        const size_t at = (size_t)(lane0 + lane) * N + row;
                        float ta = acc_t[r][e];
                        acc_t[r][e] = 0.0f;
                        float tau;
                        if (DELTA && p > 0) {
                            const float prev = __fmul_rn(__fsub_rn(old[e], gqs[e]), sdinv[e]);
                            ta = __fadd_rn(old[e], ta);
                            tau = __fmul_rn(__fsub_rn(ta, gqs[e]), sdinv[e]);
                            x2[h] = __fsub_rn(tau, prev);
                        } else {
                            tau = __fmul_rn(__fsub_rn(ta, gqs[e]), sdinv[e]);
                            x2[h] = tau;
                        }
                        if (DELTA && ok && p < iters - 1) t_acc[at] = ta;
                        if (ok && p == iters - 1) tau_out[at] = tau;
                    }
                    if (full_t) {
                        split_pair(x2[0], x2[1], hi[pp], lo[pp]);
                    } else {
                        hi[pp] = pack_bf16x2(x2[0], x2[1]);
                        lo[pp] = 0u;
                    }
                }
                store_pairs<K2>(o, t_hi, 64 * j, hi);
                if (full_t) store_pairs<K2>(o, t_lo, 64 * j, lo);
            }
            fence_shared_to_async();
        }
    }
    cp_async_wait<0>();
}

}  // namespace

extern "C" {

int blf_admm_stage_tc_l2_smem_bytes() { return (int)SMEM_BYTES; }

long long blf_admm_stage_tc_l2_operator_bytes() { return OPS_BYTES; }

const char* blf_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Launch one stage on `stream`: the operators' split into `ops`, then the
// stage. All pointers are device pointers to contiguous arrays: v, l, u
// (B, m), gq (B, n), s (B,), G2 (m, n), d (n,), rho (m,), f32; outputs v_out
// (B, m), tau_out (B, n), v_out not aliasing v; `ops` of
// blf_admm_stage_tc_l2_operator_bytes() bytes, 16-byte aligned; `scratch`
// of B (2 m + n) floats in mode delta (unused in split). `delta` must name
// the compiled mode. Returns the CUDA error code of the launches (0 on
// success), or -1 for a shape or mode other than the one compiled, -2 for a
// bad batch or iteration count, -3 for a missing buffer. Does not
// synchronise.
int blf_admm_stage_tc_l2(const float* v, const float* s, const float* gq, const float* l,
                         const float* u, const float* G2, const float* d, const float* rho,
                         float* v_out, float* tau_out, void* ops, float* scratch, long long B,
                         int m, int n, int delta, int iters, float alpha, void* stream) {
    if (m != M || n != N || (delta != 0) != DELTA) return -1;
    if (B < 1 || iters < 1) return -2;
    if (ops == nullptr || (DELTA && scratch == nullptr)) return -3;
    cudaError_t err = cudaFuncSetAttribute(
        admm_stage_tc_l2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    const long long split_blocks = (OPS_TILES * TILE + SPLIT_THREADS - 1) / SPLIT_THREADS;
    split_operators<<<(unsigned)split_blocks, SPLIT_THREADS, 0, (cudaStream_t)stream>>>(
        G2, rho, (uint16_t*)ops);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (B + LT - 1) / LT;
    if (blocks > 2147483647LL) return -2;
    admm_stage_tc_l2_kernel<<<(unsigned)blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        v, s, gq, l, u, d, (const unsigned char*)ops, v_out, tau_out, scratch, B, iters, alpha);
    return (int)cudaGetLastError();
}

}  // extern "C"
