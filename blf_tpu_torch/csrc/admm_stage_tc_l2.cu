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
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700.00 W). At (m, n, B)
// = (960, 384, 4096) one pass of 2 m n B flop is 3.02 GFLOP; a stage of 25
// iterations is 102 passes (delta) or 150 (split): 0.31 / 0.46 ms at the
// 989 TFLOP/s bf16 dense peak. What the stage cannot avoid moving is 18.4 KB
// a lane (75 MB, 0.023 ms at 3.35 TB/s). This design moves more, and that
// sets its floor: a 32-lane tile's state over m is 123 KB an array, far past
// shared memory, so it goes through device memory every pass (delta: v, l,
// u and u_acc read, v and u_acc written, t_acc and the two gains over n: 3.0
// GB a stage, 0.89 ms at 3.35 TB/s; split 1.9 GB, 0.56 ms); and the operator
// pairs, 2.95 MB, come from L2 once a pass for each tile (9.4 GB a stage).
//
// What bound the previous design (measured on the gait's last stage, 25
// iterations, NVIDIA H100 80GB HBM3, 700.00 W): 4.45 ms (delta), 3.24
// (split); 2.84 / 2.18 with the ring filled once and never again, 2.41 /
// 2.44 without the lane state, 3.47 / 2.39 without products, 3.96 / 2.87
// without the ring step's barrier; half the lanes 0.97 / 0.93 of the time.
// Its 96 ring steps a pass each paid a cp.async wait, a block barrier, a copy
// started by every thread and a wgmma wait, and the state loads sat between a
// chunk's two products, on the critical path.
//
// Design (each choice with its reason):
//  * A prologue kernel splits G2 and rho . G2 once a stage into a scratch
//    buffer of device memory, as 64 x 64 tiles already in wgmma's no-swizzle
//    K-major canonical layout, each tile's hi and lo halves side by side (16
//    KB): a copy is one contiguous bulk copy, no tensor map. A second one
//    computes the stage's gains gq / s and s / (1 + s d) once, with the
//    plain version's IEEE divisions: at each pass's end, as the previous design had them,
//    those divisions cost 0.16 ms (split) and 0.77 ms (delta) of a stage at
//    (960, 384).
//  * A block is two consumer warpgroups and a producer warpgroup (384
//    threads; setmaxnreg gives the consumers 232 registers a thread and the
//    producer 40) on one tile of L = 32 lanes (ADMM_LANES; wgmma's N) through
//    the whole stage. Batch-minor, as the TPU kernel chose: an operator tile is
//    wgmma's A (64 rows), the lane tile is N, the contraction K.
//  * ONE pass over the operators an iteration, in chunks of 128 rows of m
//    (two 64-row tiles, one a warpgroup). For chunk c: G2[c] tau_prev gives
//    v's rows of c (the previous iteration's second product, over all of n),
//    from which z and w of c follow; then Gt[:, c] w[c] adds chunk c's share
//    to t, summed in registers over the pass (from zero) and turned into tau
//    at the pass's end. A stage is iters + 1 passes (the first has no first
//    product, the last no second). Each warpgroup owns one 64-row tile of the
//    chunk (its v, w) and every second 64-row tile of t (RT tiles: 3 at n =
//    384, 48 accumulator registers a thread at L = 32).
//  * The operator tiles stream through a ring of ADMM_STAGES slots, one tile
//    pair a warpgroup a slot, each slot with a full and an empty mbarrier.
//    One thread of the producer walks the steps in the consumers' order
//    (nested loops, no division: the previous design's ring spent some 100 integer
//    operations a step finding its tile), waits for a slot to be empty, arms
//    its full barrier with the step's bytes and starts bulk copies
//    (cp.async.bulk, completing on that barrier); the consumers wait on the
//    full barrier, start their wgmma, and release the slot once the product
//    of the step after it is started (wgmma.wait_group 1): no block barrier in
//    the ring, and one product in flight behind the one being started. A
//    chunk's first product runs as six such steps into one accumulator and is
//    waited for once, before its elementwise phase reads it.
//  * No clusters. Two blocks of a cluster sharing each tile pair by
//    .multicast::cluster halve the L2 reads (9.4 GB a stage to 4.7 at (960,
//    384)), but measured no faster (split 2.04 ms against 2.01, delta 2.99
//    against 2.89): once the ring is fed, L2's bandwidth does not bind. (At
//    this shared memory the card holds 66 clusters of 2 and 30 of 4, fewer
//    than the 32 of 4 a batch of 4096 lanes needs at once.)
//  * The lane state of a chunk is loaded into registers before its first
//    product is started, so its device-memory latency runs under the tensor
//    work; "delta" no longer keeps w_prev: it recomputes it from the v it
//    loads (w_prev = 2 clip(v, l, u) - v of that very v, bit for bit), which
//    drops two of delta's eight m-sized streams.
//  * w's operand is double-buffered (chunk parity), so one barrier of the
//    two consumer warpgroups a chunk (bar.sync 1, 256) orders it: it makes
//    the chunk's w visible to both, and the buffer a write overwrites was
//    last read two chunks earlier, by products both have waited for.
//  * On chip at (960, 384): the ring (4 slots, 128 KB), w's operand twice
//    (hi and lo, 32 KB), tau's operand (hi and lo, 48 KB) and the barriers:
//    213056 bytes. A scratch buffer the wrapper allocates holds the gains
//    (read once a pass) and "delta"'s carries, t_acc over n (read and
//    written once a pass) and u_acc over m; v lives in v_out.
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
//  * Past n = 640 the tile narrows to 16 lanes (half the operand buffers and
//    accumulators, so that t's accumulators and a chunk's state fit in the
//    232 registers a consumer thread has), and the ring to as many slots as
//    fit (ops/cuda/admm.py, tc_l2_plan): n up to 2048, any m.
//
// Measured (PERF.md section 6; NVIDIA H100 80GB HBM3, 700.00 W): at (960,
// 384), B 4096, 25 iterations, delta 2.01-2.14 ms and split 1.59-1.67 ms,
// 15 % and 29 % of the tensor-core bound, against the previous design's 4.48 / 3.39 (in
// turns 2.03 / 1.61 against 4.39 / 3.34); about 2x at every other shape the
// chip run checks. What binds now is the SM's own sequence: a chunk's
// elementwise phase, while the two warpgroups, locked together by w's
// exchange, leave the tensor cores idle; and delta's lane state (1.3 ms of
// the stage when taken apart). Not L2: clusters halving its reads gained
// nothing.
//
// The shape (m, n), the mode, the tile width and the ring depth are
// compile-time constants (-DADMM_M=.. -DADMM_N=.. -DADMM_DELTA=0|1
// -DADMM_LANES=16|32 -DADMM_STAGES=2..8):
// ops/cuda/_build.py compiles one library per (m, n, mode) at first use, and
// the wrapper checks the compiled plan (blf_admm_stage_tc_l2_plan) at load.
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
constexpr int WGS = 2;                   // consumer warpgroups of a block
constexpr int CONSUMERS = 128 * WGS;
constexpr int THREADS = CONSUMERS + 128; // and the producer's warpgroup
// registers a thread: the launch gives 168 to each of the 384 threads;
// setmaxnreg moves them from the producer's warpgroup, which needs few, to
// the consumers (asking for more than the launch gave would wait for ever)
constexpr int REG_CONSUMER = 232;
constexpr int REG_PRODUCER = 40;
static_assert(WGS * REG_CONSUMER + REG_PRODUCER <= 3 * 168, "register split");
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
constexpr uint32_t W_BUF = 2 * W_HALF;   // ... of one chunk's w operand, hi and lo
constexpr uint32_t T_HALF = 2 * LT * K2; // ... of one half of tau's operand
constexpr size_t SMEM_BYTES = (size_t)STAGES * SLOT + 2 * (size_t)W_BUF + 2 * (size_t)T_HALF
                              + 2 * 8 * (size_t)STAGES;
// the split operators in device memory: G2's tile pairs (i, j) row-major over
// (MT2P, MT1), then Gt's (j, i) row-major over (MT1, MT2P)
constexpr long long OPS_TILES = (long long)MT2P * MT1;
constexpr long long OPS_BYTES = 2 * OPS_TILES * PAIR;
constexpr int SPLIT_THREADS = 256;
constexpr int BAR_CONSUMERS = 1;         // named barrier of the two consumer warpgroups

static_assert(LT == 16 || LT == 32, "tiles of 16 or 32 lanes");
static_assert(M >= 1 && N >= 1, "empty operator");
static_assert(STAGES >= 2 && STAGES <= 8, "ring of 2 to 8 slots");
static_assert(WGS == 2, "a step copies one tile pair a consumer warpgroup");
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
// Wait until at most K of this warpgroup's wgmma groups are in flight.
template <int K>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(K) : "memory");
}
// Make this thread's shared-memory writes (ordinary stores, stmatrix) visible
// to wgmma's reads.
__device__ __forceinline__ void fence_shared_to_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_barrier() {
    asm volatile("bar.sync %0, %1;\n" :: "n"(BAR_CONSUMERS), "n"(CONSUMERS) : "memory");
}
__device__ __forceinline__ void prefetch_l2(const void* p) {
    asm volatile("prefetch.global.L2 [%0];\n" :: "l"(p));
}

// mbarriers (shared addresses): init with `count` arrivals a phase, make the
// inits visible, arrive, arrive with `bytes` of copies to wait for, and wait
// for the phase of parity `parity` to complete.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    return done != 0;
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    while (!mbar_try_wait(bar, parity)) {
    }
}
// Copy `bytes` (a multiple of 16) from device memory to shared address `dst`,
// completing on the mbarrier at shared address `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n"
        :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}
template <bool INC, int REGS>
__device__ __forceinline__ void set_max_registers() {
    if constexpr (INC)
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(REGS));
    else
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(REGS));
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

// ---- end of Hopper instructions --------------------------------------------

// compile-time values carried by a type, to choose a chunk's form
template <int V>
struct Const {
    static constexpr int value = V;
};
template <bool V>
struct Bool {
    static constexpr bool value = V;
};

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

// Start acc += sum over the NP passes j of A_j B_j: A_j a 64 x 64 operator
// tile at shared address a[j], B_j 64 contraction columns of an LT-lane
// operand of KB columns at b[j]; four k steps a pass. Every thread of the
// warpgroup calls it; the caller commits and waits. A descriptor advances by
// its start address in 16-byte units, by 16 to the next k step (two core
// matrices).
template <int NP, int KB>
__device__ __forceinline__ void product(float (&acc)[NV], const uint32_t (&a)[NP],
                                        const uint32_t (&b)[NP]) {
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

// A ring position: the slot of a step and the parity of that slot's use.
struct Ring {
    uint32_t slot = 0, round = 0;
    __device__ __forceinline__ void next() {
        if (++slot == STAGES) {
            slot = 0;
            ++round;
        }
    }
};

// The producer's thread: every ring step in the consumers' order. A chunk of
// a pass whose first product runs has MT1 steps of it (step j: G2 tile
// (WGS c + g, j) for warpgroup g), then, where its second product runs, RT
// WGS steps (step (r, k): Gt tile (WGS r + g, WGS c + k)), those of a row
// tile past m left out; pass 0 has only second products, pass `iters` only
// first ones. For each step: wait until its slot is empty, arm its full
// barrier with the step's bytes, and copy the step's tile pairs into it. A
// tile pair past m or n is not copied; the warpgroup's product on that slot
// is never stored.
__device__ __forceinline__ void produce(const unsigned char* __restrict__ ops, uint32_t ring,
                                        uint32_t full, uint32_t empty, int iters) {
    Ring at;
    auto step = [&](long long src0, long long src1) {
        if (at.round > 0) mbar_wait(empty + 8 * at.slot, (at.round - 1) & 1);
        const uint32_t dst = ring + at.slot * SLOT, bar = full + 8 * at.slot;
        mbar_arrive_expect(bar, (src0 >= 0 ? PAIR : 0) + (src1 >= 0 ? PAIR : 0));
        if (src0 >= 0) bulk_copy(dst, ops + src0, PAIR, bar);
        if (src1 >= 0) bulk_copy(dst + PAIR, ops + src1, PAIR, bar);
        at.next();
    };
    constexpr long long GT = OPS_BYTES / 2;     // where Gt's tile pairs begin
#pragma unroll 1
    for (int p = 0; p <= iters; ++p) {
#pragma unroll 1
        for (int c = 0; c < NCH; ++c) {
            const int i0 = WGS * c, i1 = WGS * c + 1;
            if (p >= 1) {
#pragma unroll 1
                for (int j = 0; j < MT1; ++j)
                    step((long long)(i0 * MT1 + j) * PAIR,
                         i1 < MT2 ? (long long)(i1 * MT1 + j) * PAIR : -1);
            }
            if (p == iters) continue;
#pragma unroll 1
            for (int r = 0; r < RT; ++r) {
                const int j0 = WGS * r, j1 = WGS * r + 1;
                for (int k = 0; k < WGS; ++k) {
                    const int i = WGS * c + k;
                    if (i >= MT2) continue;
                    step(GT + (long long)(j0 * MT2P + i) * PAIR,
                         j1 < MT1 ? GT + (long long)(j1 * MT2P + i) * PAIR : -1);
                }
            }
        }
    }
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

// The stage's gains, fixed over it: gq / s and s / (1 + s d) of every lane
// and row of n, the same IEEE divisions as the plain version's, once a stage
// (inside the stage's loop they cost 0.16 ms in split and 0.77 ms in delta at
// (960, 384), in their slow paths' code, not in arithmetic).
__global__ void __launch_bounds__(SPLIT_THREADS)
stage_gains(const float* __restrict__ s_in, const float* __restrict__ gq_in,
            const float* __restrict__ d_in, float* __restrict__ gains, long long B) {
    const long long e = (long long)blockIdx.x * SPLIT_THREADS + threadIdx.x;
    if (e >= B * N) return;
    const long long lane = e / N;
    const int row = (int)(e - lane * N);
    const float sc = s_in[lane];
    gains[e] = __fdiv_rn(gq_in[e], sc);
    gains[B * N + e] = __fdiv_rn(sc, __fadd_rn(1.0f, __fmul_rn(sc, d_in[row])));
}

__global__ void __launch_bounds__(THREADS, 1)
admm_stage_tc_l2_kernel(const float* __restrict__ v_in, const float* __restrict__ l_in,
                        const float* __restrict__ u_in, const unsigned char* __restrict__ ops,
                        float* __restrict__ v_out, float* __restrict__ tau_out,
                        float* __restrict__ scratch, long long B, int iters, float alpha) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    const uint32_t ring = (uint32_t)__cvta_generic_to_shared(smem_raw);   // [STAGES][SLOT]
    const uint32_t w_ops = ring + STAGES * SLOT;          // [2 chunk parities][hi, lo][LT x KW]
    const uint32_t t_hi = w_ops + 2 * W_BUF, t_lo = t_hi + T_HALF;        // [LT x K2] each
    const uint32_t full = t_lo + T_HALF, empty = full + 8 * STAGES;       // [STAGES] each
    // the stage's gains gq / s and s / (1 + s d), (B, n) each; "delta"'s
    // carries u_acc (B, m) and t_acc (B, n)
    const float* __restrict__ gq_s = scratch;
    const float* __restrict__ sd_inv = scratch + (size_t)B * N;
    float* __restrict__ u_acc = scratch + 2 * (size_t)B * N;
    float* __restrict__ t_acc = u_acc + (size_t)B * M;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, 4 * WGS);
        }
        mbar_init_fence();
    }
    __syncthreads();

    if (threadIdx.x >= CONSUMERS) {
        set_max_registers<false, REG_PRODUCER>();
        if (threadIdx.x == CONSUMERS) produce(ops, ring, full, empty, iters);
        return;
    }
    set_max_registers<true, REG_CONSUMER>();

    const Place o = place();
    const long long lane0 = (long long)blockIdx.x * LT;
    const int nl = (int)(B - lane0 <= 0 ? 0 : (B - lane0 < LT ? B - lane0 : LT));

    Ring at;                          // the next ring step
    int held = -1;                    // the slot whose product may still be in flight
    // the slot of the next step, once its copies have landed
    auto take = [&]() -> uint32_t {
        mbar_wait(full + 8 * at.slot, at.round & 1);
        wgmma_fence();
        return ring + at.slot * SLOT + o.wg * PAIR;
    };
    // one warp's release of a slot, once every thread of the warp has waited
    // for it (the wgmma wait before it is warp-synchronous): one arrival on
    // its empty barrier. So no thread can lag a full barrier by two phases,
    // which its parity wait could not tell apart.
    auto release = [&](int s) {
        if (o.lane == 0) mbar_arrive(empty + 8 * s);
    };
    // the products of step q started: commit them, wait for the step before,
    // release its slot
    auto step_done = [&]() {
        wgmma_commit();
        wgmma_wait<1>();
        if (held >= 0) release(held);
        held = (int)at.slot;
        at.next();
    };
    // every product started so far complete, its slot released
    auto drain = [&]() {
        wgmma_wait<0>();
        if (held >= 0) release(held);
        held = -1;
    };

    float acc_t[RT][NV];
#pragma unroll
    for (int r = 0; r < RT; ++r) zero(acc_t[r]);

    // One chunk c of pass p, with UP passes of its first product (0: none, 2
    // or 3) and TP of its second, and whether it is the last chunk of an m of
    // an odd number of 64-row tiles (its second row tile of the chunk lies
    // past m). These are compile-time, so that no branch lies between the
    // products that are in flight together: every product is started by the
    // whole warpgroup, on garbage where its tile lies past m or n (it is never
    // stored), and nothing touches an accumulator before its wait.
    auto chunk = [&](int p, int c, auto up, auto tp, auto odd_tail) {
        constexpr int UP = decltype(up)::value, TP = decltype(tp)::value;
        constexpr bool ODD_TAIL = decltype(odd_tail)::value;
        const int i = WGS * c + o.wg;              // this warpgroup's row tile of v
        const bool mine = i < MT2;                 // warpgroup-uniform
        const uint32_t w_hi = w_ops + (uint32_t)(c & 1) * W_BUF, w_lo = w_hi + W_HALF;

        // the chunk's state, loaded now so that it lands while the first
        // product runs: v (v_in until pass 1 has written v_out), l and u;
        // "delta"'s u_acc into L2 only (registers are short)
        float v[NV], lb[NV], ub[NV];
#pragma unroll
        for (int e = 0; e < NV; ++e) {
            const int row = 64 * i + row_of(o, e), lane = lane_of(o, e);
            const bool ok = mine && row < M && lane < nl;
            const size_t at = (size_t)(lane0 + lane) * M + row;
            v[e] = ok ? (p <= 1 ? v_in[at] : v_out[at]) : 0.0f;
            lb[e] = ok ? l_in[at] : 0.0f;
            ub[e] = ok ? u_in[at] : 0.0f;
            if (DELTA && p >= 2 && ok && ((e >> 1) & 1) == 0) prefetch_l2(u_acc + at);
        }
        // the pass's end reads the gains and t_acc: into L2 meanwhile
        if (TP > 0 && c == NCH - 1) {
#pragma unroll
            for (int r = 0; r < RT; ++r) {
                const int j = WGS * r + o.wg;
#pragma unroll
                for (int e = 0; e < NV; e += 4) {
                    const int row = 64 * j + row_of(o, e), lane = lane_of(o, e);
                    if (j >= MT1 || row >= N || lane >= nl) continue;
                    const size_t at = (size_t)(lane0 + lane) * N + row;
                    prefetch_l2(gq_s + at);
                    prefetch_l2(sd_inv + at);
                    if (DELTA && p > 0) prefetch_l2(t_acc + at);
                }
            }
        }

        // u = G2[c] tau: this warpgroup's 64 rows, over all of n
        float acc_u[NV];
        zero(acc_u);
        if constexpr (UP > 0) {
#pragma unroll
            for (int j = 0; j < MT1; ++j) {
                const uint32_t a = take();
                const uint32_t b = 1024 * j;        // 64 columns of tau's operand
                if constexpr (UP == 3)
                    product<3, K2>(acc_u, {a, a, a + LO}, {t_hi + b, t_lo + b, t_hi + b});
                else
                    product<2, K2>(acc_u, {a, a + LO}, {t_hi + b, t_hi + b});
                step_done();
            }
            drain();
        }

        // v += alpha (u - z); then w = 2 clip(v, l, u) - v: its hi and lo, or
        // its increment, into w's operand of this chunk's parity
        if (mine) {
            constexpr bool FULL_W = !DELTA || (UP == 0);
            float ua[NV];
#pragma unroll
            for (int e = 0; e < NV; ++e) {
                const int row = 64 * i + row_of(o, e), lane = lane_of(o, e);
                const bool ok = row < M && lane < nl;
                ua[e] = (DELTA && p >= 2 && ok) ? u_acc[(size_t)(lane0 + lane) * M + row] : 0.0f;
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
                    float wp = 0.0f;
                    if constexpr (UP > 0) {
                        const float z0 = clip_nan(v[e], lb[e], ub[e]);
                        // the last pass's w, from the v it was computed from
                        if (DELTA && TP > 0) wp = __fsub_rn(__fmul_rn(2.0f, z0), v[e]);
                        float uu = acc_u[e];
                        if (DELTA && p >= 2) uu = __fadd_rn(ua[e], uu);
                        if (DELTA && TP > 0 && ok) u_acc[at] = uu;
                        v[e] = __fadd_rn(v[e], __fmul_rn(alpha, __fsub_rn(uu, z0)));
                        if (ok) v_out[at] = v[e];
                    }
                    w2[h] = 0.0f;
                    if constexpr (TP > 0) {
                        const float w =
                            __fsub_rn(__fmul_rn(2.0f, clip_nan(v[e], lb[e], ub[e])), v[e]);
                        w2[h] = (DELTA && UP > 0) ? __fsub_rn(w, wp) : w;
                    }
                }
                if constexpr (FULL_W) {
                    split_pair(w2[0], w2[1], hi[pp], lo[pp]);
                } else {
                    hi[pp] = pack_bf16x2(w2[0], w2[1]);
                    lo[pp] = 0u;
                }
            }
            if constexpr (TP > 0) {
                store_pairs<KW>(o, w_hi, 64 * o.wg, hi);
                if constexpr (FULL_W) store_pairs<KW>(o, w_lo, 64 * o.wg, lo);
                fence_shared_to_async();
            }
        }
        if constexpr (TP == 0) return;
        consumer_barrier();                  // both warpgroups' w of the chunk written

        // t += Gt[:, c] w[c]: this warpgroup's tiles of t, over the chunk
#pragma unroll
        for (int r = 0; r < RT; ++r) {
#pragma unroll
            for (int k = 0; k < WGS; ++k) {
                if (ODD_TAIL && k == 1) continue;    // no tile pair past m: no ring step
                const uint32_t a = take();
                const uint32_t b = 1024 * k;        // the chunk's k-th 64 rows
                if constexpr (TP == 3)
                    product<3, KW>(acc_t[r], {a, a, a + LO}, {w_hi + b, w_lo + b, w_hi + b});
                else
                    product<2, KW>(acc_t[r], {a, a + LO}, {w_hi + b, w_hi + b});
                step_done();
            }
        }
        drain();
    };

    // The pass's end, once its chunks are done: tau = (t - gq / s) s / (1 + s
    // d) ("delta" after pass 0: the carry t_acc += the pass's sum, and tau's
    // increment) into tau's operand, its hi and lo (FULL_T) or its
    // increment; out after the last iteration. Apart from the chunks, so that
    // it is compiled twice and not once for every kind of chunk (as often as
    // that, its loops were not unrolled and delta spilled 504 bytes).
    auto pass_end = [&](int p, auto full_t) {
        constexpr bool FULL_T = decltype(full_t)::value;
#pragma unroll
        for (int r = 0; r < RT; ++r) {
            const int j = WGS * r + o.wg;
            if (j >= MT1) continue;
            // every load before any store; a lane past B has tau = 0
            float gqs[NV], sdinv[NV], old[NV];
#pragma unroll
            for (int e = 0; e < NV; ++e) {
                const int row = 64 * j + row_of(o, e), lane = lane_of(o, e);
                const bool ok = row < N && lane < nl;
                const size_t at = (size_t)(lane0 + lane) * N + row;
                gqs[e] = ok ? gq_s[at] : 0.0f;
                sdinv[e] = ok ? sd_inv[at] : 0.0f;
                old[e] = (DELTA && !FULL_T && ok) ? t_acc[at] : 0.0f;
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
                    if constexpr (DELTA && !FULL_T) {
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
                if constexpr (FULL_T) {
                    split_pair(x2[0], x2[1], hi[pp], lo[pp]);
                } else {
                    hi[pp] = pack_bf16x2(x2[0], x2[1]);
                    lo[pp] = 0u;
                }
            }
            store_pairs<K2>(o, t_hi, 64 * j, hi);
            if constexpr (FULL_T) store_pairs<K2>(o, t_lo, 64 * j, lo);
        }
        fence_shared_to_async();
        consumer_barrier();                  // tau's operand whole before the next pass reads it
    };

    // the passes: which products each runs, and in how many passes of bf16
    // pairs, is fixed at compile time for each kind of chunk
    using I0 = Const<0>;
    using I2 = Const<2>;
    using I3 = Const<3>;
    constexpr int UP_LATER = DELTA ? 2 : 3;       // after the first iteration
#pragma unroll 1
    for (int p = 0; p <= iters; ++p) {
#pragma unroll 1
        for (int c = 0; c < NCH; ++c) {
            const bool tail = (MT2 & 1) && c == NCH - 1;
            if (p == 0) {
                if (tail) chunk(p, c, I0(), I3(), Bool<true>());
                else chunk(p, c, I0(), I3(), Bool<false>());
            } else if (p == iters) {
                if (p == 1 || !DELTA) chunk(p, c, I3(), I0(), Bool<false>());
                else chunk(p, c, I2(), I0(), Bool<false>());
            } else if (p == 1) {
                if (tail) chunk(p, c, I3(), Const<UP_LATER>(), Bool<true>());
                else chunk(p, c, I3(), Const<UP_LATER>(), Bool<false>());
            } else {
                if (tail) chunk(p, c, Const<UP_LATER>(), Const<UP_LATER>(), Bool<true>());
                else chunk(p, c, Const<UP_LATER>(), Const<UP_LATER>(), Bool<false>());
            }
        }
        if (p == iters) continue;
        if (DELTA && p > 0) pass_end(p, Bool<false>());
        else pass_end(p, Bool<true>());
    }
}

}  // namespace

extern "C" {

int blf_admm_stage_tc_l2_smem_bytes() { return (int)SMEM_BYTES; }

long long blf_admm_stage_tc_l2_operator_bytes() { return OPS_BYTES; }

// The compiled plan: lanes of a tile, slots of the ring, threads of a block
// (ops/cuda/admm.py::tc_l2_plan mirrors the first two).
void blf_admm_stage_tc_l2_plan(int* out) {
    out[0] = LT;
    out[1] = STAGES;
    out[2] = THREADS;
}

const char* blf_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Launch one stage on `stream`: the operators' split into `ops`, then the
// stage. All pointers are device pointers to contiguous arrays: v, l, u
// (B, m), gq (B, n), s (B,), G2 (m, n), d (n,), rho (m,), f32; outputs v_out
// (B, m), tau_out (B, n), v_out not aliasing v; `ops` of
// blf_admm_stage_tc_l2_operator_bytes() bytes, 16-byte aligned; `scratch`
// of B (m + 3 n) floats in mode delta, 2 B n in split. `delta` must name
// the compiled mode. Returns the CUDA error code of the launches (0 on
// success), or -1 for a
// shape or mode other than the one compiled, -2 for a bad batch or
// iteration count, -3 for a missing buffer, -4 for a library compiled with
// fewer registers than its consumers take. Does not synchronise.
int blf_admm_stage_tc_l2(const float* v, const float* s, const float* gq, const float* l,
                         const float* u, const float* G2, const float* d, const float* rho,
                         float* v_out, float* tau_out, void* ops, float* scratch, long long B,
                         int m, int n, int delta, int iters, float alpha, void* stream) {
    if (m != M || n != N || (delta != 0) != DELTA) return -1;
    if (B < 1 || iters < 1) return -2;
    if (ops == nullptr || scratch == nullptr) return -3;
    if (((uintptr_t)ops & 15) != 0) return -3;
    cudaError_t err = cudaFuncSetAttribute(
        admm_stage_tc_l2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    // the registers setmaxnreg hands the consumers must exist
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, admm_stage_tc_l2_kernel);
    if (err != cudaSuccess) return (int)err;
    if (attr.numRegs * 3 < WGS * REG_CONSUMER + REG_PRODUCER) return -4;
    const long long split_blocks = (OPS_TILES * TILE + SPLIT_THREADS - 1) / SPLIT_THREADS;
    split_operators<<<(unsigned)split_blocks, SPLIT_THREADS, 0, (cudaStream_t)stream>>>(
        G2, rho, (uint16_t*)ops);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long gain_blocks = (B * N + SPLIT_THREADS - 1) / SPLIT_THREADS;
    if (gain_blocks > 2147483647LL) return -2;
    stage_gains<<<(unsigned)gain_blocks, SPLIT_THREADS, 0, (cudaStream_t)stream>>>(
        s, gq, d, scratch, B);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (B + LT - 1) / LT;
    if (blocks > 2147483647LL) return -2;
    admm_stage_tc_l2_kernel<<<(unsigned)blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        v, l, u, (const unsigned char*)ops, v_out, tau_out, scratch, B, iters, alpha);
    return (int)cudaGetLastError();
}

}  // extern "C"
