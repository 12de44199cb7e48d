// Flash attention forward (causal / sliding window / GQA / tanh softcap)
// for Hopper: TMA loads into an mbarrier ring, both products on wgmma,
// one producer warp and two consumer warpgroups.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas, body _attn_kernel).
//
// Computes, for q (B, Hq, S, D) and k, v (B, Hkv, S, D) in bf16, with q
// head h reading kv head h / (Hq / Hkv):
//   s = (q . k) * scale                       f32 logits
//   s = softcap * tanh(s / softcap)           when a softcap is given
//   s = -inf where kpos >= S, or (causal) kpos > qpos, or (window)
//       kpos <= qpos - window
//   out = softmax(s) @ v, by the online recurrence (m, l, acc) in f32,
//   acc / max(l, 1e-30) rounded to bf16 and written through the output's
//   strides.
// Key tiles wholly outside the causal & window band are skipped by the
// loop bounds, so a window W costs O(S * W), not O(S^2).
//
// Bound on an H100: operations. A visible (q, k) pair costs 4 * D
// tensor-core flops (1 024 at D = 256) against 2 * 2 * D bytes of q/k/v/o
// per row, so at S = 8192 the two products bound it: 0.556 ms for
// gemma2-9b's global layer (1, 16/8, 8192, 256) at 989 TFLOP/s. What the
// design does about it:
// - Both products run on wgmma (the only path to the full tensor-core
//   rate): S = Q K^T with both operands read from shared memory by
//   descriptor, O += P V with P as the register A operand (the S
//   accumulator layout is the A-fragment layout, as with mma.sync) and V
//   read MN-major through the transpose bit. Each consumer warpgroup owns
//   64 query rows, so a block holds BQ = 128 rows and every K and V
//   element brought into shared memory feeds 128 rows.
// - One producer thread issues TMA loads (cp.async.bulk.tensor, 4-D maps
//   (D, S, H, B) over the caller's strides, built per call on the host):
//   Q once, then K and V tiles into a ring of STAGES stages with full and
//   empty mbarriers, K and V on separate barriers so Q K^T starts before
//   V lands. TMA's zero-fill past S (and past D) replaces predicated
//   loads. setmaxnreg gives the producer 24 registers and the consumers
//   240 (at D = 256 the O accumulator alone is 128 a thread).
// - The tensor cores are kept busy while the softmax runs: in a
//   warpgroup, Q K(j+1)^T is issued together with P V(j), and tile j+1's
//   softmax runs while P V(j) is in flight; the two warpgroups' products
//   and softmaxes interleave on their own. (Ping-pong turns between the
//   warpgroups by named barriers measured no faster, and were dropped.)
//   No wgmma sits under a branch (ptxas serializes wgmma it cannot prove
//   warp-uniform): both warpgroups run every key tile of the block, the
//   one tile a side that is wholly masked for one of them included, and
//   the barrier arrivals are predicated inside their asm.
// - Tiles land in the 128-byte swizzle that wgmma's descriptors read: a
//   row of D columns is D / 64 swizzle atoms of 64 columns, each loaded
//   as its own TMA box. D = 96 takes a second 64-column box over columns
//   64..127 that TMA zero-fills past D: Q K^T stops at column 96, and
//   P V computes 32 zero columns that are not stored.
// - Softmax in the log2 domain: log2(e) is folded into the scale and
//   softcap constants and every exponential is ex2.approx; the softcap's
//   tanh(y) is 1 - 2 / (2^(2 log2(e) y) + 1) from ex2.approx and
//   rcp.approx, with 1 / softcap folded into the scale, and the row max is
//   taken on the reciprocal, so each weight is one fma and one ex2. The
//   softmax issues more instructions than the products can hide at
//   D = 256 with a softcap (three MUFU operations a score); a reciprocal
//   by Newton steps on the FMA pipe measured slower. The mask runs only
//   on key tiles that straddle the diagonal, S or the window's lower edge
//   of the warpgroup's rows; the others take an unmasked copy of the same
//   code. The accumulator is rescaled only where a row's max moved.
// Tile sizes: BK = 80 keys at D = 256, 2 stages (Q 64 KB + K and V 40 KB
// a stage: 225 KB of shared memory, one block of 3 warpgroups per SM);
// BK = 128 at D <= 128, 3 stages (225 KB). Wider key tiles re-read Q from
// shared memory less often: Q K^T from shared memory at 64 keys sits at
// the shared-memory rate.
//
// Differences from the TPU kernel, all within f32/bf16 rounding: the
// scale multiplies the f32 logits after the product (the TPU scaled q in
// f32 before it), P is rounded to bf16 for the P V product (the TPU
// multiplied f32 P by f32 V), and exp2 / tanh are the hardware's
// approximations (relative error about 2^-22). For D = 256 the scale is
// 1/16, exact either way. ``ref.py::kernel_arithmetic`` writes this
// arithmetic out in torch; the CPU tests hold it against the plain
// version.
//
// The kernel is deterministic (no atomics; each output element is summed
// in one fixed order), runs on the caller's stream and allocates nothing;
// the host entry point returns a cudaError_t after the launch.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int CONSUMERS = 2;            // warpgroups that compute
constexpr int WG_ROWS = 64;             // query rows per consumer warpgroup
constexpr int BQ = CONSUMERS * WG_ROWS; // query rows per block
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int ATOM = 64;                // bf16 columns of a 128-byte swizzle row
constexpr int ROW_BYTES = 128;
constexpr int GROUP_BYTES = 8 * ROW_BYTES;  // one 8-row swizzle atom
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Cfg {
    static constexpr int DP = (D + ATOM - 1) / ATOM * ATOM;  // columns in smem
    static constexpr int ATOMS = DP / ATOM;
    static constexpr int BK = D > 128 ? 80 : 128;            // keys per tile
    static constexpr int STAGES = D > 128 ? 2 : 3;           // K/V ring depth
    static constexpr int Q_ATOM = BQ * ROW_BYTES;            // one column atom
    static constexpr int KV_ATOM = BK * ROW_BYTES;
    static constexpr int Q_BYTES = ATOMS * Q_ATOM;
    static constexpr int KV_BYTES = ATOMS * KV_ATOM;         // one K or V stage
    static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
    static constexpr int SMEM = BAR_OFF + 8 * (1 + 4 * STAGES) + 1024;
                                                             // + barriers, align
};

struct Params {
    bf16* o;
    long long o_sb, o_sh, o_ss;
    int Hq, group, S, causal, window;   // window <= 0: none
    float c_mul;    // scale * log2(e); with a softcap 2 log2(e) scale / cap
    float c_cap;    // softcap * log2(e)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

// one arrival on `bar`, made by the thread whose `tid` is 0: predicated
// inside the asm, so the warpgroup's code has no divergent branch
__device__ __forceinline__ void arrive_one(uint32_t bar, int tid) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.eq.s32 p, %1, 0;\n"
        "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
        :: "r"(bar), "r"(tid) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed. A wait
// that outlasts ~10 s of SM clocks traps, so a pipeline fault surfaces as
// a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    long long t0 = 0;
    for (;;) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        if (done) return;
        if (t0 == 0) t0 = clock64();
        else if (clock64() - t0 > 20000000000LL) asm volatile("trap;");
    }
}

// one TMA box at coordinates (c0, c1, c2, c3) of `map` into shared memory;
// completion is counted in bytes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
           "r"(c2), "r"(c3), "r"(bar)
        : "memory");
}

// wgmma shared-memory descriptor of a tile in the 128-byte swizzle
// (layout type 1). Atoms are 1024-byte aligned, so stepping the start
// address by 32 bytes selects the next 16 columns of a K-major atom.
// K-major: sbo = stride of 8-row groups, lbo unused. MN-major: lbo =
// stride of 64-column atoms along MN, sbo = stride of 8-row groups along K.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4)
        | ((uint64_t)(lbo >> 4) << 16)
        | ((uint64_t)(sbo >> 4) << 32)
        | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of this warpgroup's committed groups are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pin registers at this point of the program: the compiler does not know
// that wgmma reads and writes them asynchronously, so every access to an
// accumulator or A fragment is fenced in program order around the
// wgmma.fence / wait pair.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N, int M>
__device__ __forceinline__ void pin(uint32_t (&r)[N][M]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ float rcp(float x) {
    float y;
    asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// The wgmma shapes the kernel issues, one inline-asm wrapper each.

// d (64 x 80, f32) (+)= A (64 x 16, smem) * B (16 x 80, smem); both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[40], uint64_t da,
                                         uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128, f32) (+)= A (64 x 16, smem) * B (16 x 128, smem); both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128, f32) += A (64 x 16, registers) * B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256, f32) += A (64 x 16, registers) * B (16 x 256, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// One key tile's online-softmax step on this thread's share of the S
// accumulator (wgmma's layout: register i holds row g + 8 ((i >> 1) & 1)
// of the warp's 16 and column 8 (i >> 2) + 2 tq + (i & 1)). Turns s into
// the unnormalised P, updates the running max m and sum l (this thread's
// part; the quad's parts are added at the end) in the log2 domain, and
// returns the factor alpha that rescales each row's old accumulator.
template <int BK, bool SOFTCAP, bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             const Params& p, int k0,
                                             int row_a, int tq) {
    // Each logit x (log2 domain) is a monotone affine function of u:
    // u = s and x = c_mul s (increasing); or, with a softcap, u = r =
    // 1 / (2^(c_mul s) + 1) and x = c_cap (1 - 2 r) (decreasing). So the
    // row max comes from the row's extreme u, and 2^(x - base) is one fma
    // and one ex2.
    constexpr float NONE = SOFTCAP ? INFINITY : -INFINITY;   // masked u
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
        float u = SOFTCAP ? rcp(ex2(s[i] * p.c_mul) + 1.f) : s[i];
        if (MASK) {
            const int kpos = k0 + (i >> 2) * 8 + 2 * tq + (i & 1);
            const int qpos = row_a + 8 * ((i >> 1) & 1);
            const bool ok = kpos < p.S && (!p.causal || kpos <= qpos)
                && (p.window <= 0 || kpos > qpos - p.window);
            if (!ok) u = NONE;
        }
        s[i] = u;
    }
    const float a = SOFTCAP ? -2.f * p.c_cap : p.c_mul;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float ext = NONE;
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
            if (((i >> 1) & 1) == r)
                ext = SOFTCAP ? fminf(ext, s[i]) : fmaxf(ext, s[i]);
#pragma unroll
        for (int lane = 1; lane < 4; lane *= 2) {
            const float o = __shfl_xor_sync(0xffffffffu, ext, lane);
            ext = SOFTCAP ? fminf(ext, o) : fmaxf(ext, o);
        }
        const float mx = fmaxf(m[r], SOFTCAP ? fmaf(a, ext, p.c_cap)
                                             : ext * p.c_mul);
        const float base = mx == -INFINITY ? 0.f : mx;  // a row with no key yet
        const float b = SOFTCAP ? p.c_cap - base : -base;
        alpha[r] = ex2(m[r] - base);
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
            if (((i >> 1) & 1) == r) {
                s[i] = ex2(fmaf(a, s[i], b));
                sum += s[i];
            }
        }
        l[r] = l[r] * alpha[r] + sum;
        m[r] = mx;
    }
}

// Mask only the key tiles that straddle S, the diagonal or the window's
// lower edge of this warpgroup's rows [r0, r0 + 64).
template <int BK, bool SOFTCAP>
__device__ __forceinline__ void softmax_step(float (&s)[BK / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             const Params& p, int k0, int r0,
                                             int row_a, int tq) {
    const bool edge = k0 + BK > p.S
        || (p.causal && k0 + BK - 1 > r0)
        || (p.window > 0 && k0 <= r0 + WG_ROWS - 1 - p.window);
    if (edge)
        softmax_tile<BK, SOFTCAP, true>(s, m, l, alpha, p, k0, row_a, tq);
    else
        softmax_tile<BK, SOFTCAP, false>(s, m, l, alpha, p, k0, row_a, tq);
}

// O *= alpha of its row, only where some row's max in the warp moved
// (elsewhere alpha == 1 exactly, and skipping the multiply is exact)
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&alpha)[2]) {
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < N; ++i) o[i] *= alpha[(i >> 1) & 1];
    }
}

// P in bf16 as wgmma's register A fragments of keys [16 kk, 16 kk + 16)
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4],
                                       const float (&s)[BK / 2]) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
}

// issue S = Q K^T over D / 16 steps of 16 columns (one commit group)
template <int D>
__device__ __forceinline__ void qk_issue(float (&s)[Cfg<D>::BK / 2],
                                         uint32_t q_wg, uint32_t kst) {
    pin(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;     // bytes
        wgmma_ss(s,
                 sw128_desc(q_wg + (kk / 4) * Cfg<D>::Q_ATOM + col, 16,
                            GROUP_BYTES),
                 sw128_desc(kst + (kk / 4) * Cfg<D>::KV_ATOM + col, 16,
                            GROUP_BYTES),
                 kk > 0);
    }
    wg_commit();
}

// issue O += P V over BK / 16 steps of 16 keys (one commit group)
template <int D>
__device__ __forceinline__ void pv_issue(float (&o)[Cfg<D>::DP / 2],
                                         uint32_t (&pa)[Cfg<D>::BK / 16][4],
                                         uint32_t vst) {
    pin(o);
    pin(pa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < Cfg<D>::BK / 16; ++kk)
        wgmma_rs(o, pa[kk],
                 sw128_desc(vst + kk * 2 * GROUP_BYTES, Cfg<D>::KV_ATOM,
                            GROUP_BYTES));
    wg_commit();
}

template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const Params p) {
    using C = Cfg<D>;
    constexpr int BK = C::BK, STAGES = C::STAGES;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t sk = sq + C::Q_BYTES;            // + stage * KV_BYTES
    const uint32_t sv = sk + STAGES * C::KV_BYTES;
    // mbarriers: Q full, then per stage K full, V full, K empty, V empty
    const uint32_t bar_q = sq + C::BAR_OFF;
#define FULL_K(st) (bar_q + 8 * (1 + (st)))
#define FULL_V(st) (bar_q + 8 * (1 + STAGES + (st)))
#define EMPTY_K(st) (bar_q + 8 * (1 + 2 * STAGES + (st)))
#define EMPTY_V(st) (bar_q + 8 * (1 + 3 * STAGES + (st)))

    const int qt = gridDim.x - 1 - blockIdx.x;  // longest rows first
    const int b = blockIdx.y / p.Hq, h = blockIdx.y % p.Hq;
    const int hk = h / p.group;
    const int S = p.S;
    const int q0 = qt * BQ;
    // key tiles [n_lo, n_hi) hold every key some row of this block sees
    const int n_hi = ((p.causal ? min(q0 + BQ, S) : S) + BK - 1) / BK;
    const int n_lo = p.window > 0 ? max(q0 - (p.window - 1), 0) / BK : 0;

    if (threadIdx.x == 0) {
        mbar_init(bar_q, 1);
        for (int st = 0; st < STAGES; ++st) {
            mbar_init(FULL_K(st), 1);
            mbar_init(FULL_V(st), 1);
            mbar_init(EMPTY_K(st), CONSUMERS);
            mbar_init(EMPTY_V(st), CONSUMERS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // the warpgroup index, broadcast from lane 0 so that the compiler sees
    // it (and every branch on it) as warp-uniform: wgmma in a branch it
    // thinks divergent is serialized
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
    if (wg == CONSUMERS) {
        // producer warpgroup: one thread keeps the ring full
        asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
        if (threadIdx.x == CONSUMERS * 128) {
            mbar_expect_tx(bar_q, C::Q_BYTES);
            for (int c = 0; c < C::ATOMS; ++c)
                tma_load(sq + c * C::Q_ATOM, &tm_q, bar_q, c * ATOM, q0, h, b);
            for (int j = n_lo, it = 0; j < n_hi; ++j, ++it) {
                const int st = it % STAGES;
                const uint32_t ph = (it / STAGES) & 1;
                mbar_wait(EMPTY_K(st), ph ^ 1);     // passes at first use
                mbar_expect_tx(FULL_K(st), C::KV_BYTES);
                for (int c = 0; c < C::ATOMS; ++c)
                    tma_load(sk + st * C::KV_BYTES + c * C::KV_ATOM, &tm_k,
                             FULL_K(st), c * ATOM, j * BK, hk, b);
                mbar_wait(EMPTY_V(st), ph ^ 1);
                mbar_expect_tx(FULL_V(st), C::KV_BYTES);
                for (int c = 0; c < C::ATOMS; ++c)
                    tma_load(sv + st * C::KV_BYTES + c * C::KV_ATOM, &tm_v,
                             FULL_V(st), c * ATOM, j * BK, hk, b);
            }
        }
    } else {
        // consumer warpgroup wg: query rows [r0, r0 + 64)
        asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
        const int tid = threadIdx.x % 128;
        const int warp = tid / 32, lane = tid % 32;
        const int g = lane / 4, tq = lane % 4;
        const int r0 = q0 + wg * WG_ROWS;
        const int row_a = r0 + warp * 16 + g;   // this thread's rows: row_a, +8
        float o[C::DP / 2];
        float s[BK / 2];
#pragma unroll
        for (int i = 0; i < C::DP / 2; ++i) o[i] = 0.f;
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
        float m[2] = {-INFINITY, -INFINITY};
        float l[2] = {0.f, 0.f};
        float alpha[2];
        uint32_t pa[BK / 16][4];
        const uint32_t q_wg = sq + wg * WG_ROWS * ROW_BYTES;
        mbar_wait(bar_q, 0);

        // Both warpgroups run every key tile of the block: a tile wholly
        // masked for one of them (at most one a side) costs ~2 % at
        // S = 8192, and no wgmma sits under a branch, which ptxas would
        // serialize. Tile t = j - n_lo sits in stage t % STAGES. Software
        // pipeline: Q K(j+1)^T is issued with P V(j), O's rescale by tile
        // j's alpha runs under Q K(j+1)^T, and the softmax of tile j+1
        // runs while P V(j) is on the tensor cores.
        const int n = n_hi - n_lo;
        mbar_wait(FULL_K(0), 0);
        qk_issue<D>(s, q_wg, sk);
        wg_wait<0>();
        pin(s);
        arrive_one(EMPTY_K(0), tid);
        softmax_step<BK, SOFTCAP>(s, m, l, alpha, p, n_lo * BK, r0, row_a,
                                  tq);
        pack_p<BK>(pa, s);
        for (int t = 0; t + 1 < n; ++t) {
            const int j = n_lo + t;
            const int st = t % STAGES, st1 = (t + 1) % STAGES;
            mbar_wait(FULL_K(st1), ((t + 1) / STAGES) & 1);
            qk_issue<D>(s, q_wg, sk + st1 * C::KV_BYTES);
            rescale<C::DP / 2>(o, alpha);       // under Q K(j+1)^T
            mbar_wait(FULL_V(st), (t / STAGES) & 1);
            pv_issue<D>(o, pa, sv + st * C::KV_BYTES);
            wg_wait<1>();           // Q K(j+1)^T done; P V(j) runs on
            pin(s);
            arrive_one(EMPTY_K(st1), tid);
            softmax_step<BK, SOFTCAP>(s, m, l, alpha, p, (j + 1) * BK, r0,
                                      row_a, tq);
            wg_wait<0>();
            pin(o);
            pin(pa);
            arrive_one(EMPTY_V(st), tid);
            pack_p<BK>(pa, s);
        }
        {
            const int st = (n - 1) % STAGES;
            rescale<C::DP / 2>(o, alpha);
            mbar_wait(FULL_V(st), ((n - 1) / STAGES) & 1);
            pv_issue<D>(o, pa, sv + st * C::KV_BYTES);
            wg_wait<0>();
            pin(o);
            pin(pa);
            arrive_one(EMPTY_V(st), tid);
        }

#pragma unroll
        for (int r = 0; r < 2; ++r) {
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
            l[r] = 1.f / fmaxf(l[r], 1e-30f);
        }
        bf16* og = p.o + b * p.o_sb + h * p.o_sh;
        const int row_b = row_a + 8;
#pragma unroll
        for (int nb = 0; nb < D / 8; ++nb) {
            const int d = nb * 8 + 2 * tq;
            if (row_a < S)
                *reinterpret_cast<uint32_t*>(og + row_a * p.o_ss + d) =
                    pack_bf16(o[4 * nb] * l[0], o[4 * nb + 1] * l[0]);
            if (row_b < S)
                *reinterpret_cast<uint32_t*>(og + row_b * p.o_ss + d) =
                    pack_bf16(o[4 * nb + 2] * l[1], o[4 * nb + 3] * l[1]);
        }
    }
#undef FULL_K
#undef FULL_V
#undef EMPTY_K
#undef EMPTY_V
}

// cuTensorMapEncodeTiled from the driver, fetched through the runtime so
// that the library needs no -lcuda
typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* f = nullptr;
        cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                         cudaEnableDefault, &q);
#else
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q);
#endif
        if (q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)f;
    }
    return fn;
}

// A 4-D map (D, S, H, B) over a bf16 tensor with element strides
// (sb, sh, ss) and a unit last stride, read in boxes of 64 columns x
// `rows` rows in the 128-byte swizzle; reads past an edge fill zeros.
int tensor_map(CUtensorMap* map, const void* ptr, int D, int S, int H, int B,
               long long sb, long long sh, long long ss, int rows) {
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
    const cuuint64_t dim[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                               (cuuint64_t)B};
    const long long elem[3] = {ss, sh, sb};
    cuuint64_t stride[3];
    for (int i = 0; i < 3; ++i)     // an axis of extent 1 is never stepped
        stride[i] = dim[i + 1] > 1 ? (cuuint64_t)elem[i] * sizeof(bf16)
            : (i == 0 ? (cuuint64_t)D * sizeof(bf16) : stride[i - 1] * dim[i]);
    const cuuint32_t box[4] = {ATOM, (cuuint32_t)rows, 1, 1};
    const cuuint32_t step[4] = {1, 1, 1, 1};
    const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                          const_cast<void*>(ptr), dim, stride, box, step,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D, bool SOFTCAP>
int run(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
        const Params& p, int B, cudaStream_t stream) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D, SOFTCAP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::SMEM);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((p.S + BQ - 1) / BQ, B * p.Hq);
    flash_fwd_kernel<D, SOFTCAP><<<grid, THREADS, Cfg<D>::SMEM, stream>>>(
        tq, tk, tv, p);
    return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int S, const long long* st, int causal,
           int window, float softcap, float scale, cudaStream_t stream) {
    CUtensorMap tq, tk, tv;
    int e = tensor_map(&tq, q, D, S, Hq, B, st[0], st[1], st[2], BQ);
    if (e == 0) e = tensor_map(&tk, k, D, S, Hkv, B, st[3], st[4], st[5],
                               Cfg<D>::BK);
    if (e == 0) e = tensor_map(&tv, v, D, S, Hkv, B, st[6], st[7], st[8],
                               Cfg<D>::BK);
    if (e != 0) return e;
    Params p;
    p.o = (bf16*)o;
    p.o_sb = st[9]; p.o_sh = st[10]; p.o_ss = st[11];
    p.Hq = Hq;
    p.group = Hq / Hkv;
    p.S = S;
    p.causal = causal;
    p.window = window;
    if (softcap > 0.f) {
        p.c_mul = 2.f * LOG2E * scale / softcap;
        p.c_cap = softcap * LOG2E;
        return run<D, true>(tq, tk, tv, p, B, stream);
    }
    p.c_mul = scale * LOG2E;
    p.c_cap = 0.f;
    return run<D, false>(tq, tk, tv, p, B, stream);
}

}  // namespace

// strides: 12 element strides (batch, head, row) of q, k, v, o in that
// order; the last dimension must be contiguous, the others multiples of 8
// elements, the bases 16-byte aligned (TMA's rules). window <= 0 and
// softcap <= 0 mean none. Returns a cudaError_t (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int Hq,
                                   int Hkv, int S, int D,
                                   const long long* strides, int causal,
                                   int window, float softcap, float scale,
                                   void* stream) {
    if (B <= 0 || S <= 0 || Hq <= 0) return 0;
    if (Hkv <= 0 || Hq % Hkv != 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    switch (D) {
        case 96: return launch<96>(q, k, v, o, B, Hq, Hkv, S, strides, causal,
                                   window, softcap, scale, st);
        case 128: return launch<128>(q, k, v, o, B, Hq, Hkv, S, strides,
                                     causal, window, softcap, scale, st);
        case 256: return launch<256>(q, k, v, o, B, Hq, Hkv, S, strides,
                                     causal, window, softcap, scale, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* repro_error_string(int e) {
    return cudaGetErrorString((cudaError_t)e);
}
