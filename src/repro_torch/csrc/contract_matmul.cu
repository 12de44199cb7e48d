// Float32 matrix product with an optional zero-diagonal epilogue, for the
// edge-contraction product A' = KᵀAK − diag (RAMA Lemma 4), on Hopper's
// tensor cores in 3xTF32.
//
// Replaces the TPU kernel src/repro/kernels/contract_matmul/kernel.py
// (matmul_pallas :58, body _matmul_kernel :22). Like it, this is a general
// product out = x @ y of float32 inputs with float32 results, for any M, N
// and K, not one specialised to the one-hot K; with drop_diag set, the
// entries whose global row equals their global column are written as 0.
//
// Bound on an H100: operations. contract_matmul is two products,
// 2·N·N·M + 2·M·N·M flops for A (N, N) and K (N, M). On the FP32 pipes
// (67 TFLOP/s) that is 116.5 ms at the Lemma 4 shape (N = 16 384,
// M = 9 282). One TF32 product keeps 11 bits of each operand, ~1e-4 of
// max |out|, which the callers' 1e-5 gate rejects; three recover float32:
// with a = a_hi + a_lo, each part rounded to TF32,
// a·b ≈ a_lo·b_hi + a_hi·b_lo + a_hi·b_hi (the dropped a_lo·b_lo is
// ~2^-22 of a·b). Three TF32 products at 495 TFLOP/s bound the same work
// at 47.3 ms.
//
// Design: two kernels.
// - Split (contract_split_kernel): reads an operand once through its
//   strides and writes two planes, hi = cvt.rna.tf32(a) and
//   lo = cvt.rna.tf32(a − hi), each (rows, Kp) row-major with the
//   reduction axis contiguous. wgmma reads 32-bit operands only K-major
//   from shared memory (the transpose immediates exist for 16-bit types
//   only), so y is written transposed, and a transposed view (Kᵀ) costs
//   what a contiguous one does. Kp is K rounded up to 4 floats (TMA's
//   16-byte stride rule), the pad zeroed. A 32×32 tile goes through shared
//   memory, so reads and writes coalesce whichever input axis has unit
//   stride.
// - Product (contract_product_kernel): a block owns a 128 × 128 output
//   tile. One producer thread loads the hi and lo tiles of x and y, 32
//   floats of K at a time (one 128-byte swizzle row), by TMA into a ring of
//   3 stages (192 KB) with full and empty mbarriers; TMA's zero fill past
//   M, N and K replaces predicated loads. Two consumer warpgroups own 64
//   rows each and issue, per K-step, four k8 slices of
//   wgmma.m64n128k8.f32.tf32.tf32 for each of lo·hi, hi·lo and hi·hi into
//   one float32 accumulator (the small terms first); a warpgroup keeps one
//   K-step's products in flight and frees the stage of the step before.
//   The ragged-edge masks and the diagonal drop are fused into the store.
//   Tiles run in groups of 8 row tiles, so the blocks in flight share their
//   x and y tiles in L2. 128 × 256 tiles (two stages fit) measured slower
//   at both large shapes on the H100.
// There is no split-K: each output element is summed by one warpgroup in
// one fixed order, so two launches give the same bits, and so do strided
// and contiguous inputs (the split writes the same planes). The plain
// version (cuBLAS in full float32, or the CPU) sums in another order with
// unsplit operands; the two agree to ~1e-7 of max |out|. ref.py's
// matmul_3xtf32 writes this arithmetic out in torch for the CPU tests.
// Scratch: the planes, 2·(M + N)·Kp floats, allocated by the wrapper.
// Allocates nothing; runs on the caller's stream; the entry points return a
// cudaError_t after the launch.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CONSUMERS = 2;                // warpgroups that compute
constexpr int BM = 64 * CONSUMERS;          // output rows per block
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int BK = 32;                      // floats of K per stage
constexpr int ROW_BYTES = BK * 4;           // one 128-byte swizzle row
constexpr int GROUP_BYTES = 8 * ROW_BYTES;  // one 8-row swizzle atom
constexpr int GROUP_M = 8;                  // row tiles per raster group

constexpr int BN = 128;                     // output columns per block
constexpr int STAGES = 3;                   // depth of the TMA ring
constexpr int X_BYTES = BM * ROW_BYTES;     // one plane's tile of x
constexpr int Y_BYTES = BN * ROW_BYTES;     // one plane's tile of y
constexpr int STAGE_BYTES = 2 * (X_BYTES + Y_BYTES);
constexpr int BAR_OFF = STAGES * STAGE_BYTES;
constexpr int SMEM = BAR_OFF + 8 * 2 * STAGES + 1024;  // + barriers, align

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

// one TMA box at (c0, c1, c2) of `map` into shared memory; completion is
// counted in bytes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
           "r"(c2), "r"(bar)
        : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle
// (layout type 1): sbo = stride of 8-row groups, lbo unused. Atoms are
// 1024-byte aligned, so stepping the start address by 32 bytes selects the
// next 8 floats of K.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4)
        | ((uint64_t)(16 >> 4) << 16)
        | ((uint64_t)(GROUP_BYTES >> 4) << 32)
        | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pin the accumulator at this point of the program: the compiler does not
// know that wgmma reads and writes it asynchronously.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// d (64 x 128, f32) += A (64 x 8, smem) * B (8 x 128, smem); tf32, K-major
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da,
                                           uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1;\n}\n"
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
        : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ float tf32_rna(float a) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
    return __uint_as_float(r & 0xFFFFE000u);
}

// hi/lo planes of a (R, K) operand read through element strides (sr, sk):
// plane[0] = hi, plane[1] = lo, each (R, Kp) row-major, zero past K.
// A block of 32 x 8 threads moves one 32 x 32 tile through shared memory;
// `r_fast` says that the input's unit-stride axis is R, so the loads walk
// R across neighbouring threads and the stores walk K.
__global__ void __launch_bounds__(256)
contract_split_kernel(const float* __restrict__ a,
                      float* __restrict__ planes, long long R, long long K,
                      long long Kp, long long sr, long long sk, int r_fast) {
    __shared__ float t[32][33];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const long long r0 = (long long)blockIdx.x * 32;
    const long long k0 = (long long)blockIdx.y * 32;
#pragma unroll
    for (int j = ty; j < 32; j += 8) {
        const long long r = r0 + (r_fast ? tx : j);
        const long long k = k0 + (r_fast ? j : tx);
        const float v = (r < R && k < K) ? __ldg(a + r * sr + k * sk) : 0.f;
        if (r_fast) t[tx][j] = v; else t[j][tx] = v;
    }
    __syncthreads();
    float* hi = planes;
    float* lo = planes + R * Kp;
#pragma unroll
    for (int j = ty; j < 32; j += 8) {
        const long long r = r0 + j, k = k0 + tx;
        if (r < R && k < Kp) {
            const float v = t[j][tx];
            const float h = tf32_rna(v);
            hi[r * Kp + k] = h;
            lo[r * Kp + k] = tf32_rna(v - h);
        }
    }
}

struct Params {
    float* out;
    int M, N, K, tiles_m, tiles_n, drop_diag, n_even;
};

// out (M, N) = x @ y from x's planes (2, M, Kp) and y's transposed planes
// (2, N, Kp), read by the TMA maps tm_x and tm_y
__global__ void __launch_bounds__(THREADS, 1)
contract_product_kernel(const __grid_constant__ CUtensorMap tm_x,
                        const __grid_constant__ CUtensorMap tm_y,
                        const Params p) {
    extern __shared__ unsigned char smem_raw[];
    const uint32_t s0 = (smem_u32(smem_raw) + 1023u) & ~1023u;
    // stage st: x hi, x lo, y hi, y lo at s0 + st * STAGE_BYTES
    const uint32_t bar0 = s0 + BAR_OFF;
#define FULL(st) (bar0 + 8 * (st))
#define EMPTY(st) (bar0 + 8 * (STAGES + (st)))

    // grouped raster: GROUP_M row tiles walk the column tiles together
    const int per_group = GROUP_M * p.tiles_n;
    const int t = blockIdx.x;
    const int first_m = (t / per_group) * GROUP_M;
    const int gsize = min(p.tiles_m - first_m, GROUP_M);
    const int tm = first_m + (t % per_group) % gsize;
    const int tn = (t % per_group) / gsize;
    const int m0 = tm * BM, n0 = tn * BN;
    const int nk = (p.K + BK - 1) / BK;

    if (threadIdx.x == 0) {
        for (int st = 0; st < STAGES; ++st) {
            mbar_init(FULL(st), 1);
            mbar_init(EMPTY(st), CONSUMERS);
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
        if (threadIdx.x == CONSUMERS * 128) {
            for (int it = 0; it < nk; ++it) {
                const int st = it % STAGES;
                const uint32_t ph = (it / STAGES) & 1;
                const uint32_t base = s0 + st * STAGE_BYTES;
                mbar_wait(EMPTY(st), ph ^ 1);       // passes at first use
                mbar_expect_tx(FULL(st), STAGE_BYTES);
                const int k = it * BK;
                tma_load(base, &tm_x, FULL(st), k, m0, 0);
                tma_load(base + X_BYTES, &tm_x, FULL(st), k, m0, 1);
                tma_load(base + 2 * X_BYTES, &tm_y, FULL(st), k, n0, 0);
                tma_load(base + 2 * X_BYTES + Y_BYTES, &tm_y, FULL(st),
                         k, n0, 1);
            }
        }
    } else {
        // consumer warpgroup wg: output rows [m0 + 64 wg, m0 + 64 wg + 64)
        const int tid = threadIdx.x % 128;
        float acc[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
        const uint32_t xoff = wg * 64 * ROW_BYTES;
        for (int it = 0; it < nk; ++it) {
            const int st = it % STAGES;
            const uint32_t base = s0 + st * STAGE_BYTES;
            const uint32_t xh = base + xoff, xl = xh + X_BYTES;
            const uint32_t yh = base + 2 * X_BYTES, yl = yh + Y_BYTES;
            mbar_wait(FULL(st), (it / STAGES) & 1);
            pin(acc);
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 8; ++kk) {
                const uint32_t c = kk * 32;         // bytes
                wgmma_tf32(acc, sw128_desc(xl + c), sw128_desc(yh + c));
                wgmma_tf32(acc, sw128_desc(xh + c), sw128_desc(yl + c));
                wgmma_tf32(acc, sw128_desc(xh + c), sw128_desc(yh + c));
            }
            wg_commit();
            wg_wait<1>();       // step it - 1's products are done
            pin(acc);
            if (it > 0) arrive_one(EMPTY((it - 1) % STAGES), tid);
        }
        wg_wait<0>();
        pin(acc);

        // store: register i holds row 16 warp + g + 8 ((i >> 1) & 1) and
        // column 8 (i >> 2) + 2 tq + (i & 1) of the warpgroup's 64 x BN
        const int warp = tid / 32, lane = tid % 32;
        const int g = lane / 4, tq = lane % 4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = m0 + wg * 64 + warp * 16 + g + 8 * h;
            if (row >= p.M) continue;
            float* orow = p.out + (long long)row * p.N;
#pragma unroll
            for (int nb = 0; nb < BN / 8; ++nb) {
                const int col = n0 + nb * 8 + 2 * tq;
                float v0 = acc[4 * nb + 2 * h], v1 = acc[4 * nb + 2 * h + 1];
                if (p.drop_diag) {
                    if (row == col) v0 = 0.f;
                    if (row == col + 1) v1 = 0.f;
                }
                if (p.n_even && col + 1 < p.N) {
                    *reinterpret_cast<float2*>(orow + col) =
                        make_float2(v0, v1);
                } else {
                    if (col < p.N) orow[col] = v0;
                    if (col + 1 < p.N) orow[col + 1] = v1;
                }
            }
        }
    }
#undef FULL
#undef EMPTY
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

// A 3-D map (K, rows, plane) over planes (2, rows, Kp) of float32, read in
// boxes of BK floats x `box_rows` rows in the 128-byte swizzle; reads past
// K or past the last row fill zeros.
int plane_map(CUtensorMap* map, const void* planes, long long rows,
              long long K, long long Kp, int box_rows) {
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
    const cuuint64_t dim[3] = {(cuuint64_t)K, (cuuint64_t)rows, 2};
    const cuuint64_t stride[2] = {(cuuint64_t)Kp * 4,
                                  (cuuint64_t)(rows * Kp * 4)};
    const cuuint32_t box[3] = {BK, (cuuint32_t)box_rows, 1};
    const cuuint32_t step[3] = {1, 1, 1};
    const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                          const_cast<void*>(planes), dim, stride, box, step,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

int product(const void* xp, const void* yp, float* out, long long M,
            long long N, long long K, long long Kp, int drop_diag,
            cudaStream_t stream) {
    CUtensorMap tx, ty;
    int e = plane_map(&tx, xp, M, K, Kp, BM);
    if (e == 0) e = plane_map(&ty, yp, N, K, Kp, BN);
    if (e != 0) return e;
    Params p;
    p.out = out;
    p.M = (int)M;
    p.N = (int)N;
    p.K = (int)K;
    p.tiles_m = (int)((M + BM - 1) / BM);
    p.tiles_n = (int)((N + BN - 1) / BN);
    p.drop_diag = drop_diag;
    p.n_even = (N % 2) == 0;
    const cudaError_t a = cudaFuncSetAttribute(
        contract_product_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (a != cudaSuccess) return (int)a;
    const long long tiles = (long long)p.tiles_m * p.tiles_n;
    if (tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
    contract_product_kernel<<<(unsigned)tiles, THREADS, SMEM, stream>>>(
        tx, ty, p);
    return (int)cudaGetLastError();
}

// Make `device` current for this thread when it is not, and put back the
// previous one when the launch is done.
struct DeviceGuard {
    int prev = -1;
    cudaError_t err = cudaSuccess;
    explicit DeviceGuard(int device) {
        int cur = 0;
        err = cudaGetDevice(&cur);
        if (err == cudaSuccess && cur != device) {
            err = cudaSetDevice(device);
            prev = cur;
        }
    }
    ~DeviceGuard() {
        if (prev >= 0) cudaSetDevice(prev);
    }
};

}  // namespace

// hi/lo TF32 planes (2, R, Kp) of an (R, K) float32 operand read through
// element strides (sr, sk); Kp >= K, a multiple of 4. The arguments come
// packed as 64-bit words: device, a, planes, R, K, Kp, sr, sk. Returns a
// cudaError_t.
extern "C" int contract_matmul_split(const long long* w, void* stream) {
    const int device = (int)w[0];
    const void* a = (const void*)w[1];
    void* planes = (void*)w[2];
    const long long R = w[3], K = w[4], Kp = w[5], sr = w[6], sk = w[7];
    if (R <= 0 || Kp <= 0) return 0;
    if (Kp < K || Kp % 4 != 0) return (int)cudaErrorInvalidValue;
    const long long gx = (R + 31) / 32, gy = (Kp + 31) / 32;
    if (gx > 2147483647LL || gy > 65535) return (int)cudaErrorInvalidValue;
    DeviceGuard guard(device);
    if (guard.err != cudaSuccess) return (int)guard.err;
    const int r_fast = sk != 1 && sr == 1;
    contract_split_kernel<<<dim3((unsigned)gx, (unsigned)gy), dim3(32, 8),
                            0, (cudaStream_t)stream>>>(
        (const float*)a, (float*)planes, R, K, Kp, sr, sk, r_fast);
    return (int)cudaGetLastError();
}

// out (M, N) row-major = x @ y from x's planes (2, M, Kp) and y's
// transposed planes (2, N, Kp) (contract_matmul_split of y viewed as
// (N, K)). The arguments come packed as 64-bit words: device, xp, yp, out,
// M, N, K, Kp, drop_diag. Returns a cudaError_t.
extern "C" int contract_matmul_product(const long long* w, void* stream) {
    const int device = (int)w[0];
    const void* xp = (const void*)w[1];
    const void* yp = (const void*)w[2];
    void* out = (void*)w[3];
    const long long M = w[4], N = w[5], K = w[6], Kp = w[7];
    const int drop_diag = (int)w[8];
    if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
    if (M > 2147483647LL || N > 2147483647LL || K > 2147483647LL)
        return (int)cudaErrorInvalidValue;
    DeviceGuard guard(device);
    if (guard.err != cudaSuccess) return (int)guard.err;
    return product(xp, yp, (float*)out, M, N, K, Kp, drop_diag,
                   (cudaStream_t)stream);
}

extern "C" const char* repro_error_string(int e) {
    return cudaGetErrorString((cudaError_t)e);
}
