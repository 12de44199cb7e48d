// Sorted-row intersection for conflicted-cycle separation (RAMA §3.2.2).
//
// Replaces the TPU kernel src/repro/kernels/cycle_intersect/kernel.py
// (intersect_rows_pallas, body _intersect_kernel).
//
// Computes, for each ci[r, p], the index of the LAST element of row r of
// cj equal to it, or -1. cj rows are sorted ascending (sentinel N last);
// ci need not be sorted (the 4-cycle chord test passes an unsorted fan).
// Sentinels match sentinels; callers mask by window validity.
//
// Bound on an H100: memory. The function must read ci and cj once and
// write the output once, 4 B each; the binary search does at most
// ceil(log2(Wj + 1)) compares per element (8 for Wj = 128) out of shared
// memory, far below the card's integer rate. On the solver's path the
// rows are short (R = 32..1 024, W and Wj of 4..128: a few KB), so a call
// costs its launch, not its bytes.
//
// Design: the TPU kernel compared every (i, j) pair by broadcast, because
// a vector unit has no cheap data-dependent branching. Here each element
// does one upper-bound search (O(W log Wj) per row, not O(W Wj)). Warps
// own rows: G = 32 / W rows a warp when W < 32, one element a lane, so
// W = 4 or 16 still fills the warp; one row a warp when W = 32; two warps
// a row when 32 < W <= 64 and four when W > 64, so that at the solver's
// W = 128 each lane runs one search, not four in a row (these calls are
// latency-bound), unless R >= 2 048 rows already fill the card with
// warps, where one warp a row reads each cj row once. A lane's row and
// column come from one division when the thread starts, not one per
// element. Each warp stages its G cj rows (contiguous in memory) in its
// own slice of shared memory, by 16-byte cp.async copies when Wj is a
// multiple of 4 (no registers: staging through int4 registers made ptxas
// spill), the warps of a row each their own copy (512 B at Wj = 128);
// then each lane searches there. Blocks of 4 warps: R = 32 rows of
// W = 128 run as 32 blocks. The search takes the same number of steps on
// every lane (binary lifting over powers of two from the largest <= Wj),
// so a warp never diverges on it. A cj row of more than kWarpInts ints
// (the (8, 1, 20000) case) is searched in device memory instead. There is
// no host padding: any R, W and Wj work. The result is the upper bound
// torch.searchsorted(right=True) returns, so it equals the plain version
// exactly. Allocates nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpInts = 3072;         // 12 KB of cj rows per warp
constexpr int kFullWarps = 2048;        // ~16 resident warps on 132 SMs

template <bool STAGE, bool VEC>
__global__ void __launch_bounds__(kThreads)
cycle_intersect_kernel(const int* __restrict__ ci, const int* __restrict__ cj,
                       int* __restrict__ out, long long R, int W, int Wj,
                       int G, int wshift, int top) {
    extern __shared__ int smem[];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    // global warp gw serves part sub of row group gw / wpr, wpr = 2^wshift
    const long long gw = (long long)blockIdx.x * kWarps + warp;
    const long long r0 = (gw >> wshift) * G;
    const int sub = (int)(gw & ((1 << wshift) - 1));
    if (r0 >= R) return;
    const int rows = R - r0 < G ? (int)(R - r0) : G;
    // this lane's row lr of the group, its first element p0, its stride
    const int lr = G == 1 ? 0 : lane / W;
    const int p0 = G == 1 ? sub * 32 + lane : lane - lr * W;
    const int step = G == 1 ? 32 << wshift : W;
    const int* row;
    if (STAGE) {
        int* srow = smem + warp * G * Wj;
        const int n = rows * Wj;
        const int* src = cj + r0 * Wj;
        if (VEC) {      // Wj % 4 == 0 and cj 16-byte aligned: so are both
            const uint32_t dst = (uint32_t)__cvta_generic_to_shared(srow);
            for (int i = lane; i < n / 4; i += 32)
                asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                             :: "r"(dst + 16 * i), "l"(src + 4 * i)
                             : "memory");
            asm volatile("cp.async.wait_all;\n" ::: "memory");
        } else {
            for (int i = lane; i < n; i += 32) srow[i] = __ldg(src + i);
        }
        __syncwarp();
        row = srow + lr * Wj;
    } else {
        row = cj + (r0 + lr) * Wj;
    }
    if (lr >= rows) return;
    const int* cir = ci + (r0 + lr) * W;
    int* outr = out + (r0 + lr) * W;
    for (int p = p0; p < W; p += step) {
        const int x = __ldg(cir + p);
        int pos = 0;                    // elements of the row <= x
        for (int s = top; s > 0; s >>= 1) {
            const int q = pos + s;
            if (q <= Wj && row[q - 1] <= x) pos = q;
        }
        outr[p] = (pos > 0 && row[pos - 1] == x) ? pos - 1 : -1;
    }
}

}  // namespace

// ci (R, W), cj (R, Wj), out (R, W) int32, contiguous, on `device`; the
// launch goes to `stream`. `device` is made current only when it is not,
// and the previous device is restored. Returns a cudaError_t.
extern "C" int cycle_intersect_rows(const void* ci, const void* cj,
                                    void* out, long long R, int W, int Wj,
                                    int device, void* stream) {
    if (R <= 0 || W <= 0 || Wj <= 0) return 0;
    // G rows a warp (W < 32), or 2^wshift warps a row (32 < W, while R
    // alone does not fill the card with warps)
    int G = W >= 32 ? 1 : 32 / W;
    const int wshift = W <= 32 || R >= kFullWarps ? 0 : W <= 64 ? 1 : 2;
    int stage = 1;
    if (Wj > kWarpInts) stage = 0;
    else if (G * Wj > kWarpInts) G = kWarpInts / Wj;
    int top = 1;
    while (2 * top <= Wj) top *= 2;
    const long long warps = (R + G - 1) / G << wshift;
    const long long blocks = (warps + kWarps - 1) / kWarps;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    const size_t smem = stage ? (size_t)kWarps * G * Wj * sizeof(int) : 0;
    int prev = 0;
    cudaError_t e = cudaGetDevice(&prev);
    if (e != cudaSuccess) return (int)e;
    if (prev != device && (e = cudaSetDevice(device)) != cudaSuccess)
        return (int)e;
    auto kernel = !stage ? cycle_intersect_kernel<false, false>
        : Wj % 4 == 0 && (uintptr_t)cj % 16 == 0
            ? cycle_intersect_kernel<true, true>
            : cycle_intersect_kernel<true, false>;
    kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
        (const int*)ci, (const int*)cj, (int*)out, R, W, Wj, G, wshift,
        top);
    e = cudaGetLastError();
    if (prev != device) cudaSetDevice(prev);
    return (int)e;
}

// The same launch with its arguments packed as 64-bit words (device, ci,
// cj, out, R, W, Wj), as the wrapper's launcher passes them: ctypes then
// converts two arguments instead of eight.
extern "C" int cycle_intersect_launch(const long long* a, void* stream) {
    return cycle_intersect_rows((const void*)a[1], (const void*)a[2],
                                (void*)a[3], a[4], (int)a[5], (int)a[6],
                                (int)a[0], stream);
}

extern "C" const char* repro_error_string(int e) {
    return cudaGetErrorString((cudaError_t)e);
}
