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
// memory, far below the card's integer rate.
//
// Design: the TPU kernel compared every (i, j) pair by broadcast, because
// a vector unit has no cheap data-dependent branching. A GPU thread does,
// so each element does one upper-bound binary search instead
// (O(W log Wj) per row, not O(W Wj)). A block of 128 threads owns a group
// of rows: it stages those rows of cj in shared memory (coalesced), then
// each thread searches for its ci elements there. Rows per block =
// 128 / W (at least 1), so narrow windows (W = 4, 16) still fill the
// block; when even one cj row exceeds the 48 KB of static-launch shared
// memory the block searches cj in device memory instead. There is no host
// padding: the last block masks its ragged tail, and any R, W, Wj work.
// The search is the same upper bound torch.searchsorted(right=True) runs,
// so the result equals the plain version exactly. Allocates nothing.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSmemBytes = 48 * 1024;

__device__ __forceinline__ int upper_bound(const int* row, int n, int x) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = lo + ((hi - lo) >> 1);
        if (row[mid] <= x) lo = mid + 1; else hi = mid;
    }
    return lo;
}

__global__ void cycle_intersect_kernel(const int* __restrict__ ci,
                                       const int* __restrict__ cj,
                                       int* __restrict__ out,
                                       long long R, int W, int Wj,
                                       int rows_per_block, int stage) {
    extern __shared__ int smem[];
    const long long r0 = (long long)blockIdx.x * rows_per_block;
    const long long left = R - r0;
    const int nrows = left < rows_per_block ? (int)left : rows_per_block;
    if (stage) {
        const int n = nrows * Wj;
        const int* src = cj + r0 * Wj;
        for (int i = threadIdx.x; i < n; i += blockDim.x) smem[i] = src[i];
        __syncthreads();
    }
    const int n = nrows * W;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int lr = i / W;
        const int p = i - lr * W;
        const long long r = r0 + lr;
        const int* row = stage ? smem + (long long)lr * Wj : cj + r * Wj;
        const int x = ci[r * W + p];
        const int pos = upper_bound(row, Wj, x) - 1;
        out[r * W + p] = (pos >= 0 && row[pos] == x) ? pos : -1;
    }
}

}  // namespace

extern "C" int cycle_intersect_rows(const void* ci, const void* cj,
                                    void* out, long long R, int W, int Wj,
                                    void* stream) {
    if (R <= 0 || W <= 0) return 0;
    int rows = kThreads / W;
    if (rows < 1) rows = 1;
    int stage = 1;
    const long long row_bytes = 4LL * Wj;
    if (row_bytes > kSmemBytes) {
        stage = 0;
    } else if (rows * row_bytes > kSmemBytes) {
        rows = (int)(kSmemBytes / row_bytes);
    }
    const long long blocks = (R + rows - 1) / rows;
    const size_t smem = stage ? (size_t)(rows * row_bytes) : 0;
    cycle_intersect_kernel<<<(unsigned)blocks, kThreads, smem,
                             (cudaStream_t)stream>>>(
        (const int*)ci, (const int*)cj, (int*)out, R, W, Wj, rows, stage);
    return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int e) {
    return cudaGetErrorString((cudaError_t)e);
}
