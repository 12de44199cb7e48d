// Float32 matrix product with an optional zero-diagonal epilogue, for the
// edge-contraction product A' = KᵀAK − diag (RAMA Lemma 4).
//
// Replaces the TPU kernel src/repro/kernels/contract_matmul/kernel.py
// (matmul_pallas :48, body _matmul_kernel :22). Like it, this is a general
// product out = x @ y of float32 inputs with float32 accumulation, not one
// specialised to the one-hot K; with drop_diag set, the entries whose
// global row equals their global column are written as 0.
//
// Bound on an H100: operations. contract_matmul is two products,
// 2·N·N·M + 2·M·N·M flops for A (N, N) and K (N, M), against the card's
// 67 TFLOP/s of float32 outside the tensor cores (5.4 GFLOP, ~0.08 ms at
// N = 2048, M = 512); the bytes (A once, the output once) are far less.
// Hopper has no tensor-core path in full float32, and TF32 keeps about
// three decimal digits, so the products run on the FP32 pipes.
//
// Design: the classic tiled SGEMM. A block of 256 threads owns a 128×128
// output tile and walks K in steps of 8: each step's 128×8 slice of x and
// 8×128 slice of y are staged in shared memory (x transposed, k-major),
// double-buffered — the next step's slices are loaded into registers while
// the current ones are multiplied, then stored into the other buffer, one
// barrier a step. Each thread accumulates an 8×8 register tile (rows
// ty·4+{0..3} and 64+ty·4+{0..3}, columns likewise), read from shared
// memory as float4s without bank conflicts. Both inputs are read through
// their strides (a transposed view costs no copy); the loader walks the
// unit-stride axis across neighbouring threads. Ragged M, N and K edges are
// masked (zeros loaded, stores skipped), so there is no host padding. The
// diagonal drop is fused into the store. The sum over k runs in k order
// with fused multiply-adds; the plain version (cuBLAS or the CPU) sums in
// another order, so the two agree to float32 rounding, not bitwise.
// Allocates nothing.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int kThreads = 256;

__device__ __forceinline__ int tile_row(int t, int i) {
    return i < 4 ? t * 4 + i : 64 + t * 4 + (i - 4);
}

__global__ void __launch_bounds__(kThreads)
contract_matmul_kernel(const float* __restrict__ x,
                       const float* __restrict__ y,
                       float* __restrict__ out,
                       long long M, long long N, long long K,
                       long long sxm, long long sxk,
                       long long syk, long long syn,
                       int x_kfast, int y_kfast, int drop_diag) {
    __shared__ __align__(16) float As[2][BK][BM];
    __shared__ __align__(16) float Bs[2][BK][BN];

    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const long long m0 = (long long)blockIdx.y * BM;
    const long long n0 = (long long)blockIdx.x * BN;

    // loader coordinates: 4 elements of each slice per thread, the
    // unit-stride axis across neighbouring threads
    int xr[4], xk[4], yc[4], yk[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        if (x_kfast) { xr[e] = tid >> 1; xk[e] = (tid & 1) * 4 + e; }
        else         { xk[e] = tid >> 5; xr[e] = (tid & 31) * 4 + e; }
        if (y_kfast) { yc[e] = tid >> 1; yk[e] = (tid & 1) * 4 + e; }
        else         { yk[e] = tid >> 5; yc[e] = (tid & 31) * 4 + e; }
    }
    float ra[4], rb[4];

    auto load = [&](long long k0) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const long long gm = m0 + xr[e], gk = k0 + xk[e];
            ra[e] = (gm < M && gk < K) ? __ldg(x + gm * sxm + gk * sxk)
                                       : 0.0f;
            const long long gn = n0 + yc[e], hk = k0 + yk[e];
            rb[e] = (hk < K && gn < N) ? __ldg(y + hk * syk + gn * syn)
                                       : 0.0f;
        }
    };
    auto store = [&](int buf) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            As[buf][xk[e]][xr[e]] = ra[e];
            Bs[buf][yk[e]][yc[e]] = rb[e];
        }
    };

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    const long long steps = (K + BK - 1) / BK;
    load(0);
    store(0);
    __syncthreads();
    for (long long s = 0; s < steps; ++s) {
        const int cur = (int)(s & 1);
        const bool more = s + 1 < steps;
        if (more) load((s + 1) * BK);
#pragma unroll
        for (int k = 0; k < BK; ++k) {
            const float4 a0 = *reinterpret_cast<const float4*>(
                &As[cur][k][ty * 4]);
            const float4 a1 = *reinterpret_cast<const float4*>(
                &As[cur][k][64 + ty * 4]);
            const float4 b0 = *reinterpret_cast<const float4*>(
                &Bs[cur][k][tx * 4]);
            const float4 b1 = *reinterpret_cast<const float4*>(
                &Bs[cur][k][64 + tx * 4]);
            const float a[8] = {a0.x, a0.y, a0.z, a0.w,
                                a1.x, a1.y, a1.z, a1.w};
            const float b[8] = {b0.x, b0.y, b0.z, b0.w,
                                b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        // the other buffer was last read in step s - 1, before the
        // barrier that ended it
        if (more) store(cur ^ 1);
        __syncthreads();
    }

    // epilogue: mask the ragged edges, zero the global diagonal
    const bool vec = (N & 3) == 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const long long row = m0 + tile_row(ty, i);
        if (row >= M) continue;
        float* orow = out + row * N;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const long long c0 = n0 + tile_row(tx, h * 4);
            float v[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                v[j] = acc[i][h * 4 + j];
                if (drop_diag && row == c0 + j) v[j] = 0.0f;
            }
            if (vec && c0 + 3 < N) {
                *reinterpret_cast<float4*>(orow + c0) =
                    make_float4(v[0], v[1], v[2], v[3]);
            } else {
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    if (c0 + j < N) orow[c0 + j] = v[j];
            }
        }
    }
}

}  // namespace

// out (M, N) row-major = x (M, K) @ y (K, N), x and y read through the
// given element strides. Returns the launch's CUDA error code (0 = ok).
extern "C" int contract_matmul_sgemm(const void* x, const void* y, void* out,
                                     long long M, long long N, long long K,
                                     long long sxm, long long sxk,
                                     long long syk, long long syn,
                                     int drop_diag, void* stream) {
    if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
    const long long gy = (M + BM - 1) / BM;
    const long long gx = (N + BN - 1) / BN;
    if (gy > 65535 || gx > 2147483647LL) return (int)cudaErrorInvalidValue;
    const int x_kfast = sxk == 1;
    const int y_kfast = syn != 1 && syk == 1;
    contract_matmul_kernel<<<dim3((unsigned)gx, (unsigned)gy), kThreads, 0,
                             (cudaStream_t)stream>>>(
        (const float*)x, (const float*)y, (float*)out, M, N, K, sxm, sxk,
        syk, syn, x_kfast, y_kfast, drop_diag);
    return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int e) {
    return cudaGetErrorString((cudaError_t)e);
}
