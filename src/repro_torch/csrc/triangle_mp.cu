// Triangle message passing (RAMA Alg. 2) for Hopper: the sweep alone and
// one whole message-passing phase on compact triangle-edge ids.
//
// Replaces the TPU kernel src/repro/kernels/triangle_mp/kernel.py
// (mp_sweep_pallas, body _sweep_kernel), and with it the per-edge layout
// around it.
//
// The sweep computes, per triangle (a, b, c), six in-place min-marginal
// updates x -= g * mm(x, y, z) with mm = x + min(min(y, z), y + z) -
// min(0, y + z), on slots a, b, c, a, b, a with g = 1/3, 1/2, 1, 1/2, 1, 1.
//
// triangle_mp_sweep (the direct counterpart of mp_sweep_pallas). Bound on
// an H100: memory. Each triangle reads 12 B and writes 12 B and does about
// 50 flops, ~2 flops per byte against the card's ~20 float32 flops per byte
// of bandwidth. A block owns 1 024 triangles: its threads load the tile as
// 16-byte float4 words, neighbouring threads on neighbouring addresses,
// into shared memory, sweep four triangles each there (stride 3 words: no
// bank conflict), and store the tile the same way. The ragged last tile,
// or a pointer not 16-byte aligned, takes 4-byte loads.
//
// triangle_mp_phase (one MP phase). The wrapper sorts the valid slots'
// edge ids once (stable, so each edge's entries stay in flat, triangle-
// major order); a run of equal keys is one compact segment: one distinct
// edge, its entries, its degree. Thread per triangle; invalid rows exit
// at once. The first pass finds each slot's segment (a binary search over
// the sorted keys) and keeps it in a scratch word for the later passes.
// Each pass recomputes a slot's reparametrised cost from the previous
// pass's triangle costs: cost[edge] + the segment's -t_cost entries added
// one by one from +0.0 in flat order (the order the per-edge reference
// sums them), adds c / deg to the slot, and sweeps. Pass i reads one
// plane of triangle costs and writes the other, so no grid-wide barrier
// is needed. Where the two planes fit in one block's shared memory
// (T <= 2 048: the solver's shapes on its main and dense paths) the whole
// phase is one launch of one block, its passes separated by
// __syncthreads; beyond, one launch per pass over global planes, then one
// landing launch. The landing writes each touched edge's reparametrised
// cost into the E-sized output (which the wrapper filled with
// cost + 0.0), from the thread that owns the segment's first entry.
// The work is a few dependent gathers and ~60 flops a triangle a pass:
// launch- and latency-bound at the solver's T.
//
// Every sum, product, quotient and difference is rounded on its own
// (__fadd_rn / __fmul_rn / __fdiv_rn / __fsub_rn, and the file is built
// with -fmad=false), so the results are bitwise equal to the plain PyTorch
// versions, which run the same steps as separate, unfused ops. min is
// fminf, as torch.minimum's CUDA kernel uses. No kernel allocates.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSweepThreads = 256;
constexpr int kSweepTile = 4 * kSweepThreads;   // triangles a block
constexpr int kFusedMaxT = 2048;    // two (T, 3) float planes in 48 KB
constexpr int kFusedThreads = 1024;
constexpr int kPassThreads = 256;

__device__ __forceinline__ float min_marginal(float x, float y, float z) {
    const float s = __fadd_rn(y, z);
    return __fsub_rn(__fadd_rn(x, fminf(fminf(y, z), s)), fminf(s, 0.0f));
}

__device__ __forceinline__ float step(float x, float y, float z, float g) {
    return __fsub_rn(x, __fmul_rn(g, min_marginal(x, y, z)));
}

__device__ __forceinline__ void sweep(float& a, float& b, float& c) {
    const float g13 = (float)(1.0 / 3.0);
    a = step(a, b, c, g13);
    b = step(b, a, c, 0.5f);
    c = step(c, a, b, 1.0f);
    a = step(a, b, c, 0.5f);
    b = step(b, a, c, 1.0f);
    a = step(a, b, c, 1.0f);
}

template <bool kVec>
__global__ void __launch_bounds__(kSweepThreads)
triangle_mp_sweep_kernel(const float* __restrict__ in,
                         float* __restrict__ out, long long T) {
    __shared__ float4 tile[3 * kSweepThreads];
    const long long t0 = (long long)blockIdx.x * kSweepTile;
    const int tid = threadIdx.x;
    if (kVec && t0 + kSweepTile <= T) {     // block-uniform
        const float4* src = reinterpret_cast<const float4*>(in + 3 * t0);
        const float4 w0 = src[tid];
        const float4 w1 = src[tid + kSweepThreads];
        const float4 w2 = src[tid + 2 * kSweepThreads];
        tile[tid] = w0;
        tile[tid + kSweepThreads] = w1;
        tile[tid + 2 * kSweepThreads] = w2;
        __syncthreads();
        float* f = reinterpret_cast<float*>(tile);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
            float* x = f + 3 * (tid + m * kSweepThreads);
            float a = x[0], b = x[1], c = x[2];
            sweep(a, b, c);
            x[0] = a;
            x[1] = b;
            x[2] = c;
        }
        __syncthreads();
        float4* dst = reinterpret_cast<float4*>(out + 3 * t0);
        dst[tid] = tile[tid];
        dst[tid + kSweepThreads] = tile[tid + kSweepThreads];
        dst[tid + 2 * kSweepThreads] = tile[tid + 2 * kSweepThreads];
        return;
    }
    for (int m = 0; m < 4; ++m) {
        const long long t = t0 + tid + m * kSweepThreads;
        if (t >= T) return;
        float a = in[3 * t], b = in[3 * t + 1], c = in[3 * t + 2];
        sweep(a, b, c);
        out[3 * t] = a;
        out[3 * t + 1] = b;
        out[3 * t + 2] = c;
    }
}

// The compact layout of one phase: the valid slots' edge ids sorted
// (stable; invalid slots carry key E and sort last) and the flat slot
// (3 * row + slot) of each sorted entry. A compact segment is a run of
// equal keys: one distinct edge, its entries in flat order.
struct Phase {
    const int* tri;         // (T, 3) edge ids
    const bool* valid;      // (T,) row validity
    const float* cost;      // (E,) edge costs
    const int* keys;        // (3T,) sorted edge ids of the valid slots
    const long long* entries;   // (3T,) flat slot of each sorted key
    int n3;                 // 3T
};

// A slot's compact segment: the first sorted entry of its edge, its
// length (the edge's degree) and the edge's cost (as bits), in one 16-byte
// word; the fourth lane is unused.
__device__ __forceinline__ int4 find_segment(const Phase& P, int p) {
    const int key = P.tri[p];
    int lo = 0, hi = P.n3;
    while (lo < hi) {                       // first key >= key
        const int mid = (lo + hi) >> 1;
        if (P.keys[mid] < key) lo = mid + 1;
        else hi = mid;
    }
    int len = 0;
    while (lo + len < P.n3 && P.keys[lo + len] == key) ++len;
    return make_int4(lo, len, __float_as_int(P.cost[key]), 0);
}

// c^lambda of a segment: its edge's cost minus its triangle costs in t,
// added one by one from +0.0 in flat order.
__device__ __forceinline__ float slot_cost(const Phase& P, const float* t,
                                           int4 g) {
    float acc = 0.0f;
    for (int j = 0; j < g.y; ++j)
        acc = __fadd_rn(acc, -t[P.entries[g.x + j]]);
    return __fadd_rn(__int_as_float(g.z), acc);
}

// The segment of slot p: found by search (and stored to segs for the
// later passes), or loaded from segs.
__device__ __forceinline__ int4 segment(const Phase& P, int4* segs, int p,
                                        bool search) {
    if (!search) return segs[p];
    const int4 g = find_segment(P, p);
    segs[p] = g;
    return g;
}

// One pass on valid row r: each slot takes its edge's share c / deg, then
// the row is swept. Reads plane prev, writes plane next.
__device__ __forceinline__ void pass_row(const Phase& P, int4* segs,
                                         bool search, const float* prev,
                                         float* next, int r) {
    float x[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const int4 g = segment(P, segs, 3 * r + k, search);
        const float share = __fdiv_rn(slot_cost(P, prev, g), (float)g.y);
        x[k] = __fadd_rn(prev[3 * r + k], share);
    }
    sweep(x[0], x[1], x[2]);
#pragma unroll
    for (int k = 0; k < 3; ++k) next[3 * r + k] = x[k];
}

// The landing of valid row r: each slot that holds its segment's first
// entry writes the segment's reparametrised cost at its edge.
__device__ __forceinline__ void land_row(const Phase& P, int4* segs,
                                         bool search, const float* t,
                                         float* c_rep, int r) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const int p = 3 * r + k;
        const int4 g = segment(P, segs, p, search);
        if (P.entries[g.x] == p) c_rep[P.tri[p]] = slot_cost(P, t, g);
    }
}

// The whole phase in one block: both planes in shared memory. The first
// pass finds each slot's segment; a thread reads back only its own.
__global__ void __launch_bounds__(kFusedThreads)
triangle_mp_phase_kernel(Phase P, int4* __restrict__ segs,
                         float* __restrict__ t_out,
                         float* __restrict__ c_rep, int T, int iters) {
    extern __shared__ float planes[];       // two (T, 3) planes
    const int n3 = 3 * T;
    for (int i = threadIdx.x; i < 2 * n3; i += blockDim.x) planes[i] = 0.0f;
    __syncthreads();
    for (int it = 0; it < iters; ++it) {
        const float* prev = planes + (it & 1) * n3;
        float* next = planes + ((it & 1) ^ 1) * n3;
        for (int r = threadIdx.x; r < T; r += blockDim.x)
            if (P.valid[r]) pass_row(P, segs, it == 0, prev, next, r);
        __syncthreads();
    }
    const float* fin = planes + (iters & 1) * n3;
    for (int r = threadIdx.x; r < T; r += blockDim.x) {
        if (!P.valid[r]) continue;          // invalid rows stay zero
        t_out[3 * r] = fin[3 * r];
        t_out[3 * r + 1] = fin[3 * r + 1];
        t_out[3 * r + 2] = fin[3 * r + 2];
        land_row(P, segs, iters == 0, fin, c_rep, r);
    }
}

// One pass over global planes (T > kFusedMaxT); a thread a row. The first
// pass finds the segments.
__global__ void __launch_bounds__(kPassThreads)
triangle_mp_pass_kernel(Phase P, int4* __restrict__ segs, bool search,
                        const float* __restrict__ prev,
                        float* __restrict__ next, int T) {
    const int r = blockIdx.x * kPassThreads + threadIdx.x;
    if (r >= T || !P.valid[r]) return;
    pass_row(P, segs, search, prev, next, r);
}

__global__ void __launch_bounds__(kPassThreads)
triangle_mp_land_kernel(Phase P, int4* __restrict__ segs, bool search,
                        const float* __restrict__ t,
                        float* __restrict__ c_rep, int T) {
    const int r = blockIdx.x * kPassThreads + threadIdx.x;
    if (r >= T || !P.valid[r]) return;
    land_row(P, segs, search, t, c_rep, r);
}

// Make `device` current when it is not; restore the previous one after.
struct DeviceGuard {
    int prev = 0, device = 0;
    cudaError_t err = cudaSuccess;
    explicit DeviceGuard(int d) : device(d) {
        err = cudaGetDevice(&prev);
        if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
    }
    ~DeviceGuard() {
        if (prev != device) cudaSetDevice(prev);
    }
};

}  // namespace

// The sweep. Words: device, in, out (T, 3) float32 contiguous, T.
extern "C" int triangle_mp_sweep(const long long* a, void* stream) {
    const float* in = (const float*)a[1];
    float* out = (float*)a[2];
    const long long T = a[3];
    if (T <= 0) return 0;
    const long long blocks = (T + kSweepTile - 1) / kSweepTile;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    DeviceGuard g((int)a[0]);
    if (g.err != cudaSuccess) return (int)g.err;
    const bool vec = (uintptr_t)in % 16 == 0 && (uintptr_t)out % 16 == 0;
    auto kernel = vec ? triangle_mp_sweep_kernel<true>
                      : triangle_mp_sweep_kernel<false>;
    kernel<<<(unsigned)blocks, kSweepThreads, 0, (cudaStream_t)stream>>>(
        in, out, T);
    return (int)cudaGetLastError();
}

// One MP phase. Words: device; tri (T, 3) int32 and valid (T,) bool;
// cost (E,) float32; keys (3T,) int32, the stable sort of the slots' edge
// ids with E at invalid rows' slots, and entries (3T,) int64, the sort's
// permutation; segs (T, 3) int4 scratch; t_out (T, 3) and scratch (T, 3)
// float32, both zero; c_rep (E,) holding cost + 0.0; T; iters. One launch
// when T <= kFusedMaxT (scratch unused), else iters pass launches (the
// last one writes t_out) and one landing launch.
extern "C" int triangle_mp_phase(const long long* a, void* stream) {
    const long long T = a[10];
    const int iters = (int)a[11];
    if (T <= 0) return 0;
    if (T > 2147483647LL / 3 || iters < 0) return (int)cudaErrorInvalidValue;
    const Phase P{(const int*)a[1], (const bool*)a[2], (const float*)a[3],
                  (const int*)a[4], (const long long*)a[5], (int)(3 * T)};
    int4* segs = (int4*)a[6];
    float* t_out = (float*)a[7];
    float* scratch = (float*)a[8];
    float* c_rep = (float*)a[9];
    DeviceGuard g((int)a[0]);
    if (g.err != cudaSuccess) return (int)g.err;
    cudaStream_t st = (cudaStream_t)stream;
    if (T <= kFusedMaxT) {
        const int threads = T >= kFusedThreads ? kFusedThreads
                                               : (int)((T + 31) / 32 * 32);
        triangle_mp_phase_kernel<<<1, threads, 24 * T, st>>>(
            P, segs, t_out, c_rep, (int)T, iters);
        return (int)cudaGetLastError();
    }
    const unsigned blocks = (unsigned)((T + kPassThreads - 1) / kPassThreads);
    for (int it = 0; it < iters; ++it) {
        // the last pass writes t_out; both planes start at zero
        float* next = (iters - 1 - it) % 2 == 0 ? t_out : scratch;
        const float* prev = next == t_out ? scratch : t_out;
        triangle_mp_pass_kernel<<<blocks, kPassThreads, 0, st>>>(
            P, segs, it == 0, prev, next, (int)T);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    triangle_mp_land_kernel<<<blocks, kPassThreads, 0, st>>>(
        P, segs, iters == 0, t_out, c_rep, (int)T);
    return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int e) {
    return cudaGetErrorString((cudaError_t)e);
}
