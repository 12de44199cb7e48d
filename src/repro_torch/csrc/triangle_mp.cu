// Triangle message-passing sweep (RAMA Alg. 2, lines 8-13) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/triangle_mp/kernel.py
// (mp_sweep_pallas, body _sweep_kernel).
//
// Computes, per triangle (a, b, c), six in-place min-marginal updates
// x -= g * mm(x, y, z) with mm = x + min(min(y, z), y + z) - min(0, y + z),
// on slots a, b, c, a, b, a with g = 1/3, 1/2, 1, 1/2, 1, 1.
//
// Bound on an H100: memory. Each triangle reads 12 B and writes 12 B and
// does about 50 flops, i.e. ~2 flops per byte against the card's ~20
// float32 flops per byte of bandwidth, so 24 B per triangle at 3.35 TB/s.
//
// Design: one thread per triangle on the (T, 3) row-major layout, no
// padding (the TPU needed 32 768-triangle tiles; here the last block masks
// its tail). A warp reads 384 contiguous bytes per slot triple, so loads
// stay coalesced. Every product and difference is rounded on its own
// (__fmul_rn / __fsub_rn, and the file is built with -fmad=false), so the
// result is bitwise equal to the plain PyTorch version, which runs the
// same steps as separate, unfused ops. min is fminf, as torch.minimum's
// CUDA kernel uses. The kernel allocates nothing.
#include <cuda_runtime.h>

__device__ __forceinline__ float min_marginal(float x, float y, float z) {
    const float s = __fadd_rn(y, z);
    return __fsub_rn(__fadd_rn(x, fminf(fminf(y, z), s)), fminf(s, 0.0f));
}

__device__ __forceinline__ float step(float x, float y, float z, float g) {
    return __fsub_rn(x, __fmul_rn(g, min_marginal(x, y, z)));
}

__global__ void triangle_mp_sweep_kernel(const float* __restrict__ in,
                                         float* __restrict__ out,
                                         long long T) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= T) return;
    float a = in[3 * t], b = in[3 * t + 1], c = in[3 * t + 2];
    const float g13 = (float)(1.0 / 3.0);
    a = step(a, b, c, g13);
    b = step(b, a, c, 0.5f);
    c = step(c, a, b, 1.0f);
    a = step(a, b, c, 0.5f);
    b = step(b, a, c, 1.0f);
    a = step(a, b, c, 1.0f);
    out[3 * t] = a;
    out[3 * t + 1] = b;
    out[3 * t + 2] = c;
}

extern "C" int triangle_mp_sweep(const void* in, void* out, long long T,
                                 void* stream) {
    if (T <= 0) return 0;
    const int threads = 256;
    const long long blocks = (T + threads - 1) / threads;
    triangle_mp_sweep_kernel<<<(unsigned)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
        (const float*)in, (float*)out, T);
    return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int e) {
    return cudaGetErrorString((cudaError_t)e);
}
