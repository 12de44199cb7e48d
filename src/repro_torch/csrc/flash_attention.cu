// Flash attention forward (causal / sliding window / GQA / tanh softcap)
// for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas, body _attn_kernel).
//
// Computes, for q (B, Hq, S, D) and k, v (B, Hkv, S, D) in bf16, with q
// head h reading kv head h / (Hq / Hkv):
//   s = (q . k) * scale                       f32 logits
//   s = softcap * tanh(s / softcap)           when a softcap is given
//   s = -1e30 where kpos >= S, or (causal) kpos > qpos, or (window)
//       kpos <= qpos - window
//   out = softmax(s) @ v, by the online recurrence (m, l, acc) in f32,
//   acc / max(l, 1e-30) rounded to bf16.
// Key tiles wholly outside the causal & window band are skipped by the
// loop bounds, so a window W costs O(S * W), not O(S^2).
//
// Bound on an H100: operations. At S = 8192, D = 256 a (q, k) pair costs
// 4 * D = 1024 tensor-core flops against 2 * 2 * D bytes of q/k/v/o per
// row, so the matrix products dominate by far.
//
// Design: one block of 4 warps per (b * Hq + h, 64-row query tile); each
// warp owns 16 query rows. Q, and one 64-key tile each of K and V, are
// staged in dynamic shared memory (rows padded by 16 bytes so fragment
// loads hit distinct banks; 101 KB at D = 256, two blocks per SM). Both
// products run on the tensor cores through mma.sync m16n8k16 (bf16 in,
// f32 accumulate): S = Q K^T from fragments read straight out of shared
// memory, O += P V with P rounded to bf16 in registers (the S accumulator
// layout is the A-operand layout) and V fragments read by ldmatrix.trans.
// K(j+1) is fetched by cp.async while P V(j) runs, and V(j) while
// Q K(j)^T runs. The softmax carry stays in f32 registers.
//
// Differences from the TPU kernel, both within f32/bf16 rounding: the
// scale multiplies the f32 logits after the product (the TPU scaled q in
// f32 before it; folding the scale into q here would round it to bf16),
// and P is rounded to bf16 for the P V product (the TPU multiplied f32 P
// by f32 V). For D = 256 the scale is 1/16, exact either way.
//
// The kernel runs on the caller's stream and allocates nothing; the host
// entry point returns cudaGetLastError() after the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;          // query rows per block, 16 per warp
constexpr int BK = 64;          // keys per tile
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int PAD = 8;          // bf16 elements of padding per smem row
constexpr float NEG_INF = -1e30f;

struct Params {
    const bf16* q;
    const bf16* k;
    const bf16* v;
    bf16* o;
    long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss;
    long long v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
    int Hq, group, S;
    int causal, window;         // window <= 0: none
    float softcap;              // <= 0: none
    float scale;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    const int n = pred ? 16 : 0;        // 0 bytes read: the row is zeroed
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(gmem), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(p);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// rows [row0, row0 + 64) of a (S, D) plane with row stride ss into smem;
// rows at or past S are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(bf16* sm, const bf16* g,
                                          long long ss, int row0, int S) {
    constexpr int VPR = D / 8;          // 16-byte vectors per row
    constexpr int LD = D + PAD;
    for (int i = threadIdx.x; i < BQ * VPR; i += THREADS) {
        const int r = i / VPR, c = (i % VPR) * 8;
        const int row = row0 + r;
        const bool ok = row < S;
        cp_async16(sm + r * LD + c, g + (long long)(ok ? row : 0) * ss + c,
                   ok);
    }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const Params p) {
    constexpr int LD = D + PAD;
    constexpr int NT = D / 8;           // 8-wide output column tiles
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
    bf16* Ks = Qs + BQ * LD;
    bf16* Vs = Ks + BK * LD;

    const int qt = gridDim.x - 1 - blockIdx.x;  // longest rows first
    const int b = blockIdx.y / p.Hq, h = blockIdx.y % p.Hq;
    const int hk = h / p.group;
    const int S = p.S;
    const int q0 = qt * BQ;
    const bf16* qg = p.q + b * p.q_sb + h * p.q_sh;
    const bf16* kg = p.k + b * p.k_sb + hk * p.k_sh;
    const bf16* vg = p.v + b * p.v_sb + hk * p.v_sh;

    // key tiles [n_lo, n_hi) hold every key some row of this tile sees
    const int hi = p.causal ? min(q0 + BQ, S) : S;
    const int n_hi = (hi + BK - 1) / BK;
    const int n_lo = p.window > 0 ? max(q0 - (p.window - 1), 0) / BK : 0;

    load_tile<D>(Qs, qg, p.q_ss, q0, S);
    load_tile<D>(Ks, kg, p.k_ss, n_lo * BK, S);
    cp_async_commit();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = warp * 16 + g;       // this thread's rows: r0 and r0 + 8
    const int qpos0 = q0 + r0, qpos1 = qpos0 + 8;

    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
        acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};            // this thread's share of the row sum

    for (int j = n_lo; j < n_hi; ++j) {
        const int k0 = j * BK;
        cp_async_wait_all();
        __syncthreads();                // K(j) in; every warp is past P V(j-1)
        load_tile<D>(Vs, vg, p.v_ss, k0, S);
        cp_async_commit();

        // S = Q K^T for this warp's 16 rows x 64 keys
        float s[BK / 8][4];
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
            s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            const bf16* qa = Qs + r0 * LD + kk * 16 + 2 * t;
            uint32_t a[4];
            a[0] = lds32(qa);
            a[1] = lds32(qa + 8 * LD);
            a[2] = lds32(qa + 8);
            a[3] = lds32(qa + 8 * LD + 8);
#pragma unroll
            for (int n = 0; n < BK / 8; ++n) {
                const bf16* kb = Ks + (n * 8 + g) * LD + kk * 16 + 2 * t;
                mma16816(s[n], a, lds32(kb), lds32(kb + 8));
            }
        }

        // scale, softcap, mask
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float x = s[n][e] * p.scale;
                if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
                const int kpos = k0 + 8 * n + 2 * t + (e & 1);
                const int qpos = e < 2 ? qpos0 : qpos1;
                bool ok = kpos < S;
                if (p.causal) ok = ok && kpos <= qpos;
                if (p.window > 0) ok = ok && kpos > qpos - p.window;
                s[n][e] = ok ? x : NEG_INF;
            }
        }

        // online softmax; a row's 64 scores sit in the 4 threads of a quad
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float mx = NEG_INF;
#pragma unroll
            for (int n = 0; n < BK / 8; ++n)
                mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m[r], mx);
            alpha[r] = expf(m[r] - m_new);
            float sum = 0.f;
#pragma unroll
            for (int n = 0; n < BK / 8; ++n) {
                const float p0 = expf(s[n][2 * r] - m_new);
                const float p1 = expf(s[n][2 * r + 1] - m_new);
                s[n][2 * r] = p0;
                s[n][2 * r + 1] = p1;
                sum += p0 + p1;
            }
            l[r] = l[r] * alpha[r] + sum;
            m[r] = m_new;
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            acc[n][0] *= alpha[0];
            acc[n][1] *= alpha[0];
            acc[n][2] *= alpha[1];
            acc[n][3] *= alpha[1];
        }

        cp_async_wait_all();
        __syncthreads();                // V(j) in; every warp is past Q K(j)^T
        if (j + 1 < n_hi) load_tile<D>(Ks, kg, p.k_ss, k0 + BK, S);
        cp_async_commit();

        // O += P V: the S accumulators of key tiles 2kk, 2kk+1 are the A
        // fragment of keys [16kk, 16kk + 16)
        const int lm = lane >> 3, lr = lane & 7;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            uint32_t a[4];
            a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
            a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
            a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
            a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
            const bf16* vrow = Vs + (kk * 16 + (lm & 1) * 8 + lr) * LD
                + (lm >> 1) * 8;
#pragma unroll
            for (int n = 0; n < NT; n += 2) {
                uint32_t bv[4];
                ldsm_x4_trans(bv, vrow + n * 8);
                mma16816(acc[n], a, bv[0], bv[1]);
                mma16816(acc[n + 1], a, bv[2], bv[3]);
            }
        }
    }
    cp_async_wait_all();

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        l[r] = fmaxf(l[r], 1e-30f);
    }
    bf16* og = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
        const int d = n * 8 + 2 * t;
        if (qpos0 < S)
            *reinterpret_cast<uint32_t*>(og + qpos0 * p.o_ss + d) =
                pack_bf16(acc[n][0] / l[0], acc[n][1] / l[0]);
        if (qpos1 < S)
            *reinterpret_cast<uint32_t*>(og + qpos1 * p.o_ss + d) =
                pack_bf16(acc[n][2] / l[1], acc[n][3] / l[1]);
    }
}

template <int D>
int launch(const Params& p, int B, cudaStream_t stream) {
    const int smem = 3 * BQ * (D + PAD) * (int)sizeof(bf16);
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((p.S + BQ - 1) / BQ, B * p.Hq);
    flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

}  // namespace

// strides: 12 element strides (batch, head, row) of q, k, v, o in that
// order; the last dimension must be contiguous. window <= 0 and
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
    Params p;
    p.q = (const bf16*)q;
    p.k = (const bf16*)k;
    p.v = (const bf16*)v;
    p.o = (bf16*)o;
    p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_ss = strides[2];
    p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_ss = strides[5];
    p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_ss = strides[8];
    p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_ss = strides[11];
    p.Hq = Hq;
    p.group = Hq / Hkv;
    p.S = S;
    p.causal = causal;
    p.window = window;
    p.softcap = softcap;
    p.scale = scale;
    cudaStream_t st = (cudaStream_t)stream;
    switch (D) {
        case 96: return launch<96>(p, B, st);
        case 128: return launch<128>(p, B, st);
        case 256: return launch<256>(p, B, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* repro_error_string(int e) {
    return cudaGetErrorString((cudaError_t)e);
}
