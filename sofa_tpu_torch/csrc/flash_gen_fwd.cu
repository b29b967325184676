// sofa_flash_gen_fwd: fused attention forward for every (dtype, head dim)
// the Hopper kernel sofa_flash_fwd does not take: q/k/v in bfloat16,
// float16 or float32 at any head dim 1..256, out in q's dtype plus a
// per-row logsumexp in float32.
//
// Replaces, on that part of its domain, the TPU kernel
// sofa_tpu/workloads/flash_pallas.py:_flash_kernel (launched as
// name="sofa_flash_fwd" by _flash_forward, flash_pallas.py:282), which
// takes any float dtype and any head dim, and computes the same function as
// flash_cuda._flash_forward_plain:
//   - key j is visible to query i iff j <= i + shift (0 = causal, >= Tk =
//     full attention, <= -Tk = nothing visible: out 0, lse ~ -1e29);
//   - optional segment ids mask pairs whose ids differ (packed sequences);
//   - GQA is native: query head h reads compact KV head h / (H / KVH);
//   - scores in float32 (FMA over the true D), times the true D's scale;
//   - the running max starts at, and so is clamped at, -1e29; masked scores
//     are NEG_INF = -1e30, so a row with no visible key sums exact zeros;
//   - p rounds to V's dtype before the P.V product, l sums the unrounded p.
//
// What bounds it on an H100: operations.  4*B*H*D*T*(T+1)/2 flops under
// causal masking against 2*(q+k+v+out) bytes; at the float32 flagship
// shape (B 4, T 512, H 8 / 4, D 64) that is ~1.1e9 flops against ~12.6 MB,
// ~85 flops a byte, above the ridge of the card's float32 rate (67 TFLOP/s
// over 3.35 TB/s, ~20).  The design (flash_gen.cuh) runs
// every product as float32 FMA on the CUDA cores, which is what float32
// needs (no TF32) and what a head dim that is not a multiple of 16 allows
// without padding: one block per (batch * head, 64-row q-tile), heaviest
// q-tiles first; Q staged once, K and V tiles of 64 keys (32 at D > 128)
// streamed through shared memory up to the causal frontier of the runtime
// shift; the online softmax's m, l and rescale factor per row in shared
// memory, four threads a row; O in registers, 16 x 16 threads each holding
// a strided (rows, dims) patch.  The tensor cores are left unused, so a
// bfloat16 or float16 call runs far below their bound: that is a later
// PR's work.  Measured (PERF.md; NVIDIA H100 80GB HBM3, 700 W): 0.095 ms
// at the float32 flagship shape, 17 % of its float32 bound; 17.9 ms at
// bfloat16 D 256 (B 1, T 8192), 1.6 % of its bf16 bound.
// ptxas -v (CUDA 12.8, sm_90a): 62-128 registers a thread over the 15
// instantiations, no spills; dynamic shared memory 30,976 / 43,264 /
// 67,840 / 116,992 / 141,184 bytes a block at caps 16 / 32 / 64 / 128 / 256
// (sofa_flash_gen_fwd_smem_bytes, the same for every dtype).

#include "flash_gen.cuh"

namespace {

// Shared memory of one block at cap DC: Q [ROWS][LD], K and V [COLS][LD],
// the scores / probabilities [ROWS][LP], m, l and alpha [ROWS], then the
// segment ids of the rows [ROWS] and of the key tile [COLS].
template <int DC>
constexpr int fwd_smem() {
  using G = Gen<DC>;
  return 4 * ((G::ROWS + 2 * G::COLS) * G::LD + G::ROWS * G::LP +
              3 * G::ROWS + G::ROWS + G::COLS);
}

template <typename E, int DC>
__global__ void __launch_bounds__(GEN_THREADS) sofa_flash_gen_fwd_kernel(
    const E* __restrict__ q, const E* __restrict__ k,
    const E* __restrict__ v, const int* __restrict__ seg_q,
    const int* __restrict__ seg_k, E* __restrict__ out,
    float* __restrict__ lse, int T, int Tk, int H, int KVH, int D,
    long long shift, float scale) {
  using G = Gen<DC>;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + G::ROWS * G::LD;
  float* vs = ks + G::COLS * G::LD;
  float* ps = vs + G::COLS * G::LD;
  float* m_s = ps + G::ROWS * G::LP;
  float* l_s = m_s + G::ROWS;
  float* a_s = l_s + G::ROWS;
  int* sq_s = reinterpret_cast<int*>(a_s + G::ROWS);
  int* sk_s = sq_s + G::ROWS;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * G::ROWS;
  const int q_valid = min(G::ROWS, T - q0);
  const long long q_stride = static_cast<long long>(H) * D;
  const long long kv_stride = static_cast<long long>(KVH) * D;
  const long long q_off = (static_cast<long long>(b) * T + q0) * q_stride +
                          static_cast<long long>(h) * D;
  const E* k_bh = k + static_cast<long long>(b) * Tk * kv_stride +
                  static_cast<long long>(kvh) * D;
  const E* v_bh = v + static_cast<long long>(b) * Tk * kv_stride +
                  static_cast<long long>(kvh) * D;
  const bool segmented = seg_q != nullptr;

  load_tile<E, DC>(qs, q + q_off, q_stride, G::ROWS, q_valid, D);
  if (tid < G::ROWS) {
    m_s[tid] = M_FLOOR;
    l_s[tid] = 0.f;
    if (segmented) {
      sq_s[tid] = tid < q_valid
                      ? seg_q[static_cast<long long>(b) * T + q0 + tid]
                      : 0;
    }
  }
  // The keys any row of the block can see: [0, n_keys).
  const long long last = static_cast<long long>(q0) + q_valid - 1 + shift;
  const int n_keys =
      last < 0 ? 0 : static_cast<int>(last + 1 < Tk ? last + 1 : Tk);

  float o[G::RI][G::DJ];
#pragma unroll
  for (int i = 0; i < G::RI; ++i) {
#pragma unroll
    for (int j = 0; j < G::DJ; ++j) o[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < n_keys; k0 += G::COLS) {
    const int k_valid = min(G::COLS, Tk - k0);
    __syncthreads();   // the last tile's K, V and P are consumed
    load_tile<E, DC>(ks, k_bh + k0 * kv_stride, kv_stride, G::COLS, k_valid,
                     D);
    load_tile<E, DC>(vs, v_bh + k0 * kv_stride, kv_stride, G::COLS, k_valid,
                     D);
    if (segmented && tid < G::COLS) {
      sk_s[tid] = tid < k_valid
                      ? seg_k[static_cast<long long>(b) * Tk + k0 + tid]
                      : 0;
    }
    __syncthreads();

    float s[G::RI][G::CJ];
    products<DC>(s, qs, ks, D);
#pragma unroll
    for (int i = 0; i < G::RI; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < G::CJ; ++j) {
        const int c = tx + 16 * j;
        bool vis = r < q_valid && c < k_valid &&
                   static_cast<long long>(k0) + c <=
                       static_cast<long long>(q0) + r + shift;
        if (segmented && vis) vis = sq_s[r] == sk_s[c];
        ps[r * G::LP + c] = vis ? s[i][j] * scale : NEG_INF;
      }
    }
    __syncthreads();

    // The online softmax, four threads a row (a quad of one warp), each
    // over every fourth column.
    {
      constexpr int TPR = GEN_THREADS / G::ROWS;
      static_assert(TPR == 4, "quad_max / quad_sum reduce four lanes");
      const int r = tid / TPR, part = tid % TPR;
      float* row = ps + r * G::LP;
      float mx = NEG_INF;
      for (int c = part; c < G::COLS; c += TPR) mx = fmaxf(mx, row[c]);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, quad_max(mx));
      float sum = 0.f;
      for (int c = part; c < G::COLS; c += TPR) {
        const float p = expf(row[c] - m_new);
        sum += p;
        row[c] = round_as<E>(p);
      }
      sum = quad_sum(sum);
      if (part == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < G::RI; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < G::DJ; ++j) o[i][j] *= alpha;
    }
    accumulate<DC, G::COLS>(o, ps, vs);
  }
  __syncthreads();   // m and l of every row are final

  float lc[G::RI];   // l clamped, as the plain version clamps it
#pragma unroll
  for (int i = 0; i < G::RI; ++i) lc[i] = fmaxf(l_s[ty + 16 * i], 1e-30f);
#pragma unroll
  for (int i = 0; i < G::RI; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < G::DJ; ++j) {
      const int c = tx + 16 * j;
      if (r < q_valid && c < D) {
        out[q_off + r * q_stride + c] = from_f<E>(o[i][j] / lc[i]);
      }
    }
  }
  if (tid < q_valid) {
    lse[(static_cast<long long>(b) * H + h) * T + q0 + tid] =
        m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  q [B,T,H,D], k/v [B,Tk,KVH,D]
// contiguous, all of the element type `dtype` (GenDtype); seg_q [B,T] /
// seg_k [B,Tk] int32 or both null; out [B,T,H,D] in that type and lse
// [B,H,T] f32 are allocated by the caller.  Launches on `stream` without
// synchronizing and returns cudaGetLastError() (cudaErrorInvalidValue for
// a dtype, head dim or shape it does not take).
extern "C" int sofa_flash_gen_fwd(const void* q, const void* k,
                                  const void* v, const int* seg_q,
                                  const int* seg_k, void* out, float* lse,
                                  int dtype, int B, int T, int Tk, int H,
                                  int KVH, int D, long long shift,
                                  float scale, void* stream) {
  if (B <= 0 || T <= 0 || Tk <= 0 || KVH <= 0 || H % KVH != 0 ||
      (T + GEN_ROWS - 1) / GEN_ROWS > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(dtype, D, [&](auto elem, auto cap) {
    using E = typename decltype(elem)::type;
    constexpr int DC = decltype(cap)::value;
    const int smem = fwd_smem<DC>();
    cudaError_t err = allow_smem(sofa_flash_gen_fwd_kernel<E, DC>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(B * H, (T + GEN_ROWS - 1) / GEN_ROWS);
    sofa_flash_gen_fwd_kernel<E, DC><<<grid, GEN_THREADS, smem, st>>>(
        static_cast<const E*>(q), static_cast<const E*>(k),
        static_cast<const E*>(v), seg_q, seg_k, static_cast<E*>(out), lse,
        T, Tk, H, KVH, D, shift, scale);
    return cudaGetLastError();
  }));
}

// Dynamic shared memory one block asks for at head dim d (0 if
// unsupported); the same for every dtype (tiles are staged as float32).
extern "C" int sofa_flash_gen_fwd_smem_bytes(int d) {
  switch (gen_cap(d)) {
    case 16: return fwd_smem<16>();
    case 32: return fwd_smem<32>();
    case 64: return fwd_smem<64>();
    case 128: return fwd_smem<128>();
    case 256: return fwd_smem<256>();
    default: return 0;
  }
}
