// sofa_flash_gen_bwd_dq: the dQ half of the fused attention backward for
// every (dtype, head dim) the Hopper kernel sofa_flash_bwd_dq does not
// take: bfloat16, float16 or float32 at any head dim 1..256, float32
// accumulation, dq out in the inputs' dtype or float32.
//
// Replaces, on that part of its domain, the TPU kernel
// sofa_tpu/workloads/flash_pallas.py:_bwd_q_kernel (launched as
// name="sofa_flash_bwd_dq" by _flash_backward, flash_pallas.py:673) and
// computes the same function as flash_cuda._flash_bwd_dq_plain: for each
// query row, over every key the causal rule (key j visible to query i iff
// j <= i + shift) and the optional segment ids let it see,
//   p  = exp(s * scale - max(lse, -1e29))           s = Q K^T (float32)
//   dp = dO V^T
//   ds = round_q(p * (dp - delta))                   delta = rowsum(dO * O)
//   dQ = ds K,  times scale after the product
// with query head h reading compact KV head h / (H / KVH).  A row with no
// visible key writes exact zeros.
//
// What bounds it on an H100: operations, three products over the visible
// (query, key) pairs, 6*B*H*D*T*(T+1)/2 flops under causal masking.  The
// design (flash_gen.cuh), float32 FMA on the CUDA cores: one block per
// (batch * head, 64-row q-tile), heaviest q-tiles first; Q, dO and the
// rows' clamped lse, delta and segment ids staged once; K and V tiles of 64
// keys (32 at D > 128) streamed up to the causal frontier of the runtime
// shift; dQ in registers.  No atomics: two launches agree bit for bit.
// ptxas -v (CUDA 12.8, sm_90a): 64-128 registers a thread, 12 bytes of
// spill at caps 16 and 32; dynamic shared memory 35,072 / 51,456 / 84,224 /
// 149,760 / 206,720 bytes a block at caps 16 / 32 / 64 / 128 / 256
// (sofa_flash_gen_bwd_dq_smem_bytes).

#include "flash_gen.cuh"

namespace {

// Shared memory of one block at cap DC: Q and dO [ROWS][LD], K and V
// [COLS][LD], ds [ROWS][LP], the rows' lse, delta and segment ids [ROWS],
// the key tile's segment ids [COLS].
template <int DC>
constexpr int dq_smem() {
  using G = Gen<DC>;
  return 4 * (2 * (G::ROWS + G::COLS) * G::LD + G::ROWS * G::LP +
              3 * G::ROWS + G::COLS);
}

template <typename E, int DC>
__global__ void __launch_bounds__(GEN_THREADS) sofa_flash_gen_bwd_dq_kernel(
    const E* __restrict__ q, const E* __restrict__ k,
    const E* __restrict__ v, const E* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ seg_q, const int* __restrict__ seg_k, void* dq,
    bool out_f32, int T, int Tk, int H, int KVH, int D, long long shift,
    float scale) {
  using G = Gen<DC>;
  extern __shared__ float smem[];
  float* qs = smem;
  float* gs = qs + G::ROWS * G::LD;
  float* ks = gs + G::ROWS * G::LD;
  float* vs = ks + G::COLS * G::LD;
  float* ds = vs + G::COLS * G::LD;
  float* lse_s = ds + G::ROWS * G::LP;
  float* dl_s = lse_s + G::ROWS;
  int* sq_s = reinterpret_cast<int*>(dl_s + G::ROWS);
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
  load_tile<E, DC>(gs, dout + q_off, q_stride, G::ROWS, q_valid, D);
  if (tid < G::ROWS) {
    const bool in = tid < q_valid;
    const long long row = (static_cast<long long>(b) * H + h) * T + q0 + tid;
    lse_s[tid] = in ? fmaxf(lse[row], M_FLOOR) : 0.f;
    dl_s[tid] = in ? delta[row] : 0.f;
    if (segmented) {
      sq_s[tid] = in ? seg_q[static_cast<long long>(b) * T + q0 + tid] : 0;
    }
  }
  // The keys any row of the block can see: [0, n_keys).
  const long long last = static_cast<long long>(q0) + q_valid - 1 + shift;
  const int n_keys =
      last < 0 ? 0 : static_cast<int>(last + 1 < Tk ? last + 1 : Tk);

  float dq_acc[G::RI][G::DJ];
#pragma unroll
  for (int i = 0; i < G::RI; ++i) {
#pragma unroll
    for (int j = 0; j < G::DJ; ++j) dq_acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < n_keys; k0 += G::COLS) {
    const int k_valid = min(G::COLS, Tk - k0);
    __syncthreads();   // the last tile's K and ds are consumed
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

    float s[G::RI][G::CJ], dp[G::RI][G::CJ];
    products<DC>(s, qs, ks, D);
    products<DC>(dp, gs, vs, D);
#pragma unroll
    for (int i = 0; i < G::RI; ++i) {
      const int r = ty + 16 * i;   // query
#pragma unroll
      for (int j = 0; j < G::CJ; ++j) {
        const int c = tx + 16 * j;   // key
        bool vis = r < q_valid && c < k_valid &&
                   static_cast<long long>(k0) + c <=
                       static_cast<long long>(q0) + r + shift;
        if (segmented && vis) vis = sq_s[r] == sk_s[c];
        float dsv = 0.f;
        if (vis) {
          // the product, then the difference, as the plain version
          const float p =
              expf(__fsub_rn(__fmul_rn(s[i][j], scale), lse_s[r]));
          dsv = round_as<E>(p * (dp[i][j] - dl_s[r]));
        }
        ds[r * G::LP + c] = dsv;
      }
    }
    __syncthreads();
    accumulate<DC, G::COLS>(dq_acc, ds, ks);
  }

  if (out_f32) {
    store_tile<float, DC>(static_cast<float*>(dq) + q_off, q_stride, q_valid,
                          D, dq_acc, scale);
  } else {
    store_tile<E, DC>(static_cast<E*>(dq) + q_off, q_stride, q_valid, D,
                      dq_acc, scale);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  q/dout [B,T,H,D], k/v
// [B,Tk,KVH,D] contiguous, all of the element type `dtype` (GenDtype); lse
// and delta [B,H,T] f32; seg_q [B,T] / seg_k [B,Tk] int32 or both null; dq
// [B,T,H,D] in float32 when out_f32 != 0, else in `dtype`, allocated by the
// caller.  Launches on `stream` without synchronizing and returns
// cudaGetLastError() (cudaErrorInvalidValue for a dtype, head dim or shape
// it does not take).
extern "C" int sofa_flash_gen_bwd_dq(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* delta,
                                     const int* seg_q, const int* seg_k,
                                     void* dq, int out_f32, int dtype, int B,
                                     int T, int Tk, int H, int KVH, int D,
                                     long long shift, float scale,
                                     void* stream) {
  if (B <= 0 || T <= 0 || Tk <= 0 || KVH <= 0 || H % KVH != 0 ||
      (T + GEN_ROWS - 1) / GEN_ROWS > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(dtype, D, [&](auto elem, auto cap) {
    using E = typename decltype(elem)::type;
    constexpr int DC = decltype(cap)::value;
    const int smem = dq_smem<DC>();
    cudaError_t err = allow_smem(sofa_flash_gen_bwd_dq_kernel<E, DC>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(B * H, (T + GEN_ROWS - 1) / GEN_ROWS);
    sofa_flash_gen_bwd_dq_kernel<E, DC><<<grid, GEN_THREADS, smem, st>>>(
        static_cast<const E*>(q), static_cast<const E*>(k),
        static_cast<const E*>(v), static_cast<const E*>(dout), lse, delta,
        seg_q, seg_k, dq, out_f32 != 0, T, Tk, H, KVH, D, shift, scale);
    return cudaGetLastError();
  }));
}

// Dynamic shared memory one block asks for at head dim d (0 if
// unsupported); the same for every dtype (tiles are staged as float32).
extern "C" int sofa_flash_gen_bwd_dq_smem_bytes(int d) {
  switch (gen_cap(d)) {
    case 16: return dq_smem<16>();
    case 32: return dq_smem<32>();
    case 64: return dq_smem<64>();
    case 128: return dq_smem<128>();
    case 256: return dq_smem<256>();
    default: return 0;
  }
}
