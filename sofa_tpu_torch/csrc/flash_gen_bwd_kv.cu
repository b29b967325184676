// sofa_flash_gen_bwd_kv: the dK/dV half of the fused attention backward
// for every (dtype, head dim) the Hopper kernel sofa_flash_bwd_kv does not
// take: bfloat16, float16 or float32 at any head dim 1..256, float32
// accumulation, dk/dv out in the inputs' dtype or float32.
//
// Replaces, on that part of its domain, the TPU kernel
// sofa_tpu/workloads/flash_pallas.py:_bwd_kv_kernel (launched as
// name="sofa_flash_bwd_kv" by _flash_backward, flash_pallas.py:619) and
// computes the same function as flash_cuda._flash_bwd_kv_plain.  For one
// compact K/V head and one key tile, summed over every query head of its
// GQA group and every query the causal rule (key j visible to query i iff
// j <= i + shift) and the optional segment ids let see it:
//   p^T  = exp(s^T * scale - max(lse, -1e29))      s^T = K Q^T (float32)
//   dV  += round_dO(p^T) dO
//   dp^T = V dO^T
//   ds^T = round_q(p^T * (dp^T - delta))            delta = rowsum(dO * O)
//   dK  += ds^T Q,  times scale after the product
// Masked pairs and query rows past T give p = 0 exactly, so a row with no
// visible key (lse ~ -1e29 from the forward) contributes nothing, and a key
// tile that no query sees writes exact zeros.
//
// What bounds it on an H100: operations, four products over the visible
// (key, query) pairs, 8*B*H*D*T*(T+1)/2 flops under causal masking.  The
// design (flash_gen.cuh), float32 FMA on the CUDA cores: one block per
// (batch * KV head, 64-key tile), the earliest key tiles (which the most
// queries see) first; K and V staged once; the block walks the group's
// query heads and, for each, the query tiles (64 rows, 32 at D > 128) from
// the first one that can see the block's first key to the end of T,
// staging Q, dO and the tile's clamped lse, delta and segment ids.  dK and
// dV stay in registers across the whole walk, so the group sum needs no
// atomics and no second pass, and two launches agree bit for bit.
// ptxas -v (CUDA 12.8, sm_90a): 64-255 registers a thread (255 at cap 256
// in bfloat16 and float16, 234 in float32), no spills but 16 / 52 bytes at
// float32 cap 16; dynamic shared memory 51,712 / 68,096 / 100,864 / 166,400
// / 214,912 bytes a block at caps 16 / 32 / 64 / 128 / 256
// (sofa_flash_gen_bwd_kv_smem_bytes).

#include "flash_gen.cuh"

namespace {

// Shared memory of one block at cap DC: K and V [ROWS][LD], Q and dO
// [COLS][LD], p^T and ds^T [ROWS][LP], the query tile's lse, delta and
// segment ids [COLS], the key tile's segment ids [ROWS].
template <int DC>
constexpr int kv_smem() {
  using G = Gen<DC>;
  return 4 * (2 * (G::ROWS + G::COLS) * G::LD + 2 * G::ROWS * G::LP +
              3 * G::COLS + G::ROWS);
}

template <typename E, int DC>
__global__ void __launch_bounds__(GEN_THREADS) sofa_flash_gen_bwd_kv_kernel(
    const E* __restrict__ q, const E* __restrict__ k,
    const E* __restrict__ v, const E* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ seg_q, const int* __restrict__ seg_k, void* dk,
    void* dv, bool out_f32, int T, int Tk, int H, int KVH, int D,
    long long shift, float scale) {
  using G = Gen<DC>;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + G::ROWS * G::LD;
  float* qs = vs + G::ROWS * G::LD;
  float* gs = qs + G::COLS * G::LD;
  float* ps = gs + G::COLS * G::LD;
  float* ds = ps + G::ROWS * G::LP;
  float* lse_s = ds + G::ROWS * G::LP;
  float* dl_s = lse_s + G::COLS;
  int* sq_s = reinterpret_cast<int*>(dl_s + G::COLS);
  int* sk_s = sq_s + G::COLS;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.x / KVH, kvh = blockIdx.x % KVH;
  const int group = H / KVH;
  const int k0 = blockIdx.y * G::ROWS;
  const int k_valid = min(G::ROWS, Tk - k0);
  const long long q_stride = static_cast<long long>(H) * D;
  const long long kv_stride = static_cast<long long>(KVH) * D;
  const long long kv_off = (static_cast<long long>(b) * Tk + k0) * kv_stride +
                           static_cast<long long>(kvh) * D;
  const bool segmented = seg_q != nullptr;

  load_tile<E, DC>(ks, k + kv_off, kv_stride, G::ROWS, k_valid, D);
  load_tile<E, DC>(vs, v + kv_off, kv_stride, G::ROWS, k_valid, D);
  if (segmented && tid < G::ROWS) {
    sk_s[tid] = tid < k_valid
                    ? seg_k[static_cast<long long>(b) * Tk + k0 + tid]
                    : 0;
  }

  float dk_acc[G::RI][G::DJ], dv_acc[G::RI][G::DJ];
#pragma unroll
  for (int i = 0; i < G::RI; ++i) {
#pragma unroll
    for (int j = 0; j < G::DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;
  }

  // The first query that can see key k0: i >= k0 - shift.
  const long long first = static_cast<long long>(k0) - shift;
  const int q_first =
      first <= 0 ? 0 : first >= T ? T : static_cast<int>(first);
  const int qt0 = q_first / G::COLS * G::COLS;
  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    const long long row0 = (static_cast<long long>(b) * H + h) * T;
    for (int q0 = qt0; q0 < T; q0 += G::COLS) {
      const int q_valid = min(G::COLS, T - q0);
      const long long q_off = (static_cast<long long>(b) * T + q0) * q_stride +
                              static_cast<long long>(h) * D;
      __syncthreads();   // the last tile's Q, dO, p^T and ds^T are consumed
      load_tile<E, DC>(qs, q + q_off, q_stride, G::COLS, q_valid, D);
      load_tile<E, DC>(gs, dout + q_off, q_stride, G::COLS, q_valid, D);
      if (tid < G::COLS) {
        const bool in = tid < q_valid;
        lse_s[tid] = in ? fmaxf(lse[row0 + q0 + tid], M_FLOOR) : 0.f;
        dl_s[tid] = in ? delta[row0 + q0 + tid] : 0.f;
        if (segmented) {
          sq_s[tid] = in ? seg_q[static_cast<long long>(b) * T + q0 + tid]
                         : 0;
        }
      }
      __syncthreads();

      float st[G::RI][G::CJ], dpt[G::RI][G::CJ];
      products<DC>(st, ks, qs, D);
      products<DC>(dpt, vs, gs, D);
#pragma unroll
      for (int i = 0; i < G::RI; ++i) {
        const int r = ty + 16 * i;   // key
#pragma unroll
        for (int j = 0; j < G::CJ; ++j) {
          const int c = tx + 16 * j;   // query
          bool vis = r < k_valid && c < q_valid &&
                     static_cast<long long>(k0) + r <=
                         static_cast<long long>(q0) + c + shift;
          if (segmented && vis) vis = sk_s[r] == sq_s[c];
          float p = 0.f, dsv = 0.f;
          if (vis) {
            // the product, then the difference, as the plain version
            p = expf(__fsub_rn(__fmul_rn(st[i][j], scale), lse_s[c]));
            dsv = round_as<E>(p * (dpt[i][j] - dl_s[c]));
          }
          ps[r * G::LP + c] = round_as<E>(p);
          ds[r * G::LP + c] = dsv;
        }
      }
      __syncthreads();
      accumulate<DC, G::COLS>(dv_acc, ps, gs);
      accumulate<DC, G::COLS>(dk_acc, ds, qs);
    }
  }

  if (out_f32) {
    store_tile<float, DC>(static_cast<float*>(dk) + kv_off, kv_stride,
                          k_valid, D, dk_acc, scale);
    store_tile<float, DC>(static_cast<float*>(dv) + kv_off, kv_stride,
                          k_valid, D, dv_acc, 1.f);
  } else {
    store_tile<E, DC>(static_cast<E*>(dk) + kv_off, kv_stride, k_valid, D,
                      dk_acc, scale);
    store_tile<E, DC>(static_cast<E*>(dv) + kv_off, kv_stride, k_valid, D,
                      dv_acc, 1.f);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  q/dout [B,T,H,D], k/v
// [B,Tk,KVH,D] contiguous, all of the element type `dtype` (GenDtype); lse
// and delta [B,H,T] f32; seg_q [B,T] / seg_k [B,Tk] int32 or both null; dk
// and dv [B,Tk,KVH,D] in float32 when out_f32 != 0, else in `dtype`,
// allocated by the caller.  Launches on `stream` without synchronizing and
// returns cudaGetLastError() (cudaErrorInvalidValue for a dtype, head dim
// or shape it does not take).
extern "C" int sofa_flash_gen_bwd_kv(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* delta,
                                     const int* seg_q, const int* seg_k,
                                     void* dk, void* dv, int out_f32,
                                     int dtype, int B, int T, int Tk, int H,
                                     int KVH, int D, long long shift,
                                     float scale, void* stream) {
  if (B <= 0 || T <= 0 || Tk <= 0 || KVH <= 0 || H % KVH != 0 ||
      (Tk + GEN_ROWS - 1) / GEN_ROWS > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(dtype, D, [&](auto elem, auto cap) {
    using E = typename decltype(elem)::type;
    constexpr int DC = decltype(cap)::value;
    const int smem = kv_smem<DC>();
    cudaError_t err = allow_smem(sofa_flash_gen_bwd_kv_kernel<E, DC>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(B * KVH, (Tk + GEN_ROWS - 1) / GEN_ROWS);
    sofa_flash_gen_bwd_kv_kernel<E, DC><<<grid, GEN_THREADS, smem, st>>>(
        static_cast<const E*>(q), static_cast<const E*>(k),
        static_cast<const E*>(v), static_cast<const E*>(dout), lse, delta,
        seg_q, seg_k, dk, dv, out_f32 != 0, T, Tk, H, KVH, D, shift, scale);
    return cudaGetLastError();
  }));
}

// Dynamic shared memory one block asks for at head dim d (0 if
// unsupported); the same for every dtype (tiles are staged as float32).
extern "C" int sofa_flash_gen_bwd_kv_smem_bytes(int d) {
  switch (gen_cap(d)) {
    case 16: return kv_smem<16>();
    case 32: return kv_smem<32>();
    case 64: return kv_smem<64>();
    case 128: return kv_smem<128>();
    case 256: return kv_smem<256>();
    default: return 0;
  }
}
