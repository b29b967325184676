// sofa_flash_bwd_kv: the dK/dV half of the fused attention backward for
// Hopper (sm_90a), bf16 in, f32 accumulate, dk/dv out in bf16 or float32.
//
// Replaces the TPU kernel sofa_tpu/workloads/flash_pallas.py:_bwd_kv_kernel
// (launched as name="sofa_flash_bwd_kv" by _flash_backward,
// flash_pallas.py:619) and computes the same function.  For one compact K/V
// head and one 64-key tile, summed over every query head of its GQA group and
// every query the causal rule (key j visible to query i iff j <= i + shift)
// and the optional segment ids let see it:
//   p^T  = exp(s^T * scale - max(lse, -1e29))      s^T = K Q^T
//   dV  += bf16(p^T) dO
//   dp^T = V dO^T
//   ds^T = bf16(p^T * (dp^T - delta))               delta = rowsum(dO * O)
//   dK  += ds^T Q,  times scale after the product
// Masked pairs and query rows past T give p = 0 exactly, so a row with no
// visible key (lse ~ -1e29 from the forward) contributes nothing.
//
// What bounds it on an H100: bf16 tensor-core operations.  Four products of
// 64 x 64 x D per visible tile pair: 8*B*H*D*T*(T+1)/2 flops under causal
// masking (2.75e11 at the Llama-3-8B training shape B=4, T=2048, H=32,
// D=128) against ~0.2 GB of q, dO, k, v, lse, delta, dk and dv, far above
// the card's ~295 flops/byte ridge.  The design:
//   - one thread block per (batch * KV head, 64-key tile); a loop inside the
//     block walks the group's query heads and, for each, the 64-row q-tiles
//     from the first one that can see this key tile to the end.  That loop
//     replaces the TPU's sequential `inner` grid axis and its q_block clamp,
//     and keeps the group sum in registers: no atomics, so dK and dV are
//     deterministic as on the TPU.  The heaviest key tiles (the first ones
//     of a causal sequence) have the lowest blockIdx.y and start first;
//   - four warps each own 16 keys; the dK and dV accumulators (16 x D each)
//     stay in f32 mma.sync registers for the whole loop;
//   - K and V stay in shared memory (their A fragments are re-read from it
//     for each q-tile) so that two D-wide accumulators, p^T and dp^T fit in
//     the 255-register budget; Q and dO tiles are shared by all four warps;
//   - p^T and ds^T feed the dV and dK products straight from the
//     accumulators of the products that made them (no shared round trip).
// Loads are synchronous 16-byte copies; wgmma, TMA and a pipelined q-tile
// ring are the known next steps.

#include "flash_common.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(THREADS) sofa_flash_bwd_kv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ seg_q, const int* __restrict__ seg_k,
    void* __restrict__ dk, void* __restrict__ dv, bool out_f32, int T, int Tk,
    int H, int KVH, long long shift, float scale) {
  constexpr int LD = D + PAD;
  constexpr int KD = D / 16;            // k-steps over the head dim
  constexpr int NS = BLOCK / 8;         // n-tiles of s^T (8 queries each)
  constexpr int NO = D / 8;             // n-tiles of dK / dV (8 columns each)

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_tile = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_tile = k_tile + BLOCK * LD;
  __nv_bfloat16* q_tile = v_tile + BLOCK * LD;
  __nv_bfloat16* do_tile = q_tile + BLOCK * LD;
  float* lse_tile = reinterpret_cast<float*>(do_tile + BLOCK * LD);
  float* delta_tile = lse_tile + BLOCK;
  int* segq_tile = reinterpret_cast<int*>(delta_tile + BLOCK);

  const int b = blockIdx.x / KVH, kvh = blockIdx.x % KVH;
  const int group = H / KVH;
  const int k0 = blockIdx.y * BLOCK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  const long long q_stride = static_cast<long long>(H) * D;
  const long long kv_stride = static_cast<long long>(KVH) * D;
  const long long kv_off =
      static_cast<long long>(b) * Tk * kv_stride + static_cast<long long>(kvh) * D;
  load_tile<D>(k_tile, k + kv_off, k0, Tk, kv_stride);
  load_tile<D>(v_tile, v + kv_off, k0, Tk, kv_stride);

  // This thread's two keys: r and r + 8 within its warp's 16.
  const int r = warp * 16 + g;
  const int key0 = k0 + r, key1 = key0 + 8;
  const bool segmented = seg_q != nullptr;
  int sk0 = 0, sk1 = 0;
  if (segmented) {
    sk0 = key0 < Tk ? seg_k[static_cast<long long>(b) * Tk + key0] : 0;
    sk1 = key1 < Tk ? seg_k[static_cast<long long>(b) * Tk + key1] : 0;
  }

  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  }

  // The first q-tile whose last row can see this tile's first key:
  // iq * 64 + 63 + shift >= k0.
  const int n_q = (T + BLOCK - 1) / BLOCK;
  const long long need = static_cast<long long>(k0) - shift - (BLOCK - 1);
  const long long first = need <= 0 ? 0 : (need + BLOCK - 1) / BLOCK;
  const int iq0 = first < n_q ? static_cast<int>(first) : n_q;

  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const long long q_off =
        static_cast<long long>(b) * T * q_stride + static_cast<long long>(h) * D;
    const float* lse_bh = lse + (static_cast<long long>(b) * H + h) * T;
    const float* delta_bh = delta + (static_cast<long long>(b) * H + h) * T;
    for (int iq = iq0; iq < n_q; ++iq) {
      const int q0 = iq * BLOCK;
      __syncthreads();                  // every warp is done with the last tile
      load_tile<D>(q_tile, q + q_off, q0, T, q_stride);
      load_tile<D>(do_tile, dout + q_off, q0, T, q_stride);
      if (threadIdx.x < BLOCK) {
        const int i = q0 + threadIdx.x;
        const bool in = i < T;          // rows past T: p is masked to 0 below
        lse_tile[threadIdx.x] = in ? fmaxf(lse_bh[i], M_FLOOR) : 0.f;
        delta_tile[threadIdx.x] = in ? delta_bh[i] : 0.f;
        if (segmented) {
          segq_tile[threadIdx.x] =
              in ? seg_q[static_cast<long long>(b) * T + i] : 0;
        }
      }
      __syncthreads();

      // s^T = K Q^T for this warp's 16 keys x 64 queries.
      float p[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a[4];
        load_a<LD>(a, k_tile, r, kk * 16 + 2 * t);
        mma_abt<LD>(p, a, q_tile, kk, g, t);
      }

      // p^T = exp(s^T * scale - lse), exactly 0 where masked.
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jj = n * 8 + 2 * t + (e & 1);
          const long long query = q0 + jj;
          const int key = e < 2 ? key0 : key1;
          bool masked = query >= T || key >= Tk || key > query + shift;
          if (segmented) masked = masked || segq_tile[jj] != (e < 2 ? sk0 : sk1);
          const float x = masked ? NEG_INF : p[n][e] * scale;
          p[n][e] = __expf(x - lse_tile[jj]);
        }
      }

      // dV += bf16(p^T) dO.
      mma_py<LD>(dv_acc, p, do_tile, g, t);

      // dp^T = V dO^T.
      float ds[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) ds[n][0] = ds[n][1] = ds[n][2] = ds[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a[4];
        load_a<LD>(a, v_tile, r, kk * 16 + 2 * t);
        mma_abt<LD>(ds, a, do_tile, kk, g, t);
      }

      // ds^T = p^T (dp^T - delta); dK += bf16(ds^T) Q.
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jj = n * 8 + 2 * t + (e & 1);
          ds[n][e] = p[n][e] * (ds[n][e] - delta_tile[jj]);
        }
      }
      mma_py<LD>(dk_acc, ds, q_tile, g, t);
    }
  }

  const size_t elem = out_f32 ? sizeof(float) : sizeof(__nv_bfloat16);
  char* dk_b = static_cast<char*>(dk) + kv_off * elem;
  char* dv_b = static_cast<char*>(dv) + kv_off * elem;
  if (key0 < Tk) {
    store_row(dk_b + key0 * kv_stride * elem, out_f32, dk_acc, 0, scale, t);
    store_row(dv_b + key0 * kv_stride * elem, out_f32, dv_acc, 0, 1.f, t);
  }
  if (key1 < Tk) {
    store_row(dk_b + key1 * kv_stride * elem, out_f32, dk_acc, 1, scale, t);
    store_row(dv_b + key1 * kv_stride * elem, out_f32, dv_acc, 1, 1.f, t);
  }
}

template <int D>
constexpr int smem_bytes() {
  return 4 * BLOCK * (D + PAD) * static_cast<int>(sizeof(__nv_bfloat16)) +
         3 * BLOCK * 4;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   const int* seg_q, const int* seg_k, void* dk, void* dv,
                   bool out_f32, int B, int T, int Tk, int H, int KVH,
                   long long shift, float scale, cudaStream_t stream) {
  const int smem = smem_bytes<D>();
  cudaError_t err = allow_smem(sofa_flash_bwd_kv_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * KVH, (Tk + BLOCK - 1) / BLOCK);
  sofa_flash_bwd_kv_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), lse, delta, seg_q, seg_k, dk, dv,
      out_f32, T, Tk, H, KVH, shift, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  q, dout [B,T,H,D] and k, v
// [B,Tk,KVH,D] contiguous bf16; lse, delta [B,H,T] f32; seg_q [B,T] / seg_k
// [B,Tk] int32 or both null; dk, dv [B,Tk,KVH,D] in f32 when out_f32 is
// nonzero, else bf16, allocated by the caller.  Launches on `stream` without
// synchronizing and returns cudaGetLastError().
extern "C" int sofa_flash_bwd_kv(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, const int* seg_q,
                                 const int* seg_k, void* dk, void* dv,
                                 int out_f32, int B, int T, int Tk, int H,
                                 int KVH, int D, long long shift, float scale,
                                 void* stream) {
  if (B <= 0 || T <= 0 || Tk <= 0 || KVH <= 0 || H % KVH != 0 ||
      (Tk + BLOCK - 1) / BLOCK > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return static_cast<int>(launch<64>(q, k, v, dout, lse, delta, seg_q,
                                         seg_k, dk, dv, out_f32 != 0, B, T, Tk,
                                         H, KVH, shift, scale, s));
    case 128:
      return static_cast<int>(launch<128>(q, k, v, dout, lse, delta, seg_q,
                                          seg_k, dk, dv, out_f32 != 0, B, T,
                                          Tk, H, KVH, shift, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory one block asks for at head dim d (0 if unsupported).
extern "C" int sofa_flash_bwd_kv_smem_bytes(int d) {
  return d == 64 ? smem_bytes<64>() : d == 128 ? smem_bytes<128>() : 0;
}
