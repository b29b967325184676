// sofa_flash_bwd_dq: the dQ half of the fused attention backward for Hopper
// (sm_90a), bf16 in, f32 accumulate, dq out in bf16 or float32.
//
// Replaces the TPU kernel sofa_tpu/workloads/flash_pallas.py:_bwd_q_kernel
// (launched as name="sofa_flash_bwd_dq" by _flash_backward,
// flash_pallas.py:673) and computes the same function.  For one query head
// and one 64-row q-tile, over every key the causal rule (key j visible to
// query i iff j <= i + shift) and the optional segment ids let it see:
//   p   = exp(s * scale - max(lse, -1e29))          s = Q K^T
//   dp  = dO V^T
//   ds  = bf16(p * (dp - delta))                     delta = rowsum(dO * O)
//   dQ += ds K,  times scale after the product
// GQA is native: query head h reads compact K/V head h / (H / KVH).  Masked
// pairs and rows with no visible key give exact zeros, as on the TPU.  The
// TPU kernel's transposed [D, bq] accumulator is a Mosaic relayout
// workaround and is not carried over: dQ is accumulated and written in the
// [B, T, H, D] layout directly.
//
// What bounds it on an H100: bf16 tensor-core operations, three products of
// 64 x 64 x D per visible tile pair: 6*B*H*D*T*(T+1)/2 flops under causal
// masking (2.06e11 at the Llama-3-8B training shape B=4, T=2048, H=32,
// D=128) against ~0.2 GB of operands.  The design follows sofa_flash_fwd:
// one thread block per (batch * head, 64-row q-tile), heaviest tiles first,
// a loop over the 64-key K/V tiles up to the causal frontier set by the
// runtime shift, four warps of 16 rows, mma.sync m16n8k16 with ds fed to
// the dQ product straight from its accumulators.  Q and dO stay in shared
// memory (their fragments are re-read per K/V tile), which keeps the 16 x D
// f32 dQ accumulator, s and dp inside the register budget.

#include "flash_common.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(THREADS) sofa_flash_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ seg_q, const int* __restrict__ seg_k,
    void* __restrict__ dq, bool out_f32, int T, int Tk, int H, int KVH,
    long long shift, float scale) {
  constexpr int LD = D + PAD;
  constexpr int KD = D / 16;            // k-steps over the head dim
  constexpr int NS = BLOCK / 8;         // n-tiles of s (8 keys each)
  constexpr int NO = D / 8;             // n-tiles of dQ (8 columns each)

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_tile = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* do_tile = q_tile + BLOCK * LD;
  __nv_bfloat16* k_tile = do_tile + BLOCK * LD;
  __nv_bfloat16* v_tile = k_tile + BLOCK * LD;
  int* segk_tile = reinterpret_cast<int*>(v_tile + BLOCK * LD);

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  const long long q_stride = static_cast<long long>(H) * D;
  const long long kv_stride = static_cast<long long>(KVH) * D;
  const long long q_off =
      static_cast<long long>(b) * T * q_stride + static_cast<long long>(h) * D;
  const long long kv_off =
      static_cast<long long>(b) * Tk * kv_stride + static_cast<long long>(kvh) * D;
  load_tile<D>(q_tile, q + q_off, q0, T, q_stride);
  load_tile<D>(do_tile, dout + q_off, q0, T, q_stride);

  // This thread's two rows of the tile: r and r + 8 within its warp's 16.
  const int r = warp * 16 + g;
  const int row0 = q0 + r, row1 = row0 + 8;
  const float* lse_bh = lse + (static_cast<long long>(b) * H + h) * T;
  const float* delta_bh = delta + (static_cast<long long>(b) * H + h) * T;
  // Rows past T are masked to p = 0 below; their lse/delta are never read.
  const float lse0 = row0 < T ? fmaxf(lse_bh[row0], M_FLOOR) : 0.f;
  const float lse1 = row1 < T ? fmaxf(lse_bh[row1], M_FLOOR) : 0.f;
  const float dlt0 = row0 < T ? delta_bh[row0] : 0.f;
  const float dlt1 = row1 < T ? delta_bh[row1] : 0.f;
  const bool segmented = seg_q != nullptr;
  int sq0 = 0, sq1 = 0;
  if (segmented) {
    sq0 = row0 < T ? seg_q[static_cast<long long>(b) * T + row0] : 0;
    sq1 = row1 < T ? seg_q[static_cast<long long>(b) * T + row1] : 0;
  }

  float dq_acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) dq_acc[j][0] = dq_acc[j][1] = dq_acc[j][2] = dq_acc[j][3] = 0.f;

  // Causal frontier: the last key any row of this tile can see.
  const long long last = static_cast<long long>(q0) + BLOCK - 1 + shift;
  int n_tiles = 0;
  if (last >= 0) {
    const long long by_mask = last / BLOCK + 1;
    const long long by_len = (Tk + BLOCK - 1) / BLOCK;
    n_tiles = static_cast<int>(by_mask < by_len ? by_mask : by_len);
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BLOCK;
    __syncthreads();                    // every warp is done with the last tile
    load_tile<D>(k_tile, k + kv_off, k0, Tk, kv_stride);
    load_tile<D>(v_tile, v + kv_off, k0, Tk, kv_stride);
    if (segmented && threadIdx.x < BLOCK) {
      const int j = k0 + threadIdx.x;
      segk_tile[threadIdx.x] =
          j < Tk ? seg_k[static_cast<long long>(b) * Tk + j] : 0;
    }
    __syncthreads();

    // s = Q K^T and dp = dO V^T for this warp's 16 rows x 64 keys.
    float p[NS][4], ds[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) p[n][e] = ds[n][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      load_a<LD>(a, q_tile, r, kk * 16 + 2 * t);
      mma_abt<LD>(p, a, k_tile, kk, g, t);
      load_a<LD>(a, do_tile, r, kk * 16 + 2 * t);
      mma_abt<LD>(ds, a, v_tile, kk, g, t);
    }

    // p = exp(s * scale - lse), exactly 0 where masked; ds = p (dp - delta).
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jj = n * 8 + 2 * t + (e & 1);
        const int key = k0 + jj;
        const int row = e < 2 ? row0 : row1;
        bool masked = row >= T || key >= Tk || key > row + shift;
        if (segmented) masked = masked || segk_tile[jj] != (e < 2 ? sq0 : sq1);
        const float x = masked ? NEG_INF : p[n][e] * scale;
        const float pe = __expf(x - (e < 2 ? lse0 : lse1));
        ds[n][e] = pe * (ds[n][e] - (e < 2 ? dlt0 : dlt1));
      }
    }

    // dQ += bf16(ds) K.
    mma_py<LD>(dq_acc, ds, k_tile, g, t);
  }

  const size_t elem = out_f32 ? sizeof(float) : sizeof(__nv_bfloat16);
  char* dq_bh = static_cast<char*>(dq) + q_off * elem;
  if (row0 < T) store_row(dq_bh + row0 * q_stride * elem, out_f32, dq_acc, 0, scale, t);
  if (row1 < T) store_row(dq_bh + row1 * q_stride * elem, out_f32, dq_acc, 1, scale, t);
}

template <int D>
constexpr int smem_bytes() {
  return 4 * BLOCK * (D + PAD) * static_cast<int>(sizeof(__nv_bfloat16)) +
         BLOCK * static_cast<int>(sizeof(int));
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   const int* seg_q, const int* seg_k, void* dq, bool out_f32,
                   int B, int T, int Tk, int H, int KVH, long long shift,
                   float scale, cudaStream_t stream) {
  const int smem = smem_bytes<D>();
  cudaError_t err = allow_smem(sofa_flash_bwd_dq_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (T + BLOCK - 1) / BLOCK);
  sofa_flash_bwd_dq_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), lse, delta, seg_q, seg_k, dq,
      out_f32, T, Tk, H, KVH, shift, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  q, dout [B,T,H,D] and k, v
// [B,Tk,KVH,D] contiguous bf16; lse, delta [B,H,T] f32; seg_q [B,T] / seg_k
// [B,Tk] int32 or both null; dq [B,T,H,D] in f32 when out_f32 is nonzero,
// else bf16, allocated by the caller.  Launches on `stream` without
// synchronizing and returns cudaGetLastError().
extern "C" int sofa_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, const int* seg_q,
                                 const int* seg_k, void* dq, int out_f32,
                                 int B, int T, int Tk, int H, int KVH, int D,
                                 long long shift, float scale, void* stream) {
  if (B <= 0 || T <= 0 || Tk <= 0 || KVH <= 0 || H % KVH != 0 ||
      (T + BLOCK - 1) / BLOCK > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return static_cast<int>(launch<64>(q, k, v, dout, lse, delta, seg_q,
                                         seg_k, dq, out_f32 != 0, B, T, Tk, H,
                                         KVH, shift, scale, s));
    case 128:
      return static_cast<int>(launch<128>(q, k, v, dout, lse, delta, seg_q,
                                          seg_k, dq, out_f32 != 0, B, T, Tk, H,
                                          KVH, shift, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory one block asks for at head dim d (0 if unsupported).
extern "C" int sofa_flash_bwd_dq_smem_bytes(int d) {
  return d == 64 ? smem_bytes<64>() : d == 128 ? smem_bytes<128>() : 0;
}
