// sofa_flash_bwd_dq: the dQ half of the fused attention backward for Hopper
// (sm_90a), bf16 in, f32 accumulate, dq out in bf16 or float32.
//
// Replaces the TPU kernel sofa_tpu/workloads/flash_pallas.py:_bwd_q_kernel
// (launched as name="sofa_flash_bwd_dq" by _flash_backward,
// flash_pallas.py:673) and computes the same function.  For one query head
// and one q-tile, over every key the causal rule (key j visible to query i
// iff j <= i + shift) and the optional segment ids let it see:
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
// D=128) against ~0.2 GB of operands.  The design is the forward's
// (flash_fwd.cu) with one more product:
//   - one block per (batch * head, 128-row q-tile), two consumer warpgroups
//     of 64 rows and a producer warpgroup; heaviest q-tiles (nearest the
//     end of a causal sequence) first; a loop over the 64-key K/V tiles up
//     to the causal frontier of the runtime shift.  No atomics and no split
//     over keys, so two launches agree bit for bit;
//   - Q and dO are loaded once by TMA, K and V stream through a four-stage
//     ring of 128B-swizzled panels (csrc/hopper.cuh) refilled by one
//     producer warp, which also copies the tile's segment ids beside it;
//     rows past T or Tk arrive as zeros.  The producer warpgroup drops to 24
//     registers a thread (setmaxnreg) and each consumer thread may use 240;
//   - s = Q K^T and dp = dO V^T are wgmma m64n64 with both operands in
//     shared memory (K and V as stored are the K-major B), issued together;
//     ds then repacks from dp's accumulator straight into the register A
//     operand of dQ += ds K (wgmma m64nD, K read through the transpose bit),
//     so nothing is transposed or stored; lse (clamped) and delta of a
//     thread's two rows stay in registers;
//   - the causal, length and segment masks are applied only to the tiles
//     that cross a warpgroup's diagonal, the ragged end of Tk, or a
//     segmented call; a tile that no row of the warpgroup can see skips its
//     products, and a warpgroup wholly past T computes nothing.
// p is exp(s * scale - lse) rounded as the plain version rounds it
// (bwd_p).  Measured (PERF.md; NVIDIA H100 80GB HBM3, 700 W): 0.368-0.384
// ms at the Llama-3-8B training shape, 54-57 % of the 0.209 ms tensor-core
// bound.
// In development builds, issuing tile j + 1's s and dp with tile j's dQ
// product (ds of j + 1 formed under it) was slower.
// ptxas -v (CUDA 12.8, sm_90a): 168 registers a thread at launch (65,536 /
// 384, before setmaxnreg) at D 128 and D 64, no spills; dynamic shared
// memory 198,728 / 100,424 bytes a block at D 128 / D 64
// (sofa_flash_bwd_dq_smem_bytes), so one block per SM.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BLOCK_M = 128;            // query rows per block
constexpr int BLOCK_N = 64;             // keys per K/V tile
constexpr int WG_ROWS = 64;             // query rows per consumer warpgroup
constexpr int CONSUMERS = BLOCK_M / WG_ROWS;
constexpr int DQ_THREADS = (CONSUMERS + 1) * 128;   // + the producer
// The ring depth is the one tile constant a build may set
// (-DFLASH_STAGES=N, tools/tune_flash.py); BLOCK_M and BLOCK_N fix the
// warpgroup and wgmma layouts.
#ifndef FLASH_STAGES
#define FLASH_STAGES 4
#endif
constexpr int STAGES = FLASH_STAGES;   // K/V ring depth
constexpr int PANEL_COLS = 64;          // bf16 columns of a 128-byte panel
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

// Shared memory of one block, from a 1024-byte aligned base: Q then dO (D /
// 64 panels of BLOCK_M rows each), per stage K then V (D / 64 panels of
// BLOCK_N rows each), per stage the tile's BLOCK_N segment ids, then the
// barriers q_full, full[STAGES], empty[STAGES].
template <int D>
struct Smem {
  static constexpr int PANELS = D / PANEL_COLS;
  static constexpr int Q_PANEL = BLOCK_M * 128;
  static constexpr int KV_PANEL = BLOCK_N * 128;
  static constexpr int Q_BYTES = PANELS * Q_PANEL;       // Q or dO
  static constexpr int KV_BYTES = PANELS * KV_PANEL;     // one K or V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int RING = 2 * Q_BYTES;
  static constexpr int AUX = RING + STAGES * STAGE_BYTES;
  static constexpr int AUX_BYTES = BLOCK_N * 4;
  static constexpr int BARS = AUX + STAGES * AUX_BYTES;
  static constexpr int N_BARS = 1 + 2 * STAGES;
  // + 1024 so the base can be rounded up to the swizzle's alignment
  static constexpr int BYTES = BARS + N_BARS * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(DQ_THREADS, 1) sofa_flash_bwd_dq_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ seg_q, const int* __restrict__ seg_k,
    void* __restrict__ dq, bool out_f32, int T, int Tk, int H, int KVH,
    long long shift, float scale) {
  using S = Smem<D>;
  constexpr int KS = D / 16;            // k16 steps of s and dp
  constexpr int NS = BLOCK_N / 8;       // 8-key column groups of s
  constexpr int KP = BLOCK_N / 16;      // k16 steps of dQ
  constexpr int NO = D / 8;             // 8-column groups of dQ

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const base_ptr = smem_raw + (base - raw);
  const uint32_t q_s = base, do_s = base + S::Q_BYTES;
  const uint32_t bar = base + S::BARS;
  const uint32_t q_full = bar;
  auto k_s = [&](int st) { return base + S::RING + st * S::STAGE_BYTES; };
  auto v_s = [&](int st) { return k_s(st) + S::KV_BYTES; };
  auto seg_aux = [&](int st) {
    return reinterpret_cast<int*>(base_ptr + S::AUX + st * S::AUX_BYTES);
  };
  auto full = [&](int st) { return bar + 8 * (1 + st); };
  auto empty = [&](int st) { return bar + 8 * (1 + STAGES + st); };

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK_M;
  const bool segmented = seg_q != nullptr;

  // Causal frontier: the last key any row of this block can see.
  const long long last = static_cast<long long>(q0) + BLOCK_M - 1 + shift;
  int n_tiles = 0;
  if (last >= 0) {
    const long long by_mask = last / BLOCK_N + 1;
    const long long by_len = (Tk + BLOCK_N - 1) / BLOCK_N;
    n_tiles = static_cast<int>(by_mask < by_len ? by_mask : by_len);
  }

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 32);                // every producer lane
      mbar_init(empty(st), CONSUMERS * 4);    // one arrival per warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: one warp refills the ring; the others only give up
    // their registers ----
    setmaxnreg_dec<PRODUCER_REGS>();
    const int lane = tid % 32;
    if (tid % 128 < 32 && n_tiles > 0) {
      if (lane == 0) {
        tma_prefetch_map(&k_map);
        tma_prefetch_map(&v_map);
        mbar_arrive_expect_tx(q_full, 2 * S::Q_BYTES);
        for (int p = 0; p < S::PANELS; ++p) {
          tma_load_4d(q_s + p * S::Q_PANEL, &q_map, q_full, p * PANEL_COLS, h,
                      q0, b);
          tma_load_4d(do_s + p * S::Q_PANEL, &do_map, q_full, p * PANEL_COLS,
                      h, q0, b);
        }
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % STAGES;
        if (j >= STAGES) mbar_wait(empty(st), ((j / STAGES) + 1) & 1);
        if (segmented) {
          int* sa = seg_aux(st);
          for (int i = lane; i < BLOCK_N; i += 32) {
            const int key = j * BLOCK_N + i;
            sa[i] = key < Tk ? seg_k[static_cast<long long>(b) * Tk + key] : 0;
          }
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(full(st), S::STAGE_BYTES);
          for (int p = 0; p < S::PANELS; ++p) {
            tma_load_4d(k_s(st) + p * S::KV_PANEL, &k_map, full(st),
                        p * PANEL_COLS, kvh, j * BLOCK_N, b);
            tma_load_4d(v_s(st) + p * S::KV_PANEL, &v_map, full(st),
                        p * PANEL_COLS, kvh, j * BLOCK_N, b);
          }
        } else {
          mbar_arrive(full(st));
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows [wrow, wrow + 64) ----
    setmaxnreg_inc<CONSUMER_REGS>();
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;   // accumulator row group / col pair
    const int wrow = q0 + wg * WG_ROWS;
    const int row0 = wrow + warp * 16 + g, row1 = row0 + 8;
    const bool dead = wrow >= T;            // every row past T
    const float* lse_bh = lse + (static_cast<long long>(b) * H + h) * T;
    const float* delta_bh = delta + (static_cast<long long>(b) * H + h) * T;
    // Rows past T are never stored; their lse/delta are never read.
    const float lse0 = row0 < T ? fmaxf(lse_bh[row0], M_FLOOR) : 0.f;
    const float lse1 = row1 < T ? fmaxf(lse_bh[row1], M_FLOOR) : 0.f;
    const float dlt0 = row0 < T ? delta_bh[row0] : 0.f;
    const float dlt1 = row1 < T ? delta_bh[row1] : 0.f;
    int sq0 = 0, sq1 = 0;
    if (segmented) {
      sq0 = row0 < T ? seg_q[static_cast<long long>(b) * T + row0] : 0;
      sq1 = row1 < T ? seg_q[static_cast<long long>(b) * T + row1] : 0;
    }

    float dq_acc[NO][4];
#pragma unroll
    for (int j = 0; j < NO; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.f;
    }
    float s[NS][4], dp[NS][4];
    uint32_t da[KP][4];
    // Q and dO rows of this warpgroup: rows [wg * 64, wg * 64 + 64) of each
    // panel (8 KB in, a multiple of the swizzle's 1024 bytes).
    const uint32_t q_wg = q_s + wg * WG_ROWS * 128;
    const uint32_t do_wg = do_s + wg * WG_ROWS * 128;
    // Descriptors of this warpgroup's Q and dO rows and of stage 0's K
    // (K-major and transposed); a k16 step or another stage adds its offset
    const uint64_t desc_q = desc_sw128(q_wg, 16, SW128_SBO);
    const uint64_t desc_do = desc_sw128(do_wg, 16, SW128_SBO);
    const uint64_t desc_k = desc_sw128(k_s(0), 16, SW128_SBO);
    const uint64_t tdesc_k = desc_sw128(k_s(0), S::KV_PANEL, SW128_SBO);
    if (n_tiles > 0) mbar_wait(q_full, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % STAGES;
      const int kt = j * BLOCK_N;
      mbar_wait(full(st), (j / STAGES) & 1);
      // no row of this warpgroup sees any key of the tile
      const bool blind =
          dead || kt > static_cast<long long>(wrow) + WG_ROWS - 1 + shift;
      if (!blind) {
        // s = Q K^T and dp = dO V^T, issued together
        wgmma_fence();
        const uint64_t desc_k_st = desc_add(desc_k, st * S::STAGE_BYTES);
        const uint64_t desc_v_st = desc_add(desc_k_st, S::KV_BYTES);
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int off_a = (ks / 4) * S::Q_PANEL + (ks % 4) * 32;
          const int off_b = (ks / 4) * S::KV_PANEL + (ks % 4) * 32;
          wgmma_ss<BLOCK_N, 0>(s, desc_add(desc_q, off_a),
                               desc_add(desc_k_st, off_b), ks > 0);
        }
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int off_a = (ks / 4) * S::Q_PANEL + (ks % 4) * 32;
          const int off_b = (ks / 4) * S::KV_PANEL + (ks % 4) * 32;
          wgmma_ss<BLOCK_N, 0>(dp, desc_add(desc_do, off_a),
                               desc_add(desc_v_st, off_b), ks > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(s);
        fence_operands(dp);

        // p = exp(s * scale - lse), exactly 0 where
        // masked; ds = p (dp - delta) in place of dp, packed for dQ.
        const bool need_mask =
            segmented || kt + BLOCK_N > Tk ||
            static_cast<long long>(kt) + BLOCK_N - 1 > wrow + shift;
        if (need_mask) {
          const int* sa = seg_aux(st);
#pragma unroll
          for (int n = 0; n < NS; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int jj = n * 8 + 2 * t + (e & 1);
              const int key = kt + jj;
              const int row = e < 2 ? row0 : row1;
              bool masked =
                  key >= Tk || key > static_cast<long long>(row) + shift;
              if (segmented && !masked) {
                masked = sa[jj] != (e < 2 ? sq0 : sq1);
              }
              const float p =
                  masked ? 0.f : bwd_p(s[n][e], scale, e < 2 ? lse0 : lse1);
              dp[n][e] = p * (dp[n][e] - (e < 2 ? dlt0 : dlt1));
            }
          }
        } else {
#pragma unroll
          for (int n = 0; n < NS; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float p = bwd_p(s[n][e], scale, e < 2 ? lse0 : lse1);
              dp[n][e] = p * (dp[n][e] - (e < 2 ? dlt0 : dlt1));
            }
          }
        }
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          da[n / 2][(n % 2) * 2] = pack_f32(dp[n][0], dp[n][1]);
          da[n / 2][(n % 2) * 2 + 1] = pack_f32(dp[n][2], dp[n][3]);
        }
        // dQ += bf16(ds) K, K read through the transpose bit
        fence_operands(dq_acc);
        fence_operands(da);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KP; ++kk) {
          wgmma_rs<D, 1>(dq_acc, da[kk],
                         desc_add(tdesc_k, st * S::STAGE_BYTES + kk * 16 * 128),
                         1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(dq_acc);
        fence_operands(da);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }

    const long long q_stride = static_cast<long long>(H) * D;
    const long long q_off = static_cast<long long>(b) * T * q_stride +
                            static_cast<long long>(h) * D;
    const size_t elem = out_f32 ? sizeof(float) : sizeof(__nv_bfloat16);
    char* dq_bh = static_cast<char*>(dq) + q_off * elem;
    if (row0 < T) {
      store_row(dq_bh + row0 * q_stride * elem, out_f32, dq_acc, 0, scale, t);
    }
    if (row1 < T) {
      store_row(dq_bh + row1 * q_stride * elem, out_f32, dq_acc, 1, scale, t);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   const int* seg_q, const int* seg_k, void* dq, bool out_f32,
                   int B, int T, int Tk, int H, int KVH, long long shift,
                   float scale, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map, do_map;
  cudaError_t err = encode_heads(&q_map, q, D, H, T, B, BLOCK_M);
  if (err == cudaSuccess) {
    err = encode_heads(&do_map, dout, D, H, T, B, BLOCK_M);
  }
  if (err == cudaSuccess) err = encode_heads(&k_map, k, D, KVH, Tk, B, BLOCK_N);
  if (err == cudaSuccess) err = encode_heads(&v_map, v, D, KVH, Tk, B, BLOCK_N);
  if (err != cudaSuccess) return err;
  const int smem = Smem<D>::BYTES;
  err = allow_smem(sofa_flash_bwd_dq_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (T + BLOCK_M - 1) / BLOCK_M);
  sofa_flash_bwd_dq_kernel<D><<<grid, DQ_THREADS, smem, stream>>>(
      q_map, k_map, v_map, do_map, lse, delta, seg_q, seg_k, dq, out_f32, T,
      Tk, H, KVH, shift, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  q, dout [B,T,H,D] and k, v
// [B,Tk,KVH,D] contiguous bf16, 16-byte aligned; lse, delta [B,H,T] f32;
// seg_q [B,T] / seg_k [B,Tk] int32 or both null; dq [B,T,H,D] in f32 when
// out_f32 is nonzero, else bf16, allocated by the caller.  Launches on
// `stream` without synchronizing and returns cudaGetLastError()
// (cudaErrorInvalidValue when a tensor map cannot be encoded).
extern "C" int sofa_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, const int* seg_q,
                                 const int* seg_k, void* dq, int out_f32,
                                 int B, int T, int Tk, int H, int KVH, int D,
                                 long long shift, float scale, void* stream) {
  if (B <= 0 || T <= 0 || Tk <= 0 || KVH <= 0 || H % KVH != 0 ||
      (T + BLOCK_M - 1) / BLOCK_M > 65535) {
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
  return d == 64 ? Smem<64>::BYTES : d == 128 ? Smem<128>::BYTES : 0;
}
