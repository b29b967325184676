// sofa_flash_bwd_kv: the dK/dV half of the fused attention backward for
// Hopper (sm_90a), bf16 in, f32 accumulate, dk/dv out in bf16 or float32.
//
// Replaces the TPU kernel sofa_tpu/workloads/flash_pallas.py:_bwd_kv_kernel
// (launched as name="sofa_flash_bwd_kv" by _flash_backward,
// flash_pallas.py:619) and computes the same function.  For one compact K/V
// head and one key tile, summed over every query head of its GQA group and
// every query the causal rule (key j visible to query i iff j <= i + shift)
// and the optional segment ids let see it:
//   p^T  = exp(s^T * scale - max(lse, -1e29))      s^T = K Q^T
//   dV  += bf16(p^T) dO
//   dp^T = V dO^T
//   ds^T = bf16(p^T * (dp^T - delta))               delta = rowsum(dO * O)
//   dK  += ds^T Q,  times scale after the product
// Masked pairs and query rows past T give p = 0 exactly, so a row with no
// visible key (lse ~ -1e29 from the forward) contributes nothing, and a key
// tile that no query sees writes exact zeros.
//
// What bounds it on an H100: bf16 tensor-core operations.  Four products of
// 64 x 64 x D per visible (key, query) tile pair: 8*B*H*D*T*(T+1)/2 flops
// under causal masking (2.75e11 at the Llama-3-8B training shape B=4,
// T=2048, H=32, D=128) against ~0.2 GB of q, dO, k, v, lse, delta, dk and
// dv, far above the card's ~295 flops/byte ridge.  Only wgmma reaches the
// tensor cores' rate, and the four products need five D-wide or 64-wide f32
// accumulators between them.  The design:
//   - one block per (batch * KV head, 128-key tile): two consumer
//     warpgroups of 64 keys each, and a producer warpgroup.  The block walks
//     the group's query heads and, for each, the 64-query tiles from the
//     first one that can see the block's first key to the end of T.  That
//     walk replaces the TPU's sequential `inner` grid axis and its q_block
//     clamp and keeps the group sum in registers: no atomics and no split of
//     a sum across blocks, so two launches agree bit for bit.  The heaviest
//     key tiles (the first of a causal sequence) start first;
//   - K and V are loaded once by TMA; Q and dO tiles stream through a
//     three-stage ring of 128B-swizzled panels (csrc/hopper.cuh) that both
//     consumer warpgroups read, with the tile's 64 lse (clamped), delta and
//     segment ids copied beside them by the producer warp.
//     Q and dO are described as the 4-D tensor (D, H, T, B), so rows past T
//     arrive as zeros;
//   - the orientation is transposed, as on the TPU: an accumulator row is a
//     key.  s^T = K Q^T and dp^T = V dO^T are wgmma m64n64 with both operands
//     in shared memory (Q and dO as stored are the K-major B) and are issued
//     together; p^T and ds^T then repack from their accumulators straight
//     into the register A operand of dV += p^T dO and dK += ds^T Q (wgmma
//     m64nD, dO and Q read through the transpose bit), so no operand is ever
//     transposed or stored.  Both are issued together once ds^T is formed;
//   - registers are the crux: at D 128 a consumer thread holds dK and dV (64
//     f32 each), s^T and dp^T (32 each) and the packed operands.  The
//     producer warpgroup drops to 24 registers a thread (setmaxnreg) so that
//     each consumer thread may use 240: 128 x 24 + 256 x 240 <= 65536;
//   - the causal, length and segment masks are applied only to the tiles
//     that cross a warpgroup's diagonal, the ragged end of T or Tk, or a
//     segmented call; a tile that no key of the warpgroup can see skips its
//     products, and a warpgroup wholly past Tk computes nothing.
// p is exp(s * scale - lse) rounded as the plain version rounds it
// (bwd_p).  Descriptors are formed once and stepped by adding offsets
// (desc_add), which keeps a D-128 consumer inside its 240 registers.
// Measured (PERF.md; NVIDIA H100 80GB HBM3, 700 W): 0.456-0.463 ms at the
// Llama-3-8B training shape, 60-61 % of the 0.278 ms tensor-core bound.  What
// is left: a warpgroup runs its exp and ds between its own products (the
// two consumers overlap each other, not themselves).
// ptxas -v (CUDA 12.8, sm_90a): 168 registers a thread at launch (65,536 /
// 384, before setmaxnreg) at D 128 and D 64, no spills; dynamic shared
// memory 167,224 / 85,304 bytes a block at D 128 / D 64
// (sofa_flash_bwd_kv_smem_bytes), so one block per SM.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BLOCK_N = 128;            // keys per block
constexpr int BLOCK_M = 64;             // queries per Q/dO tile
constexpr int WG_KEYS = 64;             // keys per consumer warpgroup
constexpr int CONSUMERS = BLOCK_N / WG_KEYS;
constexpr int KV_THREADS = (CONSUMERS + 1) * 128;   // + the producer
// The ring depth is the one tile constant a build may set
// (-DFLASH_STAGES=N, tools/tune_flash.py); BLOCK_M and BLOCK_N fix the
// warpgroup and wgmma layouts.
#ifndef FLASH_STAGES
#define FLASH_STAGES 3
#endif
constexpr int STAGES = FLASH_STAGES;   // Q/dO ring depth
constexpr int PANEL_COLS = 64;          // bf16 columns of a 128-byte panel
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

// Shared memory of one block, from a 1024-byte aligned base: K then V (D / 64
// panels of BLOCK_N rows each), per stage Q then dO (D / 64 panels of BLOCK_M
// rows each), per stage the aux rows (lse clamped at M_FLOOR, delta, segment
// ids: BLOCK_M each), then the barriers kv_full, full[STAGES], empty[STAGES].
template <int D>
struct Smem {
  static constexpr int PANELS = D / PANEL_COLS;
  static constexpr int KV_PANEL = BLOCK_N * 128;
  static constexpr int QS_PANEL = BLOCK_M * 128;
  static constexpr int KV_BYTES = PANELS * KV_PANEL;     // K or V
  static constexpr int QS_BYTES = PANELS * QS_PANEL;     // one Q or dO tile
  static constexpr int STAGE_BYTES = 2 * QS_BYTES;
  static constexpr int RING = 2 * KV_BYTES;
  static constexpr int AUX = RING + STAGES * STAGE_BYTES;
  static constexpr int AUX_BYTES = 3 * BLOCK_M * 4;
  static constexpr int BARS = AUX + STAGES * AUX_BYTES;
  static constexpr int N_BARS = 1 + 2 * STAGES;
  // + 1024 so the base can be rounded up to the swizzle's alignment
  static constexpr int BYTES = BARS + N_BARS * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(KV_THREADS, 1) sofa_flash_bwd_kv_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ seg_q, const int* __restrict__ seg_k,
    void* __restrict__ dk, void* __restrict__ dv, bool out_f32, int T, int Tk,
    int H, int KVH, long long shift, float scale) {
  using S = Smem<D>;
  constexpr int KS = D / 16;            // k16 steps of s^T and dp^T
  constexpr int NS = BLOCK_M / 8;       // 8-query column groups of s^T
  constexpr int KP = BLOCK_M / 16;      // k16 steps of dV and dK
  constexpr int NO = D / 8;             // 8-column groups of dK / dV

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const base_ptr = smem_raw + (base - raw);
  const uint32_t k_s = base, v_s = base + S::KV_BYTES;
  const uint32_t bar = base + S::BARS;
  const uint32_t kv_full = bar;
  auto q_s = [&](int st) { return base + S::RING + st * S::STAGE_BYTES; };
  auto do_s = [&](int st) { return q_s(st) + S::QS_BYTES; };
  auto aux = [&](int st) {
    return reinterpret_cast<float*>(base_ptr + S::AUX + st * S::AUX_BYTES);
  };
  auto full = [&](int st) { return bar + 8 * (1 + st); };
  auto empty = [&](int st) { return bar + 8 * (1 + STAGES + st); };

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int b = blockIdx.x / KVH, kvh = blockIdx.x % KVH;
  const int group = H / KVH;
  const int k0 = blockIdx.y * BLOCK_N;
  const bool segmented = seg_q != nullptr;

  // The walk: for each query head of the group, the q-tiles from the first
  // whose last row can see this block's first key (iq * 64 + 63 + shift >=
  // k0) to the end.
  const int n_q = (T + BLOCK_M - 1) / BLOCK_M;
  const long long need = static_cast<long long>(k0) - shift - (BLOCK_M - 1);
  const long long first = need <= 0 ? 0 : (need + BLOCK_M - 1) / BLOCK_M;
  const int iq0 = first < n_q ? static_cast<int>(first) : n_q;
  const int per_head = n_q - iq0;
  const int n_walk = group * per_head;

  if (tid == 0) {
    mbar_init(kv_full, 1);
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
    if (tid % 128 < 32 && n_walk > 0) {
      if (lane == 0) {
        tma_prefetch_map(&q_map);
        tma_prefetch_map(&do_map);
        mbar_arrive_expect_tx(kv_full, 2 * S::KV_BYTES);
        for (int p = 0; p < S::PANELS; ++p) {
          tma_load_4d(k_s + p * S::KV_PANEL, &k_map, kv_full, p * PANEL_COLS,
                      kvh, k0, b);
          tma_load_4d(v_s + p * S::KV_PANEL, &v_map, kv_full, p * PANEL_COLS,
                      kvh, k0, b);
        }
      }
      for (int j = 0; j < n_walk; ++j) {
        const int st = j % STAGES;
        const int hh = j / per_head;
        const int h = kvh * group + hh;
        const int q0 = (iq0 + j - hh * per_head) * BLOCK_M;
        if (j >= STAGES) mbar_wait(empty(st), ((j / STAGES) + 1) & 1);
        float* a = aux(st);
        const long long row = (static_cast<long long>(b) * H + h) * T;
        for (int i = lane; i < BLOCK_M; i += 32) {
          const int query = q0 + i;
          const bool in = query < T;      // past T: masked, never read
          a[i] = in ? fmaxf(lse[row + query], M_FLOOR) : 0.f;
          a[BLOCK_M + i] = in ? delta[row + query] : 0.f;
          if (segmented) {
            reinterpret_cast<int*>(a)[2 * BLOCK_M + i] =
                in ? seg_q[static_cast<long long>(b) * T + query] : 0;
          }
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(full(st), S::STAGE_BYTES);
          for (int p = 0; p < S::PANELS; ++p) {
            tma_load_4d(q_s(st) + p * S::QS_PANEL, &q_map, full(st),
                        p * PANEL_COLS, h, q0, b);
            tma_load_4d(do_s(st) + p * S::QS_PANEL, &do_map, full(st),
                        p * PANEL_COLS, h, q0, b);
          }
        } else {
          mbar_arrive(full(st));
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns keys [kw, kw + 64) ----
    setmaxnreg_inc<CONSUMER_REGS>();
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;   // accumulator row group / col pair
    const int kw = k0 + wg * WG_KEYS;
    const int key0 = kw + warp * 16 + g, key1 = key0 + 8;
    const bool dead = kw >= Tk;             // every key past Tk
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
    float s[NS][4], dp[NS][4];
    uint32_t pa[KP][4], da[KP][4];
    // K and V rows of this warpgroup: rows [wg * 64, wg * 64 + 64) of each
    // panel (8 KB in, a multiple of the swizzle's 1024 bytes).
    const uint32_t k_wg = k_s + wg * WG_KEYS * 128;
    const uint32_t v_wg = v_s + wg * WG_KEYS * 128;
    // Descriptors of this warpgroup's K and V rows and of stage 0's Q (K-major
    // and transposed); a k16 step or another stage adds its offset (desc_add)
    const uint64_t desc_k = desc_sw128(k_wg, 16, SW128_SBO);
    const uint64_t desc_v = desc_sw128(v_wg, 16, SW128_SBO);
    const uint64_t desc_q = desc_sw128(q_s(0), 16, SW128_SBO);
    const uint64_t tdesc_q = desc_sw128(q_s(0), S::QS_PANEL, SW128_SBO);
    if (n_walk > 0) mbar_wait(kv_full, 0);

    for (int j = 0; j < n_walk; ++j) {
      const int st = j % STAGES;
      const int hh = j / per_head;
      const int q0 = (iq0 + j - hh * per_head) * BLOCK_M;
      mbar_wait(full(st), (j / STAGES) & 1);
      // no key of this warpgroup is visible to any query of the tile
      const bool blind =
          dead || kw > static_cast<long long>(q0) + BLOCK_M - 1 + shift;
      if (!blind) {
        // s^T = K Q^T and dp^T = V dO^T, issued together
        wgmma_fence();
        const uint64_t desc_q_st = desc_add(desc_q, st * S::STAGE_BYTES);
        const uint64_t desc_do_st = desc_add(desc_q_st, S::QS_BYTES);
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int off_a = (ks / 4) * S::KV_PANEL + (ks % 4) * 32;
          const int off_b = (ks / 4) * S::QS_PANEL + (ks % 4) * 32;
          wgmma_ss<BLOCK_M, 0>(s, desc_add(desc_k, off_a),
                               desc_add(desc_q_st, off_b), ks > 0);
        }
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int off_a = (ks / 4) * S::KV_PANEL + (ks % 4) * 32;
          const int off_b = (ks / 4) * S::QS_PANEL + (ks % 4) * 32;
          wgmma_ss<BLOCK_M, 0>(dp, desc_add(desc_v, off_a),
                               desc_add(desc_do_st, off_b), ks > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(s);
        fence_operands(dp);

        // p^T = exp(s^T * scale - lse) in place of s^T, exactly 0 where
        // masked; columns are queries 8n + 2t + {0, 1}.
        const float* a = aux(st);
        const int* segq = reinterpret_cast<const int*>(a) + 2 * BLOCK_M;
        const bool need_mask =
            segmented || q0 + BLOCK_M > T || kw + WG_KEYS > Tk ||
            static_cast<long long>(kw) + WG_KEYS - 1 > q0 + shift;
        if (need_mask) {
#pragma unroll
          for (int n = 0; n < NS; ++n) {
            const float2 l2 =
                *reinterpret_cast<const float2*>(a + n * 8 + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int jj = n * 8 + 2 * t + (e & 1);
              const int query = q0 + jj;
              const int key = e < 2 ? key0 : key1;
              bool masked = query >= T || key >= Tk ||
                            key > static_cast<long long>(query) + shift;
              if (segmented && !masked) {
                masked = segq[jj] != (e < 2 ? sk0 : sk1);
              }
              s[n][e] = masked ? 0.f
                               : bwd_p(s[n][e], scale, (e & 1) ? l2.y : l2.x);
            }
          }
        } else {
#pragma unroll
          for (int n = 0; n < NS; ++n) {
            const float2 l2 =
                *reinterpret_cast<const float2*>(a + n * 8 + 2 * t);
            s[n][0] = bwd_p(s[n][0], scale, l2.x);
            s[n][1] = bwd_p(s[n][1], scale, l2.y);
            s[n][2] = bwd_p(s[n][2], scale, l2.x);
            s[n][3] = bwd_p(s[n][3], scale, l2.y);
          }
        }
        // ds^T = p^T (dp^T - delta); p^T and ds^T packed to bf16 as the
        // register A operands (s^T and dp^T die as they are packed, which
        // keeps a D-128 thread inside its 240 registers)
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const float2 dl =
              *reinterpret_cast<const float2*>(a + BLOCK_M + n * 8 + 2 * t);
          dp[n][0] = s[n][0] * (dp[n][0] - dl.x);
          dp[n][1] = s[n][1] * (dp[n][1] - dl.y);
          dp[n][2] = s[n][2] * (dp[n][2] - dl.x);
          dp[n][3] = s[n][3] * (dp[n][3] - dl.y);
          pa[n / 2][(n % 2) * 2] = pack_f32(s[n][0], s[n][1]);
          pa[n / 2][(n % 2) * 2 + 1] = pack_f32(s[n][2], s[n][3]);
          da[n / 2][(n % 2) * 2] = pack_f32(dp[n][0], dp[n][1]);
          da[n / 2][(n % 2) * 2 + 1] = pack_f32(dp[n][2], dp[n][3]);
        }
        // dV += bf16(p^T) dO and dK += bf16(ds^T) Q, issued together
        const uint64_t tdesc_q_st = desc_add(tdesc_q, st * S::STAGE_BYTES);
        const uint64_t tdesc_do_st = desc_add(tdesc_q_st, S::QS_BYTES);
        fence_operands(dv_acc);
        fence_operands(dk_acc);
        fence_operands(pa);
        fence_operands(da);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KP; ++kk) {
          wgmma_rs<D, 1>(dv_acc, pa[kk], desc_add(tdesc_do_st, kk * 16 * 128),
                         1);
        }
#pragma unroll
        for (int kk = 0; kk < KP; ++kk) {
          wgmma_rs<D, 1>(dk_acc, da[kk], desc_add(tdesc_q_st, kk * 16 * 128),
                         1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(dv_acc);
        fence_operands(dk_acc);
        fence_operands(pa);
        fence_operands(da);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }

    const long long kv_stride = static_cast<long long>(KVH) * D;
    const long long kv_off = static_cast<long long>(b) * Tk * kv_stride +
                             static_cast<long long>(kvh) * D;
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
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   const int* seg_q, const int* seg_k, void* dk, void* dv,
                   bool out_f32, int B, int T, int Tk, int H, int KVH,
                   long long shift, float scale, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map, do_map;
  cudaError_t err = encode_heads(&q_map, q, D, H, T, B, BLOCK_M);
  if (err == cudaSuccess) {
    err = encode_heads(&do_map, dout, D, H, T, B, BLOCK_M);
  }
  if (err == cudaSuccess) err = encode_heads(&k_map, k, D, KVH, Tk, B, BLOCK_N);
  if (err == cudaSuccess) err = encode_heads(&v_map, v, D, KVH, Tk, B, BLOCK_N);
  if (err != cudaSuccess) return err;
  const int smem = Smem<D>::BYTES;
  err = allow_smem(sofa_flash_bwd_kv_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * KVH, (Tk + BLOCK_N - 1) / BLOCK_N);
  sofa_flash_bwd_kv_kernel<D><<<grid, KV_THREADS, smem, stream>>>(
      q_map, k_map, v_map, do_map, lse, delta, seg_q, seg_k, dk, dv, out_f32,
      T, Tk, H, KVH, shift, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  q, dout [B,T,H,D] and k, v
// [B,Tk,KVH,D] contiguous bf16, 16-byte aligned; lse, delta [B,H,T] f32;
// seg_q [B,T] / seg_k [B,Tk] int32 or both null; dk, dv [B,Tk,KVH,D] in f32
// when out_f32 is nonzero, else bf16, allocated by the caller.  Launches on
// `stream` without synchronizing and returns cudaGetLastError()
// (cudaErrorInvalidValue when a tensor map cannot be encoded).
extern "C" int sofa_flash_bwd_kv(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, const int* seg_q,
                                 const int* seg_k, void* dk, void* dv,
                                 int out_f32, int B, int T, int Tk, int H,
                                 int KVH, int D, long long shift, float scale,
                                 void* stream) {
  if (B <= 0 || T <= 0 || Tk <= 0 || KVH <= 0 || H % KVH != 0 ||
      (Tk + BLOCK_N - 1) / BLOCK_N > 65535) {
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
  return d == 64 ? Smem<64>::BYTES : d == 128 ? Smem<128>::BYTES : 0;
}
