// K3 and K4: flash-attention backward. K3 computes dK and dV, K4 computes dQ.
//
// Replaces: ray_tpu/ops/attention.py:_flash_bwd_dkv_kernel (:208, launched at
// :345) and _flash_bwd_dq_kernel (:265, launched at :371), the backward of
// every training step's attention. Inputs are the forward's q, k, v and
// per-row lse (K2, flash_fwd.cu), the output gradient dO, and
// delta = rowsum(dO * O) in f32, which the host wrapper computes with torch
// ops as the JAX package computes it in XLA (:342).
//
// Contract (the JAX kernels'):
//   - bf16 operands with f32 accumulation (K3: wgmma m64nNk16, K4:
//     mma.sync m16n8k16, bf16 -> f32); f32 operands stay f32 on plain FMA
//     (TF32 would break the 2e-4 bound);
//   - s = scale * (q . k) in f32; P = exp(s - lse), forced to 0 where masked:
//     queries at or past seq_q, keys at or past seq_k, and keys above the
//     diagonal when causal (q_pos >= k_pos, top-left aligned);
//   - P is cast to dO's dtype before dV += P^T dO;
//   - dP = dO V^T; dS = P * (dP - delta) * scale, cast to the input dtype
//     before dK += dS^T Q and dQ += dS K;
//   - GQA: query head h reads kv head h / (H / Hkv); dK and dV of a kv head
//     are the sum over its query heads (:394-395), taken here in f32
//     registers before the one cast and store (JAX sums bf16 copies after
//     the kernel: the two differ by rounding only).
//
// What bounds them on this card: at the GPT-2-small training shape (B=32,
// T=1024, H=12, D=64, causal, bf16) K3 runs four products over the causal
// half of the [T, T] pairs (S^T, dP^T, dV, dK; 103 GFLOP, 0.104 ms at
// 989 TFLOP/s) and moves q, k, v, dO, dK, dV once (302 MB, 0.090 ms at
// 3.35 TB/s); K4 runs three products (77 GFLOP, 0.078 ms) and moves q, k,
// v, dO, dQ (252 MB, 0.075 ms). Both sit near the ridge, so both keep every
// [Tq, Tk] tile (S, P, dP, dS) in registers and read each operand tile
// from device memory once per block.
//
// K3 (bf16) is built for Hopper (sm_90a):
//   - one block per (128-key tile, batch * kv head): two consumer
//     warpgroups of 64 keys each and one producer warp (at D=128 one
//     warpgroup and 64 keys, for registers). K and V are loaded
//     once by TMA; the Q and dO tiles of every query head of the kv head
//     stream through a ring of kStages shared-memory stages guarded by
//     full/empty mbarriers, from the causal start on (TMA, zero rows past
//     seq_q). lse and delta of each tile are plain loads by the producer
//     warp into the same stage (a tensor map over [B*H, Tq] f32 would need
//     Tq a multiple of 4);
//   - four wgmma products per query tile: S^T = K Q^T and dP^T = V dO^T
//     with both operands in shared memory (K-major), then dV += P^T dO and
//     dK += dS^T Q with P^T and dS^T packed from those accumulators into
//     register A operands and dO, Q read MN-major (transpose bit);
//   - the mask only on tiles that cross the diagonal or a ragged end, and
//     none of the work for query tiles wholly before a warpgroup's keys;
//   - blocks run kv-head group by group, each group small enough that its
//     Q/dO stay in L2 while all its key tiles stream them; within a group
//     key tile 0, whose causal walk is longest, starts first.
// K4 (bf16) holds Q/dO fragments in registers and streams K/V tiles up to
// the causal limit with mma.sync, synchronous copies and no pipeline.
//
// Layout: tensors are [B, T, heads, D] with the last dim contiguous, other
// strides (elements) are arguments; lse and delta are [B, H, Tq] f32,
// contiguous. K3 runs one block per (key tile, batch * kv head), K4 one per
// (query tile, batch * head). The host wrapper (ops/attention.py) checks
// dtypes, shapes, strides and alignment before it calls in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int B, Tq, Tk, H, Hkv;
  long long sqb, sqt, sqh;
  long long skb, skt, skh;
  long long svb, svt, svh;
  long long sdob, sdot, sdoh;
  long long sgb, sgt, sgh;  // strides of dq (K4) or of dk and dv (K3)
  int causal;
  float scale;
  int head_group;  // K3 bf16: kv heads whose blocks run together (l2_head_group)
};

constexpr int kThreads = 128;  // 4 warps

// ------------------------------------------------------------ bf16: mma.sync

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copies rows [r0, r0 + rows) of one head of a [B, T, heads, D] tensor into
// a [rows][D + 8] shared tile, 16 bytes a thread; rows past `limit` are
// zeros, so masked (zero) probabilities never meet uninitialised values.
template <int D>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst, int rows,
                                               const __nv_bfloat16* base,
                                               long long row_stride, int r0,
                                               int limit) {
  constexpr int kVecPerRow = D / 8;
  for (int idx = threadIdx.x; idx < rows * kVecPerRow; idx += kThreads) {
    const int r = idx / kVecPerRow;
    const int c = (idx % kVecPerRow) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < limit) {
      val = *reinterpret_cast<const uint4*>(base + (long long)(r0 + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = val;
  }
}

// ---------------------------------------------------- K3 bf16: wgmma, TMA ring

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStages = 2;  // Q/dO tiles in flight

template <int D>
struct DkvTiles {
  // Consumer warpgroups of 64 keys each. At D=128 dK and dV alone take 128
  // registers a thread: one warpgroup and a producer warp make a 160-thread
  // block, whose threads may take 255 registers (a 288-thread block's 168).
  static constexpr int kWG = D == 128 ? 1 : 2;
  static constexpr int kBK = 64 * kWG;            // keys a block
  static constexpr int kBQ = D == 128 ? 32 : 64;  // queries a streamed tile
  static constexpr int kCols = panel_cols(D);
  static constexpr int kPanels = D / kCols;
  static constexpr int kRowBytes = 2 * kCols;
  static constexpr int kKVBytes = kBK * D * 2;    // one of K, V
  static constexpr int kQBytes = kBQ * D * 2;     // one of Q, dO
  static constexpr int kThreads = 128 * kWG + 32;  // + the producer warp
  // K, V, kStages x (Q, dO), kStages x (lse, delta) rows, the barriers;
  // 1024 bytes of slack to align.
  static constexpr int kRowsOffset = 2 * kKVBytes + kStages * 2 * kQBytes;
  static constexpr size_t kSmem =
      1024 + kRowsOffset + kStages * 2 * kBQ * 4 + 8 * (2 * kStages + 1);
};

// K3, bf16. The scores are computed transposed, S^T = K Q^T, with the keys
// as the wgmma M dimension, so that the f32 accumulators of P^T and dS^T
// are, packed, the register A operands of dV += P^T dO and dK += dS^T Q:
// P and dS never leave registers. lse and delta are per query, i.e. per
// column here, and come from the stage's rows in shared memory.
template <int D>
__global__ void __launch_bounds__(DkvTiles<D>::kThreads, 1)
flash_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do, Params p) {
  using Tiles = DkvTiles<D>;
  constexpr int BQ = Tiles::kBQ, BK = Tiles::kBK, RB = Tiles::kRowBytes;
  constexpr int kCols = Tiles::kCols;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t k_s = (raw + 1023u) & ~1023u;
  const uint32_t v_s = k_s + Tiles::kKVBytes;
  const uint32_t qd_s = v_s + Tiles::kKVBytes;  // stage s: Q, then dO
  float* lse_s = reinterpret_cast<float*>(smem_raw + (k_s - raw) + Tiles::kRowsOffset);
  float* delta_s = lse_s + kStages * BQ;        // both [kStages][BQ]
  const uint32_t bars = k_s + Tiles::kRowsOffset + kStages * 2 * BQ * 4;
  const uint32_t kv_bar = bars + 16 * kStages;
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (kStages + s); };

  // kv heads in L2-sized groups; in a group, key tile 0, whose causal walk
  // is longest, first.
  const HeadTile order = head_tile(blockIdx.x, (p.Tk + BK - 1) / BK, p.B * p.Hkv, p.head_group);
  const int b = order.head / p.Hkv;
  const int hkv = order.head % p.Hkv;
  const int k0 = order.tile * BK;
  const int rep = p.H / p.Hkv;
  const int n_q = (p.Tq + BQ - 1) / BQ;
  // Lowest query tile that can see this key tile: earlier ones are masked.
  const int first = p.causal ? min(k0 / BQ, n_q) : 0;
  const int per_head = n_q - first;
  const int n_iter = rep * per_head;  // (query head, query tile) pairs
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar(s), 32);  // every producer lane, after its rows
      mbar_init(empty_bar(s), 4 * Tiles::kWG);  // one arrival per consumer warp
    }
    mbar_init(kv_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * Tiles::kWG) {
    // Producer warp: lane 0 issues the TMA loads, every lane loads rows of
    // lse (in log2 units) and delta.
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_bar, 2 * Tiles::kKVBytes);
      for (int pn = 0; pn < Tiles::kPanels; ++pn) {
        tma_load(k_s + pn * BK * RB, &tm_k, kv_bar, pn * kCols, k0, hkv, b);
        tma_load(v_s + pn * BK * RB, &tm_v, kv_bar, pn * kCols, k0, hkv, b);
      }
    }
    for (int it = 0; it < n_iter; ++it) {
      const int h = hkv * rep + it / per_head;
      const int q0 = (first + it % per_head) * BQ;
      const int s = it % kStages;
      mbar_wait(empty_bar(s), ((it / kStages) & 1) ^ 1);
      const float* lse = p.lse + ((long long)b * p.H + h) * p.Tq;
      const float* delta = p.delta + ((long long)b * p.H + h) * p.Tq;
      for (int i = lane; i < BQ; i += 32) {
        const bool in = q0 + i < p.Tq;
        lse_s[s * BQ + i] = in ? lse[q0 + i] * kLog2e : 0.f;
        delta_s[s * BQ + i] = in ? delta[q0 + i] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(full_bar(s), 2 * Tiles::kQBytes);
        const uint32_t q_st = qd_s + 2 * s * Tiles::kQBytes;
        const uint32_t do_st = q_st + Tiles::kQBytes;
        for (int pn = 0; pn < Tiles::kPanels; ++pn) {
          tma_load(q_st + pn * BQ * RB, &tm_q, full_bar(s), pn * kCols, q0, h, b);
          tma_load(do_st + pn * BQ * RB, &tm_do, full_bar(s), pn * kCols, q0, h, b);
        }
      } else {
        mbar_arrive(full_bar(s));
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns keys [k0 + 64 wg, k0 + 64 wg + 64).
  const int wg = warp / 4;
  const int g = lane / 4;
  const int t = lane % 4;
  const int kw0 = k0 + 64 * wg;
  const int key0 = kw0 + 16 * (warp % 4) + g;  // this thread's keys: key0, key0 + 8
  const int key1 = key0 + 8;
  const float c = p.scale * kLog2e;  // scores -> log2 units
  const uint32_t k_wg = k_s + 64 * wg * RB;
  const uint32_t v_wg = v_s + 64 * wg * RB;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(kv_bar, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int q0 = (first + it % per_head) * BQ;
    const int s = it % kStages;
    mbar_wait(full_bar(s), (it / kStages) & 1);
    // A query tile wholly before this warpgroup's keys sees none of them.
    if (!(p.causal && q0 + BQ - 1 < kw0)) {
      const uint32_t q_st = qd_s + 2 * s * Tiles::kQBytes;
      const uint32_t do_st = q_st + Tiles::kQBytes;

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x BQ queries each.
      float st[BQ / 2], dpt[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const int pn = kc * 16 / kCols;                 // panel
        const uint32_t off = ((kc * 16) % kCols) * 2;   // bytes along the row
        wgmma_ss<BQ>(st, desc_kmajor(k_wg + pn * BK * RB + off, RB),
                     desc_kmajor(q_st + pn * BQ * RB + off, RB), kc);
      }
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const int pn = kc * 16 / kCols;
        const uint32_t off = ((kc * 16) % kCols) * 2;
        wgmma_ss<BQ>(dpt, desc_kmajor(v_wg + pn * BK * RB + off, RB),
                     desc_kmajor(do_st + pn * BQ * RB + off, RB), kc);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // P^T (into st) and dS^T (into dpt), element by element.
      const float* lse_t = lse_s + s * BQ;
      const float* delta_t = delta_s + s * BQ;
      const bool masked = q0 + BQ > p.Tq || kw0 + 64 > p.Tk || (p.causal && q0 < kw0 + 63);
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * i + 2 * t + (e & 1);
          float pr = exp2_fast(fmaf(st[4 * i + e], c, -lse_t[col]));
          if (masked) {
            const int query = q0 + col;
            const int key = e < 2 ? key0 : key1;
            if (query >= p.Tq || key >= p.Tk || (p.causal && query < key)) pr = 0.f;
          }
          st[4 * i + e] = pr;
          dpt[4 * i + e] = pr * (dpt[4 * i + e] - delta_t[col]) * p.scale;
        }
      }

      // dV += P^T dO and dK += dS^T Q, 16 queries a product.
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[kc][r] = pack_bf16(st[8 * kc + 2 * r], st[8 * kc + 2 * r + 1]);
          da[kc][r] = pack_bf16(dpt[8 * kc + 2 * r], dpt[8 * kc + 2 * r + 1]);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc) {
        wgmma_rs<D>(dv, pa[kc], desc_mnmajor(do_st + kc * 16 * RB, RB, BQ * RB));
      }
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc) {
        wgmma_rs<D>(dk, da[kc], desc_mnmajor(q_st + kc * 16 * RB, RB, BQ * RB));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
    }
    // This warp is done with the stage.
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar(s));
  }

  __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(p.dk) + b * p.sgb + hkv * p.sgh;
  __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(p.dv) + b * p.sgb + hkv * p.sgh;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = 8 * i + 2 * t;
    if (key0 < p.Tk) {
      *reinterpret_cast<uint32_t*>(dkp + key0 * p.sgt + col) = pack_bf16(dk[4 * i], dk[4 * i + 1]);
      *reinterpret_cast<uint32_t*>(dvp + key0 * p.sgt + col) = pack_bf16(dv[4 * i], dv[4 * i + 1]);
    }
    if (key1 < p.Tk) {
      *reinterpret_cast<uint32_t*>(dkp + key1 * p.sgt + col) =
          pack_bf16(dk[4 * i + 2], dk[4 * i + 3]);
      *reinterpret_cast<uint32_t*>(dvp + key1 * p.sgt + col) =
          pack_bf16(dv[4 * i + 2], dv[4 * i + 3]);
    }
  }
}

// K4, bf16. One block per (64-query tile, batch * head); warp w owns rows
// [q0 + 16w, q0 + 16w + 16), whose Q and dO fragments stay in registers for
// the whole key loop, as K1 keeps Q. S = Q K^T and dP = dO V^T per K/V tile;
// the accumulator of dS is the A fragment of dQ += dS K.
template <int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16_kernel(Params p) {
  constexpr int BQ = 64;
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + BK * LD;

  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int hkv = h / (p.H / p.Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.sqb + h * p.sqh;
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(p.dout) + b * p.sdob + h * p.sdoh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.skb + hkv * p.skh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.svb + hkv * p.svh;

  const int row0 = qt * BQ + warp * 16 + g;
  const int row1 = row0 + 8;
  const bool in0 = row0 < p.Tq, in1 = row1 < p.Tq;

  uint32_t qa[D / 16][4], da[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c0 = kc * 16 + 2 * t;
    const int c1 = c0 + 8;
    qa[kc][0] = in0 ? ld32(q + row0 * p.sqt + c0) : 0u;
    qa[kc][1] = in1 ? ld32(q + row1 * p.sqt + c0) : 0u;
    qa[kc][2] = in0 ? ld32(q + row0 * p.sqt + c1) : 0u;
    qa[kc][3] = in1 ? ld32(q + row1 * p.sqt + c1) : 0u;
    da[kc][0] = in0 ? ld32(dout + row0 * p.sdot + c0) : 0u;
    da[kc][1] = in1 ? ld32(dout + row1 * p.sdot + c0) : 0u;
    da[kc][2] = in0 ? ld32(dout + row0 * p.sdot + c1) : 0u;
    da[kc][3] = in1 ? ld32(dout + row1 * p.sdot + c1) : 0u;
  }
  const float* lse = p.lse + (long long)bh * p.Tq;
  const float* delta = p.delta + (long long)bh * p.Tq;
  const float lse0 = in0 ? lse[row0] : 0.f, lse1 = in1 ? lse[row1] : 0.f;
  const float del0 = in0 ? delta[row0] : 0.f, del1 = in1 ? delta[row1] : 0.f;

  float dq[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.f;

  int num_tiles = (p.Tk + BK - 1) / BK;
  if (p.causal) num_tiles = min(num_tiles, ((qt + 1) * BQ - 1) / BK + 1);

  for (int kt = 0; kt < num_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile_bf16<D>(Ks, BK, k, p.skt, k0, p.Tk);
    load_tile_bf16<D>(Vs, BK, v, p.svt, k0, p.Tk);
    __syncthreads();

    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const __nv_bfloat16* krow = Ks + (nt * 8 + g) * LD + kc * 16 + 2 * t;
        const __nv_bfloat16* vrow = Vs + (nt * 8 + g) * LD + kc * 16 + 2 * t;
        mma_bf16(s[nt], qa[kc], ld32(krow), ld32(krow + 8));
        mma_bf16(dp[nt], da[kc], ld32(vrow), ld32(vrow + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t + (e & 1);
        const int row = (e < 2) ? row0 : row1;
        bool keep = key < p.Tk;
        if (p.causal) keep = keep && (row >= key);
        const float pr = keep ? expf(p.scale * s[nt][e] - (e < 2 ? lse0 : lse1)) : 0.f;
        dp[nt][e] = pr * (dp[nt][e] - (e < 2 ? del0 : del1)) * p.scale;
      }
    }
    // dQ += dS K; K's B fragment (keys x D) from 16-bit loads.
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t sa[4];
      sa[0] = pack_bf16(dp[2 * kc][0], dp[2 * kc][1]);
      sa[1] = pack_bf16(dp[2 * kc][2], dp[2 * kc][3]);
      sa[2] = pack_bf16(dp[2 * kc + 1][0], dp[2 * kc + 1][1]);
      sa[3] = pack_bf16(dp[2 * kc + 1][2], dp[2 * kc + 1][3]);
      const int r = kc * 16 + 2 * t;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const int col = dt * 8 + g;
        mma_bf16(dq[dt], sa,
                 pack_bf16_raw(Ks[r * LD + col], Ks[(r + 1) * LD + col]),
                 pack_bf16_raw(Ks[(r + 8) * LD + col], Ks[(r + 9) * LD + col]));
      }
    }
  }

  __nv_bfloat16* dqp = static_cast<__nv_bfloat16*>(p.dq) + b * p.sgb + h * p.sgh;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (in0) *reinterpret_cast<uint32_t*>(dqp + row0 * p.sgt + col) = pack_bf16(dq[dt][0], dq[dt][1]);
    if (in1) *reinterpret_cast<uint32_t*>(dqp + row1 * p.sgt + col) = pack_bf16(dq[dt][2], dq[dt][3]);
  }
}

// ------------------------------------------------------------- f32: FMA
//
// Four threads share a row (a key row in K3, a query row in K4): each owns
// dims j, j + 4, ... of the row's accumulators and a quarter of the scores
// of each streamed tile; a row's scores reach its four threads by shuffle.

constexpr int kFRows = 32;  // rows a block owns
constexpr int kFTile = 16;  // rows of each streamed tile

__device__ __forceinline__ float quad_get(float x_of_owner, int col) {
  return __shfl_sync(0xffffffffu, x_of_owner, ((threadIdx.x % 32) & ~3) | (col % 4));
}

template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, int rows, const float* base,
                                              long long row_stride, int r0, int limit) {
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    dst[r * (D + 1) + c] = r0 + r < limit ? base[(long long)(r0 + r) * row_stride + c] : 0.f;
  }
}

template <int D>
__device__ __forceinline__ float dot_f32(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll 16
  for (int c = 0; c < D; ++c) acc = fmaf(a[c], b[c], acc);
  return acc;
}

// K3, f32: one block per (32-key tile, batch * kv head), 16-query tiles.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(Params p) {
  constexpr int LD = D + 1;  // +1 float a row keeps strided reads on distinct banks
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + kFRows * LD;
  float* Qs = Vs + kFRows * LD;
  float* dOs = Qs + kFTile * LD;
  float* lse_s = dOs + kFTile * LD;
  float* delta_s = lse_s + kFTile;

  const int b = blockIdx.y / p.Hkv;
  const int hkv = blockIdx.y % p.Hkv;
  const int rep = p.H / p.Hkv;
  const int r = threadIdx.x / 4;
  const int j = threadIdx.x % 4;
  const int k0 = blockIdx.x * kFRows;
  const int key = k0 + r;

  load_tile_f32<D>(Ks, kFRows, static_cast<const float*>(p.k) + b * p.skb + hkv * p.skh,
                   p.skt, k0, p.Tk);
  load_tile_f32<D>(Vs, kFRows, static_cast<const float*>(p.v) + b * p.svb + hkv * p.svh,
                   p.svt, k0, p.Tk);

  float dk[D / 4], dv[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) dk[i] = dv[i] = 0.f;

  const int num_q_tiles = (p.Tq + kFTile - 1) / kFTile;
  const int first = p.causal ? k0 / kFTile : 0;
  for (int h = hkv * rep; h < (hkv + 1) * rep; ++h) {
    const float* q = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh;
    const float* dout = static_cast<const float*>(p.dout) + b * p.sdob + h * p.sdoh;
    const float* lse = p.lse + ((long long)b * p.H + h) * p.Tq;
    const float* delta = p.delta + ((long long)b * p.H + h) * p.Tq;
    for (int qt = first; qt < num_q_tiles; ++qt) {
      const int q0 = qt * kFTile;
      __syncthreads();
      load_tile_f32<D>(Qs, kFTile, q, p.sqt, q0, p.Tq);
      load_tile_f32<D>(dOs, kFTile, dout, p.sdot, q0, p.Tq);
      for (int i = threadIdx.x; i < kFTile; i += kThreads) {
        const bool in = q0 + i < p.Tq;
        lse_s[i] = in ? lse[q0 + i] : 0.f;
        delta_s[i] = in ? delta[q0 + i] : 0.f;
      }
      __syncthreads();

      // This thread's queries of the tile: j, j + 4, j + 8, j + 12.
      float pr[kFTile / 4], ds[kFTile / 4];
#pragma unroll
      for (int i = 0; i < kFTile / 4; ++i) {
        const int c = j + 4 * i;
        const int query = q0 + c;
        bool keep = query < p.Tq && key < p.Tk;
        if (p.causal) keep = keep && (query >= key);
        const float s = dot_f32<D>(Ks + r * LD, Qs + c * LD);
        const float dpv = dot_f32<D>(Vs + r * LD, dOs + c * LD);
        pr[i] = keep ? expf(p.scale * s - lse_s[c]) : 0.f;
        ds[i] = pr[i] * (dpv - delta_s[c]) * p.scale;
      }
#pragma unroll
      for (int c = 0; c < kFTile; ++c) {
        const float pc = quad_get(pr[c / 4], c);
        const float dc = quad_get(ds[c / 4], c);
#pragma unroll
        for (int i = 0; i < D / 4; ++i) {
          dv[i] = fmaf(pc, dOs[c * LD + j + 4 * i], dv[i]);
          dk[i] = fmaf(dc, Qs[c * LD + j + 4 * i], dk[i]);
        }
      }
    }
  }
  if (key < p.Tk) {
    float* dkp = static_cast<float*>(p.dk) + b * p.sgb + hkv * p.sgh + key * p.sgt;
    float* dvp = static_cast<float*>(p.dv) + b * p.sgb + hkv * p.sgh + key * p.sgt;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      dkp[j + 4 * i] = dk[i];
      dvp[j + 4 * i] = dv[i];
    }
  }
}

// K4, f32: one block per (32-query tile, batch * head), 16-key tiles.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(Params p) {
  constexpr int LD = D + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + kFRows * LD;
  float* Ks = dOs + kFRows * LD;
  float* Vs = Ks + kFTile * LD;

  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int hkv = h / (p.H / p.Hkv);
  const int r = threadIdx.x / 4;
  const int j = threadIdx.x % 4;
  const int q0 = qt * kFRows;
  const int row = q0 + r;
  const float* k = static_cast<const float*>(p.k) + b * p.skb + hkv * p.skh;
  const float* v = static_cast<const float*>(p.v) + b * p.svb + hkv * p.svh;

  load_tile_f32<D>(Qs, kFRows, static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh,
                   p.sqt, q0, p.Tq);
  load_tile_f32<D>(dOs, kFRows, static_cast<const float*>(p.dout) + b * p.sdob + h * p.sdoh,
                   p.sdot, q0, p.Tq);
  const float lse = row < p.Tq ? p.lse[(long long)bh * p.Tq + row] : 0.f;
  const float delta = row < p.Tq ? p.delta[(long long)bh * p.Tq + row] : 0.f;

  float dq[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) dq[i] = 0.f;

  int num_tiles = (p.Tk + kFTile - 1) / kFTile;
  if (p.causal) num_tiles = min(num_tiles, (q0 + kFRows - 1) / kFTile + 1);
  for (int kt = 0; kt < num_tiles; ++kt) {
    const int k0 = kt * kFTile;
    __syncthreads();
    load_tile_f32<D>(Ks, kFTile, k, p.skt, k0, p.Tk);
    load_tile_f32<D>(Vs, kFTile, v, p.svt, k0, p.Tk);
    __syncthreads();

    float ds[kFTile / 4];
#pragma unroll
    for (int i = 0; i < kFTile / 4; ++i) {
      const int c = j + 4 * i;
      const int key = k0 + c;
      bool keep = key < p.Tk;
      if (p.causal) keep = keep && (row >= key);
      const float s = dot_f32<D>(Qs + r * LD, Ks + c * LD);
      const float dpv = dot_f32<D>(dOs + r * LD, Vs + c * LD);
      const float pr = keep ? expf(p.scale * s - lse) : 0.f;
      ds[i] = pr * (dpv - delta) * p.scale;
    }
#pragma unroll
    for (int c = 0; c < kFTile; ++c) {
      const float dc = quad_get(ds[c / 4], c);
#pragma unroll
      for (int i = 0; i < D / 4; ++i) dq[i] = fmaf(dc, Ks[c * LD + j + 4 * i], dq[i]);
    }
  }
  if (row < p.Tq) {
    float* dqp = static_cast<float*>(p.dq) + b * p.sgb + h * p.sgh + row * p.sgt;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) dqp[j + 4 * i] = dq[i];
  }
}

// ------------------------------------------------------------- launches

// Launches `kernel` with `smem` bytes of dynamic shared memory, raising the
// kernel's limit first where it asks for more than the default 48 KB.
template <typename Kernel>
cudaError_t launch_with_smem(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                             const Params& p) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_bf16(Params p, cudaStream_t stream) {
  using Tiles = DkvTiles<D>;
  const int rep = p.H / p.Hkv;
  p.head_group = l2_head_group(4LL * D * (p.Tk + rep * p.Tq) + 8LL * rep * p.Tq, p.B * p.Hkv);
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = make_panel_map(&tq, p.q, p.B, p.Tq, p.H, D, p.sqb, p.sqt, p.sqh, Tiles::kBQ);
  if (err == cudaSuccess) {
    err = make_panel_map(&tk, p.k, p.B, p.Tk, p.Hkv, D, p.skb, p.skt, p.skh, Tiles::kBK);
  }
  if (err == cudaSuccess) {
    err = make_panel_map(&tv, p.v, p.B, p.Tk, p.Hkv, D, p.svb, p.svt, p.svh, Tiles::kBK);
  }
  if (err == cudaSuccess) {
    err = make_panel_map(&tdo, p.dout, p.B, p.Tq, p.H, D, p.sdob, p.sdot, p.sdoh, Tiles::kBQ);
  }
  auto kernel = flash_bwd_dkv_bf16_kernel<D>;
  static bool smem_set = false;
  if (err == cudaSuccess) err = allow_smem(kernel, Tiles::kSmem, &smem_set);
  if (err != cudaSuccess) return err;
  const int blocks = (p.Tk + Tiles::kBK - 1) / Tiles::kBK * p.B * p.Hkv;
  kernel<<<blocks, Tiles::kThreads, Tiles::kSmem, stream>>>(tq, tk, tv, tdo, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Params& p, int dtype, cudaStream_t stream) {
  if (dtype == 1) return launch_dkv_bf16<D>(p, stream);
  const size_t smem = ((2 * kFRows + 2 * kFTile) * (D + 1) + 2 * kFTile) * sizeof(float);
  dim3 grid((p.Tk + kFRows - 1) / kFRows, p.B * p.Hkv);
  return launch_with_smem(flash_bwd_dkv_f32_kernel<D>, grid, smem, stream, p);
}

template <int D>
cudaError_t launch_dq(const Params& p, int dtype, cudaStream_t stream) {
  if (dtype == 1) {
    constexpr int BK = D == 128 ? 32 : 64;
    const size_t smem = 2 * BK * (D + 8) * sizeof(__nv_bfloat16);
    dim3 grid((p.Tq + 63) / 64, p.B * p.H);
    return launch_with_smem(flash_bwd_dq_bf16_kernel<D, BK>, grid, smem, stream, p);
  }
  const size_t smem = (2 * kFRows + 2 * kFTile) * (D + 1) * sizeof(float);
  dim3 grid((p.Tq + kFRows - 1) / kFRows, p.B * p.H);
  return launch_with_smem(flash_bwd_dq_f32_kernel<D>, grid, smem, stream, p);
}

bool bad_args(int B, int Tq, int Tk, int H, int Hkv, int dtype) {
  return B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
         (dtype != 0 && dtype != 1);
}

}  // namespace

extern "C" {

// Launch K3 (dK, dV) or K4 (dQ) on `stream`; each returns the launch's
// cudaError_t (0 = queued). dtype: 0 = float32, 1 = bfloat16. Strides are in
// elements; the g* strides are those of the outputs (dk and dv share them).
int rt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* dk, void* dv,
                     int B, int Tq, int Tk, int H, int Hkv, int D,
                     long long sqb, long long sqt, long long sqh,
                     long long skb, long long skt, long long skh,
                     long long svb, long long svt, long long svh,
                     long long sdob, long long sdot, long long sdoh,
                     long long sgb, long long sgt, long long sgh,
                     int causal, float scale, int dtype, void* stream) {
  if (bad_args(B, Tq, Tk, H, Hkv, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, dout, lse, delta, nullptr, dk, dv, B, Tq, Tk, H, Hkv,
           sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sdob, sdot, sdoh,
           sgb, sgt, sgh, causal, scale, 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return static_cast<int>(launch_dkv<16>(p, dtype, s));
    case 32: return static_cast<int>(launch_dkv<32>(p, dtype, s));
    case 64: return static_cast<int>(launch_dkv<64>(p, dtype, s));
    case 128: return static_cast<int>(launch_dkv<128>(p, dtype, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int rt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dq,
                    int B, int Tq, int Tk, int H, int Hkv, int D,
                    long long sqb, long long sqt, long long sqh,
                    long long skb, long long skt, long long skh,
                    long long svb, long long svt, long long svh,
                    long long sdob, long long sdot, long long sdoh,
                    long long sgb, long long sgt, long long sgh,
                    int causal, float scale, int dtype, void* stream) {
  if (bad_args(B, Tq, Tk, H, Hkv, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, Tq, Tk, H, Hkv,
           sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sdob, sdot, sdoh,
           sgb, sgt, sgh, causal, scale, 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return static_cast<int>(launch_dq<16>(p, dtype, s));
    case 32: return static_cast<int>(launch_dq<32>(p, dtype, s));
    case 64: return static_cast<int>(launch_dq<64>(p, dtype, s));
    case 128: return static_cast<int>(launch_dq<128>(p, dtype, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* rt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
