// K3 and K4: flash-attention backward. K4 computes dQ and delta, K3 dK and dV.
//
// Replaces: ray_tpu/ops/attention.py:_flash_bwd_dq_kernel (:265, launched at
// :371) and _flash_bwd_dkv_kernel (:208, launched at :345), the backward of
// every training step's attention. Inputs are the forward's q, k, v, out and
// per-row lse (K2, flash_fwd.cu) and the output gradient dO. The JAX package
// computes delta = rowsum(dO * O) in XLA before its kernels (:342); here K4
// computes it for its own query rows and writes it out ([B, H, Tq] f32), so
// the host wrapper (ops/attention.py) launches K4 first and K3, which reads
// that delta, second, on one stream.
//
// Contract (the JAX kernels'):
//   - bf16 operands with f32 accumulation (wgmma m64nNk16 bf16 -> f32); f32
//     operands stay f32 on plain FMA (TF32 would break the 2e-4 bound);
//   - delta = sum over D of dO * O in f32;
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
// 989 TFLOP/s) and moves q, k, v, dO, dK, dV, lse and delta once (305 MB,
// 0.091 ms at 3.35 TB/s); K4 runs three products (77 GFLOP, 0.078 ms) and
// moves q, dO, O, dQ, k, v, lse and delta (305 MB, 0.091 ms). Both sit near
// the ridge, so both keep every [Tq, Tk] tile (S, P, dP, dS) in registers
// and read each operand tile from device memory once per block.
//
// Both bf16 kernels are built for Hopper (sm_90a) from the helpers of
// hopper.cuh: TMA loads through shared-memory rings guarded by full/empty
// mbarriers (zero rows past the end), wgmma products, the mask only on
// tiles that cross the diagonal or a ragged end, and blocks that run head
// group by head group, each group small enough that the operands its
// blocks share stay in L2, the longest causal walk first within a group.
//
// K4 (bf16), the shape of the forward kernel (flash_fwd.cu):
//   - one block per (64-query tile, batch * head): one consumer warpgroup
//     and one producer warp, at 120-183 registers a thread, so at D <= 64
//     two or three blocks share an SM. The producer loads the tile's Q and dO
//     once and streams 64-key K/V tiles up to the causal limit through a
//     ring of kDqStages stages; K/V of GQA kv heads are read in place;
//   - per K/V tile, S = Q K^T and dP = dO V^T with both operands in shared
//     memory (K-major); dS, computed in registers and packed to bf16, is the
//     register A operand of dQ += dS K, with K read MN-major through the
//     transpose bit (as the forward reads V). The next tile's S and dP are
//     issued before this tile's dQ product, and its dS computed while the
//     tensor cores run that product;
//   - delta: each row's four threads sum dO * O over a quarter of D each,
//     dO from the shared tile and O by 16-byte loads issued before the
//     first wait; the sums run while the first tile's products do (they
//     cost K4 ~6% at the training shape, against ~1.3x K4's time for the
//     same sum in torch ops).
// K3 (bf16):
//   - one block per (128-key tile, batch * kv head): two consumer
//     warpgroups of 64 keys each and one producer warp (at D=128 one
//     warpgroup and 64 keys, for registers). K and V are loaded
//     once by TMA; the Q and dO tiles of every query head of the kv head
//     stream through a ring of kStages stages, from the causal start on.
//     lse and delta of each tile are plain loads by the producer warp into
//     the same stage (a tensor map over [B*H, Tq] f32 would need Tq a
//     multiple of 4);
//   - four wgmma products per query tile: S^T = K Q^T and dP^T = V dO^T
//     with both operands in shared memory (K-major), then dV += P^T dO and
//     dK += dS^T Q with P^T and dS^T packed from those accumulators into
//     register A operands and dO, Q read MN-major (transpose bit);
//   - none of the work for query tiles wholly before a warpgroup's keys.
//
// Layout: tensors are [B, T, heads, D] with the last dim contiguous, other
// strides (elements) are arguments; lse and delta are [B, H, Tq] f32,
// contiguous. K4 runs one block per (query tile, batch * head), K3 one per
// (key tile, batch * kv head). The host wrapper (ops/attention.py) checks
// dtypes, shapes, strides and alignment before it calls in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const void* o;   // K4: the forward's output, for delta
  const float* lse;
  float* delta;    // written by K4, read by K3
  void* dq;
  void* dk;
  void* dv;
  int B, Tq, Tk, H, Hkv;
  long long sqb, sqt, sqh;
  long long skb, skt, skh;
  long long svb, svt, svh;
  long long sdob, sdot, sdoh;
  long long sob, sot, soh;  // strides of o (K4)
  long long sgb, sgt, sgh;  // strides of dq (K4) or of dk and dv (K3)
  int causal;
  float scale;
  int head_group;  // bf16: heads whose blocks run together (l2_head_group)
};

constexpr int kThreads = 128;  // the f32 kernels' block: 4 warps

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

// ---------------------------------------------------- K4 bf16: wgmma, TMA ring

constexpr int kDqStages = 3;  // K/V tiles in flight

// Tiles of the bf16 K4 at head dim D. 64-key tiles keep S, dP, the packed
// dS and dQ within 120-138 registers a thread at D <= 64, so several blocks
// share an SM and one block's dS overlaps another's products. Measured
// slower at D=64: 128-key tiles (220 registers, one block an SM), one block
// of two warpgroups sharing each K/V tile, and a 2-stage ring.
template <int D>
struct DqTiles {
  static constexpr int kBQ = 64;                   // query rows a block
  static constexpr int kBK = 64;                   // keys a K/V tile
  static constexpr int kCols = panel_cols(D);
  static constexpr int kPanels = D / kCols;
  static constexpr int kRowBytes = 2 * kCols;
  static constexpr int kQBytes = kBQ * D * 2;      // one of Q, dO
  static constexpr int kKVBytes = kBK * D * 2;     // one of K, V
  static constexpr int kThreads = 128 + 32;        // + the producer warp
  // Q, dO, kDqStages x (K, V), the barriers; 1024 bytes of slack to align.
  static constexpr size_t kSmem =
      1024 + 2 * kQBytes + kDqStages * 2 * kKVBytes + 8 * (2 * kDqStages + 1);
};

// delta += the dot product of 8 bf16 pairs (16 bytes of each row) in f32.
__device__ __forceinline__ float dot8_bf16(uint4 a, uint4 b, float acc) {
  const uint32_t av[4] = {a.x, a.y, a.z, a.w};
  const uint32_t bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = fmaf(__uint_as_float(av[i] << 16), __uint_as_float(bv[i] << 16), acc);
    acc = fmaf(__uint_as_float(av[i] & 0xffff0000u), __uint_as_float(bv[i] & 0xffff0000u), acc);
  }
  return acc;
}

// K4, bf16. The consumer warpgroup owns the block's 64 query rows; S, P,
// dP and dS of each K/V tile never leave its registers.
template <int D>
__global__ void __launch_bounds__(DqTiles<D>::kThreads, 1)
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do, Params p) {
  using Tiles = DqTiles<D>;
  constexpr int BQ = Tiles::kBQ, BK = Tiles::kBK, RB = Tiles::kRowBytes;
  constexpr int kCols = Tiles::kCols;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023u) & ~1023u;
  const uint32_t do_s = q_s + Tiles::kQBytes;
  const uint32_t kv_s = do_s + Tiles::kQBytes;  // stage s: K, then V
  const uint32_t bars = kv_s + kDqStages * 2 * Tiles::kKVBytes;
  const uint32_t qdo_bar = bars + 16 * kDqStages;
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (kDqStages + s); };
  auto k_stage = [&](int j) { return kv_s + 2 * (j % kDqStages) * Tiles::kKVBytes; };

  // Heads in L2-sized groups; in a group, the last query tiles, whose
  // causal walk is longest, first.
  const int n_qt = (p.Tq + BQ - 1) / BQ;
  const HeadTile order = head_tile(blockIdx.x, n_qt, p.B * p.H, p.head_group);
  const int bh = order.head;
  const int qt = n_qt - 1 - order.tile;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int hkv = h / (p.H / p.Hkv);
  const int q0 = qt * BQ;
  int n_tiles = (p.Tk + BK - 1) / BK;
  // K tiles wholly above the diagonal are skipped.
  if (p.causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), 4);  // one arrival per consumer warp
    }
    mbar_init(qdo_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {
    // Producer: one thread loads Q and dO, then keeps the K/V ring full.
    if (lane == 0) {
      mbar_arrive_expect_tx(qdo_bar, 2 * Tiles::kQBytes);
      for (int pn = 0; pn < Tiles::kPanels; ++pn) {
        tma_load(q_s + pn * BQ * RB, &tm_q, qdo_bar, pn * kCols, q0, h, b);
        tma_load(do_s + pn * BQ * RB, &tm_do, qdo_bar, pn * kCols, q0, h, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kDqStages;
        mbar_wait(empty_bar(s), ((j / kDqStages) & 1) ^ 1);
        mbar_arrive_expect_tx(full_bar(s), 2 * Tiles::kKVBytes);
        const uint32_t k_s = k_stage(j);
        const uint32_t v_s = k_s + Tiles::kKVBytes;
        for (int pn = 0; pn < Tiles::kPanels; ++pn) {
          tma_load(k_s + pn * BK * RB, &tm_k, full_bar(s), pn * kCols, j * BK, hkv, b);
          tma_load(v_s + pn * BK * RB, &tm_v, full_bar(s), pn * kCols, j * BK, hkv, b);
        }
      }
    }
    return;
  }

  // Consumers: the warpgroup of warps 0-3, one 64-row wgmma tile.
  const int g = lane / 4;  // accumulator row group
  const int t = lane % 4;  // thread in group
  const int r0 = 16 * warp + g;  // this thread's tile rows: r0, r0 + 8
  const int row0 = q0 + r0;
  const int row1 = row0 + 8;
  const float c = p.scale * kLog2e;  // scores -> log2 units

  // lse of this thread's rows in log2 units, and its 16-byte chunks of their
  // O rows (chunks t, t + 4, ...), loaded before the first wait.
  constexpr int kChunks = D / 8;
  constexpr int kMine = (kChunks + 3) / 4;
  const float* lse = p.lse + (long long)bh * p.Tq;
  const float lse0 = row0 < p.Tq ? lse[row0] * kLog2e : 0.f;
  const float lse1 = row1 < p.Tq ? lse[row1] * kLog2e : 0.f;
  const __nv_bfloat16* o = static_cast<const __nv_bfloat16*>(p.o) + b * p.sob + h * p.soh;
  uint4 o0[kMine], o1[kMine];
#pragma unroll
  for (int i = 0; i < kMine; ++i) {
    const int ch = t + 4 * i;
    o0[i] = o1[i] = make_uint4(0u, 0u, 0u, 0u);
    if (ch < kChunks && row0 < p.Tq) o0[i] = *reinterpret_cast<const uint4*>(o + row0 * p.sot + 8 * ch);
    if (ch < kChunks && row1 < p.Tq) o1[i] = *reinterpret_cast<const uint4*>(o + row1 * p.sot + 8 * ch);
  }

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  float sc[BK / 2], dp[BK / 2];  // S then P, and dP then dS, of one K/V tile
  uint32_t da[BK / 16][4];       // dS in bf16: the A operand of dQ += dS K

  // Waits for K/V tile j and issues S = Q K_j^T and dP = dO V_j^T.
  auto issue_sdp = [&](int j) {
    mbar_wait(full_bar(j % kDqStages), (j / kDqStages) & 1);
    const uint32_t k_s = k_stage(j);
    const uint32_t v_s = k_s + Tiles::kKVBytes;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const int pn = kc * 16 / kCols;                 // panel
      const uint32_t off = ((kc * 16) % kCols) * 2;   // bytes along the row
      wgmma_ss<BK>(sc, desc_kmajor(q_s + pn * BQ * RB + off, RB),
                   desc_kmajor(k_s + pn * BK * RB + off, RB), kc);
    }
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const int pn = kc * 16 / kCols;
      const uint32_t off = ((kc * 16) % kCols) * 2;
      wgmma_ss<BK>(dp, desc_kmajor(do_s + pn * BQ * RB + off, RB),
                   desc_kmajor(v_s + pn * BK * RB + off, RB), kc);
    }
    wgmma_commit();
  };

  float del0 = 0.f, del1 = 0.f;

  // S, dP of tile j -> dS = P (dP - delta) scale, P = exp2(S c - lse).
  auto compute_ds = [&](int j) {
    const int k0 = j * BK;
    const bool masked = k0 + BK > p.Tk || (p.causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pr = exp2_fast(fmaf(sc[4 * i + e], c, e < 2 ? -lse0 : -lse1));
        if (masked) {
          const int key = k0 + 8 * i + 2 * t + (e & 1);
          const int row = e < 2 ? row0 : row1;
          if (key >= p.Tk || (p.causal && key > row)) pr = 0.f;
        }
        dp[4 * i + e] = pr * (dp[4 * i + e] - (e < 2 ? del0 : del1)) * p.scale;
      }
    }
  };

  // Packs dS to bf16, 16 keys a product.
  auto pack_ds = [&]() {
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
#pragma unroll
      for (int r = 0; r < 4; ++r) da[kc][r] = pack_bf16(dp[8 * kc + 2 * r], dp[8 * kc + 2 * r + 1]);
    }
  };

  // dQ += dS_j K_j: dS from registers, K_j MN-major.
  auto issue_dq = [&](int j) {
    const uint32_t k_s = k_stage(j);
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      wgmma_rs<D>(dq, da[kc], desc_mnmajor(k_s + kc * 16 * RB, RB, BK * RB));
    }
    wgmma_commit();
  };

  mbar_wait(qdo_bar, 0);
  wgmma_fence();
  issue_sdp(0);

  // delta of this thread's rows while the first products run: dO from the
  // shared tile (16-byte chunk ch of row r sits at chunk ch ^ (r's swizzle
  // phase) of its panel row, hopper.cuh), O from the registers.
  const unsigned char* do_ptr = smem_raw + (do_s - raw);
#pragma unroll
  for (int i = 0; i < kMine; ++i) {
    const int ch = t + 4 * i;
    if (ch < kChunks) {
      const int pn = ch * 8 / kCols;
      const int cc = ch % (kCols / 8);
      const int rr[2] = {r0, r0 + 8};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int sw = cc ^ ((rr[k] * RB >> 7) & (RB / 16 - 1));
        const uint4 dv = *reinterpret_cast<const uint4*>(do_ptr + pn * BQ * RB + rr[k] * RB + 16 * sw);
        if (k == 0) del0 = dot8_bf16(dv, o0[i], del0);
        else del1 = dot8_bf16(dv, o1[i], del1);
      }
    }
  }
  del0 = quad_sum(del0);
  del1 = quad_sum(del1);
  float* delta = p.delta + (long long)bh * p.Tq;
  if (t == 0 && row0 < p.Tq) delta[row0] = del0;
  if (t == 0 && row1 < p.Tq) delta[row1] = del1;

  wgmma_wait<0>();
  fence_regs(sc);
  fence_regs(dp);
  compute_ds(0);
  pack_ds();
  // Per tile j: issue S and dP of tile j + 1, then dQ += dS_j K_j; dS of
  // tile j + 1 is computed while the tensor cores run dS_j K_j.
  for (int j = 0; j + 1 < n_tiles; ++j) {
    wgmma_fence();
    issue_sdp(j + 1);
    issue_dq(j);
    wgmma_wait<1>();  // S and dP of tile j + 1
    fence_regs(sc);
    fence_regs(dp);
    compute_ds(j + 1);
    wgmma_wait<0>();
    fence_regs(dq);
    // This warp is done with K/V tile j.
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar(j % kDqStages));
    pack_ds();
  }
  wgmma_fence();
  issue_dq(n_tiles - 1);
  wgmma_wait<0>();
  fence_regs(dq);

  __nv_bfloat16* dqp = static_cast<__nv_bfloat16*>(p.dq) + b * p.sgb + h * p.sgh;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = 8 * i + 2 * t;
    if (row0 < p.Tq) {
      *reinterpret_cast<uint32_t*>(dqp + row0 * p.sgt + col) = pack_bf16(dq[4 * i], dq[4 * i + 1]);
    }
    if (row1 < p.Tq) {
      *reinterpret_cast<uint32_t*>(dqp + row1 * p.sgt + col) = pack_bf16(dq[4 * i + 2], dq[4 * i + 3]);
    }
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

// K4, f32: one block per (32-query tile, batch * head), 16-key tiles; delta
// of its rows first, as the bf16 kernel.
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
  __syncthreads();

  // delta = rowsum(dO * O): dims j, j + 4, ... here, then the row's quad.
  float delta = 0.f;
  if (row < p.Tq) {
    const float* orow = static_cast<const float*>(p.o) + b * p.sob + h * p.soh + row * p.sot;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) delta = fmaf(dOs[r * LD + j + 4 * i], orow[j + 4 * i], delta);
  }
  delta = quad_sum(delta);
  if (j == 0 && row < p.Tq) p.delta[(long long)bh * p.Tq + row] = delta;

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
cudaError_t launch_dq_bf16(Params p, cudaStream_t stream) {
  using Tiles = DqTiles<D>;
  p.head_group = l2_head_group(2LL * D * (3LL * p.Tq + 2LL * p.Tk), p.B * p.H);
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
  auto kernel = flash_bwd_dq_bf16_kernel<D>;
  static bool smem_set = false;
  if (err == cudaSuccess) err = allow_smem(kernel, Tiles::kSmem, &smem_set);
  if (err != cudaSuccess) return err;
  const int blocks = (p.Tq + Tiles::kBQ - 1) / Tiles::kBQ * p.B * p.H;
  kernel<<<blocks, Tiles::kThreads, Tiles::kSmem, stream>>>(tq, tk, tv, tdo, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Params& p, int dtype, cudaStream_t stream) {
  if (dtype == 1) return launch_dq_bf16<D>(p, stream);
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

// Launch K4 (dQ, and delta into a [B, H, Tq] f32 buffer) or K3 (dK, dV,
// reading K4's delta) on `stream`; each returns the launch's cudaError_t
// (0 = queued). dtype: 0 = float32, 1 = bfloat16. Strides are in elements;
// the g* strides are those of the outputs (dk and dv share them).
int rt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                    const void* out, const float* lse, float* delta, void* dq,
                    int B, int Tq, int Tk, int H, int Hkv, int D,
                    long long sqb, long long sqt, long long sqh,
                    long long skb, long long skt, long long skh,
                    long long svb, long long svt, long long svh,
                    long long sdob, long long sdot, long long sdoh,
                    long long sob, long long sot, long long soh,
                    long long sgb, long long sgt, long long sgh,
                    int causal, float scale, int dtype, void* stream) {
  if (bad_args(B, Tq, Tk, H, Hkv, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, dout, out, lse, delta, dq, nullptr, nullptr, B, Tq, Tk, H, Hkv,
           sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sdob, sdot, sdoh,
           sob, sot, soh, sgb, sgt, sgh, causal, scale, 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return static_cast<int>(launch_dq<16>(p, dtype, s));
    case 32: return static_cast<int>(launch_dq<32>(p, dtype, s));
    case 64: return static_cast<int>(launch_dq<64>(p, dtype, s));
    case 128: return static_cast<int>(launch_dq<128>(p, dtype, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

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
  Params p{q, k, v, dout, nullptr, lse, const_cast<float*>(delta), nullptr, dk, dv,
           B, Tq, Tk, H, Hkv, sqb, sqt, sqh, skb, skt, skh, svb, svt, svh,
           sdob, sdot, sdoh, 0, 0, 0, sgb, sgt, sgh, causal, scale, 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return static_cast<int>(launch_dkv<16>(p, dtype, s));
    case 32: return static_cast<int>(launch_dkv<32>(p, dtype, s));
    case 64: return static_cast<int>(launch_dkv<64>(p, dtype, s));
    case 128: return static_cast<int>(launch_dkv<128>(p, dtype, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* rt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
