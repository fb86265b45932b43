// K1 and K2: flash-attention forward, without (K1) and with (K2) the
// per-row logsumexp.
//
// Replaces: ray_tpu/ops/attention.py:_flash_kernel (:73), one kernel body in
// JAX too. K1 is _flash_fwd_impl(with_lse=False) (:191), the forward of
// every serving call of the JAX package's full-sequence forward; K2 is
// _flash_fwd_impl(with_lse=True) (:174), the forward of every training step,
// whose lse = max(m, NEG_INF) + log(max(l, 1e-30)) (:134) feeds the backward
// kernels (flash_bwd.cu). Here the two are one template with a compile-time
// flag: a null lse pointer launches the K1 instance, whose code has no lse
// store at all. The port stores lse as [B, H, Tq] f32, not JAX's
// 8x-replicated [B*H, 8, Tq_p] (a Mosaic tiling rule, :131-135).
//
// Contract (the JAX kernel's, attention.py:82-85 and :118-121):
//   - bf16 operands with f32 accumulation (wgmma m64nNk16 bf16 -> f32);
//     f32 operands stay f32 (plain FMA: TF32 would break the 2e-5 bound);
//   - scores are scaled by D**-0.5 in f32, after the product (the bf16
//     kernel folds log2(e) into the scale and uses exp2: still f32
//     arithmetic on the f32 scores);
//   - keys at or past seq_k are masked to NEG_INF = -1e30, and so are keys
//     above the diagonal when causal (q_pos >= k_pos, top-left aligned);
//   - online softmax with running max m, denominator l and an f32
//     accumulator; P is cast to V's dtype before the PV product;
//   - out = acc / max(l, 1e-30), cast to the input dtype.
//
// What bounds it on this card: at the GPT-2-small training shape (B=32,
// T=1024, H=12, D=64, causal, bf16) it must read q, k, v and write o and
// lse once, 203 MB, 0.061 ms at 3.35 TB/s; its 51.6 GFLOP of products take
// 0.052 ms at 989 TFLOP/s. Its 0.2 G exponentials (the causal half of the
// scores), at the SFU's 16 a cycle per SM against the tensor cores' 1024
// bf16 FMAs, need half the products' time at D=64. At the
// serving shape (B=2, T=256) the launch itself costs more than any bound.
// The bf16 design (Hopper, sm_90a):
//   - one block per (64-row query tile, batch * head): one consumer
//     warpgroup (one wgmma M tile) and one producer warp. Two such blocks
//     fit on an SM, so one block's loads and epilogue overlap the other's
//     products (measured faster than one block of two warpgroups at the
//     serving, training and T=2048 shapes). Blocks run head group by head
//     group, each group small enough that its K/V stay in L2 while all its
//     query tiles read them (a grid that walks all heads first re-reads
//     K/V from HBM for every query tile once they outgrow L2); within a
//     group the last query tiles, whose causal walk is longest, start
//     first;
//   - the producer issues TMA loads: the Q tile once, then the K/V tiles
//     through a ring of kStages shared-memory stages guarded by full/empty
//     mbarriers, so the next tile is in flight while the consumers compute.
//     The tensor maps walk the strided [B, T, H, D] views (the model's
//     fused-qkv slices) in place, read GQA kv heads in place, and zero-fill
//     rows past the sequence's end;
//   - S = Q K^T is wgmma with both operands in shared memory (K-major);
//     O += P V is wgmma with P from registers (S's accumulator, packed to
//     bf16) and V read MN-major through the descriptor's transpose bit, so
//     scores and probabilities never leave registers. The consumers issue
//     S of the next tile before P V of this one and compute the next
//     softmax while the tensor cores run P V;
//   - the mask is applied only to tiles that cross the diagonal or the
//     ragged end of the keys.
// Every head dim the port takes (16, 32, 64, 128) runs this design: panels
// of min(D, 64) columns with the 32-, 64- or 128-byte swizzle of their rows,
// and 64-key tiles at D=128 to keep S, P and O within the registers.
//
// Layout: tensors are [B, T, H, D] with the last dim contiguous; the other
// strides (elements) are arguments. The host wrapper (ops/attention.py)
// checks dtypes, shapes, strides and alignment before it calls
// rt_flash_fwd.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, H, Tq] f32; written only by the kWithLse instances
  int B, Tq, Tk, H, Hkv;
  long long sqb, sqt, sqh;
  long long skb, skt, skh;
  long long svb, svt, svh;
  long long sob, sot, soh;
  int causal;
  float scale;
  int head_group;  // bf16: heads whose blocks run together (l2_head_group)
};

constexpr int kThreads = 128;  // the f32 kernel's block

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// ---------------------------------------------------- bf16: wgmma, TMA ring

constexpr int kStages = 3;  // K/V tiles in flight

// Tiles of the bf16 forward at head dim D.
template <int D>
struct FwdTiles {
  static constexpr int kBQ = 64;                       // query rows a block
  static constexpr int kBK = D == 128 ? 64 : 128;      // keys a K/V tile
  static constexpr int kCols = panel_cols(D);
  static constexpr int kPanels = D / kCols;
  static constexpr int kRowBytes = 2 * kCols;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = kBK * D * 2;         // one of K, V
  static constexpr int kThreads = 128 + 32;            // + the producer warp
  // Q, kStages x (K, V), the barriers; 1024 bytes of slack to align.
  static constexpr size_t kSmem =
      1024 + kQBytes + kStages * 2 * kKVBytes + 8 * (2 * kStages + 1);
};

template <int D, bool kWithLse>
__global__ void __launch_bounds__(FwdTiles<D>::kThreads, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, Params p) {
  using Tiles = FwdTiles<D>;
  constexpr int BQ = Tiles::kBQ, BK = Tiles::kBK, RB = Tiles::kRowBytes;
  constexpr int kCols = Tiles::kCols;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + Tiles::kQBytes;  // stage s: K, then V
  const uint32_t bars = kv_s + kStages * 2 * Tiles::kKVBytes;
  const uint32_t q_bar = bars + 16 * kStages;
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (kStages + s); };
  auto k_stage = [&](int j) { return kv_s + 2 * (j % kStages) * Tiles::kKVBytes; };

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
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), 4);  // one arrival per consumer warp
    }
    mbar_init(q_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {
    // Producer: one thread keeps the ring full.
    if (lane == 0) {
      mbar_arrive_expect_tx(q_bar, Tiles::kQBytes);
      for (int pn = 0; pn < Tiles::kPanels; ++pn) {
        tma_load(q_s + pn * BQ * RB, &tm_q, q_bar, pn * kCols, q0, h, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(empty_bar(s), ((j / kStages) & 1) ^ 1);
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
  const int row0 = q0 + 16 * warp + g;  // this thread's rows: row0, row0 + 8
  const int row1 = row0 + 8;
  const float c = p.scale * kLog2e;  // scores -> log2 units

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // m scaled, in log2 units
  float alpha0 = 1.f, alpha1 = 1.f;
  float sc[BK / 2];              // S, then P, of one K tile
  uint32_t pa[BK / 16][4];       // P in bf16: the A operand of O += P V

  // Waits for K tile j and issues S = Q K_j^T: 64 rows x BK keys.
  auto issue_scores = [&](int j) {
    mbar_wait(full_bar(j % kStages), (j / kStages) & 1);
    const uint32_t k_s = k_stage(j);
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const int pn = kc * 16 / kCols;                 // panel
      const uint32_t off = ((kc * 16) % kCols) * 2;   // bytes along the row
      wgmma_ss<BK>(sc, desc_kmajor(q_s + pn * BQ * RB + off, RB),
                   desc_kmajor(k_s + pn * BK * RB + off, RB), kc);
    }
    wgmma_commit();
  };

  // S of K tile j -> P = exp2(S c - m), with the running max, the
  // denominator and the rescale factor of the accumulator.
  auto softmax = [&](int j) {
    const int k0 = j * BK;
    if (k0 + BK > p.Tk || (p.causal && k0 + BK - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * i + 2 * t + (e & 1);
          const int row = e < 2 ? row0 : row1;
          if (key >= p.Tk || (p.causal && key > row)) sc[4 * i + e] = kNegInf;
        }
      }
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0) * c);
    const float mn1 = fmaxf(m1, quad_max(mx1) * c);
    alpha0 = exp2_fast(m0 - mn0);
    alpha1 = exp2_fast(m1 - mn1);
    float ts0 = 0.f, ts1 = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      sc[4 * i] = exp2_fast(fmaf(sc[4 * i], c, -mn0));
      sc[4 * i + 1] = exp2_fast(fmaf(sc[4 * i + 1], c, -mn0));
      sc[4 * i + 2] = exp2_fast(fmaf(sc[4 * i + 2], c, -mn1));
      sc[4 * i + 3] = exp2_fast(fmaf(sc[4 * i + 3], c, -mn1));
      ts0 += sc[4 * i] + sc[4 * i + 1];
      ts1 += sc[4 * i + 2] + sc[4 * i + 3];
    }
    l0 = l0 * alpha0 + quad_sum(ts0);
    l1 = l1 * alpha1 + quad_sum(ts1);
    m0 = mn0;
    m1 = mn1;
  };

  // Rescales the accumulator and packs P to bf16 (16 keys a product).
  auto rescale_and_pack = [&]() {
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[4 * i] *= alpha0;
      o[4 * i + 1] *= alpha0;
      o[4 * i + 2] *= alpha1;
      o[4 * i + 3] *= alpha1;
    }
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kc][r] = pack_bf16(sc[8 * kc + 2 * r], sc[8 * kc + 2 * r + 1]);
    }
  };

  // O += P_j V_j: P from registers, V_j MN-major.
  auto issue_pv = [&](int j) {
    const uint32_t v_s = k_stage(j) + Tiles::kKVBytes;
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      wgmma_rs<D>(o, pa[kc], desc_mnmajor(v_s + kc * 16 * RB, RB, BK * RB));
    }
    wgmma_commit();
  };

  mbar_wait(q_bar, 0);
  wgmma_fence();
  issue_scores(0);
  wgmma_wait<0>();
  fence_regs(sc);
  softmax(0);
  rescale_and_pack();
  // Per tile j: issue S of tile j + 1, then O += P_j V_j; the softmax of
  // tile j + 1 runs while the tensor cores compute P_j V_j.
  for (int j = 0; j + 1 < n_tiles; ++j) {
    wgmma_fence();
    issue_scores(j + 1);
    issue_pv(j);
    wgmma_wait<1>();  // S of tile j + 1
    fence_regs(sc);
    softmax(j + 1);
    wgmma_wait<0>();
    fence_regs(o);
    // This warp is done with K/V tile j.
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar(j % kStages));
    rescale_and_pack();
  }
  wgmma_fence();
  issue_pv(n_tiles - 1);
  wgmma_wait<0>();
  fence_regs(o);

  if constexpr (kWithLse) {
    // m and l are quad-reduced, so one thread of each quad writes the row.
    float* lse = p.lse + (long long)bh * p.Tq;
    if (t == 0 && row0 < p.Tq) lse[row0] = fmaxf(m0 * kLn2, kNegInf) + logf(fmaxf(l0, 1e-30f));
    if (t == 0 && row1 < p.Tq) lse[row1] = fmaxf(m1 * kLn2, kNegInf) + logf(fmaxf(l1, 1e-30f));
  }
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + b * p.sob + h * p.soh;
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = 8 * i + 2 * t;
    if (row0 < p.Tq) {
      *reinterpret_cast<uint32_t*>(out + row0 * p.sot + col) =
          pack_bf16(o[4 * i] * inv0, o[4 * i + 1] * inv0);
    }
    if (row1 < p.Tq) {
      *reinterpret_cast<uint32_t*>(out + row1 * p.sot + col) =
          pack_bf16(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
    }
  }
}

// ------------------------------------------------------------- f32: FMA

constexpr int kFBQ = 32;  // query rows per block, 4 threads a row
constexpr int kFBK = 16;  // keys per K/V tile

template <int D, bool kWithLse>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(Params p) {
  // +1 float of padding a row keeps the strided reads on distinct banks.
  __shared__ float Qs[kFBQ][D + 1];
  __shared__ float Ks[kFBK][D + 1];
  __shared__ float Vs[kFBK][D];

  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int hkv = h / (p.H / p.Hkv);
  const int r = threadIdx.x / 4;  // this thread's query row in the tile
  const int j = threadIdx.x % 4;  // its quarter of the row
  const int row = qt * kFBQ + r;

  const float* q = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh;
  const float* k = static_cast<const float*>(p.k) + b * p.skb + hkv * p.skh;
  const float* v = static_cast<const float*>(p.v) + b * p.svb + hkv * p.svh;
  float* o = static_cast<float*>(p.o) + b * p.sob + h * p.soh;

  for (int idx = threadIdx.x; idx < kFBQ * D; idx += kThreads) {
    const int rr = idx / D, c = idx % D;
    const int qr = qt * kFBQ + rr;
    Qs[rr][c] = qr < p.Tq ? q[qr * p.sqt + c] : 0.f;
  }

  // Each thread owns dims j, j + 4, ... of its row's accumulator.
  float acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;

  int num_tiles = (p.Tk + kFBK - 1) / kFBK;
  if (p.causal) {
    const int last = ((qt + 1) * kFBQ - 1) / kFBK + 1;
    num_tiles = min(num_tiles, last);
  }

  for (int kt = 0; kt < num_tiles; ++kt) {
    const int k0 = kt * kFBK;
    __syncthreads();
    for (int idx = threadIdx.x; idx < kFBK * D; idx += kThreads) {
      const int kr = idx / D, c = idx % D;
      const bool in = k0 + kr < p.Tk;
      Ks[kr][c] = in ? k[(k0 + kr) * p.skt + c] : 0.f;
      Vs[kr][c] = in ? v[(k0 + kr) * p.svt + c] : 0.f;
    }
    __syncthreads();

    // This thread's scores: keys j, j + 4, j + 8, j + 12 of the tile.
    float s[kFBK / 4];
    float tmax = kNegInf;
#pragma unroll
    for (int i = 0; i < kFBK / 4; ++i) {
      const int kr = j + 4 * i;
      float dot = 0.f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) dot = fmaf(Qs[r][c], Ks[kr][c], dot);
      const int key = k0 + kr;
      bool keep = key < p.Tk;
      if (p.causal) keep = keep && (row >= key);
      s[i] = keep ? dot * p.scale : kNegInf;
      tmax = fmaxf(tmax, s[i]);
    }
    const float mn = fmaxf(m, quad_max(tmax));
    const float alpha = expf(m - mn);
    float ts = 0.f;
#pragma unroll
    for (int i = 0; i < kFBK / 4; ++i) {
      s[i] = expf(s[i] - mn);
      ts += s[i];
    }
    l = l * alpha + quad_sum(ts);
    m = mn;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) acc[i] *= alpha;
    // acc += P V: the row's probabilities come from its 4 threads by shuffle.
#pragma unroll
    for (int kr = 0; kr < kFBK; ++kr) {
      const float pk = __shfl_sync(0xffffffffu, s[kr / 4], ((threadIdx.x % 32) & ~3) | (kr % 4));
#pragma unroll
      for (int i = 0; i < D / 4; ++i) acc[i] = fmaf(pk, Vs[kr][j + 4 * i], acc[i]);
    }
  }

  if constexpr (kWithLse) {
    if (j == 0 && row < p.Tq) {
      p.lse[(long long)bh * p.Tq + row] = fmaxf(m, kNegInf) + logf(fmaxf(l, 1e-30f));
    }
  }
  if (row < p.Tq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < D / 4; ++i) o[row * p.sot + j + 4 * i] = acc[i] * inv;
  }
}

template <int D, bool kWithLse>
cudaError_t launch_bf16(Params p, cudaStream_t stream) {
  using Tiles = FwdTiles<D>;
  p.head_group = l2_head_group(2LL * D * (p.Tq + 2LL * p.Tk), p.B * p.H);
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_panel_map(&tq, p.q, p.B, p.Tq, p.H, D, p.sqb, p.sqt, p.sqh, Tiles::kBQ);
  if (err == cudaSuccess) {
    err = make_panel_map(&tk, p.k, p.B, p.Tk, p.Hkv, D, p.skb, p.skt, p.skh, Tiles::kBK);
  }
  if (err == cudaSuccess) {
    err = make_panel_map(&tv, p.v, p.B, p.Tk, p.Hkv, D, p.svb, p.svt, p.svh, Tiles::kBK);
  }
  auto kernel = flash_fwd_bf16_kernel<D, kWithLse>;
  static bool smem_set = false;
  if (err == cudaSuccess) err = allow_smem(kernel, Tiles::kSmem, &smem_set);
  if (err != cudaSuccess) return err;
  const int blocks = (p.Tq + Tiles::kBQ - 1) / Tiles::kBQ * p.B * p.H;
  kernel<<<blocks, Tiles::kThreads, Tiles::kSmem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

template <int D, bool kWithLse>
cudaError_t launch(const Params& p, int dtype, cudaStream_t stream) {
  if (dtype == 1) return launch_bf16<D, kWithLse>(p, stream);
  dim3 grid((p.Tq + kFBQ - 1) / kFBQ, p.B * p.H);
  flash_fwd_f32_kernel<D, kWithLse><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Params& p, int dtype, cudaStream_t stream) {
  return p.lse ? launch<D, true>(p, dtype, stream) : launch<D, false>(p, dtype, stream);
}

}  // namespace

extern "C" {

// Launches K1 (lse == NULL) or K2 (lse = a [B, H, Tq] f32 buffer) on
// `stream` and returns the launch's cudaError_t (0 = queued).
// dtype: 0 = float32, 1 = bfloat16. Strides are in elements.
int rt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                 int B, int Tq, int Tk, int H, int Hkv, int D,
                 long long sqb, long long sqt, long long sqh,
                 long long skb, long long skt, long long skh,
                 long long svb, long long svt, long long svh,
                 long long sob, long long sot, long long soh,
                 int causal, float scale, int dtype, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{q, k, v, o, static_cast<float*>(lse), B, Tq, Tk, H, Hkv,
           sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh,
           causal, scale, 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return static_cast<int>(launch<16>(p, dtype, s));
    case 32: return static_cast<int>(launch<32>(p, dtype, s));
    case 64: return static_cast<int>(launch<64>(p, dtype, s));
    case 128: return static_cast<int>(launch<128>(p, dtype, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* rt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
