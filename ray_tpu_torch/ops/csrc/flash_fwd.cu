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
//   - bf16 operands with f32 accumulation (mma.sync m16n8k16 bf16 -> f32);
//     f32 operands stay f32 (plain FMA: TF32 would break the 2e-5 bound);
//   - scores are scaled by D**-0.5 in f32, after the product;
//   - keys at or past seq_k are masked to NEG_INF = -1e30, and so are keys
//     above the diagonal when causal (q_pos >= k_pos, top-left aligned);
//   - online softmax with running max m, denominator l and an f32
//     accumulator; P is cast to V's dtype before the PV product;
//   - out = acc / max(l, 1e-30), cast to the input dtype.
//
// What bounds it on this card: at the GPT-2-small serving shape (B=2,
// T=256, H=12, D=64, causal, bf16) it must read q, k, v and write o once,
// 3.1 MB, which takes 0.94 us at 3.35 TB/s; its 0.2 GFLOP of products take
// 0.2 us at 989 TFLOP/s. So bytes bound it, and at this size the launch
// itself costs more than either. The design keeps the [Tq, Tk] score matrix
// out of device memory (scores and probabilities live in registers), reads
// each K/V tile from device memory once per 64-row query tile, skips K
// tiles wholly above the diagonal, reads GQA kv heads in place (head
// h // (H / Hkv)) and walks the [B, T, H, D] layout through strides, so no
// transpose, pad or repeat copy is made around it.
//
// Layout: one thread block per (query tile, batch*head). Tensors are
// [B, T, H, D] with the last dim contiguous; the other strides (elements)
// are arguments. The host wrapper (ops/attention.py) checks dtypes, shapes,
// strides and alignment before it calls rt_flash_fwd.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr float kNegInf = -1e30f;

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
};

// ------------------------------------------------------------ bf16: mma.sync

constexpr int kBQ = 64;       // query rows per block: 4 warps x 16 rows
constexpr int kBK = 64;       // keys per K/V tile
constexpr int kThreads = 128;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Copies rows [k0, k0 + kBK) of one head of a [B, T, Hkv, D] tensor into a
// [kBK][D + 8] shared tile, 16 bytes a thread; rows past seq_k are zeros so
// that masked probabilities (0) never meet uninitialised values.
template <int D>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16 (*dst)[D + 8],
                                               const __nv_bfloat16* base,
                                               long long row_stride, int k0,
                                               int seq_k) {
  constexpr int kVecPerRow = D / 8;
  for (int idx = threadIdx.x; idx < kBK * kVecPerRow; idx += kThreads) {
    int r = idx / kVecPerRow;
    int c = (idx % kVecPerRow) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + r < seq_k) {
      val = *reinterpret_cast<const uint4*>(base + (long long)(k0 + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(&dst[r][c]) = val;
  }
}

template <int D, bool kWithLse>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(Params p) {
  // +8 bf16 of padding a row: the fragment loads below then hit 32
  // distinct banks (row stride = 4 mod 32 words).
  __shared__ __align__(16) __nv_bfloat16 Ks[kBK][D + 8];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBK][D + 8];

  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int hkv = h / (p.H / p.Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread in group

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.sqb + h * p.sqh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.skb + hkv * p.skh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.svb + hkv * p.svh;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) + b * p.sob + h * p.soh;

  const int row0 = qt * kBQ + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const int row1 = row0 + 8;

  // Q fragments stay in registers for the whole key loop.
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c0 = kc * 16 + 2 * t;
    const int c1 = c0 + 8;
    qa[kc][0] = row0 < p.Tq ? *reinterpret_cast<const uint32_t*>(q + row0 * p.sqt + c0) : 0u;
    qa[kc][1] = row1 < p.Tq ? *reinterpret_cast<const uint32_t*>(q + row1 * p.sqt + c0) : 0u;
    qa[kc][2] = row0 < p.Tq ? *reinterpret_cast<const uint32_t*>(q + row0 * p.sqt + c1) : 0u;
    qa[kc][3] = row1 < p.Tq ? *reinterpret_cast<const uint32_t*>(q + row1 * p.sqt + c1) : 0u;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  int num_tiles = (p.Tk + kBK - 1) / kBK;
  if (p.causal) {
    // Highest K tile this query tile can see; the rest lie above the diagonal.
    const int last = ((qt + 1) * kBQ - 1) / kBK + 1;
    num_tiles = min(num_tiles, last);
  }

  for (int kt = 0; kt < num_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile is no longer read
    load_tile_bf16<D>(Ks, k, p.skt, k0, p.Tk);
    load_tile_bf16<D>(Vs, v, p.svt, k0, p.Tk);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys (8 n-tiles).
    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&Ks[nt * 8 + g][kc * 16 + 2 * t]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&Ks[nt * 8 + g][kc * 16 + 8 + 2 * t]);
        mma_bf16(s[nt], qa[kc], b0, b1);
      }
    }

    // Scale, mask, and the row maxima of this tile.
    float tmax0 = kNegInf, tmax1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t + (e & 1);
        const int row = (e < 2) ? row0 : row1;
        bool keep = key < p.Tk;
        if (p.causal) keep = keep && (row >= key);
        const float x = keep ? s[nt][e] * p.scale : kNegInf;
        s[nt][e] = x;
        if (e < 2) tmax0 = fmaxf(tmax0, x); else tmax1 = fmaxf(tmax1, x);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(tmax0));
    const float mn1 = fmaxf(m1, quad_max(tmax1));
    const float alpha0 = expf(m0 - mn0);
    const float alpha1 = expf(m1 - mn1);
    float ts0 = 0.f, ts1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - mn0);
      s[nt][1] = expf(s[nt][1] - mn0);
      s[nt][2] = expf(s[nt][2] - mn1);
      s[nt][3] = expf(s[nt][3] - mn1);
      ts0 += s[nt][0] + s[nt][1];
      ts1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * alpha0 + quad_sum(ts0);
    l1 = l1 * alpha1 + quad_sum(ts1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha0;
      acc[dt][1] *= alpha0;
      acc[dt][2] *= alpha1;
      acc[dt][3] *= alpha1;
    }

    // acc += P V. The S accumulator layout of two neighbouring n-tiles is
    // the A-fragment layout of one 16-key chunk of P (cast to bf16 here).
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const int kr = kc * 16 + 2 * t;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const int col = dt * 8 + g;
        const uint32_t b0 = pack_bf16_raw(Vs[kr][col], Vs[kr + 1][col]);
        const uint32_t b1 = pack_bf16_raw(Vs[kr + 8][col], Vs[kr + 9][col]);
        mma_bf16(acc[dt], pa, b0, b1);
      }
    }
  }

  if constexpr (kWithLse) {
    // m and l are quad-reduced, so one thread of each quad writes the row.
    float* lse = p.lse + (long long)bh * p.Tq;
    if (t == 0 && row0 < p.Tq) lse[row0] = fmaxf(m0, kNegInf) + logf(fmaxf(l0, 1e-30f));
    if (t == 0 && row1 < p.Tq) lse[row1] = fmaxf(m1, kNegInf) + logf(fmaxf(l1, 1e-30f));
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row0 < p.Tq) {
      *reinterpret_cast<uint32_t*>(o + row0 * p.sot + col) =
          pack_bf16(acc[dt][0] * inv0, acc[dt][1] * inv0);
    }
    if (row1 < p.Tq) {
      *reinterpret_cast<uint32_t*>(o + row1 * p.sot + col) =
          pack_bf16(acc[dt][2] * inv1, acc[dt][3] * inv1);
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
cudaError_t launch(const Params& p, int dtype, cudaStream_t stream) {
  dim3 block(kThreads);
  const int bh = p.B * p.H;
  if (dtype == 1) {
    dim3 grid((p.Tq + kBQ - 1) / kBQ, bh);
    flash_fwd_bf16_kernel<D, kWithLse><<<grid, block, 0, stream>>>(p);
  } else {
    dim3 grid((p.Tq + kFBQ - 1) / kFBQ, bh);
    flash_fwd_f32_kernel<D, kWithLse><<<grid, block, 0, stream>>>(p);
  }
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
           causal, scale};
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
