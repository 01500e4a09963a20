// Fused pointwise MLP with residual for Hopper (sm_90a), rows of channels:
//     h   = gelu_tanh(x @ W1 + b1)          f32 accumulate, bias in f32
//     out = round( x + (round_T(h) @ W2 + b2) )   h rounded to x's type first
// x (M, C), W1 (C, E), W2 (E, C), biases f32, out (M, C) in x's type. The
// pointwise (1x1x1) conv out = round(x @ W^T) of a weight W (Cout, C) has
// kernels of its own (below the MLP's).
//
// Replaces the TPU kernel fused_mlp_residual of
// pytorch_connectomics_tpu/ops/fused_mlp_pallas.py:40 (pallas_call :54, body
// _fused_mlp_kernel :29, NDHWC wrapper :70), and the pointwise probes pw_cf
// of scripts/tpu_bf16_experiments.py:181 and scripts/tpu_bf16_experiments2.py:171.
// It ports what they compute, not the TPU's VMEM row blocks or CF lanes.
//
// Bound on an H100: at MedNeXt-S's stage 0 (C 32, E 64, bf16) one row reads
// and writes 128 bytes and does 16 KFLOP of tensor-core work, 128 FLOP per
// byte, below the card's ridge (~295): bytes bound it. At C 512, E 1024 the
// products (4 C E FLOP per row) are above the ridge; there the rows are few
// and the weights (2 MB in bf16) are read once per row tile from L2.
//
// Design (simple and right first):
// - A block takes a tile of BM rows (BM = 128, 64, 32 or 16, sized by C so
//   that the f32 accumulator of the second product fits in registers: at
//   most 64 values a thread) and walks tiles in a grid-stride loop.
// - E is walked in chunks of EC hidden columns: the first product of the
//   chunk (tile x W1[:, chunk]) runs on the tensor cores (ldmatrix +
//   mma.sync m16n8k16), the bias and GELU are applied in registers, and
//   round_T(h) goes to shared memory, never to device memory; the second
//   product accumulates tile x C outputs in registers over the chunks.
// - Where both weights fit in shared memory beside the tile (MedNeXt-S
//   stages 0-2 in bf16), they are staged once per block and stay; otherwise
//   each chunk's slice of W1 and W2 is staged per tile (cp.async).
// - Ragged M: rows past M are zero-filled when staged and never stored.
// - Shared-memory row strides are odd multiples of 16 bytes, so the 8 rows
//   of an ldmatrix phase fall on distinct banks.
// - float32: an exact f32 path on the CUDA cores (no TF32), the same tiles
//   and chunks with scalar FMAs, for the arithmetic check.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see ops/build.py). Plain C interface for ctypes.

#include "mednext_block.cuh"

namespace fmlp {

using mednext::cp_async;
using mednext::cp_async_commit;
using mednext::cp_async_wait;
using mednext::cp_async_wait_all;
using mednext::gelu_tanh;
using mednext::ldsm_x4;
using mednext::ldsm_x4_trans;
using mednext::mma16816;
using mednext::store2;
using mednext::stsm_x4;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxUnits = 2;     // bf16: (16 rows x 16 hidden) units of the first product per warp and chunk
constexpr int kMaxPairs = 8;     // bf16: 16-column output pairs per warp in the second product
constexpr int kMaxOutF32 = 32;   // f32: outputs of the second product per thread
constexpr int kMaxHidF32 = 8;    // f32: hidden values of a chunk per thread
constexpr int kErrShape = 10001;
constexpr size_t kMaxSmem = 232448;

struct Geom {
  long long M;
  int C, E;  // input width; hidden width
  int BM;    // rows per tile
  int MF;    // bf16: 16-row fragments per tile
  int WN;    // bf16: warps per fragment row in the second product (kWarps / MF)
  int EC;    // hidden columns per chunk
  int EW;    // hidden columns held in shared memory (E when resident, else EC)
  int resident;
  int XS, W1S, W2S, GS;   // row strides (elements) of the x tile, W1 (per k), W2 (per e), the hidden chunk
  long long tiles;
};

struct Layout {
  size_t x, w1, w2, g, total;  // byte offsets
};

__host__ __device__ inline size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

__host__ __device__ inline Layout layout(const Geom& g, int es) {
  Layout l;
  l.x = 0;
  l.w1 = align128((size_t)g.BM * g.XS * es);
  l.w2 = l.w1 + align128((size_t)g.C * g.W1S * es);
  l.g = l.w2 + align128((size_t)g.EW * g.W2S * es);
  l.total = l.g + align128((size_t)g.BM * g.GS * es);
  return l;
}

// Stage hidden columns [e0, e0 + ec) of W1 and rows [e0, e0 + ec) of W2 at
// column (row) `at` of their shared-memory buffers, in 16-byte pieces.
template <typename T>
__device__ __forceinline__ void stage_weights(const T* __restrict__ w1, const T* __restrict__ w2, T* w1s, T* w2s,
                                              const Geom& g, int e0, int ec, int at) {
  constexpr int per = 16 / (int)sizeof(T);
  const int vec1 = ec / per;
  for (int i = threadIdx.x; i < g.C * vec1; i += kThreads) {
    const int k = i / vec1, v = i - k * vec1;
    cp_async<16>(w1s + (size_t)k * g.W1S + at + v * per, w1 + (size_t)k * g.E + e0 + v * per, true);
  }
  const int vec2 = g.C / per;
  for (int i = threadIdx.x; i < ec * vec2; i += kThreads) {
    const int e = i / vec2, v = i - e * vec2;
    cp_async<16>(w2s + (size_t)(at + e) * g.W2S + v * per, w2 + (size_t)(e0 + e) * g.C + v * per, true);
  }
}

// Stage rows [m0, m0 + BM) of x; rows past M are zero-filled.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ x, T* xs, const Geom& g, long long m0) {
  constexpr int per = 16 / (int)sizeof(T);
  const int vec = g.C / per;
  for (int i = threadIdx.x; i < g.BM * vec; i += kThreads) {
    const int r = i / vec, v = i - r * vec;
    const bool valid = m0 + r < g.M;
    cp_async<16>(xs + (size_t)r * g.XS + v * per, x + (valid ? (m0 + r) * g.C + v * per : 0), valid);
  }
}

// bf16 on the tensor cores. NP: 16-column output pairs per warp (2, 4 or 8).
template <int NP>
__global__ void __launch_bounds__(kThreads)
    mlp_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
                    const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2, const float* __restrict__ b2,
                    __nv_bfloat16* __restrict__ out, Geom g) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout l = layout(g, 2);
  T* xs = reinterpret_cast<T*>(smem + l.x);
  T* w1s = reinterpret_cast<T*>(smem + l.w1);
  T* w2s = reinterpret_cast<T*>(smem + l.w2);
  T* gs = reinterpret_cast<T*>(smem + l.g);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  // second product: this warp's 16 rows (mi) and its output pairs wn, wn + WN, ...
  const int mi = warp % g.MF, wn = warp / g.MF;
  int np = 0;
  while (np < NP && wn + np * g.WN < g.C / 16) ++np;
  const int chunks = (g.E + g.EC - 1) / g.EC;

  if (g.resident) stage_weights(w1, w2, w1s, w2s, g, 0, g.E, 0);  // the first tile's barrier publishes them

  for (long long t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    const long long m0 = t * g.BM;
    stage_rows(x, xs, g, m0);
    float acc[NP][2][4];
#pragma unroll
    for (int j = 0; j < NP; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][h][q] = 0.f;

    for (int ch = 0; ch < chunks; ++ch) {
      const int e0 = ch * g.EC;
      const int ec = min(g.EC, g.E - e0);
      if (!g.resident) stage_weights(w1, w2, w1s, w2s, g, e0, ec, 0);
      cp_async_wait_all();
      __syncthreads();
      const int wc = g.resident ? e0 : 0;  // the chunk's first column in the weight buffers

      // first product: (16 rows x 16 hidden) units, kMaxUnits per warp
      const int units = g.MF * (ec / 16);
#pragma unroll
      for (int i = 0; i < kMaxUnits; ++i) {
        const int u = warp + i * kWarps;
        if (u >= units) break;
        const int um = u % g.MF, un = u / g.MF;
        float h[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        const T* abase = xs + (size_t)(um * 16 + (lane & 15)) * g.XS + (lane >> 4) * 8;
        const T* bbase = w1s + (size_t)((lane & 7) + ((lane >> 3) & 1) * 8) * g.W1S + wc + un * 16 + (lane >> 4) * 8;
        for (int k0 = 0; k0 < g.C; k0 += 16) {
          unsigned a[4], b[4];
          ldsm_x4(a, abase + k0);
          ldsm_x4_trans(b, bbase + (size_t)k0 * g.W1S);
          mma16816(h[0], a, b[0], b[1]);
          mma16816(h[1], a, b[2], b[3]);
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int col = un * 16 + hh * 8 + 2 * tq;  // within the chunk
          const float c0 = __ldg(b1 + e0 + col), c1 = __ldg(b1 + e0 + col + 1);
          const float v0 = gelu_tanh(h[hh][0] + c0), v1 = gelu_tanh(h[hh][1] + c1);
          const float v2 = gelu_tanh(h[hh][2] + c0), v3 = gelu_tanh(h[hh][3] + c1);
          store2(gs + (size_t)(um * 16 + gq) * g.GS + col, v0, v1);
          store2(gs + (size_t)(um * 16 + gq + 8) * g.GS + col, v2, v3);
        }
      }
      __syncthreads();

      // second product: acc += round(h)[:, chunk] @ W2[chunk, :]
      const T* abase = gs + (size_t)(mi * 16 + (lane & 15)) * g.GS + (lane >> 4) * 8;
      const T* bbase = w2s + (size_t)(wc + (lane & 7) + ((lane >> 3) & 1) * 8) * g.W2S + (lane >> 4) * 8;
      for (int k0 = 0; k0 < ec; k0 += 16) {
        unsigned a[4];
        ldsm_x4(a, abase + k0);
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          if (j < np) {
            unsigned b[4];
            ldsm_x4_trans(b, bbase + (size_t)k0 * g.W2S + (wn + j * g.WN) * 16);
            mma16816(acc[j][0], a, b[0], b[1]);
            mma16816(acc[j][1], a, b[2], b[3]);
          }
        }
      }
      __syncthreads();  // the hidden chunk (and streamed weights) are rewritten by the next chunk
    }

    // epilogue: y = acc + b2, out = round(x + y), rows past M not stored
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      if (j >= np) break;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int col = (wn + j * g.WN) * 16 + hh * 8 + 2 * tq;
        const float c0 = __ldg(b2 + col), c1 = __ldg(b2 + col + 1);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = mi * 16 + gq + half * 8;
          if (m0 + r >= g.M) continue;
          const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(xs + (size_t)r * g.XS + col);
          const float y0 = acc[j][hh][2 * half] + c0, y1 = acc[j][hh][2 * half + 1] + c1;
          store2(out + (m0 + r) * g.C + col, __low2float(xv) + y0, __high2float(xv) + y1);
        }
      }
    }
    __syncthreads();  // the x tile is rewritten by the next tile
  }
}

// float32 on the CUDA cores: thread owns hidden values o = tid + j * kThreads
// of a chunk and outputs o = tid + j * kThreads of the tile. Two shared loads
// feed each FMA; the k loops are unrolled by 8 (measured on the H100: 2-15%
// faster than the compiler's own choice at MedNeXt-S's five widths).
__global__ void __launch_bounds__(kThreads)
    mlp_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ w2, const float* __restrict__ b2, float* __restrict__ out, Geom g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout l = layout(g, 4);
  float* xs = reinterpret_cast<float*>(smem + l.x);
  float* w1s = reinterpret_cast<float*>(smem + l.w1);
  float* w2s = reinterpret_cast<float*>(smem + l.w2);
  float* gs = reinterpret_cast<float*>(smem + l.g);
  const int chunks = (g.E + g.EC - 1) / g.EC;
  const int nout = g.BM * g.C;

  if (g.resident) stage_weights(w1, w2, w1s, w2s, g, 0, g.E, 0);

  for (long long t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    const long long m0 = t * g.BM;
    stage_rows(x, xs, g, m0);
    float acc[kMaxOutF32];
#pragma unroll
    for (int j = 0; j < kMaxOutF32; ++j) acc[j] = 0.f;

    for (int ch = 0; ch < chunks; ++ch) {
      const int e0 = ch * g.EC;
      const int ec = min(g.EC, g.E - e0);
      if (!g.resident) stage_weights(w1, w2, w1s, w2s, g, e0, ec, 0);
      cp_async_wait_all();
      __syncthreads();
      const int wc = g.resident ? e0 : 0;
#pragma unroll
      for (int j = 0; j < kMaxHidF32; ++j) {
        const int o = threadIdx.x + j * kThreads;
        if (o >= g.BM * ec) break;
        const int r = o / ec, n = o - r * ec;
        const float* xr = xs + (size_t)r * g.XS;
        float h = 0.f;
#pragma unroll 8
        for (int k = 0; k < g.C; ++k) h = fmaf(xr[k], w1s[(size_t)k * g.W1S + wc + n], h);
        h = gelu_tanh(h + __ldg(b1 + e0 + n));
        gs[(size_t)r * g.GS + n] = h;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kMaxOutF32; ++j) {
        const int o = threadIdx.x + j * kThreads;
        if (o >= nout) break;
        const int r = o / g.C, c = o - r * g.C;
        const float* gr = gs + (size_t)r * g.GS;
        float a = acc[j];
#pragma unroll 8
        for (int k = 0; k < ec; ++k) a = fmaf(gr[k], w2s[(size_t)(wc + k) * g.W2S + c], a);
        acc[j] = a;
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < kMaxOutF32; ++j) {
      const int o = threadIdx.x + j * kThreads;
      if (o >= nout) break;
      const int r = o / g.C, c = o - r * g.C;
      if (m0 + r >= g.M) continue;
      const float y = acc[j] + __ldg(b2 + c);
      out[(m0 + r) * g.C + c] = xs[(size_t)r * g.XS + c] + y;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// pointwise, float32: out (M, Cout) = x (M, C) @ W^T, W (Cout, C)
// ---------------------------------------------------------------------------
//
// Exact f32 on the CUDA cores (no TF32): each output is fmaf(x[k], W[n][k],
// acc) for k = 0 .. C-1 from zero, one rounding a term. Bound at (8 x 112^3
// rows, 32 -> 32): bytes (2.9 GB, 0.86 ms) over FMAs (11.5 G, 0.34 ms).
// - A block owns BN output columns (blockIdx.y) and keeps their weight
//   slice in shared memory, k-major, read as float4.
// - Each warp walks tiles of WM rows on its own, in chunks of BK columns of
//   x: a ring of kPwStages chunks per warp, filled by 16-byte cp.async, so
//   the next chunks' copies are in flight under this chunk's FMAs. No block
//   barrier after the weight is staged.
// - A thread owns 4 rows x 8 columns: per 4 k, 4 float4 loads of x and 8 of
//   the weight feed 128 FMAs. Its rows are ty + i * TYN, so the 8 rows of a
//   load fall on 8 different 16-byte bank groups (row stride BK + 4 floats).
// - Outputs go from registers to memory as float4; rows past M are
//   zero-filled when staged and never stored.

constexpr int kPwThreads = 128;
constexpr int kPwWarps = kPwThreads / 32;
constexpr int kPwStages = 3;

template <int BN, int BK>
struct PwF32 {
  static constexpr int TM = 4, TN = 8;
  static constexpr int TXN = BN / TN;       // threads across the columns
  static constexpr int TYN = 32 / TXN;      // threads down the rows
  static constexpr int WM = TYN * TM;       // rows per warp tile
  static constexpr int XS = BK + 4;         // row stride of a staged chunk (floats)
  static size_t smem(int C) { return (size_t)C * BN * 4 + (size_t)kPwWarps * kPwStages * WM * XS * 4; }
};

template <int BN, int BK>
__global__ void __launch_bounds__(kPwThreads)
    pointwise_f32_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out,
                         long long M, int C, int Cout) {
  using P = PwF32<BN, BK>;
  constexpr int TM = P::TM, TN = P::TN, TYN = P::TYN, WM = P::WM, XS = P::XS;
  constexpr int V = BK / 4;  // 16-byte pieces per staged row
  extern __shared__ __align__(128) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);  // [C][BN]
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  float* xs = ws + (size_t)C * BN + (size_t)warp * kPwStages * WM * XS;
  const int n0 = blockIdx.y * BN;
  for (int i = threadIdx.x; i < C * BN; i += kPwThreads) {
    const int n = i / C, k = i - n * C;
    ws[k * BN + n] = w[(size_t)(n0 + n) * C + k];
  }
  __syncthreads();

  const long long tiles = (M + WM - 1) / WM;
  const long long gw = (long long)blockIdx.x * kPwWarps + warp, nw = (long long)gridDim.x * kPwWarps;
  const long long mine = gw < tiles ? (tiles - gw + nw - 1) / nw : 0;
  const int nk = C / BK;
  const long long total = mine * nk;  // (tile, chunk) stages of this warp

  auto fetch = [&](long long s) {
    const long long m0 = (gw + s / nk * nw) * WM;
    const int k0 = (int)(s % nk) * BK;
    float* dst = xs + (s % kPwStages) * WM * XS;
    for (int i = lane; i < WM * V; i += 32) {
      const int r = i / V, v = i - r * V;
      const bool valid = m0 + r < M;
      cp_async<16>(dst + r * XS + v * 4, x + (valid ? (m0 + r) * C + k0 + v * 4 : 0), valid);
    }
  };

  const int tx = lane % P::TXN, ty = lane / P::TXN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kPwStages - 1; ++s) {
    if (s < total) fetch(s);
    cp_async_commit();
  }
  for (long long s = 0; s < total; ++s) {
    cp_async_wait<kPwStages - 2>();
    __syncwarp();  // every lane's copies of stage s landed; stage s - 1's buffer is free
    if (s + kPwStages - 1 < total) fetch(s + kPwStages - 1);
    cp_async_commit();
    const float* xb = xs + (s % kPwStages) * WM * XS + ty * XS;
    const int kc = (int)(s % nk);
    const float* wk = ws + (size_t)kc * BK * BN + tx * TN;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = *reinterpret_cast<const float4*>(xb + i * TYN * XS + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 w0 = *reinterpret_cast<const float4*>(wk + (kk + u) * BN);
        const float4 w1 = *reinterpret_cast<const float4*>(wk + (kk + u) * BN + 4);
        const float wv[TN] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = u == 0 ? a[i].x : u == 1 ? a[i].y : u == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, wv[j], acc[i][j]);
        }
      }
    }
    if (kc == nk - 1) {
      const long long m0 = (gw + s / nk * nw) * WM;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const long long r = m0 + ty + i * TYN;
        if (r < M) {
          float4* o = reinterpret_cast<float4*>(out + r * Cout + n0 + tx * TN);
          o[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          o[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// pointwise, bfloat16: out (M, Cout) = round(x (M, C) @ W^T), W (Cout, C)
// ---------------------------------------------------------------------------
//
// On the tensor cores (ldmatrix + mma.sync m16n8k16, f32 accumulate, one
// rounding). Bound at (8 x 112^3 rows, 32 -> 32): bytes (1.44 GB, 0.43 ms);
// the products are 0.02 ms of tensor-core time.
// - A block owns up to 64 output columns (blockIdx.y) and stages their
//   (ncols, C) weight rows once. The row-major (Cout, C) weight is the mma B
//   operand's column-major layout, so a non-transposed ldmatrix loads its
//   fragments. Where C <= 16 KS and the block's columns <= 16 NP (KS, NP of
//   2 or 4), every fragment is loaded once into registers and kept for the
//   whole block (KS, NP fixed at compile time, so only the registers needed
//   are held); otherwise (KS = 0) they are read per k-step.
// - Each warp walks 32-row tiles on its own, in chunks of up to 64 columns
//   of x: a ring of kPbStages chunks per warp, filled by 16-byte cp.async, so
//   later tiles' loads are in flight under this tile's MMAs and stores. A
//   persistent grid (SMs x resident blocks); no block barrier after the
//   weight is staged.
// - Epilogue: the accumulators, rounded to bf16 pairs, go to the warp's own
//   shared tile by stmatrix, then out as 16-byte pieces of whole rows.
// - Shared row strides are odd multiples of 16 bytes (conflict-free
//   ldmatrix/stmatrix); rows past M are zero-filled and never stored.

constexpr int kPbThreads = 256;
constexpr int kPbWarps = kPbThreads / 32;
constexpr int kPbStages = 4;
constexpr int kPbRows = 32;   // rows of a warp tile (two 16-row fragments)
constexpr int kPbCols = 64;   // output columns a block owns at most
constexpr int kPbChunk = 64;  // columns of x a stage holds at most

struct PbGeom {
  long long M;
  int C, Cout;
  int NB;        // output columns per block (the last block may hold fewer)
  int KC;        // columns of x per chunk
  int WS, XS, ES;  // row strides (elements): weight rows, staged chunk rows, epilogue rows
};

__host__ __device__ inline size_t pb_weight_bytes(const PbGeom& g) { return (size_t)g.NB * g.WS * 2; }
__host__ __device__ inline size_t pb_warp_bytes(const PbGeom& g) {
  return (size_t)kPbStages * kPbRows * g.XS * 2 + (size_t)kPbRows * g.ES * 2;
}
inline size_t pb_smem(const PbGeom& g) { return pb_weight_bytes(g) + kPbWarps * pb_warp_bytes(g); }

template <int KS, int NP>
__global__ void __launch_bounds__(kPbThreads)
    pointwise_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                          __nv_bfloat16* __restrict__ out, PbGeom g) {
  using T = __nv_bfloat16;
  constexpr bool REG = KS > 0;  // the weight's fragments in registers
  constexpr int MF = kPbRows / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ws = reinterpret_cast<T*>(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  T* xs = reinterpret_cast<T*>(smem + pb_weight_bytes(g) + warp * pb_warp_bytes(g));
  T* es = xs + kPbStages * kPbRows * g.XS;
  const int n0 = blockIdx.y * g.NB;
  const int ncols = min(g.NB, g.Cout - n0);
  const int np = ncols / 16;
  {
    const int vec = g.C / 8;
    for (int i = threadIdx.x; i < ncols * vec; i += kPbThreads) {
      const int n = i / vec, v = i - n * vec;
      cp_async<16>(ws + (size_t)n * g.WS + v * 8, w + (size_t)(n0 + n) * g.C + v * 8, true);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  // B fragments: pair j, k-step ks; lane l addresses row (l & 7) + 8 (l >> 4) of
  // the pair, columns 8 ((l >> 3) & 1) of the k-step
  const T* bbase = ws + (size_t)((lane & 7) + ((lane >> 4) << 3)) * g.WS + ((lane >> 3) & 1) * 8;
  unsigned bfrag[REG ? KS : 1][NP][4];  // [k-step][pair]
  if constexpr (REG) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int j = 0; j < NP; ++j)
        if (ks * 16 < g.C && j < np) ldsm_x4(bfrag[ks][j], bbase + (size_t)j * 16 * g.WS + ks * 16);
  }

  // this warp's (tile, chunk) stages in order: tiles gw, gw + nw, ..., each in nk chunks
  const long long tiles = (g.M + kPbRows - 1) / kPbRows;
  const long long gw = (long long)blockIdx.x * kPbWarps + warp, nw = (long long)gridDim.x * kPbWarps;
  const int nk = (g.C + g.KC - 1) / g.KC;
  const long long total = (gw < tiles ? (tiles - gw + nw - 1) / nw : 0) * nk;
  long long it = gw;  // the next stage to fetch: tile, chunk, buffer
  int ik = 0, ib = 0;
  auto fetch = [&]() {
    const long long m0 = it * kPbRows;
    const int k0 = ik * g.KC;
    const int vec = min(g.KC, g.C - k0) / 8;
    T* dst = xs + ib * kPbRows * g.XS;
    for (int i = lane; i < kPbRows * vec; i += 32) {
      const int r = i / vec, v = i - r * vec;
      const bool valid = m0 + r < g.M;
      cp_async<16>(dst + r * g.XS + v * 8, x + (valid ? (m0 + r) * g.C + k0 + v * 8 : 0), valid);
    }
    if (++ik == nk) ik = 0, it += nw;
    if (++ib == kPbStages) ib = 0;
  };

  float acc[MF][NP][2][4];
#pragma unroll
  for (int f = 0; f < MF; ++f)
#pragma unroll
    for (int j = 0; j < NP; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[f][j][h][q] = 0.f;

#pragma unroll
  for (int s = 0; s < kPbStages - 1; ++s) {
    if (s < total) fetch();
    cp_async_commit();
  }
  const T* arow = xs + (size_t)(lane & 15) * g.XS + (lane >> 4) * 8;
  T* erow = es + (size_t)((lane & 7) + ((lane >> 3) & 1) * 8) * g.ES + (lane >> 4) * 8;  // stmatrix rows
  long long ct = gw;  // the stage computed: tile, chunk, buffer
  int ck = 0, cb = 0;
  for (long long s = 0; s < total; ++s) {
    cp_async_wait<kPbStages - 2>();
    __syncwarp();  // every lane's copies of this stage landed; the last stage's buffer and the epilogue tile are free
    if (s + kPbStages - 1 < total) fetch();
    cp_async_commit();
    const T* ab = arow + cb * kPbRows * g.XS;
    if constexpr (REG) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (ks * 16 >= g.C) break;
#pragma unroll
        for (int f = 0; f < MF; ++f) {
          unsigned a[4];
          ldsm_x4(a, ab + f * 16 * g.XS + ks * 16);
#pragma unroll
          for (int j = 0; j < NP; ++j) {
            if (j < np) {
              mma16816(acc[f][j][0], a, bfrag[ks][j][0], bfrag[ks][j][1]);
              mma16816(acc[f][j][1], a, bfrag[ks][j][2], bfrag[ks][j][3]);
            }
          }
        }
      }
    } else {
      const int k0 = ck * g.KC;
      const int steps = min(g.KC, g.C - k0) / 16;
      for (int ks = 0; ks < steps; ++ks) {
        unsigned a[MF][4];
#pragma unroll
        for (int f = 0; f < MF; ++f) ldsm_x4(a[f], ab + f * 16 * g.XS + ks * 16);
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          if (j < np) {
            unsigned b[4];
            ldsm_x4(b, bbase + (size_t)j * 16 * g.WS + k0 + ks * 16);
#pragma unroll
            for (int f = 0; f < MF; ++f) {
              mma16816(acc[f][j][0], a[f], b[0], b[1]);
              mma16816(acc[f][j][1], a[f], b[2], b[3]);
            }
          }
        }
      }
    }
    if (ck == nk - 1) {
      // stmatrix: matrix q of pair j is rows 8 (q & 1).., columns 16 j + 8 (q >> 1)..
#pragma unroll
      for (int f = 0; f < MF; ++f) {
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          if (j < np) {
            __nv_bfloat162 p[4] = {__floats2bfloat162_rn(acc[f][j][0][0], acc[f][j][0][1]),
                                   __floats2bfloat162_rn(acc[f][j][0][2], acc[f][j][0][3]),
                                   __floats2bfloat162_rn(acc[f][j][1][0], acc[f][j][1][1]),
                                   __floats2bfloat162_rn(acc[f][j][1][2], acc[f][j][1][3])};
            const unsigned* u = reinterpret_cast<const unsigned*>(p);
            stsm_x4(erow + (size_t)f * 16 * g.ES + j * 16, u[0], u[1], u[2], u[3]);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[f][j][h][q] = 0.f;
        }
      }
      __syncwarp();
      const long long m0 = ct * kPbRows;
      const int vec = ncols / 8;
      for (int i = lane; i < kPbRows * vec; i += 32) {
        const int r = i / vec, v = i - r * vec;
        if (m0 + r < g.M)
          *reinterpret_cast<uint4*>(out + (m0 + r) * g.Cout + n0 + v * 8) =
              *reinterpret_cast<const uint4*>(es + (size_t)r * g.ES + v * 8);
      }
    }
    if (++ck == nk) ck = 0, ct += nw;
    if (++cb == kPbStages) cb = 0;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// A shared-memory row stride for ldmatrix: n bf16 values (a multiple of 8)
// widened to an odd multiple of 16 bytes.
inline int odd_stride(int n) { return (n / 8) % 2 ? n : n + 8; }

inline int round_down16(int n) { return n / 16 * 16; }

// Rows per tile, chunk width, and whether the weights stay resident; false
// for a shape the kernel does not take.
inline bool plan(Geom& g, int es) {
  if (g.M < 1 || g.C < 16 || g.E < 16 || g.C % 16 || g.E % 16) return false;
  const bool mma = es == 2;
  int ec_max;
  if (mma) {
    // the most rows whose second-product accumulator fits kMaxPairs pairs a warp
    g.MF = 0;
    for (int mf = kWarps; mf >= 1; mf /= 2) {
      const int wn = kWarps / mf;
      if ((g.C / 16 + wn - 1) / wn <= kMaxPairs) {
        g.MF = mf;
        break;
      }
    }
    if (!g.MF) return false;
    g.WN = kWarps / g.MF;
    g.BM = 16 * g.MF;
    ec_max = kWarps * kMaxUnits * 16 / g.MF;  // units of the first product: MF * EC / 16 <= kWarps * kMaxUnits
  } else {
    if (g.C > kMaxOutF32 * kThreads) return false;
    g.BM = kMaxOutF32 * kThreads / g.C < 64 ? kMaxOutF32 * kThreads / g.C : 64;
    g.MF = g.WN = 0;
    ec_max = round_down16(kMaxHidF32 * kThreads / g.BM);
    if (ec_max < 16) return false;
  }
  g.EC = g.E < ec_max ? g.E : ec_max;
  g.XS = mma ? odd_stride(g.C) : g.C;
  g.W2S = g.XS;
  g.GS = mma ? odd_stride(g.EC) : g.EC;
  // resident weights if they fit beside the tile, else one chunk at a time
  g.resident = 1;
  g.EW = g.E;
  g.W1S = mma ? odd_stride(g.EW) : g.EW;
  if (layout(g, es).total > kMaxSmem) {
    g.resident = 0;
    for (;; g.EC -= 16) {
      if (g.EC < 16) return false;
      g.EW = g.EC;
      g.W1S = mma ? odd_stride(g.EW) : g.EW;
      g.GS = mma ? odd_stride(g.EC) : g.EC;
      if (layout(g, es).total <= kMaxSmem) break;
    }
  }
  g.tiles = (g.M + g.BM - 1) / g.BM;
  return true;
}

template <typename T, typename K>
int launch(K kernel, const Geom& g, cudaStream_t stream, const void* x, const void* w1, const void* b1,
           const void* w2, const void* b2, void* out) {
  const size_t smem = layout(g, (int)sizeof(T)).total;
  int occ = 0;
  const int e = mednext::occupancy(reinterpret_cast<const void*>(kernel), kThreads, smem, &occ);
  if (e) return e;
  if (occ < 1) return kErrShape;
  const long long want = (long long)mednext::sm_count() * occ;
  const unsigned blocks = (unsigned)(g.tiles < want ? g.tiles : want);
  kernel<<<blocks, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w1),
                                             static_cast<const float*>(b1), static_cast<const T*>(w2),
                                             static_cast<const float*>(b2), static_cast<T*>(out), g);
  return (int)cudaGetLastError();
}

// Weight bytes a pointwise block keeps in shared memory at most.
constexpr size_t kPwWeightBytes = 98304;

template <int BN, int BK>
int launch_pw_f32(const void* x, const void* w, void* out, long long M, int C, int Cout, cudaStream_t stream) {
  using P = PwF32<BN, BK>;
  const auto kernel = pointwise_f32_kernel<BN, BK>;
  const size_t smem = P::smem(C);
  if (smem > kMaxSmem) return kErrShape;
  int occ = 0;
  const int e = mednext::occupancy(reinterpret_cast<const void*>(kernel), kPwThreads, smem, &occ);
  if (e) return e;
  if (occ < 1) return kErrShape;
  const int cols = Cout / BN;
  const long long tiles = (M + P::WM - 1) / P::WM;
  const long long want = (tiles + kPwWarps - 1) / kPwWarps;
  long long cap = (long long)mednext::sm_count() * occ / cols;
  if (cap < 1) cap = 1;
  const dim3 grid((unsigned)(want < cap ? want : cap), (unsigned)cols);
  kernel<<<grid, kPwThreads, smem, stream>>>(static_cast<const float*>(x), static_cast<const float*>(w),
                                             static_cast<float*>(out), M, C, Cout);
  return (int)cudaGetLastError();
}

// The widest column block (64, 32 or 16) that divides Cout and whose weight
// slice fits kPwWeightBytes; chunks of 32 columns of x where C allows.
inline int pointwise_f32(const void* x, const void* w, void* out, long long M, int C, int Cout, cudaStream_t stream) {
  const bool bk32 = C % 32 == 0;
  const auto fits = [&](int bn) { return Cout % bn == 0 && (size_t)C * bn * 4 <= kPwWeightBytes; };
  if (fits(64)) return bk32 ? launch_pw_f32<64, 32>(x, w, out, M, C, Cout, stream)
                            : launch_pw_f32<64, 16>(x, w, out, M, C, Cout, stream);
  if (fits(32)) return bk32 ? launch_pw_f32<32, 32>(x, w, out, M, C, Cout, stream)
                            : launch_pw_f32<32, 16>(x, w, out, M, C, Cout, stream);
  if (fits(16)) return launch_pw_f32<16, 16>(x, w, out, M, C, Cout, stream);
  return kErrShape;
}

// Column blocks of at most 64 columns, balanced, whose weight rows fit 64 KB;
// chunks of x of at most 64 columns; the weight in registers where C <= 64.
inline int pointwise_bf16(const void* x, const void* w, void* out, long long M, int C, int Cout,
                          cudaStream_t stream) {
  if (C > 1024) return kErrShape;
  PbGeom g{};
  g.M = M, g.C = C, g.Cout = Cout;
  g.WS = odd_stride(C);
  g.KC = C < kPbChunk ? C : kPbChunk;
  g.XS = odd_stride(g.KC);
  int most = (int)(65536 / ((size_t)g.WS * 2)) / 16 * 16;
  if (most > kPbCols) most = kPbCols;
  if (most < 16) return kErrShape;
  const int blocks_n = (Cout + most - 1) / most;
  g.NB = ((Cout + blocks_n - 1) / blocks_n + 15) / 16 * 16;
  g.ES = odd_stride(g.NB);
  const int cols = (Cout + g.NB - 1) / g.NB;
  const size_t smem = pb_smem(g);
  if (smem > kMaxSmem) return kErrShape;
  const auto kernel = C <= 32 && g.NB <= 32   ? pointwise_bf16_kernel<2, 2>
                      : C <= 64 && g.NB <= 64 ? pointwise_bf16_kernel<4, 4>
                                              : pointwise_bf16_kernel<0, kPbCols / 16>;
  int occ = 0;
  const int e = mednext::occupancy(reinterpret_cast<const void*>(kernel), kPbThreads, smem, &occ);
  if (e) return e;
  if (occ < 1) return kErrShape;
  const long long tiles = (M + kPbRows - 1) / kPbRows;
  const long long want = (tiles + kPbWarps - 1) / kPbWarps;
  long long cap = (long long)mednext::sm_count() * occ / cols;
  if (cap < 1) cap = 1;
  const dim3 grid((unsigned)(want < cap ? want : cap), (unsigned)cols);
  kernel<<<grid, kPbThreads, smem, stream>>>(static_cast<const __nv_bfloat16*>(x),
                                             static_cast<const __nv_bfloat16*>(w),
                                             static_cast<__nv_bfloat16*>(out), g);
  return (int)cudaGetLastError();
}

}  // namespace fmlp

// dtype: 0 = float32, 1 = bfloat16. All pointers 16-byte aligned, rows
// contiguous. Each returns 0 or an error code (a cudaError_t, or 10001 for a
// shape the kernel does not take).
extern "C" {

// The MLP with residual: x (M, C), W1 (C, E), b1 (E,) f32, W2 (E, C), b2 (C,)
// f32, out (M, C).
int fused_mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, void* out,
                  int dtype, long long M, int C, int E, void* stream) {
  using namespace fmlp;
  Geom g{};
  g.M = M, g.C = C, g.E = E;
  const int es = dtype ? 2 : 4;
  if (!plan(g, es)) return kErrShape;
  auto s = static_cast<cudaStream_t>(stream);
  if (!dtype) return launch<float>(mlp_f32_kernel, g, s, x, w1, b1, w2, b2, out);
  using B = __nv_bfloat16;
  const int need = (g.C / 16 + g.WN - 1) / g.WN;
  if (need <= 2) return launch<B>(mlp_bf16_kernel<2>, g, s, x, w1, b1, w2, b2, out);
  if (need <= 4) return launch<B>(mlp_bf16_kernel<4>, g, s, x, w1, b1, w2, b2, out);
  return launch<B>(mlp_bf16_kernel<8>, g, s, x, w1, b1, w2, b2, out);
}

// The pointwise (1x1x1) conv: out (M, Cout) = round(x (M, C) @ w^T) for a
// weight w (Cout, C) in x's type; C and Cout multiples of 16.
int pointwise_fwd(const void* x, const void* w, void* out, int dtype, long long M, int C, int Cout, void* stream) {
  using namespace fmlp;
  if (M < 1 || C < 16 || Cout < 16 || C % 16 || Cout % 16) return kErrShape;
  auto s = static_cast<cudaStream_t>(stream);
  if (!dtype) return pointwise_f32(x, w, out, M, C, Cout, s);
  return pointwise_bf16(x, w, out, M, C, Cout, s);
}

const char* fused_mlp_error_string(int code) {
  if (code == fmlp::kErrShape) return "shape not supported by the fused MLP kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
