// Fused pointwise MLP with residual for Hopper (sm_90a), rows of channels:
//     h   = gelu_tanh(x @ W1 + b1)          f32 accumulate, bias in f32
//     out = round( x + (round_T(h) @ W2 + b2) )   h rounded to x's type first
// x (M, C), W1 (C, E), W2 (E, C), biases f32, out (M, C) in x's type. The
// same tile code, with the second product, bias and GELU left out, computes
// the pointwise (1x1x1) conv out = round(x @ W^T) of a weight W (Cout, C).
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
using mednext::cp_async_wait_all;
using mednext::gelu_tanh;
using mednext::ldsm_x4;
using mednext::ldsm_x4_trans;
using mednext::mma16816;
using mednext::store2;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxUnits = 2;     // bf16: (16 rows x 16 hidden) units of the first product per warp and chunk
constexpr int kMaxPairs = 8;     // bf16: 16-column output pairs per warp in the second product
constexpr int kMaxOutF32 = 32;   // f32: outputs of the second product per thread
constexpr int kMaxHidF32 = 8;    // f32: hidden values of a chunk per thread
constexpr int kErrShape = 10001;
constexpr size_t kMaxSmem = 232448;

enum Mode { kMlp = 0, kPointwise = 1 };

struct Geom {
  long long M;
  int C, E;  // input width; hidden width (pointwise: output width)
  int mode;
  int BM;    // rows per tile
  int MF;    // bf16: 16-row fragments per tile
  int WN;    // bf16: warps per fragment row in the second product (kWarps / MF)
  int EC;    // hidden columns per chunk
  int EW;    // hidden columns held in shared memory (E when resident, else EC)
  int resident;
  int XS, W1S, W2S, GS;   // row strides (elements) of the x tile, W1 (per k), W2 (per e), the hidden chunk
  long long w1_sk, w1_sn; // element (k, n) of W1 sits at w1[k * w1_sk + n * w1_sn]
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
  l.g = l.w2 + (g.mode == kMlp ? align128((size_t)g.EW * g.W2S * es) : 0);
  l.total = l.g + align128((size_t)g.BM * g.GS * es);
  return l;
}

// Stage hidden columns [e0, e0 + ec) of W1 and rows [e0, e0 + ec) of W2 at
// column (row) `at` of their shared-memory buffers. W1 is copied in 16-byte
// pieces where its n stride is 1, element by element otherwise (the
// pointwise weight, (Cout, C), is W1 transposed).
template <typename T>
__device__ __forceinline__ void stage_weights(const T* __restrict__ w1, const T* __restrict__ w2, T* w1s, T* w2s,
                                              const Geom& g, int e0, int ec, int at) {
  constexpr int per = 16 / (int)sizeof(T);
  if (g.w1_sn == 1) {
    const int vec = ec / per;
    for (int i = threadIdx.x; i < g.C * vec; i += kThreads) {
      const int k = i / vec, v = i - k * vec;
      cp_async<16>(w1s + (size_t)k * g.W1S + at + v * per, w1 + k * g.w1_sk + e0 + v * per, true);
    }
  } else {
    for (int i = threadIdx.x; i < g.C * ec; i += kThreads) {
      const int k = i / ec, n = i - k * ec;
      w1s[(size_t)k * g.W1S + at + n] = w1[k * g.w1_sk + (e0 + n) * g.w1_sn];
    }
  }
  if (g.mode == kMlp) {
    const int vec = g.C / per;
    for (int i = threadIdx.x; i < ec * vec; i += kThreads) {
      const int e = i / vec, v = i - e * vec;
      cp_async<16>(w2s + (size_t)(at + e) * g.W2S + v * per, w2 + (size_t)(e0 + e) * g.C + v * per, true);
    }
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

// Pointwise mode: the hidden chunk [e0, e0 + ec), already rounded, is the
// output; copy it to rows m0.. of out in 16-byte pieces.
template <typename T>
__device__ __forceinline__ void store_chunk(const T* gs, T* __restrict__ out, const Geom& g, long long m0, int e0,
                                            int ec) {
  constexpr int per = 16 / (int)sizeof(T);
  const int vec = ec / per;
  for (int i = threadIdx.x; i < g.BM * vec; i += kThreads) {
    const int r = i / vec, v = i - r * vec;
    if (m0 + r < g.M)
      *reinterpret_cast<uint4*>(out + (m0 + r) * g.E + e0 + v * per) =
          *reinterpret_cast<const uint4*>(gs + (size_t)r * g.GS + v * per);
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
          float v0 = h[hh][0], v1 = h[hh][1], v2 = h[hh][2], v3 = h[hh][3];
          if (g.mode == kMlp) {
            const float c0 = __ldg(b1 + e0 + col), c1 = __ldg(b1 + e0 + col + 1);
            v0 = gelu_tanh(v0 + c0), v1 = gelu_tanh(v1 + c1);
            v2 = gelu_tanh(v2 + c0), v3 = gelu_tanh(v3 + c1);
          }
          store2(gs + (size_t)(um * 16 + gq) * g.GS + col, v0, v1);
          store2(gs + (size_t)(um * 16 + gq + 8) * g.GS + col, v2, v3);
        }
      }
      __syncthreads();

      if (g.mode == kPointwise) {
        store_chunk(gs, out, g, m0, e0, ec);
      } else {
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
      }
      __syncthreads();  // the hidden chunk (and streamed weights) are rewritten by the next chunk
    }

    if (g.mode == kMlp) {
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
    }
    __syncthreads();  // the x tile is rewritten by the next tile
  }
}

// float32 on the CUDA cores: thread owns hidden values o = tid + j * kThreads
// of a chunk and outputs o = tid + j * kThreads of the tile.
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
        for (int k = 0; k < g.C; ++k) h = fmaf(xr[k], w1s[(size_t)k * g.W1S + wc + n], h);
        if (g.mode == kMlp) h = gelu_tanh(h + __ldg(b1 + e0 + n));
        gs[(size_t)r * g.GS + n] = h;
      }
      __syncthreads();
      if (g.mode == kPointwise) {
        store_chunk(gs, out, g, m0, e0, ec);
      } else {
#pragma unroll
        for (int j = 0; j < kMaxOutF32; ++j) {
          const int o = threadIdx.x + j * kThreads;
          if (o >= nout) break;
          const int r = o / g.C, c = o - r * g.C;
          const float* gr = gs + (size_t)r * g.GS;
          float a = acc[j];
          for (int k = 0; k < ec; ++k) a = fmaf(gr[k], w2s[(size_t)(wc + k) * g.W2S + c], a);
          acc[j] = a;
        }
      }
      __syncthreads();
    }

    if (g.mode == kMlp) {
#pragma unroll
      for (int j = 0; j < kMaxOutF32; ++j) {
        const int o = threadIdx.x + j * kThreads;
        if (o >= nout) break;
        const int r = o / g.C, c = o - r * g.C;
        if (m0 + r >= g.M) continue;
        const float y = acc[j] + __ldg(b2 + c);
        out[(m0 + r) * g.C + c] = xs[(size_t)r * g.XS + c] + y;
      }
    }
    __syncthreads();
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
      if (g.mode == kPointwise || (g.C / 16 + wn - 1) / wn <= kMaxPairs) {
        g.MF = mf;
        break;
      }
    }
    if (!g.MF) return false;
    g.WN = kWarps / g.MF;
    g.BM = 16 * g.MF;
    ec_max = kWarps * kMaxUnits * 16 / g.MF;  // units of the first product: MF * EC / 16 <= kWarps * kMaxUnits
  } else {
    if (g.mode == kMlp && g.C > kMaxOutF32 * kThreads) return false;
    g.BM = g.mode == kPointwise ? 64 : (kMaxOutF32 * kThreads / g.C < 64 ? kMaxOutF32 * kThreads / g.C : 64);
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
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 132, occ = 1;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1) return kErrShape;
  const long long want = (long long)sms * occ;
  const unsigned blocks = (unsigned)(g.tiles < want ? g.tiles : want);
  kernel<<<blocks, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w1),
                                             static_cast<const float*>(b1), static_cast<const T*>(w2),
                                             static_cast<const float*>(b2), static_cast<T*>(out), g);
  return (int)cudaGetLastError();
}

}  // namespace fmlp

// dtype: 0 = float32, 1 = bfloat16. mode 0: the MLP with residual, x (M, C),
// W1 (C, E) with element (k, n) at w1[k * w1_sk + n * w1_sn], b1 (E,) f32,
// W2 (E, C), b2 (C,) f32, out (M, C). mode 1: the pointwise conv, out (M, E)
// = x @ W1 (b1, w2, b2 unused). All pointers 16-byte aligned, rows
// contiguous. Returns 0 or an error code (a cudaError_t, or 10001 for a
// shape the kernel does not take).
extern "C" {

int fused_mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, void* out,
                  int dtype, long long M, int C, int E, int mode, long long w1_sk, long long w1_sn, void* stream) {
  using namespace fmlp;
  if (mode != kMlp && mode != kPointwise) return kErrShape;
  Geom g{};
  g.M = M, g.C = C, g.E = E, g.mode = mode, g.w1_sk = w1_sk, g.w1_sn = w1_sn;
  const int es = dtype ? 2 : 4;
  if (!plan(g, es)) return kErrShape;
  auto s = static_cast<cudaStream_t>(stream);
  if (!dtype) return launch<float>(mlp_f32_kernel, g, s, x, w1, b1, w2, b2, out);
  using B = __nv_bfloat16;
  const int need = mode == kPointwise ? 1 : (g.C / 16 + g.WN - 1) / g.WN;
  if (need <= 2) return launch<B>(mlp_bf16_kernel<2>, g, s, x, w1, b1, w2, b2, out);
  if (need <= 4) return launch<B>(mlp_bf16_kernel<4>, g, s, x, w1, b1, w2, b2, out);
  return launch<B>(mlp_bf16_kernel<8>, g, s, x, w1, b1, w2, b2, out);
}

const char* fused_mlp_error_string(int code) {
  if (code == fmlp::kErrShape) return "shape not supported by the fused MLP kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
