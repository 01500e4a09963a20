// MedNeXt block kernels for Hopper (sm_90a): the fused stride-1 block
//     out = x + W2 . gelu_tanh(W1 . GN(dw(x) + b_dw) + b1) + b2
// over channels-last activations x[b][z][y][x][c], as two passes.
//
// Replaces the TPU kernels of pytorch_connectomics_tpu/ops/fused_block_pallas.py:
//   dw_stats               (:148, body _stats_kernel :126)
//   fused_block_apply_cf   (:238, body _apply_kernel :198; with fold_block_weights :294)
// It ports what they compute, not their lane-padded "CF" layout.
//
// 1. mednext_dw_stats: per-(b, c) [sum dw(x), sum dw(x)^2] over real voxels
//    (dw without bias). These are the GroupNorm statistics of the block.
//    Bound on an H100: it reads x once and does 27 FMAs per value, so it is
//    bound by f32 CUDA-core operations at C = 32 in bf16 (8.2 GFLOP against
//    0.30 GB at batch 16) and by bytes in f32. Design: each block stages the
//    haloed tile in shared memory with cp.async (three coalesced z-runs,
//    mednext_block.cuh), double-buffered across its grid-stride loop of
//    tiles so the next tile's loads overlap this tile's stencil; a thread
//    owns one channel pair and keeps its 54 taps and its sums in registers;
//    the block writes one partial, and a second kernel sums the partials in
//    a fixed order. No atomics, so the result is deterministic; the f32 sums
//    differ from a plain reduction only by summation order.
//
// 2. mednext_block_apply: the whole block for a tile of T voxels. The stencil
//    result is normalised with the per-(b, c) scale/shift folded from the
//    statistics (eps, variance E[t^2] - E[t]^2 clipped at 0; b_dw cancels
//    against the mean) into u[T][C] in shared memory. The hidden dimension R
//    is walked in chunks of Rc: h = gelu_tanh(u . W1[r0:r0+Rc]^T + b1) in
//    shared memory, then acc[T][Cout] += h . W2[:, r0:r0+Rc]^T. The residual
//    (Cout == C) is added and the tile written once. The expanded activation
//    never reaches device memory.
//    Bound on an H100: at stage 0 (C = 32, R = 64) it moves 2 bytes in and
//    2 out per value and does 4*C*R tensor-core FLOP per voxel, so bytes
//    bound it; from C = 128 up the stencil's CUDA-core FMAs and the tensor-
//    core work grow against the bytes. Design: bf16 inputs run both matmuls
//    on tensor cores through WMMA 16x16x16 (bf16 in, f32 accumulate); f32
//    inputs use plain FMAs in f32. The tile T is chosen per C so that
//    T * C ~ 4096 (T = 128 at C = 32 down to 16 at C >= 256), which keeps the
//    haloed tile and the matmul buffers (they share one region) well under
//    the 227 KB a block may use.
//
// Both take f32 or bf16 inputs and accumulate in f32. Weights: w_dw (C, 27)
// f32 (torch's (C, 1, 3, 3, 3)); W1 (R, C) and W2 (Cout, R) in the input
// type (torch Linear layout); gamma, beta, b1, b2 f32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see ops/build.py). Plain C interface for ctypes.

#include <mma.h>

#include <type_traits>

#include "mednext_block.cuh"

namespace mednext {

constexpr int kErrShape = 10001;  // the shape needs more shared memory than a block has
constexpr size_t kMaxSmem = 232448;

__host__ __device__ __forceinline__ size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

// ---------------------------------------------------------------------------
// statistics pass
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    dw_stats_kernel(const T* __restrict__ x, const float* __restrict__ w, float* __restrict__ partial,
                    Geom g, int tile, int tiles, int nbuf) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* buf[2];
  buf[0] = reinterpret_cast<T*>(smem);
  buf[1] = buf[0] + (nbuf > 1 ? 3 * halo_len(tile, g.X) * g.C : 0);
  const int b = blockIdx.y;
  const T* xb = x + (long long)b * g.N * g.C;
  const int cp = g.C / 2;
  const int pt = cp < kThreads ? cp : kThreads;  // threads across channel pairs
  const int tv = kThreads / pt;                  // threads across voxels
  const int tp = threadIdx.x % pt;
  const int tt = threadIdx.x / pt;
  const bool active = tt < tv;
  float2 s[kMaxPairsPerThread], s2[kMaxPairsPerThread];
#pragma unroll
  for (int j = 0; j < kMaxPairsPerThread; ++j) s[j] = s2[j] = make_float2(0.f, 0.f);

  if ((int)blockIdx.x < tiles) stage_halo(xb, buf[0], blockIdx.x * tile, tile, g);
  for (int ti = blockIdx.x, k = 0; ti < tiles; ti += gridDim.x, ++k) {
    cp_async_wait_all();
    __syncthreads();  // tile ti has landed; nobody reads the other buffer any more
    const T* halo = buf[k & (nbuf - 1)];
    const int next = ti + gridDim.x;
    if (nbuf > 1 && next < tiles) stage_halo(xb, buf[(k + 1) & 1], next * tile, tile, g);
    const int v0 = ti * tile;
    if (active) {
#pragma unroll
      for (int j = 0; j < kMaxPairsPerThread; ++j) {
        const int p = tp + j * pt;
        if (p >= cp) break;
        float2 kw[27];
        load_taps(kw, w, p);
        for (int t0 = tt; t0 < tile; t0 += kVox * tv) {
          int t[kVox];
          TapMask m[kVox];
#pragma unroll
          for (int q = 0; q < kVox; ++q) {
            t[q] = t0 + q * tv;
            m[q] = tap_mask(t[q], v0, tile, g);
          }
          float2 a[kVox];
          stencil2(halo, kw, t, m, p, tile, g, a);  // masked-out voxels give 0
#pragma unroll
          for (int q = 0; q < kVox; ++q) {
            s[j].x += a[q].x;
            s[j].y += a[q].y;
            s2[j].x = fmaf(a[q].x, a[q].x, s2[j].x);
            s2[j].y = fmaf(a[q].y, a[q].y, s2[j].y);
          }
        }
      }
    }
    if (nbuf == 1) {
      __syncthreads();
      if (next < tiles) stage_halo(xb, buf[0], next * tile, tile, g);
    }
  }
  // reduce over the voxel threads in a fixed order: red[tt][2][C]
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  if (active) {
#pragma unroll
    for (int j = 0; j < kMaxPairsPerThread; ++j) {
      const int p = tp + j * pt;
      if (p < cp) {
        store2(red + (tt * 2 + 0) * g.C + 2 * p, s[j].x, s[j].y);
        store2(red + (tt * 2 + 1) * g.C + 2 * p, s2[j].x, s2[j].y);
      }
    }
  }
  __syncthreads();
  float* dst = partial + ((long long)b * gridDim.x + blockIdx.x) * 2 * g.C;
  for (int i = threadIdx.x; i < 2 * g.C; i += blockDim.x) {
    const int k = i / g.C, c = i - k * g.C;
    float acc = 0.f;
    for (int r = 0; r < tv; ++r) acc += red[(r * 2 + k) * g.C + c];
    dst[i] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
    stats_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out, int parts, int C) {
  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) {
    float acc = 0.f;
    for (int p = 0; p < parts; ++p) acc += partial[((long long)b * parts + p) * 2 * C + i];
    out[(long long)b * 2 * C + i] = acc;
  }
}

// ---------------------------------------------------------------------------
// apply pass
// ---------------------------------------------------------------------------

// Row strides of the apply kernel's shared-memory matrices, padded 16 bytes
// past the row length so that the 16 rows of
// a WMMA fragment do not fall on the same banks.
struct ApplyLayout {
  int ldu, ldhf, ldh, ldacc;
  size_t scale, u, region, hf, h, acc, total;
};

__host__ __device__ inline ApplyLayout apply_layout(int tile, int X, int C, int Rc, int Cout, int es) {
  ApplyLayout l;
  l.ldu = C + 8;
  l.ldhf = Rc + 4;
  l.ldh = Rc + 8;
  l.ldacc = Cout + 4;
  l.scale = 0;
  l.u = align128(2 * (size_t)C * 4);
  l.region = l.u + align128((size_t)tile * l.ldu * es);
  const size_t halo = align128(3 * (size_t)halo_len(tile, X) * C * es);
  l.hf = l.region;
  l.h = l.hf + align128((size_t)tile * l.ldhf * 4);
  l.acc = l.h + align128((size_t)tile * l.ldh * es);
  const size_t mlp = l.acc + align128((size_t)tile * l.ldacc * 4) - l.region;
  l.total = l.region + (halo > mlp ? halo : mlp);
  return l;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    block_apply_kernel(const T* __restrict__ x, const float* __restrict__ stats,
                       const float* __restrict__ w_dw, const float* __restrict__ gamma,
                       const float* __restrict__ beta, const T* __restrict__ w1,
                       const float* __restrict__ b1, const T* __restrict__ w2,
                       const float* __restrict__ b2, T* __restrict__ out, Geom g, int R, int Rc,
                       int Cout, int tile, float inv_n, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const ApplyLayout l = apply_layout(tile, g.X, g.C, Rc, Cout, (int)sizeof(T));
  float* scale = reinterpret_cast<float*>(smem + l.scale);
  float* shift = scale + g.C;
  T* u = reinterpret_cast<T*>(smem + l.u);
  T* halo = reinterpret_cast<T*>(smem + l.region);
  float* hf = reinterpret_cast<float*>(smem + l.hf);
  T* h = reinterpret_cast<T*>(smem + l.h);
  float* acc = reinterpret_cast<float*>(smem + l.acc);

  const int b = blockIdx.y;
  const int v0 = blockIdx.x * tile;
  const T* xb = x + (long long)b * g.N * g.C;
  const int C = g.C;

  // GroupNorm folded into a per-channel scale/shift of dw(x) (bias cancels)
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float mean = stats[((long long)b * 2 + 0) * C + c] * inv_n;
    const float var = fmaxf(stats[((long long)b * 2 + 1) * C + c] * inv_n - mean * mean, 0.f);
    const float sc = gamma[c] * rsqrtf(var + eps);
    scale[c] = sc;
    shift[c] = beta[c] - mean * sc;
  }
  stage_halo(xb, halo, v0, tile, g);
  cp_async_wait_all();
  __syncthreads();
  {
    const int cp = C / 2;
    const int pt = cp < kThreads ? cp : kThreads;
    const int tv = kThreads / pt;
    const int tt = threadIdx.x / pt;
    if (tt < tv) {
      for (int p = threadIdx.x % pt; p < cp; p += pt) {
        float2 kw[27];
        load_taps(kw, w_dw, p);
        const float2 sc = make_float2(scale[2 * p], scale[2 * p + 1]);
        const float2 sh = make_float2(shift[2 * p], shift[2 * p + 1]);
        for (int t0 = tt; t0 < tile; t0 += kVox * tv) {
          int t[kVox];
          TapMask m[kVox];
#pragma unroll
          for (int q = 0; q < kVox; ++q) {
            t[q] = t0 + q * tv;
            m[q] = tap_mask(t[q], v0, tile, g);
          }
          float2 a[kVox];
          stencil2(halo, kw, t, m, p, tile, g, a);
#pragma unroll
          for (int q = 0; q < kVox; ++q) {
            if (t[q] >= tile) break;
            const bool live = v0 + t[q] < g.N;  // rows past the volume stay 0
            store2(u + t[q] * l.ldu + 2 * p, live ? fmaf(a[q].x, sc.x, sh.x) : 0.f,
                   live ? fmaf(a[q].y, sc.y, sh.y) : 0.f);
          }
        }
      }
    }
  }
  __syncthreads();  // the halo region is reused for the matmul buffers below
  for (int i = threadIdx.x; i < tile * l.ldacc; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int n_warps = blockDim.x / 32;
  for (int r0 = 0; r0 < R; r0 += Rc) {
    // hf[T][Rc] = u[T][C] . W1[r0:r0+Rc, :]^T
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      using namespace nvcuda;
      const int nt = Rc / 16;
      for (int tix = warp; tix < (tile / 16) * nt; tix += n_warps) {
        const int m = tix / nt, n = tix - m * nt;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
        wmma::fill_fragment(fc, 0.f);
        for (int k = 0; k < C; k += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, u + m * 16 * l.ldu + k, l.ldu);
          wmma::load_matrix_sync(fb, w1 + (long long)(r0 + n * 16) * C + k, C);
          wmma::mma_sync(fc, fa, fb, fc);
        }
        wmma::store_matrix_sync(hf + m * 16 * l.ldhf + n * 16, fc, l.ldhf, wmma::mem_row_major);
      }
    } else {
      for (int i = threadIdx.x; i < tile * Rc; i += blockDim.x) {
        const int t = i / Rc, r = i - t * Rc;
        const T* ur = u + t * l.ldu;
        const T* wr = w1 + (long long)(r0 + r) * C;
        float a = 0.f;
        for (int c = 0; c < C; ++c) a = fmaf(to_f32(ur[c]), to_f32(__ldg(wr + c)), a);
        hf[t * l.ldhf + r] = a;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < tile * Rc; i += blockDim.x) {
      const int t = i / Rc, r = i - t * Rc;
      h[t * l.ldh + r] = from_f32<T>(gelu_tanh(hf[t * l.ldhf + r] + __ldg(b1 + r0 + r)));
    }
    __syncthreads();
    // acc[T][Cout] += h[T][Rc] . W2[:, r0:r0+Rc]^T
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      using namespace nvcuda;
      const int nt = Cout / 16;
      for (int tix = warp; tix < (tile / 16) * nt; tix += n_warps) {
        const int m = tix / nt, n = tix - m * nt;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
        wmma::load_matrix_sync(fc, acc + m * 16 * l.ldacc + n * 16, l.ldacc, wmma::mem_row_major);
        for (int k = 0; k < Rc; k += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, h + m * 16 * l.ldh + k, l.ldh);
          wmma::load_matrix_sync(fb, w2 + (long long)(n * 16) * R + r0 + k, R);
          wmma::mma_sync(fc, fa, fb, fc);
        }
        wmma::store_matrix_sync(acc + m * 16 * l.ldacc + n * 16, fc, l.ldacc, wmma::mem_row_major);
      }
    } else {
      for (int i = threadIdx.x; i < tile * Cout; i += blockDim.x) {
        const int t = i / Cout, co = i - t * Cout;
        const T* hr = h + t * l.ldh;
        const T* wr = w2 + (long long)co * R + r0;
        float a = acc[t * l.ldacc + co];
        for (int r = 0; r < Rc; ++r) a = fmaf(to_f32(hr[r]), to_f32(__ldg(wr + r)), a);
        acc[t * l.ldacc + co] = a;
      }
    }
    __syncthreads();
  }

  T* ob = out + (long long)b * g.N * Cout;
  for (int i = threadIdx.x; i < tile * Cout / 2; i += blockDim.x) {
    const int t = (2 * i) / Cout, co = 2 * i - t * Cout;
    const int v = v0 + t;
    if (v >= g.N) continue;
    float o0 = acc[t * l.ldacc + co] + __ldg(b2 + co), o1 = acc[t * l.ldacc + co + 1] + __ldg(b2 + co + 1);
    if (Cout == C) {
      const float2 r = load2(xb + (long long)v * C + co);
      o0 += r.x;
      o1 += r.y;
    }
    store2(ob + (long long)v * Cout + co, o0, o1);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

inline int first_tile(int C) {
  int t = 4096 / C;
  t = t > 128 ? 128 : t;
  t = (t / 16) * 16;
  return t < 16 ? 16 : t;
}

inline size_t stats_smem(int tile, int X, int C, int es, int nbuf) {
  const size_t halo = nbuf * 3 * (size_t)halo_len(tile, X) * C * es;
  const int pt = C / 2 < kThreads ? C / 2 : kThreads;
  const size_t red = (size_t)(kThreads / pt) * 2 * C * 4;
  return halo > red ? halo : red;
}

// tile and buffer count of the statistics pass: double-buffered where two
// tiles fit, else one buffer
inline int stats_tile(int C, int X, int es, int* nbuf) {
  for (int nb = 2; nb >= 1; --nb) {
    int t = first_tile(C);
    while (t > 16 && stats_smem(t, X, C, es, nb) > kMaxSmem) t -= 16;
    if (stats_smem(t, X, C, es, nb) <= kMaxSmem || nb == 1) {
      *nbuf = nb;
      return t;
    }
  }
  return 16;
}

inline int apply_tile(int C, int X, int Rc, int Cout, int es) {
  int t = first_tile(C);
  while (t > 16 && apply_layout(t, X, C, Rc, Cout, es).total > kMaxSmem) t -= 16;
  return t;
}

inline int chunk_of(int R) { return R < 64 ? R : 64; }

inline int stats_grid(int B, long long N, int C, int X, int es) {
  int dev = 0, sms = 132, nbuf = 1;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tile = stats_tile(C, X, es, &nbuf);
  const long long tiles = (N + tile - 1) / tile;
  long long want = (4LL * sms + B - 1) / B;
  if (want < 1) want = 1;
  return (int)(tiles < want ? tiles : want);
}

template <typename K>
inline int set_smem(K kernel, size_t bytes) {
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <typename T>
int run_dw_stats(const void* x, const void* w, void* partial, void* out, int B, int Z, int Y, int X, int C,
                 int parts, cudaStream_t stream) {
  if ((long long)Z * Y * X * C >= (1LL << 31)) return kErrShape;
  const Geom g{Z, Y, X, C, Z * Y * X};
  if (C > 2 * kMaxPairsPerThread * kThreads) return kErrShape;
  const int es = (int)sizeof(T);
  int nbuf = 1;
  const int tile = stats_tile(C, X, es, &nbuf);
  const size_t smem = stats_smem(tile, X, C, es, nbuf);
  if (smem > kMaxSmem) return kErrShape;
  const int tiles = (int)((g.N + tile - 1) / tile);
  int err = set_smem(dw_stats_kernel<T>, smem);
  if (err) return err;
  dw_stats_kernel<T><<<dim3(parts, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<float*>(partial), g, tile, tiles, nbuf);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  stats_reduce_kernel<<<B, kThreads, 0, stream>>>(static_cast<const float*>(partial), static_cast<float*>(out),
                                                    parts, C);
  return (int)cudaGetLastError();
}

template <typename T>
int run_block_apply(const void* x, const void* stats, const void* w_dw, const void* gamma, const void* beta,
                    const void* w1, const void* b1, const void* w2, const void* b2, void* out, int B, int Z,
                    int Y, int X, int C, int R, int Cout, float eps, cudaStream_t stream) {
  if ((long long)Z * Y * X * (C > Cout ? C : Cout) >= (1LL << 31)) return kErrShape;
  const Geom g{Z, Y, X, C, Z * Y * X};
  const int es = (int)sizeof(T);
  const int Rc = chunk_of(R);
  if (R % Rc || Rc % 16 || C % 16 || Cout % 16) return kErrShape;
  const int tile = apply_tile(C, X, Rc, Cout, es);
  const size_t smem = apply_layout(tile, X, C, Rc, Cout, es).total;
  if (smem > kMaxSmem) return kErrShape;
  int err = set_smem(block_apply_kernel<T>, smem);
  if (err) return err;
  const unsigned tiles = (unsigned)((g.N + tile - 1) / tile);
  block_apply_kernel<T><<<dim3(tiles, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(stats), static_cast<const float*>(w_dw),
      static_cast<const float*>(gamma), static_cast<const float*>(beta), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const T*>(w2), static_cast<const float*>(b2),
      static_cast<T*>(out), g, R, Rc, Cout, tile, 1.f / (float)g.N, eps);
  return (int)cudaGetLastError();
}

}  // namespace mednext

// dtype: 0 = float32, 1 = bfloat16. Every entry returns 0 or an error code
// (a cudaError_t, or 10001 for a shape the kernels do not take).
extern "C" {

int mednext_stats_parts(int B, int Z, int Y, int X, int C, int dtype) {
  return mednext::stats_grid(B, (long long)Z * Y * X, C, X, dtype ? 2 : 4);
}

int mednext_dw_stats(const void* x, const void* w_dw, void* partial, void* out, int dtype, int B, int Z, int Y,
                     int X, int C, int parts, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype) return mednext::run_dw_stats<__nv_bfloat16>(x, w_dw, partial, out, B, Z, Y, X, C, parts, s);
  return mednext::run_dw_stats<float>(x, w_dw, partial, out, B, Z, Y, X, C, parts, s);
}

int mednext_block_apply(const void* x, const void* stats, const void* w_dw, const void* gamma, const void* beta,
                        const void* w1, const void* b1, const void* w2, const void* b2, void* out, int dtype,
                        int B, int Z, int Y, int X, int C, int R, int Cout, float eps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype)
    return mednext::run_block_apply<__nv_bfloat16>(x, stats, w_dw, gamma, beta, w1, b1, w2, b2, out, B, Z, Y, X,
                                                   C, R, Cout, eps, s);
  return mednext::run_block_apply<float>(x, stats, w_dw, gamma, beta, w1, b1, w2, b2, out, B, Z, Y, X, C, R,
                                         Cout, eps, s);
}

const char* mednext_error_string(int code) {
  if (code == mednext::kErrShape) return "shape not supported by the MedNeXt block kernels";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
