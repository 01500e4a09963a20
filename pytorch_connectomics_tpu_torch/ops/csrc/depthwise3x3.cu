// Depthwise 3^3 SAME stride-1 convolution for Hopper (sm_90a), forward and
// backward, over channels-last activations x[b][z][y][x][c].
//
// 1. depthwise3x3_fwd: y[b,v,c] = sum_t x[b,v+o_t,c] * w[c,t] + bias[c] with
//    zero padding, f32 accumulation, the bias added in f32 and one rounding
//    to x's type. Replaces the TPU kernel depthwise3x3_pallas of
//    pytorch_connectomics_tpu/ops/depthwise_pallas.py:62 (body _dw_kernel
//    :25). It ports what that kernel computes, not its 128-lane channel pad,
//    its +16 x-pad for DMA or its (8, 8, 64) block. The same kernel computes
//    the input gradient: for SAME stride 1, dx = depthwise(dy, w mirrored in
//    z, y and x, no bias), which the caller launches with the taps mirrored.
//    Bound on an H100: it reads x once and writes y once and does 27 FMAs
//    per value on the CUDA cores: 54 FLOP per 4 bytes moved in bf16 (8 in
//    f32), under the card's 67 TFLOP/s / 3.35 TB/s = 20 FLOP per byte, so
//    the bytes bound it in both types. Design: one block per tile of T
//    consecutive flat voxels; it stages the haloed tile (three z-runs of
//    T + 2X + 2 voxel rows) in shared memory with cp.async
//    (mednext_block.cuh), then each thread owns one channel pair, keeps its
//    54 taps in registers and walks the tile's voxels kVox at a time.
//
// 2. depthwise3x3_wgrad: dw[t,c] = sum_{b,v} x[b,v+o_t,c] * dy[b,v,c] and
//    db[c] = sum_{b,v} dy[b,v,c], in f32, written as f32 (the parameters'
//    type). It has no TPU counterpart: the JAX package differentiates the
//    depthwise conv through XLA. Bound on an H100: it reads x and dy once
//    and does 27 FMAs per pair of values, so like the forward pass the bytes
//    bound it. Design: a grid of `parts` blocks per batch element walks the
//    tiles in a grid-stride loop, staging each x tile with its halo as the
//    forward pass does and reading dy directly; a thread owns one channel
//    pair and keeps its 28 pairs of sums in registers. The block reduces its
//    threads' sums in a fixed order into one partial, and a second kernel
//    sums the partials in a fixed order. No atomics, so two runs on one card
//    give bit-identical gradients.
//
// Types: x, dy, y are float32 or bfloat16; w (C, 27) float32 (torch's
// (C, 1, 3, 3, 3)); bias (C,) float32 or null. C is a multiple of 16 up to
// 512.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see ops/build.py). Plain C interface for ctypes.

#include "mednext_block.cuh"

namespace dwconv {

using namespace mednext;

constexpr int kErrShape = 10001;      // a shape the kernels do not take
constexpr int kMaxC = 2 * kThreads;   // one channel pair per thread
constexpr size_t kTileSmem = 110 * 1024;  // two blocks per SM
constexpr int kRows = 28;              // 27 taps + the bias
constexpr size_t kMaxSmem = 232448;    // what one block may use

__host__ __device__ inline size_t halo_bytes(int tile, int X, int C, int es) {
  return 3 * (size_t)halo_len(tile, X) * C * es;
}

// T consecutive voxels per tile: about 8192 values, at most 256 voxels, a
// multiple of 16, and a haloed tile small enough for two blocks per SM
inline int tile_of(int C, int X, int es) {
  int t = 8192 / C;
  t = t > 256 ? 256 : t;
  t = (t / 16) * 16;
  if (t < 16) t = 16;
  while (t > 16 && halo_bytes(t, X, C, es) > kTileSmem) t -= 16;
  return t;
}

// ---------------------------------------------------------------------------
// forward / input gradient
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    depthwise_kernel(const T* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
                     T* __restrict__ out, Geom g, int tile) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* halo = reinterpret_cast<T*>(smem);
  const int b = blockIdx.y;
  const int v0 = blockIdx.x * tile;
  const T* xb = x + (long long)b * g.N * g.C;
  T* ob = out + (long long)b * g.N * g.C;
  stage_halo(xb, halo, v0, tile, g);
  cp_async_wait_all();
  __syncthreads();
  const int cp = g.C / 2;
  const int pt = cp < kThreads ? cp : kThreads;  // threads across channel pairs
  const int tv = kThreads / pt;                  // threads across voxels
  const int tt = threadIdx.x / pt;
  if (tt >= tv) return;  // no barrier follows
  for (int p = threadIdx.x % pt; p < cp; p += pt) {
    float2 kw[27];
    load_taps(kw, w, p);
    const float2 bb = bias ? make_float2(__ldg(bias + 2 * p), __ldg(bias + 2 * p + 1)) : make_float2(0.f, 0.f);
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
        const int v = v0 + t[q];
        if (t[q] < tile && v < g.N) store2(ob + (long long)v * g.C + 2 * p, a[q].x + bb.x, a[q].y + bb.y);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// weight and bias gradient
// ---------------------------------------------------------------------------

// shared memory: the haloed x tile, reused after the tile loop for the
// block's reduction red[tv][kRows][C] (kThreads * 2 * kRows floats at most)
inline size_t wgrad_smem(int tile, int X, int C, int es) {
  const size_t halo = halo_bytes(tile, X, C, es);
  const size_t red = (size_t)kThreads * 2 * kRows * 4;
  return halo > red ? halo : red;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy, float* __restrict__ partial, Geom g, int tile,
                 int tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* halo = reinterpret_cast<T*>(smem);
  const int b = blockIdx.y;
  const T* xb = x + (long long)b * g.N * g.C;
  const T* dyb = dy + (long long)b * g.N * g.C;
  const int L = halo_len(tile, g.X);
  const int cp = g.C / 2;
  const int pt = cp < kThreads ? cp : kThreads;
  const int tv = kThreads / pt;
  const int tp = threadIdx.x % pt;
  const int tt = threadIdx.x / pt;
  const bool active = tt < tv;
  float2 acc[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) acc[k] = make_float2(0.f, 0.f);

  for (int ti = blockIdx.x; ti < tiles; ti += gridDim.x) {
    const int v0 = ti * tile;
    __syncthreads();  // every thread is done with the previous tile
    stage_halo(xb, halo, v0, tile, g);
    cp_async_wait_all();
    __syncthreads();
    if (!active) continue;
    for (int t = tt; t < tile; t += tv) {
      const int v = v0 + t;
      if (v >= g.N) break;
      const TapMask m = tap_mask(t, v0, tile, g);
      const float2 d = load2(dyb + (long long)v * g.C + 2 * tp);
      acc[27].x += d.x;
      acc[27].y += d.y;
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
#pragma unroll
        for (int dyy = 0; dyy < 3; ++dyy) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            if ((m.z >> dz) & (m.y >> dyy) & (m.x >> dx) & 1u) {
              const float2 xv = load2(halo + (dz * L + t + (dyy - 1) * g.X + dx + g.X) * g.C + 2 * tp);
              const int k = dz * 9 + dyy * 3 + dx;
              acc[k].x = fmaf(xv.x, d.x, acc[k].x);
              acc[k].y = fmaf(xv.y, d.y, acc[k].y);
            }
          }
        }
      }
    }
  }
  // reduce over the voxel threads in a fixed order: red[tt][k][C]
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  if (active) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) store2(red + ((size_t)tt * kRows + k) * g.C + 2 * tp, acc[k].x, acc[k].y);
  }
  __syncthreads();
  float* dst = partial + ((long long)b * gridDim.x + blockIdx.x) * kRows * g.C;
  for (int i = threadIdx.x; i < kRows * g.C; i += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < tv; ++r) s += red[(size_t)r * kRows * g.C + i];
    dst[i] = s;
  }
}

// out[k][c] = sum over the B * parts partials, in order
__global__ void __launch_bounds__(kThreads)
    wgrad_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out, int n_partials, int C) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kRows * C) return;
  float s = 0.f;
  for (int p = 0; p < n_partials; ++p) s += partial[(long long)p * kRows * C + i];
  out[i] = s;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename K>
inline int set_smem(K kernel, size_t bytes) {
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

inline bool shape_ok(int Z, int Y, int X, int C, int es) {
  return (long long)Z * Y * X * C < (1LL << 31) && C % 16 == 0 && C <= kMaxC && (C * es) % 16 == 0;
}

inline int wgrad_parts(int B, long long N, int C, int X, int es) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tile = tile_of(C, X, es);
  const long long tiles = (N + tile - 1) / tile;
  long long want = (4LL * sms + B - 1) / B;
  if (want < 1) want = 1;
  return (int)(tiles < want ? tiles : want);
}

template <typename T>
int run_fwd(const void* x, const void* w, const void* bias, void* out, int B, int Z, int Y, int X, int C,
            cudaStream_t stream) {
  const int es = (int)sizeof(T);
  if (!shape_ok(Z, Y, X, C, es)) return kErrShape;
  const Geom g{Z, Y, X, C, Z * Y * X};
  const int tile = tile_of(C, X, es);
  const size_t smem = halo_bytes(tile, X, C, es);
  if (smem > kMaxSmem) return kErrShape;
  int err = set_smem(depthwise_kernel<T>, smem);
  if (err) return err;
  const unsigned tiles = (unsigned)((g.N + tile - 1) / tile);
  depthwise_kernel<T><<<dim3(tiles, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const float*>(bias), static_cast<T*>(out),
      g, tile);
  return (int)cudaGetLastError();
}

template <typename T>
int run_wgrad(const void* x, const void* dy, void* partial, void* out, int B, int Z, int Y, int X, int C, int parts,
              cudaStream_t stream) {
  const int es = (int)sizeof(T);
  if (!shape_ok(Z, Y, X, C, es) || parts < 1) return kErrShape;
  const Geom g{Z, Y, X, C, Z * Y * X};
  const int tile = tile_of(C, X, es);
  const int tiles = (int)((g.N + tile - 1) / tile);
  const size_t smem = wgrad_smem(tile, X, C, es);
  if (smem > kMaxSmem) return kErrShape;
  int err = set_smem(wgrad_kernel<T>, smem);
  if (err) return err;
  wgrad_kernel<T><<<dim3(parts, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<float*>(partial), g, tile, tiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n = kRows * C;
  wgrad_reduce_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), B * parts, C);
  return (int)cudaGetLastError();
}

}  // namespace dwconv

// dtype: 0 = float32, 1 = bfloat16. Every entry returns 0 or an error code
// (a cudaError_t, or 10001 for a shape the kernels do not take).
extern "C" {

int depthwise3x3_wgrad_parts(int B, int Z, int Y, int X, int C, int dtype) {
  return dwconv::wgrad_parts(B, (long long)Z * Y * X, C, X, dtype ? 2 : 4);
}

int depthwise3x3_fwd(const void* x, const void* w, const void* bias, void* out, int dtype, int B, int Z, int Y,
                     int X, int C, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype) return dwconv::run_fwd<__nv_bfloat16>(x, w, bias, out, B, Z, Y, X, C, s);
  return dwconv::run_fwd<float>(x, w, bias, out, B, Z, Y, X, C, s);
}

int depthwise3x3_wgrad(const void* x, const void* dy, void* partial, void* out, int dtype, int B, int Z, int Y,
                       int X, int C, int parts, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype) return dwconv::run_wgrad<__nv_bfloat16>(x, dy, partial, out, B, Z, Y, X, C, parts, s);
  return dwconv::run_wgrad<float>(x, dy, partial, out, B, Z, Y, X, C, parts, s);
}

const char* depthwise3x3_error_string(int code) {
  if (code == dwconv::kErrShape) return "shape not supported by the depthwise 3^3 kernels";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
