// Device helpers shared by the port's kernels: type conversion, tanh-GELU,
// the tensor-core fragment helpers (cp.async, ldmatrix, mma.sync) of
// conv3d_3x3.cu and fused_mlp.cu, and the haloed-tile staging + masked
// depthwise 3^3 stencil of the MedNeXt block's float32 apply check path
// (mednext_block.cu; the ring kernels walk the slab ring of ring.cuh).
//
// Layout: activations are channels-last, x[b][v][c] with v = (z*Y + y)*X + x
// the flat voxel index inside one batch element. A tile is T consecutive flat
// voxels [v0, v0+T). Its 3^3 neighbourhood lies inside three contiguous flat
// runs, one per z-offset dz in {-1,0,1}:
//     [v0 + dz*Y*X - X - 1,  v0 + T + dz*Y*X + X + 1)
// or inside nine runs of T + 2 voxels, one per (dz, dy):
//     [v0 + dz*Y*X + dy*X - 1,  v0 + T + dz*Y*X + dy*X + 1)
// whichever is smaller (the nine runs where X > T + 2, so that no row width
// outgrows shared memory). Staging a tile is coalesced copies of those runs
// of C values, issued as asynchronous 16-byte copies (cp.async) so that all
// of them are in flight at once. A run index that falls outside the volume is
// zero-filled; a neighbour that is outside the volume only through y or x
// wrap-around is masked by its coordinates in the stencil, which gives exact
// SAME zero padding.
//
// The stencil works on channel pairs: a thread owns one pair, holds its 54
// taps in registers and walks voxels, kVox at a time, reading two channels
// per load.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

namespace mednext {

constexpr int kThreads = 256;        // threads per block, both kernels
constexpr int kMaxPairsPerThread = 2;  // statistics pass: C <= 4 * kThreads

struct Geom {
  int Z, Y, X, C;
  int N;  // voxels per batch element
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// store two adjacent channels
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// gelu_tanh(v) = 0.5 v (1 + tanh(sqrt(2/pi) (v + 0.044715 v^3))), the form
// flax's nn.gelu computes by default.
__device__ __forceinline__ float gelu_tanh(float v) {
  const float k0 = 0.7978845608028654f;
  const float k1 = 0.044715f;
  return 0.5f * v * (1.f + tanhf(k0 * (v + k1 * v * v * v)));
}

// The same with the hardware's tanh (tanh.approx.f32, relative error below
// 2^-10.9): the bf16 apply pass, which rounds the result to bf16.
__device__ __forceinline__ float gelu_tanh_fast(float v) {
  const float k0 = 0.7978845608028654f;
  const float k1 = 0.044715f;
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(k0 * (v + k1 * v * v * v)));
  return 0.5f * v * (1.f + t);
}

// The halo of a tile: `runs` runs of L voxels; tap (dz, dy, dx) of tile voxel
// t lies in run dz (3 runs) or 3 dz + dy (9 runs) at t + dy * ys + dx.
struct Halo {
  int runs, L, ys;
};

__host__ __device__ __forceinline__ Halo halo_of(int tile, int X) {
  if (3 * (tile + 2 * X + 2) <= 9 * (tile + 2)) return Halo{3, tile + 2 * X + 2, X};
  return Halo{9, tile + 2, 0};
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  const int src_bytes = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem_src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// Close the cp.async copies started since the last commit into one group;
// wait until at most N groups are still in flight.
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Tensor-core fragments (conv3d_3x3.cu, fused_mlp.cu): cp.async copies of
// 4, 8 or 16 bytes, ldmatrix and mma.sync m16n8k16 (bf16 in, f32 accumulate).

template <int N>
__device__ __forceinline__ void cp_async(void* smem_dst, const void* gmem_src, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  const int src_bytes = valid ? N : 0;  // 0: zero-fill
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem_src), "r"(src_bytes));
  } else if constexpr (N == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(gmem_src), "r"(src_bytes));
  } else {
    static_assert(N == 4, "cp.async copies 4, 8 or 16 bytes");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem_src), "r"(src_bytes));
  }
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 (16-byte aligned); register i holds matrix i.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The same four matrices transposed: for B stored k-major (row k, n
// contiguous), lane l gives row k = (l % 8) + 8 * ((l / 8) % 2) at column
// 8 * (l / 16), and register i holds the mma B fragment of (k half i % 2,
// n half i / 2).
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Four 8x8 bf16 matrices to shared memory, the inverse of ldsm_x4: lane l
// gives the address of row l % 8 of matrix l / 8; register i holds row
// l / 4, columns 2 (l % 4) and 2 (l % 4) + 1 of matrix i (the layout of an
// mma accumulator pair).
__device__ __forceinline__ void stsm_x4(void* p, unsigned r0, unsigned r1, unsigned r2, unsigned r3) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "r"(r0), "r"(r1),
               "r"(r2), "r"(r3)
               : "memory");
}

// c[16x8] += a[16x16] . b[16x8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Issue the copies of the runs of tile [v0, v0+tile) (halo_of) into
// halo[runs][L][C]; the caller waits (cp_async_wait_all) and synchronises.
// Requires C * sizeof(T) % 16 == 0 and a 16-byte aligned x.
template <typename T>
__device__ __forceinline__ void stage_halo(const T* __restrict__ xb, T* __restrict__ halo, int v0, int tile,
                                           const Geom& g) {
  const Halo h = halo_of(tile, g.X);
  const int L = h.L;
  constexpr int per = 16 / (int)sizeof(T);  // values per 16-byte copy
  const int vec = g.C / per;
  const int YX = g.Y * g.X;
  const int total = h.runs * L * vec;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int d = i / (L * vec);
    const int rem = i - d * L * vec;
    const int vox = rem / vec;
    const int q = rem - vox * vec;
    const int dz = h.runs == 3 ? d : d / 3, dy = h.runs == 3 ? 0 : d - 3 * dz;
    const int flat = v0 + (dz - 1) * YX + (dy - 1) * g.X - 1 + vox;
    const bool valid = flat >= 0 && flat < g.N;
    cp_async16(halo + (d * L + vox) * g.C + q * per, xb + (valid ? (long long)flat * g.C + q * per : 0), valid);
  }
}

__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// the 27 taps of channels (2p, 2p+1); w is the depthwise kernel in torch
// layout (C, 1, 3, 3, 3) = (C, 27); mirrored (the depthwise conv's input
// gradient), tap i is read from 26 - i
__device__ __forceinline__ void load_taps(float2 (&k)[27], const float* __restrict__ w, int p, bool mirror = false) {
#pragma unroll
  for (int i = 0; i < 27; ++i) {
    const int t = mirror ? 26 - i : i;
    k[i] = make_float2(__ldg(w + (2 * p) * 27 + t), __ldg(w + (2 * p + 1) * 27 + t));
  }
}

// Voxels a thread runs through the stencil at once: independent
// accumulators break the 27-long FMA chain of one voxel.
constexpr int kVox = 4;

// Which of the three z (y, x) offsets of a voxel lie inside the volume, as
// bits 0..2 of a mask; all zero for a voxel past the tile or the volume.
struct TapMask {
  unsigned z, y, x;
};

__device__ __forceinline__ TapMask tap_mask(int t, int v0, int tile, const Geom& g) {
  const int v = v0 + t;
  if (t >= tile || v >= g.N) return TapMask{0u, 0u, 0u};
  const int YX = g.Y * g.X;
  const int z = v / YX;
  const int rem = v - z * YX;
  const int y = rem / g.X;
  const int x = rem - y * g.X;
  return TapMask{2u | (z > 0 ? 1u : 0u) | (z < g.Z - 1 ? 4u : 0u), 2u | (y > 0 ? 1u : 0u) | (y < g.Y - 1 ? 4u : 0u),
                 2u | (x > 0 ? 1u : 0u) | (x < g.X - 1 ? 4u : 0u)};
}

// dw(x) without bias for channel pair p at the kVox tile voxels t[j]: sum
// over each voxel's in-volume taps, f32 accumulate; zero for a masked-out voxel.
template <typename T>
__device__ __forceinline__ void stencil2(const T* __restrict__ halo, const float2 (&k)[27], const int (&t)[kVox],
                                         const TapMask (&m)[kVox], int p, int tile, const Geom& g,
                                         float2 (&acc)[kVox]) {
  const Halo hl = halo_of(tile, g.X);
  const T* h = halo + 2 * p;
#pragma unroll
  for (int j = 0; j < kVox; ++j) acc[j] = make_float2(0.f, 0.f);
#pragma unroll
  for (int dz = 0; dz < 3; ++dz) {
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float2 kk = k[dz * 9 + dy * 3 + dx];
#pragma unroll
        for (int j = 0; j < kVox; ++j) {
          if ((m[j].z >> dz) & (m[j].y >> dy) & (m[j].x >> dx) & 1u) {
            const int run = hl.runs == 3 ? dz : 3 * dz + dy;
            const float2 v = load2(h + (run * hl.L + t[j] + dy * hl.ys + dx) * g.C);
            acc[j].x = fmaf(kk.x, v.x, acc[j].x);
            acc[j].y = fmaf(kk.y, v.y, acc[j].y);
          }
        }
      }
    }
  }
}

// Host side: the SM count of the current device, asked once per device.
inline int sm_count() {
  static std::atomic<int> cache[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  int n = cache[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1) n = 132;
    cache[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

// Host side: resident blocks per SM of kernel `fn` at `threads` threads and
// `smem` bytes of dynamic shared memory, on the current device. A kernel's
// first call on a device lets it take all 232,448 bytes there and prefer
// shared memory to L1 (function attributes are per device); each (device,
// kernel, threads, smem) is asked once and kept. 0, or a cudaError_t.
inline int occupancy(const void* fn, int threads, size_t smem, int* occ) {
  struct Entry {
    int dev;
    const void* fn;
    int threads;
    size_t smem;
    int occ;
  };
  static std::mutex mu;
  static Entry seen[128];
  static int n = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> lock(mu);
  bool set = false;
  for (int i = 0; i < n; ++i) {
    if (seen[i].dev != dev || seen[i].fn != fn) continue;
    set = true;
    if (seen[i].threads == threads && seen[i].smem == smem) {
      *occ = seen[i].occ;
      return 0;
    }
  }
  if (!set) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, fn, threads, smem);
  if (e != cudaSuccess) return (int)e;
  if (n < 128) seen[n++] = Entry{dev, fn, threads, smem, *occ};
  return 0;
}

}  // namespace mednext
