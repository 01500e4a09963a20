// Device helpers shared by the port's kernels: type conversion, tanh-GELU,
// the tensor-core fragment helpers (cp.async, ldmatrix, mma.sync) of
// conv3d_3x3.cu and fused_mlp.cu, the depthwise 3^3 taps of the ring
// kernels, and the types of the MedNeXt block's float32 apply check path
// (mednext_block.cu, which stages its haloed tiles and runs its masked
// stencil; the ring kernels walk the slab ring of ring.cuh).
//
// Layout: activations are channels-last, x[b][v][c] with v = (z*Y + y)*X + x
// the flat voxel index inside one batch element.
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

// The halo of a tile of the float32 apply pass (halo_of of mednext_block.cu):
// `runs` runs of L voxels; tap (dz, dy, dx) of tile voxel t lies in run dz
// (K runs) or K dz + dy (K^2 runs) at t + dy * ys + dx.
struct Halo {
  int runs, L, ys;
};

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

// Voxels a thread runs through the float32 apply's stencil at once:
// independent accumulators break the K^3-long FMA chain of one voxel.
constexpr int kVox = 4;

// Which of the K z (y, x) offsets of a voxel lie inside the volume, as bits
// 0..K-1 of a mask (the float32 apply pass's tap_mask).
struct TapMask {
  unsigned z, y, x;
};

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
