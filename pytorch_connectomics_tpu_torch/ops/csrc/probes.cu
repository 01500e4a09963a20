// Op-level measurement probes for Hopper (sm_90a): three small kernels that
// compute the functions of the TPU probe scripts' Pallas kernels, so that
// the card's own FMA rate and copy bandwidth can be measured through the
// same entry points (pytorch_connectomics_tpu_torch/tools/).
//
// - fma_chain: acc = 0; for i < inner: acc = acc + a * m[i], elementwise,
//   in a's type, m[i] the rounding of 1 + i * 1e-6 to that type. Replaces
//   _fma_kernel of scripts/tpu_vpu_probe.py:44 (pallas_call :58). float32:
//   one fmaf per step (one rounding, which is what the Pallas body gives
//   under XLA, where the multiply and add contract); bfloat16: packed
//   __hfma2 on pairs, one rounding per step (every m[i] is 1.0 in bf16 for
//   inner <= 3907, so a step is bf16(acc + a), as the Pallas body rounds
//   it). The multipliers are read from memory so the compiler cannot fold
//   the chain. Bound: the FMA (or packed bf16 FMA) rate of the CUDA cores.
// - fma27: out = round( sum_{t<27} f32(x) * w[t] ), elementwise, fmaf in
//   tap order. Replaces vpu_kernel of scripts/tpu_microbench.py:163
//   (pallas_call :171). Bound: bytes in bf16 (54 FLOP per 4 bytes moved,
//   below the f32 CUDA-core ridge of 20 FLOP per byte).
// - lane_shift: out[r, i] = x[r, i - offset] along the last axis, either
//   circular (torch.roll) or zero-filled. Replaces the data-movement
//   probes _probe_kernel (copy, roll, slice+pad) and _scratch_kernel of
//   scripts/tpu_bf16_experiments.py:66,87 and _shift_kernel of
//   scripts/tpu_bf16_experiments2.py:68. Offset 0 is a copy: the card's
//   copy-bandwidth probe. Bound: bytes. Every global access is a 16-byte
//   piece, four a thread in flight per loop pass, 32-bit index math where
//   the pieces allow, a grid of the resident blocks (occupancy and SM count
//   asked once). An offset that is not a whole piece builds each output
//   piece in registers from the two aligned source pieces it spans (funnel
//   shifts). A row that is not whole pieces takes a scalar kernel.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see ops/build.py). Plain C interface for ctypes.

#include "mednext_block.cuh"

namespace probes {

constexpr int kThreads = 256;
constexpr int kMaxInner = 4096;
constexpr int kErrShape = 10001;

using mednext::sm_count;

inline unsigned grid_for(long long work) {
  const long long cap = (long long)sm_count() * 16;  // enough resident blocks to fill every SM
  const long long want = (work + kThreads - 1) / kThreads;
  return (unsigned)(want < 1 ? 1 : (want < cap ? want : cap));
}

// A grid of kernel `fn`'s resident blocks (its occupancy, with its static
// shared memory and no dynamic, and the SM count asked once per device), at
// most one a kThreads items: fewer blocks than grid_for's cap where the
// kernel's shared memory or registers limit its residency.
inline int resident_grid(const void* fn, long long items, unsigned* grid) {
  struct Entry {
    int dev;
    const void* fn;
    int occ;
  };
  static std::mutex mu;
  static Entry seen[16];
  static int count = 0;
  int dev = 0, occ = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < count && !occ; ++i)
      if (seen[i].dev == dev && seen[i].fn == fn) occ = seen[i].occ;
    if (!occ) {
      const cudaError_t oe = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, kThreads, 0);
      if (oe != cudaSuccess) return (int)oe;
      if (occ < 1) occ = 1;
      if (count < 16) seen[count++] = Entry{dev, fn, occ};
    }
  }
  const long long want = (items + kThreads - 1) / kThreads;
  const long long cap = (long long)sm_count() * occ;
  *grid = (unsigned)(want < 1 ? 1 : (want < cap ? want : cap));
  return 0;
}

// ---------------------------------------------------------------------------
// fma_chain
// ---------------------------------------------------------------------------

// float32: each thread runs 8 independent chains (two float4 per step).
__global__ void __launch_bounds__(kThreads)
    fma_chain_f32(const float* __restrict__ a, const float* __restrict__ mul, float* __restrict__ out, long long n,
                  int inner) {
  __shared__ __align__(16) float m[kMaxInner];
  for (int i = threadIdx.x; i < inner; i += kThreads) m[i] = mul[i];
  __syncthreads();
  const long long nvec = n / 8;
  for (long long v = blockIdx.x * (long long)kThreads + threadIdx.x; v < nvec; v += (long long)gridDim.x * kThreads) {
    const float4 p = reinterpret_cast<const float4*>(a)[2 * v];
    const float4 q = reinterpret_cast<const float4*>(a)[2 * v + 1];
    float x[8] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    int i = 0;
    for (; i + 4 <= inner; i += 4) {
      const float4 mm = *reinterpret_cast<const float4*>(m + i);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = fmaf(x[j], mm.x, acc[j]);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = fmaf(x[j], mm.y, acc[j]);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = fmaf(x[j], mm.z, acc[j]);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = fmaf(x[j], mm.w, acc[j]);
    }
    for (; i < inner; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = fmaf(x[j], m[i], acc[j]);
    reinterpret_cast<float4*>(out)[2 * v] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    reinterpret_cast<float4*>(out)[2 * v + 1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
  // the tail past the last whole group of 8, one element per thread
  const long long tail = nvec * 8 + blockIdx.x * (long long)kThreads + threadIdx.x;
  if (tail < n) {
    const float x = a[tail];
    float acc = 0.f;
    for (int i = 0; i < inner; ++i) acc = fmaf(x, m[i], acc);
    out[tail] = acc;
  }
}

// bfloat16: each thread runs 16 values as 8 packed pairs (two uint4 per step).
__global__ void __launch_bounds__(kThreads)
    fma_chain_bf16(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ mul,
                   __nv_bfloat16* __restrict__ out, long long n, int inner) {
  __shared__ __align__(16) __nv_bfloat162 m[kMaxInner];
  for (int i = threadIdx.x; i < inner; i += kThreads) m[i] = __bfloat162bfloat162(mul[i]);
  __syncthreads();
  const long long nvec = n / 16;
  for (long long v = blockIdx.x * (long long)kThreads + threadIdx.x; v < nvec; v += (long long)gridDim.x * kThreads) {
    __nv_bfloat162 x[8], acc[8];
    const uint4 p = reinterpret_cast<const uint4*>(a)[2 * v];
    const uint4 q = reinterpret_cast<const uint4*>(a)[2 * v + 1];
    const unsigned raw[8] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      x[j] = *reinterpret_cast<const __nv_bfloat162*>(&raw[j]);
      acc[j] = __float2bfloat162_rn(0.f);
    }
    int i = 0;
    for (; i + 4 <= inner; i += 4) {
      const uint4 mm = *reinterpret_cast<const uint4*>(m + i);
      const unsigned mr[4] = {mm.x, mm.y, mm.z, mm.w};
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const __nv_bfloat162 ms = *reinterpret_cast<const __nv_bfloat162*>(&mr[s]);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = __hfma2(x[j], ms, acc[j]);
      }
    }
    for (; i < inner; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = __hfma2(x[j], m[i], acc[j]);
    unsigned o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = *reinterpret_cast<const unsigned*>(&acc[j]);
    reinterpret_cast<uint4*>(out)[2 * v] = make_uint4(o[0], o[1], o[2], o[3]);
    reinterpret_cast<uint4*>(out)[2 * v + 1] = make_uint4(o[4], o[5], o[6], o[7]);
  }
  const long long tail = nvec * 16 + blockIdx.x * (long long)kThreads + threadIdx.x;
  if (tail < n) {
    const __nv_bfloat16 x = a[tail];
    __nv_bfloat16 acc = __float2bfloat16(0.f);
    for (int i = 0; i < inner; ++i) acc = __hfma(x, m[i].x, acc);
    out[tail] = acc;
  }
}

// ---------------------------------------------------------------------------
// fma27
// ---------------------------------------------------------------------------

// Each thread takes 8 consecutive values (16 bytes in bf16, 32 in f32).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fma27_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out, long long n) {
  float wt[27];
#pragma unroll
  for (int t = 0; t < 27; ++t) wt[t] = __ldg(w + t);
  const long long nvec = n / 8;
  for (long long v = blockIdx.x * (long long)kThreads + threadIdx.x; v < nvec; v += (long long)gridDim.x * kThreads) {
    float xv[8];
    if constexpr (sizeof(T) == 2) {
      const uint4 p = reinterpret_cast<const uint4*>(x)[v];
      const unsigned raw[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw[j]));
        xv[2 * j] = f.x, xv[2 * j + 1] = f.y;
      }
    } else {
      const float4 p = reinterpret_cast<const float4*>(x)[2 * v];
      const float4 q = reinterpret_cast<const float4*>(x)[2 * v + 1];
      xv[0] = p.x, xv[1] = p.y, xv[2] = p.z, xv[3] = p.w, xv[4] = q.x, xv[5] = q.y, xv[6] = q.z, xv[7] = q.w;
    }
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int t = 0; t < 27; ++t)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = fmaf(xv[j], wt[t], acc[j]);
#pragma unroll
    for (int j = 0; j < 8; j += 2) mednext::store2(out + 8 * v + j, acc[j], acc[j + 1]);
  }
  const long long tail = nvec * 8 + blockIdx.x * (long long)kThreads + threadIdx.x;
  if (tail < n) {
    const float xv = mednext::to_f32(x[tail]);
    float acc = 0.f;
    for (int t = 0; t < 27; ++t) acc = fmaf(xv, wt[t], acc);
    out[tail] = mednext::from_f32<T>(acc);
  }
}

// ---------------------------------------------------------------------------
// lane_shift
// ---------------------------------------------------------------------------

// Source column of output column i, or -1 where the zero fill applies.
__device__ __forceinline__ int src_col(int i, int F, int offset, bool circular) {
  int s = i - offset;
  if (circular) {
    s %= F;
    return s < 0 ? s + F : s;
  }
  return s >= 0 && s < F ? s : -1;
}

// F a multiple of the 16-byte piece: rows of `pieces` pieces. Output piece
// p of a row takes its values from source pieces p - q - 1 (its last S
// values) and p - q (its first per - S values), for an offset of q pieces
// and S values; S == 0 takes piece p - q whole. Source pieces wrap around
// the row (circular) or read as zero (zero fill) past its ends: the pieces
// tile the row, so a piece is wholly inside it or wholly outside.
constexpr int kUnroll = 4;  // pieces a thread moves per loop pass, all loads before the stores

__device__ __forceinline__ uint4 load_piece(const uint4* p) { return __ldg(p); }
__device__ __forceinline__ void store_piece(uint4* p, uint4 v) { *p = v; }

__device__ __forceinline__ int src_piece(int s, int pieces, int circular) {
  if (circular) return s < 0 ? s + pieces : (s >= pieces ? s - pieces : s);
  return s >= 0 && s < pieces ? s : -1;
}

// The 16 bytes starting SB bytes before the end of `lo`: lo's last SB bytes,
// then hi's first 16 - SB, as funnel shifts of 32-bit words.
template <int SB>
__device__ __forceinline__ uint4 splice(uint4 lo, uint4 hi) {
  const unsigned w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  constexpr int start = 16 - SB, sw = start / 4, bs = start % 4;
  unsigned o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (bs == 0)
      o[k] = w[sw + k];
    else
      o[k] = __funnelshift_r(w[sw + k], w[sw + k + 1], 8 * bs);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// FLAT: the copy (q == 0, S == 0), one flat run of pieces. I: the index
// type, 32-bit where the piece count allows.
template <int SB, bool FLAT, typename I>
__global__ void __launch_bounds__(kThreads)
    shift_pieces(const uint4* __restrict__ x, uint4* __restrict__ out, I total, int pieces, int q, int circular) {
  const I stride = (I)gridDim.x * (kThreads * kUnroll);
  for (I base = (I)blockIdx.x * (kThreads * kUnroll) + threadIdx.x; base < total; base += stride) {
    uint4 lo[kUnroll], hi[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const I v = base + (I)(j * kThreads);
      lo[j] = hi[j] = make_uint4(0u, 0u, 0u, 0u);
      if (v >= total) continue;
      if constexpr (FLAT) {
        hi[j] = load_piece(x + v);
      } else {
        const I r = v / (I)pieces;
        const int p = (int)(v - r * (I)pieces);
        const uint4* row = x + r * (I)pieces;
        const int b = src_piece(p - q, pieces, circular);
        if (b >= 0) hi[j] = load_piece(row + b);
        if constexpr (SB != 0) {
          const int a = src_piece(p - q - 1, pieces, circular);
          if (a >= 0) lo[j] = load_piece(row + a);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const I v = base + (I)(j * kThreads);
      if (v >= total) continue;
      if constexpr (SB == 0)
        store_piece(out + v, hi[j]);
      else
        store_piece(out + v, splice<SB>(lo[j], hi[j]));
    }
  }
}

// Any F: one value per thread.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    shift_scalar(const T* __restrict__ x, T* __restrict__ out, long long rows, int F, int offset, int circular) {
  const long long total = rows * F;
  for (long long v = blockIdx.x * (long long)kThreads + threadIdx.x; v < total; v += (long long)gridDim.x * kThreads) {
    const long long r = v / F;
    const int i = (int)(v - r * F);
    const int s = src_col(i, F, offset, circular);
    out[v] = s < 0 ? mednext::from_f32<T>(0.f) : x[r * F + s];
  }
}

// A grid of the resident blocks of one shift_pieces instantiation.
template <int SB, bool FLAT, typename I>
int launch_pieces(const void* x, void* out, I total, int pieces, int q, int circular, cudaStream_t stream) {
  int occ = 0;
  const int e = mednext::occupancy(reinterpret_cast<const void*>(shift_pieces<SB, FLAT, I>), kThreads, 0, &occ);
  if (e != 0) return e;
  if (occ < 1) occ = 1;
  const long long want = ((long long)total + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  const long long cap = (long long)sm_count() * occ;
  const unsigned grid = (unsigned)(want < cap ? want : cap);
  shift_pieces<SB, FLAT, I><<<grid, kThreads, 0, stream>>>(static_cast<const uint4*>(x), static_cast<uint4*>(out),
                                                            total, pieces, q, circular);
  return (int)cudaGetLastError();
}

template <typename I, int ES, int S = 0>
int dispatch_pieces(int s, const void* x, void* out, I total, int pieces, int q, int circular, cudaStream_t stream) {
  if constexpr (S * ES < 16) {
    if (s != S) return dispatch_pieces<I, ES, S + 1>(s, x, out, total, pieces, q, circular, stream);
    if constexpr (S == 0) {
      if (q == 0) return launch_pieces<0, true, I>(x, out, total, pieces, q, circular, stream);
    }
    return launch_pieces<S * ES, false, I>(x, out, total, pieces, q, circular, stream);
  } else {
    return kErrShape;
  }
}

template <typename T>
int shift(const void* x, void* out, long long rows, int F, int offset, int circular, cudaStream_t stream) {
  constexpr int per = 16 / (int)sizeof(T);
  if (F % per != 0) {
    shift_scalar<T><<<grid_for(rows * F), kThreads, 0, stream>>>(static_cast<const T*>(x), static_cast<T*>(out), rows,
                                                                 F, offset, circular);
    return (int)cudaGetLastError();
  }
  const int pieces = F / per;
  const int q = offset >= 0 ? offset / per : -((-offset + per - 1) / per);  // floor(offset / per)
  const int s = offset - q * per;                                            // 0 <= s < per
  const long long total = rows * pieces;
  if (total < (1ll << 31))
    return dispatch_pieces<unsigned, (int)sizeof(T)>(s, x, out, (unsigned)total, pieces, q, circular, stream);
  return dispatch_pieces<unsigned long long, (int)sizeof(T)>(s, x, out, (unsigned long long)total, pieces, q, circular,
                                                            stream);
}

}  // namespace probes

// dtype: 0 = float32, 1 = bfloat16. Pointers 16-byte aligned, tensors
// contiguous. Returns 0 or an error code (a cudaError_t, or 10001 for
// arguments the kernels do not take).
extern "C" {

// a, out: n values; mul: inner multipliers in a's type
int probes_fma_chain(const void* a, const void* mul, void* out, int dtype, long long n, int inner, void* stream) {
  using namespace probes;
  if (n < 1 || inner < 1 || inner > kMaxInner) return kErrShape;
  auto s = static_cast<cudaStream_t>(stream);
  unsigned grid = 0;
  const int e = resident_grid(dtype ? reinterpret_cast<const void*>(fma_chain_bf16)
                                    : reinterpret_cast<const void*>(fma_chain_f32),
                              n / (dtype ? 16 : 8) + 1, &grid);
  if (e != 0) return e;
  if (dtype)
    fma_chain_bf16<<<grid, kThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(a),
                                             static_cast<const __nv_bfloat16*>(mul), static_cast<__nv_bfloat16*>(out),
                                             n, inner);
  else
    fma_chain_f32<<<grid, kThreads, 0, s>>>(static_cast<const float*>(a), static_cast<const float*>(mul),
                                            static_cast<float*>(out), n, inner);
  return (int)cudaGetLastError();
}

// x, out: n values; w: 27 float32 taps
int probes_fma27(const void* x, const void* w, void* out, int dtype, long long n, void* stream) {
  using namespace probes;
  if (n < 1) return kErrShape;
  auto s = static_cast<cudaStream_t>(stream);
  unsigned grid = 0;
  const int e = resident_grid(dtype ? reinterpret_cast<const void*>(fma27_kernel<__nv_bfloat16>)
                                    : reinterpret_cast<const void*>(fma27_kernel<float>),
                              n / 8 + 1, &grid);
  if (e != 0) return e;
  if (dtype)
    fma27_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                          static_cast<const float*>(w),
                                                          static_cast<__nv_bfloat16*>(out), n);
  else
    fma27_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(x), static_cast<const float*>(w),
                                                  static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}

// x, out: (rows, F)
int probes_lane_shift(const void* x, void* out, int dtype, long long rows, int F, int offset, int circular,
                      void* stream) {
  using namespace probes;
  if (rows < 1 || F < 1) return kErrShape;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? shift<__nv_bfloat16>(x, out, rows, F, offset, circular, s)
               : shift<float>(x, out, rows, F, offset, circular, s);
}

const char* probes_error_string(int code) {
  if (code == probes::kErrShape) return "arguments not supported by the probe kernels";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
