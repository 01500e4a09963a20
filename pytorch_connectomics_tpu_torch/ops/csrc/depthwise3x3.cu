// Depthwise 3^3 SAME stride-1 convolution for Hopper (sm_90a), forward and
// backward, over channels-last activations x[b][z][y][x][c].
//
// 1. depthwise3x3_fwd: y[b,v,c] = sum_t x[b,v+o_t,c] * w[c,t] + bias[c] with
//    zero padding, f32 accumulation, the bias added in f32 and one rounding
//    to x's type. Replaces the TPU kernel depthwise3x3_pallas of
//    pytorch_connectomics_tpu/ops/depthwise_pallas.py:62 (body _dw_kernel
//    :29). It ports what that kernel computes, not its 128-lane channel pad,
//    its +16 x-pad for DMA or its (8, 8, 64) block. The same kernel computes
//    the input gradient: for SAME stride 1, dx = depthwise(dy, w mirrored in
//    z, y and x, no bias); the mirror flag reads tap 26 - t for tap t.
//    Bound on an H100: it reads x once and writes y once and does 27 FMAs
//    per value on the CUDA cores: 54 FLOP per 4 bytes moved in bf16 (8 in
//    f32), under the card's 67 TFLOP/s / 3.35 TB/s = 20 FLOP per byte, so
//    the bytes bound it in both types, though in bf16 the FMAs come close.
//
// 2. depthwise3x3_wgrad: dw[t,c] = sum_{b,v} x[b,v+o_t,c] * dy[b,v,c] and
//    db[c] = sum_{b,v} dy[b,v,c], in f32, written as f32 (the parameters'
//    type). It has no TPU counterpart: the JAX package differentiates the
//    depthwise conv through XLA. Bound on an H100: it reads x and dy once
//    and does 27 FMAs per pair of values, so like the forward pass the bytes
//    bound it.
//
// Design: both kernels walk the z-marching slab ring of ring.cuh with the
// numbers ops/depthwise.py::kernel_plan picks per shape (band rows ty,
// segment seg, 3 or 4 ring slots). Persistent blocks take the work items
// (b, band, segment) in turn; the next slab arrives by cp.async under the
// current slab's stencil; slabs are zero-filled outside the volume, so no
// tap is masked. A thread owns one channel pair (C <= 512) and runs of three
// x outputs of a band row, with the pair's 54 taps in registers for all of
// its block's items.
// - The forward runs ring.cuh's stencil_band (two runs at a time, 15 shared
//   loads per three outputs), adds the bias, rounds once and stores each
//   output pair.
// - The weight gradient also stages the slab of dy at the band's outputs
//   (zero outside the volume) into a second ring (two slots beside four x
//   slots, where dy slab z + 1 is staged under the stencil of z; one beside
//   three, where it is staged after it, as x slab z + 2 is). A thread
//   holds its run's three dy pairs in registers; each (dz, dy) row of five
//   x voxels it loads feeds 9 FMAs (3 dx taps x 3 outputs) of its 27 + 1
//   pairs of sums, which stay in registers for the whole item. Each item
//   writes one partial: the run slots' sums added in slot order (through
//   shared memory that aliases the ring once the item is done). A second
//   kernel sums the partials in a fixed order (32 interleaved sums over the
//   items, then those 32 in order). No atomics, and the partials do
//   not depend on the grid, so every launch gives bit-identical gradients.
//
// Types: x, dy, y are float32 or bfloat16; w (C, 27) float32 (torch's
// (C, 1, 3, 3, 3)); bias (C,) float32 or null. C is a multiple of 16 up to
// 512.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see ops/build.py). Plain C interface for ctypes.

#include "ring.cuh"

namespace dwconv {

using namespace mednext;
using bf16 = __nv_bfloat16;

constexpr int kErrShape = 10001;     // a shape or plan the kernels do not take
constexpr int kMaxC = 2 * kThreads;  // one channel pair per thread
constexpr int kRows = 28;            // 27 taps + the bias
constexpr size_t kMaxSmem = 232448;  // what one block may use

// ---------------------------------------------------------------------------
// forward / input gradient
// ---------------------------------------------------------------------------

inline size_t fwd_smem(const Ring& g, int es) { return align128(g.nr * slab_elems(g) * es); }

template <typename T, int CT>
__global__ void __launch_bounds__(kThreads, 2)
    ring_dw_kernel(const T* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
                   T* __restrict__ out, Ring g, int mirror) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = CT ? CT : g.C;
  const size_t slab = slab_elems(g);
  T* ring = reinterpret_cast<T*>(smem);
  const Lanes ln = lanes_of(C);
  const int p = ln.p0;  // C <= 512: one channel pair a thread
  float2 kw[27];
  float2 bb = make_float2(0.f, 0.f);
  if (ln.active) {
    load_taps(kw, w, p, mirror != 0);
    if (bias) bb = make_float2(__ldg(bias + 2 * p), __ldg(bias + 2 * p + 1));
  }

  for (int item = blockIdx.x; item < g.items; item += gridDim.x) {
    int b, y0, z0, z1;
    item_origin(g, item, b, y0, z0, z1);
    const long long vol = (long long)g.Z * g.Y * g.X * C;
    const T* xb = x + b * vol;
    const int yv = min(g.ty, g.Y - y0);  // rows of the band inside the volume
    __syncthreads();  // the last item's stencil is done with the ring
    // slab z lives in slot (z - z0 + 1) % nr
    for (int d = 0; d < 3; ++d) stage_slab<T, CT>(xb, ring + d * slab, z0 - 1 + d, y0, g);
    cp_async_commit();
    for (int z = z0; z < z1; ++z) {
      cp_async_wait<0>();
      __syncthreads();  // slab z + 1 has landed; with four slots, slab z - 2's slot is free
      if (g.nr == 4 && z + 2 <= z1) stage_slab<T, CT>(xb, ring + ((z + 3 - z0) % 4) * slab, z + 2, y0, g);
      cp_async_commit();
      const T* s0 = ring + ((z - z0) % g.nr) * slab;
      const T* s1 = ring + ((z - z0 + 1) % g.nr) * slab;
      const T* s2 = ring + ((z - z0 + 2) % g.nr) * slab;
      if (ln.active) {
        T* ob = out + b * vol + (((long long)z * g.Y + y0) * g.X) * C + 2 * p;
        stencil_band<T, CT>(s0, s1, s2, p, ln, g, C, kw, [&](int ry, int rx, const float2(&a)[kRun]) {
          if (ry < yv) {
#pragma unroll
            for (int q = 0; q < kRun; ++q) {
              const int xx = kRun * rx + q;
              if (xx < g.X) store2(ob + ((long long)ry * g.X + xx) * C, a[q].x + bb.x, a[q].y + bb.y);
            }
          }
        });
      }
      if (g.nr == 3) {
        __syncthreads();  // slab z - 1's slot is free
        if (z + 2 <= z1) stage_slab<T, CT>(xb, ring + ((z + 3 - z0) % 3) * slab, z + 2, y0, g);
        cp_async_commit();
      }
    }
  }
}

// ---------------------------------------------------------------------------
// weight and bias gradient
// ---------------------------------------------------------------------------

// voxels of a dy slab row: the band row's runs of three
__host__ __device__ __forceinline__ int dy_row(const Ring& g) { return kRun * g.nrx; }

// slots of the dy ring: 2 beside four x slots, 1 beside three
__host__ __device__ __forceinline__ int dy_slots(const Ring& g) { return g.nr - 2; }

// Shared memory of the weight gradient: the x ring, then the dy ring of
// dy_slots slabs [ty][3 nrx][C]; once an item is done, its run slots' sums
// red[tv][kRows][C] (float) alias the start of it. red is not needed when
// one slot covers the band (tv == 1: C > 256, where the threads past the
// C / 2 pairs are inactive).
struct WgradLayout {
  size_t dy, red, total;
};

__host__ __device__ inline WgradLayout wgrad_layout(const Ring& g, int es) {
  WgradLayout l;
  l.dy = align128(g.nr * slab_elems(g) * es);
  const size_t dyslab = (size_t)g.ty * dy_row(g) * g.C;
  const int pt = g.C / 2 < kThreads ? g.C / 2 : kThreads;
  const int tv = kThreads / pt;
  l.red = tv > 1 ? align128((size_t)tv * kRows * g.C * 4) : 0;
  const size_t rings = l.dy + align128(dy_slots(g) * dyslab * es);
  l.total = rings > l.red ? rings : l.red;
  return l;
}

// Issue the copies of dy at slab z's band outputs into dst[ty][3 nrx][C]:
// voxel (y0 + yy, xx), zero where it lies outside the volume.
template <typename T, int CT>
__device__ __forceinline__ void stage_dy(const T* __restrict__ db, T* __restrict__ dst, int z, int y0,
                                         const Ring& g) {
  constexpr int per = 16 / (int)sizeof(T);
  const int C = CT ? CT : g.C;
  const int vec = C / per;
  const int row = dy_row(g) * vec;
  const int total = g.ty * row;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int yy = i / row, rem = i - yy * row;
    const int xx = rem / vec, q = rem - xx * vec;
    const int y = y0 + yy;
    const bool valid = y < g.Y && xx < g.X;
    const T* src = valid ? db + (((long long)z * g.Y + y) * g.X + xx) * C + q * per : db;
    cp_async16(dst + (size_t)i * per, src, valid);
  }
}

// One run's contribution to the sums: d[j] the dy pair at the run's three
// outputs; x from the three slabs at rows ry .. ry + 2, voxels 3 rx .. 3 rx + 4.
template <typename T, int CT>
__device__ __forceinline__ void wgrad_run(const T* s0, const T* s1, const T* s2, int at, int rowlen, int C_,
                                          const float2 (&d)[kRun], float2 (&acc)[kRows]) {
  const int C = CT ? CT : C_;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    acc[27].x += d[j].x;
    acc[27].y += d[j].y;
  }
#pragma unroll
  for (int dz = 0; dz < 3; ++dz) {
    const T* s = dz == 0 ? s0 : dz == 1 ? s1 : s2;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      float2 v[kRun + 2];
#pragma unroll
      for (int i = 0; i < kRun + 2; ++i) v[i] = load2(s + at + dy * rowlen + i * C);
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float2& a = acc[dz * 9 + dy * 3 + dx];
#pragma unroll
        for (int j = 0; j < kRun; ++j) {
          a.x = fmaf(v[j + dx].x, d[j].x, a.x);
          a.y = fmaf(v[j + dx].y, d[j].y, a.y);
        }
      }
    }
  }
}

template <typename T, int CT>
__global__ void __launch_bounds__(kThreads, 2)
    ring_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy, float* __restrict__ partial, Ring g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int es = (int)sizeof(T);
  const int C = CT ? CT : g.C;
  const size_t slab = slab_elems(g);
  const WgradLayout l = wgrad_layout(g, es);
  T* ring = reinterpret_cast<T*>(smem);
  T* dring = reinterpret_cast<T*>(smem + l.dy);
  float* red = reinterpret_cast<float*>(smem);
  const int xr = dy_row(g);
  const size_t dslab = (size_t)g.ty * xr * C;
  const Lanes ln = lanes_of(C);
  const int p = ln.p0;
  const int runs = g.ty * g.nrx, rowlen = g.xp * C;

  for (int item = blockIdx.x; item < g.items; item += gridDim.x) {
    int b, y0, z0, z1;
    item_origin(g, item, b, y0, z0, z1);
    const long long vol = (long long)g.Z * g.Y * g.X * C;
    const T* xb = x + b * vol;
    const T* db = dy + b * vol;
    float2 acc[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) acc[k] = make_float2(0.f, 0.f);
    __syncthreads();  // the last item's reduction is done with red (the ring)
    // x slab z lives in slot (z - z0 + 1) % nr, dy slab z in slot (z - z0) % (nr - 2)
    for (int d = 0; d < 3; ++d) stage_slab<T, CT>(xb, ring + d * slab, z0 - 1 + d, y0, g);
    stage_dy<T, CT>(db, dring, z0, y0, g);
    cp_async_commit();
    for (int z = z0; z < z1; ++z) {
      cp_async_wait<0>();
      __syncthreads();  // x slab z + 1 and dy slab z have landed; with four slots, those of x z - 2 and dy z - 1 are free
      if (g.nr == 4) {
        if (z + 2 <= z1) stage_slab<T, CT>(xb, ring + ((z + 3 - z0) % 4) * slab, z + 2, y0, g);
        if (z + 1 < z1) stage_dy<T, CT>(db, dring + ((z + 1 - z0) % 2) * dslab, z + 1, y0, g);
      }
      cp_async_commit();
      const T* s0 = ring + ((z - z0) % g.nr) * slab;
      const T* s1 = ring + ((z - z0 + 1) % g.nr) * slab;
      const T* s2 = ring + ((z - z0 + 2) % g.nr) * slab;
      const T* ds = dring + (g.nr == 4 ? ((z - z0) % 2) * dslab : 0) + 2 * p;
      if (ln.active) {
        int ry = ln.slot / g.nrx, rx = ln.slot - ry * g.nrx;
        for (int r = ln.slot; r < runs; r += ln.tv) {
          float2 d[kRun];
#pragma unroll
          for (int j = 0; j < kRun; ++j) d[j] = load2(ds + (ry * xr + kRun * rx + j) * C);
          wgrad_run<T, CT>(s0, s1, s2, (ry * g.xp + kRun * rx) * C + 2 * p, rowlen, C, d, acc);
          next_run(ln.tv, g.nrx, ry, rx);
        }
      }
      if (g.nr == 3) {
        __syncthreads();  // the slot of x z - 1 and the dy slot are free
        if (z + 2 <= z1) stage_slab<T, CT>(xb, ring + ((z + 3 - z0) % 3) * slab, z + 2, y0, g);
        if (z + 1 < z1) stage_dy<T, CT>(db, dring, z + 1, y0, g);
        cp_async_commit();
      }
    }
    // the item's partial: the run slots' sums added in slot order
    float* dst = partial + (long long)item * kRows * C;
    if (ln.tv == 1) {  // C > 256: threads past the C / 2 pairs hold nothing and store nothing
      if (ln.active) {
#pragma unroll
        for (int k = 0; k < kRows; ++k) store2(dst + k * C + 2 * p, acc[k].x, acc[k].y);
      }
      continue;
    }
    __syncthreads();  // every thread is done with the ring, which red aliases
    if (ln.active) {
#pragma unroll
      for (int k = 0; k < kRows; ++k) store2(red + (ln.slot * kRows + k) * C + 2 * p, acc[k].x, acc[k].y);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * C; i += kThreads) {
      float s = 0.f;
      for (int r = 0; r < ln.tv; ++r) s += red[r * kRows * C + i];
      dst[i] = s;
    }
  }
}

// The sum of the items' partials of each element i = k * C + c (kRows * C
// of them), written to out as dw (C, 27) then db (C): a block of kSumRows
// x 32 threads takes 32 elements; row r sums items r, r + kSumRows, ...,
// then row 0 adds the kSumRows sums in order
constexpr int kSumRows = 32;

__global__ void __launch_bounds__(kSumRows * 32)
    wgrad_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out, int items, int C) {
  const int n = kRows * C;
  __shared__ float s[kSumRows][33];
  const int col = threadIdx.x & 31, row = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + col;
  float acc = 0.f;
  if (i < n) {
    int it = row;
    for (; it + 3 * kSumRows < items; it += 4 * kSumRows) {
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = partial[(long long)(it + k * kSumRows) * n + i];
#pragma unroll
      for (int k = 0; k < 4; ++k) acc += v[k];
    }
    for (; it < items; it += kSumRows) acc += partial[(long long)it * n + i];
  }
  s[row][col] = acc;
  __syncthreads();
  if (row == 0 && i < n) {
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < kSumRows; ++r) t += s[r][col];
    const int k = i / C, c = i - k * C;
    out[k < 27 ? c * 27 + k : 27 * C + c] = t;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using FwdKernel = void (*)(const void*, const float*, const float*, void*, Ring, int);
using WgradKernel = void (*)(const void*, const void*, float*, Ring);

template <typename T, int CT>
FwdKernel fwd_fn() {
  void (*k)(const T*, const float*, const float*, T*, Ring, int) = ring_dw_kernel<T, CT>;
  return reinterpret_cast<FwdKernel>(k);
}

template <typename T, int CT>
WgradKernel wgrad_fn() {
  void (*k)(const T*, const T*, float*, Ring) = ring_wgrad_kernel<T, CT>;
  return reinterpret_cast<WgradKernel>(k);
}

// The kernels for a width: C at compile time where MedNeXt uses it.
template <typename T>
FwdKernel fwd_kernel(int C) {
  switch (C) {
    case 32: return fwd_fn<T, 32>();
    case 64: return fwd_fn<T, 64>();
    case 128: return fwd_fn<T, 128>();
    case 256: return fwd_fn<T, 256>();
    case 512: return fwd_fn<T, 512>();
    default: return fwd_fn<T, 0>();
  }
}

template <typename T>
WgradKernel wgrad_kernel(int C) {
  switch (C) {
    case 32: return wgrad_fn<T, 32>();
    case 64: return wgrad_fn<T, 64>();
    case 128: return wgrad_fn<T, 128>();
    case 256: return wgrad_fn<T, 256>();
    case 512: return wgrad_fn<T, 512>();
    default: return wgrad_fn<T, 0>();
  }
}

inline bool plan_ok(int B, int Z, int Y, int X, int C, int ty, int seg, int nr) {
  return ring_ok(B, Z, Y, X, C, ty, seg, nr) && C <= kMaxC;
}

// kind 0: forward / input gradient, 1: weight gradient
inline const void* kernel_of(int kind, int dtype, int C) {
  if (kind == 0) return reinterpret_cast<const void*>(dtype ? fwd_kernel<bf16>(C) : fwd_kernel<float>(C));
  return reinterpret_cast<const void*>(dtype ? wgrad_kernel<bf16>(C) : wgrad_kernel<float>(C));
}

inline size_t smem_of(int kind, const Ring& g, int es) {
  return kind == 0 ? fwd_smem(g, es) : wgrad_layout(g, es).total;
}

}  // namespace dwconv

// dtype: 0 = float32, 1 = bfloat16. Every entry returns 0 or an error code
// (a cudaError_t, or 10001 for a shape or plan the kernels do not take).
extern "C" {

// The plan (band rows ty, segment seg, ring slots nr) of kernel `kind` (0
// forward / input gradient, 1 weight gradient) as the card takes it, on the
// current device: out = [shared-memory bytes, work items, resident blocks a
// SM, grid (SMs x resident blocks, at most the items), registers a thread].
// The first call for a kernel on a device lets it take all of the shared
// memory (mednext::occupancy), which a launch then needs.
int depthwise3x3_plan(int kind, int dtype, int B, int Z, int Y, int X, int C, int ty, int seg, int nr, int* out) {
  using namespace dwconv;
  if ((kind != 0 && kind != 1) || !plan_ok(B, Z, Y, X, C, ty, seg, nr)) return kErrShape;
  const Ring g = make_ring(B, Z, Y, X, C, ty, seg, nr);
  const size_t smem = smem_of(kind, g, dtype ? 2 : 4);
  if (smem > kMaxSmem) return kErrShape;
  const void* fn = kernel_of(kind, dtype, C);
  int occ = 0;
  const int e = occupancy(fn, kThreads, smem, &occ);
  if (e) return e;
  if (occ < 1) return kErrShape;
  cudaFuncAttributes attr;
  const cudaError_t ea = cudaFuncGetAttributes(&attr, fn);
  if (ea != cudaSuccess) return (int)ea;
  const long long grid = (long long)sm_count() * occ;
  out[0] = (int)smem;
  out[1] = g.items;
  out[2] = occ;
  out[3] = (int)(grid < g.items ? grid : g.items);
  out[4] = attr.numRegs;
  return 0;
}

// mirror != 0: tap t reads w[c][26 - t] (the input gradient)
int depthwise3x3_fwd(const void* x, const void* w, const void* bias, void* out, int dtype, int B, int Z, int Y,
                     int X, int C, int ty, int seg, int nr, int grid, int mirror, void* stream) {
  using namespace dwconv;
  if (!plan_ok(B, Z, Y, X, C, ty, seg, nr) || grid < 1) return kErrShape;
  const Ring g = make_ring(B, Z, Y, X, C, ty, seg, nr);
  const size_t smem = fwd_smem(g, dtype ? 2 : 4);
  if (smem > kMaxSmem) return kErrShape;
  const FwdKernel k = dtype ? fwd_kernel<bf16>(C) : fwd_kernel<float>(C);
  const int blocks = grid < g.items ? grid : g.items;
  k<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<const float*>(w), static_cast<const float*>(bias), out, g, mirror);
  return (int)cudaGetLastError();
}

// partial: (items, 28, C) float32 scratch; out: 28 C float32, dw as (C, 27)
// then db (C)
int depthwise3x3_wgrad(const void* x, const void* dy, void* partial, void* out, int dtype, int B, int Z, int Y,
                       int X, int C, int ty, int seg, int nr, int grid, void* stream) {
  using namespace dwconv;
  if (!plan_ok(B, Z, Y, X, C, ty, seg, nr) || grid < 1) return kErrShape;
  const Ring g = make_ring(B, Z, Y, X, C, ty, seg, nr);
  const size_t smem = wgrad_layout(g, dtype ? 2 : 4).total;
  if (smem > kMaxSmem) return kErrShape;
  auto s = static_cast<cudaStream_t>(stream);
  const WgradKernel k = dtype ? wgrad_kernel<bf16>(C) : wgrad_kernel<float>(C);
  const int blocks = grid < g.items ? grid : g.items;
  k<<<blocks, kThreads, smem, s>>>(x, dy, static_cast<float*>(partial), g);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n = kRows * C;
  wgrad_reduce_kernel<<<(n + 31) / 32, kSumRows * 32, 0, s>>>(static_cast<const float*>(partial),
                                                          static_cast<float*>(out), g.items, C);
  return (int)cudaGetLastError();
}

const char* depthwise3x3_error_string(int code) {
  if (code == dwconv::kErrShape) return "shape or plan not supported by the depthwise 3^3 kernels";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
