// Dense 3^3 SAME stride-1 convolution for Hopper (sm_90a), channels-last:
//     out[b,z,y,x,co] = round( sum_{dz,dy,dx} sum_ci x[b,z+dz-1,y+dy-1,x+dx-1,ci] * W[dz,dy,dx,ci,co] )
//     then out += bias[co] in the output type
// with zero outside the volume and f32 accumulation. The bias is added
// after the rounding to x's type, in x's type (bf16: round, add, round
// again), as both the TPU kernel (conv3d_pallas.py:127-128) and flax's
// nn.Conv do.
//
// Replaces the TPU kernel conv3d_3x3_pallas of
// pytorch_connectomics_tpu/ops/conv3d_pallas.py:84 (body _conv3x3_kernel :31,
// dispatcher conv3d_3x3 :132). It ports what that kernel computes (an
// implicit GEMM over K = 27*Cin in tap-major order), not its 128-lane
// channel padding, its x-padding by 8 for the DMA engine or its VMEM block
// picker.
//
// Bound on an H100 (RSUNet on 64^3 windows, batch 8, bf16): at level 0
// (28 -> 28 channels, 2.1 M voxels in the batch) one launch does 88.8 GFLOP
// on 0.23 GB, 378 FLOP per byte, above the card's ridge (~295): the tensor
// cores bound it (90 us at 989 TFLOP/s). The stem (1 -> 28) is bound by
// bytes (36 us), the 16^3 and 8^3 levels by launch overhead.
//
// Design (simple and right first; wgmma/TMA and overlap are later work):
// - A block owns a slice of NB output channels (grid.y) and keeps that
//   slice of the weight resident in shared memory for its whole life,
//   transposed to (NB rows x K): it walks output tiles in a grid-stride
//   loop (a persistent grid), so the weight is read once per block, not
//   once per tile.
// - A tile is R rows of XS consecutive x-voxels in one z-slice (XS a
//   multiple of 16, R*XS <= 64). Its haloed neighbourhood, (3, R+2, XS+2)
//   voxels, is staged in shared memory with cp.async; voxels outside the
//   volume are zero-filled, so the ragged edges and SAME padding need no
//   masks later. Channels are padded with zeros to CP.
// - bf16, Cin >= 8 (every RSUNet conv but the stem): tap-wise GEMM on the
//   tensor cores (ldmatrix + mma.sync m16n8k16, bf16 in, f32 accumulate).
//   For tap (dz,dy,dx) the A operand of 16 consecutive output voxels is a
//   plain row-major 16 x 16 block of the staged halo, so no patch matrix
//   is built: the 27 taps x CP/16 channel steps are 27*CP/16 k-steps per
//   16-voxel fragment. A warp owns one 16-voxel row of fragments and loads
//   each A fragment once for all its output-channel fragments; the next
//   k-step's fragments are loaded while the current one multiplies, and
//   the k-steps' offsets come from a per-block table. Cin and Cout of 28
//   or 36 are zero-padded to multiples of 16 in the staged halo and the
//   weight; stores are masked.
// - Shared-memory strides (a halo cell, a weight row, a patch row) are odd
//   multiples of 16 bytes, so the 8 rows of an ldmatrix phase fall on
//   distinct banks (a 64- or 128-byte stride is a 4- or 8-way conflict).
// - The f32 accumulators are staged for the epilogue in the space of the
//   halo, which is dead by then: it keeps two blocks on an SM at level 0.
// - bf16, Cin < 8 (the stem, Cin = 1): padding each tap to 16 channels would
//   waste 16x of the MMA, so taps and channels are packed first: a patch
//   matrix (tile voxels x KP, KP = 27*Cin rounded up to 16) is gathered
//   from the halo into shared memory, then multiplied.
// - float32: an exact f32 path on the CUDA cores (no TF32), for the
//   arithmetic check; it is not on the bf16 model's path.
// - The weight comes in the layout the wrapper prepares once per parameter
//   version (ops/conv3d.py): (27*CP, Np) tap-major, or (KP, Np) packed,
//   zero-padded, in x's type; Np = Cout rounded up to 16.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see ops/build.py). Plain C interface for ctypes.

#include <type_traits>

#include "mednext_block.cuh"

namespace conv3d {

using mednext::cp_async;
using mednext::from_f32;
using mednext::ldsm_x4;
using mednext::mma16816;
using mednext::to_f32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxM = 64;   // output voxels per tile
constexpr int kMaxNB = 64;  // output channels per block
constexpr int kMaxFrags = (kMaxM / 16) * (kMaxNB / 16) / kWarps;  // accumulator fragments per warp
constexpr int kMaxOut = kMaxM * kMaxNB / kThreads;                 // f32 outputs per thread
constexpr int kErrShape = 10001;
constexpr size_t kMaxSmem = 232448;

struct Geom {
  int B, Z, Y, X, Cin, Cout;
  int XS, R;   // a tile: R rows of XS voxels along x in one z-slice
  int TY, TX;  // tiles along y and x
  int CP;      // channels of the staged halo (Cin zero-padded)
  int CS;      // stride of a halo cell in shared memory (>= CP)
  int K;       // rows of the weight matrix
  int KS;      // stride of a weight row (and of a patch row) in shared memory (>= K)
  int Np;      // columns of the weight matrix (Cout rounded up to 16)
  int NB;      // output channels per block
  int packed;  // bf16 with Cin < 8: taps x channels packed into KP columns
  long long tiles;
};

__host__ __device__ inline size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

// k-steps of 16 of the tensor-core path: 16 channels of one tap, or 16
// packed columns
__host__ __device__ inline int k_steps(const Geom& g) { return g.packed ? g.K / 16 : 27 * (g.CP / 16); }

struct Layout {
  size_t halo, patch, steps, total;  // byte offsets; the weight slice sits at 0, the accumulators at halo
};

__host__ __device__ inline Layout layout(const Geom& g, int es, bool mma) {
  Layout l;
  const int M = g.R * g.XS;
  l.halo = align128((size_t)g.NB * g.KS * es);
  l.patch = l.halo + align128((size_t)3 * (g.R + 2) * (g.XS + 2) * g.CS * es);
  const size_t end = l.patch + (g.packed ? align128((size_t)M * g.KS * es) : 0);
  const size_t acc_end = l.halo + (mma ? align128((size_t)M * (g.NB + 4) * 4) : 0);
  l.steps = end > acc_end ? end : acc_end;
  l.total = l.steps + (mma ? (size_t)k_steps(g) * sizeof(int2) : 0);
  return l;
}

// Stage the (3, R+2, XS+2) neighbourhood of the tile at (b, z, y0, x0) into
// halo[cell][CS]: channels 0..Cin-1 copied, Cin..CP-1 zero-filled (the
// accumulators of the previous tile overwrote them). VEC is the copy width
// in bytes; a width of one element (bf16 with odd Cin) is a plain load and
// store.
template <typename T, int VEC>
__device__ __forceinline__ void stage_halo(const T* __restrict__ x, T* __restrict__ halo, const Geom& g, int b,
                                           int z, int y0, int x0) {
  constexpr int per = VEC / (int)sizeof(T);
  const int vec = g.Cin / per;   // copies of real channels per cell
  const int vall = g.CP / per;   // copies per cell, zero-fill included
  const int W2 = g.XS + 2, H2 = g.R + 2;
  const int per_row = W2 * vall;
  const int total = 3 * H2 * per_row;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int row = i / per_row;  // (dz, yy) of the halo
    const int j = i - row * per_row;
    const int xx = j / vall;
    const int q = j - xx * vall;
    const int dz = row / H2, yy = row - dz * H2;
    const int zg = z + dz - 1, yg = y0 + yy - 1, xg = x0 + xx - 1;
    const bool valid = q < vec && zg >= 0 && zg < g.Z && yg >= 0 && yg < g.Y && xg >= 0 && xg < g.X;
    const long long off =
        valid ? ((((long long)b * g.Z + zg) * g.Y + yg) * g.X + xg) * g.Cin + q * per : 0;
    T* dst = halo + ((size_t)row * W2 + xx) * g.CS + q * per;
    if constexpr (VEC == (int)sizeof(T)) {
      *dst = valid ? x[off] : from_f32<T>(0.f);
    } else {
      cp_async<VEC>(dst, x + off, valid);
    }
  }
}

template <typename T, int VEC, bool PACKED>
__global__ void __launch_bounds__(kThreads)
    conv3d_kernel(const T* __restrict__ x, const T* __restrict__ wg, const float* __restrict__ bias,
                  T* __restrict__ out, Geom g) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout l = layout(g, (int)sizeof(T), kMma);
  T* wsm = reinterpret_cast<T*>(smem);  // [NB][KS]: wsm[n * KS + k] = W[k][n0 + n]
  T* halo = reinterpret_cast<T*>(smem + l.halo);
  T* patch = reinterpret_cast<T*>(smem + l.patch);
  float* accsm = reinterpret_cast<float*>(smem + l.halo);  // after the MMAs, in the halo's space
  int2* steps = reinterpret_cast<int2*>(smem + l.steps);    // per k-step: (A offset, B offset)
  const int n0 = blockIdx.y * g.NB;
  const int M = g.R * g.XS;
  const int W2 = g.XS + 2, H2 = g.R + 2;
  const int LDC = g.NB + 4;

  // the block's weight slice, transposed, resident (read once; the first
  // tile's barrier publishes it)
  for (int i = threadIdx.x; i < g.K * g.NB; i += kThreads) {
    const int k = i / g.NB, n = i - k * g.NB;
    wsm[(size_t)n * g.KS + k] = wg[(size_t)k * g.Np + n0 + n];
  }

  const int nsteps = kMma ? k_steps(g) : 0;
  for (int st = threadIdx.x; st < nsteps; st += kThreads) {
    if (g.packed) {
      steps[st] = make_int2(st * 16, st * 16);
    } else {
      const int cps = g.CP / 16, tap = st / cps, c0 = (st - tap * cps) * 16;
      const int dz = tap / 9, dy = (tap / 3) % 3, dx = tap % 3;
      steps[st] = make_int2(((dz * H2 + dy) * W2 + dx) * g.CS + c0, tap * g.CP + c0);
    }
  }

  const int warp = threadIdx.x / 32;
  const int MF = M / 16, NF = g.NB / 16;
  const int G = kWarps / MF;  // warps per row of output fragments
  const int mi = warp % MF;   // this warp's 16 output voxels
  const int g0 = warp / MF;   // and its output-channel fragments g0, g0 + G, ...
  for (long long t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    const int tx = (int)(t % g.TX);
    long long t2 = t / g.TX;
    const int ty = (int)(t2 % g.TY);
    t2 /= g.TY;
    const int z = (int)(t2 % g.Z);
    const int b = (int)(t2 / g.Z);
    const int y0 = ty * g.R, x0 = tx * g.XS;
    stage_halo<T, VEC>(x, halo, g, b, z, y0, x0);
    mednext::cp_async_wait_all();
    __syncthreads();

    if constexpr (kMma) {
      if constexpr (PACKED) {  // patch[m][k], k = tap * Cin + ci, zero past 27 * Cin
        for (int i = threadIdx.x; i < M * g.K; i += kThreads) {
          const int m = i / g.K, k = i - m * g.K;
          T v = from_f32<T>(0.f);
          if (k < 27 * g.Cin) {
            const int tap = k / g.Cin, ci = k - tap * g.Cin;
            const int dz = tap / 9, dy = (tap / 3) % 3, dx = tap % 3;
            const int r = m / g.XS, xm = m - r * g.XS;
            v = halo[((size_t)(dz * H2 + r + dy) * W2 + xm + dx) * g.CS + ci];
          }
          patch[(size_t)m * g.KS + k] = v;
        }
        __syncthreads();
      }
      float acc[kMaxFrags][2][4];  // per output fragment j, its two 8-channel halves
#pragma unroll
      for (int j = 0; j < kMaxFrags; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[j][h][q] = 0.f;
      const bool active = g0 < G;
      const int lane = threadIdx.x & 31;
      int nj = 0;  // output fragments of this warp: g0, g0 + G, ... below NF
      while (nj < kMaxFrags && g0 + nj * G < NF) ++nj;
      if (active) {
        const T* abase;  // this lane's ldmatrix row of the A fragment, at k-step offset 0
        if constexpr (PACKED) {
          abase = patch + (size_t)(mi * 16 + (lane & 15)) * g.KS + (lane >> 4) * 8;
        } else {
          // the 16 voxels of fragment mi lie in one x-row of the tile
          const int r = (mi * 16) / g.XS, xm0 = mi * 16 - r * g.XS;
          abase = halo + ((size_t)r * W2 + xm0 + (lane & 15)) * g.CS + (lane >> 4) * 8;
        }
        // B rows are output channels (n), k contiguous: matrices (n 0-7 | 8-15) x (k 0-7 | 8-15)
        const T* bbase = wsm + (size_t)((lane & 7) + (lane >> 4) * 8) * g.KS + ((lane >> 3) & 1) * 8;
        unsigned a0[4], a1[4], b0[kMaxFrags][4], b1[kMaxFrags][4];
        auto load = [&](int st, unsigned (&a)[4], unsigned (&bb)[kMaxFrags][4]) {
          const int2 o = steps[st];
          ldsm_x4(a, abase + o.x);
#pragma unroll
          for (int j = 0; j < kMaxFrags; ++j)
            if (j < nj) ldsm_x4(bb[j], bbase + (size_t)(g0 + j * G) * 16 * g.KS + o.y);
        };
        auto multiply = [&](const unsigned (&a)[4], const unsigned (&bb)[kMaxFrags][4]) {
#pragma unroll
          for (int j = 0; j < kMaxFrags; ++j) {
            if (j < nj) {
              mma16816(acc[j][0], a, bb[j][0], bb[j][1]);
              mma16816(acc[j][1], a, bb[j][2], bb[j][3]);
            }
          }
        };
        load(0, a0, b0);
        for (int st = 0; st < nsteps; st += 2) {  // two register sets: load one k-step ahead
          if (st + 1 < nsteps) load(st + 1, a1, b1);
          multiply(a0, b0);
          if (st + 2 < nsteps) load(st + 2, a0, b0);
          if (st + 1 < nsteps) multiply(a1, b1);
        }
      }
      __syncthreads();  // every warp is done with the halo: its space takes the accumulators
      if (active) {
        const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
        for (int j = 0; j < kMaxFrags; ++j) {
          if (j >= nj) break;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int n = (g0 + j * G) * 16 + h * 8 + 2 * tq;
            float* row = accsm + (size_t)(mi * 16 + gq) * LDC + n;
            *reinterpret_cast<float2*>(row) = make_float2(acc[j][h][0], acc[j][h][1]);
            *reinterpret_cast<float2*>(row + 8 * LDC) = make_float2(acc[j][h][2], acc[j][h][3]);
          }
        }
      }
      __syncthreads();
      const int pairs = g.NB / 2;  // two output channels per store; Cout even keeps them aligned
      const bool two = (g.Cout & 1) == 0;
      for (int i = threadIdx.x; i < M * pairs; i += kThreads) {
        const int m = i / pairs, n = 2 * (i - m * pairs);
        const int co = n0 + n;
        const int r = m / g.XS, xm = m - r * g.XS;
        const int yg = y0 + r, xg = x0 + xm;
        if (co >= g.Cout || yg >= g.Y || xg >= g.X) continue;
        T* o = out + ((((long long)b * g.Z + z) * g.Y + yg) * g.X + xg) * g.Cout + co;
        float v0 = to_f32(from_f32<T>(accsm[(size_t)m * LDC + n]));
        float v1 = to_f32(from_f32<T>(accsm[(size_t)m * LDC + n + 1]));
        if (bias) {
          v0 += to_f32(from_f32<T>(__ldg(bias + co)));
          if (co + 1 < g.Cout) v1 += to_f32(from_f32<T>(__ldg(bias + co + 1)));
        }
        if (two) {
          mednext::store2(o, v0, v1);
        } else {
          o[0] = from_f32<T>(v0);
          if (co + 1 < g.Cout) o[1] = from_f32<T>(v1);
        }
      }
    } else {
      // exact f32 on the CUDA cores: thread owns outputs o = tid + j * kThreads
      float acc[kMaxOut];
      int hoff[kMaxOut], woff[kMaxOut];
      const int nout = M * g.NB;
#pragma unroll
      for (int j = 0; j < kMaxOut; ++j) {
        acc[j] = 0.f;
        const int o = threadIdx.x + j * kThreads;
        const int m = o < nout ? o / g.NB : 0;
        const int n = o < nout ? o - m * g.NB : 0;
        const int r = m / g.XS, xm = m - r * g.XS;
        hoff[j] = (r * W2 + xm) * g.CS;
        woff[j] = n * g.KS;
      }
      for (int tap = 0; tap < 27; ++tap) {
        const int dz = tap / 9, dy = (tap / 3) % 3, dx = tap % 3;
        const T* a = halo + ((size_t)(dz * H2 + dy) * W2 + dx) * g.CS;
        const T* w = wsm + tap * g.CP;
        for (int ci = 0; ci < g.Cin; ++ci) {
#pragma unroll
          for (int j = 0; j < kMaxOut; ++j) {
            if (threadIdx.x + j * kThreads < nout)
              acc[j] = fmaf(to_f32(a[hoff[j] + ci]), to_f32(w[woff[j] + ci]), acc[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kMaxOut; ++j) {
        const int o = threadIdx.x + j * kThreads;
        if (o >= nout) continue;
        const int m = o / g.NB, co = n0 + (o - m * g.NB);
        const int r = m / g.XS, xm = m - r * g.XS;
        const int yg = y0 + r, xg = x0 + xm;
        if (co >= g.Cout || yg >= g.Y || xg >= g.X) continue;
        float v = acc[j];
        if (bias) v += __ldg(bias + co);
        out[((((long long)b * g.Z + z) * g.Y + yg) * g.X + xg) * g.Cout + co] = from_f32<T>(v);
      }
    }
    __syncthreads();  // the halo, patch and accumulator space is reused by the next tile
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

inline int round_up(int a, int m) { return (a + m - 1) / m * m; }

// Rows of the weight matrix the kernel takes for (Cin, element size): the
// wrapper (ops/conv3d.py) builds the same layout and this is checked.
inline int weight_rows(int Cin, int es, int* cp, int* packed) {
  *packed = es == 2 && Cin < 8;
  *cp = (es == 2 && !*packed) ? round_up(Cin, 16) : Cin;
  return *packed ? round_up(27 * Cin, 16) : 27 * *cp;
}

// A shared-memory row stride for ldmatrix: n elements (a multiple of 8)
// widened to an odd multiple of 8 bf16 values (16 bytes).
inline int odd_stride(int n) { return (n / 8) % 2 ? n : n + 8; }

// The tile (XS, R) and channel slice NB: the widest tile, then the widest
// slice, then the most rows whose shared memory fits a block.
inline bool plan(Geom& g, int es) {
  g.K = weight_rows(g.Cin, es, &g.CP, &g.packed);
  g.Np = round_up(g.Cout, 16);
  const bool mma = es == 2;
  g.CS = mma && !g.packed ? odd_stride(g.CP) : g.CP;
  g.KS = mma ? odd_stride(g.K) : g.K;
  for (int xs = (round_up(g.X, 16) < kMaxM ? round_up(g.X, 16) : kMaxM); xs >= 16; xs -= 16) {
    g.XS = xs;
    for (int nb = (g.Np < kMaxNB ? g.Np : kMaxNB); nb >= 16; nb -= 16) {
      if (g.Np % nb) continue;
      g.NB = nb;
      for (int r = (kMaxM / xs < g.Y ? kMaxM / xs : g.Y); r >= 1; --r) {
        g.R = r;
        if (layout(g, es, mma).total <= kMaxSmem) {
          g.TY = (g.Y + g.R - 1) / g.R;
          g.TX = (g.X + g.XS - 1) / g.XS;
          g.tiles = (long long)g.B * g.Z * g.TY * g.TX;
          return true;
        }
      }
    }
  }
  return false;
}

template <typename T, int VEC, bool PACKED>
int launch(const Geom& g, const void* x, const void* w, const void* bias, void* out, cudaStream_t stream) {
  auto kernel = conv3d_kernel<T, VEC, PACKED>;
  const size_t smem = layout(g, (int)sizeof(T), std::is_same<T, __nv_bfloat16>::value).total;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  // all of the SM's unified L1/shared memory as shared: as many blocks as fit
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 132, occ = 1;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1) return kErrShape;
  const int slices = g.Np / g.NB;
  long long want = ((long long)sms * occ + slices - 1) / slices;
  const unsigned blocks = (unsigned)(g.tiles < want ? g.tiles : want);
  kernel<<<dim3(blocks, slices), kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                                          static_cast<const float*>(bias), static_cast<T*>(out), g);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* x, const void* w, const void* bias, void* out, int B, int Z, int Y, int X, int Cin, int Cout,
        int w_rows, int w_cols, cudaStream_t stream) {
  if (B < 1 || Z < 1 || Y < 1 || X < 1 || Cin < 1 || Cout < 1) return kErrShape;
  if ((long long)B * Z * Y * X * (Cin > Cout ? Cin : Cout) >= (1LL << 62)) return kErrShape;
  const int es = (int)sizeof(T);
  Geom g{};
  g.B = B, g.Z = Z, g.Y = Y, g.X = X, g.Cin = Cin, g.Cout = Cout;
  if (!plan(g, es)) return kErrShape;
  if (w_rows != g.K || w_cols != g.Np) return kErrShape;
  const int row_bytes = Cin * es;
  if (g.packed) {
    if (row_bytes % 8 == 0) return launch<T, 8, true>(g, x, w, bias, out, stream);
    if (row_bytes % 4 == 0) return launch<T, 4, true>(g, x, w, bias, out, stream);
    return launch<T, (int)sizeof(T), true>(g, x, w, bias, out, stream);
  }
  if (row_bytes % 16 == 0) return launch<T, 16, false>(g, x, w, bias, out, stream);
  if (row_bytes % 8 == 0) return launch<T, 8, false>(g, x, w, bias, out, stream);
  if (row_bytes % 4 == 0) return launch<T, 4, false>(g, x, w, bias, out, stream);
  return launch<T, (int)sizeof(T), false>(g, x, w, bias, out, stream);
}

}  // namespace conv3d

// dtype: 0 = float32, 1 = bfloat16. x (B, Z, Y, X, Cin) contiguous and
// 16-byte aligned; w the (w_rows, w_cols) matrix of ops/conv3d.py in x's
// type; bias (Cout,) float32 or null; out (B, Z, Y, X, Cout). Returns 0 or
// an error code (a cudaError_t, or 10001 for a shape the kernel does not
// take).
extern "C" {

int conv3d_3x3_weight_rows(int Cin, int dtype) {
  int cp = 0, packed = 0;
  return conv3d::weight_rows(Cin, dtype ? 2 : 4, &cp, &packed);
}

int conv3d_3x3_fwd(const void* x, const void* w, const void* bias, void* out, int dtype, int B, int Z, int Y,
                   int X, int Cin, int Cout, int w_rows, int w_cols, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype)
    return conv3d::run<__nv_bfloat16>(x, w, bias, out, B, Z, Y, X, Cin, Cout, w_rows, w_cols, s);
  return conv3d::run<float>(x, w, bias, out, B, Z, Y, X, Cin, Cout, w_rows, w_cols, s);
}

const char* conv3d_3x3_error_string(int code) {
  if (code == conv3d::kErrShape) return "shape not supported by the conv3d 3^3 kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
