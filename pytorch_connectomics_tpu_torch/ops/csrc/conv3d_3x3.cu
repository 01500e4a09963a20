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
// Two kernels:
// - conv3d_taps_kernel: bf16 on the tensor cores (ldmatrix + mma.sync
//   m16n8k16, bf16 in, f32 accumulate), the model's path. Tap-wise for
//   Cin >= 8 (every RSUNet conv but the stem); for Cin < 8 (the stem, Cin
//   = 1; PACKED) padding each tap to 8 channels would waste 8x of the MMA,
//   so each thread first gathers its voxel's taps and channels into a
//   row of a patch matrix (M x KP, KP = 27*Cin rounded up to 16) in shared
//   memory, which the MMAs then read. Its design follows.
// - conv3d_f32_kernel: float32, the exact arithmetic check on the CUDA
//   cores (no TF32); not on the bf16 model's path. Tiles of at most 64
//   voxels, one halo buffer, a thread's outputs summed tap by tap.
//
// Design of the tensor-core kernel (wgmma and TMA are later work):
// - A block owns a slice of NB output channels (grid.y) and keeps that
//   slice of the weight resident in shared memory for its whole life,
//   transposed to (NB rows x K): it walks output tiles in a grid-stride
//   loop (a persistent grid), so the weight is read once per block.
// - A tile is R rows of XS consecutive x-voxels in one z-slice, M = R*XS up
//   to 512 voxels. Its haloed neighbourhood, (3, R+2, XS+2) cells of CP
//   channels, is staged in shared memory with cp.async; cells outside the
//   volume and channels Cin..CP-1 are zero-filled, so the ragged edges and
//   SAME padding need no masks in the MMA loop.
// - Staging overlaps the MMAs: with two halo buffers (wherever they fit
//   beside the weight slice of the tile the planner takes), tile t+1's
//   copies are issued right after the barrier that opens tile t and are in
//   flight while tile t multiplies; the next tile waits for them
//   (cp.async.wait_all: by then they are the only copies in flight) before
//   its barrier. One barrier a tile: it also tells every warp that the
//   buffer about to be refilled is no longer read. With one buffer (Cin 192, whose weight
//   slice alone is 166 KB; or a larger tile that the planner prefers), the
//   buffer is refilled after a second barrier and its copies overlap the
//   epilogue only.
// - The epilogue writes from registers: each lane rounds its accumulator
//   pairs to bf16, adds the bias in bf16 and stores two channels at once.
// - Warp tiles: a warp owns MFW m16 fragments x NFW n8 fragments: 32
//   voxels x 32, 48 or 64 channels, or 64 voxels x 32 channels, wherever
//   Np >= 32. Per k-step it issues MFW A and NFW/2 B ldmatrix.x4 for
//   MFW*NFW MMAs (32 x 32: four loads for eight MMAs, 0.125 B of shared
//   memory per FMA; 32 x 64 and 64 x 32: six for sixteen).
//   The next k-step's fragments are loaded while the current one
//   multiplies. The planner picks the warp tile, the warps' layout, the
//   tile shape, NB and the buffers from a cost model of the loads, the
//   MMAs, the staging and the waves (plan_taps).
// - K is tap-major with the channels of a tap padded to CP = Cin rounded up
//   to 8 (not 16: Cin 36 takes 40 channels a tap, not 48). A k-step of 16
//   is two chunks of 8 channels, which may belong to two taps: lanes 0-15
//   address the first chunk's rows, lanes 16-31 the second's, from a
//   per-block table of chunk offsets into the halo. The A operand of 16
//   consecutive voxels for one chunk is 16 cells of the staged halo, so no
//   patch matrix is built. A chunk past the 27 taps reads a row of zeros.
// - Shared-memory strides (a halo cell, a weight row) are odd multiples of
//   16 bytes, so the 8 rows of an ldmatrix phase fall on distinct banks.
// - The weight comes in the layout the wrapper prepares once per parameter
//   version (ops/conv3d.py): K = round_up(27*CP, 16) rows tap-major, (KP,
//   Np) packed for the stem, (27*Cin, Np) in f32; zero-padded, in x's type;
//   Np = Cout rounded up to 16.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see ops/build.py). Plain C interface for ctypes.

#include <math.h>

#include <type_traits>

#include "mednext_block.cuh"

namespace conv3d {

using mednext::cp_async;
using mednext::from_f32;
using mednext::mma16816;
using mednext::to_f32;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxM = 64;   // output voxels per tile of the f32 kernel
constexpr int kMaxNB = 64;  // output channels per block
constexpr int kMaxOut = kMaxM * kMaxNB / kThreads;  // f32: outputs per thread
constexpr int kErrShape = 10001;
constexpr size_t kMaxSmem = 232448;
constexpr unsigned kPadChunk = 0xFFFF;  // tap-wise table: a chunk past the 27 taps

struct Geom {
  int B, Z, Y, X, Cin, Cout;
  int XS, R;   // a tile: R rows of XS voxels along x in one z-slice
  int TY, TX;  // tiles along y and x
  int CP;      // channels of a staged halo cell (Cin zero-padded)
  int CS;      // stride of a halo cell in shared memory (>= CP)
  int K;       // rows of the weight matrix
  int KS;      // stride of a weight row (and of a patch row) in shared memory (>= K)
  int Np;      // columns of the weight matrix (Cout rounded up to 16)
  int NB;      // output channels per block; the last slice may reach past Np (zero columns)
  int slices;  // blocks along the output channels, ceil(Np / NB)
  int packed;  // bf16 with Cin < 8: taps x channels packed into KP columns (the stem)
  // the tensor-core kernel only
  int MFW, NFW;  // a warp's tile: MFW m16 fragments (voxels) x NFW n8 fragments (channels)
  int WMW, WNW;  // warps along the tile's voxels and along the slice's channels
  int nbuf;      // halo buffers: 2 (the next tile's copies overlap the MMAs) or 1
  int vecb;      // bytes of one staging copy: 16, 8, 4 or 2
  long long tiles;
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }
__host__ __device__ inline size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

// k-steps of 16 of the tensor-core kernel
__host__ __device__ inline int k_steps(const Geom& g) { return g.K / 16; }

// The f32 kernel: the weight slice at 0, then the halo.
__host__ __device__ inline size_t f32_halo(const Geom& g) { return align128((size_t)g.NB * g.KS * 4); }
__host__ __device__ inline size_t f32_smem(const Geom& g) {
  return f32_halo(g) + (size_t)3 * (g.R + 2) * (g.XS + 2) * g.CS * 4;
}

// The tensor-core kernel: the weight slice at 0, nbuf halo buffers, the
// patch matrix (packed only), the table (16-bit: a halo offset per 8-channel
// chunk, or per tap when packed), one zero chunk of 16 bytes.
struct TapsLayout {
  size_t halo, hbytes, patch, tab, zero, total;
};

template <bool PACKED>
__host__ __device__ inline TapsLayout layout_taps(const Geom& g) {
  TapsLayout l;
  const int entries = PACKED ? 27 : 2 * k_steps(g);
  l.halo = align16((size_t)g.NB * g.KS * 2);
  l.hbytes = align16((size_t)3 * (g.R + 2) * (g.XS + 2) * g.CS * 2);
  l.patch = l.halo + (size_t)g.nbuf * l.hbytes;
  l.tab = l.patch + (PACKED ? (size_t)g.R * g.XS * g.KS * 2 : 0);
  l.zero = l.tab + align16((size_t)entries * sizeof(unsigned short));
  l.total = l.zero + 16;
  return l;
}

inline TapsLayout layout_taps(const Geom& g) { return g.packed ? layout_taps<true>(g) : layout_taps<false>(g); }

// Tile t of the grid-stride loop: batch b, z-slice z, first row y0 and
// first x-voxel x0.
__device__ __forceinline__ void tile_origin(long long t, const Geom& g, int& b, int& z, int& y0, int& x0) {
  const int tx = (int)(t % g.TX);
  long long t2 = t / g.TX;
  const int ty = (int)(t2 % g.TY);
  t2 /= g.TY;
  z = (int)(t2 % g.Z);
  b = (int)(t2 / g.Z);
  y0 = ty * g.R;
  x0 = tx * g.XS;
}

// The copy width of one element (bf16 with odd Cin, as the stem's Cin = 1;
// f32 with odd Cin): plain loads, four of a thread in flight before their
// stores.
template <typename T>
__device__ __forceinline__ void stage_halo_scalar(const T* __restrict__ x, T* __restrict__ halo, const Geom& g,
                                                  int b, int z, int y0, int x0) {
  const int W2 = g.XS + 2, H2 = g.R + 2;
  const int cells = W2 * g.CP;  // values per row
  const int total = 3 * H2 * cells;
  for (int i0 = threadIdx.x; i0 < total; i0 += 4 * kThreads) {
    T v[4];
    int d[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kThreads;
      v[u] = from_f32<T>(0.f);
      d[u] = -1;
      if (i < total) {
        const int row = i / cells, j = i - row * cells;
        const int xx = j / g.CP, q = j - xx * g.CP;
        const int dz = row / H2, yy = row - dz * H2;
        const int zg = z + dz - 1, yg = y0 + yy - 1, xg = x0 + xx - 1;
        d[u] = (row * W2 + xx) * g.CS + q;
        if (q < g.Cin && zg >= 0 && zg < g.Z && yg >= 0 && yg < g.Y && xg >= 0 && xg < g.X)
          v[u] = x[((((long long)b * g.Z + zg) * g.Y + yg) * g.X + xg) * g.Cin + q];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (d[u] >= 0) halo[d[u]] = v[u];
  }
}

// Stage the (3, R+2, XS+2) neighbourhood of the tile at (b, z, y0, x0) into
// halo[cell][CS]: channels 0..Cin-1 copied, Cin..CP-1 zero-filled, cells
// outside the volume zero-filled. VEC is the copy width in bytes: with
// cp.async, a warp takes one (dz, y) row of cells at a time, its lanes the
// copies along the row; a width of one element goes to stage_halo_scalar.
// The caller waits (cp.async.wait_all).
template <typename T, int VEC>
__device__ __forceinline__ void stage_halo(const T* __restrict__ x, T* __restrict__ halo, const Geom& g, int b,
                                           int z, int y0, int x0) {
  if constexpr (VEC == (int)sizeof(T)) {
    stage_halo_scalar(x, halo, g, b, z, y0, x0);
  } else {
    constexpr int per = VEC / (int)sizeof(T);
    const int vec = g.Cin / per;  // copies of real channels per cell
    const int vall = g.CP / per;  // copies per cell, zero-fill included
    const int W2 = g.XS + 2, H2 = g.R + 2;
    const int cells = W2 * vall;  // copies per row
    const int lane = threadIdx.x & 31;
    for (int row = threadIdx.x / 32; row < 3 * H2; row += kWarps) {
      const int dz = row / H2, yy = row - dz * H2;
      const int zg = z + dz - 1, yg = y0 + yy - 1;
      const bool rv = zg >= 0 && zg < g.Z && yg >= 0 && yg < g.Y;
      const long long vrow = (((long long)b * g.Z + zg) * g.Y + yg) * g.X;  // voxel (b, zg, yg, 0)
      T* dst = halo + (size_t)row * W2 * g.CS;
      for (int j = lane; j < cells; j += 32) {
        const int xx = j / vall, q = j - xx * vall;
        const int xg = x0 + xx - 1;
        const bool valid = rv && q < vec && xg >= 0 && xg < g.X;
        cp_async<VEC>(dst + xx * g.CS + q * per, valid ? x + (vrow + xg) * g.Cin + q * per : x, valid);
      }
    }
  }
}

// The block's weight slice, transposed and resident: wsm[n * KS + k] =
// W[k][n0 + n], zero for a column past Np. 16-byte loads along a weight
// row (NB, Np and n0 are multiples of 16); the first tile's barrier
// publishes the slice.
template <typename T>
__device__ __forceinline__ void load_weight_slice(const T* __restrict__ wg, T* __restrict__ wsm, const Geom& g,
                                                  int n0) {
  constexpr int per = 16 / (int)sizeof(T);
  const int nv = g.NB / per;
  for (int i = threadIdx.x; i < g.K * nv; i += kThreads) {
    const int k = i / nv, n = (i - k * nv) * per;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (n0 + n < g.Np) raw = __ldg(reinterpret_cast<const uint4*>(wg + (size_t)k * g.Np + n0 + n));
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < per; ++e) wsm[(size_t)(n + e) * g.KS + k] = v[e];
  }
}

// Two adjacent output channels co, co + 1 (co + 1 may be past Cout) from
// f32 sums: each rounded to bf16, the bias (b0, b1: already bf16 values)
// added in bf16 and rounded again. two: Cout is even, so the pair is one
// 4-byte store.
__device__ __forceinline__ void store_pair(bf16* o, float s0, float s1, float b0, float b1, bool has_bias, int co,
                                           int Cout, bool two) {
  float v0 = to_f32(from_f32<bf16>(s0)), v1 = to_f32(from_f32<bf16>(s1));
  if (has_bias) {
    v0 += b0;
    v1 += b1;
  }
  if (two) {
    mednext::store2(o, v0, v1);
  } else {
    o[0] = from_f32<bf16>(v0);
    if (co + 1 < Cout) o[1] = from_f32<bf16>(v1);
  }
}

// ldmatrix.x4 (mednext::ldsm_x4) at a 32-bit shared-memory address: the
// k-loop keeps its fragment addresses in one register each
__device__ __forceinline__ unsigned smem_addr(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }
__device__ __forceinline__ void ldsm_x4_at(unsigned (&r)[4], unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ float bias_bf16(const float* __restrict__ bias, int co, int Cout) {
  return bias && co < Cout ? to_f32(from_f32<bf16>(__ldg(bias + co))) : 0.f;
}

// ---------------------------------------------------------------------------
// the tensor-core kernel (bf16): tap-wise, or over the stem's packed patch
// ---------------------------------------------------------------------------

// Issue the copies of tile t into halo (the copy width is uniform per launch).
__device__ __forceinline__ void stage_tile(const bf16* __restrict__ x, bf16* __restrict__ halo, const Geom& g,
                                           long long t) {
  int b, z, y0, x0;
  tile_origin(t, g, b, z, y0, x0);
  switch (g.vecb) {
    case 16:
      stage_halo<bf16, 16>(x, halo, g, b, z, y0, x0);
      break;
    case 8:
      stage_halo<bf16, 8>(x, halo, g, b, z, y0, x0);
      break;
    case 4:
      stage_halo<bf16, 4>(x, halo, g, b, z, y0, x0);
      break;
    default:
      stage_halo<bf16, 2>(x, halo, g, b, z, y0, x0);
  }
}

template <int MFW, int NFW, bool PACKED>
__global__ void __launch_bounds__(kThreads, 1)
    conv3d_taps_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg, const float* __restrict__ bias,
                       bf16* __restrict__ out, Geom g) {
  static_assert(NFW % 2 == 0, "B fragments come in pairs of n8 (one ldmatrix.x4 per 16 channels)");
  constexpr int NP = NFW / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const TapsLayout l = layout_taps<PACKED>(g);
  bf16* wsm = reinterpret_cast<bf16*>(smem);  // [NB][KS]
  unsigned short* tab = reinterpret_cast<unsigned short*>(smem + l.tab);
  const bf16* zrow = reinterpret_cast<const bf16*>(smem + l.zero);
  bf16* patch = reinterpret_cast<bf16*>(smem + l.patch);  // packed: [M][KS]
  const int n0 = blockIdx.y * g.NB;
  const int W2 = g.XS + 2, H2 = g.R + 2;
  const int nsteps = k_steps(g);

  // the first tile's copies fly while the weight slice is transposed into place
  if (blockIdx.x < g.tiles) stage_tile(x, reinterpret_cast<bf16*>(smem + l.halo), g, blockIdx.x);
  load_weight_slice(wg, wsm, g, n0);
  if (PACKED) {  // tap's offset in a halo buffer
    for (int tap = threadIdx.x; tap < 27; tap += kThreads) {
      const int dz = tap / 9, dy = (tap / 3) % 3, dx = tap % 3;
      tab[tap] = (unsigned short)(((dz * H2 + dy) * W2 + dx) * g.CS);
    }
  } else {  // chunk c of 8 channels (k = 8c .. 8c+7): tap c / (CP/8), its offset in a halo buffer
    const int cpc = g.CP / 8;
    for (int c = threadIdx.x; c < 2 * nsteps; c += kThreads) {
      unsigned o = kPadChunk;
      if (c < 27 * cpc) {
        const int tap = c / cpc, ci = (c - tap * cpc) * 8;
        const int dz = tap / 9, dy = (tap / 3) % 3, dx = tap % 3;
        o = (unsigned)(((dz * H2 + dy) * W2 + dx) * g.CS + ci);
      }
      tab[c] = (unsigned short)o;
    }
  }
  if (threadIdx.x < 4) reinterpret_cast<unsigned*>(smem + l.zero)[threadIdx.x] = 0u;

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const bool active = warp < g.WMW * g.WNW;
  const int mw0 = (warp % g.WMW) * MFW * 16;  // the warp's first voxel of the tile
  const int nw0 = (warp / g.WMW) * NFW * 8;   // and its first channel of the slice
  const int hi = lane >> 4;                   // A: lanes 0-15 address a k-step's first chunk, 16-31 its second
  int aoff[MFW];  // this lane's A row: the cell of its voxel in a halo buffer, or its patch row
#pragma unroll
  for (int f = 0; f < MFW; ++f) {
    const int m = mw0 + f * 16 + (lane & 15);
    const int r = m / g.XS, xm = m - r * g.XS;
    aoff[f] = PACKED ? m * g.KS + hi * 8 : (r * W2 + xm) * g.CS;
  }
  // B rows are the slice's channels, k contiguous: one ldmatrix.x4 holds
  // (n 0-7 | 8-15) x (k 0-7 | 8-15) of 16 channels
  unsigned bsa[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p)
    bsa[p] = smem_addr(wsm + (size_t)(nw0 + p * 16 + (lane & 7) + (lane >> 4) * 8) * g.KS + ((lane >> 3) & 1) * 8);
  const unsigned zsa = smem_addr(zrow);
  // lane (gq, tq) of an accumulator fragment holds rows gq, gq + 8 and
  // channels 2 tq, 2 tq + 1; their bias, rounded to bf16 once
  const int gq = lane >> 2, tq = lane & 3;
  const bool has_bias = bias != nullptr;
  const bool two = (g.Cout & 1) == 0;
  float bv[NFW][2];
#pragma unroll
  for (int j = 0; j < NFW; ++j) {
    const int co = n0 + nw0 + j * 8 + 2 * tq;
    bv[j][0] = bias_bf16(bias, co, g.Cout);
    bv[j][1] = bias_bf16(bias, co + 1, g.Cout);
  }

  int buf = 0;
  for (long long t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    const long long tn = t + gridDim.x;
    mednext::cp_async_wait_all();  // this thread's copies of tile t, the only ones in flight, have landed
    __syncthreads();               // everyone's have; every warp is done with the other buffer
    const bf16* halo = reinterpret_cast<const bf16*>(smem + l.halo + buf * l.hbytes);
    if (g.nbuf == 2 && tn < g.tiles)  // tile t + 1's copies, in flight during tile t's MMAs
      stage_tile(x, reinterpret_cast<bf16*>(smem + l.halo + (buf ^ 1) * l.hbytes), g, tn);
    if constexpr (PACKED) {  // patch[m][k], k = tap * Cin + ci, zero from 27 * Cin on: one row a thread
      const int M = g.R * g.XS;
      if ((int)threadIdx.x < M) {
        const int m = threadIdx.x, r = m / g.XS, xm = m - r * g.XS;
        const unsigned short* h = reinterpret_cast<const unsigned short*>(halo) + (r * W2 + xm) * g.CS;
        uint4* prow = reinterpret_cast<uint4*>(patch + (size_t)m * g.KS);
        int tap = 0, ci = 0;
        for (int k8 = 0; k8 < g.K / 8; ++k8) {
          unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (tap < 27) {
              w[e / 2] |= (unsigned)h[tab[tap] + ci] << (16 * (e & 1));
              if (++ci == g.Cin) ci = 0, ++tap;
            }
          }
          prow[k8] = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
      __syncthreads();  // the patch is complete
    }

    float acc[MFW][NFW][4];
#pragma unroll
    for (int f = 0; f < MFW; ++f)
#pragma unroll
      for (int j = 0; j < NFW; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[f][j][q] = 0.f;
    if (active) {
      unsigned asa[MFW];
#pragma unroll
      for (int f = 0; f < MFW; ++f) asa[f] = smem_addr((PACKED ? patch : halo) + aoff[f]);
      unsigned a0[MFW][4], a1[MFW][4], b0[NP][4], b1[NP][4];
      auto load = [&](int st, unsigned (&a)[MFW][4], unsigned (&bb)[NP][4]) {
        const unsigned o = PACKED ? st * 16 : tab[2 * st + hi];
#pragma unroll
        for (int f = 0; f < MFW; ++f) ldsm_x4_at(a[f], o != kPadChunk ? asa[f] + 2 * o : zsa);
#pragma unroll
        for (int p = 0; p < NP; ++p) ldsm_x4_at(bb[p], bsa[p] + st * 32);
      };
      auto multiply = [&](const unsigned (&a)[MFW][4], const unsigned (&bb)[NP][4]) {
#pragma unroll
        for (int f = 0; f < MFW; ++f)
#pragma unroll
          for (int j = 0; j < NFW; ++j) mma16816(acc[f][j], a[f], bb[j / 2][(j & 1) * 2], bb[j / 2][(j & 1) * 2 + 1]);
      };
      load(0, a0, b0);
      for (int st = 0; st < nsteps; st += 2) {  // two register sets: load one k-step ahead
        if (st + 1 < nsteps) load(st + 1, a1, b1);
        multiply(a0, b0);
        if (st + 2 < nsteps) load(st + 2, a0, b0);
        if (st + 1 < nsteps) multiply(a1, b1);
      }
    }
    if (g.nbuf == 1) {  // one buffer: the next tile's copies wait for every warp's MMAs
      __syncthreads();
      if (tn < g.tiles) stage_tile(x, reinterpret_cast<bf16*>(smem + l.halo), g, tn);
    }
    buf ^= g.nbuf - 1;

    // epilogue, from registers
    if (active) {
      int b, z, y0, x0;
      tile_origin(t, g, b, z, y0, x0);
#pragma unroll
      for (int f = 0; f < MFW; ++f) {
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int m = mw0 + f * 16 + gq + 8 * rh;
          const int r = m / g.XS, xm = m - r * g.XS;
          const int yg = y0 + r, xg = x0 + xm;
          if (yg >= g.Y || xg >= g.X) continue;
          bf16* orow = out + ((((long long)b * g.Z + z) * g.Y + yg) * g.X + xg) * g.Cout;
#pragma unroll
          for (int j = 0; j < NFW; ++j) {
            const int co = n0 + nw0 + j * 8 + 2 * tq;
            if (co < g.Cout)
              store_pair(orow + co, acc[f][j][2 * rh], acc[f][j][2 * rh + 1], bv[j][0], bv[j][1], has_bias, co,
                         g.Cout, two);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the f32 kernel
// ---------------------------------------------------------------------------

// float32: the exact arithmetic check on the CUDA cores (no TF32), not on
// the bf16 model's path. A thread owns outputs o = tid + j * kThreads.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
    conv3d_f32_kernel(const float* __restrict__ x, const float* __restrict__ wg, const float* __restrict__ bias,
                      float* __restrict__ out, Geom g) {
  using T = float;
  extern __shared__ __align__(128) unsigned char smem[];
  T* wsm = reinterpret_cast<T*>(smem);  // [NB][KS]
  T* halo = reinterpret_cast<T*>(smem + f32_halo(g));
  const int n0 = blockIdx.y * g.NB;
  const int M = g.R * g.XS;
  const int W2 = g.XS + 2, H2 = g.R + 2;

  load_weight_slice(wg, wsm, g, n0);
  for (long long t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    int b, z, y0, x0;
    tile_origin(t, g, b, z, y0, x0);
    stage_halo<T, VEC>(x, halo, g, b, z, y0, x0);
    mednext::cp_async_wait_all();
    __syncthreads();

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
          if ((int)threadIdx.x + j * kThreads < nout) acc[j] = fmaf(a[hoff[j] + ci], w[woff[j] + ci], acc[j]);
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
      out[((((long long)b * g.Z + z) * g.Y + yg) * g.X + xg) * g.Cout + co] = v;
    }
    __syncthreads();  // the halo is reused by the next tile
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

inline int round_up(int a, int m) { return (a + m - 1) / m * m; }

// Rows of the weight matrix the kernel takes for (Cin, element size), and
// the channels of a staged cell: the wrapper (ops/conv3d.py) builds the
// same layout and this is checked.
inline int weight_rows(int Cin, int es, int* cp, int* packed) {
  *packed = es == 2 && Cin < 8;
  if (es == 2 && !*packed) {
    *cp = round_up(Cin, 8);
    return round_up(27 * *cp, 16);
  }
  *cp = Cin;
  return es == 2 ? round_up(27 * Cin, 16) : 27 * Cin;
}

// A shared-memory row stride for ldmatrix: n elements (a multiple of 8)
// widened to an odd multiple of 8 bf16 values (16 bytes).
inline int odd_stride(int n) { return (n / 8) % 2 ? n : n + 8; }

inline void finish(Geom& g) {
  g.TY = (g.Y + g.R - 1) / g.R;
  g.TX = (g.X + g.XS - 1) / g.XS;
  g.tiles = (long long)g.B * g.Z * g.TY * g.TX;
  g.slices = (g.Np + g.NB - 1) / g.NB;
}

// The f32 kernel: the widest tile (M <= 64), then the widest slice
// dividing Np, then the most rows whose shared memory fits a block.
inline bool plan_f32(Geom& g) {
  g.CS = g.CP;
  g.KS = g.K;
  for (int xs = (round_up(g.X, 16) < kMaxM ? round_up(g.X, 16) : kMaxM); xs >= 16; xs -= 16) {
    g.XS = xs;
    for (int nb = (g.Np < kMaxNB ? g.Np : kMaxNB); nb >= 16; nb -= 16) {
      if (g.Np % nb) continue;
      g.NB = nb;
      for (int r = (kMaxM / xs < g.Y ? kMaxM / xs : g.Y); r >= 1; --r) {
        g.R = r;
        if (f32_smem(g) <= kMaxSmem) {
          finish(g);
          return true;
        }
      }
    }
  }
  return false;
}

// Estimated SM clocks of a tensor-core launch, with constants fitted to
// times measured on an H100 (PERF.md): a k-step of a tile costs about 350
// clocks of latency plus 4 per MMA on the busiest of the SM's four
// sub-partitions, unless the ldmatrix traffic (512 bytes each at 128 a
// clock for the SM) takes longer; so a warp with more MMAs per k-step
// does more in the same time. Staging a halo buffer takes about a clock per
// 32 bytes, hidden behind the MMAs with two buffers and added to them with
// one; the stem's patch gather is added to the k-loop; tiles go out in
// waves over the SMs; the weight slice is loaded once a block.
inline double taps_cost(const Geom& g, int sms) {
  const int A = g.WMW * g.WNW;
  const double kstep = 350.0 + 4.0 * ((A + 3) / 4) * g.MFW * g.NFW;
  const double lds = A * (g.MFW + g.NFW / 2.0) * 4.0;
  const double mma = k_steps(g) * (kstep > lds ? kstep : lds) + (g.packed ? 2.0 * g.K + 500.0 : 0.0);
  const double stage = layout_taps(g).hbytes / 32.0;
  const double tile = g.nbuf == 2 ? (mma > stage ? mma : stage) : mma + stage;
  const double waves = ceil((double)g.tiles * g.slices / sms);
  return waves * tile + (double)g.NB * g.K * 2 / 32.0;
}

// The tensor-core kernel's warp tiles (MFW, NFW); a kernel is instantiated
// for each (taps_kernel()), the packed stem's for those of at most 32
// channels.
constexpr int kWarpTiles[][2] = {{2, 8}, {4, 4}, {2, 6}, {2, 4}, {2, 2}, {1, 2}};

// The tap-wise kernel: among the slices NB, warp tiles, warp layouts, tile
// shapes (R*XS = the warps' voxels, R <= Y) and buffers whose shared
// memory fits a block, the least estimated time (taps_cost). Two buffers
// where they fit. First all eight warps, each of 32 voxels x at least
// min(Np, 32) channels; then such warps with some idle (a small volume);
// then smaller warp tiles (Cin 192, whose weight slice leaves room for a
// tile of 16 voxels only). The packed stem stages cells of Cin channels
// (no ldmatrix reads them) and needs M <= 256 (a patch row a thread).
inline bool plan_taps(Geom& g, int sms) {
  g.CS = g.packed ? g.CP : odd_stride(g.CP);
  g.KS = odd_stride(g.K);
  const int row = g.Cin * 2;
  g.vecb = row % 16 == 0 ? 16 : row % 8 == 0 ? 8 : row % 4 == 0 ? 4 : 2;
  double best = -1;
  Geom pick = g;
  for (int pass = 0; pass < 3 && best < 0; ++pass) {
    for (int nb = 16; nb <= kMaxNB && nb < g.Np + 16; nb += 16) {
      for (const auto& wt : kWarpTiles) {
        const int wn = 8 * wt[1];
        if (nb % wn || (g.packed && wt[1] > 4)) continue;
        if (pass < 2 && (wt[0] < 2 || wn < (g.Np < 32 ? g.Np : 32))) continue;
        const int wnw = nb / wn;
        for (int wmw = 1; wmw * wnw <= kWarps; ++wmw) {
          if (pass == 0 && wmw * wnw < kWarps) continue;
          const int M = wmw * wt[0] * 16;
          if (g.packed && M > kThreads) continue;  // a patch row a thread
          // widest x-run first: of two tiles that cost the same, the longer
          // contiguous runs of loads and stores
          const int xmax = M < round_up(g.X, 16) ? M : round_up(g.X, 16);
          for (int xs = xmax; xs >= 16; xs -= 16) {
            if (M % xs || M / xs > g.Y) continue;
            for (int nbuf = 2; nbuf >= 1; --nbuf) {
              Geom c = g;
              c.NB = nb, c.MFW = wt[0], c.NFW = wt[1], c.WMW = wmw, c.WNW = wnw, c.XS = xs, c.R = M / xs;
              c.nbuf = nbuf;
              // the last chunk's offset must fit the 16-bit table
              const int last = ((2 * (c.R + 2) + 2) * (c.XS + 2) + 2) * c.CS + c.CP - 8;
              if (layout_taps(c).total > kMaxSmem || last >= (int)kPadChunk) continue;
              finish(c);
              const double cost = taps_cost(c, sms);
              if (best < 0 || cost < best) best = cost, pick = c;
              break;  // one buffer only where two do not fit
            }
          }
        }
      }
    }
  }
  if (best < 0) return false;
  g = pick;
  return true;
}

inline int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

inline bool plan(Geom& g, int es, int sms) {
  g.K = weight_rows(g.Cin, es, &g.CP, &g.packed);
  g.Np = round_up(g.Cout, 16);
  return es == 2 ? plan_taps(g, sms) : plan_f32(g);
}

inline size_t smem_bytes(const Geom& g, int es) { return es == 2 ? layout_taps(g).total : f32_smem(g); }

template <bool PACKED>
void (*taps_kernel(const Geom& g))(const bf16*, const bf16*, const float*, bf16*, Geom) {
  if (g.MFW == 1) return conv3d_taps_kernel<1, 2, PACKED>;
  if constexpr (!PACKED) {
    if (g.MFW == 4) return conv3d_taps_kernel<4, 4, false>;
  }
  if (g.NFW == 2) return conv3d_taps_kernel<2, 2, PACKED>;
  if (g.NFW == 4) return conv3d_taps_kernel<2, 4, PACKED>;
  if constexpr (!PACKED) {
    if (g.NFW == 6) return conv3d_taps_kernel<2, 6, false>;
    if (g.NFW == 8) return conv3d_taps_kernel<2, 8, false>;
  }
  return nullptr;
}

template <typename T>
int launch(void (*kernel)(const T*, const T*, const float*, T*, Geom), const Geom& g, int sms, const void* x,
           const void* w, const void* bias, void* out, cudaStream_t stream) {
  const size_t smem = smem_bytes(g, (int)sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  // all of the SM's unified L1/shared memory as shared: as many blocks as fit
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  int occ = 1;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1) return kErrShape;
  const long long want = ((long long)sms * occ + g.slices - 1) / g.slices;
  const unsigned blocks = (unsigned)(g.tiles < want ? g.tiles : want);
  kernel<<<dim3(blocks, g.slices), kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                                            static_cast<const float*>(bias), static_cast<T*>(out), g);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* x, const void* w, const void* bias, void* out, int B, int Z, int Y, int X, int Cin, int Cout,
        int w_rows, int w_cols, cudaStream_t stream) {
  if (B < 1 || Z < 1 || Y < 1 || X < 1 || Cin < 1 || Cout < 1) return kErrShape;
  if ((long long)B * Z * Y * X * (Cin > Cout ? Cin : Cout) >= (1LL << 62)) return kErrShape;
  const int es = (int)sizeof(T), sms = sm_count();
  Geom g{};
  g.B = B, g.Z = Z, g.Y = Y, g.X = X, g.Cin = Cin, g.Cout = Cout;
  if (!plan(g, es, sms)) return kErrShape;
  if (w_rows != g.K || w_cols != g.Np) return kErrShape;
  if constexpr (std::is_same<T, bf16>::value) {
    auto k = g.packed ? taps_kernel<true>(g) : taps_kernel<false>(g);
    return k ? launch<T>(k, g, sms, x, w, bias, out, stream) : kErrShape;
  } else {
    const int row_bytes = Cin * es;
    if (row_bytes % 16 == 0) return launch<T>(conv3d_f32_kernel<16>, g, sms, x, w, bias, out, stream);
    if (row_bytes % 8 == 0) return launch<T>(conv3d_f32_kernel<8>, g, sms, x, w, bias, out, stream);
    return launch<T>(conv3d_f32_kernel<4>, g, sms, x, w, bias, out, stream);
  }
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

// The plan a launch of this shape takes, for reports: plan[0..10] = XS, R,
// NB, slices, MFW, NFW, WMW, WNW, nbuf, shared-memory bytes, kernel (0
// tap-wise, 1 packed stem, 2 f32). The f32 kernel leaves MFW..nbuf 0.
int conv3d_3x3_plan(int dtype, int B, int Z, int Y, int X, int Cin, int Cout, int* plan) {
  conv3d::Geom g{};
  g.B = B, g.Z = Z, g.Y = Y, g.X = X, g.Cin = Cin, g.Cout = Cout;
  const int es = dtype ? 2 : 4;
  if (!conv3d::plan(g, es, conv3d::sm_count())) return conv3d::kErrShape;
  const int v[11] = {g.XS, g.R,    g.NB,   g.slices, g.MFW, g.NFW, g.WMW, g.WNW, g.nbuf,
                     (int)conv3d::smem_bytes(g, es), es == 4 ? 2 : g.packed ? 1 : 0};
  for (int i = 0; i < 11; ++i) plan[i] = v[i];
  return 0;
}

int conv3d_3x3_fwd(const void* x, const void* w, const void* bias, void* out, int dtype, int B, int Z, int Y,
                   int X, int Cin, int Cout, int w_rows, int w_cols, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype) return conv3d::run<conv3d::bf16>(x, w, bias, out, B, Z, Y, X, Cin, Cout, w_rows, w_cols, s);
  return conv3d::run<float>(x, w, bias, out, B, Z, Y, X, Cin, Cout, w_rows, w_cols, s);
}

const char* conv3d_3x3_error_string(int code) {
  if (code == conv3d::kErrShape) return "shape not supported by the conv3d 3^3 kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
