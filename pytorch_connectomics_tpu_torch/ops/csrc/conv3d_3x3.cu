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

__device__ __forceinline__ void ldsm_x4_trans_at(unsigned (&r)[4], unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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
// the weight gradient: dW[tap][ci][co] = sum_v x(v + tap - 1)[ci] * dy(v)[co]
// ---------------------------------------------------------------------------

// The weight gradient is the product of the forward's weight-matrix layout
// (rows: tap-major taps x channels, as the forward's kernel_weight, K of
// them; columns: Cout, Np of them) reduced over every voxel of the batch:
//     G[row][co] = sum_v A[row][v] * dy[v][co],  A[row][v] = x[v + tap(row) - 1][ci(row)]
// WGeom adds to the forward's geometry (tiles of R x XS voxels in one z
// slice, their staged x halo) what the reduction needs: an item is one
// block's share, (chunk of consecutive tiles, tile of BM rows, slice of NB
// columns); its partial sums go to partial[chunk][row][col], and
// wgrad_sum_kernel adds the chunks in a fixed order. Items, chunks and rows
// follow from the shape alone, so the result is the same bits for any grid.
struct WGeom {
  Geom g;         // x side (tiles, halo cells of CP channels at stride CS), K rows, Np, NB, slices, packed, nbuf
  int DS;         // stride of a staged dy voxel (>= NB)
  int dvecb;      // bytes of one dy staging copy
  int BM;         // rows of an item
  int row_tiles;  // ceil(K / BM)
  int rows_p;     // row_tiles * BM: rows of a chunk's partial
  int tap_rows;   // rows a tap takes: CP (bf16 tap-wise) or Cin (packed, f32)
  int tpc;        // tiles per chunk
  int chunks;
  long long items;  // chunks * row_tiles * slices
};

constexpr int kWgradMaxM = 512;  // voxels of a tile (bf16 tap-wise; packed 256, f32 64)
constexpr int kWgradF32Rows = 64;  // rows of an f32 item: 16 thread rows x 4
constexpr int kWgradF32Cols = 64;  // columns of an f32 item: 16 thread columns x 4

// Shared memory of the bf16 kernel: the chunk table (tap-wise) or the tap
// table (packed), a zero chunk of 16 bytes, nbuf buffers of (x halo, dy
// tile), and (packed) the patch matrix of the tile.
struct WgLayout {
  size_t zero, buf, hbytes, dbytes, patch, total;
};

__host__ __device__ inline WgLayout wgrad_layout(const WGeom& w, int es) {
  const Geom& g = w.g;
  WgLayout l;
  const int entries = es == 4 ? 0 : g.packed ? 27 : w.rows_p / 8;
  l.zero = align16((size_t)entries * sizeof(unsigned short));
  l.buf = l.zero + 16;
  l.hbytes = align16((size_t)3 * (g.R + 2) * (g.XS + 2) * g.CS * es);
  l.dbytes = align16((size_t)g.R * g.XS * w.DS * es);
  l.patch = l.buf + (size_t)g.nbuf * (l.hbytes + l.dbytes);
  l.total = l.patch + (es == 2 && g.packed ? (size_t)g.R * g.XS * g.KS * 2 : 0);
  return l;
}

// Stage dy of the tile at (b, z, y0, x0), channels n0 .. n0 + NB - 1, into
// dst[m][DS] (m = r * XS + xm), zero outside the volume and past Cout. VEC
// is the copy width in bytes; a width of one element (bf16, odd Cout) loads
// and stores.
template <typename T, int VEC>
__device__ __forceinline__ void stage_dy(const T* __restrict__ dy, T* __restrict__ dst, const WGeom& w, int b, int z,
                                         int y0, int x0, int n0) {
  const Geom& g = w.g;
  constexpr int per = VEC / (int)sizeof(T);
  const int vall = g.NB / per;
  const int total = g.R * g.XS * vall;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int m = i / vall, q = i - m * vall;
    const int r = m / g.XS, xm = m - r * g.XS;
    const int yg = y0 + r, xg = x0 + xm, n = n0 + q * per;
    const bool valid = yg < g.Y && xg < g.X && n < g.Cout;
    const long long src = ((((long long)b * g.Z + z) * g.Y + yg) * g.X + xg) * g.Cout + n;
    if constexpr (VEC == (int)sizeof(T)) {
      dst[m * w.DS + q] = valid ? dy[src] : from_f32<T>(0.f);
    } else {
      cp_async<VEC>(dst + m * w.DS + q * per, valid ? dy + src : dy, valid);
    }
  }
}

// Issue the copies of tile t (x halo and dy) into one buffer.
template <typename T>
__device__ __forceinline__ void stage_wgrad_tile(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ xh,
                                                 T* __restrict__ dt, const WGeom& w, long long t, int n0) {
  const Geom& g = w.g;
  int b, z, y0, x0;
  tile_origin(t, g, b, z, y0, x0);
  if constexpr (std::is_same<T, bf16>::value) {
    stage_tile(x, xh, g, t);
  } else {
    switch (g.vecb) {
      case 16:
        stage_halo<float, 16>(x, xh, g, b, z, y0, x0);
        break;
      case 8:
        stage_halo<float, 8>(x, xh, g, b, z, y0, x0);
        break;
      default:
        stage_halo<float, 4>(x, xh, g, b, z, y0, x0);
    }
  }
  switch (w.dvecb) {
    case 16:
      stage_dy<T, 16>(dy, dt, w, b, z, y0, x0, n0);
      break;
    case 8:
      stage_dy<T, 8>(dy, dt, w, b, z, y0, x0, n0);
      break;
    case 4:
      stage_dy<T, 4>(dy, dt, w, b, z, y0, x0, n0);
      break;
    default:
      if constexpr (std::is_same<T, bf16>::value) stage_dy<T, 2>(dy, dt, w, b, z, y0, x0, n0);
  }
}

// Item i: its chunk, tile of rows and slice of columns. Consecutive items
// share a chunk, so the blocks that stage the same tiles run together.
__device__ __forceinline__ void wgrad_item(long long i, const WGeom& w, int& chunk, int& rt, int& sl) {
  sl = (int)(i % w.g.slices);
  const long long t = i / w.g.slices;
  rt = (int)(t % w.row_tiles);
  chunk = (int)(t / w.row_tiles);
}

// bf16 on the tensor cores. Warp w of the block owns rows row0 + 32 w ..
// + 31 of the item (two m16 fragments) and all NB columns of its slice
// (NFW n8 fragments). Per k-step of 16 voxels of the tile, A (rows x
// voxels) is read from channels-last x with ldmatrix.trans: the halo cell
// of voxel v for a chunk of 8 channels of one tap holds A's 8 rows of that
// voxel contiguously, so the transposed load gives the row-major fragment;
// B (voxels x columns) the same way from the staged dy tile.
template <int NFW, bool PACKED>
__global__ void __launch_bounds__(kThreads, 1)
    conv3d_wgrad_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy, float* __restrict__ partial,
                        WGeom w) {
  static_assert(NFW % 2 == 0, "B fragments come in pairs of n8");
  constexpr int NP = NFW / 2;
  const Geom& g = w.g;
  extern __shared__ __align__(128) unsigned char smem[];
  const WgLayout l = wgrad_layout(w, 2);
  unsigned short* tab = reinterpret_cast<unsigned short*>(smem);
  const bf16* zrow = reinterpret_cast<const bf16*>(smem + l.zero);
  bf16* patch = reinterpret_cast<bf16*>(smem + l.patch);
  const int W2 = g.XS + 2, H2 = g.R + 2;
  const int M = g.R * g.XS, nsteps = M / 16;

  if (PACKED) {  // tap's offset in a halo buffer
    for (int tap = threadIdx.x; tap < 27; tap += kThreads) {
      const int dz = tap / 9, dy_ = (tap / 3) % 3, dx = tap % 3;
      tab[tap] = (unsigned short)(((dz * H2 + dy_) * W2 + dx) * g.CS);
    }
  } else {  // chunk c of 8 rows (row = tap * CP + ci): its offset in a halo buffer, or past the taps
    const int cpc = g.CP / 8;
    for (int c = threadIdx.x; c < w.rows_p / 8; c += kThreads) {
      unsigned o = kPadChunk;
      if (c < 27 * cpc) {
        const int tap = c / cpc, ci = (c - tap * cpc) * 8;
        const int dz = tap / 9, dy_ = (tap / 3) % 3, dx = tap % 3;
        o = (unsigned)(((dz * H2 + dy_) * W2 + dx) * g.CS + ci);
      }
      tab[c] = (unsigned short)o;
    }
  }
  if (threadIdx.x < 4) reinterpret_cast<unsigned*>(smem + l.zero)[threadIdx.x] = 0u;

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int mj = lane >> 3, r8 = lane & 7;
  // A: lane gives voxel r8 + 8 (mj / 2) of the k-step, rows 8 (mj % 2) ..
  // of the fragment; B: voxel r8 + 8 (mj % 2), columns 8 (mj / 2) ..
  const int avox = r8 + 8 * (mj >> 1), ahalf = 8 * (mj & 1);
  const int bvox = r8 + 8 * (mj & 1), bcol = 8 * (mj >> 1);
  const unsigned zsa = smem_addr(zrow);

  for (long long item = blockIdx.x; item < w.items; item += gridDim.x) {
    int chunk, rt, sl;
    wgrad_item(item, w, chunk, rt, sl);
    const int n0 = sl * g.NB;
    const int row0 = rt * w.BM + warp * 32;
    const bool active = row0 < g.K;
    const long long t0 = (long long)chunk * w.tpc;
    const long long t1 = t0 + w.tpc < g.tiles ? t0 + w.tpc : g.tiles;
    float acc[2][NFW][4];
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int j = 0; j < NFW; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[f][j][q] = 0.f;

    __syncthreads();  // every warp is done with the last item's buffers; the tables are written
    // this lane's A chunk offsets (tap-wise) or rows (packed), per fragment
    unsigned aoff[2];
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const int row = row0 + 16 * f + ahalf;
      aoff[f] = PACKED ? (row < g.K ? (unsigned)row : kPadChunk) : (active ? tab[row / 8] : kPadChunk);
    }
    int buf = 0;
    stage_wgrad_tile(x, dy, reinterpret_cast<bf16*>(smem + l.buf), reinterpret_cast<bf16*>(smem + l.buf + l.hbytes),
                     w, t0, n0);
    for (long long t = t0; t < t1; ++t) {
      mednext::cp_async_wait_all();
      __syncthreads();  // tile t has landed; every warp is done with the other buffer
      const size_t bo = l.buf + buf * (l.hbytes + l.dbytes);
      const bf16* xh = reinterpret_cast<const bf16*>(smem + bo);
      const bf16* dt = reinterpret_cast<const bf16*>(smem + bo + l.hbytes);
      if (g.nbuf == 2 && t + 1 < t1) {
        const size_t bn = l.buf + (buf ^ 1) * (l.hbytes + l.dbytes);
        stage_wgrad_tile(x, dy, reinterpret_cast<bf16*>(smem + bn), reinterpret_cast<bf16*>(smem + bn + l.hbytes), w,
                         t + 1, n0);
      }
      if constexpr (PACKED) {  // patch[m][k], k = tap * Cin + ci, zero from 27 * Cin on: one row a thread
        if ((int)threadIdx.x < M) {
          const int m = threadIdx.x, r = m / g.XS, xm = m - r * g.XS;
          const unsigned short* h = reinterpret_cast<const unsigned short*>(xh) + (r * W2 + xm) * g.CS;
          uint4* prow = reinterpret_cast<uint4*>(patch + (size_t)m * g.KS);
          int tap = 0, ci = 0;
          for (int k8 = 0; k8 < g.K / 8; ++k8) {
            unsigned v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              if (tap < 27) {
                v[e / 2] |= (unsigned)h[tab[tap] + ci] << (16 * (e & 1));
                if (++ci == g.Cin) ci = 0, ++tap;
              }
            }
            prow[k8] = make_uint4(v[0], v[1], v[2], v[3]);
          }
        }
        __syncthreads();  // the patch is complete
      }
      if (active) {
        const unsigned xsa = smem_addr(xh), dsa = smem_addr(dt), psa = smem_addr(patch);
        auto load = [&](int st, unsigned (&a)[2][4], unsigned (&bb)[NP][4]) {
          const int m0 = st * 16, r = m0 / g.XS, xm0 = m0 - r * g.XS;
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            unsigned addr = zsa;
            if (aoff[f] != kPadChunk)
              addr = PACKED ? psa + 2 * ((m0 + avox) * g.KS + aoff[f])
                            : xsa + 2 * ((r * W2 + xm0 + avox) * g.CS + aoff[f]);
            ldsm_x4_trans_at(a[f], addr);
          }
#pragma unroll
          for (int p = 0; p < NP; ++p) ldsm_x4_trans_at(bb[p], dsa + 2 * ((m0 + bvox) * w.DS + p * 16 + bcol));
        };
        auto multiply = [&](const unsigned (&a)[2][4], const unsigned (&bb)[NP][4]) {
#pragma unroll
          for (int f = 0; f < 2; ++f)
#pragma unroll
            for (int j = 0; j < NFW; ++j) mma16816(acc[f][j], a[f], bb[j / 2][(j & 1) * 2], bb[j / 2][(j & 1) * 2 + 1]);
        };
        unsigned a0[2][4], a1[2][4], b0[NP][4], b1[NP][4];
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
        if (t + 1 < t1)
          stage_wgrad_tile(x, dy, reinterpret_cast<bf16*>(smem + l.buf),
                           reinterpret_cast<bf16*>(smem + l.buf + l.hbytes), w, t + 1, n0);
      }
      buf ^= g.nbuf - 1;
    }
    // the item's partial, from registers
    if (active) {
      float* dst = partial + ((long long)chunk * w.rows_p + row0) * g.Np + n0;
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* drow = dst + (long long)(16 * f + gq + 8 * h) * g.Np;
#pragma unroll
          for (int j = 0; j < NFW; ++j) {
            const int col = j * 8 + 2 * tq;
            if (n0 + col < g.Np) mednext::store2(drow + col, acc[f][j][2 * h], acc[f][j][2 * h + 1]);
          }
        }
    }
  }
}

// float32: the exact arithmetic on the CUDA cores (no TF32), not on the
// bf16 model's path. Thread (tr, tc) owns rows row0 + tr + 16 i and columns
// n0 + tc + 16 j (i, j < 4) of the item; per voxel it reads four x values
// and four dy values and does sixteen FMAs. One buffer.
__global__ void __launch_bounds__(kThreads, 1)
    conv3d_wgrad_f32_kernel(const float* __restrict__ x, const float* __restrict__ dy, float* __restrict__ partial,
                            WGeom w) {
  const Geom& g = w.g;
  extern __shared__ __align__(128) unsigned char smem[];
  const WgLayout l = wgrad_layout(w, 4);
  float* xh = reinterpret_cast<float*>(smem + l.buf);
  float* dt = reinterpret_cast<float*>(smem + l.buf + l.hbytes);
  const int W2 = g.XS + 2, H2 = g.R + 2;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;

  for (long long item = blockIdx.x; item < w.items; item += gridDim.x) {
    int chunk, rt, sl;
    wgrad_item(item, w, chunk, rt, sl);
    const int n0 = sl * g.NB;
    const long long t0 = (long long)chunk * w.tpc;
    const long long t1 = t0 + w.tpc < g.tiles ? t0 + w.tpc : g.tiles;
    int off[4], col[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rt * w.BM + tr + 16 * i;
      const int tap = row / g.Cin, ci = row - tap * g.Cin;
      const int dz = tap / 9, dy_ = (tap / 3) % 3, dx = tap % 3;
      off[i] = row < g.K ? ((dz * H2 + dy_) * W2 + dx) * g.CS + ci : 0;
      col[i] = tc + 16 * i < g.NB ? tc + 16 * i : 0;
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (long long t = t0; t < t1; ++t) {
      __syncthreads();  // every thread is done with the last tile
      stage_wgrad_tile(x, dy, xh, dt, w, t, n0);
      mednext::cp_async_wait_all();
      __syncthreads();
      for (int r = 0; r < g.R; ++r) {
        for (int xm = 0; xm < g.XS; ++xm) {
          const float* hv = xh + (r * W2 + xm) * g.CS;
          const float* dv = dt + (r * g.XS + xm) * w.DS;
          float a[4], d[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = hv[off[i]];
#pragma unroll
          for (int j = 0; j < 4; ++j) d[j] = dv[col[j]];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], d[j], acc[i][j]);
        }
      }
    }
    float* dst = partial + (long long)chunk * w.rows_p * g.Np + n0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rt * w.BM + tr + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tc + 16 * j;
        if (c < g.NB && n0 + c < g.Np) dst[(long long)row * g.Np + c] = acc[i][j];
      }
    }
  }
}

// The sum of the chunks' partials of each matrix element (row r < 27 *
// tap_rows, column c < Np), written to dW (Cout, Cin, 27): a block of
// kSumRows x 32 threads takes 32 elements; thread row q sums chunks q, q +
// kSumRows, ..., then row 0 adds the kSumRows sums in order. Rows of
// padding channels and columns past Cout are dropped.
constexpr int kSumRows = 32;

__global__ void __launch_bounds__(kSumRows * 32)
    conv3d_wgrad_sum_kernel(const float* __restrict__ partial, float* __restrict__ out, WGeom w) {
  const Geom& g = w.g;
  const long long n = 27LL * w.tap_rows * g.Np;
  __shared__ float s[kSumRows][33];
  const int col = threadIdx.x & 31, row = threadIdx.x >> 5;
  const long long i = (long long)blockIdx.x * 32 + col;
  const long long cstride = (long long)w.rows_p * g.Np;
  float acc = 0.f;
  if (i < n) {
    int it = row;
    for (; it + 3 * kSumRows < w.chunks; it += 4 * kSumRows) {
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = partial[(it + k * kSumRows) * cstride + i];
#pragma unroll
      for (int k = 0; k < 4; ++k) acc += v[k];
    }
    for (; it < w.chunks; it += kSumRows) acc += partial[it * cstride + i];
  }
  s[row][col] = acc;
  __syncthreads();
  if (row == 0 && i < n) {
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < kSumRows; ++r) t += s[r][col];
    const int mrow = (int)(i / g.Np), co = (int)(i - (long long)mrow * g.Np);
    const int tap = mrow / w.tap_rows, ci = mrow - tap * w.tap_rows;
    if (ci < g.Cin && co < g.Cout) out[((long long)co * g.Cin + ci) * 27 + tap] = t;
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

using mednext::sm_count;

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

// Plans by shape: a launch looks its plan, kernel and grid up here instead
// of searching the planner's space and asking the card again (a few
// microseconds of host work each). Entries are never evicted; past
// kCacheSize shapes a launch plans afresh.
constexpr int kCacheSize = 256;
constexpr int kKey = 11;  // device, shape (7), a plan forced by the caller (3)

template <typename G>
struct PlanCache {
  struct Entry {
    long long key[kKey];
    G g;
    const void* fn;
    unsigned blocks;
  };
  std::mutex mu;
  Entry e[kCacheSize];
  int n = 0;
  bool get(const long long (&k)[kKey], G& g, const void*& fn, unsigned& blocks) {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < n; ++i) {
      bool same = true;
      for (int j = 0; j < kKey && same; ++j) same = e[i].key[j] == k[j];
      if (same) {
        g = e[i].g, fn = e[i].fn, blocks = e[i].blocks;
        return true;
      }
    }
    return false;
  }
  void put(const long long (&k)[kKey], const G& g, const void* fn, unsigned blocks) {
    std::lock_guard<std::mutex> lock(mu);
    if (n == kCacheSize) return;
    for (int j = 0; j < kKey; ++j) e[n].key[j] = k[j];
    e[n].g = g, e[n].fn = fn, e[n].blocks = blocks;
    ++n;
  }
};

using FwdKernel = void (*)(const bf16*, const bf16*, const float*, bf16*, Geom);
using FwdKernelF32 = void (*)(const float*, const float*, const float*, float*, Geom);

// The plan, kernel and grid of a forward launch of this shape on the
// current device, from the cache or planned and put there. 0 or an error
// code.
template <typename T>
int fwd_plan(int B, int Z, int Y, int X, int Cin, int Cout, Geom& g, const void*& fn, unsigned& blocks) {
  static PlanCache<Geom> cache;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const long long key[kKey] = {dev, B, Z, Y, X, Cin, Cout, (long long)sizeof(T), 0, 0, 0};
  if (cache.get(key, g, fn, blocks)) return 0;
  if (B < 1 || Z < 1 || Y < 1 || X < 1 || Cin < 1 || Cout < 1) return kErrShape;
  if ((long long)B * Z * Y * X * (Cin > Cout ? Cin : Cout) >= (1LL << 62)) return kErrShape;
  const int es = (int)sizeof(T), sms = sm_count();
  g = Geom{};
  g.B = B, g.Z = Z, g.Y = Y, g.X = X, g.Cin = Cin, g.Cout = Cout;
  if (!plan(g, es, sms)) return kErrShape;
  if constexpr (std::is_same<T, bf16>::value) {
    fn = reinterpret_cast<const void*>(g.packed ? taps_kernel<true>(g) : taps_kernel<false>(g));
  } else {
    const int row_bytes = Cin * es;
    FwdKernelF32 k = row_bytes % 16 == 0 ? conv3d_f32_kernel<16>
                     : row_bytes % 8 == 0 ? conv3d_f32_kernel<8>
                                          : conv3d_f32_kernel<4>;
    fn = reinterpret_cast<const void*>(k);
  }
  if (!fn) return kErrShape;
  // all of the SM's unified L1/shared memory as shared: as many blocks as fit
  int occ = 0;
  const int rc = mednext::occupancy(fn, kThreads, smem_bytes(g, es), &occ);
  if (rc) return rc;
  if (occ < 1) return kErrShape;
  const long long want = ((long long)sms * occ + g.slices - 1) / g.slices;
  blocks = (unsigned)(g.tiles < want ? g.tiles : want);
  cache.put(key, g, fn, blocks);
  return 0;
}

template <typename T>
int run(const void* x, const void* w, const void* bias, void* out, int B, int Z, int Y, int X, int Cin, int Cout,
        int w_rows, int w_cols, cudaStream_t stream) {
  Geom g;
  const void* fn = nullptr;
  unsigned blocks = 0;
  const int rc = fwd_plan<T>(B, Z, Y, X, Cin, Cout, g, fn, blocks);
  if (rc) return rc;
  if (w_rows != g.K || w_cols != g.Np) return kErrShape;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const float* bp = static_cast<const float*>(bias);
  T* op = static_cast<T*>(out);
  void* args[] = {&xp, &wp, &bp, &op, &g};
  const cudaError_t e =
      cudaLaunchKernel(fn, dim3(blocks, g.slices), dim3(kThreads), args, smem_bytes(g, (int)sizeof(T)), stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// The weight gradient's plan, from the shape alone (the chunks too, so
// that the sums are the same bits on any grid): the forward's weight-row
// layout; slices of at most 80 columns (bf16) or 64 (f32); the tile (XS,
// R) and buffers of least estimated time; then chunks of consecutive tiles
// for about two items per SM of an H100 (132), their partials at most
// kPartialBytes. The bf16 estimate, fitted to the card's sweep of every
// tile at RSUNet's training shapes (tools/conv3d_wgrad_plans.py, PERF.md):
// a tile's visit costs about kTileClk plus kStepClk a k-step of 16 voxels
// (at 6 n8 fragments a warp; in proportion to them), whether or not a
// second buffer stages the next tile under it (it bought 1-3%), so the
// largest tile that fits wins unless it runs far past the volume's edge;
// the stem's patch adds about 2 K + 500. f32 (the check path): a voxel
// about 24 thread instructions a thread, staging a clock per 32 bytes and
// kTileClk a tile.
constexpr int kNominalSms = 132;
constexpr double kTileClk = 6000.0;
constexpr double kStepClk = 1400.0;
constexpr long long kPartialBytes = 64LL << 20;

inline bool plan_wgrad(WGeom& w, int es, int force_xs = 0, int force_r = 0, int force_nbuf = 0) {
  Geom& g = w.g;
  g.K = weight_rows(g.Cin, es, &g.CP, &g.packed);
  g.Np = round_up(g.Cout, 16);
  if (es == 2) {
    g.CS = g.packed ? g.CP : odd_stride(g.CP);
    g.KS = odd_stride(g.K);
    const int row = g.Cin * 2;
    g.vecb = row % 16 == 0 ? 16 : row % 8 == 0 ? 8 : row % 4 == 0 ? 4 : 2;
    const int sl = (g.Np + 79) / 80;
    g.NB = round_up((g.Np + sl - 1) / sl, 16);
    w.DS = odd_stride(g.NB);
    w.BM = 8 * 32;
    w.tap_rows = g.packed ? g.Cin : g.CP;
  } else {
    g.CS = g.CP;
    g.KS = g.K;
    const int row = g.Cin * 4;
    g.vecb = row % 16 == 0 ? 16 : row % 8 == 0 ? 8 : 4;
    g.NB = g.Np < kWgradF32Cols ? g.Np : kWgradF32Cols;
    w.DS = g.NB;
    w.BM = kWgradF32Rows;
    w.tap_rows = g.Cin;
  }
  g.slices = (g.Np + g.NB - 1) / g.NB;
  const int drow = g.Cout * es;
  w.dvecb = drow % 16 == 0 ? 16 : drow % 8 == 0 ? 8 : drow % 4 == 0 ? 4 : es;
  w.row_tiles = (g.K + w.BM - 1) / w.BM;
  w.rows_p = w.row_tiles * w.BM;
  const int maxm = es == 4 ? 64 : g.packed ? kThreads : kWgradMaxM;  // packed: a patch row a thread
  const int nfw = g.NB / 8;
  double best = -1;
  WGeom pick = w;
  for (int xs = 16; xs <= 64 && xs <= round_up(g.X, 16); xs += 16) {
    for (int r = 1; r <= g.Y && r * xs <= maxm; ++r) {
      for (int nbuf = es == 2 ? 2 : 1; nbuf >= 1; --nbuf) {
        if (force_xs && (xs != force_xs || r != force_r || nbuf != force_nbuf)) continue;
        WGeom c = w;
        c.g.XS = xs, c.g.R = r, c.g.nbuf = nbuf;
        const int last = ((2 * (r + 2) + 2) * (xs + 2) + 2) * c.g.CS + c.g.CP;
        if (wgrad_layout(c, es).total > kMaxSmem || last >= (int)kPadChunk) continue;
        finish(c.g);
        const WgLayout l = wgrad_layout(c, es);
        const double tile =
            es == 2 ? kTileClk - (nbuf == 2 ? 300.0 : 0.0) + (r * xs / 16) * kStepClk * nfw / 6.0 +
                          (g.packed ? 2.0 * g.K + 500.0 : 0.0)
                    : kTileClk + r * xs * 24.0 * 16.0 + (double)(l.hbytes + l.dbytes) / 32.0;
        const double cost = (double)c.g.tiles * tile;
        if (best < 0 || cost < best) best = cost, pick = c;
      }
    }
  }
  if (best < 0) return false;
  w = pick;
  const long long per = (long long)w.row_tiles * g.slices;
  long long chunks = (2LL * kNominalSms + per - 1) / per;
  const long long cap = kPartialBytes / ((long long)w.rows_p * g.Np * 4);
  if (chunks > cap) chunks = cap;
  if (chunks > g.tiles) chunks = g.tiles;
  if (chunks < 1) chunks = 1;
  const long long tpc = (g.tiles + chunks - 1) / chunks;
  if (tpc > (1LL << 30)) return false;
  w.tpc = (int)tpc;
  w.chunks = (int)((g.tiles + tpc - 1) / tpc);
  w.items = (long long)w.chunks * per;
  return true;
}

using WgradKernel = void (*)(const bf16*, const bf16*, float*, WGeom);

template <bool PACKED>
WgradKernel wgrad_kernel(int nfw) {
  switch (nfw) {
    case 2:
      return conv3d_wgrad_kernel<2, PACKED>;
    case 4:
      return conv3d_wgrad_kernel<4, PACKED>;
    case 6:
      return conv3d_wgrad_kernel<6, PACKED>;
    case 8:
      return conv3d_wgrad_kernel<8, PACKED>;
    case 10:
      return conv3d_wgrad_kernel<10, PACKED>;
  }
  return nullptr;
}

// The weight gradient's plan, kernel and default grid on the current
// device, cached by shape.
// force_xs, force_r, force_nbuf: a tile and buffers in the place of the
// planner's (0: the planner's), for sweeps; a forced plan that does not fit
// is refused.
inline int wgrad_plan(int es, int B, int Z, int Y, int X, int Cin, int Cout, int force_xs, int force_r,
                      int force_nbuf, WGeom& w, const void*& fn, unsigned& blocks) {
  static PlanCache<WGeom> cache;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const long long key[kKey] = {dev, B, Z, Y, X, Cin, Cout, es, force_xs, force_r, force_nbuf};
  if (cache.get(key, w, fn, blocks)) return 0;
  if (B < 1 || Z < 1 || Y < 1 || X < 1 || Cin < 1 || Cout < 1) return kErrShape;
  if ((long long)B * Z * Y * X * (Cin > Cout ? Cin : Cout) >= (1LL << 62)) return kErrShape;
  w = WGeom{};
  w.g.B = B, w.g.Z = Z, w.g.Y = Y, w.g.X = X, w.g.Cin = Cin, w.g.Cout = Cout;
  if (!plan_wgrad(w, es, force_xs, force_r, force_nbuf)) return kErrShape;
  if (es == 2) {
    fn = reinterpret_cast<const void*>(w.g.packed ? wgrad_kernel<true>(w.g.NB / 8) : wgrad_kernel<false>(w.g.NB / 8));
  } else {
    fn = reinterpret_cast<const void*>(conv3d_wgrad_f32_kernel);
  }
  if (!fn) return kErrShape;
  int occ = 0;
  const int rc = mednext::occupancy(fn, kThreads, wgrad_layout(w, es).total, &occ);
  if (rc) return rc;
  if (occ < 1) return kErrShape;
  const long long want = (long long)sm_count() * occ;
  blocks = (unsigned)(w.items < want ? w.items : want);
  cache.put(key, w, fn, blocks);
  return 0;
}

template <typename T>
int run_wgrad(const void* x, const void* dy, void* partial, long long partial_floats, void* out, int B, int Z, int Y,
              int X, int Cin, int Cout, int grid, const int* force, cudaStream_t stream) {
  const int es = (int)sizeof(T);
  WGeom w;
  const void* fn = nullptr;
  unsigned blocks = 0;
  const int rc = wgrad_plan(es, B, Z, Y, X, Cin, Cout, force[0], force[1], force[2], w, fn, blocks);
  if (rc) return rc;
  if (partial_floats < (long long)w.chunks * w.rows_p * w.g.Np) return kErrShape;
  if (grid > 0) blocks = (unsigned)(grid < w.items ? grid : w.items);
  const T* xp = static_cast<const T*>(x);
  const T* dp = static_cast<const T*>(dy);
  float* pp = static_cast<float*>(partial);
  void* args[] = {&xp, &dp, &pp, &w};
  cudaError_t e = cudaLaunchKernel(fn, dim3(blocks), dim3(kThreads), args, wgrad_layout(w, es).total, stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n = 27LL * w.tap_rows * w.g.Np;
  conv3d_wgrad_sum_kernel<<<(unsigned)((n + 31) / 32), kSumRows * 32, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), w);
  return (int)cudaGetLastError();
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

// The weight gradient's plan for reports and for the wrapper's scratch:
// plan[0..11] = XS, R, NB, slices, buffers, rows a chunk (rows_p), chunks,
// tiles a chunk, items, shared-memory bytes, default grid, floats of the
// partials (chunks x rows_p x Np). Items and chunks do not depend on the
// grid. force[0..2]: XS, R and buffers in the place of the planner's, or 0.
int conv3d_3x3_wgrad_plan(int dtype, int B, int Z, int Y, int X, int Cin, int Cout, const int* force,
                          long long* plan) {
  conv3d::WGeom w;
  const void* fn = nullptr;
  unsigned blocks = 0;
  const int es = dtype ? 2 : 4;
  const int rc = conv3d::wgrad_plan(es, B, Z, Y, X, Cin, Cout, force[0], force[1], force[2], w, fn, blocks);
  if (rc) return rc;
  const long long v[12] = {w.g.XS, w.g.R, w.g.NB, w.g.slices, w.g.nbuf, w.rows_p, w.chunks, w.tpc, w.items,
                           (long long)conv3d::wgrad_layout(w, es).total, blocks,
                           (long long)w.chunks * w.rows_p * w.g.Np};
  for (int i = 0; i < 12; ++i) plan[i] = v[i];
  return 0;
}

// dW (Cout, Cin, 3, 3, 3) float32 of the conv of x (B, Z, Y, X, Cin) whose
// output gradient is dy (B, Z, Y, X, Cout), both contiguous, 16-byte aligned
// and of one dtype; partial: float32 scratch of at least partial_floats
// (conv3d_3x3_wgrad_plan); grid: persistent blocks, 0 for the default (the
// result does not depend on it); force: as for conv3d_3x3_wgrad_plan (the
// partials follow the tile, so a forced plan sums in another order). Two
// kernels on the stream.
int conv3d_3x3_wgrad(const void* x, const void* dy, void* partial, long long partial_floats, void* out, int dtype,
                     int B, int Z, int Y, int X, int Cin, int Cout, int grid, const int* force, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype)
    return conv3d::run_wgrad<conv3d::bf16>(x, dy, partial, partial_floats, out, B, Z, Y, X, Cin, Cout, grid, force, s);
  return conv3d::run_wgrad<float>(x, dy, partial, partial_floats, out, B, Z, Y, X, Cin, Cout, grid, force, s);
}

const char* conv3d_3x3_error_string(int code) {
  if (code == conv3d::kErrShape) return "shape not supported by the conv3d 3^3 kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
