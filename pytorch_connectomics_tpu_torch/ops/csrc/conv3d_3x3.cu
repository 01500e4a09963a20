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
// - Any Cin: where the weight slice of the whole Cin does not fit beside a
//   halo tile (bf16 past Cin 192, f32 past 97; the MONAI U-Nets reach 256
//   and UNETR 384), Cin is streamed in chunks of Cc channels, one launch a
//   chunk of the same kernel (plan_chunks): each launch stages its
//   chunk's channels of the halo (x read at its full channel stride XC
//   from channel c0) and its chunk's rows of the weight matrix (the
//   wrapper's matrix of the whole Cin, mapped row by row), and keeps its
//   f32 sums; the first launch stores them in an f32 scratch of (voxels,
//   Cout), the middle ones add to it, and the last adds its sums to the
//   scratch's, rounds the total once to the output type and adds the bias
//   (f32: the output is the scratch). So the function stays one f32 sum
//   over all of Cin, one rounding, then the bias. A Cin that fits takes
//   one launch with today's plan and bits (chunks 1, mode 0).
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
  // Cin streamed in chunks (forward only; 1 chunk and mode 0 otherwise)
  int XC;       // channels of an x voxel in memory (the stride of a voxel): the whole Cin
  int chunks;   // launches over Cin; Cin above is a chunk's channels (Cc, the last may have fewer)
  int wtap;     // rows a tap takes in the weight matrix of the whole Cin (CP of XC; f32: XC)
  int c0;       // this launch's first channel
  int mode;     // 0 one launch; 1 first chunk (store the sums), 2 middle (add), 3 last (add, round, bias)
  float* part;  // bf16 with chunks: f32 scratch (voxels, Cout) of the earlier chunks' sums
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
          v[u] = x[((((long long)b * g.Z + zg) * g.Y + yg) * g.X + xg) * g.XC + q];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (d[u] >= 0) halo[d[u]] = v[u];
  }
}

// Stage the (3, R+2, XS+2) neighbourhood of the tile at (b, z, y0, x0) into
// halo[cell][CS]: channels 0..Cin-1 copied (x's voxels XC channels apart,
// x at this launch's first channel), Cin..CP-1 zero-filled, cells
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
        cp_async<VEC>(dst + xx * g.CS + q * per, valid ? x + (vrow + xg) * g.XC + q * per : x, valid);
      }
    }
  }
}

// The block's weight slice, transposed and resident: wsm[n * KS + k] =
// W[row(k)][n0 + n], zero for a column past Np. Row k of the launch (tap k
// / CP, channel k % CP) is row tap * wtap + c0 + channel of the whole
// Cin's matrix, zero past its tap's rows or past the 27 taps (one launch:
// row k itself). 16-byte loads along a weight row (NB, Np and n0 are
// multiples of 16); the first tile's barrier publishes the slice.
template <typename T>
__device__ __forceinline__ void load_weight_slice(const T* __restrict__ wg, T* __restrict__ wsm, const Geom& g,
                                                  int n0) {
  constexpr int per = 16 / (int)sizeof(T);
  const int nv = g.NB / per;
  for (int i = threadIdx.x; i < g.K * nv; i += kThreads) {
    const int k = i / nv, n = (i - k * nv) * per;
    const int tap = k / g.CP, ch = g.c0 + k - tap * g.CP;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (n0 + n < g.Np && tap < 27 && ch < g.wtap)
      raw = __ldg(reinterpret_cast<const uint4*>(wg + (size_t)(tap * g.wtap + ch) * g.Np + n0 + n));
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

// A chunked launch's sums of output channels co, co + 1 of one voxel (p: its
// row of the scratch at co): the first chunk stores them, a middle one adds
// them to the scratch, the last adds the scratch's to them (true: store).
__device__ __forceinline__ bool chunk_sums(float* __restrict__ p, float& s0, float& s1, int co, int Cout, int mode) {
  const bool one = co + 1 >= Cout;
  if (mode == 3) {
    s0 += p[0];
    if (!one) s1 += p[1];
    return true;
  }
  if (mode == 2) s0 += p[0], s1 += one ? 0.f : p[1];
  p[0] = s0;
  if (!one) p[1] = s1;
  return false;
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
          const long long vox = (((long long)b * g.Z + z) * g.Y + yg) * g.X + xg;
          bf16* orow = out + vox * g.Cout;
#pragma unroll
          for (int j = 0; j < NFW; ++j) {
            const int co = n0 + nw0 + j * 8 + 2 * tq;
            if (co >= g.Cout) continue;
            float s0 = acc[f][j][2 * rh], s1 = acc[f][j][2 * rh + 1];
            if (g.mode && !chunk_sums(g.part + vox * g.Cout + co, s0, s1, co, g.Cout, g.mode)) continue;
            store_pair(orow + co, s0, s1, bv[j][0], bv[j][1], has_bias, co, g.Cout, two);
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
      float* dst = out + ((((long long)b * g.Z + z) * g.Y + yg) * g.X + xg) * g.Cout + co;
      if (g.mode) {  // chunked: the output holds the earlier chunks' sums
        if (g.mode > 1) v += *dst;
        if (g.mode < 3) {
          *dst = v;
          continue;
        }
      }
      if (bias) v += __ldg(bias + co);
      *dst = v;
    }
    __syncthreads();  // the halo is reused by the next tile
  }
}

// ---------------------------------------------------------------------------
// the weight gradient: dW[tap][ci][co] = sum_v x(v + tap - 1)[ci] * dy(v)[co]
// ---------------------------------------------------------------------------

// No TPU kernel computes it: XLA differentiates conv3d_3x3_pallas
// (pytorch_connectomics_tpu/ops/conv3d_pallas.py:84), so the port has a
// kernel of its own, as it has for the depthwise conv's. It is the product of
// the forward's weight-row layout (rows: tap-major taps x channels; columns:
// Cout) reduced over every voxel of the batch:
//     G[row][co] = sum_v A[row][v] * dy[v][co],  A[row][v] = x[v + tap(row) - 1][ci(row)]
// in f32, zero outside the volume. An item is one block's share of it: a
// chunk of consecutive tiles (R rows of XS voxels in one z slice, as the
// forward's) times a set of rows (and, past 128 output channels, a slice of
// columns); its partial sums go to partial[chunk][row][col], and
// conv3d_wgrad_sum_kernel adds the chunks in a fixed order. Items, chunks
// and rows follow from the shape alone, so the result is the same bits for
// every launch and any grid.
//
// Bound on an H100 (chip_smoke.py::wgrad_bounds): 2 * 27 * Cin * Cout FLOP a
// voxel against (Cin + Cout) * 2 bytes read, 27 Cin Cout / (Cin + Cout) FLOP
// a byte: the bf16 tensor cores bound every RSUNet layer shape but the stem
// (Cin 1: bytes). At SNEMI's 36 -> 36 on 8 x 18 x 80 x 80 the product is 43
// GFLOP, 44 us at 989 TFLOP/s.
//
// The bf16 kernel (conv3d_wgrad_wgmma_kernel), against what held the first
// design (items of 256 rows on mma.sync) back:
// 1. wgmma.mma_async m64nNk16, bf16 in and f32 accumulate, with N = Cout
//    rounded up to a multiple of 8 that is instantiated (kWgN: every width
//    RSUNet and the tests use; 32, 40, 48, 64, 80 for RSUNet, 104 for Cout
//    100): all of Cout is one instruction, so a tile's products run once and
//    not once per column slice. Past 128 columns the columns are sliced.
// 2. A (rows x 16 voxels) comes from registers: the 64 rows of an M tile mix
//    taps whose halo offsets are not at one stride, which a shared-memory
//    descriptor cannot express, so each warp loads its 16 rows with one
//    ldmatrix.x4.trans through the chunk table (a halo cell's 8 channels of
//    one tap are 8 rows of A for one voxel); the register fragment of wgmma
//    is mma.sync's. B (16 voxels x N of dy) is read by wgmma from shared
//    memory through a matrix descriptor: the producer stages dy in 8 x 8 core
//    matrices (8 voxels of 16 bytes), MN-major, no swizzle. A warp's loads a
//    k-step fall from 2 + N/16 ldmatrix to one per M tile.
// 3. Rows are padded to 64 per row block, not to 256 (Cin 36 with tap groups:
//    9 taps x 40 rows = 360 -> 384; all 27 taps: 1080 -> 1088).
// 4. Loads run off the critical path with no block barrier a tile: warps
//    8-11 are the producer; they keep a ring of `stages` (x slices, dy tile)
//    stages in flight with cp.async (TMA needs 16-byte global strides, which
//    the channels-last rows of Cin 28 and 36, SNEMI's largest layers, lack)
//    and signal each stage on a full mbarrier (cp.async.mbarrier.arrive);
//    the two consumer warpgroups wait on it, fence the async proxy, run
//    their products and release the stage on an empty mbarrier after
//    wgmma.wait_group. The only block barrier is the one after the barriers'
//    init. A's registers are double-buffered: the next k-step's ldmatrix runs
//    while this one's wgmma does. The staging is bound by the producer's
//    issue rate on an H100, so the producer is a warpgroup and not one warp
//    (ptxas gives a 288-thread block the registers of 384 threads, 168 a
//    thread, all the same), and each of its threads copies whole cells and
//    voxels, a few instructions a unit (produce_x, produce_dy).
// 5. A staged tile feeds every row of its item: two warpgroups of `mt` M
//    tiles each (up to 8 x 64 = 512 rows). With tap groups (`tap_groups` 3,
//    the planner's pick wherever it costs less), an item takes one dz: 9
//    taps x CP rows, and its stage holds one z slice of the halo, (R+2) x
//    (XS+2) cells, not three; a tile whose slice lies outside the volume is
//    skipped by producer and consumers alike.
// 6. The stem (Cin < 8) runs the same kernel: rows are taps x Cin packed (27
//    rows, one M tile), and since a fragment's 8 rows are then not 8
//    contiguous channels, each thread gathers its A values with scalar shared
//    loads (PACKED). ptxas serializes these kernels' products (C7513: the
//    gathered registers are defined inside wgmma's pipeline); the stem is
//    bound by its bytes (Cin 1) and took 0.18 ms at NucMM-Z's 64^3 batch of
//    8 on an H100 all the same.
// Padded channels and columns are neither copied nor zeroed: only their own
// rows and columns of the product see them, and the sum drops those.
//
// float32 (conv3d_wgrad_f32_kernel) is the exact check path on the CUDA
// cores, the first design: items of (chunk, 64 rows, 64 columns), one buffer.

struct WGeom {
  Geom g;           // x side: tiles, halo cells of CP channels at stride CS, Cin, Cout, packed; f32: NB, Np, slices
  // the f32 kernel
  int DS;           // stride of a staged dy voxel (>= NB)
  int dvecb;        // bytes of one dy staging copy (both kernels)
  int BM;           // rows of an item
  int row_tiles;    // ceil(K / BM)
  // both kernels: the partials and their sum
  int tap_rows;     // rows a tap takes: CP (bf16 tap-wise) or Cin (packed, f32)
  int taps;         // taps of a row block: 27, or 9 with tap groups (one dz a block)
  int rb;           // rows of a row block
  int rows_p;       // rows of a chunk's partial: every row block
  int cols;         // columns of a partial row
  int tpc;          // tiles per chunk
  int chunks;
  long long items;
  // the bf16 kernel
  int N;            // columns of one product: wgmma's N
  int mt;           // M tiles (64 rows) a consumer warpgroup holds
  int rg;           // row groups of a row block, 2 * mt M tiles each
  int stages;       // ring stages
  int zs;           // z slices a stage holds: 3, or 1 with tap groups
  unsigned xbytes;  // a stage's x part: zs x (R+2) x (XS+2) cells of CS channels
  unsigned dbytes;  // and its dy part: R*XS voxels x N columns in core matrices
};

constexpr int kWgradF32Rows = 64;  // rows of an f32 item: 16 thread rows x 4
constexpr int kWgradF32Cols = 64;  // columns of an f32 item: 16 thread columns x 4

// Shared memory of the f32 kernel: one buffer of (x halo, dy tile).
struct WgLayout {
  size_t buf, hbytes, dbytes, total;
};

__host__ __device__ inline WgLayout wgrad_f32_layout(const WGeom& w) {
  const Geom& g = w.g;
  WgLayout l;
  l.buf = 0;
  l.hbytes = align16((size_t)3 * (g.R + 2) * (g.XS + 2) * g.CS * 4);
  l.dbytes = align16((size_t)g.R * g.XS * w.DS * 4);
  l.total = l.hbytes + l.dbytes;
  return l;
}

// Stage dy of the tile at (b, z, y0, x0), channels n0 .. n0 + NB - 1, into
// dst[m][DS] (m = r * XS + xm), zero outside the volume and past Cout. VEC
// is the copy width in bytes (4: loads and stores).
template <int VEC>
__device__ __forceinline__ void stage_dy_f32(const float* __restrict__ dy, float* __restrict__ dst, const WGeom& w,
                                             int b, int z, int y0, int x0, int n0) {
  const Geom& g = w.g;
  constexpr int per = VEC / 4;
  const int vall = g.NB / per;
  const int total = g.R * g.XS * vall;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int m = i / vall, q = i - m * vall;
    const int r = m / g.XS, xm = m - r * g.XS;
    const int yg = y0 + r, xg = x0 + xm, n = n0 + q * per;
    const bool valid = yg < g.Y && xg < g.X && n < g.Cout;
    const long long src = ((((long long)b * g.Z + z) * g.Y + yg) * g.X + xg) * g.Cout + n;
    if constexpr (VEC == 4) {
      dst[m * w.DS + q] = valid ? dy[src] : 0.f;
    } else {
      cp_async<VEC>(dst + m * w.DS + q * per, valid ? dy + src : dy, valid);
    }
  }
}

// Issue the copies of tile t (x halo and dy) into the f32 kernel's buffer.
__device__ __forceinline__ void stage_wgrad_f32_tile(const float* __restrict__ x, const float* __restrict__ dy,
                                                     float* __restrict__ xh, float* __restrict__ dt, const WGeom& w,
                                                     long long t, int n0) {
  const Geom& g = w.g;
  int b, z, y0, x0;
  tile_origin(t, g, b, z, y0, x0);
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
  switch (w.dvecb) {
    case 16:
      stage_dy_f32<16>(dy, dt, w, b, z, y0, x0, n0);
      break;
    case 8:
      stage_dy_f32<8>(dy, dt, w, b, z, y0, x0, n0);
      break;
    default:
      stage_dy_f32<4>(dy, dt, w, b, z, y0, x0, n0);
  }
}

// f32 item i: its chunk, tile of rows and slice of columns.
__device__ __forceinline__ void wgrad_f32_item(long long i, const WGeom& w, int& chunk, int& rt, int& sl) {
  sl = (int)(i % w.g.slices);
  const long long t = i / w.g.slices;
  rt = (int)(t % w.row_tiles);
  chunk = (int)(t / w.row_tiles);
}

// ---- the bf16 kernel on wgmma ----

constexpr int kWgConsumers = 2;                       // consumer warpgroups
constexpr int kWgProducer = 128;                      // and one producer warpgroup
constexpr int kWgThreads = kWgConsumers * 128 + kWgProducer;
constexpr int kWgMaxStages = 6;
constexpr int kWgMaxM = 512;   // voxels of a tile
constexpr int kWgMaxN = 128;   // columns of one product; wider Cout is sliced
constexpr unsigned kPad = 0xFFFFFFFFu;  // row table: a row (chunk) past the block's taps

__device__ __forceinline__ void mbar_init(unsigned a, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(a), "r"(count) : "memory");
}

// Wait until the barrier's phase of this parity has completed. A wait of
// seconds is a fault (a producer and its consumers that disagree): trap
// rather than hang the card.
__device__ __forceinline__ void mbar_wait(unsigned a, unsigned parity) {
  unsigned ok = 0;
  const long long t0 = clock64();
  while (!ok) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(a), "r"(parity)
        : "memory");
    if (!ok && clock64() - t0 > (1LL << 33)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(unsigned a) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(a) : "memory");
}

// The barrier's current phase also waits for every cp.async this thread has
// issued so far (the pending count is raised now and lowered when they land).
__device__ __forceinline__ void mbar_arrive_copies(unsigned a) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(a) : "memory");
}

// Orders the generic proxy's writes to shared memory (the producer's copies,
// acquired through the full barrier) before the async proxy's reads (wgmma's B).
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across this
// point (wgmma writes them asynchronously).
template <int K>
__device__ __forceinline__ void fence_regs(float (&r)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// A shared-memory matrix descriptor without swizzle: the start address, the
// leading byte offset (between core matrices along K: here 8 voxels) and the
// stride byte offset (along N: here 8 columns), in units of 16 bytes.
__device__ __forceinline__ unsigned long long smem_desc(unsigned addr, unsigned lbo, unsigned sbo) {
  return (unsigned long long)((addr & 0x3FFFF) >> 4) | ((unsigned long long)(lbo >> 4) << 16) |
         ((unsigned long long)(sbo >> 4) << 32);
}

// D (64 x N, f32, registers) += A (64 x 16, bf16, registers) * B (16 x N,
// bf16, shared memory, MN-major): one specialization per instruction width.
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], const unsigned (&a)[4], unsigned long long desc);

template <>
__device__ __forceinline__ void wgmma_bf16<8>(float (&d)[4], const unsigned (&a)[4], unsigned long long desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<16>(float (&d)[8], const unsigned (&a)[4], unsigned long long desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<24>(float (&d)[12], const unsigned (&a)[4], unsigned long long desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, {%12, %13, %14, %15}, %16, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16], const unsigned (&a)[4], unsigned long long desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<40>(float (&d)[20], const unsigned (&a)[4], unsigned long long desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19"
      "}, {%20, %21, %22, %23}, %24, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<48>(float (&d)[24], const unsigned (&a)[4], unsigned long long desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], const unsigned (&a)[4], unsigned long long desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<80>(float (&d)[40], const unsigned (&a)[4], unsigned long long desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<104>(float (&d)[52], const unsigned (&a)[4], unsigned long long desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51"
      "}, {%52, %53, %54, %55}, %56, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], const unsigned (&a)[4], unsigned long long desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Shared memory of the bf16 kernel: full and empty barriers per stage, the
// row table, a zero chunk of 16 bytes, then the ring of stages (x part, dy
// part).
struct WgmmaLayout {
  size_t full, empty, tab, zero, ring, total;
};

__host__ __device__ inline WgmmaLayout wgmma_layout(const WGeom& w) {
  WgmmaLayout l;
  l.full = 0;
  l.empty = 8 * kWgMaxStages;
  l.tab = 16 * kWgMaxStages;
  l.zero = align16(l.tab + (size_t)(w.g.packed ? w.rb : w.rb / 8) * 4);
  l.ring = align128(l.zero + 16);
  l.total = l.ring + (size_t)w.stages * (w.xbytes + w.dbytes);
  return l;
}

// The producer's copies: a cell (x) or a voxel (dy) a producer thread at a
// time (pt of kWgProducer), all of its VX-byte units in a row, so that a
// unit costs a few instructions (the staging is bound by the producer's
// issue: with a cell's units spread over the lanes, about 20 instructions a
// unit, SNEMI's 36 -> 36 took 0.49 ms on an H100 against 0.31 this way, at
// the same plan in tools/conv3d_wgrad_plans.py's sweeps).
// Each lane starts at another unit of its cell, so that a warp's stores fall
// on other banks; indices walk without a division. Cells and voxels outside
// the volume are zero-filled, padded channels and columns not written.
template <int VX>
__device__ __forceinline__ void copy_unit(unsigned char* d, const bf16* s, bool valid) {
  if constexpr (VX == 2) {
    *reinterpret_cast<bf16*>(d) = valid ? *s : from_f32<bf16>(0.f);
  } else {
    cp_async<VX>(d, s, valid);
  }
}

// The stage's x part: zs z slices from zf of (R+2) rows from y0 - 1 of XS + 2
// cells from x0 - 1.
template <int VX>
__device__ __forceinline__ void produce_x(const bf16* __restrict__ x, unsigned char* st, const Geom& g, int b, int zf,
                                          int y0, int x0, int zs, int pt) {
  constexpr int per = VX / 2;
  const int vec = g.Cin / per;  // units a cell
  const int W2 = g.XS + 2, H2 = g.R + 2;
  const int cells = zs * H2 * W2;
  const int dyy = kWgProducer / W2, dxx = kWgProducer - dyy * W2;
  int yy = pt / W2, xx = pt - yy * W2, s = 0;
  while (yy >= H2) yy -= H2, ++s;
  const int q0 = (pt & 31) % vec;
  for (int c = pt; c < cells; c += kWgProducer) {
    const int zg = zf + s, yg = y0 + yy - 1, xg = x0 + xx - 1;
    const bool valid = zg >= 0 && zg < g.Z && yg >= 0 && yg < g.Y && xg >= 0 && xg < g.X;
    unsigned char* d = st + (size_t)((s * H2 + yy) * W2 + xx) * 2 * g.CS;
    const bf16* src = valid ? x + ((((long long)b * g.Z + zg) * g.Y + yg) * g.X + xg) * g.Cin : x;
    const int sp = valid ? per : 0;
    int q = q0;
    const bf16* sq = src + q * sp;
    for (int k = 0; k < vec; ++k) {
      copy_unit<VX>(d + q * VX, sq, valid);
      sq += sp;
      if (++q == vec) q = 0, sq = src;
    }
    xx += dxx;
    yy += dyy;
    if (xx >= W2) xx -= W2, ++yy;
    while (yy >= H2) yy -= H2, ++s;
  }
}

// The stage's dy part: the R*XS voxels of the tile at (b, z, y0, x0),
// columns n0 .. of its slice (the real ones), in core matrices: voxel m,
// column c at byte (m / 8) * 16 N + (c / 8) * 128 + (m % 8) * 16 + (c % 8) * 2.
template <int VX>
__device__ __forceinline__ void produce_dy(const bf16* __restrict__ dy, unsigned char* dst, const WGeom& w, int b,
                                           int z, int y0, int x0, int n0, int pt) {
  const Geom& g = w.g;
  constexpr int per = VX / 2;
  const int dv = (g.Cout - n0 < w.N ? g.Cout - n0 : w.N) / per;  // units a voxel
  const int M = g.R * g.XS;
  const int dr = kWgProducer / g.XS, dxm = kWgProducer - dr * g.XS;
  int r = pt / g.XS, xm = pt - r * g.XS;
  const int q0 = (pt & 31) % dv;
  for (int m = pt; m < M; m += kWgProducer) {
    const int yg = y0 + r, xg = x0 + xm;
    const bool valid = yg < g.Y && xg < g.X;
    unsigned char* d = dst + (m >> 3) * 16 * w.N + (m & 7) * 16;
    const bf16* src = valid ? dy + ((((long long)b * g.Z + z) * g.Y + yg) * g.X + xg) * g.Cout + n0 : dy;
    const int sp = valid ? per : 0;
    int q = q0;
    const bf16* sq = src + q * sp;
    for (int k = 0; k < dv; ++k) {
      const int c = q * per;
      copy_unit<VX>(d + (c >> 3) * 128 + (c & 7) * 2, sq, valid);
      sq += sp;
      if (++q == dv) q = 0, sq = src;
    }
    xm += dxm;
    r += dr;
    if (xm >= g.XS) xm -= g.XS, ++r;
  }
}

// Issue the copies of tile t for row block blk and the column slice at n0
// into stage st: the z slices the block reads (z - 1 .. z + 1, or z + blk - 1
// with tap groups), then dy. pt: the thread's index in the producer
// warpgroup.
__device__ __forceinline__ void produce_tile(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                                             unsigned char* st, const WGeom& w, long long t, int blk, int n0,
                                             int pt) {
  const Geom& g = w.g;
  int b, z, y0, x0;
  tile_origin(t, g, b, z, y0, x0);
  const int zf = z - 1 + (w.zs == 1 ? blk : 0);
  switch (g.vecb) {
    case 16:
      produce_x<16>(x, st, g, b, zf, y0, x0, w.zs, pt);
      break;
    case 8:
      produce_x<8>(x, st, g, b, zf, y0, x0, w.zs, pt);
      break;
    case 4:
      produce_x<4>(x, st, g, b, zf, y0, x0, w.zs, pt);
      break;
    default:
      produce_x<2>(x, st, g, b, zf, y0, x0, w.zs, pt);
  }
  unsigned char* dd = st + w.xbytes;
  switch (w.dvecb) {
    case 16:
      produce_dy<16>(dy, dd, w, b, z, y0, x0, n0, pt);
      break;
    case 8:
      produce_dy<8>(dy, dd, w, b, z, y0, x0, n0, pt);
      break;
    case 4:
      produce_dy<4>(dy, dd, w, b, z, y0, x0, n0, pt);
      break;
    default:
      produce_dy<2>(dy, dd, w, b, z, y0, x0, n0, pt);
  }
}

// Item i of the bf16 kernel: its chunk, row block (a tap group's dz, or 0),
// row group and column slice. Consecutive items share a chunk, so the blocks
// that stage the same tiles run together.
__device__ __forceinline__ void wgmma_item(long long i, const WGeom& w, int& chunk, int& blk, int& grp, int& sl) {
  grp = (int)(i % w.rg);
  long long r = i / w.rg;
  const int nblk = 27 / w.taps;
  blk = (int)(r % nblk);
  r /= nblk;
  sl = (int)(r % w.g.slices);
  chunk = (int)(r / w.g.slices);
}

// With tap groups a tile whose z slice for row block blk lies outside the
// volume adds nothing: producer and consumers both skip it.
__device__ __forceinline__ bool tile_skipped(long long t, int blk, const WGeom& w) {
  if (w.zs == 3) return false;
  const int zg = (int)((t / ((long long)w.g.TX * w.g.TY)) % w.g.Z) + blk - 1;
  return zg < 0 || zg >= w.g.Z;
}

// Two x values of one row (element offset o in a cell) at the cells c and
// c + cs, packed as a fragment register; 0 for a padding row.
__device__ __forceinline__ unsigned gather2(const unsigned short* h, int c, int cs, unsigned o) {
  return o == kPad ? 0u : (unsigned)h[c + o] | ((unsigned)h[c + cs + o] << 16);
}

// Warps 0-7 are two consumer warpgroups, warps 8-11 the producer. Warpgroup wg
// holds M tiles mt0 .. mt0 + MT - 1 of the item's row block (an M tile past
// the block multiplies zeros); warp q of it owns rows 16 q .. 16 q + 15 of
// each.
template <int N, int MT, bool PACKED>
__global__ void __launch_bounds__(kWgThreads, 1)
    conv3d_wgrad_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy, float* __restrict__ partial,
                              WGeom w) {
  static_assert(N % 8 == 0 && N >= 8 && N <= 256, "wgmma's N is 8 to 256 in steps of 8");
  const Geom& g = w.g;
  extern __shared__ __align__(128) unsigned char smem[];
  const WgmmaLayout l = wgmma_layout(w);
  const unsigned sbase = smem_addr(smem);
  unsigned* tab = reinterpret_cast<unsigned*>(smem + l.tab);
  const int W2 = g.XS + 2, H2 = g.R + 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;

  // The row table, the same for every row block: tap-wise, chunk c of 8 rows
  // -> the byte offset of its first channel in a stage's x part; packed, row
  // r -> its element offset; kPad past the block's taps.
  if (PACKED) {
    for (int r = threadIdx.x; r < w.rb; r += kWgThreads) {
      unsigned o = kPad;
      if (r < w.taps * g.Cin) {
        const int tl = r / g.Cin, ci = r - tl * g.Cin;
        o = (unsigned)((((tl / 9) * H2 + (tl / 3) % 3) * W2 + tl % 3) * g.CS + ci);
      }
      tab[r] = o;
    }
  } else {
    for (int c = threadIdx.x; c < w.rb / 8; c += kWgThreads) {
      unsigned o = kPad;
      if (8 * c < w.taps * g.CP) {
        const int tl = 8 * c / g.CP, ci = 8 * c - tl * g.CP;
        o = (unsigned)(2 * ((((tl / 9) * H2 + (tl / 3) % 3) * W2 + tl % 3) * g.CS + ci));
      }
      tab[c] = o;
    }
  }
  if (threadIdx.x < 4) reinterpret_cast<unsigned*>(smem + l.zero)[threadIdx.x] = 0u;
  if (threadIdx.x == 0) {
    for (int s = 0; s < w.stages; ++s) {
      mbar_init(sbase + (unsigned)l.full + 8 * s, kWgProducer);        // the producer's threads
      mbar_init(sbase + (unsigned)l.empty + 8 * s, kWgConsumers * 4);  // the consumers' warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the only block barrier: table, zero chunk and barriers are ready

  const unsigned sstride = w.xbytes + w.dbytes;
  const unsigned full = sbase + (unsigned)l.full, empty = sbase + (unsigned)l.empty;
  if (warp >= kWgConsumers * 4) {  // the producer
    int stage = 0;
    unsigned phase = 0;
    for (long long item = blockIdx.x; item < w.items; item += gridDim.x) {
      int chunk, blk, grp, sl;
      wgmma_item(item, w, chunk, blk, grp, sl);
      const long long t0 = (long long)chunk * w.tpc;
      const long long t1 = t0 + w.tpc < g.tiles ? t0 + w.tpc : g.tiles;
      for (long long t = t0; t < t1; ++t) {
        if (tile_skipped(t, blk, w)) continue;
        mbar_wait(empty + 8 * stage, phase ^ 1);  // the consumers are done with the stage's last fill
        produce_tile(x, dy, smem + l.ring + (size_t)stage * sstride, w, t, blk, sl * N,
                     threadIdx.x - kWgConsumers * 128);
        mbar_arrive_copies(full + 8 * stage);
        mbar_arrive(full + 8 * stage);
        if (++stage == w.stages) stage = 0, phase ^= 1;
      }
    }
    mednext::cp_async_wait_all();
    return;
  }

  const int wg = warp / 4, wq = warp & 3;
  const int gq = lane >> 2, tq = lane & 3;
  const int mj = lane >> 3, r8 = lane & 7;
  // ldmatrix.x4.trans of A: lane gives voxel avox of the k-step and rows
  // ahalf .. ahalf + 7 of the warp's 16 (matrix mj: rows 8 (mj % 2), voxels 8 (mj / 2))
  const int avox = r8 + 8 * (mj >> 1), ahalf = 8 * (mj & 1);
  const unsigned zsa = sbase + (unsigned)l.zero;
  const int steps = g.R * g.XS / 16;
  const int cstep = PACKED ? g.CS : 2 * g.CS;  // a cell: elements (packed gather) or bytes (ldmatrix)
  int stage = 0;
  unsigned phase = 0;
  for (long long item = blockIdx.x; item < w.items; item += gridDim.x) {
    int chunk, blk, grp, sl;
    wgmma_item(item, w, chunk, blk, grp, sl);
    const long long t0 = (long long)chunk * w.tpc;
    const long long t1 = t0 + w.tpc < g.tiles ? t0 + w.tpc : g.tiles;
    const int mt0 = (grp * kWgConsumers + wg) * MT;
    // per M tile: tap-wise, this lane's A offset (its chunk and its voxel's
    // cell), kPad for a chunk past the taps or an M tile past the block;
    // packed, the element offsets of rows gq and gq + 8
    unsigned ao[MT], bo[MT];
#pragma unroll
    for (int f = 0; f < MT; ++f) {
      const int row = (mt0 + f) * 64 + 16 * wq;
      if constexpr (PACKED) {
        ao[f] = row < w.rb ? tab[row + gq] : kPad;
        bo[f] = row < w.rb ? tab[row + gq + 8] : kPad;
      } else {
        const unsigned o = row < w.rb ? tab[(row + ahalf) / 8] : kPad;
        ao[f] = o == kPad ? kPad : o + avox * cstep;
        bo[f] = 0;
      }
    }
    float acc[MT][N / 2];
#pragma unroll
    for (int f = 0; f < MT; ++f)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[f][i] = 0.f;
    for (long long t = t0; t < t1; ++t) {
      if (tile_skipped(t, blk, w)) continue;
      mbar_wait(full + 8 * stage, phase);
      __syncwarp();
      fence_proxy_async();  // the copies landed through the generic proxy; wgmma reads B through the async one
      const unsigned xsa = sbase + (unsigned)l.ring + stage * sstride;
      const unsigned long long desc = smem_desc(xsa + w.xbytes, 16 * N, 128);
      const unsigned short* xh = reinterpret_cast<const unsigned short*>(smem + l.ring + (size_t)stage * sstride);
      unsigned a0[MT][4], a1[MT][4];
      int cb = 0, xm0 = 0;  // the k-step's first voxel: its cell (in cstep units x cstep) and x
      auto load = [&](unsigned (&a)[MT][4]) {
#pragma unroll
        for (int f = 0; f < MT; ++f) {
          if constexpr (PACKED) {
            const int c0 = cb + 2 * tq * g.CS, c8 = c0 + 8 * g.CS;
            a[f][0] = gather2(xh, c0, g.CS, ao[f]);
            a[f][1] = gather2(xh, c0, g.CS, bo[f]);
            a[f][2] = gather2(xh, c8, g.CS, ao[f]);
            a[f][3] = gather2(xh, c8, g.CS, bo[f]);
          } else {
            ldsm_x4_trans_at(a[f], ao[f] != kPad ? xsa + cb + ao[f] : zsa);
          }
        }
      };
      auto issue = [&](int s, const unsigned (&a)[MT][4]) {
        wgmma_fence();  // A's registers were just written
#pragma unroll
        for (int f = 0; f < MT; ++f) wgmma_bf16<N>(acc[f], a[f], desc + (unsigned long long)(2 * N * s));
        wgmma_commit();
      };
      auto next = [&]() {  // 16 voxels on; XS is a multiple of 16, so a k-step stays in one row
        xm0 += 16;
        cb += 16 * cstep;
        if (xm0 == g.XS) xm0 = 0, cb += 2 * cstep;
      };
      load(a0);
      for (int s = 0; s < steps; s += 2) {  // two register sets: the next k-step loads under this one's products
        issue(s, a0);
        if (s + 1 < steps) {
          next();
          wgmma_wait<1>();  // step s - 1 is done with a1
          load(a1);
          issue(s + 1, a1);
        }
        if (s + 2 < steps) {
          next();
          wgmma_wait<1>();  // step s is done with a0
          load(a0);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int f = 0; f < MT; ++f) fence_regs(acc[f]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * stage);  // this warp is done with the stage
      if (++stage == w.stages) stage = 0, phase ^= 1;
    }
    // the item's partial, from registers: the rows of its M tiles inside the block
    float* dst = partial + ((long long)chunk * w.rows_p + (long long)blk * w.rb) * w.cols + sl * N + 2 * tq;
#pragma unroll
    for (int f = 0; f < MT; ++f) {
      const int row = (mt0 + f) * 64 + 16 * wq + gq;
      if (row >= w.rb) continue;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        mednext::store2(dst + (long long)row * w.cols + 8 * j, acc[f][4 * j], acc[f][4 * j + 1]);
        mednext::store2(dst + (long long)(row + 8) * w.cols + 8 * j, acc[f][4 * j + 2], acc[f][4 * j + 3]);
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
  const WgLayout l = wgrad_f32_layout(w);
  float* xh = reinterpret_cast<float*>(smem + l.buf);
  float* dt = reinterpret_cast<float*>(smem + l.buf + l.hbytes);
  const int W2 = g.XS + 2, H2 = g.R + 2;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;

  for (long long item = blockIdx.x; item < w.items; item += gridDim.x) {
    int chunk, rt, sl;
    wgrad_f32_item(item, w, chunk, rt, sl);
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
      stage_wgrad_f32_tile(x, dy, xh, dt, w, t, n0);
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
    float* dst = partial + (long long)chunk * w.rows_p * w.cols + n0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rt * w.BM + tr + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tc + 16 * j;
        if (c < g.NB && n0 + c < g.Np) dst[(long long)row * w.cols + c] = acc[i][j];
      }
    }
  }
}

// The sum of the chunks' partials of each matrix element (row r of rows_p,
// column c of cols), written to dW (Cout, Cin, 27): a block of kSumRows x 32
// threads takes 32 elements; thread row q sums chunks q, q + kSumRows, ...,
// then row 0 adds the kSumRows sums in order. Row r is channel ci of tap tl
// of row block r / rb (taps of a block: 27, or 9 a dz); rows of padding
// channels and taps and columns past Cout are dropped.
constexpr int kSumRows = 32;

__global__ void __launch_bounds__(kSumRows * 32)
    conv3d_wgrad_sum_kernel(const float* __restrict__ partial, float* __restrict__ out, WGeom w) {
  const Geom& g = w.g;
  const long long n = (long long)w.rows_p * w.cols;
  __shared__ float s[kSumRows][33];
  const int col = threadIdx.x & 31, row = threadIdx.x >> 5;
  const long long i = (long long)blockIdx.x * 32 + col;
  float acc = 0.f;
  if (i < n) {
    int it = row;
    for (; it + 3 * kSumRows < w.chunks; it += 4 * kSumRows) {
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = partial[(it + k * kSumRows) * n + i];
#pragma unroll
      for (int k = 0; k < 4; ++k) acc += v[k];
    }
    for (; it < w.chunks; it += kSumRows) acc += partial[it * n + i];
  }
  s[row][col] = acc;
  __syncthreads();
  if (row == 0 && i < n) {
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < kSumRows; ++r) t += s[r][col];
    const int mrow = (int)(i / w.cols), co = (int)(i - (long long)mrow * w.cols);
    const int blk = mrow / w.rb, rr = mrow - blk * w.rb;
    const int tl = rr / w.tap_rows, ci = rr - tl * w.tap_rows;
    if (tl < w.taps && ci < g.Cin && co < g.Cout) out[((long long)co * g.Cin + ci) * 27 + blk * w.taps + tl] = t;
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
  const int row = g.Cin * 4;
  g.vecb = row % 16 == 0 ? 16 : row % 8 == 0 ? 8 : 4;
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

inline bool plan_one(Geom& g, int es, int sms) {
  g.K = weight_rows(g.Cin, es, &g.CP, &g.packed);
  g.Np = round_up(g.Cout, 16);
  return es == 2 ? plan_taps(g, sms) : plan_f32(g);
}

inline int gcd(int a, int b) { return b ? gcd(b, a % b) : a; }

// The plan of a launch over all of Cin where one fits (chunks 1, today's
// plans), else of the fewest Cin chunks whose launch plans: chunks of Cc =
// ceil(Cin / n) channels rounded up to 8 (bf16: whole 8-channel groups of
// the tap-wise table) or 4 (f32: 16-byte chunk offsets), the last holding
// the rest. The copy width divides every chunk's first channel, its
// channels and the voxel stride. g.Cin is then Cc; the launches set each
// chunk's channels, first channel and mode.
inline bool plan(Geom& g, int es, int sms) {
  const int cin = g.Cin;
  g.XC = cin, g.chunks = 1, g.c0 = 0, g.mode = 0, g.part = nullptr;
  int cp = 0, packed = 0;
  weight_rows(cin, es, &cp, &packed);
  g.wtap = cp;
  if (plan_one(g, es, sms)) return true;
  if (packed) return false;
  const int align = es == 2 ? 8 : 4;
  for (int n = 2; n <= cin; ++n) {
    const int cc = round_up((cin + n - 1) / n, align);
    const int chunks = (cin + cc - 1) / cc;
    if (chunks != n) continue;  // a rounded chunk width that another n already tried
    Geom c = g;
    c.Cin = cc;
    if (!plan_one(c, es, sms)) continue;
    const int unit = gcd(gcd(cin, cc), cin - (chunks - 1) * cc) * es;
    c.vecb = unit % 16 == 0 ? 16 : unit % 8 == 0 ? 8 : unit % 4 == 0 ? 4 : 2;
    c.chunks = chunks;
    g = c;
    return true;
  }
  return false;
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
constexpr int kKey = 13;  // device, shape (7), a plan forced by the caller (5)

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
  const long long key[kKey] = {dev, B, Z, Y, X, Cin, Cout, (long long)sizeof(T), 0, 0, 0, 0, 0};
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
    FwdKernelF32 k = g.vecb == 16 ? conv3d_f32_kernel<16> : g.vecb == 8 ? conv3d_f32_kernel<8> : conv3d_f32_kernel<4>;
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

// One launch, or one a Cin chunk in order (first, middle, last); part: the
// bf16 chunks' f32 scratch of (voxels, Cout).
template <typename T>
int run(const void* x, const void* w, const void* bias, void* out, void* part, int B, int Z, int Y, int X, int Cin,
        int Cout, int w_rows, int w_cols, cudaStream_t stream) {
  Geom g;
  const void* fn = nullptr;
  unsigned blocks = 0;
  const int rc = fwd_plan<T>(B, Z, Y, X, Cin, Cout, g, fn, blocks);
  if (rc) return rc;
  int cp = 0, packed = 0;
  if (w_rows != weight_rows(Cin, (int)sizeof(T), &cp, &packed) || w_cols != g.Np) return kErrShape;
  if (g.chunks > 1 && sizeof(T) == 2 && !part) return kErrShape;
  const int cc = g.Cin;
  const T* wp = static_cast<const T*>(w);
  const float* bp = static_cast<const float*>(bias);
  T* op = static_cast<T*>(out);
  for (int c = 0; c < g.chunks; ++c) {
    Geom gc = g;
    gc.c0 = c * cc;
    gc.Cin = Cin - gc.c0 < cc ? Cin - gc.c0 : cc;
    gc.mode = g.chunks == 1 ? 0 : c == 0 ? 1 : c + 1 < g.chunks ? 2 : 3;
    gc.part = static_cast<float*>(part);
    const T* xp = static_cast<const T*>(x) + gc.c0;
    void* args[] = {&xp, &wp, &bp, &op, &gc};
    cudaError_t e =
        cudaLaunchKernel(fn, dim3(blocks, g.slices), dim3(kThreads), args, smem_bytes(g, (int)sizeof(T)), stream);
    if (e == cudaSuccess) e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// The weight gradient's plans, from the shape alone (the chunks too, so that
// the sums are the same bits on any grid), then chunks of consecutive tiles
// for about two items per SM of an H100 (132), their partials at most
// kPartialBytes.
//
// bf16 (plan_wgrad_wgmma): among tap groups (3, one dz a row block, or 1),
// M tiles a warpgroup (those built for N), tiles (XS a multiple of 16 up to
// 128, R rows, at most kWgMaxM voxels) and ring stages (2 to kWgMaxStages)
// whose shared memory fits a block, the least estimated time (wgmma_cost),
// a model fitted (tools/conv3d_wgrad_plans.py --fit; PERF.md) to that tool's
// sweep of every RSUNet training shape on an H100: a stage's visit costs the
// longer of the consumers' k-steps (kWgStepClk a column of wgmma's width, or
// of its shared-memory reads where those are more, for each M tile, plus
// kWgStepLat) and the producer's staging (kWgBytesClk bytes a clock); with
// two stages a share kWgTwoStages of the shorter adds to it; every visit
// adds kWgVisitClk. Visits: tiles x tap groups (less the skipped z edges) x
// row groups x column slices, out in waves of items over the SMs.
// f32 (plan_wgrad_f32, the check path): slices of at most 64 columns, the
// tile of least estimated time: kTileClk a tile, a voxel about 24 thread
// instructions a thread, staging a clock per 32 bytes.
constexpr int kNominalSms = 132;
constexpr long long kPartialBytes = 64LL << 20;
constexpr double kTileClk = 6000.0;
constexpr double kWgStepClk = 0.417;
constexpr double kWgStepLat = 97.6;
constexpr double kWgBytesClk = 13.1;
constexpr double kWgTwoStages = 0.036;
constexpr double kWgVisitClk = 4989.0;

// wgmma's widths instantiated (wgmma_kernel), and the M tiles a warpgroup
// may hold at each: what fits 168 registers a thread (65,536 over 384
// threads) without spilling (ptxas on the H100's build: 168 with spills at
// MT x N of 4 x 64, 3 x 80 and 2 x 128).
constexpr int kWgN[] = {8, 16, 24, 32, 40, 48, 64, 80, 104, 128};
constexpr int wg_max_mt(int n) { return n >= 32 && n <= 48 ? 4 : n == 64 ? 3 : n == 128 ? 1 : 2; }

// The widest copy (16, 8, 4 or 2 bytes) that divides a row of `bytes`.
inline int copy_bytes(int bytes) { return bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8 : bytes % 4 == 0 ? 4 : 2; }

// Chunks of the plan's tiles for about two items per SM, `per` items a chunk.
inline bool wgrad_chunks(WGeom& w, long long per) {
  const Geom& g = w.g;
  long long chunks = (2LL * kNominalSms + per - 1) / per;
  const long long cap = kPartialBytes / ((long long)w.rows_p * w.cols * 4);
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

inline double wgmma_cost(const WGeom& c) {
  const Geom& g = c.g;
  const double width = c.N > 32 + c.N / 2.0 ? c.N : 32 + c.N / 2.0;
  const double cons = g.R * g.XS / 16.0 * (kWgStepClk * c.mt * width + kWgStepLat);
  const int dcols = g.Cout < c.N ? g.Cout : c.N;
  const double prod = (2.0 * c.zs * (g.R + 2) * (g.XS + 2) * g.Cin + 2.0 * g.R * g.XS * dcols) / kWgBytesClk;
  const double visit = (cons > prod ? cons : prod) + (c.stages < 3 ? kWgTwoStages * (cons < prod ? cons : prod) : 0.0) +
                       kWgVisitClk;
  const double groups = c.zs == 1 ? 3.0 - 2.0 / g.Z : 1.0;
  const double waves = ceil((double)c.items / kNominalSms) / ((double)c.items / kNominalSms);
  return (double)g.tiles * groups * c.rg * g.slices * visit * waves;
}

// force: XS, R, stages, M tiles a warpgroup and tap groups (1 or 3) in the
// place of the planner's, each 0 for its own.
inline bool plan_wgrad_wgmma(WGeom& w, const int* force) {
  Geom& g = w.g;
  g.packed = g.Cin < 8;
  g.XC = g.Cin;
  g.CP = g.packed ? g.Cin : round_up(g.Cin, 8);
  g.CS = g.packed ? g.CP : odd_stride(g.CP);
  g.vecb = copy_bytes(g.Cin * 2);
  w.dvecb = copy_bytes(g.Cout * 2);
  g.slices = (g.Cout + kWgMaxN - 1) / kWgMaxN;
  const int need = round_up((g.Cout + g.slices - 1) / g.slices, 8);
  w.N = 0;
  for (int n : kWgN)
    if (!w.N && n >= need) w.N = n;
  g.NB = w.N;
  g.Np = w.cols = g.slices * w.N;
  w.tap_rows = g.CP;
  double best = -1;
  WGeom pick = w;
  for (int tg = 3; tg >= 1; tg -= 2) {
    if (force[4] && force[4] != tg) continue;
    for (int mt = 1; mt <= (g.packed ? 1 : wg_max_mt(w.N)); ++mt) {
      if (force[3] && force[3] != mt) continue;
      for (int xs = 16; xs <= 128 && xs <= round_up(g.X, 16); xs += 16) {
        if (force[0] && force[0] != xs) continue;
        for (int r = 1; r <= g.Y && r * xs <= kWgMaxM; ++r) {
          if (force[1] && force[1] != r) continue;
          for (int stages = 2; stages <= kWgMaxStages; ++stages) {
            if (force[2] && force[2] != stages) continue;
            WGeom c = w;
            c.taps = 27 / tg;
            c.zs = tg == 3 ? 1 : 3;
            c.rb = round_up(c.taps * c.tap_rows, 64);
            c.rows_p = tg * c.rb;
            c.mt = mt;
            c.rg = (c.rb / 64 + kWgConsumers * mt - 1) / (kWgConsumers * mt);
            c.stages = stages;
            c.g.XS = xs, c.g.R = r;
            c.xbytes = (unsigned)align128((size_t)c.zs * (r + 2) * (xs + 2) * g.CS * 2);
            c.dbytes = (unsigned)align128((size_t)r * xs * w.N * 2);
            if (wgmma_layout(c).total > kMaxSmem) break;  // more stages take more
            finish(c.g);
            if (!wgrad_chunks(c, (long long)tg * c.rg * g.slices)) continue;
            const double cost = wgmma_cost(c);
            if (best < 0 || cost < best) best = cost, pick = c;
          }
        }
      }
    }
  }
  if (best < 0) return false;
  w = pick;
  return true;
}

// force: XS, R and one buffer (stages 1) in the place of the planner's.
inline bool plan_wgrad_f32(WGeom& w, const int* force) {
  Geom& g = w.g;
  if (force[2] > 1 || force[3] || force[4] > 1) return false;  // one buffer, no M tiles or tap groups
  g.K = weight_rows(g.Cin, 4, &g.CP, &g.packed);
  g.Np = round_up(g.Cout, 16);
  g.CS = g.CP;
  g.KS = g.K;
  const int row = g.Cin * 4;
  g.vecb = row % 16 == 0 ? 16 : row % 8 == 0 ? 8 : 4;
  g.NB = g.Np < kWgradF32Cols ? g.Np : kWgradF32Cols;
  g.nbuf = 1;
  g.XC = g.Cin;
  g.slices = (g.Np + g.NB - 1) / g.NB;
  w.DS = g.NB;
  w.BM = kWgradF32Rows;
  w.dvecb = copy_bytes(g.Cout * 4);
  w.tap_rows = g.Cin;
  w.taps = 27;
  w.row_tiles = (g.K + w.BM - 1) / w.BM;
  w.rows_p = w.rb = w.row_tiles * w.BM;
  w.cols = g.Np;
  double best = -1;
  WGeom pick = w;
  for (int xs = 16; xs <= 64 && xs <= round_up(g.X, 16); xs += 16) {
    for (int r = 1; r <= g.Y && r * xs <= 64; ++r) {
      if (force[0] && (xs != force[0] || r != force[1])) continue;
      WGeom c = w;
      c.g.XS = xs, c.g.R = r;
      const int last = ((2 * (r + 2) + 2) * (xs + 2) + 2) * g.CS + g.CP;
      const WgLayout l = wgrad_f32_layout(c);
      if (l.total > kMaxSmem || last >= 0xFFFF) continue;
      finish(c.g);
      const double cost = (double)c.g.tiles * (kTileClk + r * xs * 24.0 * 16.0 + (double)(l.hbytes + l.dbytes) / 32.0);
      if (best < 0 || cost < best) best = cost, pick = c;
    }
  }
  if (best < 0) return false;
  w = pick;
  return wgrad_chunks(w, (long long)w.row_tiles * g.slices);
}

using WgradKernel = void (*)(const bf16*, const bf16*, float*, WGeom);

template <int N, int MT>
WgradKernel wgmma_kernel_upto(int mt) {
  if constexpr (MT == 0) {
    return nullptr;
  } else {
    return mt == MT ? conv3d_wgrad_wgmma_kernel<N, MT, false> : wgmma_kernel_upto<N, MT - 1>(mt);
  }
}

// The bf16 kernel of a plan: tap-wise for each width and mt <= wg_max_mt,
// packed (the stem) with mt 1.
template <int I = 0>
WgradKernel wgmma_kernel(int n, int mt, bool packed) {
  if constexpr (I == sizeof(kWgN) / sizeof(kWgN[0])) {
    return nullptr;
  } else {
    constexpr int NN = kWgN[I];
    if (n != NN) return wgmma_kernel<I + 1>(n, mt, packed);
    if (packed) return mt == 1 ? conv3d_wgrad_wgmma_kernel<NN, 1, true> : nullptr;
    return wgmma_kernel_upto<NN, wg_max_mt(NN)>(mt);
  }
}

inline size_t wgrad_smem(const WGeom& w, int es) { return es == 2 ? wgmma_layout(w).total : wgrad_f32_layout(w).total; }

// The weight gradient's plan, kernel and default grid on the current
// device, cached by shape and forced fields (a forced plan that does not
// fit, or names no instantiated kernel, is refused).
inline int wgrad_plan(int es, int B, int Z, int Y, int X, int Cin, int Cout, const int* force, WGeom& w,
                      const void*& fn, unsigned& blocks) {
  static PlanCache<WGeom> cache;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const long long key[kKey] = {dev, B, Z, Y, X, Cin, Cout, es, force[0], force[1], force[2], force[3], force[4]};
  if (cache.get(key, w, fn, blocks)) return 0;
  if (B < 1 || Z < 1 || Y < 1 || X < 1 || Cin < 1 || Cout < 1) return kErrShape;
  if ((long long)B * Z * Y * X * (Cin > Cout ? Cin : Cout) >= (1LL << 62)) return kErrShape;
  w = WGeom{};
  w.g.B = B, w.g.Z = Z, w.g.Y = Y, w.g.X = X, w.g.Cin = Cin, w.g.Cout = Cout;
  if (!(es == 2 ? plan_wgrad_wgmma(w, force) : plan_wgrad_f32(w, force))) return kErrShape;
  fn = es == 2 ? reinterpret_cast<const void*>(wgmma_kernel(w.N, w.mt, w.g.packed))
               : reinterpret_cast<const void*>(conv3d_wgrad_f32_kernel);
  if (!fn) return kErrShape;
  int occ = 0;
  const int rc = mednext::occupancy(fn, es == 2 ? kWgThreads : kThreads, wgrad_smem(w, es), &occ);
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
  const int rc = wgrad_plan(es, B, Z, Y, X, Cin, Cout, force, w, fn, blocks);
  if (rc) return rc;
  if (partial_floats < (long long)w.chunks * w.rows_p * w.cols) return kErrShape;
  if (grid > 0) blocks = (unsigned)(grid < w.items ? grid : w.items);
  const T* xp = static_cast<const T*>(x);
  const T* dp = static_cast<const T*>(dy);
  float* pp = static_cast<float*>(partial);
  void* args[] = {&xp, &dp, &pp, &w};
  cudaError_t e = cudaLaunchKernel(fn, dim3(blocks), dim3(es == 2 ? kWgThreads : kThreads), args, wgrad_smem(w, es),
                                   stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n = (long long)w.rows_p * w.cols;
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

// The plan a launch of this shape takes, for reports: plan[0..13] = XS, R,
// NB, slices, MFW, NFW, WMW, WNW, nbuf, shared-memory bytes, kernel (0
// tap-wise, 1 packed stem, 2 f32), Cin chunks (launches), channels a chunk
// (Cc; Cin for one launch), copy bytes. The f32 kernel leaves MFW..nbuf 0.
int conv3d_3x3_plan(int dtype, int B, int Z, int Y, int X, int Cin, int Cout, int* plan) {
  conv3d::Geom g{};
  g.B = B, g.Z = Z, g.Y = Y, g.X = X, g.Cin = Cin, g.Cout = Cout;
  const int es = dtype ? 2 : 4;
  if (!conv3d::plan(g, es, conv3d::sm_count())) return conv3d::kErrShape;
  const int v[14] = {g.XS,  g.R,    g.NB,   g.slices, g.MFW,     g.NFW,    g.WMW,
                     g.WNW, g.nbuf, (int)conv3d::smem_bytes(g, es), es == 4 ? 2 : g.packed ? 1 : 0,
                     g.chunks, g.Cin, g.vecb};
  for (int i = 0; i < 14; ++i) plan[i] = v[i];
  return 0;
}

// part: bf16 with Cin chunks (conv3d_3x3_plan), an f32 scratch of B*Z*Y*X*Cout
// values; else unused (may be null).
int conv3d_3x3_fwd(const void* x, const void* w, const void* bias, void* out, void* part, int dtype, int B, int Z,
                   int Y, int X, int Cin, int Cout, int w_rows, int w_cols, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype) return conv3d::run<conv3d::bf16>(x, w, bias, out, part, B, Z, Y, X, Cin, Cout, w_rows, w_cols, s);
  return conv3d::run<float>(x, w, bias, out, part, B, Z, Y, X, Cin, Cout, w_rows, w_cols, s);
}

// The weight gradient's plan for reports and for the wrapper's scratch:
// plan[0..16] = XS, R, N (bf16: wgmma's width; f32: the slice's columns),
// column slices, ring stages (f32: 1), M tiles a warpgroup (f32: 0), tap
// groups, rows a row block, row groups (f32: row tiles), rows a chunk
// (rows_p), chunks, tiles a chunk, items, shared-memory bytes, default grid,
// floats of the partials (chunks x rows_p x columns), kernel (0 wgmma, 1
// wgmma packed stem, 2 f32). Items and chunks do not depend on the grid.
// force[0..4]: XS, R, stages, M tiles a warpgroup, tap groups (1 or 3) in
// the place of the planner's, each 0 for its own.
int conv3d_3x3_wgrad_plan(int dtype, int B, int Z, int Y, int X, int Cin, int Cout, const int* force,
                          long long* plan) {
  conv3d::WGeom w;
  const void* fn = nullptr;
  unsigned blocks = 0;
  const int es = dtype ? 2 : 4;
  const int rc = conv3d::wgrad_plan(es, B, Z, Y, X, Cin, Cout, force, w, fn, blocks);
  if (rc) return rc;
  const bool f32 = es == 4;
  const long long v[17] = {w.g.XS,  w.g.R,         f32 ? w.g.NB : w.N, w.g.slices, f32 ? 1 : w.stages,
                           w.mt,    27 / w.taps,   w.rb,               f32 ? w.row_tiles : w.rg,
                           w.rows_p, w.chunks,     w.tpc,              w.items,
                           (long long)conv3d::wgrad_smem(w, es),       blocks,
                           (long long)w.chunks * w.rows_p * w.cols,    f32 ? 2 : w.g.packed ? 1 : 0};
  for (int i = 0; i < 17; ++i) plan[i] = v[i];
  return 0;
}

// dW (Cout, Cin, 3, 3, 3) float32 of the conv of x (B, Z, Y, X, Cin) whose
// output gradient is dy (B, Z, Y, X, Cout), both contiguous, 16-byte aligned
// and of one dtype; partial: float32 scratch of at least partial_floats
// (conv3d_3x3_wgrad_plan); grid: persistent blocks, 0 for the default (the
// result does not depend on it); force: as for conv3d_3x3_wgrad_plan (the
// partials follow the plan, so a forced plan sums in another order). Two
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
