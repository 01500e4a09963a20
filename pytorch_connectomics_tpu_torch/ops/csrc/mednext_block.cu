// MedNeXt block kernels for Hopper (sm_90a): the fused stride-1 block
//     out = x + W2 . gelu_tanh(W1 . GN(dw(x) + b_dw) + b1) + b2
// over channels-last activations x[b][z][y][x][c], as two passes.
//
// Replaces the TPU kernels of pytorch_connectomics_tpu/ops/fused_block_pallas.py:
//   dw_stats               (:148, body _stats_kernel :126)
//   fused_block_apply_cf   (:238, body _apply_kernel :198; with fold_block_weights :294)
// It ports what they compute, not their lane-padded "CF" layout, and not the
// folding of the depthwise taps into W1 (k^2 tap matmuls on the MXU): on
// Hopper that would cost 27 * 2 * C * R tensor FLOP a voxel, more at C 32
// than the whole byte bound, so the stencil stays on the CUDA cores.
//
// Both passes walk the volume the same way (the slab ring of ring.cuh,
// which depthwise3x3.cu shares), with the numbers that
// ops/fused_block.py::kernel_plan picks per shape:
// - A work item is (b, a segment of Sz slabs of z, a band of Ty rows of y,
//   a band of Tx columns of x: the whole row wherever it leaves room for two
//   blocks on an SM). Persistent
//   blocks (SMs x resident blocks) take the items in turn and march each
//   along z.
// - A ring of slabs in shared memory holds the band with its y and x halo,
//   (Ty + 2) x (Tx + 2) voxels of C values. The
//   next slab arrives by cp.async while the current one is computed. Rows,
//   columns and slabs outside the volume are zero-filled when staged, which
//   is SAME zero padding: the stencil has no mask. An input voxel is staged
//   (Ty + 2) / Ty * (Sz + 2) / Sz times, mostly from L2.
// - A thread owns a channel pair and runs of three consecutive x outputs
//   of one band row, two runs at a time; each (dz, dy) row of five voxels
//   it loads feeds all three outputs of a run (15 shared loads per three
//   outputs, not 27 per output). The run
//   length is odd, so the two half-warps of a 32-channel bf16 row fall on
//   different banks. The channel count is a template argument for the
//   widths MedNeXt uses, so every stencil load has a compile-time offset.
//
// 1. mednext_dw_stats: per-(b, c) [sum dw(x), sum dw(x)^2] over real voxels
//    (dw without bias): the GroupNorm statistics of the block. Bound on an
//    H100: 27 FMAs a value, f32 CUDA-core operations at C = 32 in bf16 (8.2
//    GFLOP against 0.30 GB at batch 16). A ring of four slabs (slab z + 2
//    staged under the stencil of z), or three where four do not fit (slab
//    z + 2 staged after it); the 54 taps and the sums stay in registers; each
//    item writes one partial and a second kernel sums an element's partials
//    in a fixed order. No atomics: the result is the same on every launch.
//
// 2. mednext_apply_bf16: the whole block, bf16. A ring of three slabs (the
//    next slab's copies run under this step's matmuls; a fourth slot
//    measured no faster). Per z step:
//    - the stencil, normalised with the per-(b, c) scale/shift folded from
//      the statistics (eps, variance E[t^2] - E[t]^2 clipped at 0; b_dw
//      cancels against the mean), rounded to bf16 into the u tile
//      [Ty * TW rows][C] in shared memory (TW = min(Tx, X); rows padded to
//      16);
//    - a warp takes a unit (16 rows, CS output channels): for each 16 hidden
//      units, h = u . W1^T on mma.sync m16n8k16 (A by ldmatrix, cached in
//      registers for C <= 128), bias and tanh-GELU on the accumulators,
//      which are repacked as the bf16 A fragment of out += h . W2^T: the
//      hidden activation never leaves registers. W1 and W2 are staged in
//      shared memory once per block where they fit; otherwise every block
//      streams them in chunks of RC hidden units through one cp.async
//      buffer that all its warps share (a chunk's barriers and wait cost
//      more than its copies: two buffers of half the chunk were slower at
//      every stage on the H100).
//    - the epilogue adds b2 and the residual (read from the ring's centre
//      slab), rounds to bf16, goes through a warp tile by stmatrix and out
//      with 16-byte coalesced stores; with whole rows the band's rows of one
//      slab are one contiguous run of the output.
//    Bound on an H100: at stage 0 (C 32, R 64) 2 bytes in and 2 out per
//    value against 4 C R tensor FLOP a voxel: bytes, though the stencil's
//    and GELU's CUDA-core work come close; from C 128 up the matmuls grow.
//
// 3. mednext_block_apply: the float32 check path, the first design (one
//    8-128-voxel tile a block, masked stencil, scalar FMAs for both
//    products); its halo is three flat runs, or nine runs of one row each
//    where those are smaller (wide rows), so shared memory bounds no X.
//
// Both take f32 or bf16 inputs and accumulate in f32. Weights: w_dw (C, K^3)
// f32 (torch's (C, 1, K, K, K)); W1 (R, C) and W2 (Cout, R) in the input
// type (torch Linear layout); gamma, beta, b1, b2 f32.
//
// The stencil edge K (3 or 5) is a template parameter of the three kernels.
// K 3 is the design above, its plans and bits unchanged. K 5 is the same
// walk with a halo of two: rings of K + 1 or K slabs of (Ty + 4) x (Tx + 4)
// voxels, runs of three outputs reading K + 2 voxels a (dz, dy) row, and
// 125 tap pairs, more than a thread's registers hold, so each row's five
// pairs are loaded from L1 where they are used (stencil_band_k of ring.cuh);
// the apply reads W2's mma fragments from global memory, which leaves a ring
// of five slabs room at C 512; the f32 check path stages its halo (K flat
// runs or K^2 row runs) in channel groups where all of C does not fit. K 5
// is built for the runtime C only (one instance per kernel and unit width),
// which keeps the build short. MedNeXt's 2-D mode embeds its (1, k, k) taps
// in k^3 (ops/fused_block.py::taps3d) and runs these kernels as they are.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see ops/build.py). Plain C interface for ctypes.

#include "ring.cuh"

namespace mednext {

using bf16 = __nv_bfloat16;

constexpr int kErrShape = 10001;  // a shape or plan the kernels do not take
constexpr size_t kMaxSmem = 232448;
constexpr int kWarps = kThreads / 32;
constexpr int kApplyRing = 3;  // slabs in the apply pass's ring at K 3: K of a K^3 stencil

__host__ __device__ __forceinline__ int apply_slots(const Ring& g) { return 2 * g.hl + 1; }

// ---------------------------------------------------------------------------
// statistics pass
// ---------------------------------------------------------------------------

// K: the stencil's edge. K 3 holds its 54 taps in registers; K 5 loads
// each (dz, dy) row's taps where it uses them (stencil_band_k). blockIdx.y
// is a group of g.C of x's g.cx channels (float32 at K 5 from C 512, whose
// slabs of all C outgrow shared memory); partial rows hold all g.cx
// channels.
template <typename T, int CT, int K>
__global__ void __launch_bounds__(kThreads, 2)
    ring_stats_kernel(const T* __restrict__ x, const float* __restrict__ w, float* __restrict__ partial, Ring g) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int KPM = CT ? (CT / 2 + kThreads - 1) / kThreads : 2;  // channel pairs a thread
  constexpr int H = K / 2;
  const int C = CT ? CT : g.C;
  const int CX = g.cx;
  const int c0 = blockIdx.y * C;
  x += c0;
  w += (size_t)c0 * K * K * K;
  const size_t slab = slab_elems(g);
  T* ring = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem + align128(g.nr * slab * sizeof(T)));
  const Lanes ln = lanes_of(C);
  const int P = C / 2;
  float2 kw[K == 3 ? 27 : 1];
  if constexpr (K == 3) {
    if (KPM == 1) load_taps(kw, w, ln.p0);
  }

  for (int item = blockIdx.x; item < g.items; item += gridDim.x) {
    int b, y0, x0, z0, z1;
    item_origin(g, item, b, y0, x0, z0, z1);
    const T* xb = x + (long long)b * g.Z * g.Y * g.X * CX;
    const int yv = min(g.ty, g.Y - y0);  // rows of the band inside the volume
    const int xv = min(g.tw, g.X - x0);  // its columns inside the volume
    float2 s[KPM], s2[KPM];
#pragma unroll
    for (int j = 0; j < KPM; ++j) s[j] = s2[j] = make_float2(0.f, 0.f);
    // slab z lives in slot (z - z0 + H) % nr
    for (int d = 0; d < K; ++d) stage_slab<T, CT, K>(xb, ring + d * slab, z0 - H + d, y0, x0, g, CX);
    cp_async_commit();
    for (int z = z0; z < z1; ++z) {
      cp_async_wait<0>();
      __syncthreads();  // slab z + H has landed; with K + 1 slots, slab z - H - 1's slot is free
      if (g.nr == K + 1 && z + 2 <= z1)
        stage_slab<T, CT, K>(xb, ring + ((z + K - z0) % (K + 1)) * slab, z + H + 1, y0, x0, g, CX);
      cp_async_commit();
      if (ln.active) {
#pragma unroll
        for (int j = 0; j < KPM; ++j) {
          const int p = ln.p0 + j * ln.pt;
          if (p >= P) break;
          float2 sj = s[j], s2j = s2[j];
          auto emit = [&](int ry, int rx, const float2(&a)[kRun]) {
            if (ry < yv) {
#pragma unroll
              for (int q = 0; q < kRun; ++q) {
                if (kRun * rx + q < xv) {
                  sj.x += a[q].x;
                  sj.y += a[q].y;
                  s2j.x = fmaf(a[q].x, a[q].x, s2j.x);
                  s2j.y = fmaf(a[q].y, a[q].y, s2j.y);
                }
              }
            }
          };
          if constexpr (K == 3) {
            const T* s0 = ring + ((z - z0) % g.nr) * slab;
            const T* s1 = ring + ((z - z0 + 1) % g.nr) * slab;
            const T* sl2 = ring + ((z - z0 + 2) % g.nr) * slab;
            if (KPM > 1) load_taps(kw, w, p);
            stencil_band<T, CT>(s0, s1, sl2, p, ln, g, C, kw, emit);
          } else {
            stencil_band_k<T, CT, K>(ring, z - z0, g.nr, slab, w, p, ln, g, C, emit);
          }
          s[j] = sj;
          s2[j] = s2j;
        }
      }
      if (g.nr == K) {
        __syncthreads();  // slab z - H's slot is free
        if (z + 2 <= z1) stage_slab<T, CT, K>(xb, ring + ((z + K - z0) % K) * slab, z + H + 1, y0, x0, g, CX);
        cp_async_commit();
      }
    }
    // the item's partial, summed over the run slots in a fixed order: red[slot][2][C]
    if (ln.active) {
#pragma unroll
      for (int j = 0; j < KPM; ++j) {
        const int p = ln.p0 + j * ln.pt;
        if (p < P) {
          store2(red + (ln.slot * 2 + 0) * C + 2 * p, s[j].x, s[j].y);
          store2(red + (ln.slot * 2 + 1) * C + 2 * p, s2[j].x, s2[j].y);
        }
      }
    }
    __syncthreads();
    float* dst = partial + (long long)item * 2 * CX + c0;
    for (int i = threadIdx.x; i < 2 * C; i += kThreads) {
      const int k = i / C, c = i - k * C;
      float acc = 0.f;
      for (int r = 0; r < ln.tv; ++r) acc += red[(r * 2 + k) * C + c];
      dst[k * CX + c] = acc;
    }
    __syncthreads();  // red and the ring are rewritten by the next item
  }
}

// out[b] = the sum of b's `parts` partials, in order: one thread an
// element (grid: elements / kThreads x B), eight partials loaded ahead of
// each eight additions
__global__ void __launch_bounds__(kThreads)
    stats_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out, int parts, int C) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= 2 * C) return;
  const float* src = partial + (long long)b * parts * 2 * C + i;
  float acc = 0.f;
  int p = 0;
  for (; p + 8 <= parts; p += 8) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = src[(long long)(p + k) * 2 * C];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc += v[k];
  }
  for (; p < parts; ++p) acc += src[(long long)p * 2 * C];
  out[(long long)b * 2 * C + i] = acc;
}

// ---------------------------------------------------------------------------
// apply pass, bf16
// ---------------------------------------------------------------------------

struct Mlp {
  int R, Cout;
  int cs, ns;         // output channels a unit; units across Cout
  int mf;             // 16-row fragments of the u tile: ceil(ty * tw / 16)
  int rc;             // hidden units a weight chunk; rc == R: both weights resident
  int units, rounds;  // units = mf * ns, rounds = ceil(units / kWarps)
};

inline Mlp make_mlp(const Ring& g, int R, int Cout, int cs, int rc) {
  Mlp m{R, Cout, cs, Cout / cs, (g.ty * g.tw + 15) / 16, rc, 0, 0};
  m.units = m.mf * m.ns;
  m.rounds = (m.units + kWarps - 1) / kWarps;
  return m;
}

// Byte offsets of the apply kernel's shared memory, and its row strides
// (elements). Strides are odd multiples of 16 bytes, so the 8 rows of an
// ldmatrix or stmatrix phase fall on distinct banks.
struct ApplyLayout {
  int ldu, ldw1, ldw2, lds;
  size_t u, w1, w2, stage, total;
};

__host__ __device__ inline ApplyLayout apply_layout(const Ring& g, const Mlp& m) {
  ApplyLayout l;
  l.ldu = g.C + 8;
  l.ldw1 = g.C + 8;
  l.ldw2 = m.rc + 8;
  l.lds = m.cs + 8;
  l.u = align128((size_t)apply_slots(g) * slab_elems(g) * 2);
  l.w1 = l.u + align128((size_t)16 * m.mf * l.ldu * 2);
  l.w2 = l.w1 + align128((size_t)m.rc * l.ldw1 * 2);
  // past K 3 the W2 fragments come from global memory (w2_from_global): no w2 region
  l.stage = l.w2 + (g.hl == 1 ? align128((size_t)m.Cout * l.ldw2 * 2) : 0);
  l.total = l.stage + align128((size_t)kWarps * 16 * l.lds * 2);
  return l;
}

// Issue the copies of W1 rows [r0, r0 + rn) into w1s[rn][ldw1] and (with
// with_w2) of W2 columns [r0, r0 + rn) into w2s[Cout][ldw2].
__device__ __forceinline__ void stage_weights(const bf16* __restrict__ w1, const bf16* __restrict__ w2, bf16* w1s,
                                              bf16* w2s, int r0, int rn, int C, const Mlp& m,
                                              const ApplyLayout& l, bool with_w2 = true) {
  const int v1 = C / 8;
  for (int i = threadIdx.x; i < rn * v1; i += kThreads) {
    const int r = i / v1, q = i - r * v1;
    cp_async16(w1s + r * l.ldw1 + q * 8, w1 + (size_t)(r0 + r) * C + q * 8, true);
  }
  if (!with_w2) return;
  const int v2 = rn / 8;
  for (int i = threadIdx.x; i < m.Cout * v2; i += kThreads) {
    const int co = i / v2, q = i - co * v2;
    cp_async16(w2s + co * l.ldw2 + q * 8, w2 + (size_t)co * m.R + r0 + q * 8, true);
  }
}

// a float of the taps, loaded anew each time (volatile: the compiler keeps
// the 54 taps out of registers across the matmuls)
__device__ __forceinline__ float ldg_fresh(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// NB blocks of 16 hidden units (rows rr, rr + 16, ... of this weight chunk;
// hidden index r0 + rr of b1) for one warp's unit: h = u . W1^T on
// mma.sync, its A fragments cached (af) or loaded from u (abase) and shared
// by the NB blocks; bias and tanh-GELU on the accumulators, rounded to bf16
// as the A fragment of acc += h . W2^T (rows gq and gq + 8, hidden 2 tq and
// 8 + 2 tq of each 16). Without the cache, alternate k-steps go to two
// chains of accumulators, summed at the end.
// kW2G: the B fragments of W2 come from global memory (gw2: W2 at row n0 +
// gq, column r0 + 2 tq; R its row length), two 4-byte loads an n8 tile,
// in place of ldmatrix from the staged W2 (bw2).
template <int NB, int KA, int NP8, bool kCacheA, bool kW2G = false>
__device__ __forceinline__ void hidden_step(float (&acc)[NP8][4], const unsigned (&af)[KA][4], const bf16* abase,
                                            const bf16* bw1, const bf16* bw2, const float* __restrict__ b1, int rr,
                                            int r0, int C, const ApplyLayout& l, int tq,
                                            const bf16* __restrict__ gw2 = nullptr, int R = 0) {
  float h[NB][2][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) h[n][t][q] = 0.f;
  if constexpr (kCacheA) {
#pragma unroll
    for (int k = 0; k < KA; ++k) {
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        unsigned bb[4];
        ldsm_x4(bb, bw1 + (rr + 16 * n) * l.ldw1 + k * 16);
        mma16816(h[n][0], af[k], bb[0], bb[1]);
        mma16816(h[n][1], af[k], bb[2], bb[3]);
      }
    }
  } else {
    float h2[NB][2][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int q = 0; q < 4; ++q) h2[n][t][q] = 0.f;
    for (int k = 0; k < C; k += 32) {
      unsigned a[4];
      ldsm_x4(a, abase + k);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        unsigned bb[4];
        ldsm_x4(bb, bw1 + (rr + 16 * n) * l.ldw1 + k);
        mma16816(h[n][0], a, bb[0], bb[1]);
        mma16816(h[n][1], a, bb[2], bb[3]);
      }
      if (k + 16 < C) {
        ldsm_x4(a, abase + k + 16);
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          unsigned bb[4];
          ldsm_x4(bb, bw1 + (rr + 16 * n) * l.ldw1 + k + 16);
          mma16816(h2[n][0], a, bb[0], bb[1]);
          mma16816(h2[n][1], a, bb[2], bb[3]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int q = 0; q < 4; ++q) h[n][t][q] += h2[n][t][q];
  }
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    unsigned a2[4];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int col = r0 + rr + 16 * n + t * 8 + 2 * tq;
      const float c0 = __ldg(b1 + col), c1 = __ldg(b1 + col + 1);
      a2[2 * t] = pack_bf16(gelu_tanh_fast(h[n][t][0] + c0), gelu_tanh_fast(h[n][t][1] + c1));
      a2[2 * t + 1] = pack_bf16(gelu_tanh_fast(h[n][t][2] + c0), gelu_tanh_fast(h[n][t][3] + c1));
    }
#pragma unroll
    for (int j = 0; j < NP8 / 2; ++j) {
      unsigned bb[4];
      if constexpr (kW2G) {
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const bf16* q = gw2 + (size_t)(16 * j + 8 * t) * R + rr + 16 * n;
          bb[2 * t] = __ldg(reinterpret_cast<const unsigned*>(q));
          bb[2 * t + 1] = __ldg(reinterpret_cast<const unsigned*>(q + 8));
        }
      } else {
        ldsm_x4(bb, bw2 + j * 16 * l.ldw2 + rr + 16 * n);
      }
      mma16816(acc[2 * j], a2, bb[0], bb[1]);
      mma16816(acc[2 * j + 1], a2, bb[2], bb[3]);
    }
  }
}

// CT: C at compile time (32, 64, 128) or 0; NP8: n8 tiles of a unit's
// output channels (cs / 8). Two blocks a SM (128 registers a thread) where
// the unit's accumulators and u's cached A fragments leave room.
template <int CT>
constexpr int apply_min_blocks(int np8) {
  return np8 <= 8 && CT != 128 ? 2 : 1;
}

template <int CT, int NP8, int K>
__global__ void __launch_bounds__(kThreads, apply_min_blocks<CT>(NP8))
    ring_apply_kernel(const bf16* __restrict__ x, const float* __restrict__ stats, const float* __restrict__ w_dw,
                      const float* __restrict__ gamma, const float* __restrict__ beta, const bf16* __restrict__ w1,
                      const float* __restrict__ b1, const bf16* __restrict__ w2, const float* __restrict__ b2,
                      bf16* __restrict__ out, Ring g, Mlp m, float inv_n, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int KPM = CT ? (CT / 2 + kThreads - 1) / kThreads : 2;
  constexpr bool kCacheA = CT > 0 && CT <= 128;  // u's A fragments of a unit in registers
  constexpr int KA = kCacheA ? CT / 16 : 1;
  constexpr int H = K / 2;
  const int C = CT ? CT : g.C;
  const ApplyLayout l = apply_layout(g, m);
  const size_t slab = slab_elems(g);
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* u = reinterpret_cast<bf16*>(smem + l.u);
  bf16* w1s = reinterpret_cast<bf16*>(smem + l.w1);
  bf16* w2s = reinterpret_cast<bf16*>(smem + l.w2);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  bf16* stg = reinterpret_cast<bf16*>(smem + l.stage) + warp * 16 * l.lds;
  const bool resident = m.rc == m.R;
  const Lanes ln = lanes_of(C);
  const int P = C / 2;
  const bool residual = m.Cout == C;

  constexpr bool kW2G = K != 3;  // W2 from global memory past K 3 (apply_layout)
  if (resident) stage_weights(w1, w2, w1s, w2s, 0, m.R, C, m, l, !kW2G);  // committed with the first item's slabs

  for (int item = blockIdx.x; item < g.items; item += gridDim.x) {
    int b, y0, x0, z0, z1;
    item_origin(g, item, b, y0, x0, z0, z1);
    const bf16* xb = x + (long long)b * g.Z * g.Y * g.X * C;
    const int yv = min(g.ty, g.Y - y0), xv = min(g.tw, g.X - x0);  // the band's rows, columns inside the volume
    // GroupNorm folded into a scale and shift of the thread's channel pairs
    float2 sc[KPM], sh[KPM];
#pragma unroll
    for (int j = 0; j < KPM; ++j) {
      const int p = ln.p0 + j * ln.pt;
      sc[j] = sh[j] = make_float2(0.f, 0.f);
      if (p < P) {
        float v[2][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 2 * p + e;
          const float mean = stats[((long long)b * 2 + 0) * C + c] * inv_n;
          const float var = fmaxf(stats[((long long)b * 2 + 1) * C + c] * inv_n - mean * mean, 0.f);
          const float scl = gamma[c] * rsqrtf(var + eps);
          v[e][0] = scl;
          v[e][1] = beta[c] - mean * scl;
        }
        sc[j] = make_float2(v[0][0], v[1][0]);
        sh[j] = make_float2(v[0][1], v[1][1]);
      }
    }
    // slab z lives in slot (z - z0 + H) % K
    __syncthreads();  // the last item's epilogues have read the ring's centre slab
    for (int d = 0; d < K; ++d) stage_slab<bf16, CT, K>(xb, ring + d * slab, z0 - H + d, y0, x0, g);
    cp_async_commit();

    for (int z = z0; z < z1; ++z) {
      cp_async_wait<0>();
      __syncthreads();  // slab z + H has landed; the u tile is free
      if (ln.active) {
#pragma unroll
        for (int j = 0; j < KPM; ++j) {
          const int p = ln.p0 + j * ln.pt;
          if (p >= P) break;
          const float2 scj = sc[j], shj = sh[j];
          auto emit = [&](int ry, int rx, const float2(&a)[kRun]) {
#pragma unroll
            for (int q = 0; q < kRun; ++q) {
              const int xx = kRun * rx + q;
              if (xx < g.tw)
                store2(u + (ry * g.tw + xx) * l.ldu + 2 * p, fmaf(a[q].x, scj.x, shj.x), fmaf(a[q].y, scj.y, shj.y));
            }
          };
          if constexpr (K == 3) {
            const bf16* s0 = ring + ((z - z0) % kApplyRing) * slab;
            const bf16* s1 = ring + ((z - z0 + 1) % kApplyRing) * slab;
            const bf16* sl2 = ring + ((z - z0 + 2) % kApplyRing) * slab;
            float2 kw[27];
#pragma unroll
            for (int i = 0; i < 27; ++i)
              kw[i] = make_float2(ldg_fresh(w_dw + (2 * p) * 27 + i), ldg_fresh(w_dw + (2 * p + 1) * 27 + i));
            stencil_band<bf16, CT>(s0, s1, sl2, p, ln, g, C, kw, emit);
          } else {
            stencil_band_k<bf16, CT, K>(ring, z - z0, K, slab, w_dw, p, ln, g, C, emit);
          }
        }
      }
      __syncthreads();  // the u tile is complete; slab z - H's slot is free
      if (z + 2 <= z1) stage_slab<bf16, CT, K>(xb, ring + ((z + K - z0) % K) * slab, z + H + 1, y0, x0, g);
      cp_async_commit();
      // phase: stencil continue
      // the centre slab at the band's (row 0, x 0)
      const bf16* res = ring + ((z - z0 + H) % K) * slab + (size_t)(H * g.xp + H) * C;
      const long long obase = (((long long)b * g.Z + z) * g.Y + y0) * g.X + x0;

      for (int round = 0; round < m.rounds; ++round) {
        const int unit = round * kWarps + warp;
        const bool have = unit < m.units;
        const int mf = have ? unit % m.mf : 0;
        const int n0 = have ? (unit / m.mf) * m.cs : 0;
        float acc[NP8][4];
#pragma unroll
        for (int j = 0; j < NP8; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
        const bf16* abase = u + (mf * 16 + (lane & 15)) * l.ldu + (lane >> 4) * 8;
        unsigned af[KA][4];
        if (kCacheA && have) {
#pragma unroll
          for (int k = 0; k < KA; ++k) ldsm_x4(af[k], abase + k * 16);
        }
        const int nch = resident ? 1 : m.R / m.rc;
        for (int ch = 0; ch < nch; ++ch) {
          int r0 = 0, rn = m.R;
          if (!resident) {
            __syncthreads();  // everyone is done with chunk ch - 1
            stage_weights(w1, w2, w1s, w2s, ch * m.rc, m.rc, C, m, l, !kW2G);
            cp_async_commit();
            cp_async_wait<0>();
            __syncthreads();  // chunk ch has landed
            r0 = ch * m.rc;
            rn = m.rc;
          }
          if (have) {
            const bf16* bw1 = w1s + ((lane & 7) + ((lane >> 4) << 3)) * l.ldw1 + ((lane >> 3) & 1) * 8;
            const bf16* bw2 = w2s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * l.ldw2 + ((lane >> 3) & 1) * 8;
            const bf16* gw2 = w2 + (size_t)(n0 + gq) * m.R + r0 + 2 * tq;
            if (rn % 32 == 0) {
              for (int rr = 0; rr < rn; rr += 32)
                hidden_step<2, KA, NP8, kCacheA, kW2G>(acc, af, abase, bw1, bw2, b1, rr, r0, C, l, tq, gw2, m.R);
            } else {
              for (int rr = 0; rr < rn; rr += 16)
                hidden_step<1, KA, NP8, kCacheA, kW2G>(acc, af, abase, bw1, bw2, b1, rr, r0, C, l, tq, gw2, m.R);
            }
          }
        }
        if (!have) continue;
        // phase: mlp continue
        // epilogue: + b2 + residual, rounded to bf16, through the warp tile
        int roff[2];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = mf * 16 + gq + hf * 8;
          const int ry = row / g.tw;
          roff[hf] = row < g.ty * g.tw ? (ry * g.xp + row - ry * g.tw) * C : -1;
        }
        unsigned pk[NP8][2];
#pragma unroll
        for (int j = 0; j < NP8; ++j) {
          const int col = n0 + j * 8 + 2 * tq;
          const float c0 = __ldg(b2 + col), c1 = __ldg(b2 + col + 1);
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float o0 = acc[j][2 * hf] + c0, o1 = acc[j][2 * hf + 1] + c1;
            if (residual && roff[hf] >= 0) {
              const float2 rv = load2(res + roff[hf] + col);
              o0 += rv.x;
              o1 += rv.y;
            }
            pk[j][hf] = pack_bf16(o0, o1);
          }
        }
        bf16* sp = stg + ((lane & 7) + ((lane >> 3) & 1) * 8) * l.lds + (lane >> 4) * 8;
#pragma unroll
        for (int j = 0; j < NP8; j += 2) stsm_x4(sp + j * 8, pk[j][0], pk[j][1], pk[j + 1][0], pk[j + 1][1]);
        __syncwarp();
        constexpr int pieces = NP8;  // 16-byte pieces of a unit's row (8 channels each)
        for (int i = lane; i < 16 * pieces; i += 32) {
          const int rw = i / pieces, pc = i - rw * pieces;
          const int row = mf * 16 + rw;
          const int ry = row / g.tw, xl = row - ry * g.tw;  // u row = band row ry, column xl
          if (ry < yv && xl < xv)
            *reinterpret_cast<uint4*>(out + (obase + (long long)ry * g.X + xl) * m.Cout + n0 + pc * 8) =
                *reinterpret_cast<const uint4*>(stg + rw * l.lds + pc * 8);
        }
        __syncwarp();  // the warp tile is rewritten by the next unit
      }
    }
  }
}

// ---------------------------------------------------------------------------
// apply pass, float32: the first design, kept as the arithmetic check
// ---------------------------------------------------------------------------

// A tile is T consecutive flat voxels [v0, v0 + T) of x[b][v][c]. Its K^3
// neighbourhood (H = K / 2) lies inside K contiguous flat runs, one per
// z offset dz in [-H, H]:
//     [v0 + dz*Y*X - H*X - H,  v0 + T + dz*Y*X + H*X + H)
// or inside K^2 runs of T + 2H voxels, one per (dz, dy), whichever is
// smaller (the K^2 runs where X is wide, so that no row width outgrows
// shared memory). Staging a tile is coalesced cp.async copies of those runs
// of a channel group's values, all in flight at once. A run index outside
// the volume is zero-filled; a neighbour outside the volume only through y
// or x wrap-around is masked by its coordinates in the stencil, which gives
// exact SAME zero padding. A thread owns a channel pair and walks voxels,
// kVox at a time, reading two channels a load.
//
// halo_of: the K runs of T + 2H (X + 1) voxels or the K^2 runs of T + 2H.
// Tap (dz, dy, dx) of tile voxel t lies in run dz (K runs) or K dz + dy at
// t + dy * ys + dx.
__host__ __device__ __forceinline__ Halo halo_of(int tile, int X, int K) {
  const int H = K / 2;
  if (K * (tile + 2 * H * X + 2 * H) <= K * K * (tile + 2 * H)) return Halo{K, tile + 2 * H * X + 2 * H, X};
  return Halo{K * K, tile + 2 * H, 0};
}

// Issue the copies of the runs of tile [v0, v0 + tile) (halo_of), channels
// [c0, c0 + cg) of x, into halo[runs][L][cg]; the caller waits
// (cp_async_wait_all) and synchronises. Requires cg * sizeof(T) % 16 == 0.
template <typename T, int K>
__device__ __forceinline__ void stage_halo(const T* __restrict__ xb, T* __restrict__ halo, int v0, int tile,
                                             const Geom& g, int c0, int cg) {
  constexpr int H = K / 2;
  const Halo h = halo_of(tile, g.X, K);
  const int L = h.L;
  constexpr int per = 16 / (int)sizeof(T);
  const int vec = cg / per;
  const int YX = g.Y * g.X;
  const int total = h.runs * L * vec;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int d = i / (L * vec);
    const int rem = i - d * L * vec;
    const int vox = rem / vec;
    const int q = rem - vox * vec;
    const int dz = h.runs == K ? d : d / K, dy = h.runs == K ? 0 : d - K * dz;
    const int flat = v0 + (dz - H) * YX + (dy - H) * g.X - H + vox;
    const bool valid = flat >= 0 && flat < g.N;
    cp_async16(halo + (d * L + vox) * cg + q * per, xb + (valid ? (long long)flat * g.C + c0 + q * per : 0),
               valid);
  }
}

// Bit d of each axis is set where coordinate + d - H lies inside the volume;
// all zero for a voxel past the tile or the volume.
template <int K>
__device__ __forceinline__ TapMask tap_mask(int t, int v0, int tile, const Geom& g) {
  constexpr int H = K / 2;
  const int v = v0 + t;
  if (t >= tile || v >= g.N) return TapMask{0u, 0u, 0u};
  const int YX = g.Y * g.X;
  const int z = v / YX;
  const int rem = v - z * YX;
  const int y = rem / g.X;
  const int x = rem - y * g.X;
  TapMask m{0u, 0u, 0u};
#pragma unroll
  for (int d = 0; d < K; ++d) {
    m.z |= (z + d - H >= 0 && z + d - H < g.Z) ? 1u << d : 0u;
    m.y |= (y + d - H >= 0 && y + d - H < g.Y) ? 1u << d : 0u;
    m.x |= (x + d - H >= 0 && x + d - H < g.X) ? 1u << d : 0u;
  }
  return m;
}

// dw(x) without bias for channel pair p (inside the halo's cg channels) at
// the kVox tile voxels t[j]: the sum over each voxel's in-volume taps, f32
// accumulate in the order dz, dy, dx; zero for a masked-out voxel. The taps
// are loaded where they are used (w0, w1: the K^3 taps of channels 2p and
// 2p + 1 of x).
template <typename T, int K>
__device__ __forceinline__ void stencil2(const T* __restrict__ halo, const float* __restrict__ w0,
                                           const float* __restrict__ w1, const int (&t)[kVox],
                                           const TapMask (&m)[kVox], int p, int tile, const Geom& g, int cg,
                                           float2 (&acc)[kVox]) {
  const Halo hl = halo_of(tile, g.X, K);
  const T* h = halo + 2 * p;
#pragma unroll
  for (int j = 0; j < kVox; ++j) acc[j] = make_float2(0.f, 0.f);
#pragma unroll 1
  for (int dz = 0; dz < K; ++dz) {
#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        const int tap = (dz * K + dy) * K + dx;
        const float2 kk = make_float2(__ldg(w0 + tap), __ldg(w1 + tap));
#pragma unroll
        for (int j = 0; j < kVox; ++j) {
          if ((m[j].z >> dz) & (m[j].y >> dy) & (m[j].x >> dx) & 1u) {
            const int run = hl.runs == K ? dz : K * dz + dy;
            const float2 v = load2(h + (run * hl.L + t[j] + dy * hl.ys + dx) * cg);
            acc[j].x = fmaf(kk.x, v.x, acc[j].x);
            acc[j].y = fmaf(kk.y, v.y, acc[j].y);
          }
        }
      }
    }
  }
}

// Row strides of the f32 apply kernel's shared-memory matrices, padded 16
// bytes past the row length.
struct F32Layout {
  int ldu, ldhf, ldh, ldacc;
  size_t scale, u, region, hf, h, acc, total;
};

// cg: the channels of one staged halo (C, or past K 3 a divisor of C where
// the whole halo does not fit; the stencil then runs a group at a time)
__host__ __device__ inline F32Layout f32_layout(int tile, int X, int C, int Rc, int Cout, int K, int cg) {
  const Halo hl = halo_of(tile, X, K);
  F32Layout l;
  l.ldu = C + 8;
  l.ldhf = Rc + 4;
  l.ldh = Rc + 8;
  l.ldacc = Cout + 4;
  l.scale = 0;
  l.u = align128(2 * (size_t)C * 4);
  l.region = l.u + align128((size_t)tile * l.ldu * 4);
  const size_t halo = align128((size_t)hl.runs * hl.L * cg * 4);
  l.hf = l.region;
  l.h = l.hf + align128((size_t)tile * l.ldhf * 4);
  l.acc = l.h + align128((size_t)tile * l.ldh * 4);
  const size_t mlp = l.acc + align128((size_t)tile * l.ldacc * 4) - l.region;
  l.total = l.region + (halo > mlp ? halo : mlp);
  return l;
}

template <int K>
__global__ void __launch_bounds__(kThreads, 2)
    f32_apply_kernel(const float* __restrict__ x, const float* __restrict__ stats, const float* __restrict__ w_dw,
                     const float* __restrict__ gamma, const float* __restrict__ beta, const float* __restrict__ w1,
                     const float* __restrict__ b1, const float* __restrict__ w2, const float* __restrict__ b2,
                     float* __restrict__ out, Geom g, int R, int Rc, int Cout, int tile, int cg, float inv_n,
                     float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int KK = K * K * K;
  const F32Layout l = f32_layout(tile, g.X, g.C, Rc, Cout, K, cg);
  float* scale = reinterpret_cast<float*>(smem + l.scale);
  float* shift = scale + g.C;
  float* u = reinterpret_cast<float*>(smem + l.u);
  float* halo = reinterpret_cast<float*>(smem + l.region);
  float* hf = reinterpret_cast<float*>(smem + l.hf);
  float* h = reinterpret_cast<float*>(smem + l.h);
  float* acc = reinterpret_cast<float*>(smem + l.acc);

  const int b = blockIdx.y;
  const int v0 = blockIdx.x * tile;
  const float* xb = x + (long long)b * g.N * g.C;
  const int C = g.C;

  // GroupNorm folded into a per-channel scale/shift of dw(x) (bias cancels)
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float mean = stats[((long long)b * 2 + 0) * C + c] * inv_n;
    const float var = fmaxf(stats[((long long)b * 2 + 1) * C + c] * inv_n - mean * mean, 0.f);
    const float sc = gamma[c] * rsqrtf(var + eps);
    scale[c] = sc;
    shift[c] = beta[c] - mean * sc;
  }
  for (int c0 = 0; c0 < C; c0 += cg) {
    __syncthreads();  // the last group's stencil has read the halo
    stage_halo<float, K>(xb, halo, v0, tile, g, c0, cg);
    cp_async_wait_all();
    __syncthreads();
    const int cp = (c0 + cg) / 2;  // the group's pairs end here
    const int pt = cg / 2 < kThreads ? cg / 2 : kThreads;
    const int tv = kThreads / pt;
    const int tt = threadIdx.x / pt;
    if (tt < tv) {
      for (int p = c0 / 2 + threadIdx.x % pt; p < cp; p += pt) {
        const float2 sc = make_float2(scale[2 * p], scale[2 * p + 1]);
        const float2 sh = make_float2(shift[2 * p], shift[2 * p + 1]);
        for (int t0 = tt; t0 < tile; t0 += kVox * tv) {
          int t[kVox];
          TapMask m[kVox];
#pragma unroll
          for (int q = 0; q < kVox; ++q) {
            t[q] = t0 + q * tv;
            m[q] = tap_mask<K>(t[q], v0, tile, g);
          }
          float2 a[kVox];
          stencil2<float, K>(halo, w_dw + (size_t)(2 * p) * KK, w_dw + (size_t)(2 * p + 1) * KK, t, m, p - c0 / 2,
                             tile, g, cg, a);
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

  for (int r0 = 0; r0 < R; r0 += Rc) {
    // hf[T][Rc] = u[T][C] . W1[r0:r0+Rc, :]^T
    for (int i = threadIdx.x; i < tile * Rc; i += blockDim.x) {
      const int t = i / Rc, r = i - t * Rc;
      const float* ur = u + t * l.ldu;
      const float* wr = w1 + (long long)(r0 + r) * C;
      float a = 0.f;
      for (int c = 0; c < C; ++c) a = fmaf(ur[c], __ldg(wr + c), a);
      hf[t * l.ldhf + r] = a;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < tile * Rc; i += blockDim.x) {
      const int t = i / Rc, r = i - t * Rc;
      h[t * l.ldh + r] = gelu_tanh(hf[t * l.ldhf + r] + __ldg(b1 + r0 + r));
    }
    __syncthreads();
    // acc[T][Cout] += h[T][Rc] . W2[:, r0:r0+Rc]^T
    for (int i = threadIdx.x; i < tile * Cout; i += blockDim.x) {
      const int t = i / Cout, co = i - t * Cout;
      const float* hr = h + t * l.ldh;
      const float* wr = w2 + (long long)co * R + r0;
      float a = acc[t * l.ldacc + co];
      for (int r = 0; r < Rc; ++r) a = fmaf(hr[r], __ldg(wr + r), a);
      acc[t * l.ldacc + co] = a;
    }
    __syncthreads();
  }

  float* ob = out + (long long)b * g.N * Cout;
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

// The f32 apply's tile (flat voxels a block) and halo channel group: at K 3
// the whole C; past it, where no tile of all C fits, tiles of 16 and the
// largest group of channels (a multiple of 16 dividing C) that fits.
inline int f32_tile(int C, int X, int Rc, int Cout, int K, int* cg) {
  *cg = C;
  int t = 4096 / C;
  t = t > 128 ? 128 : t;
  t = (t / 16) * 16;
  t = t < 16 ? 16 : t;
  while (t > 16 && f32_layout(t, X, C, Rc, Cout, K, C).total > kMaxSmem) t -= 16;
  // K^2 runs of 8 + K - 1 voxels: C up to 640 at K 3
  if (f32_layout(t, X, C, Rc, Cout, K, C).total > kMaxSmem) t = 8;
  if (K != 3 && f32_layout(t, X, C, Rc, Cout, K, C).total > kMaxSmem) {
    t = 16;
    for (int g = C - 16; g >= 16; g -= 16) {
      if (C % g == 0 && f32_layout(t, X, C, Rc, Cout, K, g).total <= kMaxSmem) {
        *cg = g;
        break;
      }
    }
  }
  return t;
}

// hidden units a chunk of the float32 apply: all of R up to 64, else the
// largest of 64, 48, 32, 16 that divides R (the sums run over R in order
// whatever the chunk)
inline int f32_rc(int R) {
  if (R <= 64) return R;
  for (int rc = 64; rc > 16; rc -= 16)
    if (R % rc == 0) return rc;
  return 16;
}

inline size_t stats_smem(const Ring& g, int es) {
  const int pt = g.C / 2 < kThreads ? g.C / 2 : kThreads;
  return align128(g.nr * slab_elems(g) * es) + align128((size_t)(kThreads / pt) * 2 * g.C * 4);
}

using StatsKernel = void (*)(const void*, const float*, float*, Ring);
using ApplyKernel = void (*)(const bf16*, const float*, const float*, const float*, const float*, const bf16*,
                             const float*, const bf16*, const float*, bf16*, Ring, Mlp, float, float);
using F32Kernel = void (*)(const float*, const float*, const float*, const float*, const float*, const float*,
                           const float*, const float*, const float*, float*, Geom, int, int, int, int, int, float,
                           float);

template <typename T, int CT, int K>
StatsKernel stats_fn() {
  void (*k)(const T*, const float*, float*, Ring) = ring_stats_kernel<T, CT, K>;
  return reinterpret_cast<StatsKernel>(k);
}

// The statistics kernel for a width and stencil: at K 3, C at compile time
// where MedNeXt uses it; K 5 is built for the runtime C only (build time).
template <typename T>
StatsKernel stats_kernel(int C, int K) {
  if (K == 5) return stats_fn<T, 0, 5>();
  switch (C) {
    case 32: return stats_fn<T, 32, 3>();
    case 64: return stats_fn<T, 64, 3>();
    case 128: return stats_fn<T, 128, 3>();
    case 256: return stats_fn<T, 256, 3>();
    case 512: return stats_fn<T, 512, 3>();
    default: return stats_fn<T, 0, 3>();
  }
}

template <int CT, int K>
ApplyKernel apply_kernel_c(int cs) {
  switch (cs) {
    case 16: return ring_apply_kernel<CT, 2, K>;
    case 32: return ring_apply_kernel<CT, 4, K>;
    case 64: return ring_apply_kernel<CT, 8, K>;
    case 128: return ring_apply_kernel<CT, 16, K>;
    default: return nullptr;
  }
}

inline ApplyKernel apply_kernel(int C, int cs, int K) {
  if (K == 5) return apply_kernel_c<0, 5>(cs);
  switch (C) {
    case 32: return apply_kernel_c<32, 3>(cs);
    case 64: return apply_kernel_c<64, 3>(cs);
    case 128: return apply_kernel_c<128, 3>(cs);
    default: return apply_kernel_c<0, 3>(cs);
  }
}

inline F32Kernel f32_kernel(int K) {
  if (K == 5) return f32_apply_kernel<5>;
  return f32_apply_kernel<3>;
}

inline bool mlp_ok(const Ring& g, int R, int Cout, int cs, int rc) {
  return R >= 16 && R % 16 == 0 && Cout % 16 == 0 && Cout >= 16 && (cs == 16 || cs == 32 || cs == 64 || cs == 128) &&
         Cout % cs == 0 && rc >= 16 && rc % 16 == 0 && R % rc == 0 && (long long)g.Z * g.Y * g.X * Cout < (1LL << 31);
}

}  // namespace mednext

// dtype: 0 = float32, 1 = bfloat16; K: the depthwise stencil's edge, 3 or 5
// (taps (C, K^3) float32). Every entry returns 0 or an error code (a
// cudaError_t, or 10001 for a shape or plan the kernels do not take).
extern "C" {

// The plan (ty, tx, seg, ring slots; for the apply pass cs, rc) as the kernel takes it, on
// the current device: out = [shared-memory bytes, work items, resident
// blocks a SM, grid (SMs x resident blocks, at most the items), registers a
// thread]. kind: 0 statistics, 1 apply (bf16), 2 apply (f32: its tiles
// follow from the shape; ty, tx and seg unused). The first call for a kernel on
// a device lets it take all of the shared memory (mednext::occupancy), which
// a launch then needs.
int mednext_ring_plan(int kind, int dtype, int B, int Z, int Y, int X, int C, int R, int Cout, int ty, int tx,
                      int seg, int nr, int cs, int rc, int K, int* out) {
  using namespace mednext;
  if (kind != 0) nr = K;
  if (kind == 2) {
    ty = seg = 1;
    tx = kRun * ((X + kRun - 1) / kRun);
  }
  if (!ring_ok(B, Z, Y, X, C, ty, tx, seg, nr, K)) return kErrShape;
  Ring g = make_ring(B, Z, Y, X, C, ty, tx, seg, nr, K);
  const void* fn;
  size_t smem;
  if (kind == 2) {
    const int Rc = f32_rc(R);
    if (dtype || R < 16 || R % 16 || Cout % 16) return kErrShape;
    int cg = C;
    const int tile = f32_tile(C, X, Rc, Cout, K, &cg);
    fn = reinterpret_cast<const void*>(f32_kernel(K));
    smem = f32_layout(tile, X, C, Rc, Cout, K, cg).total;
    g.items = B * (int)(((long long)Z * Y * X + tile - 1) / tile);
  } else if (kind == 0) {
    fn = reinterpret_cast<const void*>(dtype ? stats_kernel<bf16>(C, K) : stats_kernel<float>(C, K));
    smem = stats_smem(g, dtype ? 2 : 4);
  } else {
    if (!dtype || !mlp_ok(g, R, Cout, cs, rc)) return kErrShape;
    fn = reinterpret_cast<const void*>(apply_kernel(C, cs, K));
    smem = apply_layout(g, make_mlp(g, R, Cout, cs, rc)).total;
  }
  if (smem > kMaxSmem) return kErrShape;
  int occ = 0;
  const int e = occupancy(fn, kThreads, smem, &occ);
  if (e) return e;
  if (occ < 1) return kErrShape;
  cudaFuncAttributes attr;
  const cudaError_t ea = cudaFuncGetAttributes(&attr, fn);
  if (ea != cudaSuccess) return (int)ea;
  const long long grid = kind == 2 ? g.items : (long long)sm_count() * occ;
  out[0] = (int)smem;
  out[1] = g.items;
  out[2] = occ;
  out[3] = (int)(grid < g.items ? grid : g.items);
  out[4] = attr.numRegs;
  return 0;
}

// partial: (B * segs * bands * xbands, 2, C) float32 scratch; out (B, 2, C); nr: K + 1 or K ring slots;
// groups: channel groups of C / groups each (the plan is a group's), grid blocks a group.
int mednext_dw_stats(const void* x, const void* w_dw, void* partial, void* out, int dtype, int B, int Z, int Y,
                     int X, int C, int groups, int ty, int tx, int seg, int nr, int K, int grid, void* stream) {
  using namespace mednext;
  if (groups < 1 || C % groups) return kErrShape;
  const int cg = C / groups;
  if (!ring_ok(B, Z, Y, X, cg, ty, tx, seg, nr, K) || grid < 1) return kErrShape;
  Ring g = make_ring(B, Z, Y, X, cg, ty, tx, seg, nr, K);
  g.cx = C;
  const size_t smem = stats_smem(g, dtype ? 2 : 4);
  if (smem > kMaxSmem) return kErrShape;
  auto s = static_cast<cudaStream_t>(stream);
  const StatsKernel k = dtype ? stats_kernel<bf16>(cg, K) : stats_kernel<float>(cg, K);
  const int blocks = grid < g.items ? grid : g.items;
  k<<<dim3(blocks, groups), kThreads, smem, s>>>(x, static_cast<const float*>(w_dw), static_cast<float*>(partial),
                                                 g);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  stats_reduce_kernel<<<dim3((2 * C + kThreads - 1) / kThreads, B), kThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), g.segs * g.bands * g.xbands, C);
  return (int)cudaGetLastError();
}

int mednext_apply_bf16(const void* x, const void* stats, const void* w_dw, const void* gamma, const void* beta,
                       const void* w1, const void* b1, const void* w2, const void* b2, void* out, int B, int Z, int Y,
                       int X, int C, int R, int Cout, int ty, int tx, int seg, int cs, int rc, int K, int grid,
                       float eps, void* stream) {
  using namespace mednext;
  if (!ring_ok(B, Z, Y, X, C, ty, tx, seg, K, K) || grid < 1) return kErrShape;
  const Ring g = make_ring(B, Z, Y, X, C, ty, tx, seg, K, K);
  if (!mlp_ok(g, R, Cout, cs, rc)) return kErrShape;
  const Mlp m = make_mlp(g, R, Cout, cs, rc);
  const size_t smem = apply_layout(g, m).total;
  if (smem > kMaxSmem) return kErrShape;
  const ApplyKernel k = apply_kernel(C, cs, K);
  const int blocks = grid < g.items ? grid : g.items;
  k<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(stats), static_cast<const float*>(w_dw),
      static_cast<const float*>(gamma), static_cast<const float*>(beta), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2), static_cast<const float*>(b2),
      static_cast<bf16*>(out), g, m, 1.f / ((float)Z * Y * X), eps);
  return (int)cudaGetLastError();
}

// The float32 apply pass (its tiles follow from the shape; mednext_ring_plan
// of kind 2 first, once per device).
int mednext_block_apply_f32(const void* x, const void* stats, const void* w_dw, const void* gamma, const void* beta,
                            const void* w1, const void* b1, const void* w2, const void* b2, void* out, int B, int Z,
                            int Y, int X, int C, int R, int Cout, int K, float eps, void* stream) {
  using namespace mednext;
  if ((long long)Z * Y * X * (C > Cout ? C : Cout) >= (1LL << 31) || (K != 3 && K != 5)) return kErrShape;
  const Geom g{Z, Y, X, C, Z * Y * X};
  const int Rc = f32_rc(R);
  if (R < 16 || R % 16 || C % 16 || Cout % 16) return kErrShape;
  int cg = C;
  const int tile = f32_tile(C, X, Rc, Cout, K, &cg);
  const size_t smem = f32_layout(tile, X, C, Rc, Cout, K, cg).total;
  if (smem > kMaxSmem) return kErrShape;
  const unsigned tiles = (unsigned)((g.N + tile - 1) / tile);
  f32_kernel(K)<<<dim3(tiles, B), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(stats), static_cast<const float*>(w_dw),
      static_cast<const float*>(gamma), static_cast<const float*>(beta), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<float*>(out), g, R, Rc, Cout, tile, cg, 1.f / (float)g.N, eps);
  return (int)cudaGetLastError();
}

const char* mednext_error_string(int code) {
  if (code == mednext::kErrShape) return "shape or plan not supported by the MedNeXt block kernels";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
