// Per-sample 'same' 3-D convolution and its transpose, for Hopper (sm_90a).
//
// Replaces the TPU kernel repmode_tpu/ops/pallas/conv3d.py:
// pallas_conv3d_same_persample (body _conv_kernel_ps) in both of its uses:
//
//   forward (K2)        y[n,p,o]  = sum_t sum_i x[n, p + t - c, i] * w[n, t, i, o]
//   transposed (K3)     dx[n,p,i] = sum_t sum_o dy[n, p + t - c, o] * w[n, T-1-t, i, o]
//
// with zero 'same' padding, any odd (kD, kH, kW), NDHWC activations and the
// per-sample merged MoDE kernels w of shape (N, kD, kH, kW, Ci, Co), as the
// gate-merge einsum writes them. The transposed conv is the dx of the
// forward: it reads the FORWARD kernels with the taps reversed and contracts
// on their output axis, so no flipped, io-swapped, transposed or padded copy
// of the per-sample kernels is ever written (N*T*Ci*Co*2 bytes a conv, 0.52
// GB at the 512x512 bottleneck at batch 8). Inputs are bf16, products are
// summed in fp32 and the output is bf16 (the dtype contract of
// repmode_tpu/ops/mode.py:merged_conv_persample).
//
// What bounds it: like the shared-kernel conv (conv3d_same.cu) it does
// 2*125*Ci*Co operations per output voxel, far above the card's ~295
// operations per byte at every MoDE conv of the training net except the
// 1-channel input and output convs, so it is bound by tensor-core
// operations. The per-sample kernels add bytes: each is read by every block
// of its sample, so the grid keeps a sample's blocks together (below) and a
// sample's kernel comes from device memory about once.
//
// Both instances are one implicit GEMM: M = a tile of output positions
// inside one (n, d) plane, N = a tile of output channels, K = taps x
// contraction channels, walked as (dz, dy, channel chunk) stages. Per stage
// one input slab (the tile's rows shifted by dy, widened by the kW-1 column
// halo) and the kW tap matrices of that (dz, dy) are copied to shared
// memory; all kW taps read the same slab at addresses shifted by dx
// positions, so the input is read kD*kH times, not 125 times. Halos and
// channel tails are zero-filled by the copies; depth taps outside the volume
// are skipped. No atomics: every output is written once, so results are
// bit-reproducible. The host's plan (ops/conv3d.py,
// conv3d_same_persample_plan) picks the instance and its tiles.
//
// wide instance (packed contraction channels >= 16, output channels >= 32,
// planes of 128 positions or more): hopper.cuh's warpgroup-MMA conv block
// (wgmma_conv_block: conv3d_same.cu's tiles, KC and TMA ring) with a
// per-sample weight map. wgmma.mma_async.m64n{BN}k16 with both operands in
// shared memory, 1 or 2 warpgroups of 1, 2 or 4 m64 tiles, BN = 32, 64 or
// 128, a 3-4 stage ring.
//   * B: w read in place through a 4-D tensor map over its true extents
//     (Co, Ci, T, N); the map's out-of-bounds fill gives the zeros past Ci
//     and Co. The transposed conv reads it K-major with the taps reversed
//     by the box, the forward MN-major through wgmma's transpose-B
//     immediate.
//   * The grid is 1-D with the sample outermost, then the Co tile, the
//     depth and the position tile: the blocks of one sample run together, so
//     its kernel comes from device memory about once, and the blocks in
//     flight share one Co tile of it (measured up to 10 % faster at the
//     convs with two or more Co tiles than the Co tile fastest).
//
// narrow instance (the packed 1-channel input conv, conv_out and its dx,
// the 2x8x8 bottleneck, small test shapes): the bf16 mma.sync.m16n8k16
// kernel of the first port: BM = 128 positions, BN <= 64, KC <= 32, two
// stage buffers filled by per-thread zero-filling cp.async, A and B by
// ldmatrix (ldmatrix.trans for the forward's B).
//
// The contraction channel count (x's channels, Ci forward and Co transposed)
// must be a multiple of 8 (16-byte copies), and so must the forward kernels'
// output axis; the caller packs or pads the narrow 1-channel cases.

#include "hopper.cuh"  // mma.sync, wgmma, mbarrier and TMA helpers

namespace {

constexpr int BM = 128;      // narrow instance: output positions per block
constexpr int THREADS = 256; // narrow instance: 8 warps, 4 along M (32 rows each) x 2 along N
constexpr int SMEM_MAX = 227 * 1024;

struct PsParams {
  const __nv_bfloat16* x;  // (N, D, H, W, cin)
  const __nv_bfloat16* wt; // (N, T, wci, wco): the forward's per-sample kernels
  __nv_bfloat16* y;        // (N, D, H, W, cout)
  int n, d, h, w, cin, cout;
  int kd, kh, kw;
  int wci, wco;         // forward: wci == cin, wco >= cout; transposed: wco == cin, wci >= cout
  int tw;               // columns per tile
  int rows_per_tile;    // rows per tile
  int tiles_per_row;    // ceil(W / tw)
  int tiles_per_plane;
  int slab_cap;         // slab positions per stage buffer
  int stages;           // wide instance: ring depth
  int pitch;            // wide instance: slab positions a tile row (tw + kw - 1)
  int patch;            // wide instance: m64 tiles of 8 x 8 positions (1) or of one row (0)
  int co_tiles;         // wide instance: output-channel tiles
};

// ---------------------------------------------------------------- narrow instance

// KC: contraction channels per stage (16 or 32). BN: output channels per
// block (16, 32 or 64). TRANS: the transposed conv (K3). Each warp owns a
// 32 x (BN/2) output tile.
template <int KC, int BN, bool TRANS>
__global__ void __launch_bounds__(THREADS)
conv3d_persample_kernel(const PsParams p) {
  constexpr int A_STRIDE = KC + 8;  // bf16 per slab position (pad: no bank conflicts)
  // weight tile of one tap: forward KC rows x BN, transposed BN rows x KC
  constexpr int B_STRIDE = TRANS ? KC + 8 : BN + 8;
  constexpr int B_ROWS = TRANS ? BN : KC;
  constexpr int B_SEGS = (TRANS ? KC : BN) / 8;  // 16-byte segments per weight row
  constexpr int WN = BN / 2;        // output channels per warp
  constexpr int NT = WN / 8;        // n8 tiles per warp
  constexpr int SEGS = KC / 8;      // 16-byte segments per slab position

  extern __shared__ __align__(16) unsigned char smem[];
  const int slab_elems = p.slab_cap * A_STRIDE;
  const int buf_elems = slab_elems + p.kw * B_ROWS * B_STRIDE;
  __nv_bfloat16* base = reinterpret_cast<__nv_bfloat16*>(smem);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp & 3;
  const int warp_n = warp >> 2;

  // ---- which tile this block computes ----
  int bx = blockIdx.x;
  const int t = bx % p.tiles_per_plane;
  bx /= p.tiles_per_plane;
  const int dd = bx % p.d;
  const int nn = bx / p.d;
  const int h0 = (t / p.tiles_per_row) * p.rows_per_tile;
  const int w0 = (t % p.tiles_per_row) * p.tw;
  const int rows = min(p.rows_per_tile, p.h - h0);
  const int twv = min(p.tw, p.w - w0);
  const int cols = twv + p.kw - 1;
  const int npos = rows * cols;
  const int co0 = blockIdx.y * BN;

  const int taps = p.kd * p.kh * p.kw;
  const __nv_bfloat16* wsample = p.wt + (long long)nn * taps * p.wci * p.wco;

  const int pd = (p.kd - 1) / 2, ph = (p.kh - 1) / 2, pw = (p.kw - 1) / 2;
  const int dz_lo = max(0, pd - dd);
  const int dz_hi = min(p.kd, p.d - dd + pd);
  const int nchunks = (p.cin + KC - 1) / KC;
  const int num_stages = (dz_hi - dz_lo) * p.kh * nchunks;

  // slab position read by each of this thread's two ldmatrix rows (tap dx=0)
  int a_pos[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int m = warp_m * 32 + mt * 16 + (lane & 15);
    const int r = m / twv, c = m - (m / twv) * twv;
    a_pos[mt] = (r < rows) ? r * cols + c : 0;  // rows past the tile: never stored
  }

  auto load_stage = [&](int s, int buf) {
    const int chunk = s % nchunks;
    const int rest = s / nchunks;
    const int dy = rest % p.kh;
    const int dz = dz_lo + rest / p.kh;
    const int di = dd + dz - pd;
    const int ci0 = chunk * KC;
    __nv_bfloat16* slab = base + buf * buf_elems;
    __nv_bfloat16* wsm = slab + slab_elems;
    const long long plane = ((long long)nn * p.d + di) * p.h;

    for (int i = tid; i < npos * SEGS; i += THREADS) {
      const int pos = i / SEGS, sg = i - (i / SEGS) * SEGS;
      const int r = pos / cols, c = pos - (pos / cols) * cols;
      const int hi = h0 + r + dy - ph, wi = w0 + c - pw;
      const int ci = ci0 + sg * 8;
      const bool ok = hi >= 0 && hi < p.h && wi >= 0 && wi < p.w && ci < p.cin;
      const __nv_bfloat16* src = ok ? p.x + ((plane + hi) * p.w + wi) * p.cin + ci : p.x;
      cp_async16(smem_u32(slab + pos * A_STRIDE + sg * 8), src, ok ? 16 : 0);
    }

    const int tap0 = (dz * p.kh + dy) * p.kw;
    for (int i = tid; i < p.kw * B_ROWS * B_SEGS; i += THREADS) {
      const int row = i / B_SEGS, sg = i - (i / B_SEGS) * B_SEGS;
      const int dx = row / B_ROWS, k = row - (row / B_ROWS) * B_ROWS;
      bool ok;
      const __nv_bfloat16* src;
      if (TRANS) {
        // row k = output channel co0+k (the forward's input axis) of the
        // reversed tap; 8 contraction channels (the forward's output axis)
        const int j = co0 + k, o = ci0 + sg * 8;
        ok = j < p.wci && o < p.wco;
        src = wsample + ((long long)(taps - 1 - (tap0 + dx)) * p.wci + j) * p.wco + o;
      } else {
        const int i_ = ci0 + k, o = co0 + sg * 8;
        ok = i_ < p.wci && o < p.wco;
        src = wsample + ((long long)(tap0 + dx) * p.wci + i_) * p.wco + o;
      }
      cp_async16(smem_u32(wsm + row * B_STRIDE + sg * 8), ok ? src : p.wt, ok ? 16 : 0);
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0.0f;

  if (num_stages > 0) {
    load_stage(0, 0);
  }
  cp_async_commit();
  for (int s = 0; s < num_stages; ++s) {
    const int buf = s & 1;
    if (s + 1 < num_stages) load_stage(s + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

    const __nv_bfloat16* slab = base + buf * buf_elems;
    const __nv_bfloat16* wsm = slab + slab_elems;
    const uint32_t slab_addr = smem_u32(slab);
    const uint32_t w_addr = smem_u32(wsm);
    for (int dx = 0; dx < p.kw; ++dx) {
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int off = (a_pos[mt] + dx) * A_STRIDE + kk * 16 + (lane >> 4) * 8;
          ldmatrix_x4(slab_addr + off * 2, a[mt]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t b[2];
          if (TRANS) {
            const int off = (dx * BN + warp_n * WN + j * 8 + (lane & 7)) * B_STRIDE + kk * 16 +
                            ((lane >> 3) & 1) * 8;
            ldmatrix_x2(w_addr + off * 2, b);
          } else {
            const int off =
                (dx * KC + kk * 16 + (lane & 15)) * B_STRIDE + warp_n * WN + j * 8;
            ldmatrix_x2_trans(w_addr + off * 2, b);
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_bf16_16816(acc[mt][j], a[mt], b);
        }
      }
    }
    __syncthreads();
  }

  // ---- epilogue: round to bf16 and store ----
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = warp_m * 32 + mt * 16 + (lane >> 2) + half * 8;
      const int r = m / twv, c = m - (m / twv) * twv;
      if (r >= rows) continue;
      const long long out_base =
          ((((long long)nn * p.d + dd) * p.h + h0 + r) * p.w + w0 + c) * p.cout;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = co0 + warp_n * WN + j * 8 + (lane & 3) * 2 + e;
          if (co >= p.cout) continue;
          p.y[out_base + co] = __float2bfloat16_rn(acc[mt][j][half * 2 + e]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- warpgroup MMA

// WG warpgroups of MT m64 tiles each (BM = 64 * WG * MT output positions),
// KC contraction channels a stage, BN output channels a block; TRANS: the
// transposed conv (K3). The block itself is hopper.cuh's wgmma_conv_block.
template <int WG, int MT, int KC, int BN, bool TRANS>
__global__ void __launch_bounds__(WG * 128, WG == 2 ? 2 : 4)
conv3d_persample_kernel_wgmma(const PsParams p, const __grid_constant__ CUtensorMap tmx,
                              const __grid_constant__ CUtensorMap tmw) {
  // ---- which tile this block computes: the position tile fastest, then
  // the depth, the Co tile and the sample ----
  int bx = blockIdx.x;
  const int pos = bx % p.tiles_per_plane;
  bx /= p.tiles_per_plane;
  ConvTile t;
  t.dd = bx % p.d;
  bx /= p.d;
  t.co0 = (bx % p.co_tiles) * BN;
  t.nn = bx / p.co_tiles;
  t.wn = t.nn;  // the sample's own kernels
  t.h0 = (pos / p.tiles_per_row) * p.rows_per_tile;
  t.w0 = (pos % p.tiles_per_row) * p.tw;
  t.rows = min(p.rows_per_tile, p.h - t.h0);
  t.twv = min(p.tw, p.w - t.w0);

  // round to bf16 and store, in pairs where Co is even
  const bool pairs = (p.cout & 1) == 0;
  wgmma_conv_block<WG, MT, KC, BN, TRANS, 0>(
      p, &tmx, &tmw, t, [&](__nv_bfloat16* yr, int co, float v0, float v1) {
        if (co >= p.cout) return;
        if (co + 1 < p.cout && pairs) {
          *reinterpret_cast<__nv_bfloat162*>(yr + co) = __floats2bfloat162_rn(v0, v1);
        } else {
          yr[co] = __float2bfloat16_rn(v0);
          if (co + 1 < p.cout) yr[co + 1] = __float2bfloat16_rn(v1);
        }
      });
}

// ---------------------------------------------------------------- host

size_t narrow_smem(const PsParams& p, int kc, int bn, bool trans) {
  const int b_rows = trans ? bn : kc, b_stride = trans ? kc + 8 : bn + 8;
  return 2 * ((size_t)p.slab_cap * (kc + 8) * 2 + (size_t)p.kw * b_rows * b_stride * 2);
}

using Kernel = void (*)(PsParams);
using WideKernel = void (*)(PsParams, CUtensorMap, CUtensorMap);

template <int KC, bool TRANS>
Kernel narrow_kernel(int bn) {
  switch (bn) {
    case 16: return &conv3d_persample_kernel<KC, 16, TRANS>;
    case 32: return &conv3d_persample_kernel<KC, 32, TRANS>;
    case 64: return &conv3d_persample_kernel<KC, 64, TRANS>;
    default: return nullptr;
  }
}

// The instances of conv3d_same.cu's wide kernel: BN 32 at 1, 2 or 4 m64
// tiles a warpgroup, BN 64 at 1 or 2, BN 128 at 1; KC = 64 up to BN = 64
// and 2 m64 tiles.
template <int WG, int MT, bool TRANS>
WideKernel wide_kernel(int kc, int bn) {
  if (MT == 4 && (bn != 32 || kc == 64)) return nullptr;
  if (MT != 1 && bn == 128) return nullptr;
  constexpr int M2 = MT == 4 ? 1 : MT;  // the BN = 64 and 128 instances MT names
  switch (kc * 1000 + bn) {
    case 16032: return &conv3d_persample_kernel_wgmma<WG, MT, 16, 32, TRANS>;
    case 32032: return &conv3d_persample_kernel_wgmma<WG, MT, 32, 32, TRANS>;
    case 64032: return &conv3d_persample_kernel_wgmma<WG, M2, 64, 32, TRANS>;
    case 16064: return &conv3d_persample_kernel_wgmma<WG, M2, 16, 64, TRANS>;
    case 32064: return &conv3d_persample_kernel_wgmma<WG, M2, 32, 64, TRANS>;
    case 64064: return &conv3d_persample_kernel_wgmma<WG, M2, 64, 64, TRANS>;
    case 16128: return &conv3d_persample_kernel_wgmma<WG, 1, 16, 128, TRANS>;
    case 32128: return &conv3d_persample_kernel_wgmma<WG, 1, 32, 128, TRANS>;
    default: return nullptr;
  }
}

template <bool TRANS>
WideKernel wide_kernel_of(int wgs, int mt, int kc, int bn) {
  if (wgs == 2) {
    return mt == 4 ? wide_kernel<2, 4, TRANS>(kc, bn)
         : mt == 2 ? wide_kernel<2, 2, TRANS>(kc, bn) : wide_kernel<2, 1, TRANS>(kc, bn);
  }
  return mt == 4 ? wide_kernel<1, 4, TRANS>(kc, bn)
       : mt == 2 ? wide_kernel<1, 2, TRANS>(kc, bn) : wide_kernel<1, 1, TRANS>(kc, bn);
}

// The planned launch: the narrow or the wide kernel (neither for a plan
// this source has no instance for), threads, dynamic shared bytes, grid.
struct Launch {
  Kernel kern;      // narrow instance
  WideKernel wide;  // wide instance
  int threads;
  size_t smem;
  dim3 grid;
  bool ok() const { return kern != nullptr || wide != nullptr; }
  const void* func() const {
    return kern != nullptr ? reinterpret_cast<const void*>(kern)
                           : reinterpret_cast<const void*>(wide);
  }
};

// instance: 0 narrow (mma.sync), 1 wide (wgmma, BM = 64 * warpgroups * m64
// tiles a warpgroup, the latter given as mt: 1, 2 or 4).
Launch plan_launch(PsParams& p, int n, int d, int h, int wl, int cin, int cout, int kd, int kh,
                   int kw, int wci, int wco, int transpose, int instance, int bm, int mt, int bn,
                   int kc, int stages) {
  Launch l{nullptr, nullptr, 0, 0, dim3(1)};
  const bool shapes_ok = transpose ? (wco == cin && wci >= cout) : (wci == cin && wco >= cout);
  if (kd % 2 == 0 || kh % 2 == 0 || kw % 2 == 0 || n <= 0 || d <= 0 || h <= 0 || wl <= 0 ||
      cin <= 0 || cin % 8 != 0 || cout <= 0 || wco % 8 != 0 || !shapes_ok || kc <= 0 ||
      bn <= 0) {
    return l;
  }
  p.n = n; p.d = d; p.h = h; p.w = wl; p.cin = cin; p.cout = cout;
  p.kd = kd; p.kh = kh; p.kw = kw;
  p.wci = wci; p.wco = wco;
  p.stages = stages;
  p.co_tiles = (cout + bn - 1) / bn;
  if (instance == 1) {
    const int wgs = bm / (64 * mt);
    if ((mt != 1 && mt != 2 && mt != 4) || (wgs != 1 && wgs != 2) || bm != 64 * wgs * mt ||
        stages < 3 || stages > 4) {
      return l;
    }
    if (!wgmma_conv_geometry(p, h, wl, kw, wgs, mt)) return l;
    l.wide = transpose ? wide_kernel_of<true>(wgs, mt, kc, bn)
                       : wide_kernel_of<false>(wgs, mt, kc, bn);
    l.threads = wgs * 128;
    l.smem = wgmma_conv_smem(p.slab_cap, kw, kc, bn, stages);
    l.grid = dim3((unsigned)((long long)n * d * p.tiles_per_plane * p.co_tiles));
  } else if (instance == 0) {
    if (bm != BM || mt != 1 || stages != 2 || (kc != 16 && kc != 32)) return l;
    if (wl >= BM) {
      p.tw = BM;
      p.rows_per_tile = 1;
      p.tiles_per_row = (wl + BM - 1) / BM;
      p.tiles_per_plane = h * p.tiles_per_row;
    } else {
      p.tw = wl;
      p.rows_per_tile = BM / wl;
      p.tiles_per_row = 1;
      p.tiles_per_plane = (h + p.rows_per_tile - 1) / p.rows_per_tile;
    }
    p.slab_cap = p.rows_per_tile * (p.tw + kw - 1);
    if (kc == 16) {
      l.kern = transpose ? narrow_kernel<16, true>(bn) : narrow_kernel<16, false>(bn);
    } else {
      l.kern = transpose ? narrow_kernel<32, true>(bn) : narrow_kernel<32, false>(bn);
    }
    l.threads = THREADS;
    l.smem = narrow_smem(p, kc, bn, transpose);
    l.grid = dim3((unsigned)((long long)n * d * p.tiles_per_plane), (unsigned)p.co_tiles);
  } else {
    return l;
  }
  if (l.smem > SMEM_MAX) l.kern = nullptr, l.wide = nullptr;
  return l;
}

// Tensor maps of the wide instance's TMA loads: x as (C, W, H, D, N) in
// boxes of 8 channels x pitch columns x rows; w, the forward's kernels in
// place, as (wco, wci, T, N) over their true extents (zeros past them), in
// boxes of KC x BN x kW (transposed: K-major, the KC*2-byte swizzle) or of
// min(BN, 64) x KC x kW (forward: MN-major, one swizzle atom a box).
bool encode_maps(const PsParams& p, const void* x, const void* w, int transpose, int kc, int bn,
                 CUtensorMap* tmx, CUtensorMap* tmw) {
  if (!encode_activation_map(tmx, x, p.n, p.d, p.h, p.w, p.cin, p.pitch, p.rows_per_tile)) {
    return false;
  }
  const int inner = transpose ? kc : (bn < 64 ? bn : 64);
  return encode_weight_map(tmw, w, p.n, p.kd * p.kh * p.kw, p.wci, p.wco, inner,
                           transpose ? bn : kc, p.kw);
}

}  // namespace

extern "C" {

// What a plan launches, into out[0..4]: dynamic shared bytes, grid x, grid
// y, registers a thread, local (spill) bytes a thread. The plan's arguments
// are those of conv3d_persample_bf16. Returns cudaErrorInvalidValue for a
// plan with no instance, else the cudaError_t of reading the kernel's
// attributes.
int conv3d_persample_plan(int n, int d, int h, int wl, int cin, int cout, int kd, int kh, int kw,
                          int wci, int wco, int transpose, int instance, int bm, int mt, int bn,
                          int kc, int stages, int* out) {
  PsParams p;
  const Launch l = plan_launch(p, n, d, h, wl, cin, cout, kd, kh, kw, wci, wco, transpose,
                               instance, bm, mt, bn, kc, stages);
  if (!l.ok()) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, l.func());
  out[0] = (int)l.smem;
  out[1] = (int)l.grid.x;
  out[2] = (int)l.grid.y;
  out[3] = err == cudaSuccess ? a.numRegs : -1;
  out[4] = err == cudaSuccess ? (int)a.localSizeBytes : -1;
  return (int)err;
}

// Launches the per-sample conv (transpose = 0, K2) or its transpose
// (transpose = 1, K3) as planned on `stream` and returns the cudaError_t of
// the launch (0 on success). x: (n, d, h, wl, cin) bf16; w: (n, kd, kh, kw,
// wci, wco) bf16, the forward's kernels in both cases; y: (n, d, h, wl,
// cout) bf16. instance: 0 narrow (mma.sync), 1 wide (wgmma). Does not
// synchronize and allocates nothing.
int conv3d_persample_bf16(const void* x, const void* w, void* y, int n, int d, int h, int wl,
                          int cin, int cout, int kd, int kh, int kw, int wci, int wco,
                          int transpose, int instance, int bm, int mt, int bn, int kc,
                          int stages, void* stream) {
  PsParams p;
  const Launch l = plan_launch(p, n, d, h, wl, cin, cout, kd, kh, kw, wci, wco, transpose,
                               instance, bm, mt, bn, kc, stages);
  if (!l.ok()) return (int)cudaErrorInvalidValue;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.wt = static_cast<const __nv_bfloat16*>(w);
  p.y = static_cast<__nv_bfloat16*>(y);
  cudaError_t err =
      cudaFuncSetAttribute(l.func(), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (l.kern != nullptr) {
    l.kern<<<l.grid, l.threads, l.smem, s>>>(p);
    return (int)cudaGetLastError();
  }
  CUtensorMap tmx, tmw;
  if (!encode_maps(p, x, w, transpose, kc, bn, &tmx, &tmw)) {
    return (int)cudaErrorInvalidValue;
  }
  l.wide<<<l.grid, l.threads, l.smem, s>>>(p, tmx, tmw);
  return (int)cudaGetLastError();
}

const char* conv3d_persample_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
