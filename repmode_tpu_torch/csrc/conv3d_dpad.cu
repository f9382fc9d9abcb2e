// Chainable 'same' 3-D convolution on depth-padded tensors, fused bias(+ReLU),
// for Hopper (sm_90a).
//
// Replaces the TPU kernel repmode_tpu/ops/pallas/conv3d.py:pallas_conv3d_dpad
// (body _dpad_kernel). Inside the space-to-depth (s2d) levels of the serving
// net the activations stay depth-padded in device memory: a tensor of native
// depth D is stored as (N, Dp = D + kD - 1, H, W, C) with pd = (kD-1)/2 zero
// rows at each depth edge. This kernel computes
//
//     y[n,dp,p,o] = act( sum_t sum_i x[n, dp + dz - pd, p + (dy,dx) - 1, i] * w[t, i, o] + b[o] )
//
// for the interior rows pd <= dp < Dp - pd, and writes exact zeros to the
// halo rows dp < pd and dp >= Dp - pd, so its output is the next conv's
// input as it stands (conv1 -> conv2 of a level, with no pad or slice pass
// between them). Taps are (kD, 3, 3) with kD in {3, 5}; x and w are bf16,
// products are summed in fp32, bias and ReLU run in fp32, the output is bf16.
// No padded or repacked copy of x or w is written.
//
// What bounds it: at the s2d shapes (Ci, Co = 128..512, 32x64x64 and
// 16x32x32 positions per sample) a conv does 2*45*Ci*Co operations per
// output position against ~2*(Ci+Co) bytes moved, far above the card's ~295
// operations per byte: it is bound by tensor-core operations. The seven
// convs of a batch of 8 patches cost 9.66 TFLOP, at least 9.77 ms at 989
// TFLOP/s.
//
// Both instances are one implicit GEMM: M = a tile of output positions
// inside one (n, dp) plane, N = a tile of output channels, K = taps x Ci,
// walked as (dz, dy, Ci chunk) stages. Per stage one input slab (the tile's
// rows shifted by dy, widened by the two halo columns) and the three tap
// matrices of that (dz, dy) go to shared memory; the three dx taps read the
// same slab at addresses shifted by dx positions. The depth halo is
// physical: an interior row reads input rows dp-pd .. dp+pd, which all
// exist, so every interior block runs all kD*3 (dz, dy) stages. A block of a
// halo row writes zeros for its tile with 16-byte stores and returns before
// it touches a barrier. No atomics: every output is written once, so results
// are bit-reproducible. The host's plan (ops/conv3d.py, conv3d_dpad_plan)
// picks the instance and its tiles.
//
// wide instance (planes of 128 positions or more: every s2d shape of the
// net): hopper.cuh's warpgroup-MMA conv block (wgmma_conv_block), the one
// conv3d_persample.cu's forward runs, with the weights shared by every
// sample. wgmma.mma_async.m64n128k16 with both operands in shared memory; 1
// or 2 warpgroups of one m64 tile each, BN = 128, KC = 32; loads by the
// tensor memory accelerator (TMA) from one thread onto an mbarrier a buffer
// of a 3-4 stage ring, filled S-2 stages ahead.
//   * A: the slab of x, one TMA box (rows x pitch positions x 8 channels) per
//     channel chunk, zero past the H and W edges (the depth rows dp-pd ..
//     dp+pd of an interior row all exist, so every block runs all kD*3
//     stages); an m64 tile is a 64-position row segment where W >= 64, else
//     8 rows x 8 columns.
//   * B: w read in place as (Co, Ci, T, 1) through a tensor map. Co is
//     contiguous, so B is MN-major and read with wgmma's transpose-B
//     immediate: two boxes of 64 Co x KC x 3 taps a stage, one 128-byte
//     swizzle atom each.
//   * The grid is 1-D with the Co tile fastest: neighbouring blocks share a
//     slab of x, and w (at most 11.8 MB) stays in L2 whole. It was 2-3 %
//     faster over the s2d level 2, the only convs with two Co tiles, than
//     the Co tile slowest.
//   * The epilogue adds the bias and applies the ReLU in fp32.
//
// narrow instance (planes under 128 positions; no s2d shape of the net, the
// small test shapes): the bf16 mma.sync.m16n8k16 kernel of the first port.
// BM = 128 positions (whole rows when W < 128), BN = 128, KC = 32, 8 warps
// as 4 (32 positions) x 2 (64 channels), two stage buffers filled by
// per-thread zero-filling cp.async, A and B by ldmatrix, at most 128
// registers a thread (two blocks an SM).
//
// Ci and Co must be multiples of 128 (every s2d level of the net: 4x the
// native width of 32 or 64); the wrapper refuses other geometry. A producer
// warp and a persistent schedule are left for later work.

#include "hopper.cuh"  // mma.sync, wgmma, mbarrier and TMA helpers

namespace {

constexpr int BM = 128;      // narrow instance: output positions per block
constexpr int BN = 128;      // both instances: output channels per block
constexpr int KC = 32;       // both instances: input channels per stage
constexpr int THREADS = 256; // narrow instance: 8 warps, 4 along M (32 rows each) x 2 along N
constexpr int KH = 3, KW = 3;
constexpr int SMEM_MAX = 227 * 1024;

// The names wgmma_conv_block reads (hopper.cuh): d is the padded depth Dp,
// cin and cout the channels; kh and kw are constants, so that the block's
// stage and tap arithmetic folds.
struct DpadParams {
  const __nv_bfloat16* x;  // (N, Dp, H, W, Ci)
  const __nv_bfloat16* wt; // (kD*3*3, Ci, Co)
  const float* bias;       // (Co) or nullptr
  __nv_bfloat16* y;        // (N, Dp, H, W, Co)
  int n, d, h, w, cin, cout;
  int kd;
  static constexpr int kh = KH, kw = KW;
  int tw;               // columns per tile
  int rows_per_tile;    // rows per tile
  int tiles_per_row;    // ceil(W / tw)
  int tiles_per_plane;
  int slab_cap;         // slab positions per stage buffer
  int relu;
  int stages;           // wide instance: ring depth
  int pitch;            // wide instance: slab positions a tile row (tw + 2)
  int patch;            // wide instance: m64 tiles of 8 x 8 positions (1) or of one row (0)
  int co_tiles;         // output-channel tiles
};

// The tile of position-tile block `bx` (its Co tile aside): sample, padded
// depth row, first row and column, rows and columns inside the volume.
__device__ __forceinline__ ConvTile tile_of(const DpadParams& p, int bx) {
  ConvTile t;
  const int pos = bx % p.tiles_per_plane;
  bx /= p.tiles_per_plane;
  t.dd = bx % p.d;
  t.nn = bx / p.d;
  t.h0 = (pos / p.tiles_per_row) * p.rows_per_tile;
  t.w0 = (pos % p.tiles_per_row) * p.tw;
  t.rows = min(p.rows_per_tile, p.h - t.h0);
  t.twv = min(p.tw, p.w - t.w0);
  t.wn = 0;  // the weights every sample shares
  return t;
}

__device__ __forceinline__ bool halo_row(const DpadParams& p, int dd) {
  const int pd = (p.kd - 1) / 2;
  return dd < pd || dd >= p.d - pd;
}

// A halo row's block: zeros for its tile's positions and BN channels.
__device__ __forceinline__ void zero_tile(const DpadParams& p, const ConvTile& t) {
  constexpr int WSEGS = BN / 8;  // 16-byte segments per position
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < t.rows * t.twv * WSEGS; i += blockDim.x) {
    const int pos = i / WSEGS, sg = i - (i / WSEGS) * WSEGS;
    const int r = pos / t.twv, c = pos - (pos / t.twv) * t.twv;
    const long long o =
        ((((long long)t.nn * p.d + t.dd) * p.h + t.h0 + r) * p.w + t.w0 + c) * p.cout;
    *reinterpret_cast<uint4*>(p.y + o + t.co0 + sg * 8) = zero;
  }
}

// ---------------------------------------------------------------- narrow instance

// Two blocks per SM: registers capped at 128.
__global__ void __launch_bounds__(THREADS, 2)
conv3d_dpad_kernel(const DpadParams p) {
  constexpr int A_STRIDE = KC + 8;  // bf16 per slab position (pad: no bank conflicts)
  constexpr int B_STRIDE = BN + 8;  // bf16 per weight row
  constexpr int WN = BN / 2;        // output channels per warp
  constexpr int NT = WN / 8;        // n8 tiles per warp
  constexpr int SEGS = KC / 8;      // 16-byte segments per slab position
  constexpr int WSEGS = BN / 8;     // 16-byte segments per weight row

  extern __shared__ __align__(16) unsigned char smem[];
  const int slab_elems = p.slab_cap * A_STRIDE;
  const int buf_elems = slab_elems + KW * KC * B_STRIDE;
  __nv_bfloat16* base = reinterpret_cast<__nv_bfloat16*>(smem);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp & 3;
  const int warp_n = warp >> 2;

  ConvTile tl = tile_of(p, blockIdx.x);
  tl.co0 = blockIdx.y * BN;
  const int nn = tl.nn, dd = tl.dd, h0 = tl.h0, w0 = tl.w0, rows = tl.rows, twv = tl.twv;
  const int cols = twv + KW - 1;
  const int npos = rows * cols;
  const int co0 = tl.co0;
  const int pd = (p.kd - 1) / 2;

  if (halo_row(p, dd)) {
    zero_tile(p, tl);
    return;
  }

  const int nchunks = p.cin / KC;
  const int num_stages = p.kd * KH * nchunks;

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
    const int dy = rest % KH;
    const int dz = rest / KH;
    const int di = dd + dz - pd;  // in [0, Dp): the depth halo is physical
    const int ci0 = chunk * KC;
    __nv_bfloat16* slab = base + buf * buf_elems;
    __nv_bfloat16* wsm = slab + slab_elems;
    const long long plane = ((long long)nn * p.d + di) * p.h;

    for (int i = tid; i < npos * SEGS; i += THREADS) {
      const int pos = i / SEGS, sg = i - (i / SEGS) * SEGS;
      const int r = pos / cols, c = pos - (pos / cols) * cols;
      const int hi = h0 + r + dy - 1, wi = w0 + c - 1;
      const bool ok = hi >= 0 && hi < p.h && wi >= 0 && wi < p.w;
      const __nv_bfloat16* src = ok ? p.x + ((plane + hi) * p.w + wi) * p.cin + ci0 + sg * 8 : p.x;
      cp_async16(smem_u32(slab + pos * A_STRIDE + sg * 8), src, ok ? 16 : 0);
    }

    const int tap0 = (dz * KH + dy) * KW;
    for (int i = tid; i < KW * KC * WSEGS; i += THREADS) {
      const int row = i / WSEGS, sg = i - (i / WSEGS) * WSEGS;
      const int dx = row / KC, k = row - (row / KC) * KC;
      const __nv_bfloat16* src =
          p.wt + ((long long)(tap0 + dx) * p.cin + ci0 + k) * p.cout + co0 + sg * 8;
      cp_async16(smem_u32(wsm + row * B_STRIDE + sg * 8), src, 16);
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0.0f;

  load_stage(0, 0);
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
#pragma unroll
    for (int dx = 0; dx < KW; ++dx) {
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
          const int off = (dx * KC + kk * 16 + (lane & 15)) * B_STRIDE + warp_n * WN + j * 8;
          ldmatrix_x2_trans(w_addr + off * 2, b);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_bf16_16816(acc[mt][j], a[mt], b);
        }
      }
    }
    __syncthreads();
  }

  // ---- epilogue: bias (+ReLU) in fp32, then bf16 pairs ----
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
        const int co = co0 + warp_n * WN + j * 8 + (lane & 3) * 2;
        float v0 = acc[mt][j][half * 2];
        float v1 = acc[mt][j][half * 2 + 1];
        if (p.bias != nullptr) {
          v0 += p.bias[co];
          v1 += p.bias[co + 1];
        }
        if (p.relu) {
          v0 = fmaxf(v0, 0.0f);
          v1 = fmaxf(v1, 0.0f);
        }
        *reinterpret_cast<__nv_bfloat162*>(p.y + out_base + co) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// ---------------------------------------------------------------- warpgroup MMA

// WG warpgroups of one m64 tile each (BM = 64 * WG output positions).
template <int WG>
__global__ void __launch_bounds__(WG * 128, WG == 2 ? 2 : 4)
conv3d_dpad_kernel_wgmma(const DpadParams p, const __grid_constant__ CUtensorMap tmx,
                         const __grid_constant__ CUtensorMap tmw) {
  // ---- which tile this block computes: the Co tile fastest ----
  ConvTile t = tile_of(p, blockIdx.x / p.co_tiles);
  t.co0 = (blockIdx.x % p.co_tiles) * BN;

  // A halo row: zeros, and return before any barrier is set up or any copy
  // starts (the test is uniform over the block).
  if (halo_row(p, t.dd)) {
    zero_tile(p, t);
    return;
  }

  // bias (+ReLU) in fp32, then bf16 pairs
  wgmma_conv_block<WG, 1, KC, BN, false, KW>(
      p, &tmx, &tmw, t, [&](__nv_bfloat16* yr, int co, float v0, float v1) {
        if (p.bias != nullptr) {
          v0 += p.bias[co];
          v1 += p.bias[co + 1];
        }
        if (p.relu) {
          v0 = fmaxf(v0, 0.0f);
          v1 = fmaxf(v1, 0.0f);
        }
        *reinterpret_cast<__nv_bfloat162*>(yr + co) = __floats2bfloat162_rn(v0, v1);
      });
}

// ---------------------------------------------------------------- host

using Kernel = void (*)(DpadParams);
using WideKernel = void (*)(DpadParams, CUtensorMap, CUtensorMap);

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

// instance: 0 narrow (mma.sync: bm 128, mt 1, bn 128, kc 32, 2 stages, a
// 2-D grid with the Co tile on y), 1 wide (wgmma: bm = 64 x warpgroups, mt
// 1, bn 128, kc 32, 3-4 stages, a 1-D grid with the Co tile fastest).
Launch plan_launch(DpadParams& p, int n, int dp, int h, int wl, int ci, int co, int kd,
                   int instance, int bm, int mt, int bn, int kc, int stages) {
  Launch l{nullptr, nullptr, 0, 0, dim3(1)};
  if ((kd != 3 && kd != 5) || n <= 0 || dp <= kd - 1 || h <= 0 || wl <= 0 || ci <= 0 ||
      ci % 128 != 0 || co <= 0 || co % 128 != 0 || mt != 1 || bn != BN || kc != KC) {
    return l;
  }
  p.n = n; p.d = dp; p.h = h; p.w = wl; p.cin = ci; p.cout = co;
  p.kd = kd;
  p.stages = stages;
  p.co_tiles = co / bn;
  if (instance == 1) {
    const int wgs = bm / 64;
    if ((wgs != 1 && wgs != 2) || bm != 64 * wgs || stages < 3 || stages > 4 ||
        !wgmma_conv_geometry(p, h, wl, KW, wgs, 1)) {
      return l;
    }
    l.wide = wgs == 2 ? &conv3d_dpad_kernel_wgmma<2> : &conv3d_dpad_kernel_wgmma<1>;
    l.threads = wgs * 128;
    l.smem = wgmma_conv_smem(p.slab_cap, KW, kc, bn, stages);
    l.grid = dim3((unsigned)((long long)n * dp * p.tiles_per_plane * p.co_tiles));
  } else if (instance == 0) {
    if (bm != BM || stages != 2) return l;
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
    p.slab_cap = p.rows_per_tile * (p.tw + KW - 1);
    l.kern = &conv3d_dpad_kernel;
    l.threads = THREADS;
    l.smem = 2 * ((size_t)p.slab_cap * (KC + 8) * 2 + (size_t)KW * KC * (BN + 8) * 2);
    l.grid = dim3((unsigned)((long long)n * dp * p.tiles_per_plane), (unsigned)p.co_tiles);
  } else {
    return l;
  }
  if (l.smem > SMEM_MAX) l.kern = nullptr, l.wide = nullptr;
  return l;
}

}  // namespace

extern "C" {

// What a plan launches, into out[0..4]: dynamic shared bytes, grid x, grid
// y, registers a thread, local (spill) bytes a thread. The plan's arguments
// are those of conv3d_dpad_bf16. Returns cudaErrorInvalidValue for a plan
// with no instance, else the cudaError_t of reading the kernel's attributes.
int conv3d_dpad_plan(int n, int dp, int h, int wl, int ci, int co, int kd, int instance, int bm,
                     int mt, int bn, int kc, int stages, int* out) {
  DpadParams p;
  const Launch l = plan_launch(p, n, dp, h, wl, ci, co, kd, instance, bm, mt, bn, kc, stages);
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

// Launches the planned instance on `stream` and returns the cudaError_t of
// the launch (0 on success). x: (n, dp, h, wl, ci) bf16; w: (kd, 3, 3, ci,
// co) bf16, read in place by both instances; bias: (co) fp32 or null; y:
// (n, dp, h, wl, co) bf16. instance: 0 narrow (mma.sync), 1 wide (wgmma).
// Does not synchronize and allocates nothing.
int conv3d_dpad_bf16(const void* x, const void* w, const void* bias, void* y, int n, int dp,
                     int h, int wl, int ci, int co, int kd, int instance, int bm, int mt, int bn,
                     int kc, int stages, int relu, void* stream) {
  DpadParams p;
  const Launch l = plan_launch(p, n, dp, h, wl, ci, co, kd, instance, bm, mt, bn, kc, stages);
  if (!l.ok()) return (int)cudaErrorInvalidValue;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.wt = static_cast<const __nv_bfloat16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.relu = relu;
  cudaError_t err =
      cudaFuncSetAttribute(l.func(), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (l.kern != nullptr) {
    l.kern<<<l.grid, l.threads, l.smem, s>>>(p);
    return (int)cudaGetLastError();
  }
  // x as (Ci, W, H, Dp, N) in boxes of 8 channels x pitch columns x rows;
  // w in place as (Co, Ci, T, 1) in boxes of 64 x KC x 3 taps
  CUtensorMap tmx, tmw;
  if (!encode_activation_map(&tmx, x, n, dp, h, wl, ci, p.pitch, p.rows_per_tile) ||
      !encode_weight_map(&tmw, w, 1, kd * KH * KW, ci, co, 64, KC, KW)) {
    return (int)cudaErrorInvalidValue;
  }
  l.wide<<<l.grid, l.threads, l.smem, s>>>(p, tmx, tmw);
  return (int)cudaGetLastError();
}

const char* conv3d_dpad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
