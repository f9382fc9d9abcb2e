// Per-sample 'same' 3-D convolution of a 4-lane input as one K=180 GEMM per
// tile, for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/bench_enc1c1_kernel.py: make_kernel.conv
// (body _kernel), the tap-concat conv:
//
//     y[n, p, o] = sum_k P[n, p, k] * w[n, k, o],   k = tap * 4 + lane
//
// where P[n, p, :] concatenates the 45 shifted 4-lane slices of x around
// position p (taps (dz, dy, dx) over (5, 3, 3), lexicographic, 'same' zero
// padding). This is the space-to-depth (s2d) entry conv of training,
// encoder_block1.conv1: the 1-channel volume is 4 s2d lanes, and w is the
// sample's gate-merged s2d expert bank reshaped to (180, Co). x is NDHWC bf16
// (N, D, H, W, 4), w bf16 (N, 180, wco) with wco >= Co a multiple of 8, y bf16
// (N, D, H, W, Co), products summed in fp32.
//
// What bounds it: 2*180*Co operations per position against 8 bytes read and
// 2*Co written, about 180 operations per byte, below the card's ~295: the
// kernel is bound by the bytes of its output (268 MB at batch 8 of 32x128x128
// patches, Co = 128). A per-tap conv (K2 on 4 channels) would feed the tensor
// cores a contraction of 4 (packed to 16) per step; here the contraction is
// the whole 180 at once, and the patch matrix never leaves shared memory (the
// TPU measured materializing it in device memory as a loss). The design:
//
//   * a block owns one sample, a 128-wide slice of Co, and TILES_PER_BLOCK
//     consecutive tiles of BM = 128 output positions (whole rows when W < 128)
//     of that sample; the sample's (180 x 128) weight slice is copied to
//     shared memory once (rows 180..191 zero-filled, K padded to 192) and
//     stays there for all of the block's tiles;
//   * per tile, cp.async copies the halo slab, 5 x (rows+2) x (cols+2)
//     positions of 4 lanes (8 bytes each), with zero-filled copies for the
//     depth, H and W halos: no padded copy of x exists anywhere;
//   * the block builds the tile's (128 x 192) patch matrix in shared memory
//     from the slab, 8 bytes per (position, tap), then runs 12 k-steps of bf16
//     mma.sync.m16n8k16 with fp32 accumulators (8 warps, 32 x 64 each); the
//     next tile's slab is loaded while the current tile is multiplied;
//   * each output is written once, as bf16 pairs, with no atomics.
//
// A first version that is right: wgmma, TMA and a persistent schedule are left
// for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CI = 4;              // input lanes
constexpr int KD = 5, KH = 3, KW = 3;
constexpr int TAPS = KD * KH * KW; // 45
constexpr int K = TAPS * CI;       // 180
constexpr int KP = 192;            // K padded to a multiple of 16
constexpr int TAP_SLOTS = KP / CI; // 48 (45 taps + 3 zero slots)
constexpr int BM = 128;            // output positions per tile
constexpr int BN = 128;            // output channels per block
constexpr int THREADS = 256;       // 8 warps: 4 along M (32 rows) x 2 along N (64 cols)
constexpr int WN = BN / 2;
constexpr int NT = WN / 8;         // n8 tiles per warp
constexpr int P_STRIDE = KP + 8;   // bf16 per patch row (pad: no bank conflicts)
constexpr int W_STRIDE = BN + 8;   // bf16 per weight row
constexpr int TILES_PER_BLOCK = 4;

struct TcParams {
  const __nv_bfloat16* x;  // (N, D, H, W, 4)
  const __nv_bfloat16* w;  // (N, 180, wco)
  __nv_bfloat16* y;        // (N, D, H, W, cout)
  int n, d, h, w_len, cout, wco;
  int tw;               // columns per tile (BM when W >= BM, else W)
  int rows_per_tile;    // 1 when W >= BM, else BM / W
  int tiles_per_row;    // ceil(W / BM) when W >= BM, else 1
  int tiles_per_plane;
  int tiles_per_sample;
  int blocks_per_sample;
  int srows, scols;     // slab rows and columns: rows_per_tile + 2, tw + 2
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit_and_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t addr, uint32_t (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct Tile {
  int dd, h0, w0, rows, twv;
};

__device__ __forceinline__ Tile tile_of(const TcParams& p, int tt) {
  Tile t;
  const int tp = tt % p.tiles_per_plane;
  t.dd = tt / p.tiles_per_plane;
  t.h0 = (tp / p.tiles_per_row) * p.rows_per_tile;
  t.w0 = (tp % p.tiles_per_row) * p.tw;
  t.rows = min(p.rows_per_tile, p.h - t.h0);
  t.twv = min(p.tw, p.w_len - t.w0);
  return t;
}

// The halo slab of one tile: positions (dz, r, c) of the tile's rows
// h0-1 .. h0+rows_per_tile and columns w0-1 .. w0+tw around depth dd-2 ..
// dd+2, 8 bytes each; positions outside the volume are zero-filled copies.
__device__ __forceinline__ void load_slab(const TcParams& p, int nn, const Tile& t,
                                          __nv_bfloat16* slab) {
  const int per_dz = p.srows * p.scols;
  for (int i = threadIdx.x; i < KD * per_dz; i += THREADS) {
    const int dz = i / per_dz;
    const int rc = i - dz * per_dz;
    const int r = rc / p.scols, c = rc - (rc / p.scols) * p.scols;
    const int di = t.dd + dz - KD / 2, hi = t.h0 + r - KH / 2, wi = t.w0 + c - KW / 2;
    const bool ok = di >= 0 && di < p.d && hi >= 0 && hi < p.h && wi >= 0 && wi < p.w_len;
    const __nv_bfloat16* src =
        ok ? p.x + ((((long long)nn * p.d + di) * p.h + hi) * p.w_len + wi) * CI : p.x;
    cp_async8(smem_u32(slab + i * CI), src, ok ? 8 : 0);
  }
}

__global__ void __launch_bounds__(THREADS, 2) conv3d_tapconcat_kernel(const TcParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* patch = reinterpret_cast<__nv_bfloat16*>(smem);  // BM x P_STRIDE
  __nv_bfloat16* wsm = patch + BM * P_STRIDE;                      // KP x W_STRIDE
  __nv_bfloat16* slab = wsm + KP * W_STRIDE;                       // KD*srows*scols x 4

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp & 3;
  const int warp_n = warp >> 2;

  const int nn = blockIdx.x / p.blocks_per_sample;
  const int first = (blockIdx.x % p.blocks_per_sample) * TILES_PER_BLOCK;
  const int last = min(first + TILES_PER_BLOCK, p.tiles_per_sample);
  const int co0 = blockIdx.y * BN;
  if (first >= last) return;

  // the sample's weight slice, resident for all of the block's tiles
  const __nv_bfloat16* wsample = p.w + (long long)nn * K * p.wco;
  for (int i = tid; i < KP * (BN / 8); i += THREADS) {
    const int row = i / (BN / 8), sg = i - (i / (BN / 8)) * (BN / 8);
    const int o = co0 + sg * 8;
    const bool ok = row < K && o < p.wco;
    const __nv_bfloat16* src = ok ? wsample + (long long)row * p.wco + o : p.w;
    cp_async16(smem_u32(wsm + row * W_STRIDE + sg * 8), src, ok ? 16 : 0);
  }
  Tile t = tile_of(p, first);
  load_slab(p, nn, t, slab);
  cp_async_commit();

  for (int tt = first; tt < last; ++tt) {
    // this tile's slab (and, the first time, the weights) has arrived, and
    // every warp is done reading the previous tile's patch matrix
    cp_async_commit_and_wait_all();
    __syncthreads();

    // patch matrix: row m = output position (r, c) of the tile, column
    // slot*4 + lane = tap slot's lane; rows past the tile and slots 45..47 are 0
    for (int i = tid; i < BM * TAP_SLOTS; i += THREADS) {
      const int m = i / TAP_SLOTS, tap = i - (i / TAP_SLOTS) * TAP_SLOTS;
      const int r = m / t.twv, c = m - (m / t.twv) * t.twv;
      uint2 v = make_uint2(0u, 0u);
      if (r < t.rows && tap < TAPS) {
        const int dz = tap / (KH * KW), dy = (tap / KW) % KH, dx = tap % KW;
        v = *reinterpret_cast<const uint2*>(
            slab + ((dz * p.srows + r + dy) * p.scols + c + dx) * CI);
      }
      *reinterpret_cast<uint2*>(patch + m * P_STRIDE + tap * CI) = v;
    }
    __syncthreads();

    // the next tile's slab streams in while this tile is multiplied
    const Tile cur = t;
    if (tt + 1 < last) {
      t = tile_of(p, tt + 1);
      load_slab(p, nn, t, slab);
    }
    cp_async_commit();

    float acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0.0f;

    const uint32_t p_addr = smem_u32(patch);
    const uint32_t w_addr = smem_u32(wsm);
#pragma unroll
    for (int kk = 0; kk < KP / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int row = warp_m * 32 + mt * 16 + (lane & 15);
        ldmatrix_x4(p_addr + (row * P_STRIDE + kk * 16 + (lane >> 4) * 8) * 2, a[mt]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t b[2];
        const int off = (kk * 16 + (lane & 15)) * W_STRIDE + warp_n * WN + j * 8;
        ldmatrix_x2_trans(w_addr + off * 2, b);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16_16816(acc[mt][j], a[mt], b);
      }
    }

    // epilogue: round to bf16 and store, two channels per store
    const bool pairs = (p.cout & 1) == 0;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = warp_m * 32 + mt * 16 + (lane >> 2) + half * 8;
        const int r = m / cur.twv, c = m - (m / cur.twv) * cur.twv;
        if (r >= cur.rows) continue;
        __nv_bfloat16* out = p.y + ((((long long)nn * p.d + cur.dd) * p.h + cur.h0 + r) *
                                        p.w_len + cur.w0 + c) * p.cout;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int co = co0 + warp_n * WN + j * 8 + (lane & 3) * 2;
          const float v0 = acc[mt][j][half * 2], v1 = acc[mt][j][half * 2 + 1];
          if (pairs && co + 1 < p.cout) {
            *reinterpret_cast<__nv_bfloat162*>(out + co) = __floats2bfloat162_rn(v0, v1);
          } else {
            if (co < p.cout) out[co] = __float2bfloat16_rn(v0);
            if (co + 1 < p.cout) out[co + 1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches the tap-concat conv on `stream` and returns the cudaError_t of the
// launch (0 on success). x: (n, d, h, wl, 4) bf16; w: (n, 180, wco) bf16 with
// wco a multiple of 8 and >= cout, rows tap-major (taps (5, 3, 3)) x 4 lanes;
// y: (n, d, h, wl, cout) bf16. Does not synchronize and allocates nothing.
int conv3d_tapconcat_bf16(const void* x, const void* w, void* y, int n, int d, int h, int wl,
                          int cout, int wco, void* stream) {
  if (n <= 0 || d <= 0 || h <= 0 || wl <= 0 || cout <= 0 || wco < cout || wco % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  TcParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.n = n; p.d = d; p.h = h; p.w_len = wl; p.cout = cout; p.wco = wco;
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
  p.tiles_per_sample = d * p.tiles_per_plane;
  p.blocks_per_sample = (p.tiles_per_sample + TILES_PER_BLOCK - 1) / TILES_PER_BLOCK;
  p.srows = p.rows_per_tile + KH - 1;
  p.scols = p.tw + KW - 1;
  const size_t smem = (size_t)BM * P_STRIDE * 2 + (size_t)KP * W_STRIDE * 2 +
                      (size_t)KD * p.srows * p.scols * CI * 2;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      conv3d_tapconcat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((long long)n * p.blocks_per_sample), (unsigned)((cout + BN - 1) / BN));
  conv3d_tapconcat_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

const char* conv3d_tapconcat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
