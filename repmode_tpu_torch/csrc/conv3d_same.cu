// 'same' 3-D convolution with a fused bias(+ReLU) epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel repmode_tpu/ops/pallas/conv3d.py:pallas_conv3d_same
// (bodies _conv_kernel and _conv_bias_relu_kernel). It computes
//
//     y[n,p,o] = act( sum_t sum_i x[n, p + t - c, i] * w[t, i, o] + b[o] )
//
// with zero 'same' padding, any odd (kD, kH, kW), NDHWC activations and DHWIO
// weights (zero-padded by the caller to whole Ci chunks and Co tiles). x and
// w are bf16, products are summed in fp32, the epilogue (none / bias /
// bias+ReLU) runs in fp32 and the output is fp32 or bf16.
//
// What bounds it: at the serving shapes a conv does ~2*125*Ci*Co operations
// per output voxel and moves tens of MB, far above the card's ~295
// operations per byte, so its bound is tensor-core operations. The 19
// convs of the serving net cost 1.086 TFLOP per 32x128x128 patch; a batch of
// 8 patches is 8.7 TFLOP, at least 8.8 ms at the H100's 989 TFLOP/s dense
// bf16. Only the first conv (Ci=1) and conv_out (Co=1) are bound by bytes.
//
// Both instances are one implicit GEMM: M = a tile of output positions
// inside one (n, d) plane, N = a tile of output channels, K = taps x Ci,
// walked as (dz, dy, Ci chunk) stages. Per stage one input slab (the tile's
// rows shifted by dy, widened by the kW-1 column halo) and the kW tap
// matrices of that (dz, dy) are copied to shared memory; all kW taps along W
// read the same slab at addresses shifted by dx positions, so the input is
// read from L2 kD*kH times, not kD*kH*kW times. Halos are zero-filled by the
// copies: no padded copy of the input exists. Depth taps that fall outside
// the volume are skipped. No atomics: every output is written once, so
// results are bit-reproducible. The host's plan (ops/conv3d.py,
// conv3d_same_plan) picks the instance and its tiles.
//
// wide instance (packed Ci >= 16, Co >= 32, planes of 128 positions or
// more): warpgroup MMA, wgmma.mma_async.m64n{BN}k16 with both operands in
// shared memory. A block is 1 or 2 warpgroups of 1, 2 or 4 m64 tiles (BM =
// 64 to 512 positions), BN = 32, 64 or 128 channels.
//   * Loads: one thread issues each stage's copies to the tensor memory
//     accelerator (TMA), which computes the addresses, fills the halos and
//     the channels past Ci with zeros and signals an mbarrier a ring
//     buffer: one box (rows x pitch positions x 8 channels) per channel
//     chunk of x, one box of kW x BN x KC weights.
//   * A: the slab is chunk-major, 16 bytes a (8-channel chunk, position), so
//     8 consecutive positions of a chunk are one 128-byte core matrix of the
//     no-swizzle K-major layout (exactly what a box of 8 channels writes). An
//     m64 tile is 64 positions of one row (core matrices 128 bytes apart)
//     where W >= 64, or 8 rows x 8 columns (core matrices one slab row
//     apart) where W < 64; either way tap dx is the same descriptor started
//     dx positions later.
//   * B: the weights are K-major (taps, co_pad, ci_pad) in memory; the copy
//     writes them in the canonical swizzled layout of wgmma (32-, 64- or
//     128-byte swizzle for KC = 16, 32, 64) at a 1024-byte aligned base.
//   * Each stage is one commit group of kW * KC/16 * (m64 tiles) wgmmas per
//     warpgroup; a warpgroup waits for the previous stage's group only, so
//     the products of one stage overlap the barrier and loads of the next.
//     The ring of 3-4 stages is filled 2 stages ahead of use, so a buffer is
//     refilled only after every warpgroup retired its group.
//   What bounds it is not measured (no profiler counters on the card's
//   machine). Per-stage work is what the rates track: loads by TMA in place
//   of per-thread cp.async loops, and wider stages (KC 64, BM up to 512),
//   each bought time, where fewer shared-memory bytes per product did not.
//
// narrow instance (the packed 1-channel input conv, conv_out, the 2x8x8
// bottleneck, small test shapes): the bf16 mma.sync.m16n8k16 kernel of the
// first port, 8 warps as 4 (32 positions) x 2 (BN/2 channels), BM = 128,
// two stage buffers filled by bounds-checked zero-filling cp.async, A and B
// by ldmatrix. Ci is a multiple of 8 (16-byte copies): the caller packs the
// kW taps of a narrow input into channels; Co=1 is served by zero weight
// columns. The first two are bound by bytes, which neither instance
// approaches yet.
//
// A producer warp and a persistent schedule are left for later work.

#include "hopper.cuh"  // mma.sync, wgmma, mbarrier and TMA helpers

namespace {

constexpr int BM = 128;      // narrow instance: output positions per block
constexpr int THREADS = 256; // narrow instance: 8 warps, 4 along M (32 rows each) x 2 along N
constexpr int SMEM_MAX = 227 * 1024;

struct ConvParams {
  const __nv_bfloat16* x;  // (N, D, H, W, Ci)
  const __nv_bfloat16* wt; // narrow: (T, ci_pad, co_pad); wide: (T, co_pad, ci_pad)
  const float* bias;       // (co_pad) or nullptr
  void* y;                 // (N, D, H, W, Co), fp32 or bf16
  int n, d, h, w, ci, co;
  int kd, kh, kw;
  int ci_pad, co_pad;
  int tw;               // columns per tile
  int rows_per_tile;    // rows per tile
  int tiles_per_row;    // ceil(W / tw)
  int tiles_per_plane;
  int slab_cap;         // slab positions per stage buffer
  int relu;
  int out_bf16;         // wide instance: bf16 (1) or fp32 (0) output
  int stages;           // wide instance: ring depth
  int pitch;            // wide instance: slab positions a tile row (tw + kw - 1)
  int patch;            // wide instance: m64 tiles of 8 x 8 positions (1) or of one row (0)
};

// ---------------------------------------------------------------- narrow instance

template <int KC, int BN, bool OUT_BF16>
__global__ void __launch_bounds__(THREADS)
conv3d_same_kernel(const ConvParams p) {
  constexpr int A_STRIDE = KC + 8;  // bf16 per slab position (pad: no bank conflicts)
  constexpr int B_STRIDE = BN + 8;  // bf16 per weight row
  constexpr int WN = BN / 2;        // output channels per warp
  constexpr int NT = WN / 8;        // n8 tiles per warp
  constexpr int SEGS = KC / 8;      // 16-byte segments per slab position
  constexpr int WSEGS = BN / 8;     // 16-byte segments per weight row

  extern __shared__ __align__(16) unsigned char smem[];
  const int slab_elems = p.slab_cap * A_STRIDE;
  const int buf_elems = slab_elems + p.kw * KC * B_STRIDE;
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

  const int pd = (p.kd - 1) / 2, ph = (p.kh - 1) / 2, pw = (p.kw - 1) / 2;
  const int dz_lo = max(0, pd - dd);
  const int dz_hi = min(p.kd, p.d - dd + pd);
  const int nchunks = p.ci_pad / KC;
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
      const bool ok = hi >= 0 && hi < p.h && wi >= 0 && wi < p.w && ci < p.ci;
      const __nv_bfloat16* src = ok ? p.x + ((plane + hi) * p.w + wi) * p.ci + ci : p.x;
      cp_async16(smem_u32(slab + pos * A_STRIDE + sg * 8), src, ok ? 16 : 0);
    }

    const int tap0 = (dz * p.kh + dy) * p.kw;
    for (int i = tid; i < p.kw * KC * WSEGS; i += THREADS) {
      const int row = i / WSEGS, sg = i - (i / WSEGS) * WSEGS;
      const int dx = row / KC, k = row - (row / KC) * KC;
      const __nv_bfloat16* src =
          p.wt + ((long long)(tap0 + dx) * p.ci_pad + ci0 + k) * p.co_pad + co0 + sg * 8;
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
          const int off = (dx * KC + kk * 16 + (lane & 15)) * B_STRIDE + warp_n * WN + j * 8;
          ldmatrix_x2_trans(w_addr + off * 2, b);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_bf16_16816(acc[mt][j], a[mt], b);
        }
      }
    }
    __syncthreads();
  }

  // ---- epilogue: bias (+ReLU) in fp32, then store ----
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = warp_m * 32 + mt * 16 + (lane >> 2) + half * 8;
      const int r = m / twv, c = m - (m / twv) * twv;
      if (r >= rows) continue;
      const long long out_base =
          ((((long long)nn * p.d + dd) * p.h + h0 + r) * p.w + w0 + c) * p.co;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = co0 + warp_n * WN + j * 8 + (lane & 3) * 2 + e;
          if (co >= p.co) continue;
          float v = acc[mt][j][half * 2 + e];
          if (p.bias != nullptr) v += p.bias[co];
          if (p.relu) v = fmaxf(v, 0.0f);
          if (OUT_BF16) {
            reinterpret_cast<__nv_bfloat16*>(p.y)[out_base + co] = __float2bfloat16_rn(v);
          } else {
            reinterpret_cast<float*>(p.y)[out_base + co] = v;
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------- warpgroup MMA

// WG consumer warpgroups of MT m64 tiles each (BM = 64 * WG * MT output
// positions), KC input channels a stage, BN output channels a block.
template <int WG, int MT, int KC, int BN>
__global__ void __launch_bounds__(WG * 128, WG == 2 ? 2 : 4)
conv3d_same_kernel_wgmma(const ConvParams p, const __grid_constant__ CUtensorMap tmx,
                         const __grid_constant__ CUtensorMap tmw) {
  constexpr int SEGS = KC / 8;               // 8-channel chunks a stage
  constexpr int RB = KC * 2;                 // bytes per weight row (one output channel)
  constexpr int KSTEPS = KC / 16;
  constexpr int NACC = BN / 2;
  constexpr uint64_t LAYOUT = KC == 64 ? 1 : (KC == 32 ? 2 : 3);
  constexpr uint32_t SBO_B = 8 * RB;

  extern __shared__ __align__(16) unsigned char smem[];
  // weight tiles first, at a 1024-byte boundary (the swizzle pattern is a
  // function of the address), then the slabs: chunk-major, 16 bytes a
  // (8-channel chunk, position), so 8 consecutive positions of a chunk are
  // one core matrix of A; a chunk starts 128-byte aligned, as a tensor
  // copy's destination must
  const uint32_t b_base = (smem_u32(smem) + SWIZZLE_ALIGN - 1) & ~(uint32_t)(SWIZZLE_ALIGN - 1);
  const uint32_t b_stage = (uint32_t)p.kw * BN * RB;
  const uint32_t a_chunk = ((uint32_t)p.slab_cap * 16 + 127) & ~127u;
  const uint32_t a_stage = a_chunk * SEGS;
  const uint32_t a_base = b_base + p.stages * b_stage;
  __shared__ __align__(8) uint64_t bar_mem[4];  // one mbarrier a ring buffer
  const uint32_t bars = smem_u32(bar_mem);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;
  const int wl = (tid >> 5) & 3;  // warp within the warpgroup: rows 16 wl .. +15 of each m64

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
  const int co0 = blockIdx.y * BN;

  const int pd = (p.kd - 1) / 2, ph = (p.kh - 1) / 2, pw = (p.kw - 1) / 2;
  const int dz_lo = max(0, pd - dd);
  const int dz_hi = min(p.kd, p.d - dd + pd);
  const int nchunks = p.ci_pad / KC;
  const int num_stages = (dz_hi - dz_lo) * p.kh * nchunks;

  // slab offset of each m64 tile's first core matrix at tap dx = 0, and the
  // stride between its 8 core matrices: a row segment of 64 positions (row
  // mode), or 8 rows x 8 columns (patch mode)
  uint32_t a_off[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int q = wg * MT + i;
    if (p.patch) {
      a_off[i] = (uint32_t)q * 8 * 16;
    } else {
      const int r = q * 64 / p.tw;
      a_off[i] = (uint32_t)(r * p.pitch + q * 64 - r * p.tw) * 16;
    }
  }
  const uint32_t sbo_a = p.patch ? (uint32_t)p.pitch * 16 : 128;

  // One thread loads a stage by the tensor memory accelerator: a box of
  // rows x pitch positions x 8 channels of x per channel chunk (zero past
  // every edge: the halos, and channels past Ci), and a box of kW x BN x KC
  // weights, which the copy writes in wgmma's swizzled layout. All complete
  // on the buffer's mbarrier.
  auto load_stage = [&](int s, int buf) {
    if (tid != 0) return;
    const int chunk = s % nchunks;
    const int rest = s / nchunks;
    const int dy = rest % p.kh;
    const int dz = dz_lo + rest / p.kh;
    const int ci0 = chunk * KC;
    const uint32_t bar = bars + buf * 8;
    mbar_expect_tx(bar, SEGS * p.slab_cap * 16 + b_stage);
    for (int k = 0; k < SEGS; ++k) {
      tma_load_5d(a_base + buf * a_stage + k * a_chunk, &tmx, bar, ci0 + k * 8, w0 - pw,
                  h0 + dy - ph, dd + dz - pd, nn);
    }
    tma_load_3d(b_base + buf * b_stage, &tmw, bar, ci0, co0, (dz * p.kh + dy) * p.kw);
  };

  float acc[MT][NACC];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NACC; ++j) acc[i][j] = 0.0f;

  // Ring of S >= 3 buffers, filled S - 2 stages ahead. Each stage is one
  // commit group per warpgroup, and a warpgroup leaves a stage with at most
  // that group in flight; so when the barrier of stage s is passed, stage
  // s - 2 is retired everywhere and its buffer can be refilled.
  const int S = p.stages;
  const int ahead = S - 2;
  if (tid == 0) {
    for (int i = 0; i < S; ++i) mbar_init(bars + i * 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int s = 0; s < ahead && s < num_stages; ++s) load_stage(s, s);
  int buf = 0, next_buf = ahead;
  for (int s = 0; s < num_stages; ++s) {
    mbar_wait(bars + buf * 8, (uint32_t)(s / S) & 1);  // the buffer's (s / S)-th fill
    __syncthreads();  // every warpgroup has retired stage s - 2
    if (s + ahead < num_stages) load_stage(s + ahead, next_buf);

    // tap dx reads the slab dx positions later: all kW taps share one slab
    const uint32_t bt = b_base + buf * b_stage;
    const uint32_t at = a_base + buf * a_stage;
    wgmma_fence();
    for (int dx = 0; dx < p.kw; ++dx) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const uint64_t db = smem_desc(bt + dx * BN * RB + kk * 32, SBO_B, LAYOUT);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          wgmma_ss(acc[i], smem_desc_a(at + a_off[i] + dx * 16 + kk * 2 * a_chunk, a_chunk, sbo_a),
                   db);
        }
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
    buf = buf + 1 == S ? 0 : buf + 1;
    next_buf = next_buf + 1 == S ? 0 : next_buf + 1;
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < MT; ++i) fence_accumulators(acc[i]);

  // ---- epilogue: bias (+ReLU) in fp32, then store ----
  // accumulator 4j + 2h + e of lane l in warp wl: row 16 wl + l/4 + 8h of
  // the m64 tile, column 8j + 2(l%4) + e (the mma.m16n8k16 C fragment, once
  // per 8 columns)
  const bool pairs = (p.co & 1) == 0;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int q = wg * MT + i;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int mm = wl * 16 + (lane >> 2) + half * 8;
      int r, c;
      if (p.patch) {
        r = mm >> 3;
        c = q * 8 + (mm & 7);
      } else {
        const int m = q * 64 + mm;
        r = m / p.tw;
        c = m - r * p.tw;
      }
      if (r >= rows || c >= twv) continue;
      const long long out_base =
          ((((long long)nn * p.d + dd) * p.h + h0 + r) * p.w + w0 + c) * p.co;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int co = co0 + j * 8 + (lane & 3) * 2;
        if (co >= p.co) continue;
        float v0 = acc[i][j * 4 + half * 2], v1 = acc[i][j * 4 + half * 2 + 1];
        if (p.bias != nullptr) {
          v0 += p.bias[co];
          v1 += p.bias[co + 1];
        }
        if (p.relu) {
          v0 = fmaxf(v0, 0.0f);
          v1 = fmaxf(v1, 0.0f);
        }
        const bool both = co + 1 < p.co;
        if (p.out_bf16) {
          __nv_bfloat16* y = reinterpret_cast<__nv_bfloat16*>(p.y) + out_base + co;
          if (both && pairs) {
            *reinterpret_cast<__nv_bfloat162*>(y) = __floats2bfloat162_rn(v0, v1);
          } else {
            y[0] = __float2bfloat16_rn(v0);
            if (both) y[1] = __float2bfloat16_rn(v1);
          }
        } else {
          float* y = reinterpret_cast<float*>(p.y) + out_base + co;
          if (both && pairs) {
            *reinterpret_cast<float2*>(y) = make_float2(v0, v1);
          } else {
            y[0] = v0;
            if (both) y[1] = v1;
          }
        }
      }
    }
  }
}

size_t narrow_smem(const ConvParams& p, int kc, int bn) {
  return 2 * ((size_t)p.slab_cap * (kc + 8) * 2 + (size_t)p.kw * kc * (bn + 8) * 2);
}

size_t wide_smem(const ConvParams& p, int kc, int bn, int stages) {
  const size_t slab = (size_t)(p.slab_cap + 7) / 8 * 8;  // 128-byte aligned chunks
  return (size_t)stages * ((size_t)p.kw * bn * kc * 2 + slab * kc * 2) + SWIZZLE_ALIGN;
}

using Kernel = void (*)(ConvParams);
using WideKernel = void (*)(ConvParams, CUtensorMap, CUtensorMap);

template <int KC, bool OUT_BF16>
Kernel narrow_kernel(int bn) {
  switch (bn) {
    case 16: return &conv3d_same_kernel<KC, 16, OUT_BF16>;
    case 32: return &conv3d_same_kernel<KC, 32, OUT_BF16>;
    case 64: return &conv3d_same_kernel<KC, 64, OUT_BF16>;
    default: return nullptr;
  }
}

// Instances: BN 32 at 1, 2 or 4 m64 tiles a warpgroup, BN 64 at 1 or 2, BN
// 128 at 1; KC = 64 up to BN = 64 and 2 m64 tiles (beyond, three stages of
// slab and weights outgrow shared memory).
template <int WG, int MT>
WideKernel wide_kernel(int kc, int bn) {
  if (MT == 4 && (bn != 32 || kc == 64)) return nullptr;
  if (MT != 1 && bn == 128) return nullptr;
  constexpr int M2 = MT == 4 ? 1 : MT;  // the BN = 64 and 128 instances MT names
  switch (kc * 1000 + bn) {
    case 16032: return &conv3d_same_kernel_wgmma<WG, MT, 16, 32>;
    case 32032: return &conv3d_same_kernel_wgmma<WG, MT, 32, 32>;
    case 64032: return &conv3d_same_kernel_wgmma<WG, M2, 64, 32>;
    case 16064: return &conv3d_same_kernel_wgmma<WG, M2, 16, 64>;
    case 32064: return &conv3d_same_kernel_wgmma<WG, M2, 32, 64>;
    case 64064: return &conv3d_same_kernel_wgmma<WG, M2, 64, 64>;
    case 16128: return &conv3d_same_kernel_wgmma<WG, 1, 16, 128>;
    case 32128: return &conv3d_same_kernel_wgmma<WG, 1, 32, 128>;
    default: return nullptr;
  }
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
Launch plan_launch(ConvParams& p, int n, int d, int h, int wl, int ci, int co, int kd, int kh,
                   int kw, int ci_pad, int co_pad, int instance, int bm, int mt, int bn, int kc,
                   int stages, int out_bf16) {
  Launch l{nullptr, nullptr, 0, 0, dim3(1)};
  if (kd % 2 == 0 || kh % 2 == 0 || kw % 2 == 0 || n <= 0 || d <= 0 || h <= 0 || wl <= 0 ||
      ci <= 0 || ci % 8 != 0 || co <= 0 || ci_pad < ci || co_pad < co || kc <= 0 || bn <= 0 ||
      ci_pad % kc != 0 || co_pad % bn != 0) {
    return l;
  }
  p.n = n; p.d = d; p.h = h; p.w = wl; p.ci = ci; p.co = co;
  p.kd = kd; p.kh = kh; p.kw = kw;
  p.ci_pad = ci_pad; p.co_pad = co_pad;
  p.out_bf16 = out_bf16;
  p.stages = stages;
  if (instance == 1) {
    const int wgs = bm / (64 * mt);
    if ((mt != 1 && mt != 2 && mt != 4) || (wgs != 1 && wgs != 2) || bm != 64 * wgs * mt ||
        stages < 3 || stages > 4) {
      return l;
    }
    if (wl >= 64) {  // row mode: each m64 tile is 64 positions of one row
      p.patch = 0;
      p.tw = 64;  // up to 128 columns: a tensor-copy box spans at most 256
      while (p.tw * 2 <= bm && p.tw * 2 <= wl && p.tw < 128) p.tw *= 2;
      p.rows_per_tile = bm / p.tw;
    } else {  // patch mode: each m64 tile is 8 rows x 8 columns
      if (mt != 1) return l;
      p.patch = 1;
      p.rows_per_tile = 8;
      p.tw = 8 * wgs;
    }
    p.tiles_per_row = (wl + p.tw - 1) / p.tw;
    p.tiles_per_plane = (h + p.rows_per_tile - 1) / p.rows_per_tile * p.tiles_per_row;
    p.pitch = p.tw + kw - 1;
    p.slab_cap = p.rows_per_tile * p.pitch;
    if (wgs == 2) {
      l.wide = mt == 4 ? wide_kernel<2, 4>(kc, bn)
             : mt == 2 ? wide_kernel<2, 2>(kc, bn) : wide_kernel<2, 1>(kc, bn);
    } else {
      l.wide = mt == 4 ? wide_kernel<1, 4>(kc, bn)
             : mt == 2 ? wide_kernel<1, 2>(kc, bn) : wide_kernel<1, 1>(kc, bn);
    }
    l.threads = wgs * 128;
    l.smem = wide_smem(p, kc, bn, stages);
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
      l.kern = out_bf16 ? narrow_kernel<16, true>(bn) : narrow_kernel<16, false>(bn);
    } else {
      l.kern = out_bf16 ? narrow_kernel<32, true>(bn) : narrow_kernel<32, false>(bn);
    }
    l.threads = THREADS;
    l.smem = narrow_smem(p, kc, bn);
  } else {
    return l;
  }
  if (l.smem > SMEM_MAX) l.kern = nullptr, l.wide = nullptr;
  l.grid = dim3((unsigned)((long long)n * d * p.tiles_per_plane), (unsigned)(co_pad / bn));
  return l;
}

// Tensor maps of the TMA loads: x as (Ci, W, H, D, N) in boxes of 8
// channels x pitch columns x rows, zero past the edges; the weights as
// (ci_pad, co_pad, taps) in boxes of KC x BN x kW, written in wgmma's
// swizzled layout. The encoder is fetched through the runtime API, so the
// library needs no link flag beyond nvcc's defaults.
bool encode_maps(const ConvParams& p, const void* x, const void* w, int kc, int bn,
                 CUtensorMap* tmx, CUtensorMap* tmw) {
  if (!encode_activation_map(tmx, x, p.n, p.d, p.h, p.w, p.ci, p.pitch, p.rows_per_tile)) {
    return false;
  }
  const cuuint64_t e = 2;  // bytes a bf16
  const cuuint64_t wd[3] = {(cuuint64_t)p.ci_pad, (cuuint64_t)p.co_pad,
                            (cuuint64_t)p.kd * p.kh * p.kw};
  const cuuint64_t ws[2] = {wd[0] * e, wd[0] * wd[1] * e};
  const cuuint32_t wb[3] = {(cuuint32_t)kc, (cuuint32_t)bn, (cuuint32_t)p.kw};
  const cuuint32_t one[3] = {1, 1, 1};
  return tensor_map_encoder()(tmw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), wd,
                              ws, wb, one, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(kc * 2),
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// What a plan launches, into out[0..4]: dynamic shared bytes, grid x, grid
// y, registers a thread, local (spill) bytes a thread. The plan's arguments
// are those of conv3d_same_bf16. Returns cudaErrorInvalidValue for a plan
// with no instance, else the cudaError_t of reading the kernel's attributes.
int conv3d_same_plan(int n, int d, int h, int wl, int ci, int co, int kd, int kh, int kw,
                     int ci_pad, int co_pad, int instance, int bm, int mt, int bn, int kc,
                     int stages, int out_bf16, int* out) {
  ConvParams p;
  const Launch l = plan_launch(p, n, d, h, wl, ci, co, kd, kh, kw, ci_pad, co_pad, instance,
                               bm, mt, bn, kc, stages, out_bf16);
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
// the launch (0 on success). instance: 0 narrow (mma.sync), 1 wide (wgmma).
// Weights: (T, ci_pad, co_pad) for the narrow instance, K-major (T, co_pad,
// ci_pad) for the wide one. Does not synchronize and allocates nothing.
int conv3d_same_bf16(const void* x, const void* w, const void* bias, void* y, int n, int d,
                     int h, int wl, int ci, int co, int kd, int kh, int kw, int ci_pad,
                     int co_pad, int instance, int bm, int mt, int bn, int kc, int stages,
                     int relu, int out_bf16, void* stream) {
  ConvParams p;
  const Launch l = plan_launch(p, n, d, h, wl, ci, co, kd, kh, kw, ci_pad, co_pad, instance,
                               bm, mt, bn, kc, stages, out_bf16);
  if (!l.ok()) return (int)cudaErrorInvalidValue;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.wt = static_cast<const __nv_bfloat16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.y = y;
  p.relu = relu;
  cudaError_t err =
      cudaFuncSetAttribute(l.func(), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (l.kern != nullptr) {
    l.kern<<<l.grid, l.threads, l.smem, s>>>(p);
    return (int)cudaGetLastError();
  }
  CUtensorMap tmx, tmw;
  if (!encode_maps(p, x, w, kc, bn, &tmx, &tmw)) {
    return (int)cudaErrorInvalidValue;
  }
  l.wide<<<l.grid, l.threads, l.smem, s>>>(p, tmx, tmw);
  return (int)cudaGetLastError();
}

const char* conv3d_same_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
