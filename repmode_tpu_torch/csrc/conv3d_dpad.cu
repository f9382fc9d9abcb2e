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
//
// What bounds it: at the s2d shapes (Ci, Co = 128..512, 32x64x64 and
// 16x32x32 positions per sample) a conv does 2*45*Ci*Co operations per
// output position against ~2*(Ci+Co) bytes moved, far above the card's ~295
// operations per byte: it is bound by tensor-core operations. The seven
// convs of a batch of 8 patches cost 9.66 TFLOP, at least 9.77 ms at 989
// TFLOP/s. The design keeps the tensor cores fed from shared memory:
//
//   * implicit GEMM. M = a tile of BM=128 output positions inside one
//     (n, dp) plane (whole rows when W < 128), N = BN=128 output channels,
//     K = taps x Ci, walked as (dz, dy, Ci chunk) stages of KC=32 channels.
//   * the depth halo is physical: an interior row reads input rows
//     dp-pd .. dp+pd, which all exist, so there are no depth bounds checks.
//   * the H and W halos are zero-filled loads (cp.async with src-size 0):
//     no padded copy of the input exists. Per stage one slab (the tile's
//     rows shifted by dy, widened by the two halo columns) serves all three
//     dx taps at shifted row addresses.
//   * products are bf16 mma.sync.m16n8k16 with fp32 accumulators; two stage
//     buffers overlap the next stage's copies with this stage's products.
//   * two blocks of 256 threads per SM (73 KB of shared memory each, at most
//     128 registers a thread): one block's barrier waits overlap the other's
//     products. Uncapped, ptxas takes 136 registers and one block fits.
//   * a block of a halo row writes zeros with 16-byte stores and returns.
//   * no atomics: every output is written once, so results are deterministic.
//
// Ci and Co must be multiples of 128 (every s2d level of the net: 4x the
// native width of 32 or 64); the wrapper refuses other geometry. wgmma,
// TMA and a persistent schedule are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // output positions per block
constexpr int BN = 128;      // output channels per block
constexpr int KC = 32;       // input channels per stage
constexpr int THREADS = 256; // 8 warps: 4 along M (32 rows each) x 2 along N (64 each)
constexpr int KH = 3, KW = 3;

struct DpadParams {
  const __nv_bfloat16* x;  // (N, Dp, H, W, Ci)
  const __nv_bfloat16* wt; // (kD*3*3, Ci, Co)
  const float* bias;       // (Co) or nullptr
  __nv_bfloat16* y;        // (N, Dp, H, W, Co)
  int n, dp, h, w, ci, co, kd;
  int tw;               // columns per tile (BM when W >= BM, else W)
  int rows_per_tile;    // 1 when W >= BM, else BM / W
  int tiles_per_row;    // ceil(W / BM) when W >= BM, else 1
  int tiles_per_plane;
  int slab_cap;         // slab positions per stage buffer
  int relu;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
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

// Two blocks per SM: registers capped at 128 (ptxas spills ~20 bytes).
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

  // ---- which tile this block computes ----
  int bx = blockIdx.x;
  const int t = bx % p.tiles_per_plane;
  bx /= p.tiles_per_plane;
  const int dd = bx % p.dp;
  const int nn = bx / p.dp;
  const int h0 = (t / p.tiles_per_row) * p.rows_per_tile;
  const int w0 = (t % p.tiles_per_row) * p.tw;
  const int rows = min(p.rows_per_tile, p.h - h0);
  const int twv = min(p.tw, p.w - w0);
  const int cols = twv + KW - 1;
  const int npos = rows * cols;
  const int co0 = blockIdx.y * BN;
  const int pd = (p.kd - 1) / 2;

  // ---- a halo row: zeros for this tile's positions and channels ----
  if (dd < pd || dd >= p.dp - pd) {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int i = tid; i < rows * twv * WSEGS; i += THREADS) {
      const int pos = i / WSEGS, sg = i - (i / WSEGS) * WSEGS;
      const int r = pos / twv, c = pos - (pos / twv) * twv;
      const long long o = ((((long long)nn * p.dp + dd) * p.h + h0 + r) * p.w + w0 + c) * p.co;
      *reinterpret_cast<uint4*>(p.y + o + co0 + sg * 8) = zero;
    }
    return;
  }

  const int nchunks = p.ci / KC;
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
    const long long plane = ((long long)nn * p.dp + di) * p.h;

    for (int i = tid; i < npos * SEGS; i += THREADS) {
      const int pos = i / SEGS, sg = i - (i / SEGS) * SEGS;
      const int r = pos / cols, c = pos - (pos / cols) * cols;
      const int hi = h0 + r + dy - 1, wi = w0 + c - 1;
      const bool ok = hi >= 0 && hi < p.h && wi >= 0 && wi < p.w;
      const __nv_bfloat16* src = ok ? p.x + ((plane + hi) * p.w + wi) * p.ci + ci0 + sg * 8 : p.x;
      cp_async16(smem_u32(slab + pos * A_STRIDE + sg * 8), src, ok ? 16 : 0);
    }

    const int tap0 = (dz * KH + dy) * KW;
    for (int i = tid; i < KW * KC * WSEGS; i += THREADS) {
      const int row = i / WSEGS, sg = i - (i / WSEGS) * WSEGS;
      const int dx = row / KC, k = row - (row / KC) * KC;
      const __nv_bfloat16* src =
          p.wt + ((long long)(tap0 + dx) * p.ci + ci0 + k) * p.co + co0 + sg * 8;
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
          ((((long long)nn * p.dp + dd) * p.h + h0 + r) * p.w + w0 + c) * p.co;
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

}  // namespace

extern "C" {

// Launches the conv on `stream` and returns the cudaError_t of the launch
// (0 on success). Does not synchronize and allocates nothing.
int conv3d_dpad_bf16(const void* x, const void* w, const void* bias, void* y, int n, int dp,
                     int h, int wl, int ci, int co, int kd, int relu, void* stream) {
  if ((kd != 3 && kd != 5) || n <= 0 || dp <= kd - 1 || h <= 0 || wl <= 0 || ci <= 0 ||
      ci % 128 != 0 || co <= 0 || co % 128 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  DpadParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.wt = static_cast<const __nv_bfloat16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.n = n; p.dp = dp; p.h = h; p.w = wl; p.ci = ci; p.co = co; p.kd = kd;
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
  p.relu = relu;

  const size_t buf_bytes = (size_t)p.slab_cap * (KC + 8) * 2 + (size_t)KW * KC * (BN + 8) * 2;
  const size_t smem = 2 * buf_bytes;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      conv3d_dpad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((long long)n * dp * p.tiles_per_plane), (unsigned)(co / BN));
  conv3d_dpad_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

const char* conv3d_dpad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
