// 'same' 3-D convolution with a fused bias(+ReLU) epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel repmode_tpu/ops/pallas/conv3d.py:pallas_conv3d_same
// (bodies _conv_kernel and _conv_bias_relu_kernel). It computes
//
//     y[n,p,o] = act( sum_t sum_i x[n, p + t - c, i] * w[t, i, o] + b[o] )
//
// with zero 'same' padding, any odd (kD, kH, kW), NDHWC activations and DHWIO
// weights (passed as (T, Ci_pad, Co_pad), zero-padded by the caller). x and w
// are bf16, products are summed in fp32, the epilogue (none / bias /
// bias+ReLU) runs in fp32 and the output is fp32 or bf16.
//
// What bounds it: at the serving shapes a conv does ~2*125*Ci*Co operations
// per output voxel and moves tens of MB, far above the card's ~295
// operations per byte, so it is bound by tensor-core operations. The 19
// convs of the serving net cost 1.086 TFLOP per 32x128x128 patch (the
// largest, decoder_block1.conv1, 64 -> 32 channels at 32x128x128, 0.27
// TFLOP); a batch of 8 patches is 8.7 TFLOP, at least 8.8 ms at the H100's
// 989 TFLOP/s dense bf16. Only the first conv (Ci=1) and conv_out (Co=1)
// are bound by bytes. The design therefore keeps the tensor cores fed from
// shared memory:
//
//   * implicit GEMM. M = a tile of BM=128 output positions inside one (n, d)
//     plane (one row segment along W, or whole rows when W < 128), N = a tile
//     of BN output channels, K = taps x Ci, walked as (dz, dy, Ci chunk)
//     stages.
//   * per stage one input slab (the tile's rows shifted by dy, widened by the
//     kW-1 column halo) and the kW tap matrices of that (dz, dy) are copied
//     to shared memory with cp.async; all kW taps along W read the same slab
//     at shifted row addresses (ldmatrix takes one address per row), so the
//     input is read from L2 kD*kH times, not kD*kH*kW times.
//   * halos are bounds-checked zero-filled loads (cp.async src-size 0): no
//     padded copy of the input exists. Depth taps that fall outside the
//     volume are skipped entirely.
//   * products are bf16 mma.sync.m16n8k16 with fp32 accumulators; two stage
//     buffers overlap the next stage's copies with this stage's products.
//   * Ci must be a multiple of 8 (16-byte copies). The caller packs the kW
//     taps of a narrow input (the 1-channel input conv) into channels, and
//     pads the weights to whole Ci chunks and Co tiles; Co=1 is served by
//     zero weight columns.
//   * no atomics: every output is written once, so results are deterministic.
//
// wgmma, TMA and a persistent schedule are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // output positions per block
constexpr int THREADS = 256; // 8 warps: 4 along M (32 rows each) x 2 along N

struct ConvParams {
  const __nv_bfloat16* x;  // (N, D, H, W, Ci)
  const __nv_bfloat16* wt; // (T, ci_pad, co_pad)
  const float* bias;       // (co_pad) or nullptr
  void* y;                 // (N, D, H, W, Co), fp32 or bf16
  int n, d, h, w, ci, co;
  int kd, kh, kw;
  int ci_pad, co_pad;
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

// KC: input channels per stage (16 or 32). BN: output channels per block
// (16, 32 or 64). Each warp owns a 32 x (BN/2) output tile.
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

template <int KC, int BN, bool OUT_BF16>
cudaError_t launch(const ConvParams& p, cudaStream_t stream) {
  const size_t buf_bytes =
      (size_t)p.slab_cap * (KC + 8) * 2 + (size_t)p.kw * KC * (BN + 8) * 2;
  const size_t smem = 2 * buf_bytes;
  if (smem > 227 * 1024) return cudaErrorInvalidConfiguration;
  auto kern = conv3d_same_kernel<KC, BN, OUT_BF16>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((long long)p.n * p.d * p.tiles_per_plane), (unsigned)(p.co_pad / BN));
  kern<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int KC, bool OUT_BF16>
cudaError_t launch_bn(const ConvParams& p, int bn, cudaStream_t stream) {
  switch (bn) {
    case 16: return launch<KC, 16, OUT_BF16>(p, stream);
    case 32: return launch<KC, 32, OUT_BF16>(p, stream);
    case 64: return launch<KC, 64, OUT_BF16>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches the conv on `stream` and returns the cudaError_t of the launch
// (0 on success). Does not synchronize and allocates nothing.
int conv3d_same_bf16(const void* x, const void* w, const void* bias, void* y, int n, int d,
                     int h, int wl, int ci, int co, int kd, int kh, int kw, int ci_pad,
                     int co_pad, int kc, int bn, int relu, int out_bf16, void* stream) {
  if (kd % 2 == 0 || kh % 2 == 0 || kw % 2 == 0 || n <= 0 || d <= 0 || h <= 0 || wl <= 0 ||
      ci <= 0 || ci % 8 != 0 || co <= 0 || (kc != 16 && kc != 32) || ci_pad % kc != 0 ||
      ci_pad < ci ||
      co_pad % bn != 0 || co_pad < co) {
    return (int)cudaErrorInvalidValue;
  }
  ConvParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.wt = static_cast<const __nv_bfloat16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.y = y;
  p.n = n; p.d = d; p.h = h; p.w = wl; p.ci = ci; p.co = co;
  p.kd = kd; p.kh = kh; p.kw = kw;
  p.ci_pad = ci_pad; p.co_pad = co_pad;
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
  p.relu = relu;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (kc == 16) {
    err = out_bf16 ? launch_bn<16, true>(p, bn, s) : launch_bn<16, false>(p, bn, s);
  } else {
    err = out_bf16 ? launch_bn<32, true>(p, bn, s) : launch_bn<32, false>(p, bn, s);
  }
  return (int)err;
}

const char* conv3d_same_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
