// Per-sample 'same' 3-D convolution and its transpose, for Hopper (sm_90a).
//
// Replaces the TPU kernel repmode_tpu/ops/pallas/conv3d.py:
// pallas_conv3d_same_persample (body _conv_kernel_ps) in both of its uses:
//
//   forward (K2)        y[n,p,o]  = sum_t sum_i x[n, p + t - c, i] * w[n, t, i, o]
//   transposed (K3)     dx[n,p,i] = sum_t sum_o dy[n, p + t - c, o] * w[n, T-1-t, i, o]
//
// with zero 'same' padding, any odd (kD, kH, kW), NDHWC activations and the
// per-sample merged MoDE kernels w of shape (N, kD, kH, kW, Ci, Co). The
// transposed conv is the dx of the forward: it reads the FORWARD kernels with
// the taps reversed and contracts on their output axis, so no flipped or
// io-swapped copy of the per-sample kernels is ever written. Inputs are bf16,
// products are summed in fp32 and the output is bf16 (the dtype contract of
// repmode_tpu/ops/mode.py:merged_conv_persample).
//
// What bounds it: like the shared-kernel conv (conv3d_same.cu) it does
// 2*125*Ci*Co operations per output voxel, far above the card's ~295
// operations per byte at every MoDE conv of the training net except the
// 1-channel input and output convs, so it is bound by tensor-core operations.
// The per-sample kernels add bytes: N*125*Ci*Co bf16 (0.52 GB at the 512x512
// bottleneck conv at batch 8), each read by every block of its sample, which
// at the deep levels is most of the traffic. The design is conv3d_same.cu's:
//
//   * implicit GEMM. M = a tile of BM=128 output positions inside one (n, d)
//     plane, N = a tile of BN output channels, K = taps x input channels,
//     walked as (dz, dy, channel chunk) stages;
//   * per stage one input slab (the tile's rows shifted by dy, widened by the
//     kW-1 column halo) and the kW tap matrices of that (dz, dy) go to shared
//     memory with cp.async; all kW taps read the same slab at shifted row
//     addresses, so the input is read kD*kH times, not 125 times;
//   * the block's weight pointer is its sample's kernel, w + n*T*Ci*Co. The
//     forward stores a tap's (Ci chunk x BN) tile row-major and feeds the
//     tensor cores with ldmatrix.trans; the transposed conv copies the (BN x
//     Co chunk) block of tap T-1-t as it lies in memory (rows = the forward's
//     input channels, contiguous along its output channels) and feeds it with
//     plain ldmatrix, which is the same B operand seen from the other side;
//   * halos, channel tails and output-tile tails are zero-filled loads
//     (cp.async src-size 0): no padded copy of the input or the kernels;
//     depth taps outside the volume are skipped;
//   * bf16 mma.sync.m16n8k16 with fp32 accumulators, two stage buffers;
//   * no atomics: every output is written once, results are deterministic.
//
// The contraction channel count (x's channels, Ci forward and Co transposed)
// must be a multiple of 8 (16-byte copies), and so must the forward kernels'
// output axis; the caller packs or pads the narrow 1-channel cases. wgmma,
// TMA and a persistent schedule are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // output positions per block
constexpr int THREADS = 256; // 8 warps: 4 along M (32 rows each) x 2 along N

struct PsParams {
  const __nv_bfloat16* x;  // (N, D, H, W, cin)
  const __nv_bfloat16* wt; // (N, T, wci, wco): the forward's per-sample kernels
  __nv_bfloat16* y;        // (N, D, H, W, cout)
  int n, d, h, w, cin, cout;
  int kd, kh, kw;
  int wci, wco;         // forward: wci == cin, wco >= cout; transposed: wco == cin, wci >= cout
  int tw;               // columns per tile (BM when W >= BM, else W)
  int rows_per_tile;    // 1 when W >= BM, else BM / W
  int tiles_per_row;    // ceil(W / BM) when W >= BM, else 1
  int tiles_per_plane;
  int slab_cap;         // slab positions per stage buffer
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

__device__ __forceinline__ void ldmatrix_x2(uint32_t addr, uint32_t (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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

template <int KC, int BN, bool TRANS>
cudaError_t launch(const PsParams& p, cudaStream_t stream) {
  const int b_rows = TRANS ? BN : KC, b_stride = TRANS ? KC + 8 : BN + 8;
  const size_t buf_bytes =
      (size_t)p.slab_cap * (KC + 8) * 2 + (size_t)p.kw * b_rows * b_stride * 2;
  const size_t smem = 2 * buf_bytes;
  if (smem > 227 * 1024) return cudaErrorInvalidConfiguration;
  auto kern = conv3d_persample_kernel<KC, BN, TRANS>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((long long)p.n * p.d * p.tiles_per_plane),
            (unsigned)((p.cout + BN - 1) / BN));
  kern<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int KC, bool TRANS>
cudaError_t launch_bn(const PsParams& p, int bn, cudaStream_t stream) {
  switch (bn) {
    case 16: return launch<KC, 16, TRANS>(p, stream);
    case 32: return launch<KC, 32, TRANS>(p, stream);
    case 64: return launch<KC, 64, TRANS>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches the per-sample conv (transpose = 0, K2) or its transpose
// (transpose = 1, K3) on `stream` and returns the cudaError_t of the launch
// (0 on success). x: (n, d, h, wl, cin) bf16; w: (n, kd, kh, kw, wci, wco)
// bf16, the forward's kernels in both cases; y: (n, d, h, wl, cout) bf16.
// Does not synchronize and allocates nothing.
int conv3d_persample_bf16(const void* x, const void* w, void* y, int n, int d, int h, int wl,
                          int cin, int cout, int kd, int kh, int kw, int wci, int wco,
                          int transpose, int kc, int bn, void* stream) {
  const bool shapes_ok = transpose ? (wco == cin && wci >= cout) : (wci == cin && wco >= cout);
  if (kd % 2 == 0 || kh % 2 == 0 || kw % 2 == 0 || n <= 0 || d <= 0 || h <= 0 || wl <= 0 ||
      cin <= 0 || cin % 8 != 0 || cout <= 0 || wco % 8 != 0 || !shapes_ok ||
      (kc != 16 && kc != 32)) {
    return (int)cudaErrorInvalidValue;
  }
  PsParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.wt = static_cast<const __nv_bfloat16*>(w);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.n = n; p.d = d; p.h = h; p.w = wl; p.cin = cin; p.cout = cout;
  p.kd = kd; p.kh = kh; p.kw = kw;
  p.wci = wci; p.wco = wco;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (kc == 16) {
    err = transpose ? launch_bn<16, true>(p, bn, s) : launch_bn<16, false>(p, bn, s);
  } else {
    err = transpose ? launch_bn<32, true>(p, bn, s) : launch_bn<32, false>(p, bn, s);
  }
  return (int)err;
}

const char* conv3d_persample_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
