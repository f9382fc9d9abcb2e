// Per-sample weight gradient of a 'same' 3-D convolution, for Hopper (sm_90a).
//
// Replaces the TPU kernel repmode_tpu/ops/pallas/conv3d.py:
// pallas_conv3d_dw_persample (body _dw_kernel_ps). It computes the tap
// correlation
//
//     dW[n, t, i, o] = sum_p x[n, p + t - c, i] * dy[n, p, o]
//
// with zero 'same' padding, NDHWC x (N,D,H,W,Ci) and dy (N,D,H,W,Co) in bf16,
// fp32 sums, and an fp32 (N, kD, kH, kW, Ci, Co) result: the sufficient
// statistic of the merged MoDE conv's backward (the expert-bank and gate
// gradients are contractions of it).
//
// For each (sample, tap) this is a GEMM with M = Ci, N = Co and K = the
// sample's positions, and the shapes swing across the net: 32x32 outputs
// over 524,288 positions at level 1, 512x512 outputs over 128 positions at
// the bottleneck. What bounds it is tensor-core operations (2*125*Ci*Co per
// position, like the forward) except where the output is large against the
// positions (the bottleneck writes 8*125*512*512*4 B = 1 GB of fp32 dW), where
// bytes bound it. The design:
//
//   * one block computes a BI x BO = 32 x 32 tile of dW for one sample, one
//     (dz, dy) tap pair and KWB consecutive taps along W (all kW of them when
//     kW is 1, 3 or 5), so the kW taps share one shared-memory slab: x is read
//     kD*kH times, not 125 times (conv3d_same.cu's slab trick, seen from the
//     weight side);
//   * positions are walked in chunks of TP = 64 (one row segment, or several
//     whole rows when W < 64): per chunk, cp.async copies the dy tile and the
//     x slab (the chunk's rows shifted by (dz, dy), widened by the column
//     halo) to shared memory, double-buffered. Halos and tails are
//     zero-filled loads; depth taps outside the volume skip the chunk;
//   * bf16 mma.sync.m16n8k16, fp32 accumulators: A = x^T from the slab with
//     ldmatrix.trans at the tap's shifted positions, B = dy with
//     ldmatrix.trans; each warp owns 16 x 16 of the tile for all KWB taps;
//   * split over positions: where (sample, tap, tile) blocks alone would not
//     fill the card (level 1 has 200 of them), each block takes a contiguous
//     range of the sample's chunks and writes its fp32 partial sums to a
//     workspace; a second kernel adds the partials in a fixed order. No
//     atomics, so dW is bit-reproducible.
//
// Ci and Co must be multiples of 8 (16-byte copies); the caller packs or pads
// the narrow 1-channel cases. wgmma, TMA and a persistent schedule are left
// for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TP = 64;       // positions per chunk (the GEMM's K per stage)
constexpr int BI = 32;       // input channels per block (dW rows)
constexpr int BO = 32;       // output channels per block (dW columns)
constexpr int THREADS = 128; // 4 warps: 2 along i x 2 along o, 16 x 16 each
constexpr int A_STRIDE = BI + 8;  // bf16 per slab position (pad: no bank conflicts)
constexpr int B_STRIDE = BO + 8;  // bf16 per dy position

struct DwParams {
  const __nv_bfloat16* x;   // (N, D, H, W, ci)
  const __nv_bfloat16* dy;  // (N, D, H, W, co)
  float* out;               // (splits, N, T, ci, co); splits == 1: the result
  int n, d, h, w, ci, co;
  int kd, kh, kw;
  int tw;                // columns per chunk (TP when W >= TP, else W)
  int rows;              // rows per chunk (1 when W >= TP, else TP / W)
  int segs_per_row;      // ceil(W / TP) when W >= TP, else 1
  int chunks_per_plane;  // ceil(H / rows) * segs_per_row
  int itiles, otiles, dxgroups, splits, chunks_per_split;
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

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
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

// KWB: taps along W served by one block from one slab (1, 3 or 5).
template <int KWB>
__global__ void __launch_bounds__(THREADS)
conv3d_dw_kernel(const DwParams p) {
  constexpr int ISEGS = BI / 8, OSEGS = BO / 8;
  const int cols = p.tw + KWB - 1;    // slab columns per row
  const int slab_cap = p.rows * cols;
  const int buf_elems = slab_cap * A_STRIDE + TP * B_STRIDE;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* base = reinterpret_cast<__nv_bfloat16*>(smem);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_i = warp & 1;
  const int warp_o = warp >> 1;

  // ---- which tile, taps and chunk range this block computes ----
  int bx = blockIdx.x;
  const int split = bx % p.splits;
  bx /= p.splits;
  const int ot = bx % p.otiles;
  bx /= p.otiles;
  const int it = bx % p.itiles;
  bx /= p.itiles;
  const int dxg = bx % p.dxgroups;
  bx /= p.dxgroups;
  const int ty = bx % p.kh;
  bx /= p.kh;
  const int tz = bx % p.kd;
  const int nn = bx / p.kd;
  const int i0 = it * BI, o0 = ot * BO, dx0 = dxg * KWB;

  const int pd = (p.kd - 1) / 2, ph = (p.kh - 1) / 2, pw = (p.kw - 1) / 2;
  // chunks are ordered depth-major; a depth plane whose shifted input plane
  // lies outside the volume contributes nothing
  const int d_lo = max(0, pd - tz), d_hi = min(p.d, p.d + pd - tz);
  const int c_begin = max(split * p.chunks_per_split, d_lo * p.chunks_per_plane);
  const int c_end = min((split + 1) * p.chunks_per_split, d_hi * p.chunks_per_plane);
  const int num_chunks = max(0, c_end - c_begin);

  // slab position of each of this thread's ldmatrix rows, per k16 step (tap dx0)
  int a_pos[TP / 16];
#pragma unroll
  for (int kk = 0; kk < TP / 16; ++kk) {
    const int q = kk * 16 + (lane & 7) + ((lane >> 4) & 1) * 8;
    const int r = q / p.tw, c = q - (q / p.tw) * p.tw;
    a_pos[kk] = (r < p.rows) ? r * cols + c : 0;  // positions past the chunk: dy is 0
  }

  auto load_chunk = [&](int chunk, int buf) {
    const int dd = chunk / p.chunks_per_plane;
    const int rem = chunk - dd * p.chunks_per_plane;
    const int h0 = (rem / p.segs_per_row) * p.rows;
    const int w0 = (rem % p.segs_per_row) * p.tw;
    const int di = dd + tz - pd;
    __nv_bfloat16* slab = base + buf * buf_elems;
    __nv_bfloat16* dys = slab + slab_cap * A_STRIDE;

    const long long xplane = ((long long)nn * p.d + di) * p.h;
    for (int i = tid; i < slab_cap * ISEGS; i += THREADS) {
      const int pos = i / ISEGS, sg = i - (i / ISEGS) * ISEGS;
      const int r = pos / cols, c = pos - (pos / cols) * cols;
      const int hi = h0 + r + ty - ph, wi = w0 + c + dx0 - pw;
      const int ch = i0 + sg * 8;
      const bool ok = hi >= 0 && hi < p.h && wi >= 0 && wi < p.w && ch < p.ci;
      const __nv_bfloat16* src = ok ? p.x + ((xplane + hi) * p.w + wi) * p.ci + ch : p.x;
      cp_async16(smem_u32(slab + pos * A_STRIDE + sg * 8), src, ok ? 16 : 0);
    }

    const long long yplane = ((long long)nn * p.d + dd) * p.h;
    for (int i = tid; i < TP * OSEGS; i += THREADS) {
      const int q = i / OSEGS, sg = i - (i / OSEGS) * OSEGS;
      const int r = q / p.tw, c = q - (q / p.tw) * p.tw;
      const int ho = h0 + r, wo = w0 + c;
      const int ch = o0 + sg * 8;
      const bool ok = r < p.rows && ho < p.h && wo < p.w && ch < p.co;
      const __nv_bfloat16* src = ok ? p.dy + ((yplane + ho) * p.w + wo) * p.co + ch : p.dy;
      cp_async16(smem_u32(dys + q * B_STRIDE + sg * 8), src, ok ? 16 : 0);
    }
  };

  float acc[KWB][2][4];
#pragma unroll
  for (int dx = 0; dx < KWB; ++dx)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[dx][j][q] = 0.0f;

  if (num_chunks > 0) {
    load_chunk(c_begin, 0);
  }
  cp_async_commit();
  for (int s = 0; s < num_chunks; ++s) {
    const int buf = s & 1;
    if (s + 1 < num_chunks) load_chunk(c_begin + s + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

    const __nv_bfloat16* slab = base + buf * buf_elems;
    const uint32_t slab_addr = smem_u32(slab);
    const uint32_t dy_addr = smem_u32(slab + slab_cap * A_STRIDE);
    const int a_col = warp_i * 16 + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < TP / 16; ++kk) {
      // B = dy[positions kk*16.., o0 + warp_o*16 ..+16]: two n8 fragments
      uint32_t b[4];
      const int boff = (kk * 16 + (lane & 15)) * B_STRIDE + warp_o * 16 + (lane >> 4) * 8;
      ldmatrix_x4_trans(dy_addr + boff * 2, b);
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
#pragma unroll
      for (int dx = 0; dx < KWB; ++dx) {
        // A = x^T[i0 + warp_i*16 ..+16, the same positions shifted by dx]
        uint32_t a[4];
        ldmatrix_x4_trans(slab_addr + ((a_pos[kk] + dx) * A_STRIDE + a_col) * 2, a);
        mma_bf16_16816(acc[dx][0], a, b0);
        mma_bf16_16816(acc[dx][1], a, b1);
      }
    }
    __syncthreads();
  }

  // ---- store this block's (partial) sums ----
  const int taps = p.kd * p.kh * p.kw;
  float* out = p.out + (long long)split * p.n * taps * p.ci * p.co;
#pragma unroll
  for (int dx = 0; dx < KWB; ++dx) {
    const int tap = (tz * p.kh + ty) * p.kw + dx0 + dx;
    const long long tap_base = ((long long)nn * taps + tap) * p.ci;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = i0 + warp_i * 16 + (lane >> 2) + half * 8;
      if (i >= p.ci) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = o0 + warp_o * 16 + j * 8 + (lane & 3) * 2 + e;
          if (o < p.co) out[(tap_base + i) * p.co + o] = acc[dx][j][half * 2 + e];
        }
      }
    }
  }
}

// out[j] = sum over s of part[s][j], in order s = 0, 1, ...
__global__ void sum_partials_kernel(const float* part, float* out, long long total,
                                    int splits) {
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < total;
       j += (long long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < splits; ++k) s += part[k * total + j];
    out[j] = s;
  }
}

template <int KWB>
cudaError_t launch(const DwParams& p, long long blocks, cudaStream_t stream) {
  const int slab_cap = p.rows * (p.tw + KWB - 1);
  const size_t smem = 2 * ((size_t)slab_cap * A_STRIDE + (size_t)TP * B_STRIDE) * 2;
  auto kern = conv3d_dw_kernel<KWB>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)blocks, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of position splits the kernel will use for these shapes: the
// caller allocates a (splits, n, kd, kh, kw, ci, co) fp32 workspace when it
// is above 1.
int conv3d_dw_persample_splits(int n, int d, int h, int wl, int ci, int co, int kd, int kh,
                               int kw) {
  const int kwb = (kw == 1 || kw == 3 || kw == 5) ? kw : 1;
  const long long base = (long long)n * kd * kh * (kw / kwb) * ((ci + BI - 1) / BI) *
                         ((co + BO - 1) / BO);
  const int rows = wl >= TP ? 1 : TP / wl;
  const int segs = wl >= TP ? (wl + TP - 1) / TP : 1;
  const long long chunks = (long long)d * ((h + rows - 1) / rows) * segs;
  // aim at ~2048 blocks (132 SMs, several 4-warp blocks each)
  long long splits = (2048 + base - 1) / base;
  if (splits > chunks) splits = chunks;
  if (splits < 1) splits = 1;
  const long long per = (chunks + splits - 1) / splits;
  return (int)((chunks + per - 1) / per);
}

// Launches dW on `stream`; returns the cudaError_t (0 on success). x: (n, d,
// h, wl, ci) bf16; dy: (n, d, h, wl, co) bf16; out: (n, kd, kh, kw, ci, co)
// fp32; work: (splits, n, kd, kh, kw, ci, co) fp32 when
// conv3d_dw_persample_splits(...) > 1, else unused. Does not synchronize and
// allocates nothing.
int conv3d_dw_persample_bf16(const void* x, const void* dy, void* out, void* work, int n, int d,
                             int h, int wl, int ci, int co, int kd, int kh, int kw,
                             void* stream) {
  if (kd % 2 == 0 || kh % 2 == 0 || kw % 2 == 0 || n <= 0 || d <= 0 || h <= 0 || wl <= 0 ||
      ci <= 0 || ci % 8 != 0 || co <= 0 || co % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int splits = conv3d_dw_persample_splits(n, d, h, wl, ci, co, kd, kh, kw);
  if (splits > 1 && work == nullptr) return (int)cudaErrorInvalidValue;
  DwParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.dy = static_cast<const __nv_bfloat16*>(dy);
  p.out = static_cast<float*>(splits > 1 ? work : out);
  p.n = n; p.d = d; p.h = h; p.w = wl; p.ci = ci; p.co = co;
  p.kd = kd; p.kh = kh; p.kw = kw;
  if (wl >= TP) {
    p.tw = TP; p.rows = 1; p.segs_per_row = (wl + TP - 1) / TP;
  } else {
    p.tw = wl; p.rows = TP / wl; p.segs_per_row = 1;
  }
  p.chunks_per_plane = ((h + p.rows - 1) / p.rows) * p.segs_per_row;
  const int kwb = (kw == 1 || kw == 3 || kw == 5) ? kw : 1;
  p.itiles = (ci + BI - 1) / BI;
  p.otiles = (co + BO - 1) / BO;
  p.dxgroups = kw / kwb;
  p.splits = splits;
  const long long chunks = (long long)d * p.chunks_per_plane;
  p.chunks_per_split = (int)((chunks + splits - 1) / splits);
  const long long blocks =
      (long long)n * kd * kh * p.dxgroups * p.itiles * p.otiles * splits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (kwb) {
    case 1: err = launch<1>(p, blocks, s); break;
    case 3: err = launch<3>(p, blocks, s); break;
    default: err = launch<5>(p, blocks, s); break;
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long total = (long long)n * kd * kh * kw * ci * co;
  long long grid = (total + 255) / 256;
  if (grid > 132 * 16) grid = 132 * 16;
  sum_partials_kernel<<<(unsigned)grid, 256, 0, s>>>(static_cast<const float*>(work),
                                                     static_cast<float*>(out), total, splits);
  return (int)cudaGetLastError();
}

const char* conv3d_dw_persample_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
