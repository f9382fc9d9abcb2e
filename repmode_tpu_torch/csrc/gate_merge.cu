// The MoDE gate merge of the training route and its backward, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package merges with an XLA einsum over a
// materialized expert bank (repmode_tpu/ops/mode.py: expert_bank,
// merge_kernels), which the port ran as torch.einsum on an fp32 bank, wrote
// fp32 per-sample kernels, cast them to bf16 and copied them into K2's
// layout; its autograd backward went the same way back. These two kernels
// compute the same linear map straight from the expert parameters:
//
//   wn[n,t,i,o] = g0 w5[o,i,t] + [t in 3^3] (g1 w3[o,i,t'] + g3 wa3[o,i] / 27)
//                 + [t = centre] g2 w1[o,i] + g4 wa5[o,i] / 125,   ge = g[n,e,o]
//
// forward (gate_merge_fwd_kernel): the five expert weights in their stored
// (Co, Ci, kD, kH, kW) fp32 layout and the gate g (N, 5, Co) fp32 -> wn (N,
// 5, 5, 5, Ci, Co) bf16, K2's layout, summed in fp32 in the order above and
// rounded once;
//
// backward (gate_merge_bwd_kernel): the per-sample bf16 dW (the layout of
// wn) -> the five weight gradients in the parameters' layout (fp32) and the
// gate's, dg[n,e,o] = sum over (t, i) of dW[n,t,i,o] * bank_e[t,i,o]:
//
//   dw5 = sum_n g0 dW          dw3 = sum_n g1 dW over the central 3^3
//   dw1 = sum_n g2 dW[centre]  dwa3 = (1/27) sum_n g3 sum_(3^3) dW
//   dwa5 = (1/125) sum_n g4 sum_(5^3) dW.
//
// What bounds them: bytes. The forward reads each expert weight once for
// all N samples and writes N*125*Ci*Co bf16 (1.57 GB over the 19 convs of a
// full-width step at batch 8); the backward reads that much dW, the weights
// again for dg, and writes the weight gradients (0.49 GB). A few operations
// a byte: far below the tensor cores' line. The design:
//
//   * a block owns a tile of at most ELEMS (i, o) pairs, bo output channels
//     by bi input channels (bo = min(Co, 64)), and all 125 taps. The
//     weights of the tile are copied to shared memory row by row (each
//     (o, i) row of 125 taps is contiguous in the parameters), so the reads
//     are coalesced; the taps are then read across the rows, o fastest,
//     which is wn's and dW's order: the shared-memory tile is the transpose
//     from tap-innermost to o-innermost;
//   * a thread owns a unit of V pairs of one input channel and consecutive
//     output channels (V = 2, bf16x2 loads and stores, where Co allows) and
//     the taps of one slice, t = s + slices * k;
//   * forward: per tap, the unit's five expert values; per sample (NB a
//     pass, their gates in registers), one fp32 sum and one bf16x2 store. A
//     warp stores 128 contiguous bytes. Where the tiles are too few to fill
//     the card, blocks also split the samples. No bank is ever written;
//   * backward: per tile, the samples in order. Sample n + 1's dW is copied
//     to shared memory (cp.async, 16 bytes a copy) while sample n is summed.
//     A thread keeps its unit's dw5 sums for its taps in registers (dw3's
//     in shared memory) and its share of dg for the sample; the block adds
//     the slices' and pairs' shares in a fixed order into the group's dg
//     share in shared memory, one barrier a sample. A block walks a group of
//     consecutive input tiles; where a conv has more than one group, a
//     second kernel (gate_merge_bwd_gates_kernel) adds the groups' shares in
//     order. The plan depends only on the shapes (never on the card), and
//     no sum uses atomics, so every gradient is bit-reproducible.
//
// The host (ops/mode.py: gate_merge_plan) picks bo, bi, the sample split and
// the groups; the launches check them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int T5 = 125;             // taps of the 5^3 kernel
constexpr int T3 = 27;              // taps of the central 3^3
constexpr int CENTRE = 62;          // the centre tap (2, 2, 2)
constexpr int ELEMS = 64;           // (i, o) pairs a tile
constexpr int FWD_THREADS = 256;
constexpr int BWD_THREADS = 256;

struct MergeArgs {
  const float* w5;   // (co, ci, 125)
  const float* w3;   // (co, ci, 27)
  const float* w1;   // (co, ci)
  const float* wa3;  // (co, ci)
  const float* wa5;  // (co, ci)
  const float* g;    // (n, 5, co)
  int n, ci, co;
  int bo, bi;        // tile: bo output by bi input channels
  int otiles;        // ceil(co / bo)
};

struct GradArgs {
  const __nv_bfloat16* dw;  // (n, 125, ci, co)
  float* dw5;               // (co, ci, 125)
  float* dw3;               // (co, ci, 27)
  float* dw1;               // (co, ci)
  float* dwa3;              // (co, ci)
  float* dwa5;              // (co, ci)
  float* dg;                // (groups, n, 5, co): each group's share of dg
  int tiles_per_group;      // input-channel tiles a block walks
};

// Index of tap t (0..124, or more: none) in the central 3^3, or -1.
__device__ __forceinline__ int central_index(int t) {
  const int d = t / 25, h = (t / 5) % 5, w = t % 5;
  if (d < 1 || d > 3 || h < 1 || h > 3 || w < 1 || w > 3) return -1;
  return (d - 1) * 9 + (h - 1) * 3 + (w - 1);
}

// Shared memory of both kernels, in floats: the tile's w5 rows [ELEMS][125],
// w3 rows [ELEMS][27], and three [ELEMS] vectors: w1, wa3 / 27, wa5 / 125.
constexpr int S5 = 0;
constexpr int S3 = S5 + ELEMS * T5;
constexpr int SC = S3 + ELEMS * T3;
constexpr int TILE_FLOATS = SC + 3 * ELEMS;

// Copy the weights of the tile (o0.., i0..) to shared memory; pairs outside
// the conv read as zero.
__device__ void load_tile(const MergeArgs& a, int o0, int i0, float* sm) {
  const int pairs = a.bo * a.bi;
#pragma unroll 4
  for (int j = threadIdx.x; j < pairs * T5; j += blockDim.x) {
    const int e = j / T5, o = o0 + e % a.bo, i = i0 + e / a.bo;
    sm[S5 + j] = (o < a.co && i < a.ci) ? a.w5[((size_t)o * a.ci + i) * T5 + j % T5] : 0.f;
  }
#pragma unroll 4
  for (int j = threadIdx.x; j < pairs * T3; j += blockDim.x) {
    const int e = j / T3, o = o0 + e % a.bo, i = i0 + e / a.bo;
    sm[S3 + j] = (o < a.co && i < a.ci) ? a.w3[((size_t)o * a.ci + i) * T3 + j % T3] : 0.f;
  }
  for (int e = threadIdx.x; e < pairs; e += blockDim.x) {
    const int o = o0 + e % a.bo, i = i0 + e / a.bo;
    const bool in = o < a.co && i < a.ci;
    const size_t k = (size_t)o * a.ci + i;
    sm[SC + e] = in ? a.w1[k] : 0.f;
    sm[SC + ELEMS + e] = in ? a.wa3[k] * (1.0f / 27.0f) : 0.f;
    sm[SC + 2 * ELEMS + e] = in ? a.wa5[k] * (1.0f / 125.0f) : 0.f;
  }
}

// Two bf16 (or one) of consecutive output channels: V = 2 where Co is even.
template <int V>
struct Vec;
template <>
struct Vec<1> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[1]) { v[0] = __ldg(p); }
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[1]) {
    v[0] = __bfloat162float(p[0]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[1]) {
    p[0] = __float2bfloat16_rn(v[0]);
  }
};
template <>
struct Vec<2> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[2]) {
    const float2 f = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = f.x; v[1] = f.y;
  }
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[2]) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = f.x; v[1] = f.y;
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[2]) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  }
};

constexpr int NB = 4;  // forward: samples a pass over the taps

// One block a tile and a range of samples (blockIdx.x = (sample range *
// itiles + input tile) * otiles + output tile). A thread owns V pairs of one
// input channel and consecutive output channels (a unit) and the taps t = s
// + slices * k of its slice s; it walks its samples NB at a time with their
// gates in registers.
template <int V>
__global__ void __launch_bounds__(FWD_THREADS)
    gate_merge_fwd_kernel(MergeArgs a, int samples_per_block, __nv_bfloat16* __restrict__ wn) {
  constexpr int UNITS = ELEMS / V, TS = FWD_THREADS / UNITS;
  extern __shared__ float sm[];
  const int itiles = (a.ci + a.bi - 1) / a.bi;
  const int o0 = (blockIdx.x % a.otiles) * a.bo;
  const int i0 = (blockIdx.x / a.otiles % itiles) * a.bi;
  const int n_first = blockIdx.x / a.otiles / itiles * samples_per_block;
  const int n_end = min(a.n, n_first + samples_per_block);
  load_tile(a, o0, i0, sm);
  __syncthreads();
  const int u = threadIdx.x % UNITS, s = threadIdx.x / UNITS, e = u * V;
  const int o = o0 + e % a.bo, i = i0 + e / a.bo;
  if (e >= a.bo * a.bi || o >= a.co || i >= a.ci) return;
  float w1v[V], a3v[V], a5v[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    w1v[v] = sm[SC + e + v];
    a3v[v] = sm[SC + ELEMS + e + v];
    a5v[v] = sm[SC + 2 * ELEMS + e + v];
  }
  const size_t plane = (size_t)a.ci * a.co, sample = T5 * plane;
  __nv_bfloat16* base = wn + (size_t)i * a.co + o;
  for (int n0 = n_first; n0 < n_end; n0 += NB) {
    float gs[NB][5][V];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        if (n0 + nb < n_end) {
          Vec<V>::load(a.g + ((size_t)(n0 + nb) * 5 + k) * a.co + o, gs[nb][k]);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) gs[nb][k][v] = 0.f;
        }
      }
    for (int t = s; t < T5; t += TS) {
      const int c = central_index(t);
      float b0[V], b1[V], b2[V], b3[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        b0[v] = sm[S5 + (e + v) * T5 + t];
        b1[v] = c >= 0 ? sm[S3 + (e + v) * T3 + c] : 0.f;
        b2[v] = t == CENTRE ? w1v[v] : 0.f;
        b3[v] = c >= 0 ? a3v[v] : 0.f;
      }
      __nv_bfloat16* out = base + t * plane + (size_t)n0 * sample;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        if (n0 + nb >= n_end) break;
        float acc[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          acc[v] = gs[nb][0][v] * b0[v];
          acc[v] = fmaf(gs[nb][1][v], b1[v], acc[v]);
          acc[v] = fmaf(gs[nb][2][v], b2[v], acc[v]);
          acc[v] = fmaf(gs[nb][3][v], b3[v], acc[v]);
          acc[v] = fmaf(gs[nb][4][v], a5v[v], acc[v]);
        }
        Vec<V>::store(out + nb * sample, acc);
      }
    }
  }
}

// Shared memory of the backward beyond the tile, in floats: dw3 sums
// [ELEMS][27]; the threads' dg shares, two buffers (even and odd samples) of
// [5][V][BWD_THREADS] at most; and the dW of two samples, [2][125][ELEMS]
// bf16, each pair's V output channels together.
constexpr int D3 = TILE_FLOATS;
constexpr int RED = D3 + ELEMS * T3;
constexpr int RED_BUF = 5 * 2 * BWD_THREADS;
constexpr int XS = RED + 2 * RED_BUF;
constexpr int XS_BUF = T5 * ELEMS / 2;  // floats: 125 x 64 bf16
constexpr int SDG = XS + 2 * XS_BUF;     // then the group's dg share, [n][5][bo]

__host__ __device__ constexpr size_t bwd_smem(int n, int bo) {
  return sizeof(float) * ((size_t)SDG + (size_t)n * 5 * bo);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// Stage sample n's dW of the tile (o0.., i0..) into xs [125][ELEMS]: with
// V = 2 (Co a multiple of 8) as asynchronous 16-byte copies, zero-filled
// past Co and Ci; else element by element.
template <int V>
__device__ __forceinline__ void stage_dw(const MergeArgs& a, const GradArgs& b, int n, int o0,
                                         int i0, __nv_bfloat16* xs) {
  const int pairs = a.bo * a.bi;
  const size_t plane = (size_t)a.ci * a.co;
  const __nv_bfloat16* src = b.dw + (size_t)n * T5 * plane + (size_t)i0 * a.co + o0;
  if (V == 2) {
    const int chunks = pairs / 8;  // 16-byte chunks a tap
    for (int j = threadIdx.x; j < T5 * chunks; j += BWD_THREADS) {
      const int t = j / chunks, e = (j % chunks) * 8;
      const int ol = e % a.bo, il = e / a.bo;
      const bool in = o0 + ol < a.co && i0 + il < a.ci;
      const __nv_bfloat16* g = in ? src + t * plane + (size_t)il * a.co + ol : b.dw;
      cp_async16(xs + t * ELEMS + e, g, in ? 16 : 0);
    }
    cp_async_commit();
  } else {
    for (int j = threadIdx.x; j < T5 * pairs; j += BWD_THREADS) {
      const int t = j / pairs, e = j % pairs;
      const int ol = e % a.bo, il = e / a.bo;
      const bool in = o0 + ol < a.co && i0 + il < a.ci;
      xs[t * ELEMS + e] = in ? src[t * plane + (size_t)il * a.co + ol] : __float2bfloat16_rn(0.f);
    }
  }
}

// One block a (group of input tiles, output tile): blockIdx.x = group *
// otiles + output tile. A thread owns a unit (V pairs) and the taps t = s +
// slices * k of its slice s. Per tile, the samples in order: sample n + 1's
// dW is copied to shared memory while sample n is summed, and the block's
// dg share of sample n - 1 is added up; one barrier a sample. Per sample n,
// red[(n % 2) * RED_BUF + (x * V + v) * BWD_THREADS + tid] holds the
// thread's share x of dg for pair e + v.
template <int V>
__global__ void __launch_bounds__(BWD_THREADS, 2)
    gate_merge_bwd_kernel(MergeArgs a, GradArgs b) {
  constexpr int UNITS = ELEMS / V, SL = BWD_THREADS / UNITS, KT = (T5 + SL - 1) / SL;
  extern __shared__ float sm[];
  float* d3 = sm + D3;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(sm + XS);
  const int tid = threadIdx.x, u = tid % UNITS, s = tid / UNITS, e = u * V;
  const int group = blockIdx.x / a.otiles;
  const int o0 = (blockIdx.x % a.otiles) * a.bo;
  const int pairs = a.bo * a.bi, o = o0 + e % a.bo;
  const int itiles = (a.ci + a.bi - 1) / a.bi;
  const int first = group * b.tiles_per_group;
  const int last = min(itiles, first + b.tiles_per_group);
  float* sdg = sm + SDG;

  // the block's share of dg for sample n of tile it: slices, then input
  // channels, in order, added to the group's share
  auto reduce = [&](int it, int n) {
    const float* red = sm + RED + (n % 2) * RED_BUF;
    for (int j = tid; j < 5 * a.bo; j += BWD_THREADS) {
      const int ex = j / a.bo, oj = j % a.bo;
      if (o0 + oj >= a.co) continue;
      float sum = 0.f;
      for (int ss = 0; ss < SL; ++ss)
        for (int ij = 0; ij < a.bi; ++ij) {
          const int ep = ij * a.bo + oj;
          sum += red[(ex * V + ep % V) * BWD_THREADS + ss * UNITS + ep / V];
        }
      float* out = sdg + (n * 5 + ex) * a.bo + oj;
      *out = it == first ? sum : *out + sum;
    }
  };

  for (int it = first; it < last; ++it) {
    const int i0 = it * a.bi, i = i0 + e / a.bo;
    const bool live = e < pairs && o < a.co && i < a.ci;
    __syncthreads();  // the last tile's stores have read the shared tile
    load_tile(a, o0, i0, sm);
    for (int j = tid; j < ELEMS * T3; j += BWD_THREADS) d3[j] = 0.f;
    stage_dw<V>(a, b, 0, o0, i0, xs);
    float dr[KT][V];  // dw5 of this unit at taps s + SL * k
#pragma unroll
    for (int k = 0; k < KT; ++k)
#pragma unroll
      for (int v = 0; v < V; ++v) dr[k][v] = 0.f;
    float acc1[V], acc3[V], acc5[V];  // dw1; sums of g3 and g4 times dW
#pragma unroll
    for (int v = 0; v < V; ++v) acc1[v] = acc3[v] = acc5[v] = 0.f;
    for (int n = 0; n < a.n; ++n) {
      if (V == 2) cp_async_wait_all();
      __syncthreads();  // sample n staged; sample n - 1's shares written
      if (n + 1 < a.n) stage_dw<V>(a, b, n + 1, o0, i0, xs + ((n + 1) % 2) * 2 * XS_BUF);
      if (n > 0) reduce(it, n - 1);
      const __nv_bfloat16* x = xs + (n % 2) * 2 * XS_BUF + e;
      // the gates of this sample, g[0] and g[1] now, the others where used
      const float* gn = a.g + (size_t)n * 5 * a.co + (live ? o : 0);
      float g[5][V];
      Vec<V>::load(gn, g[0]);
      Vec<V>::load(gn + a.co, g[1]);
      // this unit's share of dg[n, e, o] for e = 0..4
      float r0[V], r1[V], r2[V], q3[V], q5[V];
#pragma unroll
      for (int v = 0; v < V; ++v) r0[v] = r1[v] = r2[v] = q3[v] = q5[v] = 0.f;
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        const int t = s + SL * k;
        if (t >= T5) continue;
        const int c = central_index(t);
        float xv[V];
        Vec<V>::load(x + t * ELEMS, xv);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          r0[v] = fmaf(xv[v], sm[S5 + (e + v) * T5 + t], r0[v]);
          q5[v] += xv[v];
          dr[k][v] = fmaf(g[0][v], xv[v], dr[k][v]);
          if (c >= 0) {
            float* d = d3 + (e + v) * T3 + c;
            r1[v] = fmaf(xv[v], sm[S3 + (e + v) * T3 + c], r1[v]);
            q3[v] += xv[v];
            *d = fmaf(g[1][v], xv[v], *d);
            if (t == CENTRE) {
              Vec<V>::load(gn + 2 * a.co, g[2]);
              r2[v] = fmaf(xv[v], sm[SC + e + v], r2[v]);
              acc1[v] = fmaf(g[2][v], xv[v], acc1[v]);
            }
          }
        }
      }
      Vec<V>::load(gn + 3 * a.co, g[3]);
      Vec<V>::load(gn + 4 * a.co, g[4]);
      float* red = sm + RED + (n % 2) * RED_BUF;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        acc3[v] = fmaf(g[3][v], q3[v], acc3[v]);
        acc5[v] = fmaf(g[4][v], q5[v], acc5[v]);
        red[(0 * V + v) * BWD_THREADS + tid] = r0[v];
        red[(1 * V + v) * BWD_THREADS + tid] = r1[v];
        red[(2 * V + v) * BWD_THREADS + tid] = r2[v];
        red[(3 * V + v) * BWD_THREADS + tid] = q3[v] * sm[SC + ELEMS + e + v];
        red[(4 * V + v) * BWD_THREADS + tid] = q5[v] * sm[SC + 2 * ELEMS + e + v];
      }
    }
    __syncthreads();
    reduce(it, a.n - 1);
    // the tile's weight gradients, through shared memory to their layout;
    // the dg buffer no reduction reads now holds the pool experts' sums
    float* red = sm + RED + (a.n % 2) * RED_BUF;
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const int t = s + SL * k;
      if (t < T5) {
#pragma unroll
        for (int v = 0; v < V; ++v) sm[S5 + (e + v) * T5 + t] = dr[k][v];
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      red[(0 * V + v) * BWD_THREADS + tid] = acc3[v];
      red[(1 * V + v) * BWD_THREADS + tid] = acc5[v];
      if (live && s == CENTRE % SL) b.dw1[(size_t)(o + v) * a.ci + i] = acc1[v];
    }
    __syncthreads();
    for (int j = tid; j < pairs * T5; j += BWD_THREADS) {
      const int ej = j / T5, oj = o0 + ej % a.bo, ij = i0 + ej / a.bo;
      if (oj < a.co && ij < a.ci) b.dw5[((size_t)oj * a.ci + ij) * T5 + j % T5] = sm[S5 + j];
    }
    for (int j = tid; j < pairs * T3; j += BWD_THREADS) {
      const int ej = j / T3, oj = o0 + ej % a.bo, ij = i0 + ej / a.bo;
      if (oj < a.co && ij < a.ci) b.dw3[((size_t)oj * a.ci + ij) * T3 + j % T3] = d3[j];
    }
    if (live && s == 0) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float s3 = 0.f, s5 = 0.f;
        for (int ss = 0; ss < SL; ++ss) {
          s3 += red[(0 * V + v) * BWD_THREADS + ss * UNITS + u];
          s5 += red[(1 * V + v) * BWD_THREADS + ss * UNITS + u];
        }
        b.dwa3[(size_t)(o + v) * a.ci + i] = s3 * (1.0f / 27.0f);
        b.dwa5[(size_t)(o + v) * a.ci + i] = s5 * (1.0f / 125.0f);
      }
    }
  }
  // the group's share of dg, (n, 5, co)
  __syncthreads();
  float* dg = b.dg + (size_t)group * a.n * 5 * a.co;
  for (int j = tid; j < a.n * 5 * a.bo; j += BWD_THREADS) {
    const int oj = j % a.bo;
    if (o0 + oj < a.co) dg[(size_t)(j / a.bo) * a.co + o0 + oj] = sdg[j];
  }
}

// dg[j] = sum over groups k of part[k][j], in order k = 0, 1, ...
__global__ void gate_merge_bwd_gates_kernel(const float* __restrict__ part,
                                            float* __restrict__ dg, int total, int groups) {
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < total; j += gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int k = 0; k < groups; ++k) sum += part[(size_t)k * total + j];
    dg[j] = sum;
  }
}

constexpr size_t FWD_SMEM = sizeof(float) * TILE_FLOATS;
constexpr size_t MAX_SMEM = 227 * 1024;

bool fill_args(MergeArgs& a, const void* w5, const void* w3, const void* w1, const void* wa3,
               const void* wa5, const void* g, int n, int ci, int co, int bo, int bi) {
  if (n <= 0 || ci <= 0 || co <= 0 || bo <= 0 || bi <= 0 || bo > co || bo * bi > ELEMS ||
      (bo < co && bo != ELEMS)) {
    return false;
  }
  a.w5 = static_cast<const float*>(w5);
  a.w3 = static_cast<const float*>(w3);
  a.w1 = static_cast<const float*>(w1);
  a.wa3 = static_cast<const float*>(wa3);
  a.wa5 = static_cast<const float*>(wa5);
  a.g = static_cast<const float*>(g);
  a.n = n; a.ci = ci; a.co = co; a.bo = bo; a.bi = bi;
  a.otiles = (co + bo - 1) / bo;
  return true;
}

}  // namespace

extern "C" {

// The forward on `stream`: w5 (co, ci, 5, 5, 5), w3 (co, ci, 3, 3, 3), w1,
// wa3, wa5 (co, ci) fp32, all contiguous; g (n, 5, co) fp32; wn (n, 5, 5, 5,
// ci, co) bf16. Tiles of bo x bi (bo = co, or 64 with co above it; bo * bi
// <= 64). Returns the cudaError_t of the launch. Does not synchronize and
// allocates nothing.
int gate_merge_fwd_bf16(const void* w5, const void* w3, const void* w1, const void* wa3,
                        const void* wa5, const void* g, void* wn, int n, int ci, int co, int bo,
                        int bi, int samples_per_block, void* stream) {
  MergeArgs a;
  if (!fill_args(a, w5, w3, w1, wa3, wa5, g, n, ci, co, bo, bi) || samples_per_block <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = (long long)a.otiles * ((ci + bi - 1) / bi) *
                           ((n + samples_per_block - 1) / samples_per_block);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const auto kernel = co % 2 == 0 ? gate_merge_fwd_kernel<2> : gate_merge_fwd_kernel<1>;
  kernel<<<(unsigned)blocks, FWD_THREADS, FWD_SMEM, static_cast<cudaStream_t>(stream)>>>(
      a, samples_per_block, static_cast<__nv_bfloat16*>(wn));
  return (int)cudaGetLastError();
}

// The backward on `stream`: the forward's operands, dw (n, 5, 5, 5, ci, co)
// bf16 contiguous, and the fp32 outputs dw5, dw3, dw1, dwa3, dwa5 in the
// weights' layouts and dg (n, 5, co). `groups` blocks along the input
// channels, each over `tiles_per_group` consecutive input tiles; where
// groups > 1, work (groups, n, 5, co) fp32 takes their shares and a second
// kernel adds them into dg in order. Returns the cudaError_t of the launches.
// Does not synchronize and allocates nothing.
int gate_merge_bwd_bf16(const void* w5, const void* w3, const void* w1, const void* wa3,
                        const void* wa5, const void* g, const void* dw, void* dw5, void* dw3,
                        void* dw1, void* dwa3, void* dwa5, void* dg, void* work, int n, int ci,
                        int co, int bo, int bi, int tiles_per_group, int groups, void* stream) {
  MergeArgs a;
  if (!fill_args(a, w5, w3, w1, wa3, wa5, g, n, ci, co, bo, bi)) return (int)cudaErrorInvalidValue;
  const int itiles = (ci + bi - 1) / bi;
  if (tiles_per_group <= 0 || groups != (itiles + tiles_per_group - 1) / tiles_per_group ||
      (groups > 1 && work == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = (long long)a.otiles * groups;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  GradArgs b;
  b.dw = static_cast<const __nv_bfloat16*>(dw);
  b.dw5 = static_cast<float*>(dw5);
  b.dw3 = static_cast<float*>(dw3);
  b.dw1 = static_cast<float*>(dw1);
  b.dwa3 = static_cast<float*>(dwa3);
  b.dwa5 = static_cast<float*>(dwa5);
  b.dg = static_cast<float*>(groups > 1 ? work : dg);
  b.tiles_per_group = tiles_per_group;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = bwd_smem(n, bo);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const auto kernel = co % 8 == 0 ? gate_merge_bwd_kernel<2> : gate_merge_bwd_kernel<1>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, BWD_THREADS, smem, s>>>(a, b);
  err = cudaGetLastError();
  if (err != cudaSuccess || groups == 1) return (int)err;
  const int total = n * 5 * co;
  const int grid = (total + 255) / 256 < 132 * 8 ? (total + 255) / 256 : 132 * 8;
  gate_merge_bwd_gates_kernel<<<grid, 256, 0, s>>>(static_cast<const float*>(work),
                                                   static_cast<float*>(dg), total, groups);
  return (int)cudaGetLastError();
}

const char* gate_merge_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
