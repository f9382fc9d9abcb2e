// Device helpers shared by the implicit-GEMM conv kernels of the port
// (conv3d_same.cu, conv3d_persample.cu, conv3d_dpad.cu, conv3d_tapconcat.cu)
// and the per-sample weight gradient (conv3d_dw_persample.cu), for Hopper
// (sm_90a):
//
//   * the mma.sync path: cp.async copies, ldmatrix, bf16 mma.m16n8k16;
//   * the warpgroup-MMA path: wgmma fences and groups, the mbarriers that
//     tensor copies complete on, the tensor memory accelerator (TMA) loads
//     and stores (and the bulk groups a store completes in), the proxy fence
//     between shared-memory writes of threads and reads of wgmma or TMA,
//     shared-memory matrix descriptors and the m64n{32,64,128}k16 bf16 wgmma
//     with both operands in shared memory, each K-major or MN-major;
//   * one block of the warpgroup-MMA conv whose weights come in place from a
//     tensor map (wgmma_conv_block): the wide instance of conv3d_persample.cu
//     (K2/K3) and of conv3d_dpad.cu (K5), each a thin kernel around it;
//   * the tensor-map encoder, fetched through the runtime API (no -lcuda),
//     and the maps of an NDHWC activation (loads, and stores of an output
//     tile) and of conv weights read in place.
//
// A source that includes this file is rebuilt when it changes: the kernel
// builder (ops/kernels/build.py) hashes every local header a source includes.

#pragma once

#include <cuda.h>          // CUtensorMap (its encoder is fetched at run time)
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mma.sync

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

// 8 bytes (a position of a 4-lane bf16 input); zero-filled when src_bytes is 0.
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
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

// ---------------------------------------------------------------- warpgroup MMA

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// mbarrier of one ring buffer: the tensor copies of a stage complete on it.
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits for the phase of `parity` to complete; traps (a launch error)
// rather than hang if it never does.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (long long i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (i > (1ll << 26)) __trap();
  }
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// Makes this thread's writes to shared memory (st.shared, cp.async) visible
// to the async proxy: to wgmma reading them as an operand and to a TMA store
// reading them as its source. A barrier after it publishes them to the
// thread that issues the read.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// TMA store of one box from shared memory (`src`, in the map's swizzle) to
// the tensor at coordinates c0..c4; the tensor copy clips what lies past its
// extents. Completes in this thread's current bulk group.
__device__ __forceinline__ void tma_store_5d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5, %6}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's bulk groups still read their
// shared-memory source (their writes to global memory may still be going).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Waits until at most N of this thread's bulk groups are incomplete.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of an accumulator register across
// the wgmma waits (it does not know that wgmma writes them asynchronously).
template <int NACC>
__device__ __forceinline__ void fence_accumulators(float (&d)[NACC]) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a K-major operand in a swizzled layout:
// start address, leading byte offset (unused by swizzled K-major layouts: 1),
// stride byte offset (between 8-row groups), swizzle mode (bits 62-63: 1 =
// 128-byte, 2 = 64-byte, 3 = 32-byte).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t sbo_bytes,
                                              uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(sbo_bytes >> 4) << 32) | (layout << 62);
}

// Shared-memory matrix descriptor of an MN-major operand in a swizzled
// layout (read with the transpose immediate of wgmma): each swizzle atom
// holds 8 K-rows of (swizzle width) contiguous bytes along N. The leading
// byte offset is the stride between atoms along N, the stride byte offset
// that between groups of 8 K-rows (the PTX ISA's canonical MN-major layouts:
// ((T,S,m),(8,k)) : ((1,T,LBO),(S*T,SBO)) for a swizzle of S*16 bytes).
__device__ __forceinline__ uint64_t smem_desc_mn(uint32_t addr, uint32_t lbo_bytes,
                                                 uint32_t sbo_bytes, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo_bytes >> 4) << 16) |
         ((uint64_t)(sbo_bytes >> 4) << 32) | (layout << 62);
}

// Shared-memory descriptor of an operand in a no-swizzle layout: core
// matrices of 128 contiguous bytes, `lbo` bytes apart along K and `sbo`
// bytes apart along M (or N). K-major (A of the convs: 8 positions x 16
// bytes of channels) or MN-major, read with wgmma's transpose immediate
// (A and B of the weight gradient: 8 K-rows x 16 bytes along M or N); the
// PTX ISA's canonical layouts ((8,m),(T,2k)) : ((1T,SBO),(1,LBO)) and
// ((T,1,m),(8,k)) : ((1,T,SBO),(1T,LBO)) put the K stride in the leading
// byte offset in both.
__device__ __forceinline__ uint64_t smem_desc_a(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// D (64 x N, fp32) += A (64 x 16, bf16) * B (16 x N, bf16), both in shared
// memory; A K-major (TRANS_A = 0) or MN-major (TRANS_A = 1), B K-major
// (TRANS_B = 0) or MN-major (TRANS_B = 1).
template <int TRANS_B = 0, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %20, %19;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_B), "n"(TRANS_A)
      : "memory");
}

template <int TRANS_B = 0, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %36, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_B), "n"(TRANS_A)
      : "memory");
}

template <int TRANS_B = 0, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %68, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_B), "n"(TRANS_A)
      : "memory");
}

// ---------------------------------------------------------------- the wgmma conv block

constexpr int SWIZZLE_ALIGN = 1024;  // the 128-byte swizzle repeats every 8 rows of 128 bytes

// The output tile of one block of an implicit-GEMM conv: sample, depth row,
// first row and column, rows and columns inside the volume, first output
// channel, and the sample coordinate of the block's weights in their tensor
// map (its own sample for per-sample kernels, 0 for shared ones).
struct ConvTile {
  int nn, dd, h0, w0, rows, twv, co0, wn;
};

// Tile geometry of the wgmma conv block for a plane of h x wl positions, BM
// = 64 * wgs * mt output positions a block, kw taps along W: m64 tiles of
// one 64-position row segment where W >= 64 (tile rows up to 128 columns: a
// tensor-copy box spans at most 256), else of 8 rows x 8 columns, one a
// warpgroup (mt must be 1). Sets p.patch, tw, rows_per_tile, tiles_per_row,
// tiles_per_plane, pitch and slab_cap; false for a tile it has no geometry
// for.
template <class P>
bool wgmma_conv_geometry(P& p, int h, int wl, int kw, int wgs, int mt) {
  const int bm = 64 * wgs * mt;
  if (wl >= 64) {  // row mode: each m64 tile is 64 positions of one row
    p.patch = 0;
    p.tw = 64;
    while (p.tw * 2 <= bm && p.tw * 2 <= wl && p.tw < 128) p.tw *= 2;
    p.rows_per_tile = bm / p.tw;
  } else {  // patch mode: each m64 tile is 8 rows x 8 columns
    if (mt != 1) return false;
    p.patch = 1;
    p.rows_per_tile = 8;
    p.tw = 8 * wgs;
  }
  p.tiles_per_row = (wl + p.tw - 1) / p.tw;
  p.tiles_per_plane = (h + p.rows_per_tile - 1) / p.rows_per_tile * p.tiles_per_row;
  p.pitch = p.tw + kw - 1;
  p.slab_cap = p.rows_per_tile * p.pitch;
  return true;
}

// Dynamic shared bytes of the wgmma conv block: a ring of `stages` buffers,
// each the kW weight tiles of a stage and the slab, its channel chunks
// 128-byte aligned, plus the slack that aligns the weights to the swizzle.
inline size_t wgmma_conv_smem(int slab_cap, int kw, int kc, int bn, int stages) {
  const size_t slab = (size_t)(slab_cap + 7) / 8 * 8;
  return (size_t)stages * ((size_t)kw * bn * kc * 2 + slab * kc * 2) + SWIZZLE_ALIGN;
}

// One block of the warpgroup-MMA implicit-GEMM conv
//
//     y[t] = store( sum over taps and Ci of x[position + tap - c] * w[wn, tap] )
//
// over the output tile t: WG warpgroups of MT m64 tiles (BM = 64 * WG * MT
// positions of one (n, d) plane), BN output channels, KC contraction
// channels a stage. The stages walk (dz, dy, channel chunk), skipping depth
// taps outside the volume; tap dx reads the same slab dx positions later.
//   * A: the slab of x, one TMA box (rows x pitch positions x 8 channels)
//     per channel chunk from the 5-D map tmx over (C, W, H, D, N), zero past
//     every edge, chunk-major, read through the no-swizzle K-major
//     descriptor: an m64 tile is a 64-position row segment, or 8 x 8
//     positions in patch mode.
//   * B: w read in place through the 4-D map tmw over (Co, Ci, T, samples)
//     at sample t.wn; a stage loads the kW taps of one (dz, dy).
//       TRANS: the contraction axis (w's Co) is contiguous, so B is
//       K-major: a box of KC x BN x kW in the KC*2-byte swizzle, the taps
//       reversed (the kW consecutive taps ending at T-1-tap0; tap dx in slot
//       kW-1-dx).
//       forward: Co is contiguous, so B is MN-major and read with wgmma's
//       transpose-B immediate: a box of min(BN, 64) Co x KC x kW in the
//       (min(BN, 64)*2)-byte swizzle; BN = 128 takes two boxes, one swizzle
//       atom each, the descriptor's leading byte offset apart.
//   * One thread loads each stage onto the mbarrier of its buffer in a ring
//     of S = p.stages (3 or 4) buffers, filled S - 2 stages ahead.
//   * store(yr, co, v0, v1) writes output channels co and co + 1 of the
//     position whose channel 0 is at yr, from their fp32 sums.
// KW: the taps along W where the source fixes them (the dx loop is then
// unrolled: a loop over p.kw at run time makes ptxas wait on the wgmmas at
// its back edge), else 0. P is the source's parameter struct: the block
// reads its d, h, w, cin, cout, kd, kh, kw, tw, pitch, patch, slab_cap,
// stages and y.
template <int WG, int MT, int KC, int BN, bool TRANS, int KW, class P, class Store>
__device__ __forceinline__ void wgmma_conv_block(const P& p, const CUtensorMap* tmx,
                                                 const CUtensorMap* tmw, const ConvTile& t,
                                                 Store store) {
  constexpr int SEGS = KC / 8;    // 8-channel chunks a stage
  constexpr int KSTEPS = KC / 16;
  constexpr int NACC = BN / 2;
  // a row of B in shared memory: transposed, one output channel's KC
  // contraction channels (K-major); forward, one contraction channel's BA
  // output channels, one swizzle atom of BA columns (MN-major)
  constexpr int BA = BN < 64 ? BN : 64;
  constexpr int RB = TRANS ? KC * 2 : BA * 2;
  constexpr uint64_t LAYOUT = RB == 128 ? 1 : (RB == 64 ? 2 : 3);
  constexpr uint32_t SBO_B = 8 * RB;  // between groups of 8 rows
  const int kw = KW > 0 ? KW : p.kw;

  extern __shared__ __align__(16) unsigned char smem[];
  // weight tiles first, at a 1024-byte boundary (the swizzle pattern is a
  // function of the address), then the chunk-major slabs: 16 bytes a
  // (8-channel chunk, position), so 8 consecutive positions of a chunk are
  // one core matrix of A; a chunk starts 128-byte aligned, as a tensor
  // copy's destination must
  const uint32_t b_base = (smem_u32(smem) + SWIZZLE_ALIGN - 1) & ~(uint32_t)(SWIZZLE_ALIGN - 1);
  const uint32_t b_stage = (uint32_t)kw * BN * KC * 2;
  const uint32_t b_atom = (uint32_t)kw * KC * RB;  // forward: the box of one swizzle atom
  const uint32_t a_chunk = ((uint32_t)p.slab_cap * 16 + 127) & ~127u;
  const uint32_t a_stage = a_chunk * SEGS;
  const uint32_t a_base = b_base + p.stages * b_stage;
  __shared__ __align__(8) uint64_t bar_mem[4];  // one mbarrier a ring buffer
  const uint32_t bars = smem_u32(bar_mem);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;
  const int wl = (tid >> 5) & 3;  // warp within the warpgroup: rows 16 wl .. +15 of each m64

  const int taps = p.kd * p.kh * kw;
  const int pd = (p.kd - 1) / 2, ph = (p.kh - 1) / 2, pw = (kw - 1) / 2;
  const int dz_lo = max(0, pd - t.dd);
  const int dz_hi = min(p.kd, p.d - t.dd + pd);
  const int nchunks = (p.cin + KC - 1) / KC;
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
  // every edge), and the kW taps of this (dz, dy) of the weights, written
  // in wgmma's swizzled layout (zero past Ci and Co). All complete on the
  // buffer's mbarrier.
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
      tma_load_5d(a_base + buf * a_stage + k * a_chunk, tmx, bar, ci0 + k * 8, t.w0 - pw,
                  t.h0 + dy - ph, t.dd + dz - pd, t.nn);
    }
    const int tap0 = (dz * p.kh + dy) * kw;
    const uint32_t bt = b_base + buf * b_stage;
    if (TRANS) {
      // the reversed taps T-1-tap0-dx are the kW consecutive taps ending
      // at T-1-tap0: tap dx lands in slot kW-1-dx
      tma_load_4d(bt, tmw, bar, ci0, t.co0, taps - tap0 - kw, t.wn);
    } else {
#pragma unroll
      for (int j = 0; j < BN / BA; ++j) {
        tma_load_4d(bt + j * b_atom, tmw, bar, t.co0 + j * BA, ci0, tap0, t.wn);
      }
    }
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
    auto mma_tap = [&](int dx) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const uint64_t db =
            TRANS ? smem_desc(bt + (kw - 1 - dx) * BN * RB + kk * 32, SBO_B, LAYOUT)
                  : smem_desc_mn(bt + (dx * KC + kk * 16) * RB, b_atom, SBO_B, LAYOUT);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          wgmma_ss<TRANS ? 0 : 1>(
              acc[i], smem_desc_a(at + a_off[i] + dx * 16 + kk * 2 * a_chunk, a_chunk, sbo_a), db);
        }
      }
    };
    wgmma_fence();
    if constexpr (KW > 0) {
#pragma unroll
      for (int dx = 0; dx < KW; ++dx) mma_tap(dx);
    } else {
      for (int dx = 0; dx < p.kw; ++dx) mma_tap(dx);
    }
    wgmma_commit();
    wgmma_wait<1>();
    buf = buf + 1 == S ? 0 : buf + 1;
    next_buf = next_buf + 1 == S ? 0 : next_buf + 1;
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < MT; ++i) fence_accumulators(acc[i]);

  // ---- epilogue ----
  // accumulator 4j + 2h + e of lane l in warp wl: row 16 wl + l/4 + 8h of
  // the m64 tile, column 8j + 2(l%4) + e (the mma.m16n8k16 C fragment, once
  // per 8 columns)
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
      if (r >= t.rows || c >= t.twv) continue;
      __nv_bfloat16* yr =
          p.y + ((((long long)t.nn * p.d + t.dd) * p.h + t.h0 + r) * p.w + t.w0 + c) * p.cout;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        store(yr, t.co0 + j * 8 + (lane & 3) * 2, acc[i][j * 4 + half * 2],
              acc[i][j * 4 + half * 2 + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------- host

// cuTensorMapEncodeTiled, fetched once through the runtime API, so a library
// needs no link flag beyond nvcc's defaults; nullptr if it cannot be fetched.
inline PFN_cuTensorMapEncodeTiled tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
  }
  return encode;
}

// The map of an NDHWC bf16 activation as (C, W, H, D, N) in boxes of 8
// channels x `pitch` columns x `rows` rows, zero past every edge: one box a
// channel chunk of an implicit-GEMM slab.
inline bool encode_activation_map(CUtensorMap* map, const void* x, int n, int d, int h, int w,
                                  int c, int pitch, int rows) {
  const PFN_cuTensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t e = 2;  // bytes a bf16
  const cuuint64_t xd[5] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)d,
                            (cuuint64_t)n};
  const cuuint64_t xs[4] = {xd[0] * e, xd[0] * xd[1] * e, xd[0] * xd[1] * xd[2] * e,
                            xd[0] * xd[1] * xd[2] * xd[3] * e};
  const cuuint32_t xb[5] = {8, (cuuint32_t)pitch, (cuuint32_t)rows, 1, 1};
  const cuuint32_t one[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x), xd, xs, xb, one,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The swizzle mode of a TMA box whose inner extent is `bytes` (32, 64, 128).
inline CUtensorMapSwizzle swizzle_of(int bytes) {
  return bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
         : bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                       : CU_TENSOR_MAP_SWIZZLE_32B;
}

// The map of an NDHWC bf16 output as (C, W, H, D, N) in boxes of `inner`
// channels x `cols` columns x `rows` rows, in the (inner * 2)-byte swizzle:
// one box the staged tile of one swizzle atom of channels, stored by TMA
// (clipped past every edge).
inline bool encode_output_map(CUtensorMap* map, void* y, int n, int d, int h, int w, int c,
                              int inner, int cols, int rows) {
  const PFN_cuTensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t e = 2;  // bytes a bf16
  const cuuint64_t yd[5] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)d,
                            (cuuint64_t)n};
  const cuuint64_t ys[4] = {yd[0] * e, yd[0] * yd[1] * e, yd[0] * yd[1] * yd[2] * e,
                            yd[0] * yd[1] * yd[2] * yd[3] * e};
  const cuuint32_t yb[5] = {(cuuint32_t)inner, (cuuint32_t)cols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t one[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, y, yd, ys, yb, one,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(inner * 2),
                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The map of bf16 conv weights (samples, taps, wci, wco), read in place as
// (wco, wci, taps, samples) over their true extents (zero past them), in
// boxes of inner x outer x kw x 1 written in the (inner * 2)-byte swizzle:
// one box the kW taps of one (dz, dy) of a sample, inner along wco.
inline bool encode_weight_map(CUtensorMap* map, const void* w, int samples, int taps, int wci,
                              int wco, int inner, int outer, int kw) {
  const PFN_cuTensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t e = 2;  // bytes a bf16
  const cuuint64_t wd[4] = {(cuuint64_t)wco, (cuuint64_t)wci, (cuuint64_t)taps,
                            (cuuint64_t)samples};
  const cuuint64_t ws[3] = {wd[0] * e, wd[0] * wd[1] * e, wd[0] * wd[1] * wd[2] * e};
  const cuuint32_t wb[4] = {(cuuint32_t)inner, (cuuint32_t)outer, (cuuint32_t)kw, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(w), wd, ws, wb, one,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(inner * 2),
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
