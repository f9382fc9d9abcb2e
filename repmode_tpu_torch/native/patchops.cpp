// Native host-side data ops of repmode_tpu_torch (the port's own copy of
// repmode_tpu/native/patchops.cpp; the two packages share no file).
//
// 1) crop_flip_batch: multithreaded random-crop + flip + batch assembly of
//    training patches from RAM-resident float32 volumes, the host hot path of
//    the training loop (the reference ran 10 DataLoader worker processes on
//    it, fnet/functions.py:53). It is a strided copy parallelized over batch
//    elements, called via ctypes with crop/flip decisions drawn in Python, so
//    the RNG protocol stays in data/sampler.py.
//
// 2) lzw_decode: TIFF-variant LZW for compressed CZI subblocks (ZISRAW
//    compression type 2). The reference relied on an optional third-party C
//    extension for this decode (aicsimage/io/czifile.py:122-133).
//
// Build: repmode_tpu_torch/native/__init__.py (g++ -O3 -std=c++17 -shared
// -fPIC -pthread, no -march: the library may run on another host than the
// one that built it).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

extern "C" {

// Copy one patch [start, start+patch) from a (D,H,W) volume into out,
// flipping the requested axes. Patch layout: (pd, ph, pw) contiguous.
static void copy_patch(const float* vol, const int64_t* vshape,
                       const int64_t* start, const uint8_t* flip,
                       float* out, int64_t pd, int64_t ph, int64_t pw) {
  const int64_t H = vshape[1], W = vshape[2];
  const int64_t sd = start[0], sh = start[1], sw = start[2];
  for (int64_t d = 0; d < pd; ++d) {
    const int64_t src_d = flip[0] ? (sd + pd - 1 - d) : (sd + d);
    for (int64_t h = 0; h < ph; ++h) {
      const int64_t src_h = flip[1] ? (sh + ph - 1 - h) : (sh + h);
      const float* row = vol + (src_d * H + src_h) * W;
      float* dst = out + (d * ph + h) * pw;
      if (!flip[2]) {
        std::memcpy(dst, row + sw, sizeof(float) * pw);
      } else {
        const float* src = row + sw + pw - 1;
        for (int64_t w = 0; w < pw; ++w) dst[w] = src[-w];
      }
    }
  }
}

// signals/targets: arrays of n pointers to (D,H,W) float32 volumes.
// shapes: n*3 int64; starts: n*3 int64; flips: n*3 uint8.
// out_*: n*pd*ph*pw float32 (contiguous batches).
void crop_flip_batch(const float** signals, const float** targets,
                     const int64_t* shapes, const int64_t* starts,
                     const uint8_t* flips, float* out_signal,
                     float* out_target, int64_t n, int64_t pd, int64_t ph,
                     int64_t pw, int32_t nthreads) {
  const int64_t patch = pd * ph * pw;
  if (nthreads <= 0) nthreads = 1;
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    int64_t i;
    while ((i = next.fetch_add(1)) < n) {
      copy_patch(signals[i], shapes + 3 * i, starts + 3 * i, flips + 3 * i,
                 out_signal + i * patch, pd, ph, pw);
      if (targets != nullptr && targets[i] != nullptr) {
        copy_patch(targets[i], shapes + 3 * i, starts + 3 * i, flips + 3 * i,
                   out_target + i * patch, pd, ph, pw);
      }
    }
  };
  if (nthreads == 1 || n == 1) {
    worker();
    return;
  }
  std::vector<std::thread> threads;
  const int32_t tcount = static_cast<int32_t>(
      std::min<int64_t>(nthreads, n));
  threads.reserve(tcount);
  for (int32_t t = 0; t < tcount; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// TIFF-variant LZW decode (MSB-first codes, 9->12 bits, clear=256, eoi=257,
// "early change": the code width bumps one code before the table fills).
// Returns the number of bytes written, or -1 on malformed input / overflow.
int64_t lzw_decode(const uint8_t* src, int64_t src_len, uint8_t* dst,
                   int64_t dst_cap) {
  constexpr int kClear = 256;
  constexpr int kEoi = 257;
  constexpr int kFirst = 258;
  constexpr int kMaxBits = 12;
  constexpr int kTableSize = 1 << kMaxBits;

  // table entries as (prefix, suffix); strings materialized on emit
  std::vector<int32_t> prefix(kTableSize, -1);
  std::vector<uint8_t> suffix(kTableSize, 0);
  std::vector<uint8_t> stack(kTableSize, 0);

  int next_code = kFirst;
  int code_bits = 9;
  int64_t bitpos = 0;
  const int64_t total_bits = src_len * 8;
  int64_t out = 0;
  int prev = -1;

  auto read_code = [&]() -> int {
    if (bitpos + code_bits > total_bits) return kEoi;
    int code = 0;
    for (int b = 0; b < code_bits; ++b) {
      const int64_t p = bitpos + b;
      code = (code << 1) | ((src[p >> 3] >> (7 - (p & 7))) & 1);
    }
    bitpos += code_bits;
    return code;
  };

  auto emit = [&](int code, int* first_byte) -> bool {
    int64_t sp = 0;
    while (code >= kFirst) {
      if (sp >= kTableSize || prefix[code] < 0) return false;
      stack[sp++] = suffix[code];
      code = prefix[code];
    }
    if (code < 0 || code >= 256) return false;
    *first_byte = code;
    if (out + sp + 1 > dst_cap) return false;
    dst[out++] = static_cast<uint8_t>(code);
    while (sp > 0) dst[out++] = stack[--sp];
    return true;
  };

  while (true) {
    int code = read_code();
    if (code == kEoi) break;
    if (code == kClear) {
      next_code = kFirst;
      code_bits = 9;
      prev = -1;
      continue;
    }
    int first = 0;
    if (prev < 0) {
      if (!emit(code, &first)) return -1;
    } else {
      if (code < next_code) {
        if (!emit(code, &first)) return -1;
      } else if (code == next_code) {
        // KwKwK case: emit prev string + its first byte
        int f0 = 0;
        int64_t mark = out;
        if (!emit(prev, &f0)) return -1;
        if (out + 1 > dst_cap) return -1;
        dst[out++] = static_cast<uint8_t>(f0);
        first = f0;
        (void)mark;
      } else {
        return -1;  // code beyond table
      }
      if (next_code < kTableSize) {
        prefix[next_code] = prev;
        suffix[next_code] = static_cast<uint8_t>(first);
        ++next_code;
      }
    }
    prev = code;
    // "Early change" (TIFF6 spec / libtiff): the decoder widens as soon as
    // the next free entry reaches (1<<bits)-1 -- one entry before the table
    // could actually address it. Verified empirically both directions against
    // libtiff (Pillow tiff_lzw) in tests/test_native.py::TestLZWOracle.
    if (next_code == (1 << code_bits) - 1 && code_bits < kMaxBits) {
      ++code_bits;
    }
  }
  return out;
}

}  // extern "C"
