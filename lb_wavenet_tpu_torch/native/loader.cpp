// Native host-side ingest and assembly tier of the port (its own copy of
// `lb_wavenet_tpu/native/loader.cpp`, byte-compatible in every entry point):
// RIFF/PCM16 parsing, mu-law encoding by table, and teacher-forcing window
// assembly, multithreaded and outside the GIL. No GPU is involved. The
// Python loader (data.py) stays the semantic oracle and the path for wavs
// that are not mono PCM16; tests/test_torch_native.py holds both against
// each other and against the JAX package's tier.
//
// Bit-exactness: mu-law encoding of PCM16 has a finite input domain (65536
// values), so Python builds the class table once with the port's torch
// encoder (ops/mulaw.py) and passes it in; the C++ encoder is a lookup,
// identical to the torch path by construction.
//
// Window semantics replicated exactly from ops/geometry.py:
//   num_windows(n)    = n < 2 ? 0 : ceil((n-1)/W)
//   t0 = 1 + wi*W ; t1 = min(t0 + W, n)
//   inputs[i]  = enc[in_start + i] if 0 <= in_start+i < n else 0,
//                in_start = t0 - R, length R-1+W
//   targets[k] = enc[t0+k] if t0+k < t1 else 0
//   mask[k]    = (t0+k < t1 && t0+k-R >= 0) ? 1.0f : 0.0f
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// RIFF/WAVE parsing (PCM16 little-endian; mono handled natively, other
// layouts return an error so Python falls back to the scipy path).
// ---------------------------------------------------------------------------

uint32_t rd_u32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

uint16_t rd_u16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0]) |
         (static_cast<uint16_t>(static_cast<uint16_t>(p[1]) << 8));
}

struct WavInfo {
  int64_t n_frames = 0;   // samples per channel
  int32_t sample_rate = 0;
  int32_t channels = 0;
  const uint8_t* data = nullptr;  // PCM16 payload
};

// Returns 0 on success, negative error code otherwise.
//   -1 malformed container   -2 not PCM16   -3 no data chunk
int parse_wav(const uint8_t* buf, int64_t n, WavInfo* out) {
  if (n < 12 || std::memcmp(buf, "RIFF", 4) != 0 ||
      std::memcmp(buf + 8, "WAVE", 4) != 0) {
    return -1;
  }
  int64_t pos = 12;
  bool have_fmt = false;
  uint16_t audio_format = 0, channels = 0, bits = 0;
  uint32_t sample_rate = 0;
  while (pos + 8 <= n) {
    const uint8_t* hdr = buf + pos;
    const uint32_t size = rd_u32(hdr + 4);
    const int64_t body = pos + 8;
    if (body + size > n) return -1;
    if (std::memcmp(hdr, "fmt ", 4) == 0) {
      if (size < 16) return -1;
      audio_format = rd_u16(buf + body);
      channels = rd_u16(buf + body + 2);
      sample_rate = rd_u32(buf + body + 4);
      bits = rd_u16(buf + body + 14);
      if (audio_format == 0xFFFE) {
        // WAVE_FORMAT_EXTENSIBLE: the real codec is the first two bytes of
        // the SubFormat GUID (fmt body offset 24). Anything but PCM(1) must
        // NOT be decoded as linear PCM — route to the Python fallback.
        if (size < 40) return -2;
        audio_format = rd_u16(buf + body + 24);
      }
      have_fmt = true;
    } else if (std::memcmp(hdr, "data", 4) == 0) {
      if (!have_fmt) return -1;
      if (audio_format != 1 || bits != 16) return -2;  // PCM16 only
      if (channels == 0) return -1;
      out->n_frames = static_cast<int64_t>(size) / (2 * channels);
      out->sample_rate = static_cast<int32_t>(sample_rate);
      out->channels = channels;
      out->data = buf + body;
      return 0;
    }
    pos = body + size + (size & 1);  // chunks are word-aligned
  }
  return -3;
}

void parallel_rows(int64_t rows, int n_threads,
                   const std::function<void(int64_t, int64_t)>& fn) {
  n_threads = std::max(1, std::min<int>(n_threads, rows));
  if (n_threads == 1) {
    fn(0, rows);
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(n_threads);
  const int64_t per = (rows + n_threads - 1) / n_threads;
  for (int i = 0; i < n_threads; ++i) {
    const int64_t lo = i * per;
    const int64_t hi = std::min(rows, lo + per);
    if (lo >= hi) break;
    ts.emplace_back(fn, lo, hi);
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// Parse a whole in-memory wav file; mu-law-encode via `lut` (65536 entries,
// index = int16 sample + 32768) and emit the float32 waveform (sample/32768,
// exactly data.load_wav's int16 branch). MONO PCM16 only — other layouts
// return an error and the caller falls back to the Python path.
//
// Returns n_frames >= 0 on success; negative parse error otherwise
// (-4 = unsupported channel count).
int64_t wavenet_ingest_wav(const uint8_t* buf, int64_t nbytes,
                           const int32_t* lut, int32_t* enc_out,
                           float* wav_out, int32_t* sample_rate_out) {
  WavInfo info;
  const int err = parse_wav(buf, nbytes, &info);
  if (err != 0) return err;
  if (info.channels != 1) return -4;
  *sample_rate_out = info.sample_rate;
  const int64_t n = info.n_frames;
  const uint8_t* p = info.data;
  for (int64_t i = 0; i < n; ++i) {
    const int16_t s = static_cast<int16_t>(rd_u16(p + 2 * i));
    enc_out[i] = lut[static_cast<int32_t>(s) + 32768];
    wav_out[i] = static_cast<float>(s) / 32768.0f;
  }
  return n;
}

// Assemble a batch of teacher-forcing windows from a packed corpus.
//   enc:      concatenated mu-law classes of all files (int32 or uint8 —
//             the uint8 form is the on-disk pack layout for Q <= 256, read
//             straight from the mmap and widened here)
//   offsets:  F+1 prefix offsets into enc (offsets[f]..offsets[f+1])
//   n_files:  F (bounds-checks the fi indices)
//   fis/wis:  B (file, window) pairs
//   inputs:   int32  [B, R-1+W]
//   targets:  int32  [B, W]
//   mask:     float32[B, W]
// Returns 0, or -(row+1) for the first row whose (fi, wi) pair is out of
// range (fi outside [0, F) or wi >= num_windows(file_len, w)) — unchecked,
// a bad wi would make t1 - t0 negative and memcpy a huge size_t.
}  // extern "C" (templates cannot carry C linkage; reopened below)

namespace {

template <typename T>
void copy_widen(int32_t* dst, const T* src, int64_t n) {
  if constexpr (sizeof(T) == sizeof(int32_t)) {
    std::memcpy(dst, src, n * sizeof(int32_t));
  } else {
    for (int64_t i = 0; i < n; ++i) dst[i] = static_cast<int32_t>(src[i]);
  }
}

template <typename T>
int64_t assemble_impl(const T* enc, const int64_t* offsets, int64_t n_files,
                      const int32_t* fis, const int32_t* wis, int64_t b,
                      int64_t w, int64_t r, int32_t* inputs, int32_t* targets,
                      float* mask, int32_t n_threads) {
  const int64_t in_len = r - 1 + w;
  std::atomic<int64_t> bad_row(-1);
  parallel_rows(b, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t row = lo; row < hi; ++row) {
      const int64_t fi = fis[row];
      const int64_t wi = wis[row];
      if (fi < 0 || fi >= n_files) {
        bad_row.store(row);
        return;
      }
      const int64_t file_len = offsets[fi + 1] - offsets[fi];
      // num_windows: 0 for file_len < 2, else ceil((file_len - 1) / w).
      const int64_t n_windows =
          file_len < 2 ? 0 : (file_len - 1 + w - 1) / w;
      if (wi < 0 || wi >= n_windows) {
        bad_row.store(row);
        return;
      }
      const T* file = enc + offsets[fi];
      const int64_t n = file_len;
      const int64_t t0 = 1 + wi * w;
      const int64_t t1 = std::min(t0 + w, n);
      const int64_t in_start = t0 - r;
      int32_t* in_row = inputs + row * in_len;
      // inputs: [in_start, in_start + in_len), zero outside [0, n)
      const int64_t lo_i = std::clamp<int64_t>(-in_start, 0, in_len);
      const int64_t hi_i = std::clamp<int64_t>(n - in_start, 0, in_len);
      std::fill(in_row, in_row + lo_i, 0);
      if (hi_i > lo_i) {
        copy_widen(in_row + lo_i, file + in_start + lo_i, hi_i - lo_i);
      }
      std::fill(in_row + hi_i, in_row + in_len, 0);
      // targets + mask over [t0, t0 + w)
      int32_t* tg_row = targets + row * w;
      float* mk_row = mask + row * w;
      const int64_t n_real = t1 - t0;  // >= 1 by num_windows construction
      copy_widen(tg_row, file + t0, n_real);
      std::fill(tg_row + n_real, tg_row + w, 0);
      // mask: real target AND full receptive field inside the file
      // (t - r >= 0  <=>  k >= r - t0).
      const int64_t full_from = std::clamp<int64_t>(r - t0, 0, w);
      std::fill(mk_row, mk_row + std::min(full_from, n_real), 0.0f);
      std::fill(mk_row + std::min(full_from, n_real), mk_row + n_real, 1.0f);
      std::fill(mk_row + n_real, mk_row + w, 0.0f);
    }
  });
  const int64_t bad = bad_row.load();
  return bad < 0 ? 0 : -(bad + 1);
}

// Out-of-core variant: windows are READ from the pack file with pread(2)
// instead of faulted through a mapping: mmap fault-around pulls hundreds of
// KB of residency per touched window even under MADV_RANDOM, so a
// random-permutation epoch over a large pack would inflate process RSS
// toward the file size. pread copies exactly the window span into a
// per-thread scratch buffer; the data still rides the (evictable,
// kernel-side) page cache, but process RSS stays O(batch).
template <typename T>
int64_t assemble_fd_impl(int fd, int64_t enc_byte_pos, const int64_t* offsets,
                         int64_t n_files, const int32_t* fis,
                         const int32_t* wis, int64_t b, int64_t w, int64_t r,
                         int32_t* inputs, int32_t* targets, float* mask,
                         int32_t n_threads) {
  const int64_t in_len = r - 1 + w;
  std::atomic<int64_t> bad_row(-1);   // index arguments out of range
  std::atomic<int64_t> io_fail(0);    // short/failed pread
  parallel_rows(b, n_threads, [&](int64_t lo, int64_t hi) {
    std::vector<T> buf(static_cast<size_t>(in_len) + 1);
    for (int64_t row = lo; row < hi; ++row) {
      const int64_t fi = fis[row];
      const int64_t wi = wis[row];
      if (fi < 0 || fi >= n_files) {
        bad_row.store(row);
        return;
      }
      const int64_t file_len = offsets[fi + 1] - offsets[fi];
      const int64_t n_windows =
          file_len < 2 ? 0 : (file_len - 1 + w - 1) / w;
      if (wi < 0 || wi >= n_windows) {
        bad_row.store(row);
        return;
      }
      const int64_t n = file_len;
      const int64_t t0 = 1 + wi * w;
      const int64_t t1 = std::min(t0 + w, n);
      const int64_t in_start = t0 - r;
      const int64_t lo_i = std::clamp<int64_t>(-in_start, 0, in_len);
      const int64_t hi_i = std::clamp<int64_t>(n - in_start, 0, in_len);
      // One read covers both inputs [in_start+lo_i, in_start+hi_i) and
      // targets [t0, t1): targets ⊆ [in_start, in_start+in_len] ∩ [0, n)
      // plus possibly the one sample past the last input (t1 - 1 ==
      // in_start + in_len when the window is full) — hence buf in_len + 1.
      const int64_t span_lo = std::min<int64_t>(in_start + lo_i, t0);
      const int64_t span_hi = std::max<int64_t>(in_start + hi_i, t1);
      const int64_t span = span_hi - span_lo;  // <= in_len + 1
      const int64_t byte_off =
          enc_byte_pos +
          static_cast<int64_t>(sizeof(T)) * (offsets[fi] + span_lo);
      int64_t got = 0;
      const int64_t want = span * static_cast<int64_t>(sizeof(T));
      char* dst = reinterpret_cast<char*>(buf.data());
      while (got < want) {
        const ssize_t k = pread(fd, dst + got, want - got, byte_off + got);
        if (k <= 0) {
          io_fail.store(1);
          return;
        }
        got += k;
      }
      const T* file = buf.data() - span_lo;  // index with file-local t
      int32_t* in_row = inputs + row * in_len;
      std::fill(in_row, in_row + lo_i, 0);
      if (hi_i > lo_i) {
        copy_widen(in_row + lo_i, file + in_start + lo_i, hi_i - lo_i);
      }
      std::fill(in_row + hi_i, in_row + in_len, 0);
      int32_t* tg_row = targets + row * w;
      float* mk_row = mask + row * w;
      const int64_t n_real = t1 - t0;
      copy_widen(tg_row, file + t0, n_real);
      std::fill(tg_row + n_real, tg_row + w, 0);
      const int64_t full_from = std::clamp<int64_t>(r - t0, 0, w);
      std::fill(mk_row, mk_row + std::min(full_from, n_real), 0.0f);
      std::fill(mk_row + std::min(full_from, n_real), mk_row + n_real, 1.0f);
      std::fill(mk_row + n_real, mk_row + w, 0.0f);
    }
  });
  if (io_fail.load()) return INT64_MIN;  // distinct from -(row+1)
  const int64_t bad = bad_row.load();
  return bad < 0 ? 0 : -(bad + 1);
}

}  // namespace

extern "C" {

int64_t wavenet_assemble(const int32_t* enc, const int64_t* offsets,
                         int64_t n_files, const int32_t* fis,
                         const int32_t* wis, int64_t b, int64_t w, int64_t r,
                         int32_t* inputs, int32_t* targets, float* mask,
                         int32_t n_threads) {
  return assemble_impl<int32_t>(enc, offsets, n_files, fis, wis, b, w, r,
                                inputs, targets, mask, n_threads);
}

int64_t wavenet_assemble_u8(const uint8_t* enc, const int64_t* offsets,
                            int64_t n_files, const int32_t* fis,
                            const int32_t* wis, int64_t b, int64_t w,
                            int64_t r, int32_t* inputs, int32_t* targets,
                            float* mask, int32_t n_threads) {
  return assemble_impl<uint8_t>(enc, offsets, n_files, fis, wis, b, w, r,
                                inputs, targets, mask, n_threads);
}

// pread-based out-of-core assemblers (packed-corpus files). `itemsize`
// selects the on-disk class width (1 = uint8 pack, 4 = int32 pack);
// `enc_byte_pos` is the byte position of the enc section. Returns
// INT64_MIN on I/O failure, else the wavenet_assemble contract.
int64_t wavenet_assemble_fd(int32_t fd, int64_t enc_byte_pos,
                            int32_t itemsize, const int64_t* offsets,
                            int64_t n_files, const int32_t* fis,
                            const int32_t* wis, int64_t b, int64_t w,
                            int64_t r, int32_t* inputs, int32_t* targets,
                            float* mask, int32_t n_threads) {
  if (itemsize == 1) {
    return assemble_fd_impl<uint8_t>(fd, enc_byte_pos, offsets, n_files, fis,
                                     wis, b, w, r, inputs, targets, mask,
                                     n_threads);
  }
  if (itemsize == 4) {
    return assemble_fd_impl<int32_t>(fd, enc_byte_pos, offsets, n_files, fis,
                                     wis, b, w, r, inputs, targets, mask,
                                     n_threads);
  }
  return INT64_MIN;
}

}  // extern "C"
