// Native audio data loader: multithreaded WAV decode + mono downmix +
// zero-mean/unit-variance normalization, writing straight into the
// caller's batch buffer.
//
// This is the runtime equivalent of the reference's dependency-level
// native IO (HF `datasets` Audio decoding via libsndfile,
// the reference's utils/generate_dataset.py:159 Audio(sampling_rate=16k))
// — the reference has no first-party native code, its
// loader speed comes from C libraries under datasets/soundfile. Here the
// hot collate-time load (mtasr_tpu_torch/data/pipeline.py::collate
// materializing lazy examples) is one C call that decodes a whole batch
// in parallel.
//
// Scope: RIFF/WAVE with PCM 8/16/24/32-bit and IEEE float32, mono or
// multi-channel (downmixed by mean, matching
// mtasr_tpu_torch/data/audio.py::read_wav).
// Files whose sample rate differs from target_sr are reported (status=2)
// and the caller falls back to the Python resample path (scipy polyphase
// — not worth re-implementing bit-exactly in C++ for the rare
// non-16 kHz file).
//
// Exposed C ABI (ctypes-friendly, see mtasr_tpu_torch/utils/native.py):
//   wav_header(path, *n_frames, *sr, *channels) -> 0 ok / <0 error
//   wav_load_batch(paths, path_off, B, target_sr, normalize,
//                  out[B*cap], cap, lens[B], status[B], n_threads)
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct WavInfo {
  uint16_t format = 0;     // 1=PCM, 3=IEEE float (possibly via EXTENSIBLE)
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
  int64_t data_off = -1;   // byte offset of sample data
  int64_t data_len = 0;    // bytes of sample data
};

bool read_u32(FILE* f, uint32_t* v) {
  unsigned char b[4];
  if (fread(b, 1, 4, f) != 4) return false;
  *v = (uint32_t)b[0] | ((uint32_t)b[1] << 8) | ((uint32_t)b[2] << 16) |
       ((uint32_t)b[3] << 24);
  return true;
}

// Parses the RIFF chunk list; returns 0 on success.
int parse_wav(FILE* f, WavInfo* info) {
  char tag[4];
  uint32_t riff_len;
  if (fread(tag, 1, 4, f) != 4 || memcmp(tag, "RIFF", 4) != 0) return -2;
  if (!read_u32(f, &riff_len)) return -2;
  if (fread(tag, 1, 4, f) != 4 || memcmp(tag, "WAVE", 4) != 0) return -2;
  while (fread(tag, 1, 4, f) == 4) {
    uint32_t chunk_len;
    if (!read_u32(f, &chunk_len)) return -2;
    if (memcmp(tag, "fmt ", 4) == 0) {
      unsigned char fmt[40];
      size_t want = chunk_len < sizeof(fmt) ? chunk_len : sizeof(fmt);
      if (fread(fmt, 1, want, f) != want) return -2;
      if (want < 16) return -2;
      info->format = (uint16_t)(fmt[0] | (fmt[1] << 8));
      info->channels = (uint16_t)(fmt[2] | (fmt[3] << 8));
      info->sample_rate = (uint32_t)fmt[4] | ((uint32_t)fmt[5] << 8) |
                          ((uint32_t)fmt[6] << 16) | ((uint32_t)fmt[7] << 24);
      info->bits = (uint16_t)(fmt[14] | (fmt[15] << 8));
      if (info->format == 0xFFFE && want >= 26) {
        // WAVE_FORMAT_EXTENSIBLE: real format = first 2 bytes of SubFormat
        info->format = (uint16_t)(fmt[24] | (fmt[25] << 8));
      }
      if (chunk_len > want &&
          fseek(f, (long)(chunk_len - want), SEEK_CUR) != 0)
        return -2;
    } else if (memcmp(tag, "data", 4) == 0) {
      info->data_off = ftell(f);
      info->data_len = chunk_len;
      // keep scanning is unnecessary; fmt normally precedes data
      if (info->format != 0) return 0;
      if (fseek(f, (long)chunk_len, SEEK_CUR) != 0) return -2;
    } else {
      // chunks are word-aligned
      long skip = (long)chunk_len + (chunk_len & 1);
      if (fseek(f, skip, SEEK_CUR) != 0) return -2;
    }
  }
  return (info->format != 0 && info->data_off >= 0) ? 0 : -2;
}

// Per-format sample converters, specialized so the mono fast paths below
// compile to tight auto-vectorized loops (little-endian hosts assumed,
// matching numpy '<i2' in mtasr_tpu_torch/data/audio.py).
inline float cvt_pcm16(const unsigned char* p) {
  int16_t s;
  memcpy(&s, p, 2);
  return (float)s * (1.0f / 32768.0f);
}
inline float cvt_pcm32(const unsigned char* p) {
  int32_t s;
  memcpy(&s, p, 4);
  return (float)s * (1.0f / 2147483648.0f);
}
inline float cvt_f32(const unsigned char* p) {
  float v;
  memcpy(&v, p, 4);
  return v;
}
inline float cvt_pcm24(const unsigned char* p) {
  int32_t s = (int32_t)((uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                        ((uint32_t)p[2] << 16));
  if (s >= (1 << 23)) s -= (1 << 24);
  return (float)s * (1.0f / (float)(1 << 23));
}
inline float cvt_pcm8(const unsigned char* p) {
  return ((float)p[0] - 128.0f) * (1.0f / 128.0f);
}

template <float (*CVT)(const unsigned char*), int BYTES>
void cvt_block(const unsigned char* p, int64_t n, int channels, float inv_ch,
               float* out) {
  if (channels == 1) {
    for (int64_t i = 0; i < n; ++i) out[i] = CVT(p + i * BYTES);
  } else {
    for (int64_t i = 0; i < n; ++i) {
      float acc = 0.0f;
      for (int c = 0; c < channels; ++c)
        acc += CVT(p + (i * channels + c) * BYTES);
      out[i] = acc * inv_ch;
    }
  }
}

// Decode interleaved samples -> mono float32 (channel mean), into out[cap].
// Returns frames written, or <0 on error.
int64_t decode_mono(FILE* f, const WavInfo& in, float* out, int64_t cap) {
  const int bytes = in.bits / 8;
  if (bytes < 1 || bytes > 4 || in.channels == 0) return -3;
  const int64_t frame_bytes = (int64_t)bytes * in.channels;
  int64_t frames = in.data_len / frame_bytes;
  if (frames > cap) frames = cap;
  if (fseek(f, (long)in.data_off, SEEK_SET) != 0) return -2;
  const int64_t CHUNK = 1 << 16;  // frames per read
  std::vector<unsigned char> buf((size_t)(CHUNK * frame_bytes));
  const float inv_ch = 1.0f / (float)in.channels;
  int64_t done = 0;
  while (done < frames) {
    int64_t n = frames - done < CHUNK ? frames - done : CHUNK;
    if ((int64_t)fread(buf.data(), (size_t)frame_bytes, (size_t)n, f) != n)
      return -2;
    const unsigned char* p = buf.data();
    float* o = out + done;
    if (in.format == 3)
      cvt_block<cvt_f32, 4>(p, n, in.channels, inv_ch, o);
    else if (bytes == 2)
      cvt_block<cvt_pcm16, 2>(p, n, in.channels, inv_ch, o);
    else if (bytes == 4)
      cvt_block<cvt_pcm32, 4>(p, n, in.channels, inv_ch, o);
    else if (bytes == 3)
      cvt_block<cvt_pcm24, 3>(p, n, in.channels, inv_ch, o);
    else
      cvt_block<cvt_pcm8, 1>(p, n, in.channels, inv_ch, o);
    done += n;
  }
  return frames;
}

// Zero-mean/unit-variance in double accumulation (matches
// Wav2Vec2FeatureExtractor do_normalize semantics,
// mtasr_tpu_torch/data/audio.py::normalize_waveform).
void normalize_inplace(float* x, int64_t n) {
  if (n <= 0) return;
  // 4-way independent accumulators so the strict-FP double sums still
  // auto-vectorize (no -ffast-math reassociation needed)
  double s0 = 0, s1 = 0, s2 = 0, s3 = 0;
  int64_t i = 0;
  for (; i + 4 <= n; i += 4) {
    s0 += x[i];
    s1 += x[i + 1];
    s2 += x[i + 2];
    s3 += x[i + 3];
  }
  for (; i < n; ++i) s0 += x[i];
  double mean = (s0 + s1 + s2 + s3) / (double)n;
  double q0 = 0, q1 = 0, q2 = 0, q3 = 0;
  for (i = 0; i + 4 <= n; i += 4) {
    double d0 = x[i] - mean, d1 = x[i + 1] - mean;
    double d2 = x[i + 2] - mean, d3 = x[i + 3] - mean;
    q0 += d0 * d0;
    q1 += d1 * d1;
    q2 += d2 * d2;
    q3 += d3 * d3;
  }
  for (; i < n; ++i) {
    double d = x[i] - mean;
    q0 += d * d;
  }
  float inv = (float)(1.0 / std::sqrt((q0 + q1 + q2 + q3) / (double)n + 1e-7));
  float fmean = (float)mean;
  for (i = 0; i < n; ++i) x[i] = (x[i] - fmean) * inv;
}

}  // namespace

extern "C" {

// 0 ok; -1 open failure; -2 malformed; frames/sr/channels written on ok.
int wav_header(const char* path, int64_t* n_frames, int32_t* sr,
               int32_t* channels) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  int rc = parse_wav(f, &info);
  fclose(f);
  if (rc != 0) return rc;
  int64_t frame_bytes = (int64_t)(info.bits / 8) * info.channels;
  if (frame_bytes <= 0) return -3;
  *n_frames = info.data_len / frame_bytes;
  *sr = (int32_t)info.sample_rate;
  *channels = (int32_t)info.channels;
  return 0;
}

// Load ONE file: decode + downmix (+ optional normalize) into out[cap].
// status: 0 ok; 1 open/parse error; 2 sample-rate mismatch (caller must
// fall back to the resampling path); 3 unsupported encoding.
// Returns frames written (0 on non-ok status).
int64_t wav_load(const char* path, int32_t target_sr, int32_t normalize,
                 float* out, int64_t cap, int32_t* status) {
  FILE* f = fopen(path, "rb");
  if (!f) {
    *status = 1;
    return 0;
  }
  WavInfo info;
  int rc = parse_wav(f, &info);
  if (rc != 0) {
    fclose(f);
    *status = 1;
    return 0;
  }
  if ((int32_t)info.sample_rate != target_sr) {
    fclose(f);
    *status = 2;
    return 0;
  }
  if (!((info.format == 1 && (info.bits == 8 || info.bits == 16 ||
                              info.bits == 24 || info.bits == 32)) ||
        (info.format == 3 && info.bits == 32))) {
    fclose(f);
    *status = 3;
    return 0;
  }
  int64_t n = decode_mono(f, info, out, cap);
  fclose(f);
  if (n < 0) {
    *status = 1;
    return 0;
  }
  if (normalize) normalize_inplace(out, n);
  *status = 0;
  return n;
}

// Batch load: B files (paths concatenated, path_off[B+1] byte offsets into
// the UTF-8 blob) decoded in parallel into out[b*cap : b*cap+lens[b]].
// Rows with status != 0 are left zero-filled for the caller to handle.
void wav_load_batch(const char* paths, const int64_t* path_off, int64_t B,
                    int32_t target_sr, int32_t normalize, float* out,
                    int64_t cap, int64_t* lens, int32_t* status,
                    int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > B) n_threads = (int32_t)B;
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t b = next.fetch_add(1);
      if (b >= B) return;
      std::string path(paths + path_off[b],
                       (size_t)(path_off[b + 1] - path_off[b]));
      lens[b] = wav_load(path.c_str(), target_sr, normalize, out + b * cap,
                         cap, &status[b]);
    }
  };
  if (n_threads == 1) {
    worker();
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve((size_t)n_threads);
  for (int32_t t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // extern "C"
