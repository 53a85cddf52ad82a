// Native I/O codec for tpuflow: RAW frame readers/writers and the Bruhn
// color-circle flow visualization.
//
// Counterpart of the reference's C++ host I/O layer
// (reference: src/data_types/data2d.cpp:98-231, src/utils/io_utils.cpp:35-225).
// The hot loops (u8->f32 widening, clamped u8 quantization, per-pixel
// color-circle conversion) run here; Python falls back to numpy when this
// library is not built. Exposed via ctypes (no pybind11 in this toolchain).
//
// Build: make -C tpuflow/_native   (g++ -O3 -shared -fPIC)

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// RAW frames. Return 0 on success, negative errno-style codes on failure.
// ---------------------------------------------------------------------------

int tf_read_raw_u8(const char* path, int64_t count, float* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  constexpr int64_t kChunk = 1 << 20;
  uint8_t buf[kChunk];
  int64_t done = 0;
  while (done < count) {
    int64_t want = count - done < kChunk ? count - done : kChunk;
    int64_t got = static_cast<int64_t>(std::fread(buf, 1, want, f));
    if (got != want) {
      std::fclose(f);
      return -2;  // short read
    }
    for (int64_t i = 0; i < got; ++i) out[done + i] = static_cast<float>(buf[i]);
    done += got;
  }
  std::fclose(f);
  return 0;
}

int tf_read_raw_f32(const char* path, int64_t count, float* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  int64_t got = static_cast<int64_t>(std::fread(out, sizeof(float), count, f));
  std::fclose(f);
  return got == count ? 0 : -2;
}

int tf_write_raw_u8(const char* path, const float* data, int64_t count) {
  // Clamp to [0, 255] and truncate (reference: data2d.cpp:189-190).
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  constexpr int64_t kChunk = 1 << 20;
  uint8_t buf[kChunk];
  int64_t done = 0;
  while (done < count) {
    int64_t n = count - done < kChunk ? count - done : kChunk;
    for (int64_t i = 0; i < n; ++i) {
      float v = data[done + i];
      v = v < 0.f ? 0.f : (v > 255.f ? 255.f : v);
      buf[i] = static_cast<uint8_t>(v);
    }
    if (static_cast<int64_t>(std::fwrite(buf, 1, n, f)) != n) {
      std::fclose(f);
      return -2;
    }
    done += n;
  }
  std::fclose(f);
  return 0;
}

int tf_write_raw_f32(const char* path, const float* data, int64_t count) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  int64_t put = static_cast<int64_t>(std::fwrite(data, sizeof(float), count, f));
  std::fclose(f);
  return put == count ? 0 : -2;
}

// ---------------------------------------------------------------------------
// Flow visualization: Bruhn color circle (reference: io_utils.cpp:140-225).
// ---------------------------------------------------------------------------

static inline int to_byte(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

static void convert_to_rgb(double x, double y, uint8_t rgb[3]) {
  const double pi = 2.0 * std::acos(0.0);

  double amp = std::sqrt(x * x + y * y);
  if (amp > 1.0) amp = 1.0;

  double phi;
  if (x == 0.0)
    phi = (y >= 0.0) ? 0.5 * pi : 1.5 * pi;
  else if (x > 0.0)
    phi = (y >= 0.0) ? std::atan(y / x) : 2.0 * pi + std::atan(y / x);
  else
    phi = pi + std::atan(y / x);
  phi *= 0.5;

  // Six angular segments, linear interpolation between RGB anchors.
  struct Seg { double start, span, c0[3], c1[3]; };
  static const Seg segs[6] = {
      {0.000, 0.125, {255, 0, 0}, {255, 0, 255}},
      {0.125, 0.125, {255, 0, 255}, {64, 64, 255}},
      {0.250, 0.125, {64, 64, 255}, {0, 255, 255}},
      {0.375, 0.125, {0, 255, 255}, {0, 255, 0}},
      {0.500, 0.250, {0, 255, 0}, {255, 255, 0}},
      {0.750, 0.250, {255, 255, 0}, {255, 0, 0}},
  };

  int r = 0, g = 0, b = 0;
  for (const Seg& s : segs) {
    double lo = s.start * pi, hi = (s.start + s.span) * pi;
    bool in = (s.start == 0.750) ? (phi >= lo && phi <= pi) : (phi >= lo && phi < hi);
    if (!in) continue;
    double beta = (phi - lo) / (s.span * pi);
    double alpha = 1.0 - beta;
    r = static_cast<int>(std::floor(amp * (alpha * s.c0[0] + beta * s.c1[0])));
    g = static_cast<int>(std::floor(amp * (alpha * s.c0[1] + beta * s.c1[1])));
    b = static_cast<int>(std::floor(amp * (alpha * s.c0[2] + beta * s.c1[2])));
  }
  rgb[0] = static_cast<uint8_t>(to_byte(r));
  rgb[1] = static_cast<uint8_t>(to_byte(g));
  rgb[2] = static_cast<uint8_t>(to_byte(b));
}

void tf_flow_to_rgb(const float* u, const float* v, int64_t count,
                    float flow_max_scale, uint8_t* rgb_out) {
  const double factor = 1.0 / static_cast<double>(flow_max_scale);
  for (int64_t i = 0; i < count; ++i) {
    convert_to_rgb(u[i] * factor, v[i] * factor, rgb_out + 3 * i);
  }
}

// Magnitude image: per-pixel sqrt(u^2+v^2) (reference: io_utils.cpp:81-114).
void tf_flow_magnitude(const float* u, const float* v, int64_t count, float* out) {
  for (int64_t i = 0; i < count; ++i) {
    out[i] = std::sqrt(u[i] * u[i] + v[i] * v[i]);
  }
}

}  // extern "C"
