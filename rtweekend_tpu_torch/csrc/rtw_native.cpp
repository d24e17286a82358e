// Host image runtime of the port: the C++ counterpart of the JAX
// package's native/rtw_native.cpp, behind rtweekend_tpu_torch/utils/native.py.
//
// Two C entry points, each with the arithmetic of its counterpart there:
//   - rtw_png_filter (rtw_native.cpp:56-62, :73-86): the Paeth-filtered
//     scanlines of an 8-bit RGB PNG, filter byte 4 on every row;
//   - rtw_ppm_encode (rtw_native.cpp:122-140): P3 text.
// Every output goes into a buffer the caller allocated, so nothing here
// allocates or frees. The deflate and the PNG chunks are done by the
// caller (Python's zlib), so the library needs no zlib of its own.
//
// Build: c++ -O3 -shared -fPIC (utils/native.build does it at first use).

#include <cstdint>
#include <cstdio>
#include <cstdlib>

extern "C" {

// rgb [h, w, 3] uint8 -> out [h, 1 + 3w]: per row the filter type 4, then
// each byte minus the Paeth predictor of its left (a), upper (b) and
// upper-left (c) bytes of the same channel. a and c are 0 in a row's first
// pixel, b and c on row 0. The predictor is chosen in int; only the
// difference wraps to uint8.
void rtw_png_filter(const uint8_t* rgb, int32_t w, int32_t h, uint8_t* out) {
  const int64_t stride = int64_t(w) * 3;
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* row = rgb + y * stride;
    const uint8_t* prev = y > 0 ? row - stride : nullptr;
    uint8_t* o = out + y * (stride + 1);
    o[0] = 4;
    for (int64_t x = 0; x < stride; ++x) {
      int a = x >= 3 ? row[x - 3] : 0;
      int b = prev ? prev[x] : 0;
      int c = prev && x >= 3 ? prev[x - 3] : 0;
      int p = a + b - c;
      int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
      int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
      o[1 + x] = uint8_t(row[x] - pred);
    }
  }
}

// rgb [h, w, 3] uint8 -> "P3\n{w} {h}\n255\n" and "%d %d %d\n" a pixel in
// out[0, cap). Returns the bytes written, or -1 if cap is too small
// (12 * w * h + 32 always suffices).
int64_t rtw_ppm_encode(const uint8_t* rgb, int32_t w, int32_t h, char* out,
                       int64_t cap) {
  int64_t n = std::snprintf(out, size_t(cap), "P3\n%d %d\n255\n", w, h);
  if (n < 0 || n >= cap) return -1;
  for (int64_t i = 0; i < int64_t(w) * h; ++i) {
    const uint8_t* p = rgb + i * 3;
    int k = std::snprintf(out + n, size_t(cap - n), "%d %d %d\n", p[0], p[1],
                          p[2]);
    if (k < 0 || k >= cap - n) return -1;
    n += k;
  }
  return n;
}

}  // extern "C"
