// PNG row unfiltering for io/png.py: the five filter types of the PNG
// specification (section 9), from the inflated scanlines (a filter byte,
// then the row's bytes) to the raw samples. It needs neither libpng nor
// the Python headers, so it builds wherever a C++ compiler is, also where
// the libpng loader (loader.cpp) cannot. io/png.py calls it through
// ctypes; the filter types were checked there.
#include <cstdint>

extern "C" void ygz_png_unfilter(const uint8_t* src, uint8_t* dst, int64_t h,
                                 int64_t stride, int64_t bpp) {
  const uint8_t* prior = nullptr;
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* f = src + y * (stride + 1);
    const uint8_t kind = f[0];
    ++f;
    uint8_t* cur = dst + y * stride;
    for (int64_t i = 0; i < stride; ++i) {
      const int a = i >= bpp ? cur[i - bpp] : 0;
      const int b = prior ? prior[i] : 0;
      const int c = (prior && i >= bpp) ? prior[i - bpp] : 0;
      int pred = 0;
      if (kind == 1) {
        pred = a;
      } else if (kind == 2) {
        pred = b;
      } else if (kind == 3) {
        pred = (a + b) >> 1;
      } else if (kind == 4) {
        const int p = a + b - c;
        const int pa = p > a ? p - a : a - p;
        const int pb = p > b ? p - b : b - p;
        const int pc = p > c ? p - c : c - p;
        pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
      }
      cur[i] = static_cast<uint8_t>(f[i] + pred);
    }
    prior = cur;
  }
}
