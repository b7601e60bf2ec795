// Native host runtime: PNG scanline reconstruction.
//
// Undoes the five scanline filters of a non-interlaced image (PNG
// specification, section 9: none, sub, up, average, Paeth). Average and
// Paeth predict each byte from the reconstructed byte to its left, so a
// scanline is sequential; PNGs written by libpng choose a filter per row,
// mostly Paeth, which made the numpy reader's per-byte Python loop cost
// seconds for a 1024x1024 texture.

#include <cstdint>
#include <cstdlib>

extern "C" {

// raw: h scanlines of (1 + stride) bytes, each a filter type byte and the
// filtered bytes; out: the (h, stride) reconstructed bytes; bpp: bytes per
// complete pixel (at least 1). Returns 0, or 1 + the index of the first
// scanline whose filter type is unknown.
int64_t frt_png_unfilter(const uint8_t *raw, int64_t h, int64_t stride,
                         int64_t bpp, uint8_t *out) {
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t *line = raw + y * (stride + 1) + 1;
    const uint8_t ftype = line[-1];
    uint8_t *rec = out + y * stride;
    const uint8_t *prev = y > 0 ? out + (y - 1) * stride : nullptr;
    for (int64_t i = 0; i < stride; ++i) {
      const int a = i >= bpp ? rec[i - bpp] : 0;
      const int b = prev ? prev[i] : 0;
      const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
      int pred;
      switch (ftype) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: return y + 1;
      }
      rec[i] = static_cast<uint8_t>(line[i] + pred);
    }
  }
  return 0;
}

}  // extern "C"
