// The port's PNG unfilter: the five scanline filters of the PNG
// specification (None, Sub, Up, Average, Paeth) undone over one image or
// one Adam7 pass.  data/png.py inflates the IDAT stream with Python's zlib
// and hands the filtered rows here; data/native.py builds this file with
// g++ at first use and binds it with ctypes.
//
// C ABI:
//   png_unfilter(filtered, rows, row_bytes, bpp, out)           -> 0/err
//     filtered: rows x (1 + row_bytes) bytes, each row led by its filter
//     type; out: rows x row_bytes; bpp: bytes per complete pixel (at
//     least 1).  Returns 0, or 1 + the row whose filter type is not 0-4.

#include <cstddef>
#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return uint8_t(a);
  if (pb <= pc) return uint8_t(b);
  return uint8_t(c);
}

}  // namespace

extern "C" {

int png_unfilter(const uint8_t* filtered, int rows, int row_bytes, int bpp,
                 uint8_t* out) {
  for (int y = 0; y < rows; ++y) {
    const uint8_t* src = filtered + size_t(y) * (row_bytes + 1);
    const int type = src[0];
    ++src;
    uint8_t* cur = out + size_t(y) * row_bytes;
    const uint8_t* up = y > 0 ? cur - row_bytes : nullptr;
    switch (type) {
      case 0:
        for (int x = 0; x < row_bytes; ++x) cur[x] = src[x];
        break;
      case 1:
        for (int x = 0; x < row_bytes; ++x)
          cur[x] = uint8_t(src[x] + (x >= bpp ? cur[x - bpp] : 0));
        break;
      case 2:
        for (int x = 0; x < row_bytes; ++x)
          cur[x] = uint8_t(src[x] + (up ? up[x] : 0));
        break;
      case 3:
        for (int x = 0; x < row_bytes; ++x) {
          int a = x >= bpp ? cur[x - bpp] : 0, b = up ? up[x] : 0;
          cur[x] = uint8_t(src[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int x = 0; x < row_bytes; ++x) {
          int a = x >= bpp ? cur[x - bpp] : 0, b = up ? up[x] : 0;
          int c = (up && x >= bpp) ? up[x - bpp] : 0;
          cur[x] = uint8_t(src[x] + paeth(a, b, c));
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

}  // extern "C"
