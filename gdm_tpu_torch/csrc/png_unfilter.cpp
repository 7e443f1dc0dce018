// PNG row unfiltering for the Average (3) and Paeth (4) filter types.
//
// Host code of gdm_tpu_torch/data/imio.py (not a device kernel).  Both
// filters predict each byte from the byte already reconstructed bpp
// places to its left, so a row is a sequential loop; numpy does the other
// three types (None, Sub as a wrapping cumsum, Up) on whole rows.  Built
// at first use with the host C++ compiler (gdm_tpu_torch/_build.py) and
// called through ctypes, which releases the GIL for the loader threads.

#include <cstdint>
#include <cstdlib>

extern "C" int gdm_png_unfilter_row(int ftype, const uint8_t* in,
                                    const uint8_t* prev, uint8_t* out,
                                    int stride, int bpp) {
  if (ftype == 3) {                       // Average: (left + up) / 2
    for (int i = 0; i < stride; ++i) {
      int left = i >= bpp ? out[i - bpp] : 0;
      out[i] = static_cast<uint8_t>(in[i] + ((left + prev[i]) >> 1));
    }
    return 0;
  }
  if (ftype == 4) {                       // Paeth predictor
    for (int i = 0; i < stride; ++i) {
      int a = i >= bpp ? out[i - bpp] : 0;
      int b = prev[i];
      int c = i >= bpp ? prev[i - bpp] : 0;
      int p = a + b - c;
      int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
      int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
      out[i] = static_cast<uint8_t>(in[i] + pred);
    }
    return 0;
  }
  return -1;
}
