// Inverse MDCT synthesis for CELT (RFC 6716 §4.3.7).
//
// Matrix form: t[m] = sum_k X[k] cos(2*pi/N (m + N/2 + .5)(k + .5)),
// m in [0, N2) — exactly what the device pipeline evaluates as a matmul;
// the host fallback computes the same product. Output contract (matches the
// reference backward MDCT, verified empirically in tests):
//   out[ov/2 + m] = t[m]                       (raw, unwindowed)
//   then TDAC mirror over the first `ov` samples, folding the *previous*
//   buffer contents (the prior block's unwindowed tail) with this block's
//   head through the window:
//     x1 = t[ov/2-1-i]; x2 = old out[i]
//     out[i]      = w[ov-1-i]*x2 - w[i]*x1
//     out[ov-1-i] = w[ov-1-i]*x1 + w[i]*x2
// Nothing past out[ov/2 + N2) is written.

#include <cmath>
#include <cstring>

#include "celt.h"
#include "celt_tables.h"

namespace iamf_opus {

static const float* build_basis(int shift) {
  int N2 = (SHORT_MDCT_SIZE * 8) >> shift;  // 960>>shift
  int N = 2 * N2;
  float* m = new float[(size_t)N2 * N2];
  for (int j = 0; j < N2; ++j) {
    for (int k = 0; k < N2; ++k) {
      double ang = 2.0 * M_PI / N * (j + N / 2.0 + 0.5) * (k + 0.5);
      m[(size_t)j * N2 + k] = (float)cos(ang);
    }
  }
  return m;
}

static const float* basis_for_shift(int shift) {
  // magic-static: thread-safe one-time build of all four bases (decode
  // runs on parallel host threads, one per substream)
  static const float* bases[4] = {build_basis(0), build_basis(1),
                                  build_basis(2), build_basis(3)};
  return bases[shift];
}

void clt_mdct_backward(const float* in, float* out, int N, int stride,
                       const float* window, int overlap) {
  int N2 = N >> 1;
  int shift;
  switch (N2) {
    case 960: shift = 0; break;
    case 480: shift = 1; break;
    case 240: shift = 2; break;
    default: shift = 3; break;
  }
  const float* basis = basis_for_shift(shift);

  static thread_local float xbuf[960];
  static thread_local float tbuf[960];
  for (int k = 0; k < N2; ++k) xbuf[k] = in[k * stride];
  for (int m = 0; m < N2; ++m) {
    const float* row = basis + (size_t)m * N2;
    float acc = 0;
    for (int k = 0; k < N2; ++k) acc += row[k] * xbuf[k];
    tbuf[m] = acc;
  }

  int ov = overlap;
  // TDAC mirror first (uses old out[0..ov/2) and t head)
  for (int i = 0; i < ov / 2; ++i) {
    float x1 = tbuf[ov / 2 - 1 - i];
    float x2 = out[i];
    out[i] = window[ov - 1 - i] * x2 - window[i] * x1;
    out[ov - 1 - i] = window[ov - 1 - i] * x1 + window[i] * x2;
  }
  // core (skip the [ov/2, ov) region already finalized by the mirror)
  for (int m = ov / 2; m < N2; ++m) out[ov / 2 + m] = tbuf[m];
}

}  // namespace iamf_opus
