// From-scratch AAC-LC decoder (ISO/IEC 14496-3 subpart 4) for IAMF
// substreams: RAW access units (one raw_data_block per AU), mono (SCE) or
// stereo (CPE), AOT 2 at frame length 1024.
//
// This replaces the prebuilt fdk-aac binary the reference links
// (IAMF_aac_decoder.c:83-161, aac_multistream_decoder.c:82-218); only the
// spec-defined constant tables were extracted from that binary
// (aac_tables.cc). Architecture mirrors the Opus path: the bit-serial
// layers (Huffman sections/scalefactors/spectral data, TNS) run here on
// the host; the filterbank exists both as a host reference (decode())
// and as spectrum export (decode_spectrum()) for the batched device IMDCT in
// iamf_tpu/codecs/aac/tpu_synth.py.
//
// Tool coverage: sectioning, scalefactors, pulse data, TNS, M/S stereo,
// intensity stereo (books 14/15), PNS (book 13), window sequences
// ONLY_LONG / LONG_START / EIGHT_SHORT / LONG_STOP with sine+KBD shapes.
// Not AAC-LC (rejected): gain control (SSR), prediction (Main), LTP.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include "aac_tables.h"

namespace iamf_aac {

// ---------------------------------------------------------------- bitstream
struct Bits {
  const uint8_t* d;
  long nbits;
  long pos = 0;
  bool err = false;

  Bits(const uint8_t* data, long nbytes) : d(data), nbits(8L * nbytes) {}

  uint32_t get(int n) {  // MSB-first, n <= 24
    if (pos + n > nbits) {
      err = true;
      pos = nbits;
      return 0;
    }
    uint32_t v = 0;
    long p = pos;
    pos += n;
    while (n > 0) {
      int byte = p >> 3, off = p & 7;
      int take = 8 - off;
      if (take > n) take = n;
      v = (v << take) | ((d[byte] >> (8 - off - take)) & ((1u << take) - 1));
      p += take;
      n -= take;
    }
    return v;
  }

  uint32_t peek24() const {  // next 24 bits, zero-padded past the end
    uint32_t v = 0;
    for (int i = 0; i < 4; i++) {
      long byte = (pos >> 3) + i;
      v = (v << 8) | (byte < (nbits + 7) / 8 ? d[byte] : 0);
    }
    return (v >> (8 - (pos & 7))) & 0xFFFFFF;
  }

  void skip(int n) {
    pos += n;
    if (pos > nbits) {
      err = true;
      pos = nbits;
    }
  }
};

// ------------------------------------------------------------ huffman LUTs
struct HuffLut {
  int maxlen = 0;
  std::vector<int32_t> t;  // (flat_index << 5) | len; -1 = invalid

  void build(const unsigned* codes, const unsigned short* codes16,
             const unsigned char* lens, int count) {
    for (int i = 0; i < count; i++)
      if (lens[i] > maxlen) maxlen = lens[i];
    t.assign(1u << maxlen, -1);
    for (int i = 0; i < count; i++) {
      uint32_t code = codes ? codes[i] : codes16[i];
      int len = lens[i];
      uint32_t base = code << (maxlen - len);
      for (uint32_t k = 0; k < (1u << (maxlen - len)); k++)
        t[base + k] = (i << 5) | len;
    }
  }

  int decode(Bits& bs) const {  // -> flat index, or -1
    int32_t e = t[bs.peek24() >> (24 - maxlen)];
    if (e < 0) {
      bs.err = true;
      return -1;
    }
    bs.skip(e & 31);
    return e >> 5;
  }
};

struct BookInfo {
  int dim;       // 2 or 4
  int n;         // values per axis
  int lav;       // centered offset for signed books, 0 for unsigned
  bool signd;    // values carry sign in the codeword
  HuffLut lut;
};

static BookInfo g_books[12];  // 1..11
static HuffLut g_scf;
static bool g_init = false;

static void init_books_impl();

static void init_books() {
  // thread-safe one-time init (decode may run on parallel host threads)
  static const bool once = [] { init_books_impl(); return true; }();
  (void)once;
}

static void init_books_impl() {
  if (g_init) return;
  struct D {
    const unsigned short* c;
    const unsigned char* l;
    int cnt, dim, n;
    bool signd;
  } defs[12] = {
      {nullptr, nullptr, 0, 0, 0, false},
      {kBook1Codes, kBook1Lens, 81, 4, 3, true},
      {kBook2Codes, kBook2Lens, 81, 4, 3, true},
      {kBook3Codes, kBook3Lens, 81, 4, 3, false},
      {kBook4Codes, kBook4Lens, 81, 4, 3, false},
      {kBook5Codes, kBook5Lens, 81, 2, 9, true},
      {kBook6Codes, kBook6Lens, 81, 2, 9, true},
      {kBook7Codes, kBook7Lens, 64, 2, 8, false},
      {kBook8Codes, kBook8Lens, 64, 2, 8, false},
      {kBook9Codes, kBook9Lens, 169, 2, 13, false},
      {kBook10Codes, kBook10Lens, 169, 2, 13, false},
      {kBook11Codes, kBook11Lens, 289, 2, 17, false},
  };
  for (int b = 1; b <= 11; b++) {
    g_books[b].dim = defs[b].dim;
    g_books[b].n = defs[b].n;
    g_books[b].signd = defs[b].signd;
    g_books[b].lav = defs[b].signd ? (defs[b].n - 1) / 2 : 0;
    g_books[b].lut.build(nullptr, defs[b].c, defs[b].l, defs[b].cnt);
  }
  g_scf.build(kScfCodes, nullptr, kScfLens, 121);
  g_init = true;
}

// Tool-usage counters (cb histogram 0..15, tns filters, window sequences,
// M/S bands, escapes), exported via iamf_aac_debug_stats for tests.
static int g_stats[24];

// ------------------------------------------------------------- frame model
enum { ONLY_LONG = 0, LONG_START = 1, EIGHT_SHORT = 2, LONG_STOP = 3 };
enum { ZERO_HCB = 0, NOISE_HCB = 13, INTENSITY_HCB2 = 14, INTENSITY_HCB = 15 };

struct IcsInfo {
  int window_sequence = ONLY_LONG;
  int window_shape = 0;
  int max_sfb = 0;
  int num_groups = 1;
  int group_len[8] = {1};
  int num_windows = 1;
};

struct ChannelData {
  IcsInfo ics;
  int global_gain = 0;
  uint8_t sfb_cb[8][52];
  int sf[8][52];  // scalefactor / is_position / noise energy
  int32_t quant[1024];
  float spec[1024];  // dequantized, per-window sequential order
  // TNS
  bool tns_present = false;
  int tns_n_filt[8] = {0};
  int tns_length[8][4];
  int tns_order[8][4];
  int tns_dir[8][4];
  float tns_lpc[8][4][21];
  // pulse
  bool pulse_present = false;
  int pulse_start_sfb = 0, n_pulse = 0;
  int pulse_offset[4], pulse_amp[4];
};

struct Decoder {
  int sr_index;
  int nch;  // 1 or 2
  const short* swb_long;
  const short* swb_short;
  int n_swb_long, n_swb_short;
  int tns_max_long, tns_max_short;
  // synthesis state per channel
  float overlap[2][1024];
  int prev_shape[2];  // -1 = none yet (use current frame's shape)
  // PNS state (fdk-compatible): one running LCG seed per decoder plus the
  // per-band pre-draw seeds channel 0 saves for correlated channel-1 bands
  uint32_t pns_seed = 0;
  uint32_t pns_saved[8 * 16 + 52] = {0};
  ChannelData ch[2];
};

// --------------------------------------------------------------- ics parse
static bool ics_info(Bits& bs, Decoder& d, IcsInfo& ics) {
  bs.get(1);  // ics_reserved_bit
  ics.window_sequence = bs.get(2);
  g_stats[17 + ics.window_sequence]++;
  ics.window_shape = bs.get(1);
  ics.num_groups = 1;
  ics.group_len[0] = 1;
  if (ics.window_sequence == EIGHT_SHORT) {
    ics.max_sfb = bs.get(4);
    int grouping = bs.get(7);
    ics.num_windows = 8;
    for (int w = 1; w < 8; w++) {
      if ((grouping >> (7 - w)) & 1) {
        ics.group_len[ics.num_groups - 1]++;
      } else {
        ics.group_len[ics.num_groups] = 1;
        ics.num_groups++;
      }
    }
    if (ics.max_sfb > d.n_swb_short) return false;
  } else {
    ics.max_sfb = bs.get(6);
    ics.num_windows = 1;
    if (bs.get(1)) return false;  // predictor_data_present: not LC
    if (ics.max_sfb > d.n_swb_long) return false;
  }
  return !bs.err;
}

static bool section_data(Bits& bs, const IcsInfo& ics, ChannelData& cd) {
  const int bits = ics.window_sequence == EIGHT_SHORT ? 3 : 5;
  const int esc = (1 << bits) - 1;
  for (int g = 0; g < ics.num_groups; g++) {
    int k = 0;
    while (k < ics.max_sfb) {
      int cb = bs.get(4);
      if (cb == 12) return false;  // reserved
      int len = 0, inc;
      while ((inc = bs.get(bits)) == esc) len += esc;
      len += inc;
      if (k + len > ics.max_sfb || bs.err) return false;
      for (int sfb = k; sfb < k + len; sfb++) cd.sfb_cb[g][sfb] = cb;
      g_stats[cb] += len;
      k += len;
    }
  }
  return !bs.err;
}

static bool scale_factor_data(Bits& bs, const IcsInfo& ics, ChannelData& cd) {
  int sf = cd.global_gain;
  int is_pos = 0;
  int noise_nrg = cd.global_gain - 90;
  bool noise_first = true;
  for (int g = 0; g < ics.num_groups; g++)
    for (int sfb = 0; sfb < ics.max_sfb; sfb++) {
      int cb = cd.sfb_cb[g][sfb];
      if (cb == ZERO_HCB) {
        cd.sf[g][sfb] = 0;
      } else if (cb == INTENSITY_HCB || cb == INTENSITY_HCB2) {
        int idx = g_scf.decode(bs);
        if (idx < 0) return false;
        is_pos += idx - 60;
        cd.sf[g][sfb] = is_pos;
      } else if (cb == NOISE_HCB) {
        if (noise_first) {
          noise_nrg += (int)bs.get(9) - 256;
          noise_first = false;
        } else {
          int idx = g_scf.decode(bs);
          if (idx < 0) return false;
          noise_nrg += idx - 60;
        }
        cd.sf[g][sfb] = noise_nrg;
      } else {
        int idx = g_scf.decode(bs);
        if (idx < 0) return false;
        sf += idx - 60;
        if (sf < 0 || sf > 255) return false;
        cd.sf[g][sfb] = sf;
      }
    }
  return !bs.err;
}

static bool pulse_data(Bits& bs, const IcsInfo& ics, ChannelData& cd,
                       int n_swb_long) {
  if (ics.window_sequence == EIGHT_SHORT) return false;
  cd.pulse_present = true;
  cd.n_pulse = bs.get(2) + 1;
  cd.pulse_start_sfb = bs.get(6);
  if (cd.pulse_start_sfb > n_swb_long) return false;
  for (int i = 0; i < cd.n_pulse; i++) {
    cd.pulse_offset[i] = bs.get(5);
    cd.pulse_amp[i] = bs.get(4);
  }
  return !bs.err;
}

static bool tns_data(Bits& bs, const IcsInfo& ics, ChannelData& cd) {
  cd.tns_present = true;
  const bool shortw = ics.window_sequence == EIGHT_SHORT;
  const int n_filt_bits = shortw ? 1 : 2;
  const int len_bits = shortw ? 4 : 6;
  const int ord_bits = shortw ? 3 : 5;
  for (int w = 0; w < ics.num_windows; w++) {
    cd.tns_n_filt[w] = bs.get(n_filt_bits);
    g_stats[16] += cd.tns_n_filt[w];
    int coef_res = 0;
    if (cd.tns_n_filt[w]) coef_res = bs.get(1);
    for (int f = 0; f < cd.tns_n_filt[w]; f++) {
      cd.tns_length[w][f] = bs.get(len_bits);
      int order = cd.tns_order[w][f] = bs.get(ord_bits);
      if (order > 20) return false;
      if (order) {
        cd.tns_dir[w][f] = bs.get(1);
        int compress = bs.get(1);
        int coef_bits = coef_res + 3 - compress;
        // inverse quantization of reflection coefficients (14496-3
        // 4.6.9.3): sign-extend, then sin mapping
        double iqfac = ((1 << (coef_res + 2)) - 0.5) / (M_PI / 2.0);
        double iqfac_m = ((1 << (coef_res + 2)) + 0.5) / (M_PI / 2.0);
        double parcor[21];
        for (int i = 1; i <= order; i++) {
          int v = bs.get(coef_bits);
          if (v >= (1 << (coef_bits - 1))) v -= 1 << coef_bits;
          parcor[i] = sin(v / (v >= 0 ? iqfac : iqfac_m));
        }
        // reflection -> direct-form LPC
        double a[21] = {1.0}, b[21];
        for (int m = 1; m <= order; m++) {
          for (int i = 1; i < m; i++)
            b[i] = a[i] + parcor[m] * a[m - i];
          for (int i = 1; i < m; i++) a[i] = b[i];
          a[m] = parcor[m];
        }
        cd.tns_lpc[w][f][0] = 1.0f;
        for (int i = 1; i <= order; i++) cd.tns_lpc[w][f][i] = (float)a[i];
      }
    }
  }
  return !bs.err;
}

// ----------------------------------------------------------- spectral data
static inline float iquant(int32_t q) {
  float a = fabsf((float)q);
  return copysignf(powf(a, 4.0f / 3.0f), (float)q);
}

static bool spectral_data(Bits& bs, const Decoder& d, const IcsInfo& ics,
                          ChannelData& cd) {
  memset(cd.quant, 0, sizeof(cd.quant));
  const short* swb =
      ics.window_sequence == EIGHT_SHORT ? d.swb_short : d.swb_long;
  int32_t buf[1024];  // group-interleaved decode order
  memset(buf, 0, sizeof(buf));
  int base = 0;  // start (in coeffs) of the current group's region
  for (int g = 0; g < ics.num_groups; g++) {
    const int glen = ics.group_len[g];
    int sect_start = 0;
    for (int sfb = 0; sfb < ics.max_sfb; sfb++) {
      const int cb = cd.sfb_cb[g][sfb];
      const int width = swb[sfb + 1] - swb[sfb];
      if (cb == ZERO_HCB || cb >= NOISE_HCB) {
        sect_start += width * glen;
        continue;
      }
      const BookInfo& bk = g_books[cb];
      // within a group the windows' sfb coefficients are interleaved:
      // decode glen*width values contiguously into the group region
      for (int k = 0; k < width * glen; k += bk.dim) {
        int flat = bk.lut.decode(bs);
        if (flat < 0) return false;
        int vals[4];
        for (int i = bk.dim - 1; i >= 0; i--) {
          vals[i] = flat % bk.n;
          flat /= bk.n;
        }
        if (bk.signd) {
          for (int i = 0; i < bk.dim; i++) vals[i] -= bk.lav;
        } else {
          // all sign bits first (1 = negative), then any escape words
          for (int i = 0; i < bk.dim; i++)
            if (vals[i] && bs.get(1)) vals[i] = -vals[i];
        }
        if (cb == 11) {
          for (int i = 0; i < bk.dim; i++) {
            if (vals[i] != 16 && vals[i] != -16) continue;
            // escape: N ones, 0, then N+4 bits; value = 1<<(N+4) | word
            int n = 4;
            while (bs.get(1)) {
              if (++n > 24 || bs.err) return false;
            }
            int mag = (1 << n) + (int)bs.get(n);
            vals[i] = vals[i] < 0 ? -mag : mag;
          }
        }
        for (int i = 0; i < bk.dim; i++)
          buf[base + sect_start + k + i] = vals[i];
      }
      sect_start += width * glen;
    }
    base += 128 * glen;
  }
  // deinterleave group regions into per-window order
  if (ics.window_sequence == EIGHT_SHORT) {
    int win = 0;
    base = 0;
    for (int g = 0; g < ics.num_groups; g++) {
      const int glen = ics.group_len[g];
      int sect_start = 0;
      for (int sfb = 0; sfb < ics.max_sfb; sfb++) {
        const int width = swb[sfb + 1] - swb[sfb];
        for (int w = 0; w < glen; w++)
          for (int k = 0; k < width; k++)
            cd.quant[(win + w) * 128 + swb[sfb] + k] =
                buf[base + sect_start + w * width + k];
        sect_start += width * glen;
      }
      win += glen;
      base += 128 * glen;
    }
  } else {
    memcpy(cd.quant, buf, sizeof(cd.quant));
  }
  return !bs.err;
}

static void apply_pulse(const Decoder& d, ChannelData& cd) {
  if (!cd.pulse_present) return;
  int k = d.swb_long[cd.pulse_start_sfb];
  for (int i = 0; i < cd.n_pulse; i++) {
    k += cd.pulse_offset[i];
    if (k >= 1024) break;
    if (cd.quant[k] > 0)
      cd.quant[k] += cd.pulse_amp[i];
    else
      cd.quant[k] -= cd.pulse_amp[i];
  }
}

static void dequant(const Decoder& d, const IcsInfo& ics, ChannelData& cd) {
  memset(cd.spec, 0, sizeof(cd.spec));
  const short* swb =
      ics.window_sequence == EIGHT_SHORT ? d.swb_short : d.swb_long;
  const int wlen = ics.window_sequence == EIGHT_SHORT ? 128 : 1024;
  int win = 0;
  for (int g = 0; g < ics.num_groups; g++) {
    for (int w = 0; w < ics.group_len[g]; w++) {
      for (int sfb = 0; sfb < ics.max_sfb; sfb++) {
        int cb = cd.sfb_cb[g][sfb];
        if (cb == ZERO_HCB || cb >= NOISE_HCB) continue;
        float gain = exp2f(0.25f * (cd.sf[g][sfb] - 100));
        for (int k = swb[sfb]; k < swb[sfb + 1] && k < wlen; k++)
          cd.spec[(win + w) * wlen + k] =
              iquant(cd.quant[(win + w) * wlen + k]) * gain;
      }
    }
    win += ics.group_len[g];
  }
}

// ------------------------------------------------- stereo tools / PNS / TNS
// PNS noise generation replicating the reference's fdk decoder exactly
// (reverse-derived from the binary's CPns_Apply / GenerateRandomVector /
// ScaleBand): LCG seed*0x19660D+0x3C6EF35F, energy estimated in the same
// truncated fixed-point form, band gain MantissaTable[nrg&3]*2^(nrg>>2).
static const float kPnsMant[4] = {
    1073741824.0f / 2147483648.0f, 1276901376.0f / 2147483648.0f,
    1518500224.0f / 2147483648.0f, 1805811328.0f / 2147483648.0f};
// Calibration of fdk's fixed-point frame to our s16-scale float spectra:
// exactly 2^-22 (fitted against the binary with waveform correlation 1.0).
#ifndef IAMF_PNS_CAL
#define IAMF_PNS_CAL 2.384185791015625e-07f
#endif
static const float kPnsCal = IAMF_PNS_CAL;

static void pns_band(Decoder& d, float* band, int width, int nrg,
                     int seed_slot, bool use_saved) {
  uint32_t seed = use_saved ? d.pns_saved[seed_slot] : d.pns_seed;
  if (!use_saved) d.pns_saved[seed_slot] = d.pns_seed;
  int32_t n[1024];
  int64_t acc = 0;
  for (int i = 0; i < width; i++) {
    seed = seed * 0x19660Du + 0x3C6EF35Fu;
    n[i] = (int32_t)seed;
    int64_t v = (int64_t)(n[i] >> 7);
    acc += (v * v) >> 32;
  }
  if (!use_saved) d.pns_seed = seed;
  int64_t energy = 2 * acc;
  float inv = 0.0f;
  if (energy > 0) {
    float e32 = (float)energy * 0.5f;  // fdk's float32 rounding kept
    inv = (float)(1.0 / sqrt((double)e32));
  }
  float scale = inv * kPnsMant[nrg & 3] * exp2f((float)(nrg >> 2)) * kPnsCal;
  for (int i = 0; i < width; i++) band[i] = (float)n[i] * scale;
}

// channel: position within the element (correlation reuses channel 0's
// per-band seeds); corr: ms_used flags [g][sfb] (null = none).
static void apply_pns(Decoder& d, const IcsInfo& ics, ChannelData& cd,
                      int channel, const uint8_t (*corr)[52]) {
  const short* swb =
      ics.window_sequence == EIGHT_SHORT ? d.swb_short : d.swb_long;
  const int wlen = ics.window_sequence == EIGHT_SHORT ? 128 : 1024;
  int win = 0;
  for (int g = 0; g < ics.num_groups; g++) {
    for (int w = 0; w < ics.group_len[g]; w++)
      for (int sfb = 0; sfb < ics.max_sfb; sfb++) {
        if (cd.sfb_cb[g][sfb] != NOISE_HCB) continue;
        bool correlated = corr && corr[g][sfb];
        pns_band(d, cd.spec + (win + w) * wlen + swb[sfb],
                 swb[sfb + 1] - swb[sfb], cd.sf[g][sfb],
                 (win + w) * 16 + sfb, channel > 0 && correlated);
      }
    win += ics.group_len[g];
  }
}

static void apply_ms_is(Decoder& d, int ms_mask_present,
                        const uint8_t ms_used[8][52]) {
  ChannelData& l = d.ch[0];
  ChannelData& r = d.ch[1];
  const IcsInfo& ics = l.ics;
  const short* swb =
      ics.window_sequence == EIGHT_SHORT ? d.swb_short : d.swb_long;
  const int wlen = ics.window_sequence == EIGHT_SHORT ? 128 : 1024;
  int win = 0;
  for (int g = 0; g < ics.num_groups; g++) {
    for (int sfb = 0; sfb < ics.max_sfb; sfb++) {
      int rcb = r.sfb_cb[g][sfb];
      int mask = ms_mask_present == 2 ||
                 (ms_mask_present == 1 && ms_used[g][sfb]);
      if (rcb == INTENSITY_HCB || rcb == INTENSITY_HCB2) {
        // intensity: right reconstructed from left (14496-3 4.6.8.2)
        float scale = exp2f(-0.25f * r.sf[g][sfb]);
        if (rcb == INTENSITY_HCB2) scale = -scale;
        if (mask) scale = -scale;  // ms_used inverts intensity direction
        for (int w = 0; w < ics.group_len[g]; w++) {
          float* L = l.spec + (win + w) * wlen;
          float* R = r.spec + (win + w) * wlen;
          for (int k = swb[sfb]; k < swb[sfb + 1]; k++) R[k] = L[k] * scale;
        }
      } else if (mask && rcb != NOISE_HCB && l.sfb_cb[g][sfb] != NOISE_HCB) {
        g_stats[21]++;
        for (int w = 0; w < ics.group_len[g]; w++) {
          float* L = l.spec + (win + w) * wlen;
          float* R = r.spec + (win + w) * wlen;
          for (int k = swb[sfb]; k < swb[sfb + 1]; k++) {
            float m = L[k], s = R[k];
            L[k] = m + s;
            R[k] = m - s;
          }
        }
      }
    }
    win += ics.group_len[g];
  }
}

static void apply_tns(const Decoder& d, const IcsInfo& ics, ChannelData& cd) {
  if (!cd.tns_present) return;
  const bool shortw = ics.window_sequence == EIGHT_SHORT;
  const short* swb = shortw ? d.swb_short : d.swb_long;
  const int n_swb = shortw ? d.n_swb_short : d.n_swb_long;
  const int wlen = shortw ? 128 : 1024;
  const int tns_max = shortw ? d.tns_max_short : d.tns_max_long;
  for (int w = 0; w < ics.num_windows; w++) {
    int bottom = n_swb;
    for (int f = 0; f < cd.tns_n_filt[w]; f++) {
      int top = bottom;
      bottom = top - cd.tns_length[w][f];
      if (bottom < 0) bottom = 0;
      int order = cd.tns_order[w][f];
      if (!order) continue;
      int m0 = std::min(std::min(top, tns_max), ics.max_sfb);
      int m1 = std::min(std::min(bottom, tns_max), ics.max_sfb);
      int start = swb[m1], end = swb[m0];
      if (start >= end) continue;
      int size = end - start;
      const float* lpc = cd.tns_lpc[w][f];
      float* spec = cd.spec + w * wlen;
      int inc, pos;
      if (cd.tns_dir[w][f]) {
        pos = end - 1;
        inc = -1;
      } else {
        pos = start;
        inc = 1;
      }
      // all-pole synthesis filter along the spectrum
      float state[21] = {0};
      for (int i = 0; i < size; i++, pos += inc) {
        float y = spec[pos];
        for (int j = 0; j < order; j++) y -= lpc[j + 1] * state[j];
        for (int j = order - 1; j > 0; j--) state[j] = state[j - 1];
        state[0] = y;
        spec[pos] = y;
      }
    }
  }
}

// ------------------------------------------------------------- filterbank
struct FbTables {
  // IMDCT bases, [n][k] row-major
  std::vector<float> b_long;   // [2048][1024]
  std::vector<float> b_short;  // [256][128]
  float sine_long[1024], kbd_long[1024];    // first halves
  float sine_short[128], kbd_short[128];
};

static FbTables* g_fb = nullptr;

static void kbd_window(float* w, int n, double alpha) {
  // Kaiser-Bessel derived window first half (14496-3 4.6.11.3.3)
  std::vector<double> kern(n + 1);
  double sum = 0;
  for (int j = 0; j <= n; j++) {
    double x = 2.0 * j / n - 1.0;
    double arg = M_PI * alpha * sqrt(1.0 - x * x);
    // I0 Bessel series
    double i0 = 1.0, term = 1.0;
    for (int k = 1; k < 50; k++) {
      term *= (arg / (2.0 * k)) * (arg / (2.0 * k));
      i0 += term;
      if (term < 1e-21 * i0) break;
    }
    kern[j] = i0;
    sum += i0;
  }
  double cum = 0;
  for (int j = 0; j < n; j++) {
    cum += kern[j];
    w[j] = (float)sqrt(cum / sum);
  }
}

static void init_fb_impl();

static void init_fb() {
  // thread-safe one-time init (decode may run on parallel host threads)
  static const bool once = [] { init_fb_impl(); return true; }();
  (void)once;
}

static void init_fb_impl() {
  if (g_fb) return;
  g_fb = new FbTables();
  g_fb->b_long.resize(2048 * 1024);
  g_fb->b_short.resize(256 * 128);
  {
    const int N = 2048;
    const double n0 = (N / 2 + 1) / 2.0;
    for (int n = 0; n < N; n++)
      for (int k = 0; k < N / 2; k++)
        g_fb->b_long[(size_t)n * (N / 2) + k] =
            (float)((2.0 / N) * cos(2.0 * M_PI / N * (n + n0) * (k + 0.5)));
  }
  {
    const int N = 256;
    const double n0 = (N / 2 + 1) / 2.0;
    for (int n = 0; n < N; n++)
      for (int k = 0; k < N / 2; k++)
        g_fb->b_short[(size_t)n * (N / 2) + k] =
            (float)((2.0 / N) * cos(2.0 * M_PI / N * (n + n0) * (k + 0.5)));
  }
  for (int n = 0; n < 1024; n++)
    g_fb->sine_long[n] = (float)sin(M_PI / 2048 * (n + 0.5));
  for (int n = 0; n < 128; n++)
    g_fb->sine_short[n] = (float)sin(M_PI / 256 * (n + 0.5));
  kbd_window(g_fb->kbd_long, 1024, 4.0);
  kbd_window(g_fb->kbd_short, 128, 6.0);
}

static inline const float* half_window(int shape, bool shortw) {
  if (shortw) return shape ? g_fb->kbd_short : g_fb->sine_short;
  return shape ? g_fb->kbd_long : g_fb->sine_long;
}

static void imdct(const float* basis, const float* spec, float* out, int N) {
  const int K = N / 2;
  for (int n = 0; n < N; n++) {
    float acc = 0;
    const float* row = basis + (size_t)n * K;
    for (int k = 0; k < K; k++) acc += row[k] * spec[k];
    out[n] = acc;
  }
}

// One channel's filterbank: spec (per-window order) + state -> 1024 samples.
static void filterbank(const IcsInfo& ics, const float* spec, float* overlap,
                       int& prev_shape, float* out) {
  init_fb();
  const int shape = ics.window_shape;
  const int pshape = prev_shape < 0 ? shape : prev_shape;
  float t[2048];
  float frame[2048];  // windowed frame: out half + next overlap half
  if (ics.window_sequence == EIGHT_SHORT) {
    memset(frame, 0, sizeof(frame));
    float ts[256];
    for (int j = 0; j < 8; j++) {
      imdct(g_fb->b_short.data(), spec + j * 128, ts, 256);
      const float* wl = half_window(j == 0 ? pshape : shape, true);
      const float* wr = half_window(shape, true);
      float* dst = frame + 448 + 128 * j;
      for (int n = 0; n < 128; n++) dst[n] += ts[n] * wl[n];
      for (int n = 0; n < 128; n++)
        dst[128 + n] += ts[128 + n] * wr[127 - n];
    }
  } else {
    imdct(g_fb->b_long.data(), spec, t, 2048);
    // left half
    if (ics.window_sequence == LONG_STOP) {
      const float* wl = half_window(pshape, true);
      for (int n = 0; n < 448; n++) frame[n] = 0;
      for (int n = 0; n < 128; n++)
        frame[448 + n] = t[448 + n] * wl[n];
      for (int n = 576; n < 1024; n++) frame[n] = t[n];
    } else {
      const float* wl = half_window(pshape, false);
      for (int n = 0; n < 1024; n++) frame[n] = t[n] * wl[n];
    }
    // right half
    if (ics.window_sequence == LONG_START) {
      const float* wr = half_window(shape, true);
      for (int n = 0; n < 448; n++) frame[1024 + n] = t[1024 + n];
      for (int n = 0; n < 128; n++)
        frame[1472 + n] = t[1472 + n] * wr[127 - n];
      for (int n = 1600; n < 2048; n++) frame[n] = 0;
    } else {
      const float* wr = half_window(shape, false);
      for (int n = 0; n < 1024; n++)
        frame[1024 + n] = t[1024 + n] * wr[1023 - n];
    }
  }
  for (int n = 0; n < 1024; n++) out[n] = overlap[n] + frame[n];
  memcpy(overlap, frame + 1024, 1024 * sizeof(float));
  prev_shape = shape;
}

// ---------------------------------------------------------- element parse
static bool individual_channel_stream(Bits& bs, Decoder& d, ChannelData& cd,
                                      bool common_window, int channel = 0,
                                      const uint8_t (*corr)[52] = nullptr) {
  cd.tns_present = false;
  cd.pulse_present = false;
  cd.global_gain = bs.get(8);
  if (!common_window) {
    if (!ics_info(bs, d, cd.ics)) return false;
  }
  if (!section_data(bs, cd.ics, cd)) return false;
  if (!scale_factor_data(bs, cd.ics, cd)) return false;
  if (bs.get(1)) {  // pulse_data_present
    if (!pulse_data(bs, cd.ics, cd, d.n_swb_long)) return false;
  }
  if (bs.get(1)) {  // tns_data_present
    if (!tns_data(bs, cd.ics, cd)) return false;
  }
  if (bs.get(1)) return false;  // gain_control: SSR only
  if (!spectral_data(bs, d, cd.ics, cd)) return false;
  apply_pulse(d, cd);
  dequant(d, cd.ics, cd);
  apply_pns(d, cd.ics, cd, channel, corr);
  return true;
}

// Parse one raw_data_block; returns decoded channel count or <0.
static int raw_data_block(Bits& bs, Decoder& d) {
  int got = 0;
  for (;;) {
    int id = bs.get(3);
    if (bs.err) return -1;
    switch (id) {
      case 0:   // SCE
      case 3: {  // LFE (same ICS syntax)
        bs.get(4);  // element_instance_tag
        if (got >= d.nch) return -2;
        if (!individual_channel_stream(bs, d, d.ch[got], false)) return -3;
        apply_tns(d, d.ch[got].ics, d.ch[got]);
        got++;
        break;
      }
      case 1: {  // CPE
        if (got + 2 > d.nch) return -2;
        bs.get(4);
        int common = bs.get(1);
        int ms_mask_present = 0;
        uint8_t ms_used[8][52];
        memset(ms_used, 0, sizeof(ms_used));
        if (common) {
          if (!ics_info(bs, d, d.ch[0].ics)) return -3;
          d.ch[1].ics = d.ch[0].ics;
          ms_mask_present = bs.get(2);
          if (ms_mask_present == 3) return -3;
          if (ms_mask_present == 1) {
            for (int g = 0; g < d.ch[0].ics.num_groups; g++)
              for (int sfb = 0; sfb < d.ch[0].ics.max_sfb; sfb++)
                ms_used[g][sfb] = bs.get(1);
          } else if (ms_mask_present == 2) {
            memset(ms_used, 1, sizeof(ms_used));
          }
        }
        if (!individual_channel_stream(bs, d, d.ch[0], common, 0)) return -3;
        if (!individual_channel_stream(bs, d, d.ch[1], common, 1,
                                       common ? ms_used : nullptr))
          return -3;
        if (common) apply_ms_is(d, ms_mask_present, ms_used);
        apply_tns(d, d.ch[0].ics, d.ch[0]);
        apply_tns(d, d.ch[1].ics, d.ch[1]);
        got += 2;
        break;
      }
      case 4: {  // DSE
        bs.get(4);
        int align = bs.get(1);
        int cnt = bs.get(8);
        if (cnt == 255) cnt += bs.get(8);
        if (align) bs.skip((8 - (bs.pos & 7)) & 7);
        bs.skip(8 * cnt);
        break;
      }
      case 6: {  // FIL
        int cnt = bs.get(4);
        if (cnt == 15) cnt += bs.get(8) - 1;
        bs.skip(8 * cnt);
        break;
      }
      case 7:  // END
        return bs.err ? -1 : got;
      default:  // CCE / PCE unsupported in this profile
        return -4;
    }
  }
}

}  // namespace iamf_aac

// ------------------------------------------------------------- public API
using namespace iamf_aac;

extern "C" {

void* iamf_aac_open(int sr_index, int nch) {
  if (sr_index < 0 || sr_index > 12 || nch < 1 || nch > 2) return nullptr;
  init_books();
  init_fb();
  Decoder* d = new Decoder();
  d->sr_index = sr_index;
  d->nch = nch;
  d->swb_long = kSfbOffLong + 52 * sr_index;
  d->swb_short = kSfbOffShort + 16 * sr_index;
  d->n_swb_long = kSfbNumLong[sr_index];
  d->n_swb_short = kSfbNumShort[sr_index];
  d->tns_max_long = kTnsMaxBands[2 * sr_index];
  d->tns_max_short = kTnsMaxBands[2 * sr_index + 1];
  memset(d->overlap, 0, sizeof(d->overlap));
  d->prev_shape[0] = d->prev_shape[1] = -1;
  return d;
}

void iamf_aac_close(void* h) { delete (Decoder*)h; }

// Full host decode: out = planar float [nch][1024] at int16 scale.
// Returns samples per channel, or negative error.
int iamf_aac_decode(void* h, const uint8_t* au, int size, float* out) {
  Decoder* d = (Decoder*)h;
  Bits bs(au, size);
  int got = raw_data_block(bs, *d);
  if (got < 0) return got;
  if (got != d->nch) return -5;
  for (int c = 0; c < d->nch; c++)
    filterbank(d->ch[c].ics, d->ch[c].spec, d->overlap[c], d->prev_shape[c],
               out + 1024 * c);
  return 1024;
}

// Cumulative tool-usage counters: out[0..15] codebook sfb counts, [16] TNS
// filters, [17..20] window sequences, [21] M/S bands. reset != 0 clears.
void iamf_aac_debug_stats(int* out, int reset) {
  memcpy(out, g_stats, sizeof(g_stats));
  if (reset) memset(g_stats, 0, sizeof(g_stats));
}

// Spectrum export for the device filterbank: spec [nch][1024] (per-window
// order, post-TNS), meta [nch][3] = {window_sequence, window_shape,
// prev_window_shape}. Host keeps only the prev-shape state; overlap lives
// on the device. Returns samples per channel or negative error.
int iamf_aac_decode_spectrum(void* h, const uint8_t* au, int size,
                             float* spec, int* meta) {
  Decoder* d = (Decoder*)h;
  Bits bs(au, size);
  int got = raw_data_block(bs, *d);
  if (got < 0) return got;
  if (got != d->nch) return -5;
  for (int c = 0; c < d->nch; c++) {
    memcpy(spec + 1024 * c, d->ch[c].spec, 1024 * sizeof(float));
    int shape = d->ch[c].ics.window_shape;
    meta[3 * c] = d->ch[c].ics.window_sequence;
    meta[3 * c + 1] = shape;
    meta[3 * c + 2] = d->prev_shape[c] < 0 ? shape : d->prev_shape[c];
    d->prev_shape[c] = shape;
  }
  return 1024;
}

// Batched strided spectrum export: decode n consecutive AUs of ONE
// substream in a single GIL-free call, writing each frame's spectra and
// window metadata straight into the caller's packed arrays.
// spec_base/meta_base address frame 0 of this substream's first lane;
// row_stride/ch_stride are in floats (ints for meta, 3 per lane).
// One call per substream replaces the per-(frame, substream) ctypes loop
// (~900 calls/batch) exactly like flac_frame.cc's batched decode.
// Returns n, or the failing frame index encoded as -(1000 + idx) after a
// negative decode.
int iamf_aac_decode_spectrum_batch(void* h, const uint8_t* data,
                                   const int* sizes, int n,
                                   long long row_stride, long long ch_stride,
                                   float* spec_base, int* meta_base,
                                   long long meta_row_stride) {
  Decoder* d = (Decoder*)h;
  const uint8_t* p = data;
  for (int f = 0; f < n; ++f) {
    Bits bs(p, sizes[f]);
    int got = raw_data_block(bs, *d);
    if (got < 0 || got != d->nch) return -(1000 + f);
    float* spec = spec_base + (size_t)f * row_stride;
    int* meta = meta_base + (size_t)f * meta_row_stride;
    for (int c = 0; c < d->nch; c++) {
      memcpy(spec + (size_t)c * ch_stride, d->ch[c].spec,
             1024 * sizeof(float));
      int shape = d->ch[c].ics.window_shape;
      meta[3 * c] = d->ch[c].ics.window_sequence;
      meta[3 * c + 1] = shape;
      meta[3 * c + 2] = d->prev_shape[c] < 0 ? shape : d->prev_shape[c];
      d->prev_shape[c] = shape;
    }
    p += sizes[f];
  }
  return n;
}

}  // extern "C"
