// Opus packet layer (RFC 6716 §3): TOC parse, frame packing codes 0-3,
// and the decoder API exposed to Python via ctypes. CELT-mode packets are
// fully decoded by the from-scratch CELT implementation; SILK/hybrid modes
// return -10 (not yet implemented — LP layer scheduled next).
//
// Output matches the reference wrapper's convention: float samples obtained
// by decoding to s16 (saturating round-to-nearest, opus float2int16) then
// dividing by 32768 (IAMF_opus_decoder.c:130-136).

#include <chrono>
#include <cmath>
#include <cstdlib>
#include <cstring>

#include "celt.h"
#include "celt_tables.h"
#include "silk.h"

using namespace iamf_opus;

namespace {

struct OpusDec {
  CeltDecoder celt;
  iamf_silk::SilkDecoder silk;
  int channels;
  int prev_mode = -1;       // 0 silk, 1 hybrid, 2 celt
  int prev_redundancy = 0;  // last packet carried trailing (silk->celt)
                            // redundancy that primed the celt state
  float softclip_mem[2];
  // packet-loss concealment state: last decoded frame + decay factor
  // (energy-fade concealment analogous to the reference's
  // AAC_CONCEAL_METHOD=1 fade behavior, aac_multistream_decoder.c:224)
  float last_frame[2 * 2880];
  int last_samples = 0;
  float plc_gain = 1.f;
};

// Soft-clipping to +/-1 applied before s16 conversion (RFC 6716 decoder
// output stage; the quadratic x + a*x^2 segments between zero crossings,
// with cross-frame continuation memory).
void pcm_soft_clip(float* _x, int N, int C, float* declip_mem) {
  if (C < 1 || N < 1) return;
  for (int i = 0; i < N * C; ++i)
    _x[i] = _x[i] > 2.f ? 2.f : (_x[i] < -2.f ? -2.f : _x[i]);
  for (int c = 0; c < C; ++c) {
    float* x = _x + c;
    float a = declip_mem[c];
    int i;
    for (i = 0; i < N; ++i) {
      if (x[i * C] * a >= 0) break;
      x[i * C] = x[i * C] + a * x[i * C] * x[i * C];
    }
    int curr = 0;
    float x0 = x[0];
    while (1) {
      for (i = curr; i < N; ++i) {
        if (x[i * C] > 1 || x[i * C] < -1) break;
      }
      if (i == N) {
        a = 0;
        break;
      }
      int peak_pos = i;
      int start = i, end = i;
      float maxval = fabsf(x[i * C]);
      while (start > 0 && x[i * C] * x[(start - 1) * C] >= 0) start--;
      while (end < N && x[i * C] * x[end * C] >= 0) {
        if (fabsf(x[end * C]) > maxval) {
          maxval = fabsf(x[end * C]);
          peak_pos = end;
        }
        end++;
      }
      int special = (start == 0 && x[i * C] * x[0] >= 0);
      a = (maxval - 1) / (maxval * maxval);
      a += a * 2.4e-7f;
      if (x[i * C] > 0) a = -a;
      for (i = start; i < end; ++i)
        x[i * C] = x[i * C] + a * x[i * C] * x[i * C];

      if (special && peak_pos >= 2) {
        float offset = x0 - x[0];
        float delta = offset / peak_pos;
        for (i = curr; i < peak_pos; ++i) {
          offset -= delta;
          x[i * C] += offset;
          x[i * C] =
              x[i * C] > 1.f ? 1.f : (x[i * C] < -1.f ? -1.f : x[i * C]);
        }
      }
      curr = end;
      if (curr == N) break;
    }
    declip_mem[c] = a;
  }
}

struct PacketInfo {
  int mode;        // 0 silk, 1 hybrid, 2 celt
  int frame_size;  // samples at 48 kHz
  int stereo;
  int silk_khz;    // SILK internal rate (8/12/16), hybrid always 16
  int end_band;    // CELT end band (hybrid: 19 SWB / 21 FB)
  int nb_frames;
  const unsigned char* frames[48];
  int sizes[48];
};

int parse_frame_length(const unsigned char*& p, const unsigned char* end) {
  if (p >= end) return -1;
  int v = *p++;
  if (v >= 252) {
    if (p >= end) return -1;
    v += 4 * (*p++);
  }
  return v;
}

int parse_packet(const unsigned char* data, int len, PacketInfo* pi) {
  if (len < 1) return -1;
  int toc = data[0];
  int config = toc >> 3;
  pi->stereo = (toc >> 2) & 1;
  int code = toc & 3;

  static const int celt_sizes[4] = {120, 240, 480, 960};
  pi->silk_khz = 16;
  pi->end_band = 21;
  if (config >= 16) {
    pi->mode = 2;
    pi->frame_size = celt_sizes[config & 3];
    // end band per CELT bandwidth group (opus_decoder.c endband switch):
    // NB 13 / WB 17 / SWB 19 / FB 21
    static const int celt_end[4] = {13, 17, 19, 21};
    pi->end_band = celt_end[(config - 16) >> 2];
  } else if (config >= 12) {
    pi->mode = 1;
    pi->frame_size = (config & 1) ? 960 : 480;
    pi->end_band = config < 14 ? 19 : 21;  // SWB / FB
  } else {
    pi->mode = 0;
    static const int silk_sizes[4] = {480, 960, 1920, 2880};
    pi->frame_size = silk_sizes[config % 4];
    pi->silk_khz = config < 4 ? 8 : (config < 8 ? 12 : 16);
    // CELT end band per packet bandwidth (opus_decoder.c endband switch:
    // NB 13 / MB+WB 17) — governs the transition-redundancy decode
    pi->end_band = config < 4 ? 13 : 17;
  }

  const unsigned char* p = data + 1;
  const unsigned char* end = data + len;
  if (code == 0) {
    pi->nb_frames = 1;
    pi->frames[0] = p;
    pi->sizes[0] = (int)(end - p);
  } else if (code == 1) {
    int sz = (int)(end - p);
    if (sz & 1) return -1;
    pi->nb_frames = 2;
    pi->frames[0] = p;
    pi->sizes[0] = sz / 2;
    pi->frames[1] = p + sz / 2;
    pi->sizes[1] = sz / 2;
  } else if (code == 2) {
    int s0 = parse_frame_length(p, end);
    if (s0 < 0 || p + s0 > end) return -1;
    pi->nb_frames = 2;
    pi->frames[0] = p;
    pi->sizes[0] = s0;
    pi->frames[1] = p + s0;
    pi->sizes[1] = (int)(end - p - s0);
  } else {
    if (p >= end) return -1;
    int count = *p++;
    int vbr = count & 0x80;
    int padding = count & 0x40;
    int M = count & 0x3F;
    if (M == 0 || M > 48) return -1;
    int pad_len = 0;
    if (padding) {
      int pv;
      do {
        if (p >= end) return -1;
        pv = *p++;
        pad_len += pv == 255 ? 254 : pv;
      } while (pv == 255);
    }
    const unsigned char* payload_end = end - pad_len;
    pi->nb_frames = M;
    if (vbr) {
      int total = 0;
      for (int i = 0; i < M - 1; ++i) {
        int s = parse_frame_length(p, payload_end);
        if (s < 0) return -1;
        pi->sizes[i] = s;
        total += s;
      }
      for (int i = 0; i < M - 1; ++i) {
        pi->frames[i] = p;
        p += pi->sizes[i];
      }
      if (p > payload_end) return -1;
      pi->frames[M - 1] = p;
      pi->sizes[M - 1] = (int)(payload_end - p);
    } else {
      int sz = (int)(payload_end - p);
      if (sz % M) return -1;
      for (int i = 0; i < M; ++i) {
        pi->frames[i] = p + i * (sz / M);
        pi->sizes[i] = sz / M;
      }
    }
  }
  return 0;
}

inline int16_t float2int16(float x) {
  x *= 32768.f;
  x = x > 32767.f ? 32767.f : x;
  x = x < -32768.f ? -32768.f : x;
  return (int16_t)lrintf(x);
}

}  // namespace

extern "C" {

void* iamf_opus_decoder_create(int channels) {
  OpusDec* d = new OpusDec();
  d->channels = channels;
  d->celt.init(channels);
  return d;
}

void iamf_opus_decoder_destroy(void* p) { delete (OpusDec*)p; }

// Decode one Opus packet. out: interleaved float [samples][channels].
// Returns samples per channel, or negative error (-10: SILK mode).
int iamf_opus_decode_float(void* ptr, const unsigned char* data, int len,
                           float* out, int max_samples) {
  OpusDec* d = (OpusDec*)ptr;
  if (data == nullptr || len == 0) {
    int n = d->last_samples > 0 ? d->last_samples : 960;
    if (n > max_samples) return -2;
    if (d->prev_mode == 2) {
      // CELT-mode loss: pitch-based PLC on the decode history (pitch
      // search + LPC excitation extrapolation with decay, falling back to
      // background-noise CNG after 100 ms — libopus celt_decode_lost
      // semantics, celt_plc.cc). Concealed in CELT frame-size chunks.
      int done = 0;
      while (done < n) {
        int chunk = n - done > 960 ? 960 : n - done;
        int r = celt_conceal_frame(&d->celt, out + (size_t)done * d->channels,
                                   chunk);
        if (r < 0) return r;
        done += r;
      }
    } else {
      // SILK/hybrid-mode loss: SILK's own LTP-based PLC (LTP
      // extrapolation + LPC synthesis over randomized excitation,
      // silk/PLC.c semantics in silk_decoder.cc); hybrid losses add the
      // CELT layer's concealment (noise CNG above band 17, since the
      // hybrid celt history starts at band 17) exactly as
      // opus_decoder.c's data==NULL path runs both layers
      int16_t sbuf[2 * 2880];
      int done = d->silk.conceal(d->channels, n / 48, sbuf);
      if (done == n) {
        for (int i = 0; i < n * d->channels; ++i)
          out[i] = sbuf[i] * (1.f / 32768.f);
        if (d->prev_mode == 1) {
          float celt_pcm[2 * 960];
          int doneC = 0;
          while (doneC < n) {
            int chunk = n - doneC > 960 ? 960 : n - doneC;
            if (celt_conceal_frame(&d->celt, celt_pcm, chunk) == chunk) {
              for (int i = 0; i < chunk * d->channels; ++i)
                out[(size_t)doneC * d->channels + i] += celt_pcm[i];
            }
            doneC += chunk;
          }
        }
      } else {
        // conceal before any decode: fall back to energy-fade repeat
        d->plc_gain *= 0.5f;
        for (int i = 0; i < n * d->channels; ++i)
          out[i] = d->last_frame[i] * d->plc_gain;
      }
    }
    // concealed frames take the same output tail as normal frames
    // (soft clip + s16 round-trip, IAMF_opus_decoder.c:130-136)
    if (!getenv("IAMF_NO_CLIP")) {
      pcm_soft_clip(out, n, d->channels, d->softclip_mem);
      for (int i = 0; i < n * d->channels; ++i)
        out[i] = float2int16(out[i]) / 32768.f;
    }
    return n;
  }
  PacketInfo pi;
  if (parse_packet(data, len, &pi) < 0) return -4;
  int pkt_ch = pi.stereo ? 2 : 1;
  if (pkt_ch != d->channels) {
    // stream channel count must match (IAMF opens per-substream decoders
    // with the exact channel count)
    d->celt.stream_channels = pkt_ch;
  }
  // state resets on mode transitions (opus_decoder.c semantics); the
  // celt reset happens per frame below, gated on prev_redundancy
  if ((pi.mode == 0 || pi.mode == 1) && d->prev_mode == 2) d->silk.reset();
  int total = 0;
  for (int f = 0; f < pi.nb_frames; ++f) {
    if (total + pi.frame_size > max_samples) return -2;
    float* pcm_out = out + (size_t)total * d->channels;
    EntDec dec;
    dec.init(pi.frames[f], (uint32_t)pi.sizes[f]);
    if (pi.mode == 2) {
      // discard previous celt state on a mode change UNLESS the previous
      // packet's trailing redundancy frame already primed it
      // (opus_decoder.c: reset when prev_mode differs && !prev_redundancy)
      if (d->prev_mode >= 0 && d->prev_mode != 2 && !d->prev_redundancy)
        d->celt.init(d->channels);
      int ret = celt_decode_frame_bands(&d->celt, pi.frames[f], pi.sizes[f],
                                        pcm_out, pi.frame_size, &dec, 0,
                                        pi.end_band);
      if (ret < 0) return ret;
      total += ret;
      d->prev_mode = 2;
      d->prev_redundancy = 0;
      continue;
    }
    // SILK / hybrid: LP layer from the shared range decoder
    int ms = pi.frame_size / 48;
    int16_t silk_buf[2 * 2880];
    int done = d->silk.decode(dec, pi.silk_khz, pkt_ch, d->channels, ms, 1,
                              silk_buf);
    if (done < 0 || dec.error) return -3;
    if (done != pi.frame_size) return -3;
    for (int i = 0; i < done * d->channels; ++i)
      pcm_out[i] = silk_buf[i] * (1.f / 32768.f);
    // redundancy signalling (RFC 6716 §4.4 transition side information):
    // a redundant 5 ms CELT frame at the end of the payload smooths mode
    // transitions (celt_to_silk covers THIS frame's start after a CELT
    // packet; otherwise it primes the NEXT CELT packet and fades this
    // frame's tail) — blended exactly as opus_decoder.c does
    int redundancy = 0, redundancy_bytes = 0, celt_to_silk = 0;
    if (dec.tell() + 17 + 20 * (pi.mode == 1) <= 8 * pi.sizes[f]) {
      redundancy = pi.mode == 1 ? dec.bit_logp(12) : 1;
      if (redundancy) {
        celt_to_silk = dec.bit_logp(1);
        redundancy_bytes = pi.mode == 1
                               ? (int)dec.uint(256) + 2
                               : pi.sizes[f] - ((dec.tell() + 7) >> 3);
        if (redundancy_bytes < 0 || redundancy_bytes > pi.sizes[f])
          return -3;
        // the hybrid celt layer reads its PVQ raw bits from the END of
        // the range-coder buffer: shrink the shared decoder so those
        // reads stop before the redundancy bytes (opus_decoder.c
        // "dec.storage -= redundancy_bytes")
        dec.storage -= (uint32_t)redundancy_bytes;
      }
    }
    const int F2_5 = 120, F5 = 240;  // 2.5 / 5 ms at 48 kHz
    int celt_len = pi.sizes[f] - redundancy_bytes;
    const unsigned char* red_data = pi.frames[f] + celt_len;
    float redundant_audio[2 * F5];
    int have_red_start = 0;
    if (redundancy && celt_to_silk) {
      // CELT -> SILK: redundancy covers this frame's first 5 ms; decoded
      // CONTINUING the previous packet's celt state (no reset — its IMDCT
      // overlap tail must flow into the redundant frame's first samples;
      // opus_decoder.c resets only in the silk->celt branch)
      EntDec rdec;
      rdec.init(red_data, (uint32_t)redundancy_bytes);
      int r = celt_decode_frame_bands(&d->celt, red_data, redundancy_bytes,
                                      redundant_audio, F5, &rdec, 0,
                                      pi.end_band);
      have_red_start = (r == F5);
    }
    if (pi.mode == 1) {
      // hybrid: CELT bands 17..end from the same range decoder; with a
      // celt_to_silk redundancy frame just decoded, the layer CONTINUES
      // that state (its energies seed the band-17+ prediction) — no reset
      if (d->prev_mode >= 0 && d->prev_mode != 1 && !d->prev_redundancy)
        d->celt.init(d->channels);
      float celt_pcm[2 * 960];
      int ret = celt_decode_frame_bands(&d->celt, pi.frames[f], celt_len,
                                        celt_pcm, pi.frame_size, &dec, 17,
                                        pi.end_band);
      if (ret < 0) return ret;
      for (int i = 0; i < ret * d->channels; ++i) pcm_out[i] += celt_pcm[i];
    }
    if (redundancy && !celt_to_silk) {
      // SILK -> CELT: the redundancy primes the celt state for the next
      // packet; crossfade this frame's tail into its second half
      d->celt.init(d->channels);
      EntDec rdec;
      rdec.init(red_data, (uint32_t)redundancy_bytes);
      int r = celt_decode_frame_bands(&d->celt, red_data, redundancy_bytes,
                                      redundant_audio, F5, &rdec, 0,
                                      pi.end_band);
      if (r == F5) {
        float* tail = pcm_out + (size_t)(pi.frame_size - F2_5) * d->channels;
        for (int i = 0; i < F2_5; ++i) {
          float w = window120[i] * window120[i];
          for (int c = 0; c < d->channels; ++c)
            tail[i * d->channels + c] =
                w * redundant_audio[(F2_5 + i) * d->channels + c] +
                (1.f - w) * tail[i * d->channels + c];
        }
      }
    }
    if (have_red_start) {
      // replace the first 2.5 ms with the redundant frame, crossfade the
      // next 2.5 ms from redundancy into this frame's audio
      for (int i = 0; i < F2_5 * d->channels; ++i)
        pcm_out[i] = redundant_audio[i];
      for (int i = 0; i < F2_5; ++i) {
        float w = window120[i] * window120[i];
        for (int c = 0; c < d->channels; ++c) {
          int k = (F2_5 + i) * d->channels + c;
          pcm_out[k] = w * pcm_out[k] + (1.f - w) * redundant_audio[k];
        }
      }
    }
    total += pi.frame_size;
    d->prev_mode = pi.mode;
    d->prev_redundancy = redundancy && !celt_to_silk;
  }
  // match reference: soft clip + s16 quantize + scale back
  // (the reference wrapper uses the opus s16 decode API,
  // IAMF_opus_decoder.c:130-136, which soft-clips in the float build)
  if (!getenv("IAMF_NO_CLIP")) {
    pcm_soft_clip(out, total, d->channels, d->softclip_mem);
    for (int i = 0; i < total * d->channels; ++i)
      out[i] = float2int16(out[i]) / 32768.f;
  }
  // remember the last decoded frame (post-quantize, so concealment
  // replays exactly what the caller last heard) for packet loss
  if (total > 0 && total <= 2880) {
    memcpy(d->last_frame, out, sizeof(float) * total * d->channels);
    d->last_samples = total;
    d->plc_gain = 1.f;
  }
  return total;
}
}

extern "C" void iamf_soft_clip(float* x, int N, int C, float* mem) {
  pcm_soft_clip(x, N, C, mem);
}

// IAMF_PROF=1 stage accumulators (celt.h prof_ns): out[4] receives
// nanoseconds spent in {pre-band entropy, quant_all_bands PVQ,
// anti-collapse+denormalise+state, hybrid SILK}; reset!=0 zeroes them.
extern "C" void iamf_opus_prof_read(long long* out, int reset) {
  for (int i = 0; i < 8; ++i) {
    out[i] = iamf_opus::prof_ns[i].load(std::memory_order_relaxed);
    if (reset) iamf_opus::prof_ns[i].store(0, std::memory_order_relaxed);
  }
}

// ---- spectrum-export API for the device synthesis path -----------------
// Decodes the entropy/PVQ layers on the host and exports the denormalised
// spectrum (freq domain, [C][960] stride, first N entries valid) plus
// per-frame synthesis metadata; the device pipeline performs IMDCT (
// matmul) + overlap + post-filter + de-emphasis. States that live in the
// bitstream layer (energy prediction, LCG seed, range-coder reseed) stay
// in the host decoder. Covers CELT mode at every frame size (120/240/480/
// 960) and packing code (multi-frame packets export one row per OPUS
// frame), and hybrid mode (SILK half decoded host-side — bit-exact — and
// exported at s16 value scale for the device to add post-deemphasis,
// opus_decoder.c hybrid split). SILK-only packets return -10: they carry
// no CELT synthesis, so the host float path decodes them outright and the
// device runs only the decode pipeline.

extern "C" {

struct SpectrumMeta {
  int samples;        // opus frame size N (0 on error)
  int transient;      // shortBlocks != 0
  int pf_period_old;  // post-filter params at frame start ("old" set)
  float pf_gain_old;
  int pf_tapset_old;
  int pf_period;      // params decoded last frame ("current" set)
  float pf_gain;
  int pf_tapset;
  int pf_period_new;  // params decoded this frame ("new" set)
  float pf_gain_new;
  int pf_tapset_new;
};

// Decode every opus frame of ONE packet to spectra. freq_out/silk_out:
// [max_frames][channels][960] (silk_out may be null for CELT streams).
// Returns frames decoded, or negative error (-10 silk-only, -12 hybrid
// redundancy side information — mode-transition streams take the host
// decode path).
static int spectrum_frames_strided(OpusDec* d, const unsigned char* data,
                                   int len, float* freq_base,
                                   float* silk_base, long row_stride,
                                   long ch_stride, SpectrumMeta* metas,
                                   int max_frames) {
  PacketInfo pi;
  if (parse_packet(data, len, &pi) < 0) return -4;
  if (pi.mode == 0) return -10;
  if (pi.nb_frames > max_frames || pi.frame_size > 960) return -2;
  int ch = d->channels;
  int pkt_ch = pi.stereo ? 2 : 1;
  d->celt.stream_channels = pkt_ch;
  for (int f = 0; f < pi.nb_frames; ++f) {
    float* freq = freq_base + (size_t)f * row_stride;
    SpectrumMeta* m = metas + f;
    EntDec dec;
    dec.init(pi.frames[f], (uint32_t)pi.sizes[f]);
    m->pf_period_old = d->celt.postfilter_period_old;
    m->pf_gain_old = d->celt.postfilter_gain_old;
    m->pf_tapset_old = d->celt.postfilter_tapset_old;
    m->pf_period = d->celt.postfilter_period;
    m->pf_gain = d->celt.postfilter_gain;
    m->pf_tapset = d->celt.postfilter_tapset;
    int start = 0;
    if (pi.mode == 1) {
      // hybrid: SILK layer on the host (bit-exact vs libopus), CELT bands
      // 17+ from the shared range decoder on the device
      if (!silk_base) return -2;
      float* silk = silk_base + (size_t)f * row_stride;
      int16_t silk_buf[2 * 960];
      std::chrono::steady_clock::time_point _st;
      if (iamf_opus::prof_enabled()) _st = std::chrono::steady_clock::now();
      int done = d->silk.decode(dec, pi.silk_khz, pkt_ch, ch,
                                pi.frame_size / 48, 1, silk_buf);
      if (iamf_opus::prof_enabled())
        iamf_opus::prof_ns[3].fetch_add(
            std::chrono::duration_cast<std::chrono::nanoseconds>(
                std::chrono::steady_clock::now() - _st).count(),
            std::memory_order_relaxed);
      if (done != pi.frame_size || dec.error) return -3;
      for (int i = 0; i < done; ++i)
        for (int c = 0; c < ch; ++c)
          silk[c * ch_stride + i] = (float)silk_buf[i * ch + c];
      // redundancy side information needs host celt synthesis state
      // (RFC 6716 §4.4); pure hybrid streams never carry it
      if (dec.tell() + 37 <= 8 * pi.sizes[f]) {
        if (dec.bit_logp(12)) return -12;
      }
      start = 17;
    }
    int transient = 0;
    int ret = celt_decode_spectrum_bands(&d->celt, pi.frames[f],
                                         pi.sizes[f], freq, pi.frame_size,
                                         &dec, &transient, start,
                                         pi.end_band, ch_stride);
    if (ret < 0) return ret;
    m->samples = ret;
    m->transient = transient;
    m->pf_period_new = d->celt.postfilter_period;
    m->pf_gain_new = d->celt.postfilter_gain;
    m->pf_tapset_new = d->celt.postfilter_tapset;
  }
  d->prev_mode = pi.mode;
  return pi.nb_frames;
}

int iamf_opus_decode_spectrum_frames(void* ptr, const unsigned char* data,
                                     int len, float* freq_out,
                                     float* silk_out, SpectrumMeta* metas,
                                     int max_frames) {
  OpusDec* d = (OpusDec*)ptr;
  long ch = d->channels;
  return spectrum_frames_strided(d, data, len, freq_out, silk_out, ch * 960,
                                 960, metas, max_frames);
}

// Batch form: decode `n_packets` consecutive packets of ONE substream in a
// single call (packets concatenated in `data`, per-packet byte sizes in
// `sizes`). freq_out/silk_out are [n_packets*frames_per_packet][ch][960];
// metas likewise. One long GIL-free native stretch per substream, so
// substreams decode on parallel host threads (their codec states are
// independent by construction — each IAMF substream is a self-contained
// Opus stream). On error the failing packet index is written to
// metas[0].samples and the bare error code returned.
int iamf_opus_decode_spectrum_batch2(void* ptr, const unsigned char* data,
                                     const int* sizes, int n_packets,
                                     int frames_per_packet, int channels,
                                     float* freq_out, float* silk_out,
                                     SpectrumMeta* metas) {
  const unsigned char* p = data;
  for (int k = 0; k < n_packets; ++k) {
    size_t base = (size_t)k * frames_per_packet;
    int r = spectrum_frames_strided(
        (OpusDec*)ptr, p, sizes[k], freq_out + base * channels * 960,
        silk_out ? silk_out + base * channels * 960 : nullptr,
        (long)channels * 960, 960, metas + base, frames_per_packet);
    if (r < 0 || r != frames_per_packet) {
      metas[0].samples = k;
      return r < 0 ? r : -5;
    }
    p += sizes[k];
  }
  return n_packets * frames_per_packet;
}

// Strided batch form: identical to batch2 but writes every exported row
// straight into the caller's packed [R, L, W] float32 h2d buffer (freq at
// column 0 of this substream's first lane; hybrid SILK pcm at silk_base =
// freq_base + packed silk column offset). row_stride = L*W floats between
// consecutive frame rows, ch_stride = W floats between the substream's
// lanes — eliminates the [R][ch][960] scratch array and the Python-side
// 70 MB/stream scatter copy the old API required.
int iamf_opus_decode_spectrum_batch3(void* ptr, const unsigned char* data,
                                     const int* sizes, int n_packets,
                                     int frames_per_packet, long long row_stride,
                                     long long ch_stride, float* freq_base,
                                     float* silk_base, SpectrumMeta* metas) {
  const unsigned char* p = data;
  for (int k = 0; k < n_packets; ++k) {
    size_t base = (size_t)k * frames_per_packet;
    int r = spectrum_frames_strided(
        (OpusDec*)ptr, p, sizes[k], freq_base + base * row_stride,
        silk_base ? silk_base + base * row_stride : nullptr,
        (long)row_stride, (long)ch_stride, metas + base, frames_per_packet);
    if (r < 0 || r != frames_per_packet) {
      metas[0].samples = k;
      return r < 0 ? r : -5;
    }
    p += sizes[k];
  }
  return n_packets * frames_per_packet;
}

// Host decode path batch (SILK-only and mixed-mode streams): full float
// decode of consecutive packets in one GIL-free call; out is
// [n][samples_per_packet][channels] interleaved.
int iamf_opus_decode_float_batch(void* ptr, const unsigned char* data,
                                 const int* sizes, int n, float* out,
                                 int samples_per_packet) {
  OpusDec* d = (OpusDec*)ptr;
  const unsigned char* p = data;
  for (int k = 0; k < n; ++k) {
    int r = iamf_opus_decode_float(
        ptr, p, sizes[k],
        out + (size_t)k * samples_per_packet * d->channels,
        samples_per_packet);
    if (r < 0) return r;
    if (r != samples_per_packet) return -5;
    p += sizes[k];
  }
  return n;
}
}

// IAMF_BAND_STATS census reader: out[14] = {pvq_leaves, pvq_bins,
// fold_leaves, fold_bins, noise_leaves, noise_bins, zero_leaves,
// zero_bins, splits, theta_calls, haar_calls, haar_bins, stereo_bands,
// frames}; out[14] = max leaves in one frame. reset!=0 zeroes them.
extern "C" void iamf_opus_band_stats(long long* out, int reset) {
  using namespace iamf_opus;
  std::atomic<long long>* f[] = {
      &g_band_stats.pvq_leaves,   &g_band_stats.pvq_bins,
      &g_band_stats.fold_leaves,  &g_band_stats.fold_bins,
      &g_band_stats.noise_leaves, &g_band_stats.noise_bins,
      &g_band_stats.zero_leaves,  &g_band_stats.zero_bins,
      &g_band_stats.splits,       &g_band_stats.theta_calls,
      &g_band_stats.haar_calls,   &g_band_stats.haar_bins,
      &g_band_stats.stereo_bands, &g_band_stats.frames,
      &g_band_stats.max_leaves_frame};
  for (int i = 0; i < 15; ++i) {
    out[i] = f[i]->load(std::memory_order_relaxed);
    if (reset) f[i]->store(0, std::memory_order_relaxed);
  }
}

// cwrsi micro-bench + correctness shim: decode `count` recorded PVQ
// leaves (n[i], k[i], idx[i]) into y_out[count][208], repeated `reps`
// times; returns nanoseconds per rep. Used by the device-kernel experiment
// to establish the host baseline on REAL leaf data.
extern "C" long long iamf_cwrsi_bench(const int* n, const int* k,
                                      const uint32_t* idx, int count,
                                      int reps, int* y_out) {
  auto t0 = std::chrono::steady_clock::now();
  for (int r = 0; r < reps; ++r)
    for (int c = 0; c < count; ++c)
      iamf_opus::cwrsi_export(n[c], k[c], idx[c], y_out + (size_t)c * 208);
  auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration_cast<std::chrono::nanoseconds>(t1 - t0)
             .count() / (reps > 0 ? reps : 1);
}

// LeafTap reader: copies up to max_count recorded (n, k, index) triples;
// returns the number recorded (reset!=0 zeroes the tap).
extern "C" long long iamf_leaf_tap_read(int* n, int* k, uint32_t* idx,
                                        long long max_count, int reset) {
  using iamf_opus::g_leaf_tap;
  long long c = g_leaf_tap.count.load(std::memory_order_relaxed);
  if (c > (1 << 20)) c = 1 << 20;
  if (c > max_count) c = max_count;
  for (long long i = 0; i < c; ++i) {
    n[i] = g_leaf_tap.n[i];
    k[i] = g_leaf_tap.k[i];
    idx[i] = g_leaf_tap.idx[i];
  }
  if (reset) g_leaf_tap.count.store(0, std::memory_order_relaxed);
  return c;
}

// Extended LeafTap reader (level 2): also copies gain/spread/blocks and
// the post-rotation X prefixes for the device leaf-reconstruction oracle.
extern "C" long long iamf_leaf_tap_read2(int* n, int* k, uint32_t* idx,
                                         float* gain, int* spread,
                                         int* blocks, float* x,
                                         long long max_count, int reset) {
  using iamf_opus::g_leaf_tap;
  using iamf_opus::LeafTap;
  long long c = g_leaf_tap.count.load(std::memory_order_relaxed);
  if (c > LeafTap::CAP) c = LeafTap::CAP;
  if (c > max_count) c = max_count;
  for (long long i = 0; i < c; ++i) {
    n[i] = g_leaf_tap.n[i];
    k[i] = g_leaf_tap.k[i];
    idx[i] = g_leaf_tap.idx[i];
    gain[i] = g_leaf_tap.gain[i];
    spread[i] = g_leaf_tap.spread[i];
    blocks[i] = g_leaf_tap.blocks[i];
    if (i < LeafTap::XCAP)
      memcpy(x + i * LeafTap::XW, g_leaf_tap.x[i],
             LeafTap::XW * sizeof(float));
  }
  if (reset) g_leaf_tap.count.store(0, std::memory_order_relaxed);
  return c;
}

// exp_rotation shim for the device leaf-reconstruction experiment: the
// host builds each (N,K,spread,B) rotation as a dense matrix by pushing
// unit vectors through the exact spreading rotation.
extern "C" void iamf_exp_rotation(float* X, int len, int dir, int stride,
                                  int K, int spread) {
  iamf_opus::exp_rotation(X, len, dir, stride, K, spread);
}

// Band-emit control for the device band-walk experiment: enable installs
// a per-thread EmitBuf (serial decode only); read copies `count` records
// of 16 u32 fields and optionally resets.
static thread_local iamf_opus::EmitBuf* t_emit_owned = nullptr;
extern "C" void iamf_band_emit_enable(int on) {
  using iamf_opus::g_emit;
  if (on) {
    if (!t_emit_owned) t_emit_owned = new iamf_opus::EmitBuf();
    t_emit_owned->count = 0;
    g_emit = t_emit_owned;
  } else {
    g_emit = nullptr;
  }
}
extern "C" long long iamf_band_emit_read(uint32_t* out, long long max_recs,
                                         int reset) {
  if (!t_emit_owned) return 0;
  long long c = t_emit_owned->count;
  if (c > max_recs) c = max_recs;
  memcpy(out, t_emit_owned->rec, (size_t)c * 16 * sizeof(uint32_t));
  if (reset) t_emit_owned->count = 0;
  return c;
}

// Band-tap accessor for the replay harness (g_band_tap lives in
// celt_decoder.cc; test_shim.cc exposes the same pointer for the shim
// builds — this one serves the main library).
extern "C" void* iamf_band_tap_ptr() { return &iamf_opus::g_band_tap; }

extern "C" void iamf_leaf_tap_set(int level) {
  iamf_opus::leaf_tap_set(level);
}
