// CELT frame decoder orchestration (RFC 6716 §4.3): flags, post-filter
// parameters, coarse/fine energy, tf, spread, dynalloc, allocation, band
// decode, anti-collapse, denormalisation, IMDCT synthesis, post-filter
// (comb), de-emphasis.

#include <chrono>
#include <cmath>
#include <cstring>

#include <cstdio>
#include <cstdlib>

#include "celt.h"
#include "celt_tables.h"

namespace iamf_opus {

BandTap g_band_tap;

std::atomic<long long> prof_ns[8];
bool prof_enabled() {
  static const bool on = getenv("IAMF_PROF") != nullptr;
  return on;
}

static inline int imin(int a, int b) { return a < b ? a : b; }
static inline int imax(int a, int b) { return a > b ? a : b; }

void comb_filter(float* y, float* x, int T0, int T1, int N, float g0, float g1,
                 int tapset0, int tapset1, const float* window, int overlap) {
  if (g0 == 0 && g1 == 0) {
    if (x != y) memmove(y, x, N * sizeof(float));
    return;
  }
  T0 = imax(T0, COMBFILTER_MINPERIOD);
  T1 = imax(T1, COMBFILTER_MINPERIOD);
  // postfilter tap gain sets (celt.c `gains` table, extracted)
  float g00 = g0 * gains[tapset0 * 3 + 0];
  float g01 = g0 * gains[tapset0 * 3 + 1];
  float g02 = g0 * gains[tapset0 * 3 + 2];
  float g10 = g1 * gains[tapset1 * 3 + 0];
  float g11 = g1 * gains[tapset1 * 3 + 1];
  float g12 = g1 * gains[tapset1 * 3 + 2];
  float x1 = x[-T1 + 1];
  float x2 = x[-T1];
  float x3 = x[-T1 - 1];
  float x4 = x[-T1 - 2];
  if (g0 == g1 && T0 == T1 && tapset0 == tapset1) overlap = 0;
  int i = 0;
  for (; i < overlap; ++i) {
    float f = window[i] * window[i];
    float x0 = x[i - T1 + 2];
    y[i] = x[i] + (1.f - f) * g00 * x[i - T0] +
           (1.f - f) * g01 * (x[i - T0 + 1] + x[i - T0 - 1]) +
           (1.f - f) * g02 * (x[i - T0 + 2] + x[i - T0 - 2]) + f * g10 * x2 +
           f * g11 * (x1 + x3) + f * g12 * (x0 + x4);
    x4 = x3;
    x3 = x2;
    x2 = x1;
    x1 = x0;
  }
  if (g1 == 0) {
    if (x != y) memmove(y + overlap, x + overlap, (N - overlap) * sizeof(float));
    return;
  }
  for (; i < N; ++i) {
    y[i] = x[i] + g10 * x[i - T1] + g11 * (x[i - T1 + 1] + x[i - T1 - 1]) +
           g12 * (x[i - T1 + 2] + x[i - T1 - 2]);
  }
}

static void deemphasis(float* const* in, float* pcm, int N, int C, float coef0,
                       float* mem) {
  for (int c = 0; c < C; ++c) {
    float m = mem[c];
    const float* x = in[c];
    float* y = pcm + c;
    for (int j = 0; j < N; ++j) {
      float tmp = x[j] + 1e-30f + m;
      m = coef0 * tmp;
      y[j * C] = tmp * (1.f / CELT_SIG_SCALE);
    }
    mem[c] = m;
  }
}

// When freq_export != nullptr the synthesis stages (IMDCT, overlap,
// post-filter, de-emphasis) are skipped and the denormalised spectrum is
// written to freq_export[CC][960] instead — the device pipeline evaluates them
// as batched matmuls + scans (codecs/opus/tpu_synth.py). All host-side state
// (energy prediction, post-filter param rollover, LCG reseed) is updated
// identically so the two paths can't diverge at the bitstream layer.
static int celt_decode_frame_ex(CeltDecoder* st, const unsigned char* data,
                                int len, float* pcm, int frame_size,
                                EntDec* dec, float* freq_export,
                                int* transient_out, int start_band = 0,
                                int end_band = NB_EBANDS,
                                long freq_stride = 960) {
  const bool _prof = prof_enabled();
  std::chrono::steady_clock::time_point _pt;
  if (_prof) _pt = std::chrono::steady_clock::now();
  auto _mark = [&](int slot) {
    if (!_prof) return;
    auto n = std::chrono::steady_clock::now();
    prof_ns[slot].fetch_add(
        std::chrono::duration_cast<std::chrono::nanoseconds>(n - _pt)
            .count(),
        std::memory_order_relaxed);
    _pt = n;
  };
  const short* eBands = mode_eBands();
  int C = st->stream_channels;
  int CC = st->channels;
  int N = frame_size;
  int LM;
  for (LM = 0; LM <= MAX_LM; ++LM)
    if (SHORT_MDCT_SIZE << LM == N) break;
  if (LM > MAX_LM) return -1;
  int M = 1 << LM;
  int start = start_band, end = end_band, effEnd = end_band;
  int total_bits = len * 8;

  float* oldBandE = st->oldEBands;
  float* oldLogE = st->oldLogE;
  float* oldLogE2 = st->oldLogE2;

  int tell = dec->tell();
  int silence = 0;
  if (tell >= total_bits)
    silence = 1;
  else if (tell == 1)
    silence = dec->bit_logp(15);
  if (silence) {
    // consume the rest of the frame
    tell = total_bits;
    dec->nbits_total += tell - dec->tell();
  }

  int postfilter_gain_i = 0;
  float postfilter_gain = 0;
  int postfilter_pitch = 0;
  int postfilter_tapset = 0;
  if (start == 0 && tell + 16 <= total_bits) {
    if (dec->bit_logp(1)) {
      int octave = (int)dec->uint(6);
      postfilter_pitch = (16 << octave) + (int)dec->bits(4 + octave) - 1;
      int qg = (int)dec->bits(3);
      if (dec->tell() + 2 <= total_bits)
        postfilter_tapset = dec->icdf(tapset_icdf, 2);
      postfilter_gain = 0.09375f * (qg + 1);
    }
    tell = dec->tell();
  }
  (void)postfilter_gain_i;

  int isTransient = 0;
  if (LM > 0 && tell + 3 <= total_bits) {
    isTransient = dec->bit_logp(3);
    tell = dec->tell();
  }
  int shortBlocks = isTransient ? M : 0;

  int intra_ener = 0;
  if (tell + 3 <= total_bits) intra_ener = dec->bit_logp(3);

  unquant_coarse_energy(start, end, oldBandE, intra_ener, *dec, C, LM);

  int tf_res[NB_EBANDS];
  tf_decode(start, end, isTransient, tf_res, LM, *dec);

  tell = dec->tell();
  int spread_decision = SPREAD_NORMAL;
  if (tell + 4 <= total_bits) spread_decision = dec->icdf(spread_icdf, 5);

  int cap[NB_EBANDS];
  init_caps(cap, LM, C);

  int offsets[NB_EBANDS];
  memset(offsets, 0, sizeof(offsets));
  int dynalloc_logp = 6;
  int total_bits_frac = total_bits << BITRES;
  int tell_frac = (int)dec->tell_frac();
  int total_boost = 0;
  for (int i = start; i < end; ++i) {
    int width = C * (eBands[i + 1] - eBands[i]) << LM;
    int quanta = imin(width << BITRES, imax(6 << BITRES, width));
    int dynalloc_loop_logp = dynalloc_logp;
    int boost = 0;
    while (tell_frac + (dynalloc_loop_logp << BITRES) <
               total_bits_frac - total_boost &&
           boost < cap[i]) {
      int flag = dec->bit_logp(dynalloc_loop_logp);
      tell_frac = (int)dec->tell_frac();
      if (!flag) break;
      boost += quanta;
      total_boost += quanta;
      dynalloc_loop_logp = 1;
    }
    offsets[i] = boost;
    if (boost > 0) dynalloc_logp = imax(2, dynalloc_logp - 1);
  }

  int alloc_trim = 5;
  tell_frac = (int)dec->tell_frac();
  if (tell_frac + (6 << BITRES) <= total_bits_frac - total_boost)
    alloc_trim = dec->icdf(trim_icdf, 7);

  int bits = (((int)len * 8) << BITRES) - (int)dec->tell_frac() - 1;
  int anti_collapse_rsv =
      isTransient && LM >= 2 && bits >= ((LM + 2) << BITRES) ? (1 << BITRES)
                                                            : 0;
  bits -= anti_collapse_rsv;

  if (getenv("IAMF_CELT_DEBUG"))
    fprintf(stderr,
            "frame: len=%d silence=%d pf(pitch=%d gain=%.3f tap=%d) "
            "transient=%d intra=%d spread=%d trim=%d tell=%d\n",
            len, silence, postfilter_pitch, postfilter_gain,
            postfilter_tapset, isTransient, intra_ener, spread_decision,
            alloc_trim, dec->tell());
  int pulses[NB_EBANDS], fine_quant[NB_EBANDS], fine_priority[NB_EBANDS];
  int intensity = 0, dual_stereo = 0, balance = 0;
  int codedBands = compute_allocation(
      start, end, offsets, cap, alloc_trim, &intensity, &dual_stereo, bits,
      &balance, pulses, fine_quant, fine_priority, C, LM, dec);

  unquant_fine_energy(start, end, oldBandE, fine_quant, *dec, C);

  // X buffers: C * (M*eBands[21]) + scratch slack
  static thread_local float Xbuf[2 * 8 * 100 + 8 * 100];
  float* X = Xbuf;
  float* Y = C == 2 ? Xbuf + M * eBands[NB_EBANDS] : nullptr;
  // NOTE: lowband_scratch in quant_all_bands_decode points past
  // X_+M*eBands[nbEBands-1]; the X buffer above leaves room.

  unsigned char collapse_masks[2 * NB_EBANDS];
  uint32_t seed = st->rng;

  BandTap* tap = nullptr;
  if (getenv("IAMF_BAND_TAP")) {
    tap = &g_band_tap;
    tap->valid = 1;
    tap->start = start; tap->end = end; tap->shortBlocks = shortBlocks;
    tap->spread = spread_decision; tap->dual_stereo = dual_stereo;
    tap->intensity = intensity; tap->LM = LM; tap->codedBands = codedBands;
    tap->total_bits = len * 8 << BITRES; tap->balance = balance;
    tap->C = C; tap->len = len;
    memcpy(tap->pulses, pulses, sizeof(pulses));
    memcpy(tap->tf_res, tf_res, sizeof(tf_res));
    tap->ec_offs = dec->offs; tap->ec_rng = dec->rng; tap->ec_val = dec->val;
    tap->ec_ext = dec->ext; tap->ec_end_offs = dec->end_offs;
    tap->ec_end_window = dec->end_window; tap->ec_nend_bits = dec->nend_bits;
    tap->ec_nbits_total = dec->nbits_total; tap->ec_rem = dec->rem;
    if (len <= 4000) memcpy(tap->buf, data, len);
    tap->seed_in = seed;
  }

  _mark(0);
  quant_all_bands_decode(start, end, X, Y, collapse_masks, pulses, shortBlocks,
                         spread_decision, dual_stereo, intensity, tf_res,
                         len * 8 << BITRES, balance, *dec, LM, codedBands,
                         &seed);
  st->rng = seed;
  _mark(1);

  if (tap) {
    int M = 1 << LM;
    memcpy(tap->X, X, sizeof(float) * M * eBands[NB_EBANDS] *
                          (Y ? 2 : 1));
    memcpy(tap->collapse, collapse_masks, sizeof(collapse_masks));
    tap->seed_out = seed;
  }

  int anti_collapse_on = 0;
  if (anti_collapse_rsv > 0) anti_collapse_on = (int)dec->bits(1);

  unquant_energy_finalise(start, end, oldBandE, fine_quant, fine_priority,
                          len * 8 - dec->tell(), *dec, C);

  if (tap) {
    memcpy(tap->oldBandE, oldBandE, sizeof(tap->oldBandE));
    memcpy(tap->oldLogE, oldLogE, sizeof(tap->oldLogE));
    memcpy(tap->oldLogE2, oldLogE2, sizeof(tap->oldLogE2));
    tap->anti_collapse_on = anti_collapse_on;
    tap->rng_at_ac = st->rng;
  }
  if (anti_collapse_on && !getenv("IAMF_NO_AC"))
    anti_collapse(X, collapse_masks, LM, C, M * eBands[NB_EBANDS], start, end,
                  oldBandE, oldLogE, oldLogE2, pulses, st->rng);
  if (tap)
    memcpy(tap->X_post_ac, X,
           sizeof(float) * M * eBands[NB_EBANDS] * (Y ? 2 : 1));

  if (silence) {
    for (int i = 0; i < C * NB_EBANDS; ++i) oldBandE[i] = -28.f;
  }
  if (transient_out) *transient_out = isTransient;

  if (freq_export) {
    // spectrum-export path: denormalise only, leave time-domain synthesis
    // to the device; fall through to the shared state bookkeeping below
    for (int c = 0; c < CC; ++c) {
      const float* Xc = c == 0 || !Y ? X : Y;
      denormalise_bands(Xc, freq_export + c * freq_stride,
                        oldBandE + c * NB_EBANDS, start, effEnd, M, silence);
    }
    // post-filter param rollover, exactly as the synthesis path below
    st->postfilter_period = imax(st->postfilter_period, COMBFILTER_MINPERIOD);
    st->postfilter_period_old =
        imax(st->postfilter_period_old, COMBFILTER_MINPERIOD);
    st->postfilter_period_old = st->postfilter_period;
    st->postfilter_gain_old = st->postfilter_gain;
    st->postfilter_tapset_old = st->postfilter_tapset;
    st->postfilter_period = postfilter_pitch;
    st->postfilter_gain = postfilter_gain;
    st->postfilter_tapset = postfilter_tapset;
    if (LM != 0) {
      st->postfilter_period_old = st->postfilter_period;
      st->postfilter_gain_old = st->postfilter_gain;
      st->postfilter_tapset_old = st->postfilter_tapset;
    }
    if (C == 1)
      memcpy(&oldBandE[NB_EBANDS], oldBandE, NB_EBANDS * sizeof(float));
    if (!isTransient) {
      memcpy(oldLogE2, oldLogE, 2 * NB_EBANDS * sizeof(float));
      memcpy(oldLogE, oldBandE, 2 * NB_EBANDS * sizeof(float));
    } else {
      for (int i = 0; i < 2 * NB_EBANDS; ++i)
        oldLogE[i] = fminf(oldLogE[i], oldBandE[i]);
    }
    for (int c = 0; c < 2; ++c) {
      for (int i = 0; i < start; ++i) {
        oldBandE[c * NB_EBANDS + i] = 0;
        oldLogE[c * NB_EBANDS + i] = oldLogE2[c * NB_EBANDS + i] = -28.f;
      }
      for (int i = end; i < NB_EBANDS; ++i) {
        oldBandE[c * NB_EBANDS + i] = 0;
        oldLogE[c * NB_EBANDS + i] = oldLogE2[c * NB_EBANDS + i] = -28.f;
      }
    }
    // background (comfort-noise) floor tracking for the PLC noise branch:
    // rises slowly in normal decode, freely right after a loss run
    {
      float max_bg_inc = st->loss_duration == 0 ? M * 0.001f : 1.f;
      for (int i = 0; i < 2 * NB_EBANDS; ++i)
        st->backgroundLogE[i] =
            fminf(st->backgroundLogE[i] + max_bg_inc, oldBandE[i]);
    }
    st->start_band = start;
    st->end_band = end;
    st->loss_duration = 0;
    st->rng = dec->rng;
    _mark(2);
    return N;
  }

  // synthesis into decode memory (history slides left by N)
  float* out_syn[2];
  for (int c = 0; c < CC; ++c) {
    memmove(st->decode_mem[c], st->decode_mem[c] + N,
            (DECODE_BUFFER_SIZE - N + OVERLAP / 2) * sizeof(float));
    out_syn[c] = st->decode_mem[c] + DECODE_BUFFER_SIZE - N;
  }

  {
    int B, NB, shift;
    if (isTransient) {
      B = M;
      NB = SHORT_MDCT_SIZE;
      shift = MAX_LM;
    } else {
      B = 1;
      NB = SHORT_MDCT_SIZE << LM;
      shift = MAX_LM - LM;
    }
    static thread_local float freq[960];
    for (int c = 0; c < CC; ++c) {
      const float* Xc = c == 0 || !Y ? X : Y;
      denormalise_bands(Xc, freq, oldBandE + c * NB_EBANDS, start, effEnd, M,
                        silence);
      (void)shift;
      if (tap && c == 0) memcpy(tap->freq_tap, freq, sizeof(float) * 960);
      for (int b = 0; b < B; ++b)
        clt_mdct_backward(freq + b, out_syn[c] + NB * b, 2 * NB, B,
                          window120, OVERLAP);
      if (tap && c == 0)
        memcpy(tap->out_syn_tap, out_syn[c], sizeof(float) * (N + OVERLAP / 2));
    }
  }

  // post-filter
  st->postfilter_period = imax(st->postfilter_period, COMBFILTER_MINPERIOD);
  st->postfilter_period_old =
      imax(st->postfilter_period_old, COMBFILTER_MINPERIOD);
  for (int c = 0; c < CC; ++c) {
    comb_filter(out_syn[c], out_syn[c], st->postfilter_period_old,
                st->postfilter_period, SHORT_MDCT_SIZE,
                st->postfilter_gain_old, st->postfilter_gain,
                st->postfilter_tapset_old, st->postfilter_tapset, window120,
                OVERLAP);
    if (LM != 0)
      comb_filter(out_syn[c] + SHORT_MDCT_SIZE, out_syn[c] + SHORT_MDCT_SIZE,
                  st->postfilter_period, postfilter_pitch,
                  N - SHORT_MDCT_SIZE, st->postfilter_gain, postfilter_gain,
                  st->postfilter_tapset, postfilter_tapset, window120,
                  OVERLAP);
  }
  st->postfilter_period_old = st->postfilter_period;
  st->postfilter_gain_old = st->postfilter_gain;
  st->postfilter_tapset_old = st->postfilter_tapset;
  st->postfilter_period = postfilter_pitch;
  st->postfilter_gain = postfilter_gain;
  st->postfilter_tapset = postfilter_tapset;
  if (LM != 0) {
    // for frames longer than 2.5 ms the in-frame second comb pass already
    // completed the transition; next frame starts from the new params
    st->postfilter_period_old = st->postfilter_period;
    st->postfilter_gain_old = st->postfilter_gain;
    st->postfilter_tapset_old = st->postfilter_tapset;
  }

  if (C == 1) memcpy(&oldBandE[NB_EBANDS], oldBandE, NB_EBANDS * sizeof(float));

  // energy bookkeeping
  if (!isTransient) {
    memcpy(oldLogE2, oldLogE, 2 * NB_EBANDS * sizeof(float));
    memcpy(oldLogE, oldBandE, 2 * NB_EBANDS * sizeof(float));
  } else {
    for (int i = 0; i < 2 * NB_EBANDS; ++i)
      oldLogE[i] = fminf(oldLogE[i], oldBandE[i]);
  }
  for (int c = 0; c < 2; ++c) {
    for (int i = 0; i < start; ++i) {
      oldBandE[c * NB_EBANDS + i] = 0;
      oldLogE[c * NB_EBANDS + i] = oldLogE2[c * NB_EBANDS + i] = -28.f;
    }
    for (int i = end; i < NB_EBANDS; ++i) {
      oldBandE[c * NB_EBANDS + i] = 0;
      oldLogE[c * NB_EBANDS + i] = oldLogE2[c * NB_EBANDS + i] = -28.f;
    }
  }

  if (tap) {
    memcpy(tap->decode_mem_tap, st->decode_mem, sizeof(tap->decode_mem_tap));
    tap->preemph_tap[0] = st->preemph_memD[0];
    tap->preemph_tap[1] = st->preemph_memD[1];
  }
  // background (comfort-noise) floor tracking for the PLC noise branch
  {
    float max_bg_inc = st->loss_duration == 0 ? M * 0.001f : 1.f;
    for (int i = 0; i < 2 * NB_EBANDS; ++i)
      st->backgroundLogE[i] =
          fminf(st->backgroundLogE[i] + max_bg_inc, oldBandE[i]);
  }
  st->start_band = start;
  st->end_band = end;
  // de-emphasis to output
  deemphasis(out_syn, pcm, N, CC, 0.85f, st->preemph_memD);
  st->loss_duration = 0;
  // re-seed the noise LCG for the next frame from the range coder's final
  // state — deterministic across encoder/decoder
  st->rng = dec->rng;
  return N;
}

int celt_decode_frame(CeltDecoder* st, const unsigned char* data, int len,
                      float* pcm, int frame_size, EntDec* dec) {
  return celt_decode_frame_ex(st, data, len, pcm, frame_size, dec, nullptr,
                              nullptr);
}

int celt_decode_frame_bands(CeltDecoder* st, const unsigned char* data,
                            int len, float* pcm, int frame_size, EntDec* dec,
                            int start_band, int end_band) {
  return celt_decode_frame_ex(st, data, len, pcm, frame_size, dec, nullptr,
                              nullptr, start_band, end_band);
}

int celt_decode_spectrum(CeltDecoder* st, const unsigned char* data, int len,
                         float* freq_out, int frame_size, EntDec* dec,
                         int* transient_out) {
  return celt_decode_frame_ex(st, data, len, nullptr, frame_size, dec,
                              freq_out, transient_out);
}

int celt_decode_spectrum_bands(CeltDecoder* st, const unsigned char* data,
                               int len, float* freq_out, int frame_size,
                               EntDec* dec, int* transient_out,
                               int start_band, int end_band,
                               long freq_stride) {
  return celt_decode_frame_ex(st, data, len, nullptr, frame_size, dec,
                              freq_out, transient_out, start_band, end_band,
                              freq_stride);
}

}  // namespace iamf_opus
