// CELT decoder (RFC 6716 §4.3) — iamf-tpu native implementation.
//
// Algorithms implemented from the specification; numeric constant tables in
// celt_tables.cc (see iamf_tpu/tools/extract_opus_tables.py for
// provenance). Supports the 48 kHz Opus modes: frames of 2.5/5/10/20 ms
// (LM=0..3), mono and stereo.

#pragma once

#include <atomic>
#include <cstdint>
#include <cstring>

#include "entdec.h"

namespace iamf_opus {

constexpr int NB_EBANDS = 21;
constexpr int MAX_LM = 3;
constexpr int SHORT_MDCT_SIZE = 120;
constexpr int OVERLAP = 120;
constexpr int BITRES = 3;
constexpr int MAX_FINE_BITS = 8;
constexpr int FINE_OFFSET = 21;
constexpr int ALLOC_STEPS = 6;
constexpr int NB_ALLOC_VECTORS = 11;
constexpr int SPREAD_NONE = 0;
constexpr int SPREAD_LIGHT = 1;
constexpr int SPREAD_NORMAL = 2;
constexpr int SPREAD_AGGRESSIVE = 3;
constexpr int COMBFILTER_MAXPERIOD = 1024;
constexpr int COMBFILTER_MINPERIOD = 15;
constexpr int DECODE_BUFFER_SIZE = 2048;
constexpr float CELT_SIG_SCALE = 32768.f;

// IAMF_PROF=1: nanosecond accumulators over the spectrum-export stages
// (0 pre-band entropy, 1 quant_all_bands PVQ, 2 anti-collapse+denorm+state,
// 3 hybrid SILK, 4 decode_pulses/cwrs, 5 exp_rotation — 4/5 nest inside 1).
// Read/reset via iamf_opus_prof_read (opus_dec.cc).
extern std::atomic<long long> prof_ns[8];
bool prof_enabled();

// mode accessors (48 kHz, shortMdctSize=120, 21 bands)
const short* mode_eBands();       // [22]
const short* mode_logN();         // [21]
const unsigned char* mode_alloc_vectors();  // [11*21]
const short* mode_cache_index();  // [(MAX_LM+2)*21]
const unsigned char* mode_cache_bits();
const unsigned char* mode_cache_caps();

// ---- rate.c equivalents -------------------------------------------------

inline int get_pulses(int i) { return i < 8 ? i : (8 + (i & 7)) << ((i >> 3) - 1); }

int bits2pulses(int band, int LM, int bits);
int pulses2bits(int band, int LM, int pulses);
void init_caps(int* cap, int LM, int C);

// Bit allocation (decode side). Returns codedBands.
int compute_allocation(int start, int end, const int* offsets, const int* cap,
                       int alloc_trim, int* intensity, int* dual_stereo,
                       int total, int* balance, int* pulses, int* ebits,
                       int* fine_priority, int C, int LM, EntDec* ec);

// ---- quant_bands.c equivalents -----------------------------------------

void unquant_coarse_energy(int start, int end, float* oldEBands, int intra,
                           EntDec& dec, int C, int LM);
void unquant_fine_energy(int start, int end, float* oldEBands,
                         const int* fine_quant, EntDec& dec, int C);
void unquant_energy_finalise(int start, int end, float* oldEBands,
                             const int* fine_quant, const int* fine_priority,
                             int bits_left, EntDec& dec, int C);

// ---- bands.c equivalents ------------------------------------------------

void tf_decode(int start, int end, int isTransient, int* tf_res, int LM,
               EntDec& dec);

uint32_t celt_lcg_rand(uint32_t seed);
// IAMF_SKIP_RECON=1: pass-1 mode — run every range-decoder read but
// defer the float reconstruction (the device band-walk's host half);
// outputs are garbage by design, only the ec state and op emission
// matter (see band_replay.py)
bool skip_recon();

void quant_all_bands_decode(int start, int end, float* X_, float* Y_,
                            unsigned char* collapse_masks, const int* pulses,
                            int shortBlocks, int spread, int dual_stereo,
                            int intensity, const int* tf_res, int total_bits,
                            int balance, EntDec& ec, int LM, int codedBands,
                            uint32_t* seed);

void anti_collapse(float* X_, const unsigned char* collapse_masks, int LM,
                   int C, int size, int start, int end, const float* logE,
                   const float* prev1logE, const float* prev2logE,
                   const int* pulses, uint32_t seed);

void denormalise_bands(const float* X, float* freq, const float* bandLogE,
                       int start, int end, int M, int silence);

// ---- PVQ ---------------------------------------------------------------

void decode_pulses(int* y, int N, int K, EntDec& dec);
// standalone index->pulse expansion (the cwrsi walk) for the device-kernel
// experiment harness; y must hold N ints
void cwrsi_export(int n, int k, uint32_t i, int* y);
// IAMF_LEAF_TAP: record decoded PVQ leaves (n, k, index) plus the
// alg_unquant reconstruction inputs (gain, spread, B) and, when
// IAMF_LEAF_TAP=2, the host's post-rotation output vector — the oracle
// for the device leaf-reconstruction kernel. Ring capacity 1<<20.
struct LeafTap {
  static constexpr int CAP = 1 << 20;
  static constexpr int XCAP = 1 << 18;  // oracle vectors (level 2)
  static constexpr int XW = 32;
  std::atomic<long long> count{0};
  int n[CAP];
  int k[CAP];
  uint32_t idx[CAP];
  float gain[CAP];
  unsigned char spread[CAP];
  unsigned char blocks[CAP];
  // post-rotation X prefix (level 2 only, first XW values of each of the
  // first XCAP leaves)
  float x[XCAP][XW];
};
extern LeafTap g_leaf_tap;
int leaf_tap_level();
void leaf_tap_set(int lv);
bool leaf_tap_enabled();

// IAMF_BAND_EMIT: op-table emission for the device band-walk experiment
// (pass-2 reconstruction). Hooks inside the REAL band decode append
// typed records describing every reconstruction-relevant event; the
// device program (or its numpy replay oracle) re-derives the spectrum
// from these plus the PVQ (n,k,idx) leaves, using no other host floats.
// Record: 16 x u32/f32 fields, field 0 = op type.
enum EmitOpType {
  EMIT_FRAME = 1,   // f1=C f2=LM f3=shortBlocks f4=spread f5=intensity
                    // f6=dual_stereo f7=seed_in f8=start f9=end
                    // f10=codedBands
  EMIT_BAND = 2,    // f1=i f2=offX(=M*eBands[i]-norm_off) f3=N
                    // f4=B(after recombine/time steps? no: band entry B)
                    // f5=recombine f6=time_divide(count) f7=longBlocks
                    // f8=has_lowband f9=effective_lowband f10=fold_start
                    // f11=fold_end f12=b_bits f13=last f14=ch(0/1/2=couple)
  EMIT_LEAF = 3,    // f1=off(within band partition domain) f2=n f3=k
                    // f4=idx f5=gain(f32) f6=B_leaf f7=cm_shift
                    // f8=ch f9=kind(actual: 0 pvq,1 zero,2 noise,3 fold)
                    // f10=fill_at_leaf(actual, for cross-check)
                    // f11=lowband_off(fold: offset within band lowband)
  EMIT_N1 = 4,      // f1=off f2=val(f32 +-1) f3=ch f4=lowband_out_flag
  EMIT_THETA = 5,   // f1=itheta f2=imid f3=iside f4=inv f5=stereo
                    // f6=n f7=off f8=ch
  EMIT_N2S = 6,     // stereo N==2: f1=off f2=sign f3=c(itheta>8192)
                    // f4=imid f5=iside
  EMIT_MERGE = 7,   // stereo_merge: f1=off f2=n f3=imid
  EMIT_END = 8,     // frame end: f1=seed_out
  EMIT_BANDCFG = 9  // quant_band entry: f1=recombine f2=time_divide
                    // f3=longBlocks f4=B0 f5=N_B0 f6=has_lowband f7=N0
                    // f8=ch f9=has_lowband_out f10=tf_change_in
};
struct EmitBuf {
  static constexpr int CAP = 1 << 18;  // records
  long long count = 0;                 // single-threaded use (serial mode)
  uint32_t rec[CAP][16];
};
extern thread_local EmitBuf* g_emit;   // null = emission off
// decode + rotate + normalize. Returns collapse mask.
unsigned alg_unquant(float* X, int N, int K, int spread, int B, EntDec& dec,
                     float gain);
void renormalise_vector(float* X, int N, float gain);
void haar1(float* X, int N0, int stride);
void deinterleave_hadamard(float* X, int N0, int stride, int hadamard);
void interleave_hadamard(float* X, int N0, int stride, int hadamard);
void stereo_merge(float* X, float* Y, float mid, int N);
void exp_rotation(float* X, int len, int dir, int stride, int K, int spread);

// ---- MDCT synthesis ----------------------------------------------------

// Inverse MDCT of one block: in has N/2 freq samples with stride `stride`
// (B interleaving); out gets N time samples added with window overlap.
void clt_mdct_backward(const float* in, float* out, int N, int stride,
                       const float* window, int overlap);

void comb_filter(float* y, float* x, int T0, int T1, int N, float g0, float g1,
                 int tapset0, int tapset1, const float* window, int overlap);

// ---- decoder state ------------------------------------------------------

struct CeltDecoder {
  int channels;       // 1 or 2
  int stream_channels;
  int postfilter_period;
  int postfilter_period_old;
  float postfilter_gain;
  float postfilter_gain_old;
  int postfilter_tapset;
  int postfilter_tapset_old;
  uint32_t rng;
  int error;
  int last_pitch_index;
  int loss_duration;
  int start_band;  // band range of the last decoded frame (PLC needs it:
  int end_band;    // noise-fill range / hybrid history detection)

  float preemph_memD[2];
  // per-channel synthesis history (DECODE_BUFFER_SIZE) + overlap slack
  float decode_mem[2][DECODE_BUFFER_SIZE + OVERLAP];
  float lpc_mem[2][24];  // PLC LPC coefficients (persist across a loss run)
  float oldEBands[2 * NB_EBANDS];
  float oldLogE[2 * NB_EBANDS];
  float oldLogE2[2 * NB_EBANDS];
  float backgroundLogE[2 * NB_EBANDS];

  void init(int ch) {
    memset(this, 0, sizeof(*this));
    channels = stream_channels = ch;
    end_band = NB_EBANDS;
    // backgroundLogE starts at 0 (libopus clears it but excludes it from
    // the -28 init loop): the CNG floor creeps up from there, min-capped
    // by each band's decoded energy
    for (int i = 0; i < 2 * NB_EBANDS; ++i)
      oldLogE[i] = oldLogE2[i] = -28.f;
  }
};

struct BandTap {
  int valid;
  int start, end, shortBlocks, spread, dual_stereo, intensity;
  int LM, codedBands, total_bits, balance, C, len;
  int pulses[21], tf_res[21];
  unsigned ec_offs, ec_rng, ec_val, ec_ext, ec_end_offs, ec_end_window;
  int ec_nend_bits, ec_nbits_total, ec_rem;
  unsigned char buf[4000];
  float X[2 * 800];
  unsigned char collapse[42];
  unsigned seed_in, seed_out;
  float oldBandE[42], oldLogE[42], oldLogE2[42];
  int anti_collapse_on;
  float X_post_ac[2 * 800];
  unsigned rng_at_ac;
  float freq_tap[960];
  float out_syn_tap[1080];
  float decode_mem_tap[2][2168];
  float preemph_tap[2];
};
extern BandTap g_band_tap;

// IAMF_BAND_STATS accumulators (celt_bands.cc): band-decode structure
// census used to size the device-side reconstruction design — counts of
// leaf kinds and linear passes, plus bin totals per kind.
struct BandStats {
  std::atomic<long long> pvq_leaves{0}, pvq_bins{0};
  std::atomic<long long> fold_leaves{0}, fold_bins{0};
  std::atomic<long long> noise_leaves{0}, noise_bins{0};
  std::atomic<long long> zero_leaves{0}, zero_bins{0};
  std::atomic<long long> splits{0}, theta_calls{0};
  std::atomic<long long> haar_calls{0}, haar_bins{0};
  std::atomic<long long> stereo_bands{0}, frames{0};
  std::atomic<long long> max_leaves_frame{0};
};
extern BandStats g_band_stats;
bool band_stats_enabled();

// Decode one CELT frame (N = 120<<LM samples) into pcm (interleaved float,
// [-1,1] scale). `dec` must be initialized over the frame payload.
int celt_decode_frame(CeltDecoder* st, const unsigned char* data, int len,
                      float* pcm, int frame_size, EntDec* dec);

// Band-restricted decode for Opus hybrid frames (start band 17, end per
// bandwidth); `dec` is the range decoder shared with the SILK layer.
int celt_decode_frame_bands(CeltDecoder* st, const unsigned char* data,
                            int len, float* pcm, int frame_size, EntDec* dec,
                            int start_band, int end_band);

// Entropy/PVQ/denormalise only: export the spectrum ([CC][960] stride,
// first frame_size entries valid) for the device-side synthesis pipeline;
// updates all decoder state like celt_decode_frame but performs no
// time-domain synthesis.
int celt_decode_spectrum(CeltDecoder* st, const unsigned char* data, int len,
                         float* freq_out, int frame_size, EntDec* dec,
                         int* transient_out);

// Conceal one lost frame into the decode history (pitch-based PLC /
// noise CNG, libopus celt_decode_lost semantics; celt_plc.cc).
void celt_decode_lost(CeltDecoder* st, int N, int LM);

// Conceal + de-emphasis to interleaved float pcm at [-1,1] scale.
int celt_conceal_frame(CeltDecoder* st, float* pcm, int frame_size);

// Band-restricted spectrum export (hybrid start=17 / NB-WB end bands).
// freq_stride: float distance between the two channels' export rows (the
// batch3 API writes straight into the packed [R, L, W] h2d buffer).
int celt_decode_spectrum_bands(CeltDecoder* st, const unsigned char* data,
                               int len, float* freq_out, int frame_size,
                               EntDec* dec, int* transient_out,
                               int start_band, int end_band,
                               long freq_stride = 960);

}  // namespace iamf_opus
