// The frames kernel: the whole AECM core of one fused serving step, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel _frames_kernel_call (webrtc_aecm_tpu/fused.py:
// 1595, pallas_call :1708, body frames_step :1283 -> _process_block_f
// :1037), in the circular far-history mode, at n_frames = 4 (a 320-sample
// step = exactly 5 blocks).  Plain version: webrtc_aecm_tpu_torch/fused.py
// `frames_step`; the __device__ functions below carry the names of their
// counterparts there.
//
// One thread runs one stream.  The state keeps the fused lane-major layout:
// a leaf of R rows is an (R, B) array, thread b reads row r at r*B + b, so
// a warp's loads of one row coalesce.  Every core leaf is updated in place
// (as input_output_aliases does for the TPU kernel), except far_history and
// far_q_domains, which are read-only here: the step's new far blocks are
// written to pend_hist / pend_q and the caller appends them at the
// circular head.  The CNG seed chain and phase lookups run before the
// kernel (phase rows come in packed: Q13 cos low 16 bits, sin high 16).
//
// Bound on the card: the per-thread dependent chain (three 128-point FFTs,
// the 100-entry delay search and the 65-bin stages per block, 5 blocks per
// step) and memory latency; at 4096 streams the grid is 4096 threads, so
// little latency is hidden.  Working arrays live in local memory.  The TPU
// workarounds are gone: permutations are index loads, division is native,
// rolls are indexing.  Built with --fmad=false so the float32 histogram
// arithmetic rounds op by op like the PyTorch version.
#include <cuda_runtime.h>

#include <cstdint>

#include "spl.cuh"

namespace aecm {
namespace {

// Core leaves in CoreState field order (nested tuples flattened); the
// Python wrapper passes their pointers in this order.
enum Leaf {
  X_BUF, D_BUF_NOISY, D_BUF_CLEAN, OUT_BUF, KNOWN_DELAY, FRAME_FILL,
  IN_CARRY_FAR, IN_CARRY_NOISY, IN_CARRY_CLEAN, OUT_FILL, OUT_CARRY,
  OUT_TAIL, SEED,
  FE_BINARY_HISTORY, FE_BIT_COUNTS, FE_MEAN_SPECTRUM,
  FE_SPECTRUM_INITIALIZED,
  NE_MEAN_SPECTRUM, NE_SPECTRUM_INITIALIZED, NE_BINARY_HISTORY,
  NE_BIT_COUNTS, NE_MEAN_BIT_COUNTS, NE_HISTOGRAM, NE_MINIMUM_PROBABILITY,
  NE_LAST_DELAY_PROBABILITY, NE_LAST_DELAY, NE_LAST_CANDIDATE_DELAY,
  NE_COMPARE_DELAY, NE_CANDIDATE_HITS, NE_LAST_DELAY_HISTOGRAM,
  NE_ALLOWED_OFFSET, NE_LOOKAHEAD, NE_ROBUST_VALIDATION_ENABLED,
  FAR_HISTORY, FAR_Q_DOMAINS, NLP_FLAG, FIXED_DELAY, TOT_COUNT, DFA_CLEAN_Q,
  DFA_CLEAN_Q_OLD, DFA_NOISY_Q, DFA_NOISY_Q_OLD, NEAR_LOG_ENERGY,
  FAR_LOG_ENERGY, ECHO_ADAPT_LOG_ENERGY, ECHO_STORED_LOG_ENERGY,
  CHANNEL_STORED, CHANNEL_ADAPT16, CHANNEL_ADAPT32, ECHO_FILT, NEAR_FILT,
  NOISE_EST, NOISE_EST_TOO_LOW_CTR, NOISE_EST_TOO_HIGH_CTR, NOISE_EST_CTR,
  CNG_MODE, MSE_ADAPT_OLD, MSE_STORED_OLD, MSE_THRESHOLD, FAR_ENERGY_MIN,
  FAR_ENERGY_MAX, FAR_ENERGY_MAX_MIN, FAR_ENERGY_VAD, FAR_ENERGY_MSE,
  CURRENT_VAD_VALUE, VAD_UPDATE_COUNT, FIRST_VAD, STARTUP_STATE,
  MSE_CHANNEL_COUNT, SUP_GAIN, SUP_GAIN_OLD, SUP_GAIN_ERR_PARAM_A,
  SUP_GAIN_ERR_PARAM_D, SUP_GAIN_ERR_PARAM_DIFF_AB,
  SUP_GAIN_ERR_PARAM_DIFF_BD,
  N_LEAVES
};

constexpr int PART_LEN = 64;
constexpr int PART_LEN1 = 65;
constexpr int FRAME_LEN = 80;
constexpr int MAX_DELAY = 100;
constexpr int FAR_HIST_ROWS = 40;
constexpr int N_FRAMES = 4;
constexpr int N_SLOTS = 5;             // (4*80 + 48) / 64
constexpr int STEP_LEN = N_FRAMES * FRAME_LEN;
constexpr int ONE_Q14 = 1 << 14;
constexpr float Q14_SCALING = 1.0f / 16384.0f;

struct Leaves {
  void* p[N_LEAVES];
};

struct Inputs {
  const int* far;        // (320, B) far frames
  const int* noisy;      // (320, B) near frames
  const int* phase;      // (320, B) packed CNG phase rows, per slot
  const bool* run_rows;  // (4, B)
  const int* win128;     // (128,)
  const int* fwr;        // (7, 128) per-stage per-row twiddles
  const int* fws;        // (7, 128)
  int* out;              // (320, B)
  int* pend_hist;        // (5 * 40, B)
  int* pend_q;           // (5, B)
  int B, head, mult, fpc;
};

// One stream's view of the lane-major state.
struct St {
  const Leaves& lv;
  int B, b;
  __device__ int& i(int leaf, int r = 0) const {
    return ((int*)lv.p[leaf])[(size_t)r * B + b];
  }
  __device__ long long& q(int leaf, int r = 0) const {
    return ((long long*)lv.p[leaf])[(size_t)r * B + b];
  }
  __device__ float& f(int leaf, int r = 0) const {
    return ((float*)lv.p[leaf])[(size_t)r * B + b];
  }
};

// ---------------------------------------------------------------------------
// FFT pair, order 7, mode 1 (ops/fft.py via fused.py _complex_*_128)
// ---------------------------------------------------------------------------

__device__ __forceinline__ int bitrev7(int i) { return (int)(__brev(i) >> 25); }

__device__ void _complex_fft_128(int* fr, int* fi, const Inputs& in) {
  for (int s = 0; s < 7; ++s) {
    const int l = 1 << s;
    for (int i = 0; i < 128; ++i) {
      if (i & l) continue;
      const int j = i | l;
      const int wr = in.fwr[s * 128 + i];
      const int wi = -in.fws[s * 128 + i];
      const int ar = fr[i], ai = fi[i], br = fr[j], bi = fi[j];
      const int tr = (wr * br - wi * bi + 1) >> 1;
      const int ti = (wr * bi + wi * br + 1) >> 1;
      const int qr = ar * 16384, qi = ai * 16384;
      fr[i] = to_w16((qr + tr + 16384) >> 15);
      fi[i] = to_w16((qi + ti + 16384) >> 15);
      fr[j] = to_w16((qr - tr + 16384) >> 15);
      fi[j] = to_w16((qi - ti + 16384) >> 15);
    }
  }
}

// Inverse with the per-stage data-dependent scaling; returns the scale.
__device__ int _complex_ifft_128(int* fr, int* fi, const Inputs& in) {
  int scale = 0;
  for (int s = 0; s < 7; ++s) {
    int maxabs = 0;
    for (int i = 0; i < 128; ++i) {
      maxabs = max(maxabs, max(abs(fr[i]), abs(fi[i])));
    }
    maxabs = min(maxabs, 32767);
    const int shift = (maxabs > 13573) + (maxabs > 27146);
    scale += shift;
    const int rnd = 8192 << shift;
    const int l = 1 << s;
    for (int i = 0; i < 128; ++i) {
      if (i & l) continue;
      const int j = i | l;
      const int wr = in.fwr[s * 128 + i];
      const int wi = in.fws[s * 128 + i];
      const int ar = fr[i], ai = fi[i], br = fr[j], bi = fi[j];
      const int tr = (wr * br - wi * bi + 1) >> 1;
      const int ti = (wr * bi + wi * br + 1) >> 1;
      const int qr = ar * 16384, qi = ai * 16384;
      fr[i] = to_w16((qr + tr + rnd) >> (shift + 14));
      fi[i] = to_w16((qi + ti + rnd) >> (shift + 14));
      fr[j] = to_w16((qr - tr + rnd) >> (shift + 14));
      fi[j] = to_w16((qi - ti + rnd) >> (shift + 14));
    }
  }
  return scale;
}

// core.time_to_frequency_domain: x (128) -> Q scaling, re/im/mag (65),
// returns the mag sum (uint32).
__device__ uint32_t _time_to_frequency_domain_f(const int* x, int* re,
                                                int* im, int* mag,
                                                int* scaling_out, int* fr,
                                                int* fi, const Inputs& in) {
  int max_abs = 0;
  for (int i = 0; i < 128; ++i) max_abs = max(max_abs, abs(x[i]));
  max_abs = min(max_abs, WORD16_MAX);
  const int scaling = norm_w16(max_abs);
  for (int i = 0; i < 128; ++i) {
    const int src = bitrev7(i);
    const int scaled = to_w16(shl_i32(x[src], scaling));
    fr[i] = to_w16((scaled * in.win128[src]) >> 14);
    fi[i] = 0;
  }
  _complex_fft_128(fr, fi, in);
  uint32_t sum = 0;
  for (int i = 0; i < PART_LEN1; ++i) {
    const int r = fr[i];
    const int m = (i == 0 || i == PART_LEN) ? 0 : to_w16(-fi[i]);
    re[i] = r;
    im[i] = m;
    const int ar = abs(r), am = abs(m);
    int v;
    if (i == 0 || i == PART_LEN) {
      v = ar;
    } else if (r == 0) {
      v = am;
    } else if (m == 0) {
      v = ar;
    } else {
      v = sqrt_floor(add_sat_w32(ar * ar, am * am));
    }
    mag[i] = v;
    sum += (uint32_t)v;
  }
  *scaling_out = scaling;
  return sum;
}

// ---------------------------------------------------------------------------
// Delay estimator (fused.py _binary_spectrum_fix_f ... _process_fix_f),
// lookahead capacity 1
// ---------------------------------------------------------------------------

__device__ uint32_t _binary_spectrum_fix_f(const St& st, const int* spectrum,
                                           int mean_leaf, int init_leaf,
                                           int q_domain) {
  const int shift = 15 - q_domain;
  if (st.i(init_leaf) == 0) {
    bool any_nonzero = false;
    for (int i = 12; i <= 43; ++i) {
      if (spectrum[i] > 0) {
        st.i(mean_leaf, i) = ((int)((uint32_t)spectrum[i] << shift)) >> 1;
        any_nonzero = true;
      }
    }
    if (any_nonzero) st.i(init_leaf) = 1;
  }
  uint32_t bits = 0;
  for (int i = 12; i <= 43; ++i) {
    const int q15 = (int)((uint32_t)spectrum[i] << shift);
    const int mean = mean_estimator_fix(q15, 6, st.i(mean_leaf, i));
    st.i(mean_leaf, i) = mean;
    if (q15 > mean) bits |= 1u << (i - 12);
  }
  return bits;
}

__device__ void _add_far_spectrum_fix_f(const St& st, const int* spectrum,
                                        int far_q) {
  const uint32_t bits = _binary_spectrum_fix_f(
      st, spectrum, FE_MEAN_SPECTRUM, FE_SPECTRUM_INITIALIZED, far_q);
  for (int r = MAX_DELAY - 1; r > 0; --r) {
    st.q(FE_BINARY_HISTORY, r) = st.q(FE_BINARY_HISTORY, r - 1);
    st.i(FE_BIT_COUNTS, r) = st.i(FE_BIT_COUNTS, r - 1);
  }
  st.q(FE_BINARY_HISTORY, 0) = (long long)bits;
  st.i(FE_BIT_COUNTS, 0) = __popc(bits);
}

__device__ __forceinline__ bool in_range(int idx, int n) {
  return idx >= 0 && idx < n;
}

// delay_estimator.process_binary_spectrum; returns the new last_delay.
__device__ int _process_binary_spectrum_f(const St& st, uint32_t bits) {
  st.q(NE_BINARY_HISTORY) = (long long)bits;
  int value_best = 0x7FFFFFFF, candidate = 0, value_worst = (int)0x80000000;
  bool non_stationary = false;
  for (int r = 0; r < MAX_DELAY; ++r) {
    const int bc = __popc(bits ^ (uint32_t)st.q(FE_BINARY_HISTORY, r));
    st.i(NE_BIT_COUNTS, r) = bc;
    const int fbc = st.i(FE_BIT_COUNTS, r);
    int mean = st.i(NE_MEAN_BIT_COUNTS, r);
    if (fbc > 0) {
      const int shifts = 13 - ((3 * fbc) >> 4);
      mean = mean_estimator_fix(bc << 9, shifts, mean);
      st.i(NE_MEAN_BIT_COUNTS, r) = mean;
      non_stationary = true;
    }
    if (mean < value_best) {
      value_best = mean;
      candidate = r;
    }
    value_worst = max(value_worst, mean);
  }
  constexpr int MAX_BITCOUNTS_Q9 = 32 << 9;
  if (!(value_best < MAX_BITCOUNTS_Q9)) candidate = -1;
  value_best = min(value_best, MAX_BITCOUNTS_Q9);
  value_worst = max(value_worst, 0);
  const int valley_depth = value_worst - value_best;

  const int threshold = max(value_best + 1024, 8704);
  int minimum_probability = st.i(NE_MINIMUM_PROBABILITY);
  if (minimum_probability > 8704 && valley_depth > 2816 &&
      minimum_probability > threshold) {
    minimum_probability = threshold;
  }
  st.i(NE_MINIMUM_PROBABILITY) = minimum_probability;
  const int last_delay_probability = st.i(NE_LAST_DELAY_PROBABILITY) + 1;
  st.i(NE_LAST_DELAY_PROBABILITY) = last_delay_probability;
  bool valid_candidate = valley_depth > 1024 &&
                         (value_best < minimum_probability ||
                          value_best < last_delay_probability);

  // --- UpdateRobustValidationStatistics (non-stationary far end only) ---
  const int last_delay = st.i(NE_LAST_DELAY);
  const int compare_delay = st.i(NE_COMPARE_DELAY);
  const float valley_f = (float)valley_depth * Q14_SCALING;
  if (non_stationary) {
    const int max_hits = candidate < last_delay ? 10 : 1000;
    const int cand_hits =
        (candidate != st.i(NE_LAST_CANDIDATE_DELAY) ? 0
                                                     : st.i(NE_CANDIDATE_HITS)) +
        1;
    float dls = valley_f;
    if (cand_hits < max_hits) {
      const int sel = in_range(compare_delay, MAX_DELAY + 1)
                          ? st.i(NE_MEAN_BIT_COUNTS, compare_delay)
                          : 0;
      dls = (float)(sel - value_best) * Q14_SCALING;
    }
    for (int i = 0; i <= MAX_DELAY; ++i) {
      float h = st.f(NE_HISTOGRAM, i);
      if (i == candidate) h = fminf(h + valley_f, 3000.0f);
      if (i < MAX_DELAY) {
        const bool in_last = i >= last_delay - 2 && i <= last_delay + 1 &&
                             i != candidate;
        const bool in_cand = i >= candidate - 2 && i <= candidate + 1;
        const float dec = dls * (in_last ? 1.0f : 0.0f) +
                          valley_f * ((!in_last && !in_cand) ? 1.0f : 0.0f);
        h = fmaxf(h - dec, 0.0f);
      }
      st.f(NE_HISTOGRAM, i) = h;
    }
    st.i(NE_CANDIDATE_HITS) = cand_hits;
    st.i(NE_LAST_CANDIDATE_DELAY) = candidate;
  }

  // --- histogram-based + robust validation (runtime toggle) ---
  const float hist_cand = in_range(candidate, MAX_DELAY + 1)
                              ? st.f(NE_HISTOGRAM, candidate)
                              : 0.0f;
  const float delay_difference = (float)(candidate - last_delay);
  const float allowed = (float)st.i(NE_ALLOWED_OFFSET);
  float fraction = 1.0f;
  if (delay_difference > allowed) {
    fraction = fmaxf(1.0f - 0.05f * (delay_difference - allowed), 0.5f);
  } else if (delay_difference < 0.0f) {
    fraction = fminf(0.25f - 0.05f * delay_difference, 1.0f);
  }
  const float hist_compare = in_range(compare_delay, MAX_DELAY + 1)
                                 ? st.f(NE_HISTOGRAM, compare_delay)
                                 : 0.0f;
  const float h_threshold = fmaxf(hist_compare * fraction, 1.5f);
  const bool is_histogram_valid =
      hist_cand >= h_threshold && st.i(NE_CANDIDATE_HITS) > 10;
  const float last_delay_histogram = st.f(NE_LAST_DELAY_HISTOGRAM);
  bool is_robust = last_delay < 0 && (valid_candidate || is_histogram_valid);
  is_robust = is_robust || (valid_candidate && is_histogram_valid);
  is_robust = is_robust ||
              (is_histogram_valid && hist_cand > last_delay_histogram);
  if (st.i(NE_ROBUST_VALIDATION_ENABLED) != 0) valid_candidate = is_robust;

  const bool do_update = non_stationary && valid_candidate;
  const bool changed = do_update && candidate != last_delay;
  if (changed) {
    st.f(NE_LAST_DELAY_HISTOGRAM) = fminf(hist_cand, 250.0f);
    if (in_range(compare_delay, MAX_DELAY + 1) &&
        hist_cand < st.f(NE_HISTOGRAM, compare_delay)) {
      st.f(NE_HISTOGRAM, compare_delay) = hist_cand;
    }
  }
  int new_last_delay = last_delay;
  if (do_update) {
    new_last_delay = candidate;
    if (value_best < last_delay_probability) {
      st.i(NE_LAST_DELAY_PROBABILITY) = value_best;
    }
    st.i(NE_COMPARE_DELAY) = candidate;
  }
  st.i(NE_LAST_DELAY) = new_last_delay;
  return new_last_delay;
}

// ---------------------------------------------------------------------------
// Core block stages (fused.py _calc_energies_f ... _inverse_fft_and_window_f)
// ---------------------------------------------------------------------------

// LogOfEnergyInQ8 (aecm_core.cc:618-628).
__device__ int log_of_energy_in_q8(uint32_t energy, int q_domain) {
  constexpr int k_log_low = 7 << 7;
  if (energy == 0) return k_log_low;
  const int zeros = norm_u32(energy);
  const int frac = to_w16((int)((shl_u32(energy, zeros) & 0x7FFFFFFFu) >> 23));
  return k_log_low + (31 - zeros) * 256 + frac - q_domain * 256;
}

// WebRtcAecm_AsymFilt (aecm_core.cc:588-605).
__device__ int asym_filt(int filt_old, int in_val, int step_pos,
                         int step_neg) {
  if (filt_old == WORD16_MAX || filt_old == WORD16_MIN) return in_val;
  return filt_old > in_val ? filt_old - ((filt_old - in_val) >> step_neg)
                           : filt_old + ((in_val - filt_old) >> step_pos);
}

__device__ void shift_in(const St& st, int leaf, int rows, int v) {
  for (int r = rows - 1; r > 0; --r) st.i(leaf, r) = st.i(leaf, r - 1);
  st.i(leaf, 0) = v;
}

// core.calc_energies; fills echo_est (65).
__device__ void _calc_energies_f(const St& st, const int* far_spectrum,
                                 int far_q, uint32_t near_ener,
                                 int* echo_est) {
  shift_in(st, NEAR_LOG_ENERGY, 64,
           log_of_energy_in_q8(near_ener, st.i(DFA_NOISY_Q)));
  uint32_t tmp_far = 0, tmp_adapt = 0, tmp_stored = 0;
  for (int i = 0; i < PART_LEN1; ++i) {
    echo_est[i] = wmul(st.i(CHANNEL_STORED, i), far_spectrum[i]);
    tmp_far += (uint32_t)far_spectrum[i];
    tmp_adapt += (uint32_t)wmul(st.i(CHANNEL_ADAPT16, i), far_spectrum[i]);
    tmp_stored += (uint32_t)echo_est[i];
  }
  const int far_log_energy = log_of_energy_in_q8(tmp_far, far_q);
  st.i(FAR_LOG_ENERGY) = far_log_energy;
  shift_in(st, ECHO_ADAPT_LOG_ENERGY, 64,
           log_of_energy_in_q8(tmp_adapt, 12 + far_q));
  shift_in(st, ECHO_STORED_LOG_ENERGY, 64,
           log_of_energy_in_q8(tmp_stored, 12 + far_q));

  const bool in_startup = st.i(STARTUP_STATE) == 0;
  const int increase_max_shifts = in_startup ? 2 : 4;
  const int increase_min_shifts = in_startup ? 8 : 11;
  const int decrease_min_shifts = in_startup ? 2 : 3;

  const bool active = far_log_energy > 1025;
  int fe_min = st.i(FAR_ENERGY_MIN), fe_max = st.i(FAR_ENERGY_MAX);
  int fe_max_min = st.i(FAR_ENERGY_MAX_MIN);
  if (active) {
    fe_min = asym_filt(fe_min, far_log_energy, increase_min_shifts,
                       decrease_min_shifts);
    fe_max = asym_filt(fe_max, far_log_energy, increase_max_shifts, 11);
    fe_max_min = fe_max - fe_min;
  }
  st.i(FAR_ENERGY_MIN) = fe_min;
  st.i(FAR_ENERGY_MAX) = fe_max;
  st.i(FAR_ENERGY_MAX_MIN) = fe_max_min;

  int tmp16 = to_w16(2560 - fe_min);
  tmp16 = tmp16 > 0 ? to_w16((tmp16 * 230) >> 9) : 0;
  tmp16 = to_w16(tmp16 + 230);

  const int fe_vad_old = st.i(FAR_ENERGY_VAD);
  const int vad_count = st.i(VAD_UPDATE_COUNT);
  const bool vad_halted = in_startup || vad_count > 1024;
  const bool track = fe_vad_old > far_log_energy;
  int fe_vad = fe_vad_old;
  if (active) {
    fe_vad = vad_halted
                 ? fe_min + tmp16
                 : (track ? fe_vad_old +
                                ((far_log_energy + tmp16 - fe_vad_old) >> 6)
                          : fe_vad_old);
    if (!vad_halted) st.i(VAD_UPDATE_COUNT) = track ? 0 : to_w16(vad_count + 1);
    st.i(FAR_ENERGY_MSE) = fe_vad + (1 << 8);
  }
  st.i(FAR_ENERGY_VAD) = fe_vad;

  const bool above = far_log_energy > fe_vad;
  const bool dynamic = in_startup || fe_max_min > 929;
  int vad = st.i(CURRENT_VAD_VALUE);
  vad = above ? (dynamic ? 1 : vad) : 0;
  st.i(CURRENT_VAD_VALUE) = vad;

  const bool first_fire = vad != 0 && st.i(FIRST_VAD) != 0;
  const bool too_hot =
      st.i(ECHO_ADAPT_LOG_ENERGY, 0) > st.i(NEAR_LOG_ENERGY, 0);
  if (first_fire && too_hot) {
    for (int i = 0; i < PART_LEN1; ++i) {
      st.i(CHANNEL_ADAPT16, i) = st.i(CHANNEL_ADAPT16, i) >> 3;
    }
    st.i(ECHO_ADAPT_LOG_ENERGY, 0) = st.i(ECHO_ADAPT_LOG_ENERGY, 0) - (3 << 8);
  }
  if (first_fire && !too_hot) st.i(FIRST_VAD) = 0;
}

// core.calc_step_size.
__device__ int _calc_step_size_f(const St& st) {
  const int fe_min = st.i(FAR_ENERGY_MIN);
  const int tmp32 = wmul(st.i(FAR_LOG_ENERGY) - fe_min, 9);
  const int ratio = to_w16(div_w32_w16(tmp32, st.i(FAR_ENERGY_MAX_MIN)));
  int mu = max(9 - ratio, 1);
  if (fe_min >= st.i(FAR_ENERGY_MAX)) mu = 10;
  if (!(st.i(STARTUP_STATE) > 0)) mu = 1;
  return st.i(CURRENT_VAD_VALUE) == 0 ? 0 : mu;
}

// core.update_channel (NLMS + store/restore); may rewrite echo_est.
__device__ void _update_channel_f(const St& st, const int* far_spectrum,
                                  int far_q, const int* dfa, int mu,
                                  int* echo_est) {
  const int dfa_noisy_q = st.i(DFA_NOISY_Q);
  for (int i = 0; i < PART_LEN1; ++i) {
    const int ch32 = st.i(CHANNEL_ADAPT32, i);
    const int far = far_spectrum[i];
    const int zeros_ch = norm_u32((uint32_t)ch32);
    const int zeros_far = norm_u32((uint32_t)far);
    const bool safe_mul = zeros_ch + zeros_far > 31;
    const int shift_ch_far = safe_mul ? 0 : 32 - zeros_ch - zeros_far;
    const uint32_t prod_safe = (uint32_t)ch32 * (uint32_t)far;
    const int shifted_ch = shift_ch_far >= 32 ? 0 : sar_i32(ch32, shift_ch_far);
    const uint32_t prod_shifted = (uint32_t)shifted_ch * (uint32_t)far;
    uint32_t tmp_u32_no1 = safe_mul ? prod_safe : prod_shifted;

    int zeros_num = norm_u32(tmp_u32_no1);
    const int zeros_dfa = dfa[i] != 0 ? norm_u32((uint32_t)dfa[i]) : 32;
    const int tmp16_no1 =
        zeros_dfa - 2 + dfa_noisy_q - 28 - far_q + shift_ch_far;
    const bool use_dfa_domain = zeros_num > tmp16_no1 + 1;
    const int xfa_q = use_dfa_domain ? tmp16_no1 : zeros_num - 2;
    const int dfa_q = use_dfa_domain
                          ? zeros_dfa - 2
                          : 28 + far_q - dfa_noisy_q - shift_ch_far +
                                (zeros_num - 2);
    tmp_u32_no1 = shift_w32_u(tmp_u32_no1, xfa_q);
    const uint32_t tmp_u32_no2 = shift_w32_u((uint32_t)dfa[i], dfa_q);
    const int tmp32_no1 = (int)(tmp_u32_no2 - tmp_u32_no1);
    zeros_num = norm_w32(tmp32_no1);

    const bool do_update = tmp32_no1 != 0 && far > shl_i32(16, far_q);
    const bool safe_mul2 = zeros_num + zeros_far > 31;
    const bool pos = tmp32_no1 > 0;
    const int shift_num = safe_mul2 ? 0 : 32 - (zeros_num + zeros_far);
    int tmp32_no2;
    if (safe_mul2) {
      tmp32_no2 = pos ? wmul(tmp32_no1, far)
                      : wneg(wmul(wneg(tmp32_no1), far));
    } else {
      tmp32_no2 = pos ? wmul(sar_i32(tmp32_no1, shift_num), far)
                      : wneg(wmul(sar_i32(wneg(tmp32_no1), shift_num), far));
    }
    tmp32_no2 = div_w32_w16(tmp32_no2, i + 1);
    const int shift2_res_chan =
        shift_num + shift_ch_far - xfa_q - mu - (30 - zeros_far) * 2;
    tmp32_no2 = norm_w32(tmp32_no2) < shift2_res_chan
                    ? WORD32_MAX
                    : shift_w32(tmp32_no2, shift2_res_chan);
    if (mu != 0 && do_update) {
      const int new_ch32 = max(add_sat_w32(ch32, tmp32_no2), 0);
      st.i(CHANNEL_ADAPT32, i) = new_ch32;
      st.i(CHANNEL_ADAPT16, i) = new_ch32 >> 16;
    }
  }

  // --- store/restore arbitration ---
  const bool startup_store =
      st.i(STARTUP_STATE) == 0 && st.i(CURRENT_VAD_VALUE) != 0;
  const int mse_channel_count = st.i(FAR_LOG_ENERGY) < st.i(FAR_ENERGY_MSE)
                                    ? 0
                                    : st.i(MSE_CHANNEL_COUNT) + 1;
  const bool evaluate = mse_channel_count >= 20 + 10;
  int mse_stored = 0, mse_adapt = 0;
  for (int r = 0; r < 20; ++r) {
    const int nle = st.i(NEAR_LOG_ENERGY, r);
    mse_stored = wadd(mse_stored, abs(st.i(ECHO_STORED_LOG_ENERGY, r) - nle));
    mse_adapt = wadd(mse_adapt, abs(st.i(ECHO_ADAPT_LOG_ENERGY, r) - nle));
  }
  const int mse_stored_old = st.i(MSE_STORED_OLD);
  const int mse_adapt_old = st.i(MSE_ADAPT_OLD);
  const int mse_threshold = st.i(MSE_THRESHOLD);
  const bool do_reset = evaluate &&
                        shl_i32(mse_stored, 5) < wmul(29, mse_adapt) &&
                        shl_i32(mse_stored_old, 5) < wmul(29, mse_adapt_old);
  const bool do_store = evaluate && !do_reset &&
                        wmul(29, mse_stored) > shl_i32(mse_adapt, 5) &&
                        mse_adapt < mse_threshold &&
                        mse_adapt_old < mse_threshold;
  if (do_store && !startup_store) {
    const int scaled_threshold = wmul(mse_threshold, 5) / 8;
    const int bumped = wadd(
        mse_threshold, wmul(wsub(mse_adapt, scaled_threshold), 205) >> 8);
    st.i(MSE_THRESHOLD) = mse_threshold == WORD32_MAX
                              ? wadd(mse_adapt, mse_adapt_old)
                              : bumped;
  }
  const bool store_now = startup_store || do_store;
  const bool reset_now = !startup_store && do_reset;
  for (int i = 0; i < PART_LEN1; ++i) {
    if (store_now) {
      const int ch16 = st.i(CHANNEL_ADAPT16, i);
      st.i(CHANNEL_STORED, i) = ch16;
      echo_est[i] = wmul(ch16, far_spectrum[i]);
    } else if (reset_now) {
      const int stored = st.i(CHANNEL_STORED, i);
      st.i(CHANNEL_ADAPT16, i) = stored;
      st.i(CHANNEL_ADAPT32, i) = shl_i32(stored, 16);
    }
  }
  if (!startup_store) {
    st.i(MSE_CHANNEL_COUNT) = evaluate ? 0 : mse_channel_count;
    if (evaluate) {
      st.i(MSE_STORED_OLD) = mse_stored;
      st.i(MSE_ADAPT_OLD) = mse_adapt;
    }
  }
}

// core.calc_suppression_gain; returns the new sup_gain.
__device__ int _calc_suppression_gain_f(const St& st) {
  const int tmp16 = st.i(NEAR_LOG_ENERGY, 0) - st.i(ECHO_STORED_LOG_ENERGY, 0);
  const int d_e = to_w16(abs(to_w16(tmp16)));
  int sup;
  if (d_e < 400) {
    if (d_e < 200) {
      sup = st.i(SUP_GAIN_ERR_PARAM_A) -
            to_w16(div_w32_w16(
                wadd(wmul(st.i(SUP_GAIN_ERR_PARAM_DIFF_AB), d_e), 100), 200));
    } else {
      sup = st.i(SUP_GAIN_ERR_PARAM_D) +
            to_w16(div_w32_w16(
                wadd(wmul(st.i(SUP_GAIN_ERR_PARAM_DIFF_BD), 400 - d_e), 100),
                200));
    }
  } else {
    sup = st.i(SUP_GAIN_ERR_PARAM_D);
  }
  if (st.i(CURRENT_VAD_VALUE) == 0) sup = 0;
  const int old = st.i(SUP_GAIN);
  const int target = max(sup, st.i(SUP_GAIN_OLD));
  const int new_sup = to_w16(old + to_w16((target - old) >> 4));
  st.i(SUP_GAIN) = new_sup;
  st.i(SUP_GAIN_OLD) = sup;
  return new_sup;
}

// core.comfort_noise: updates the noise estimate and adds the noise to
// efw; lam is the final hnl; phase (64 rows of this slot, stride B).
__device__ void _comfort_noise_f(const St& st, const int* dfa, int* efw_re,
                                 int* efw_im, const int* lam,
                                 const int* phase, int B) {
  const int shift_noise = 15 - st.i(DFA_CLEAN_Q);
  const int ctr = st.i(NOISE_EST_CTR);
  const bool fast = ctr < 100;
  st.i(NOISE_EST_CTR) = fast ? ctr + 1 : ctr;
  const int min_track_shift = fast ? 6 : 9;
  for (int i = 0; i < PART_LEN1; ++i) {
    int noise = st.i(NOISE_EST, i);
    int too_low = st.i(NOISE_EST_TOO_LOW_CTR, i);
    int too_high = st.i(NOISE_EST_TOO_HIGH_CTR, i);
    const int out_lshift = shl_i32(dfa[i], shift_noise);
    if (out_lshift < noise) {
      if (noise < shl_i32(1, min_track_shift)) {
        const int th_inc = too_high + 1;
        if (th_inc >= 5) {
          noise = noise - 1;
          too_high = 0;
        } else {
          too_high = th_inc;
        }
      } else {
        noise = wsub(noise, sar_i32(wsub(noise, out_lshift), min_track_shift));
      }
      too_low = 0;
    } else {
      if ((noise >> 19) > 0) {
        noise = wmul(noise >> 11, 2049);
      } else if ((noise >> 11) > 0) {
        noise = wmul(noise, 2049) >> 11;
      } else {
        const int tl_inc = too_low + 1;
        if (tl_inc >= 5) {
          noise = noise + (noise >> 9) + 1;
          too_low = 0;
        } else {
          too_low = tl_inc;
        }
      }
      too_high = 0;
    }
    int tmp32 = sar_i32(noise, shift_noise);
    if (tmp32 > 32767) {
      tmp32 = 32767;
      noise = shl_i32(tmp32, shift_noise);
    }
    st.i(NOISE_EST, i) = noise;
    st.i(NOISE_EST_TOO_LOW_CTR, i) = too_low;
    st.i(NOISE_EST_TOO_HIGH_CTR, i) = too_high;
    const int amp = to_w16(wmul(ONE_Q14 - lam[i], to_w16(tmp32)) >> 14);
    // bin i >= 1 draws phase row i - 1; bin 0 and the imaginary part of
    // bin 64 get no noise
    if (i >= 1) {
      const int p = phase[(size_t)(i - 1) * B];
      const int cos_v = to_w16(p), sin_v = p >> 16;
      efw_re[i] = add_sat_w16(efw_re[i], to_w16(wmul(amp, cos_v) >> 13));
      if (i < PART_LEN) {
        efw_im[i] =
            add_sat_w16(efw_im[i], to_w16(wmul(wneg(amp), sin_v) >> 13));
      }
    }
  }
}

// core.inverse_fft_and_window: writes the 64 output samples.
__device__ void _inverse_fft_and_window_f(const St& st, const int* efw_re,
                                          const int* efw_im, int* output,
                                          int* fr, int* fi,
                                          const Inputs& in) {
  for (int i = 0; i < 128; ++i) {
    const int j = bitrev7(i);
    const int src = j <= 64 ? j : 128 - j;
    fr[i] = efw_re[src];
    const int im = to_w16(-efw_im[src]);
    fi[i] = to_w16(j <= 64 ? im : -im);
  }
  const int scale = _complex_ifft_128(fr, fi, in);
  const int shift = scale - st.i(DFA_CLEAN_Q);
  for (int i = 0; i < PART_LEN; ++i) {
    const int first = to_w16((fr[i] * in.win128[i] + 8192) >> 14);
    output[i] = sat_w16(wadd(shift_w32(first, shift), st.i(OUT_BUF, i)));
    const int second = (fr[PART_LEN + i] * in.win128[PART_LEN + i]) >> 14;
    st.i(OUT_BUF, i) = sat_w16(shift_w32(second, shift));
    st.i(X_BUF, i) = st.i(X_BUF, PART_LEN + i);
    st.i(D_BUF_NOISY, i) = st.i(D_BUF_NOISY, PART_LEN + i);
  }
}

// ---------------------------------------------------------------------------
// The block and the step (fused.py _process_block_f, frames_step)
// ---------------------------------------------------------------------------

// Per-thread working arrays.
struct Work {
  int t[128];          // FFT input window
  int fr[128], fi[128];
  int xfa[PART_LEN1], dfa[PART_LEN1], dfw_re[PART_LEN1], dfw_im[PART_LEN1];
  int far_spec[PART_LEN1], echo_est[PART_LEN1], hnl[PART_LEN1];
  int outs[N_SLOTS * PART_LEN];  // each slot's 64 output samples
};

// Sample i of the step's input stream (carry + active payload placed at
// the carry fill, zeros after): fused.py frames_step's `stream`.
__device__ __forceinline__ int stream_sample(const St& st, int carry_leaf,
                                             const int* payload,
                                             const Inputs& in, int fill0,
                                             int k, int i) {
  const int sel = fill0 >> 4;
  if (sel < 0 || sel > 3) return 0;
  const int f = 16 * sel;
  if (i < f) return st.i(carry_leaf, i);
  const int j = i - f;
  if (j >= STEP_LEN) return 0;
  // _suffix_frames: the last k frames front-aligned (k a multiple of fpc)
  if (k <= 0 || k > N_FRAMES || k % in.fpc != 0) return 0;
  if (j >= k * FRAME_LEN) return 0;
  return payload[(size_t)((N_FRAMES - k) * FRAME_LEN + j) * in.B + st.b];
}

// Pack a 65-bin block into 40 rows of slot s of pend_hist.
__device__ void _push_far_pending(const St& st, const Inputs& in, int s,
                                  const int* xfa, int far_q) {
  for (int r = 0; r < FAR_HIST_ROWS; ++r) {
    const uint32_t lo = (uint32_t)xfa[r];
    const uint32_t hi = r + FAR_HIST_ROWS < PART_LEN1
                            ? (uint32_t)xfa[r + FAR_HIST_ROWS]
                            : 0u;
    in.pend_hist[(size_t)(s * FAR_HIST_ROWS + r) * in.B + st.b] =
        (int)(lo | (hi << 16));
  }
  in.pend_q[(size_t)s * in.B + st.b] = far_q;
}

// AlignedFarend against the deferred circular view (slot s has s pending
// predecessors plus its own block): fills far_spec, returns its Q domain.
__device__ int _aligned_farend_deferred(const St& st, const Inputs& in,
                                        int s, int delay, int* far_spec) {
  const int* rows = nullptr;
  size_t stride = (size_t)in.B;
  int far_q = 0;
  if (delay >= 0 && delay <= s) {
    rows = in.pend_hist + (size_t)((s - delay) * FAR_HIST_ROWS) * in.B;
    far_q = in.pend_q[(size_t)(s - delay) * in.B + st.b];
  } else {
    const int idx_old = delay - (s + 1);
    if (delay < MAX_DELAY && idx_old >= 0) {
      int tgt = in.head + (MAX_DELAY - 1) - idx_old;
      if (tgt >= MAX_DELAY) tgt -= MAX_DELAY;
      rows = (const int*)st.lv.p[FAR_HISTORY] +
             (size_t)(tgt * FAR_HIST_ROWS) * in.B;
      far_q = st.i(FAR_Q_DOMAINS, tgt);
    }
  }
  for (int r = 0; r < FAR_HIST_ROWS; ++r) {
    const uint32_t v = rows ? (uint32_t)rows[r * stride + st.b] : 0u;
    far_spec[r] = (int)(v & 0xFFFFu);
    if (r + FAR_HIST_ROWS < PART_LEN1) {
      far_spec[r + FAR_HIST_ROWS] = (int)(v >> 16);
    }
  }
  return far_q;
}

// The far block of an inactive slot: its pending entry is the analysis of
// the committed x_buf[:64] followed by the slot's stream samples (the
// plain version computes and discards the whole block; only this part of
// it is visible in the outputs).
__device__ void _inactive_slot(const St& st, const Inputs& in, Work& w,
                               int s, int fill0, int k) {
  for (int i = 0; i < PART_LEN; ++i) {
    w.t[i] = st.i(X_BUF, i);
    w.t[PART_LEN + i] = stream_sample(st, IN_CARRY_FAR, in.far, in, fill0, k,
                                      s * PART_LEN + i);
  }
  int far_q;
  _time_to_frequency_domain_f(w.t, w.dfw_re, w.dfw_im, w.xfa, &far_q, w.fr,
                              w.fi, in);
  _push_far_pending(st, in, s, w.xfa, far_q);
  for (int i = 0; i < PART_LEN; ++i) w.outs[s * PART_LEN + i] = 0;
}

// core.process_block for slot s (an active slot).
__device__ void _process_block_f(const St& st, const Inputs& in, Work& w,
                                 int s, int fill0, int k) {
  if (st.i(STARTUP_STATE) < 2) {
    const int tc = st.i(TOT_COUNT);
    st.i(STARTUP_STATE) = (tc >= 512) + (tc >= 1024);
  }
  // x_buf / d_buf_noisy: [previous block, this block]
  for (int i = 0; i < PART_LEN; ++i) {
    const int v = stream_sample(st, IN_CARRY_FAR, in.far, in, fill0, k,
                                s * PART_LEN + i);
    st.i(X_BUF, PART_LEN + i) = v;
  }
  for (int i = 0; i < PART_LEN; ++i) {
    const int v = stream_sample(st, IN_CARRY_NOISY, in.noisy, in, fill0, k,
                                s * PART_LEN + i);
    st.i(D_BUF_NOISY, PART_LEN + i) = v;
  }
  for (int i = 0; i < 128; ++i) w.t[i] = st.i(X_BUF, i);
  int far_q;
  _time_to_frequency_domain_f(w.t, w.dfw_re, w.dfw_im, w.xfa, &far_q, w.fr,
                              w.fi, in);
  for (int i = 0; i < 128; ++i) w.t[i] = st.i(D_BUF_NOISY, i);
  int zeros_d;
  const uint32_t dfa_sum = _time_to_frequency_domain_f(
      w.t, w.dfw_re, w.dfw_im, w.dfa, &zeros_d, w.fr, w.fi, in);
  const int dfa_noisy_q_prev = st.i(DFA_NOISY_Q);
  st.i(DFA_NOISY_Q_OLD) = dfa_noisy_q_prev;
  st.i(DFA_NOISY_Q) = zeros_d;
  st.i(DFA_CLEAN_Q_OLD) = dfa_noisy_q_prev;
  st.i(DFA_CLEAN_Q) = zeros_d;

  _push_far_pending(st, in, s, w.xfa, far_q);
  _add_far_spectrum_fix_f(st, w.xfa, far_q);
  const uint32_t near_bits = _binary_spectrum_fix_f(
      st, w.dfa, NE_MEAN_SPECTRUM, NE_SPECTRUM_INITIALIZED, zeros_d);
  int delay = _process_binary_spectrum_f(st, near_bits);
  if (delay == -2) delay = 0;
  if (st.i(FIXED_DELAY) >= 0) delay = st.i(FIXED_DELAY);

  const int zeros_x_buf = _aligned_farend_deferred(st, in, s, delay,
                                                   w.far_spec);
  _calc_energies_f(st, w.far_spec, zeros_x_buf, dfa_sum, w.echo_est);
  const int mu = _calc_step_size_f(st);
  st.i(TOT_COUNT) = st.i(TOT_COUNT) + 1;
  _update_channel_f(st, w.far_spec, zeros_x_buf, w.dfa, mu, w.echo_est);
  const int sup_gain = _calc_suppression_gain_f(st);

  // --- Wiener filter hnl ---
  const int zeros16 = norm_w16(sup_gain) + 1;
  const int dfa_clean_q = st.i(DFA_CLEAN_Q);
  const int dq_diff = dfa_clean_q - st.i(DFA_CLEAN_Q_OLD);
  int num_pos_coef = 0;
  for (int i = 0; i < PART_LEN1; ++i) {
    const int ef_old = st.i(ECHO_FILT, i);
    const int echo_filt = wadd(
        ef_old, mul_i64_shift_right(wsub(w.echo_est[i], ef_old), 50, 8));
    st.i(ECHO_FILT, i) = echo_filt;

    const int zeros32 = norm_w32(echo_filt) + 1;
    const bool safe = zeros32 + zeros16 > 16;
    const int tmp16_no1 = 17 - zeros32 - zeros16;
    uint32_t gained;
    int resolution_diff;
    if (safe) {
      gained = (uint32_t)echo_filt * (uint32_t)sup_gain;
      resolution_diff = 14 - 12 - 8 + dfa_clean_q - zeros_x_buf;
    } else {
      gained = zeros32 > tmp16_no1
                   ? (uint32_t)echo_filt *
                         (uint32_t)sar_i32(sup_gain, tmp16_no1)
                   : (uint32_t)wmul(sar_i32(echo_filt, tmp16_no1), sup_gain);
      resolution_diff = 14 + tmp16_no1 - 12 - 8 + dfa_clean_q - zeros_x_buf;
    }

    const int nf = st.i(NEAR_FILT, i);
    const int zeros16n = norm_w16(nf);
    const bool cramped = zeros16n < dq_diff && nf != 0;
    int t1, t2, q_domain_diff;
    if (cramped) {
      t1 = to_w16(shl_i32(nf, zeros16n));
      q_domain_diff = zeros16n - dq_diff;
      t2 = sar_i32(w.dfa[i], -q_domain_diff);
    } else {
      t1 = to_w16(dq_diff < 0 ? sar_i32(nf, -dq_diff) : shl_i32(nf, dq_diff));
      q_domain_diff = 0;
      t2 = to_w16(w.dfa[i]);
    }
    t2 = to_w16(to_w16(wsub(t2, t1) >> 4) + t1);
    const int zeros16n2 = norm_w16(t2);
    int near_filt;
    if ((t2 & 1) != 0 && -q_domain_diff > zeros16n2) {
      near_filt = WORD16_MAX;
    } else if (q_domain_diff < 0) {
      near_filt = to_w16(shl_i32(t2, -q_domain_diff));
    } else {
      near_filt = sar_i32(t2, q_domain_diff);
    }
    st.i(NEAR_FILT, i) = near_filt;

    const uint32_t rounded = gained + (uint32_t)sar_i32(near_filt, 1);
    const uint32_t ratio =
        div_u32_u16(rounded, (uint32_t)(near_filt & 0xFFFF));
    const int tmp32no1 = (int)shift_w32_u(ratio, resolution_diff);
    int hnl = tmp32no1 > ONE_Q14 ? 0
                                 : (tmp32no1 < 0 ? ONE_Q14
                                                 : max(ONE_Q14 - tmp32no1, 0));
    if (gained == 0) {
      hnl = ONE_Q14;
    } else if (near_filt == 0) {
      hnl = 0;
    }
    w.hnl[i] = hnl;
    num_pos_coef += hnl != 0;
  }

  if (in.mult == 2) {
    int avg = 0;
    for (int i = 0; i < PART_LEN1; ++i) {
      w.hnl[i] = to_w16((w.hnl[i] * w.hnl[i]) >> 14);
      if (i >= 4 && i <= 24) avg += w.hnl[i];
    }
    avg /= 21;
    for (int i = 24; i < PART_LEN1; ++i) {
      if (w.hnl[i] > avg) w.hnl[i] = avg;
    }
  }
  if (st.i(NLP_FLAG) != 0) {
    const int nlp_gain = num_pos_coef < 3 ? 0 : ONE_Q14;
    for (int i = 0; i < PART_LEN1; ++i) {
      int h = w.hnl[i];
      h = h < 3277 ? 0 : (h > ONE_Q14 ? ONE_Q14 : h);
      w.hnl[i] = (h == ONE_Q14 && nlp_gain == ONE_Q14)
                     ? ONE_Q14
                     : to_w16((h * nlp_gain) >> 14);
    }
  }

  // efw = dfw * hnl (reusing the dfw arrays), comfort noise, IFFT
  for (int i = 0; i < PART_LEN1; ++i) {
    w.dfw_re[i] = to_w16((w.dfw_re[i] * w.hnl[i] + 8192) >> 14);
    w.dfw_im[i] = to_w16((w.dfw_im[i] * w.hnl[i] + 8192) >> 14);
  }
  if (st.i(CNG_MODE) != 0) {
    _comfort_noise_f(st, w.dfa, w.dfw_re, w.dfw_im, w.hnl,
                     in.phase + (size_t)(s * PART_LEN) * in.B + st.b, in.B);
  }
  _inverse_fft_and_window_f(st, w.dfw_re, w.dfw_im, w.outs + s * PART_LEN,
                            w.fr, w.fi, in);
}

__device__ __forceinline__ int slot_sample(const Work& w, int slot, int i) {
  return (slot >= 0 && slot < N_SLOTS) ? w.outs[slot * PART_LEN + i] : 0;
}

__global__ void __launch_bounds__(32)
frames_step_kernel(const __grid_constant__ Leaves lv,
                   const __grid_constant__ Inputs in) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= in.B) return;
  const St st{lv, in.B, b};
  Work w;

  const int fill0 = st.i(FRAME_FILL);
  int k = 0;
  for (int f = 0; f < N_FRAMES; ++f) k += in.run_rows[(size_t)f * in.B + b] != 0;
  const bool run_last = in.run_rows[(size_t)(N_FRAMES - 1) * in.B + b] != 0;
  const int total = fill0 + FRAME_LEN * k;

  // slot-major block schedule; activity is monotone in s
  for (int s = 0; s < N_SLOTS; ++s) {
    if (total >= PART_LEN * (s + 1)) {
      _process_block_f(st, in, w, s, fill0, k);
    } else {
      _inactive_slot(st, in, w, s, fill0, k);
    }
  }

  // in-carry: rows [64, 128) of the last active frame's window (stream
  // rows >= 64 never read the carry, so updating it in place is safe)
  if (run_last) {
    const int b_last_p1 = ((fill0 + FRAME_LEN * max(k - 1, 0)) >> 6) + 1;
    for (int i = 0; i < PART_LEN; ++i) {
      const int row = b_last_p1 * PART_LEN + i;
      const bool ok = b_last_p1 >= 1 && b_last_p1 <= N_SLOTS;
      const int vf = ok ? stream_sample(st, IN_CARRY_FAR, in.far, in, fill0,
                                        k, row) : 0;
      const int vn = ok ? stream_sample(st, IN_CARRY_NOISY, in.noisy, in,
                                        fill0, k, row) : 0;
      st.i(IN_CARRY_FAR, i) = vf;
      st.i(IN_CARRY_NOISY, i) = vn;
    }
  }
  st.i(FRAME_FILL) = (fill0 + 16 * k) & 63;

  // per-frame output attribution and the 80-sample emit, in frame order
  for (int f = 0; f < N_FRAMES; ++f) {
    const bool run_f = in.run_rows[(size_t)f * in.B + b] != 0;
    const int j_f = max(k - (N_FRAMES - f), 0);
    const bool two = (((fill0 + 16 * j_f) & 63) >= 48) && run_f;
    const int b_f = (fill0 + FRAME_LEN * j_f) >> 6;
    const int o = st.i(OUT_FILL);
    const int osel = o >> 4;
    const int fo = 16 * osel;
    int* work_out = w.t;                // 192 samples: t, then fr
    for (int i = 0; i < 192; ++i) {
      int v = 0;
      if (osel >= 0 && osel <= 3) {
        if (i < fo) {
          v = st.i(OUT_CARRY, i);
        } else if (i - fo < 128) {
          const int pi = i - fo;
          v = pi < PART_LEN ? slot_sample(w, b_f, pi)
                            : (two ? slot_sample(w, b_f + 1, pi - PART_LEN)
                                   : 0);
        }
      }
      (i < 128 ? work_out[i] : w.fr[i - 128]) = v;
    }
    auto wo = [&](int i) { return i < 128 ? work_out[i] : w.fr[i - 128]; };
    const int avail = o + (1 + (two ? 1 : 0)) * PART_LEN;
    const int stuff = max(0, FRAME_LEN - avail);
    const bool stuffed = stuff > 0;
    int* out_f = w.fi;                  // 80 samples
    for (int i = 0; i < FRAME_LEN; ++i) {
      out_f[i] = stuffed ? (i < 16 ? st.i(OUT_TAIL, i) : wo(i - 16)) : wo(i);
      in.out[(size_t)(f * FRAME_LEN + i) * in.B + b] = out_f[i];
    }
    if (run_f) {
      for (int i = 0; i < PART_LEN; ++i) {
        st.i(OUT_CARRY, i) = stuffed ? wo(64 + i) : wo(FRAME_LEN + i);
      }
      st.i(OUT_FILL) = avail + stuff - FRAME_LEN;
      for (int i = 0; i < 16; ++i) st.i(OUT_TAIL, i) = out_f[64 + i];
    }
  }
}

}  // namespace
}  // namespace aecm

extern "C" int aecm_frames_step(void* const* leaves, int n_leaves,
                                const void* far, const void* noisy,
                                const void* phase, const void* run_rows,
                                const void* win128, const void* fwr,
                                const void* fws, void* out, void* pend_hist,
                                void* pend_q, int B, int head, int mult,
                                int fpc, void* stream) {
  using namespace aecm;
  if (n_leaves != N_LEAVES) return -1;
  if (B <= 0 || head < 0 || head >= MAX_DELAY || fpc <= 0) return -2;
  Leaves lv;
  for (int i = 0; i < N_LEAVES; ++i) lv.p[i] = leaves[i];
  Inputs in{(const int*)far,   (const int*)noisy, (const int*)phase,
            (const bool*)run_rows, (const int*)win128, (const int*)fwr,
            (const int*)fws,   (int*)out,         (int*)pend_hist,
            (int*)pend_q,      B, head, mult, fpc};
  const int threads = 32;
  const int blocks = (B + threads - 1) / threads;
  frames_step_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(lv, in);
  return (int)cudaGetLastError();
}
