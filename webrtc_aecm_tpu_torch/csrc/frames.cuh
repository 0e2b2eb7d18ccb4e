// The frames kernel: the whole AECM core of one fused serving step, for
// Hopper (sm_90a).  The device code, templated on the near input (single or
// clean), on the far history's order, and on general-or-main (below);
// frames.cu builds the single-input instances and the C entry points,
// frames_clean.cu the clean ones, so that the two compile at once.
//
// Replaces the TPU kernel _frames_kernel_call (webrtc_aecm_tpu/fused.py:
// 1595, pallas_call :1708, body frames_step :1283 -> _process_block_f
// :1037) in each of its modes: any number of frames a step, a single or a
// clean near input (has_clean: a third forward transform per block, the
// clean Q domains, the clean spectrum in the Wiener stage and in comfort
// noise), abs_approx magnitudes, a delay estimator of any history size and
// lookahead capacity (taken from the leaf shapes, as the TPU kernel takes
// them), and the far history circular (the step's new blocks go out to
// pend_hist / pend_q for the caller to append; steps of whole blocks
// dividing the 100-block history) or newest-first (merged in place at the
// end of the step: fused.py _far_merge_deferred).  Plain version:
// webrtc_aecm_tpu_torch/fused.py `frames_step`; the __device__ functions
// below carry the names of their counterparts there.
//
// Two kinds of instance.  The main path's (history 100, capacity 1, at
// most 5 block slots: 1 to 4 frames, circular at 4) fix their layout at
// compile time.  The general ones take the delay estimator's sizes at
// launch (Geo), run any number of slots in windows of 5, write each slot's
// pending block and each frame's output to global memory as they are made,
// and take as many streams a block as leave the most warps resident.
//
// Bound on the card: integer operations, not bytes.  A 5-slot step is
// about 0.24 M integer operations per stream (three 128-point fixed-point
// FFTs, the history-size delay search and the 65-bin NLMS / Wiener /
// comfort-noise stages per block; counted by stage in chip_smoke.py,
// FRAMES_OPS) against 22 KB of state and samples moved (the newest-first
// history merge adds 32.8 KB).  What the design does about it:
//
//   * One warp per stream, G streams per thread block.  Lanes take bins:
//     the 65-bin stages run as three passes of 32 lanes (bin 64 is the
//     tail of the third), the H delay candidates and the H + 1 histogram
//     entries as ceil(H / 32) passes.  Every branch on a per-stream scalar
//     is uniform across the warp, so streams do not diverge from each
//     other; the modes of a call (clean input, history order, general) are
//     template parameters and abs_approx and the frame count are the same
//     for every stream.
//   * The state is staged in shared memory once per launch.  The state
//     keeps the lane-major (rows, B) layout, so the G adjacent streams of a
//     block give 4 G contiguous bytes per row; the block loads and stores
//     its streams' leaves cooperatively (G = 8 fills a 32-byte sector).
//     The loads are asynchronous copies, all in flight at once.
//     far_history / far_q_domains stay in global memory (one block of 40
//     rows is fetched per slot), as do the sample inputs, which each slot
//     fetches for the slot after it.  A clean input takes 2 KB more a
//     stream, so its main instances run 4 streams a block.
//   * One-row leaves are read from the staged copy into registers once,
//     carried through the slots, and written back once.
//   * The FFTs run in the stream's shared memory, two butterflies per lane
//     and stage with __syncwarp() between stages; the twiddle rows and the
//     window are loaded into shared memory once per block.  A block's
//     forward transforms run together, butterfly by butterfly.  The
//     inverse transform's per-stage maximum is a warp reduction over the
//     values each lane wrote in the stage before.
//   * Histories are not shifted.  Each of the one-row-per-block histories
//     is staged with N_SLOTS words of head room; slot a of a window writes
//     its new row at head room position 4 - a, and the store copies the
//     view that starts as many rows before the loaded one as the last
//     window's active slots.  Between two windows (general instances) each
//     history moves back by N_SLOTS words, which resets its head room.
//     The newest-first far history is shifted once, by the whole block, in
//     descending chunks of rows: row r of a stream takes row r - 40 n_act
//     of the same stream, so each chunk is read, the block syncs, and the
//     chunk is written.
//   * Sums across bins are integer and wrap, so the warp reductions give
//     the bits of the serial loops.  The delay search reduces on the value
//     and then on the lowest index that holds it.
//   * No 64-bit division: WebRtcSpl_DivW32W16 is a 32-bit divide with its
//     one overflowing quotient handled apart (spl.cuh).
//
// Every core leaf the step can change is updated in place (as
// input_output_aliases does for the TPU kernel), the CNG seed among them.
// Each lane draws its own comfort-noise phases: draw k of the step is the
// seed advanced k + 1 times, one multiply-add from the LCG's affine-closure
// tables, then a lookup in the Q13 cos and sin tables; the tables are a few
// KB and are read through the read-only cache, since the lanes of a warp
// index different entries.  Built with
// --fmad=false so the float32 histogram arithmetic rounds op by op like the
// PyTorch version.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "spl.cuh"

namespace aecm {

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

struct Leaves {
  void* p[N_LEAVES];
};

// Where a stream's delay-estimator rows stand in its shared region, and
// their sizes: fixed in the main path's instances, from the leaf shapes in
// the general ones.
struct Geo {
  int H;         // history size: far-end histories and bit counts H rows,
                 // mean bit counts and histogram H + 1
  int cap;       // lookahead capacity: near binary history rows
  int fe_hist, fe_bc, ne_bc, ne_mbc, ne_hist, ne_bh;   // word offsets
  int words;     // a stream's region
};

struct Inputs {
  const int* far;        // (n_frames * 80, B) far frames
  const int* noisy;      // (n_frames * 80, B) near frames
  const int* clean;      // (n_frames * 80, B) clean near frames, or null
  const long long* lcg_a;  // (>= n_slots * 64,) uint32 values: CNG draw k is
  const long long* lcg_c;  //   the seed (lcg_a[k] seed + lcg_c[k]) mod 2^31
  const int* cos360;       // (360,) Q13 phase tables
  const int* sin360;
  const bool* run_rows;  // (n_frames, B)
  const int* win128;     // (128,)
  const int* fwr;        // (7, 128) per-stage per-row twiddles
  const int* fws;        // (7, 128)
  int* out;              // (n_frames * 80, B)
  int* pend_hist;        // (n_slots * 40, B): the circular history's output,
  int* pend_q;           // (n_slots, B)       and the general instances' store
  const int* head;       // the circular history's head (device memory)
  int B, mult, fpc, n_frames, abs_approx;
  Geo geo;               // the general instances' layout
  int lg;                // log2 of the general instances' streams a block
};

// The clean instances (frames_clean.cu), called from frames.cu.
int frames_launch_clean(bool circular, bool general, const Leaves& lv,
                        Inputs in, cudaStream_t stream);
int frames_layout_clean(bool circular, bool general, int H, int cap,
                        int* streams_per_block, int* smem_bytes,
                        int* blocks_per_sm);

namespace {

constexpr int PART_LEN = 64;
constexpr int PART_LEN1 = 65;
constexpr int FRAME_LEN = 80;
constexpr int MAX_DELAY = 100;
constexpr int FAR_HIST_ROWS = 40;
constexpr int N_FRAMES = 4;            // the main instances' widest step
constexpr int N_SLOTS = 5;             // (4*80 + 48) / 64, staged at once
constexpr int STEP_LEN = N_FRAMES * FRAME_LEN;
constexpr int ONE_Q14 = 1 << 14;
constexpr float Q14_SCALING = 1.0f / 16384.0f;

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int MEAN_LO = 12;            // the binary spectrum uses bins 12..43

// ---------------------------------------------------------------------------
// Shared memory: per block the tables, then one region per stream
// ---------------------------------------------------------------------------

// Word offsets inside a stream's region.  A sliding history (see the
// header) has N_SLOTS words of head room in front of its rows.  The delay
// estimator's rows follow the fixed part (Geo).
enum Off {
  O_X_BUF = 0,
  O_D_BUF = O_X_BUF + 128,
  O_OUT_BUF = O_D_BUF + 128,
  O_CARRY_FAR = O_OUT_BUF + PART_LEN,
  O_CARRY_NOISY = O_CARRY_FAR + PART_LEN,
  O_OUT_CARRY = O_CARRY_NOISY + PART_LEN,
  O_OUT_TAIL = O_OUT_CARRY + PART_LEN,
  O_FE_MEAN = O_OUT_TAIL + 16,                  // rows 12..43
  O_NE_MEAN = O_FE_MEAN + 32,                   // rows 12..43
  O_NLE = O_NE_MEAN + 32,                       // sliding
  O_EALE = O_NLE + N_SLOTS + PART_LEN,          // sliding
  O_ESLE = O_EALE + N_SLOTS + PART_LEN,         // sliding
  O_CH_STORED = O_ESLE + N_SLOTS + PART_LEN,
  O_CH16 = O_CH_STORED + PART_LEN1,
  O_CH32 = O_CH16 + PART_LEN1,
  O_ECHO_FILT = O_CH32 + PART_LEN1,
  O_NEAR_FILT = O_ECHO_FILT + PART_LEN1,
  O_NOISE = O_NEAR_FILT + PART_LEN1,
  O_TOO_LOW = O_NOISE + PART_LEN1,
  O_TOO_HIGH = O_TOO_LOW + PART_LEN1,
  O_SCAL = O_TOO_HIGH + PART_LEN1,              // one-row leaves, by Leaf
  O_N_ACT = O_SCAL + N_LEAVES,                  // active slots of this step
  O_N_SLIDE = O_N_ACT + 1,                      // ... in its last window
  // working arrays and staged outputs
  O_PEND = O_N_SLIDE + 1,                       // far blocks of 5 slots
  O_PEND_Q = O_PEND + N_SLOTS * FAR_HIST_ROWS,
  O_FR = O_PEND_Q + N_SLOTS,
  O_FI = O_FR + 128,
  O_XFA = O_FI + 128,
  O_DFA = O_XFA + PART_LEN1,
  O_OUTS = O_DFA + PART_LEN1,                   // 64 samples of 5 slots
  O_EMIT = O_OUTS + N_SLOTS * PART_LEN,         // the step's outputs
  O_END = O_EMIT + STEP_LEN,
  // the clean input's leaves and arrays, in the clean layout only
  O_D_BUF_CLEAN = O_END,
  O_CARRY_CLEAN = O_D_BUF_CLEAN + 128,
  O_DFA_CLEAN = O_CARRY_CLEAN + PART_LEN,
  O_FFT3 = O_DFA_CLEAN + PART_LEN1,             // the third transform
  O_END_CLEAN = O_FFT3 + 256
};
// Forward transform t works at fft_re(t) (re) and fft_re(t) + 128 (im).
// The second works in the emit staging, which the main path's instances
// write only after the step's last slot and the general ones never.
__device__ __forceinline__ constexpr int fft_re(int t) {
  return t == 0 ? O_FR : (t == 1 ? O_EMIT : O_FFT3);
}
static_assert(O_FI == O_FR + 128, "a transform's im follows its re");
static_assert(2 * 128 <= STEP_LEN, "the second transform fits the staging");
constexpr int TABLE_WORDS = 2 * 7 * 128 + 128;  // fwr, fws, win128
// The most shared memory a thread block may take (sm_90).
constexpr int SMEM_LIMIT = 232448;

// A stream's region at history size H and lookahead capacity cap: the
// fixed part, then the two sliding far-end histories, the near bit counts,
// mean bit counts and histogram, and (general instances only: the main
// path's capacity-1 row rides in a register) the sliding near binary
// history.  A stride of 4 mod 32 words spreads the cooperative load's G
// streams x 4 rows over all 32 banks.
__host__ __device__ constexpr Geo make_geo(bool clean, bool general, int H,
                                           int cap) {
  const int fe_hist = clean ? (int)O_END_CLEAN : (int)O_END;
  const int fe_bc = fe_hist + N_SLOTS + H;
  const int ne_bc = fe_bc + N_SLOTS + H;
  const int ne_mbc = ne_bc + H;
  const int ne_hist = ne_mbc + H + 1;
  const int ne_bh = ne_hist + H + 1;
  const int end = ne_bh + (general ? N_SLOTS + cap : 0);
  return Geo{H, cap, fe_hist, fe_bc, ne_bc, ne_mbc, ne_hist, ne_bh,
             ((end - 4 + 31) / 32) * 32 + 4};
}

// The launch shape of the main path's instances (history 100, capacity
// 1): the clean layout's 3,652 words a stream take 4 streams a block, 3
// blocks an SM.  The general instances take up to G streams a block, as
// many as leave the most warps resident (frames_shape).
template <bool CLEAN>
struct Layout {
  static constexpr int LG = CLEAN ? 2 : 3;
  static constexpr int G = 1 << LG;            // streams (= warps) a block
  static constexpr int THREADS = 32 * G;
  static constexpr int MIN_BLOCKS = CLEAN ? 3 : 2;
  static constexpr Geo GEO = make_geo(CLEAN, false, 100, 1);
  static constexpr int STREAM_WORDS = GEO.words;
  static constexpr int SMEM_BYTES = (TABLE_WORDS + G * STREAM_WORDS) * 4;
};
static_assert(Layout<false>::SMEM_BYTES == 108160,
              "the main path's single-input layout");
static_assert(Layout<true>::SMEM_BYTES == 66112,
              "the main path's clean layout");

// A leaf with rows, staged at `off`: rows [row0, row0 + rows) of it.  The
// delay estimator's leaves, whose rows and offsets are the Geo's, are
// staged apart (de_leaves).
struct RowLeaf {
  short leaf, row0, rows, off;
  bool slide;   // a sliding history
};
__constant__ RowLeaf kRowLeaves[] = {
    {X_BUF, 0, 128, O_X_BUF, false},
    {D_BUF_NOISY, 0, 128, O_D_BUF, false},
    {OUT_BUF, 0, PART_LEN, O_OUT_BUF, false},
    {IN_CARRY_FAR, 0, PART_LEN, O_CARRY_FAR, false},
    {IN_CARRY_NOISY, 0, PART_LEN, O_CARRY_NOISY, false},
    {OUT_CARRY, 0, PART_LEN, O_OUT_CARRY, false},
    {OUT_TAIL, 0, 16, O_OUT_TAIL, false},
    {FE_MEAN_SPECTRUM, MEAN_LO, 32, O_FE_MEAN, false},
    {NE_MEAN_SPECTRUM, MEAN_LO, 32, O_NE_MEAN, false},
    {NEAR_LOG_ENERGY, 0, PART_LEN, O_NLE, true},
    {ECHO_ADAPT_LOG_ENERGY, 0, PART_LEN, O_EALE, true},
    {ECHO_STORED_LOG_ENERGY, 0, PART_LEN, O_ESLE, true},
    {CHANNEL_STORED, 0, PART_LEN1, O_CH_STORED, false},
    {CHANNEL_ADAPT16, 0, PART_LEN1, O_CH16, false},
    {CHANNEL_ADAPT32, 0, PART_LEN1, O_CH32, false},
    {ECHO_FILT, 0, PART_LEN1, O_ECHO_FILT, false},
    {NEAR_FILT, 0, PART_LEN1, O_NEAR_FILT, false},
    {NOISE_EST, 0, PART_LEN1, O_NOISE, false},
    {NOISE_EST_TOO_LOW_CTR, 0, PART_LEN1, O_TOO_LOW, false},
    {NOISE_EST_TOO_HIGH_CTR, 0, PART_LEN1, O_TOO_HIGH, false},
    // the clean input's, staged by the clean instances only
    {D_BUF_CLEAN, 0, 128, O_D_BUF_CLEAN, false},
    {IN_CARRY_CLEAN, 0, PART_LEN, O_CARRY_CLEAN, false},
};
// the single-input instances stage all but the last two
constexpr int N_ROW_LEAVES = sizeof(kRowLeaves) / sizeof(RowLeaf);

// The one-row leaves the step reads; X(field, LEAF).  The first list is
// written back, the second is read-only.  Float leaves travel as bits.
#define AECM_RW_SCALARS(X)                                                   \
  X(frame_fill, FRAME_FILL) X(out_fill, OUT_FILL)                            \
  X(fe_spectrum_initialized, FE_SPECTRUM_INITIALIZED)                        \
  X(ne_spectrum_initialized, NE_SPECTRUM_INITIALIZED)                        \
  X(ne_binary_history, NE_BINARY_HISTORY)                                    \
  X(minimum_probability, NE_MINIMUM_PROBABILITY)                             \
  X(last_delay_probability, NE_LAST_DELAY_PROBABILITY)                       \
  X(last_delay, NE_LAST_DELAY)                                               \
  X(last_candidate_delay, NE_LAST_CANDIDATE_DELAY)                           \
  X(compare_delay, NE_COMPARE_DELAY) X(candidate_hits, NE_CANDIDATE_HITS)    \
  X(last_delay_histogram, NE_LAST_DELAY_HISTOGRAM)                           \
  X(tot_count, TOT_COUNT) X(dfa_clean_q, DFA_CLEAN_Q)                        \
  X(dfa_clean_q_old, DFA_CLEAN_Q_OLD) X(dfa_noisy_q, DFA_NOISY_Q)            \
  X(dfa_noisy_q_old, DFA_NOISY_Q_OLD) X(far_log_energy, FAR_LOG_ENERGY)      \
  X(noise_est_ctr, NOISE_EST_CTR) X(mse_adapt_old, MSE_ADAPT_OLD)            \
  X(mse_stored_old, MSE_STORED_OLD) X(mse_threshold, MSE_THRESHOLD)          \
  X(far_energy_min, FAR_ENERGY_MIN) X(far_energy_max, FAR_ENERGY_MAX)        \
  X(far_energy_max_min, FAR_ENERGY_MAX_MIN)                                  \
  X(far_energy_vad, FAR_ENERGY_VAD) X(far_energy_mse, FAR_ENERGY_MSE)        \
  X(current_vad_value, CURRENT_VAD_VALUE)                                    \
  X(vad_update_count, VAD_UPDATE_COUNT) X(first_vad, FIRST_VAD)              \
  X(startup_state, STARTUP_STATE) X(mse_channel_count, MSE_CHANNEL_COUNT)    \
  X(sup_gain, SUP_GAIN) X(sup_gain_old, SUP_GAIN_OLD)
#define AECM_RO_SCALARS(X)                                                   \
  X(allowed_offset, NE_ALLOWED_OFFSET)                                       \
  X(robust_validation_enabled, NE_ROBUST_VALIDATION_ENABLED)                 \
  X(nlp_flag, NLP_FLAG) X(fixed_delay, FIXED_DELAY) X(cng_mode, CNG_MODE)    \
  X(sup_gain_err_param_a, SUP_GAIN_ERR_PARAM_A)                              \
  X(sup_gain_err_param_d, SUP_GAIN_ERR_PARAM_D)                              \
  X(sup_gain_err_param_diff_ab, SUP_GAIN_ERR_PARAM_DIFF_AB)                  \
  X(sup_gain_err_param_diff_bd, SUP_GAIN_ERR_PARAM_DIFF_BD)

#define AECM_LEAF_ID(field, LEAF) LEAF,
__constant__ short kScalarLeaves[] = {
    AECM_RW_SCALARS(AECM_LEAF_ID) AECM_RO_SCALARS(AECM_LEAF_ID)};
#define AECM_COUNT(field, LEAF) +1
constexpr int N_RW_SCALARS = 0 AECM_RW_SCALARS(AECM_COUNT);
constexpr int N_SCALARS = N_RW_SCALARS AECM_RO_SCALARS(AECM_COUNT);

// One stream's one-row leaves, in registers; every lane holds the same
// values.
struct Scal {
#define AECM_FIELD(field, LEAF) int field;
  AECM_RW_SCALARS(AECM_FIELD)
  AECM_RO_SCALARS(AECM_FIELD)
#undef AECM_FIELD
};

// What a warp needs to run its stream.
struct Ctx {
  int* S;           // the stream's shared region
  const int* fwr;   // the block's shared tables
  const int* fws;
  const int* win;
  const Leaves& lv;
  const Inputs& in;
  int b, lane;
  Geo g;            // the delay estimator's rows (constants in the main
                    // path's instances)
  int lookahead;    // the stream's lookahead (general instances)
  int head;         // the circular history's head
  uint32_t seed;    // the stream's CNG seed at entry (the leaf's low word)
};

__device__ __forceinline__ int warp_max(int v) {
  return __reduce_max_sync(FULL, v);
}
__device__ __forceinline__ int warp_min(int v) {
  return __reduce_min_sync(FULL, v);
}
__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
  return __reduce_add_sync(FULL, v);
}

// ---------------------------------------------------------------------------
// FFT pair, order 7, mode 1 (ops/fft.py via fused.py _complex_*_128), in
// the stream's O_FR / O_FI: 64 butterflies a stage, two per lane
// ---------------------------------------------------------------------------

__device__ __forceinline__ int bitrev7(int i) { return (int)(__brev(i) >> 25); }

// Transform t lives at word fft_re(t) (re) and fft_re(t) + 128 (im).  N
// independent transforms run butterfly by butterfly
// together: they share the index arithmetic and the twiddles, and their
// dependent chains overlap.
template <int N>
__device__ void _complex_fft_128(const Ctx& c) {
  for (int s = 0; s < 7; ++s) {
    __syncwarp();
    const int l = 1 << s;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = c.lane + 32 * h;
      const int i = ((k >> s) << (s + 1)) | (k & (l - 1));
      const int j = i | l;
      const int wr = c.fwr[s * 128 + i];
      const int wi = -c.fws[s * 128 + i];
#pragma unroll
      for (int t = 0; t < N; ++t) {
        int* fr = c.S + fft_re(t);
        int* fi = fr + 128;
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
  __syncwarp();
}

// Inverse with the per-stage data-dependent scaling; returns the scale.
// `maxabs` is the largest |value| this lane wrote into O_FR / O_FI.
__device__ int _complex_ifft_128(const Ctx& c, int maxabs) {
  int* fr = c.S + O_FR;
  int* fi = c.S + O_FI;
  int scale = 0;
  for (int s = 0; s < 7; ++s) {
    maxabs = min(warp_max(maxabs), 32767);
    const int shift = (maxabs > 13573) + (maxabs > 27146);
    scale += shift;
    const int rnd = 8192 << shift;
    const int l = 1 << s;
    __syncwarp();
    maxabs = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = c.lane + 32 * h;
      const int i = ((k >> s) << (s + 1)) | (k & (l - 1));
      const int j = i | l;
      const int wr = c.fwr[s * 128 + i];
      const int wi = c.fws[s * 128 + i];
      const int ar = fr[i], ai = fi[i], br = fr[j], bi = fi[j];
      const int tr = (wr * br - wi * bi + 1) >> 1;
      const int ti = (wr * bi + wi * br + 1) >> 1;
      const int qr = ar * 16384, qi = ai * 16384;
      const int ri = to_w16((qr + tr + rnd) >> (shift + 14));
      const int ii = to_w16((qi + ti + rnd) >> (shift + 14));
      const int rj = to_w16((qr - tr + rnd) >> (shift + 14));
      const int ij = to_w16((qi - ti + rnd) >> (shift + 14));
      fr[i] = ri;
      fi[i] = ii;
      fr[j] = rj;
      fi[j] = ij;
      maxabs = max(max(maxabs, max(abs(ri), abs(ii))), max(abs(rj), abs(ij)));
    }
  }
  __syncwarp();
  return scale;
}

// The alpha-max-plus-beta-min magnitude of AECM_WITH_ABS_APPROX
// (fused.py:910-921); the uint16 sum wraps.
__device__ __forceinline__ int abs_approx_mag(int ar, int am) {
  const int mx = max(ar, am), mn = min(ar, am);
  int alpha = 26951, beta = 18927;
  if ((mx >> 2) > mn) {
    alpha = 32584;
    beta = 4249;
  } else if ((mx >> 1) > mn) {
    alpha = 30879;
    beta = 11072;
  }
  return ((to_w16((mx * alpha) >> 15) & 0xFFFF) +
          (to_w16((mn * beta) >> 15) & 0xFFFF)) & 0xFFFF;
}

// core.time_to_frequency_domain of N signals at once.  xv[t][j] is input
// sample lane + 32 j of signal t's 128; transform t is left in its O_FR /
// O_FI, mag[t][j] is the magnitude of bin lane + 32 j (j < 3, bins above 64
// give 0), sum[t] the sum of the magnitudes.
template <int N>
__device__ void _time_to_frequency_domain_f(const Ctx& c, const int (*xv)[4],
                                            int (*mag)[3], int* scaling,
                                            uint32_t* sum) {
#pragma unroll
  for (int t = 0; t < N; ++t) {
    int max_abs = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) max_abs = max(max_abs, abs(xv[t][j]));
    max_abs = min(warp_max(max_abs), WORD16_MAX);
    scaling[t] = norm_w16(max_abs);
  }
  __syncwarp();   // earlier readers of O_FR / O_FI are done
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int idx = c.lane + 32 * j;
    const int pos = bitrev7(idx);
    const int win = c.win[idx];
#pragma unroll
    for (int t = 0; t < N; ++t) {
      const int scaled = to_w16(shl_i32(xv[t][j], scaling[t]));
      c.S[fft_re(t) + pos] = to_w16((scaled * win) >> 14);
      c.S[fft_re(t) + 128 + pos] = 0;
    }
  }
  _complex_fft_128<N>(c);
#pragma unroll
  for (int t = 0; t < N; ++t) {
    const int* fr = c.S + fft_re(t);
    const int* fi = fr + 128;
    uint32_t part = 0;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int i = c.lane + 32 * j;
      int v = 0;
      if (i < PART_LEN1) {
        const int r = fr[i];
        const int m = (i == 0 || i == PART_LEN) ? 0 : to_w16(-fi[i]);
        const int ar = abs(r), am = abs(m);
        if (i == 0 || i == PART_LEN) {
          v = ar;
        } else if (r == 0) {
          v = am;
        } else if (m == 0) {
          v = ar;
        } else if (c.in.abs_approx) {
          v = abs_approx_mag(ar, am);
        } else {
          v = sqrt_floor(add_sat_w32(ar * ar, am * am));
        }
      }
      mag[t][j] = v;
      part += (uint32_t)v;
    }
    sum[t] = warp_sum(part);
  }
}

// ---------------------------------------------------------------------------
// Delay estimator (fused.py _binary_spectrum_fix_f ... _process_fix_f)
// ---------------------------------------------------------------------------

// Lane l takes bin 12 + l; `spectrum` is a 65-bin array in shared memory,
// `mean` the staged rows 12..43 of the mean spectrum.
__device__ uint32_t _binary_spectrum_fix_f(const Ctx& c, const int* spectrum,
                                           int* mean, int& initialized,
                                           int q_domain) {
  const int shift = 15 - q_domain;
  const int sp = spectrum[MEAN_LO + c.lane];
  int m = mean[c.lane];
  if (initialized == 0) {
    if (sp > 0) m = ((int)((uint32_t)sp << shift)) >> 1;
    if (__any_sync(FULL, sp > 0)) initialized = 1;
  }
  const int q15 = (int)((uint32_t)sp << shift);
  m = mean_estimator_fix(q15, 6, m);
  mean[c.lane] = m;
  return __ballot_sync(FULL, q15 > m);
}

__device__ __forceinline__ bool in_range(int idx, int n) {
  return idx >= 0 && idx < n;
}

// delay_estimator.process_binary_spectrum; returns the new last_delay.
// Row r of the far-end histories (and of the near binary history, in the
// general instances) stands at word `base + r` of its region.  The history
// size is c.g.H: 100 in the main path's instances, where the four passes
// of 32 lanes unroll.
template <bool GEN>
__device__ int _process_binary_spectrum_f(const Ctx& c, Scal& sc,
                                          uint32_t bits, int base) {
  int* S = c.S;
  const Geo& g = c.g;
  if (GEN) {
    // the near binary history shifts in this block's bits; the row at the
    // stream's lookahead, clamped to the capacity, is compared
    if (c.lane == 0) S[g.ne_bh + base] = (int)bits;
    __syncwarp();
    bits = (uint32_t)S[g.ne_bh + base + min(max(c.lookahead, 0), g.cap - 1)];
  } else {
    sc.ne_binary_history = (int)bits;
  }
  int best = 0x7FFFFFFF, best_r = 0x7FFFFFFF, worst = (int)0x80000000;
  bool stirred = false;
  const int passes = (g.H + 31) / 32;
#pragma unroll 4
  for (int j = 0; j < passes; ++j) {
    const int r = c.lane + 32 * j;
    if (r < g.H) {
      const int bc = __popc(bits ^ (uint32_t)S[g.fe_hist + base + r]);
      S[g.ne_bc + r] = bc;
      const int fbc = S[g.fe_bc + base + r];
      int mean = S[g.ne_mbc + r];
      if (fbc > 0) {
        const int shifts = 13 - ((3 * fbc) >> 4);
        mean = mean_estimator_fix(bc << 9, shifts, mean);
        S[g.ne_mbc + r] = mean;
        stirred = true;
      }
      if (mean < best) {   // ascending r: the lane's lowest index wins
        best = mean;
        best_r = r;
      }
      worst = max(worst, mean);
    }
  }
  // the lowest index among equal minima, over the warp
  int value_best = warp_min(best);
  int candidate = warp_min(best == value_best ? best_r : 0x7FFFFFFF);
  int value_worst = warp_max(worst);
  const bool non_stationary = __any_sync(FULL, stirred);
  __syncwarp();   // mean_bit_counts rows are read by index below
  constexpr int MAX_BITCOUNTS_Q9 = 32 << 9;
  if (!(value_best < MAX_BITCOUNTS_Q9)) candidate = -1;
  value_best = min(value_best, MAX_BITCOUNTS_Q9);
  value_worst = max(value_worst, 0);
  const int valley_depth = value_worst - value_best;

  const int threshold = max(value_best + 1024, 8704);
  if (sc.minimum_probability > 8704 && valley_depth > 2816 &&
      sc.minimum_probability > threshold) {
    sc.minimum_probability = threshold;
  }
  const int last_delay_probability = sc.last_delay_probability + 1;
  sc.last_delay_probability = last_delay_probability;
  bool valid_candidate = valley_depth > 1024 &&
                         (value_best < sc.minimum_probability ||
                          value_best < last_delay_probability);

  // --- UpdateRobustValidationStatistics (non-stationary far end only) ---
  const int last_delay = sc.last_delay;
  const int compare_delay = sc.compare_delay;
  const float valley_f = (float)valley_depth * Q14_SCALING;
  float* hist = (float*)(S + g.ne_hist);
  if (non_stationary) {
    const int max_hits = candidate < last_delay ? 10 : 1000;
    const int cand_hits =
        (candidate != sc.last_candidate_delay ? 0 : sc.candidate_hits) + 1;
    float dls = valley_f;
    if (cand_hits < max_hits) {
      const int sel = in_range(compare_delay, g.H + 1)
                          ? S[g.ne_mbc + compare_delay]
                          : 0;
      dls = (float)(sel - value_best) * Q14_SCALING;
    }
    const int hist_passes = (g.H + 1 + 31) / 32;
#pragma unroll 4
    for (int j = 0; j < hist_passes; ++j) {
      const int i = c.lane + 32 * j;
      if (i <= g.H) {
        float h = hist[i];
        if (i == candidate) h = fminf(h + valley_f, 3000.0f);
        if (i < g.H) {
          const bool in_last = i >= last_delay - 2 && i <= last_delay + 1 &&
                               i != candidate;
          const bool in_cand = i >= candidate - 2 && i <= candidate + 1;
          const float dec = dls * (in_last ? 1.0f : 0.0f) +
                            valley_f * ((!in_last && !in_cand) ? 1.0f : 0.0f);
          h = fmaxf(h - dec, 0.0f);
        }
        hist[i] = h;
      }
    }
    sc.candidate_hits = cand_hits;
    sc.last_candidate_delay = candidate;
    __syncwarp();   // histogram entries are read by index below
  }

  // --- histogram-based + robust validation (runtime toggle) ---
  const float hist_cand =
      in_range(candidate, g.H + 1) ? hist[candidate] : 0.0f;
  const float delay_difference = (float)(candidate - last_delay);
  const float allowed = (float)sc.allowed_offset;
  float fraction = 1.0f;
  if (delay_difference > allowed) {
    fraction = fmaxf(1.0f - 0.05f * (delay_difference - allowed), 0.5f);
  } else if (delay_difference < 0.0f) {
    fraction = fminf(0.25f - 0.05f * delay_difference, 1.0f);
  }
  const float hist_compare = in_range(compare_delay, g.H + 1)
                                 ? hist[compare_delay]
                                 : 0.0f;
  const float h_threshold = fmaxf(hist_compare * fraction, 1.5f);
  const bool is_histogram_valid =
      hist_cand >= h_threshold && sc.candidate_hits > 10;
  const float last_delay_histogram = __int_as_float(sc.last_delay_histogram);
  bool is_robust = last_delay < 0 && (valid_candidate || is_histogram_valid);
  is_robust = is_robust || (valid_candidate && is_histogram_valid);
  is_robust = is_robust ||
              (is_histogram_valid && hist_cand > last_delay_histogram);
  if (sc.robust_validation_enabled != 0) valid_candidate = is_robust;

  const bool do_update = non_stationary && valid_candidate;
  const bool changed = do_update && candidate != last_delay;
  __syncwarp();   // every lane has read the histogram before it is patched
  if (changed) {
    sc.last_delay_histogram = __float_as_int(fminf(hist_cand, 250.0f));
    if (in_range(compare_delay, g.H + 1) && hist_cand < hist_compare &&
        c.lane == 0) {
      hist[compare_delay] = hist_cand;
    }
  }
  if (do_update) {
    sc.last_delay = candidate;
    if (value_best < last_delay_probability) {
      sc.last_delay_probability = value_best;
    }
    sc.compare_delay = candidate;
  }
  return sc.last_delay;
}

// ---------------------------------------------------------------------------
// Core block stages (fused.py _calc_energies_f ... _inverse_fft_and_window_f)
// A lane's bins are lane + 32 j, j < 3; arrays of 3 hold them.
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

// The newest rows of the three log-energy histories, kept in registers
// through a block (row 0 of each after this block's shift).
struct Energies {
  int near, echo_adapt, echo_stored;
};

// core.calc_energies; fills echo_est and the new history rows (also
// written at word `base` of the three sliding histories).
__device__ Energies _calc_energies_f(const Ctx& c, Scal& sc,
                                     const int* far_spectrum, int far_q,
                                     uint32_t near_ener, int* echo_est,
                                     int base) {
  int* S = c.S;
  Energies e;
  e.near = log_of_energy_in_q8(near_ener, sc.dfa_noisy_q);
  uint32_t tmp_far = 0, tmp_adapt = 0, tmp_stored = 0;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int i = c.lane + 32 * j;
    echo_est[j] = 0;
    if (i < PART_LEN1) {
      echo_est[j] = wmul(S[O_CH_STORED + i], far_spectrum[j]);
      tmp_far += (uint32_t)far_spectrum[j];
      tmp_adapt += (uint32_t)wmul(S[O_CH16 + i], far_spectrum[j]);
      tmp_stored += (uint32_t)echo_est[j];
    }
  }
  tmp_far = warp_sum(tmp_far);
  tmp_adapt = warp_sum(tmp_adapt);
  tmp_stored = warp_sum(tmp_stored);
  const int far_log_energy = log_of_energy_in_q8(tmp_far, far_q);
  sc.far_log_energy = far_log_energy;
  e.echo_adapt = log_of_energy_in_q8(tmp_adapt, 12 + far_q);
  e.echo_stored = log_of_energy_in_q8(tmp_stored, 12 + far_q);

  const bool in_startup = sc.startup_state == 0;
  const int increase_max_shifts = in_startup ? 2 : 4;
  const int increase_min_shifts = in_startup ? 8 : 11;
  const int decrease_min_shifts = in_startup ? 2 : 3;

  const bool active = far_log_energy > 1025;
  if (active) {
    sc.far_energy_min = asym_filt(sc.far_energy_min, far_log_energy,
                                  increase_min_shifts, decrease_min_shifts);
    sc.far_energy_max = asym_filt(sc.far_energy_max, far_log_energy,
                                  increase_max_shifts, 11);
    sc.far_energy_max_min = sc.far_energy_max - sc.far_energy_min;
  }
  const int fe_min = sc.far_energy_min;

  int tmp16 = to_w16(2560 - fe_min);
  tmp16 = tmp16 > 0 ? to_w16((tmp16 * 230) >> 9) : 0;
  tmp16 = to_w16(tmp16 + 230);

  const int fe_vad_old = sc.far_energy_vad;
  const int vad_count = sc.vad_update_count;
  const bool vad_halted = in_startup || vad_count > 1024;
  const bool track = fe_vad_old > far_log_energy;
  int fe_vad = fe_vad_old;
  if (active) {
    fe_vad = vad_halted
                 ? fe_min + tmp16
                 : (track ? fe_vad_old +
                                ((far_log_energy + tmp16 - fe_vad_old) >> 6)
                          : fe_vad_old);
    if (!vad_halted) sc.vad_update_count = track ? 0 : to_w16(vad_count + 1);
    sc.far_energy_mse = fe_vad + (1 << 8);
  }
  sc.far_energy_vad = fe_vad;

  const bool above = far_log_energy > fe_vad;
  const bool dynamic = in_startup || sc.far_energy_max_min > 929;
  const int vad = above ? (dynamic ? 1 : sc.current_vad_value) : 0;
  sc.current_vad_value = vad;

  const bool first_fire = vad != 0 && sc.first_vad != 0;
  const bool too_hot = e.echo_adapt > e.near;
  if (first_fire && too_hot) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int i = c.lane + 32 * j;
      if (i < PART_LEN1) S[O_CH16 + i] = S[O_CH16 + i] >> 3;
    }
    e.echo_adapt -= 3 << 8;
  }
  if (first_fire && !too_hot) sc.first_vad = 0;
  if (c.lane == 0) {
    S[O_NLE + base] = e.near;
    S[O_EALE + base] = e.echo_adapt;
    S[O_ESLE + base] = e.echo_stored;
  }
  __syncwarp();   // the store/restore arbitration reads rows 0..19
  return e;
}

// core.calc_step_size.
__device__ int _calc_step_size_f(const Scal& sc) {
  const int fe_min = sc.far_energy_min;
  const int tmp32 = wmul(sc.far_log_energy - fe_min, 9);
  const int ratio = to_w16(div_w32_w16(tmp32, sc.far_energy_max_min));
  int mu = max(9 - ratio, 1);
  if (fe_min >= sc.far_energy_max) mu = 10;
  if (!(sc.startup_state > 0)) mu = 1;
  return sc.current_vad_value == 0 ? 0 : mu;
}

// core.update_channel (NLMS + store/restore); may rewrite echo_est.  dfa is
// the 65-bin near magnitude in shared memory.
__device__ void _update_channel_f(const Ctx& c, Scal& sc,
                                  const int* far_spectrum, int far_q,
                                  const int* dfa, int mu, int* echo_est,
                                  int base) {
  int* S = c.S;
  const int dfa_noisy_q = sc.dfa_noisy_q;
#pragma unroll
  for (int jb = 0; jb < 3; ++jb) {
    const int i = c.lane + 32 * jb;
    if (i >= PART_LEN1 || mu == 0) continue;
    const int ch32 = S[O_CH32 + i];
    const int far = far_spectrum[jb];
    const int dfa_i = dfa[i];
    const int zeros_ch = norm_u32((uint32_t)ch32);
    const int zeros_far = norm_u32((uint32_t)far);
    const bool safe_mul = zeros_ch + zeros_far > 31;
    const int shift_ch_far = safe_mul ? 0 : 32 - zeros_ch - zeros_far;
    const uint32_t prod_safe = (uint32_t)ch32 * (uint32_t)far;
    const int shifted_ch = shift_ch_far >= 32 ? 0 : sar_i32(ch32, shift_ch_far);
    const uint32_t prod_shifted = (uint32_t)shifted_ch * (uint32_t)far;
    uint32_t tmp_u32_no1 = safe_mul ? prod_safe : prod_shifted;

    int zeros_num = norm_u32(tmp_u32_no1);
    const int zeros_dfa = dfa_i != 0 ? norm_u32((uint32_t)dfa_i) : 32;
    const int tmp16_no1 =
        zeros_dfa - 2 + dfa_noisy_q - 28 - far_q + shift_ch_far;
    const bool use_dfa_domain = zeros_num > tmp16_no1 + 1;
    const int xfa_q = use_dfa_domain ? tmp16_no1 : zeros_num - 2;
    const int dfa_q = use_dfa_domain
                          ? zeros_dfa - 2
                          : 28 + far_q - dfa_noisy_q - shift_ch_far +
                                (zeros_num - 2);
    tmp_u32_no1 = shift_w32_u(tmp_u32_no1, xfa_q);
    const uint32_t tmp_u32_no2 = shift_w32_u((uint32_t)dfa_i, dfa_q);
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
    if (do_update) {
      const int new_ch32 = max(add_sat_w32(ch32, tmp32_no2), 0);
      S[O_CH32 + i] = new_ch32;
      S[O_CH16 + i] = new_ch32 >> 16;
    }
  }

  // --- store/restore arbitration ---
  const bool startup_store =
      sc.startup_state == 0 && sc.current_vad_value != 0;
  const int mse_channel_count =
      sc.far_log_energy < sc.far_energy_mse ? 0 : sc.mse_channel_count + 1;
  const bool evaluate = mse_channel_count >= 20 + 10;
  uint32_t sum_stored = 0, sum_adapt = 0;
  if (c.lane < 20) {
    const int nle = S[O_NLE + base + c.lane];
    sum_stored = (uint32_t)abs(S[O_ESLE + base + c.lane] - nle);
    sum_adapt = (uint32_t)abs(S[O_EALE + base + c.lane] - nle);
  }
  const int mse_stored = (int)warp_sum(sum_stored);
  const int mse_adapt = (int)warp_sum(sum_adapt);
  const int mse_stored_old = sc.mse_stored_old;
  const int mse_adapt_old = sc.mse_adapt_old;
  const int mse_threshold = sc.mse_threshold;
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
    sc.mse_threshold = mse_threshold == WORD32_MAX
                           ? wadd(mse_adapt, mse_adapt_old)
                           : bumped;
  }
  const bool store_now = startup_store || do_store;
  const bool reset_now = !startup_store && do_reset;
  if (store_now || reset_now) {
#pragma unroll
    for (int jb = 0; jb < 3; ++jb) {
      const int i = c.lane + 32 * jb;
      if (i >= PART_LEN1) continue;
      if (store_now) {
        const int ch16 = S[O_CH16 + i];
        S[O_CH_STORED + i] = ch16;
        echo_est[jb] = wmul(ch16, far_spectrum[jb]);
      } else {
        const int stored = S[O_CH_STORED + i];
        S[O_CH16 + i] = stored;
        S[O_CH32 + i] = shl_i32(stored, 16);
      }
    }
  }
  if (!startup_store) {
    sc.mse_channel_count = evaluate ? 0 : mse_channel_count;
    if (evaluate) {
      sc.mse_stored_old = mse_stored;
      sc.mse_adapt_old = mse_adapt;
    }
  }
}

// core.calc_suppression_gain; returns the new sup_gain.
__device__ int _calc_suppression_gain_f(Scal& sc, const Energies& e) {
  const int tmp16 = e.near - e.echo_stored;
  const int d_e = to_w16(abs(to_w16(tmp16)));
  int sup;
  if (d_e < 400) {
    if (d_e < 200) {
      sup = sc.sup_gain_err_param_a -
            to_w16(div_w32_w16(
                wadd(wmul(sc.sup_gain_err_param_diff_ab, d_e), 100), 200));
    } else {
      sup = sc.sup_gain_err_param_d +
            to_w16(div_w32_w16(
                wadd(wmul(sc.sup_gain_err_param_diff_bd, 400 - d_e), 100),
                200));
    }
  } else {
    sup = sc.sup_gain_err_param_d;
  }
  if (sc.current_vad_value == 0) sup = 0;
  const int old = sc.sup_gain;
  const int target = max(sup, sc.sup_gain_old);
  const int new_sup = to_w16(old + to_w16((target - old) >> 4));
  sc.sup_gain = new_sup;
  sc.sup_gain_old = sup;
  return new_sup;
}

// core.comfort_noise for bin i: updates the noise estimate and adds the
// noise to (re, im); lam is the bin's final hnl, p its packed phase.
__device__ void _comfort_noise_f(const Ctx& c, int i, int dfa_i, int lam,
                                 int p, int shift_noise, int min_track_shift,
                                 int& re, int& im) {
  int* S = c.S;
  int noise = S[O_NOISE + i];
  int too_low = S[O_TOO_LOW + i];
  int too_high = S[O_TOO_HIGH + i];
  const int out_lshift = shl_i32(dfa_i, shift_noise);
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
  S[O_NOISE + i] = noise;
  S[O_TOO_LOW + i] = too_low;
  S[O_TOO_HIGH + i] = too_high;
  const int amp = to_w16(wmul(ONE_Q14 - lam, to_w16(tmp32)) >> 14);
  // bin i >= 1 draws phase row i - 1; bin 0 and the imaginary part of
  // bin 64 get no noise
  if (i >= 1) {
    const int cos_v = to_w16(p), sin_v = p >> 16;
    re = add_sat_w16(re, to_w16(wmul(amp, cos_v) >> 13));
    if (i < PART_LEN) {
      im = add_sat_w16(im, to_w16(wmul(wneg(amp), sin_v) >> 13));
    }
  }
}

// core.inverse_fft_and_window on this lane's bins of efw: writes the 64
// output samples to ring entry `s` of O_OUTS and the overlap to O_OUT_BUF.
__device__ void _inverse_fft_and_window_f(const Ctx& c, const Scal& sc,
                                          const int* efw_re,
                                          const int* efw_im, int s) {
  int* S = c.S;
  int* fr = S + O_FR;
  int* fi = S + O_FI;
  __syncwarp();   // every lane has taken its dfw bins out of O_FR / O_FI
  // Hermitian extension in bit-reversed order: bin i goes to bitrev7(i)
  // and, for 0 < i < 64, its conjugate to bitrev7(128 - i)
  int maxabs = 0;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int i = c.lane + 32 * j;
    if (i >= PART_LEN1) continue;
    const int re = efw_re[j];
    const int im = to_w16(-efw_im[j]);
    const int p = bitrev7(i);
    fr[p] = re;
    fi[p] = im;
    maxabs = max(maxabs, max(abs(re), abs(im)));
    if (i > 0 && i < PART_LEN) {
      const int q = bitrev7(128 - i);
      const int imc = to_w16(-im);
      fr[q] = re;
      fi[q] = imc;
      maxabs = max(maxabs, abs(imc));
    }
  }
  const int scale = _complex_ifft_128(c, maxabs);
  const int shift = scale - sc.dfa_clean_q;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = c.lane + 32 * j;
    const int first = to_w16((fr[i] * c.win[i] + 8192) >> 14);
    S[O_OUTS + s * PART_LEN + i] =
        sat_w16(wadd(shift_w32(first, shift), S[O_OUT_BUF + i]));
    const int second = (fr[PART_LEN + i] * c.win[PART_LEN + i]) >> 14;
    S[O_OUT_BUF + i] = sat_w16(shift_w32(second, shift));
  }
}

// ---------------------------------------------------------------------------
// The block and the step (fused.py _process_block_f, frames_step)
// ---------------------------------------------------------------------------

// Sample i of the step's input stream (carry + active payload placed at
// the carry fill, zeros after): fused.py frames_step's `stream`, for a
// step of n frames.
__device__ __forceinline__ int stream_sample(const Ctx& c, int carry_off,
                                             const int* payload, int fill0,
                                             int k, int n, int i) {
  const int sel = fill0 >> 4;
  if (sel < 0 || sel > 3) return 0;
  const int f = 16 * sel;
  if (i < f) return c.S[carry_off + i];
  const int j = i - f;
  if (j >= n * FRAME_LEN) return 0;
  // _suffix_frames: the last k frames front-aligned (k a multiple of fpc)
  if (k <= 0 || k > n || k % c.in.fpc != 0) return 0;
  if (j >= k * FRAME_LEN) return 0;
  return payload[(size_t)((n - k) * FRAME_LEN + j) * c.in.B + c.b];
}

// Pack the 65-bin block in O_XFA into the 40 rows of ring entry `ring` of
// O_PEND (slot s); the general instances also write it to slot s of
// pend_hist / pend_q.
template <bool GEN>
__device__ void _push_far_pending(const Ctx& c, int s, int ring, int far_q) {
  int* S = c.S;
  const size_t B = (size_t)c.in.B;
  __syncwarp();   // O_XFA is complete
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = c.lane + 32 * j;
    if (r < FAR_HIST_ROWS) {
      const uint32_t lo = (uint32_t)S[O_XFA + r];
      const uint32_t hi = r + FAR_HIST_ROWS < PART_LEN1
                              ? (uint32_t)S[O_XFA + r + FAR_HIST_ROWS]
                              : 0u;
      S[O_PEND + ring * FAR_HIST_ROWS + r] = (int)(lo | (hi << 16));
      if (GEN) {
        c.in.pend_hist[(size_t)(s * FAR_HIST_ROWS + r) * B + c.b] =
            (int)(lo | (hi << 16));
      }
    }
  }
  if (c.lane == 0) {
    S[O_PEND_Q + ring] = far_q;
    if (GEN) c.in.pend_q[(size_t)s * B + c.b] = far_q;
  }
  __syncwarp();   // the aligned fetch may read this block back
}

// CNG draw k of the step (fused.py _precompute_cng_phases): the seed
// advanced k + 1 times by WebRtcSpl_RandU's LCG, (A seed + C) mod 2^31 with
// A, C the closure's entry k.  Exact in 32-bit wrap-around arithmetic,
// because 2^31 divides 2^32.
__device__ __forceinline__ uint32_t cng_seed(const Ctx& c, int k) {
  const uint32_t a = (uint32_t)__ldg(c.in.lcg_a + k);
  return (a * c.seed + (uint32_t)__ldg(c.in.lcg_c + k)) & 0x7FFFFFFFu;
}

// Slot s's input samples and phases, as its lanes use them: far and near
// sample lane + 32 j of the slot (j < 2), the phase of bin lane + 32 j
// (j < 3), drawn here if the slot is active (bin i >= 1 of slot s takes
// draw 64 s + i - 1) and packed: Q13 cos in the low 16 bits, sin high.  Fetched one slot ahead, so that the loads from
// global memory are in flight behind the slot before.
struct SlotIn {
  int far[2], near[2], clean[2], phase[3];
  // the aligned far block, fetched on the guess that the slot's delay will
  // be the one the estimator holds now: the packed history word of bin
  // lane + 32 j, the block's Q domain, and the guessed delay (-1: the
  // guess does not point into the circular history)
  int hist[3], hist_q, hist_delay;
};

// Where delay `delay` of slot s lies in the far history (circular, or
// newest-first): the block's index there, or -1 if it is one of the step's
// pending blocks or out of range.
template <bool CIRC>
__device__ __forceinline__ int history_block(const Ctx& c, int s, int delay) {
  const int idx_old = delay - (s + 1);
  if (delay >= MAX_DELAY || idx_old < 0) return -1;
  if (!CIRC) return idx_old;
  const int tgt = c.head + (MAX_DELAY - 1) - idx_old;
  return tgt >= MAX_DELAY ? tgt - MAX_DELAY : tgt;
}

// The packed words of this lane's bins of block `tgt` of the far
// history (bin i < 40 is the low half of row i, bin i >= 40 the high half
// of row i - 40), and the block's Q domain.
__device__ __forceinline__ void fetch_history(const Ctx& c, int tgt,
                                              int* words, int* far_q) {
  const size_t B = (size_t)c.in.B;
  const int* rows =
      (const int*)c.lv.p[FAR_HISTORY] + (size_t)(tgt * FAR_HIST_ROWS) * B + c.b;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int i = c.lane + 32 * j;
    const int row = i >= FAR_HIST_ROWS ? i - FAR_HIST_ROWS : i;
    words[j] = i < PART_LEN1 ? rows[(size_t)row * B] : 0;
  }
  *far_q = ((const int*)c.lv.p[FAR_Q_DOMAINS])[(size_t)tgt * B + c.b];
}

template <bool CLEAN, bool CIRC>
__device__ __forceinline__ SlotIn fetch_slot(const Ctx& c, const Scal& sc,
                                             int s, int fill0, int k, int n) {
  SlotIn x;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = s * PART_LEN + c.lane + 32 * j;
    x.far[j] = stream_sample(c, O_CARRY_FAR, c.in.far, fill0, k, n, i);
    x.near[j] = stream_sample(c, O_CARRY_NOISY, c.in.noisy, fill0, k, n, i);
    x.clean[j] = CLEAN ? stream_sample(c, O_CARRY_CLEAN, c.in.clean, fill0,
                                       k, n, i)
                       : 0;
  }
  const bool draw =
      sc.cng_mode != 0 && fill0 + FRAME_LEN * k >= PART_LEN * (s + 1);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int i = c.lane + 32 * j;
    x.phase[j] = 0;
    if (draw && i >= 1 && i < PART_LEN1) {
      const uint32_t seed = cng_seed(c, s * PART_LEN + i - 1);
      const int idx = (359 * (int)(seed >> 16)) >> 15;
      x.phase[j] = (int)(((uint32_t)__ldg(c.in.sin360 + idx) << 16) |
                         ((uint32_t)__ldg(c.in.cos360 + idx) & 0xFFFFu));
    }
  }
  int guess = sc.fixed_delay >= 0 ? sc.fixed_delay : sc.last_delay;
  if (guess == -2) guess = 0;
  const int tgt = history_block<CIRC>(c, s, guess);
  x.hist_delay = tgt >= 0 ? guess : -1;
  x.hist_q = 0;
  x.hist[0] = x.hist[1] = x.hist[2] = 0;
  if (tgt >= 0) fetch_history(c, tgt, x.hist, &x.hist_q);
  return x;
}

// AlignedFarend against the deferred view (slot s has s pending
// predecessors plus its own block): fills this lane's bins of far_spec,
// returns the block's Q domain.  A pending block is in the O_PEND ring if
// it is one of the last N_SLOTS, else (general instances) in pend_hist; a
// block of the history comes from the slot's early fetch if the delay is
// the one it guessed.
template <bool CIRC, bool GEN>
__device__ int _aligned_farend_deferred(const Ctx& c, int s, int delay,
                                        const SlotIn& x, int* far_spec) {
  int words[3] = {0, 0, 0};
  int far_q = 0;
  if (delay >= 0 && delay <= s) {
    const int p = s - delay;
    if (!GEN || delay < N_SLOTS) {
      const int ring = GEN ? p % N_SLOTS : p;
      const int* rows = c.S + O_PEND + ring * FAR_HIST_ROWS;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int i = c.lane + 32 * j;
        const int row = i >= FAR_HIST_ROWS ? i - FAR_HIST_ROWS : i;
        words[j] = i < PART_LEN1 ? rows[row] : 0;
      }
      far_q = c.S[O_PEND_Q + ring];
    } else {
      const size_t B = (size_t)c.in.B;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int i = c.lane + 32 * j;
        const int row = i >= FAR_HIST_ROWS ? i - FAR_HIST_ROWS : i;
        words[j] = i < PART_LEN1
                       ? c.in.pend_hist[(size_t)(p * FAR_HIST_ROWS + row) * B +
                                        c.b]
                       : 0;
      }
      far_q = c.in.pend_q[(size_t)p * B + c.b];
    }
  } else if (delay == x.hist_delay) {
#pragma unroll
    for (int j = 0; j < 3; ++j) words[j] = x.hist[j];
    far_q = x.hist_q;
  } else {
    const int tgt = history_block<CIRC>(c, s, delay);
    if (tgt >= 0) fetch_history(c, tgt, words, &far_q);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const uint32_t v = (uint32_t)words[j];
    far_spec[j] = (int)(c.lane + 32 * j >= FAR_HIST_ROWS ? v >> 16
                                                         : v & 0xFFFFu);
  }
  return far_q;
}

// An inactive slot: no output.  In the circular mode its pending entry
// is an output too, the analysis of the committed x_buf[:64] followed by
// the slot's stream samples (the plain version computes and discards the
// whole block; only this part of it is visible in the outputs); the
// newest-first merge never takes it.
template <bool CIRC, bool GEN>
__device__ void _inactive_slot(const Ctx& c, int s, int ring,
                               const SlotIn& x) {
  int* S = c.S;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    S[O_OUTS + ring * PART_LEN + c.lane + 32 * j] = 0;
  }
  if (!CIRC) return;
  int xv[1][4], mag[1][3], far_q;
  uint32_t sum;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = c.lane + 32 * j;
    xv[0][j] = S[O_X_BUF + i];
    xv[0][2 + j] = x.far[j];
  }
  _time_to_frequency_domain_f<1>(c, xv, mag, &far_q, &sum);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int i = c.lane + 32 * j;
    if (i < PART_LEN1) S[O_XFA + i] = mag[0][j];
  }
  _push_far_pending<GEN>(c, s, ring, far_q);
}

// core.process_block for slot s (an active slot; the s-th active one),
// whose outputs and pending block go to ring entry `ring`; the sliding
// histories' new row 0 is at word `base` of their regions.
template <bool CLEAN, bool CIRC, bool GEN>
__device__ void _process_block_f(const Ctx& c, Scal& sc, int s, int ring,
                                 int base, const SlotIn& x) {
  int* S = c.S;
  const int lane = c.lane;
  if (sc.startup_state < 2) {
    const int tc = sc.tot_count;
    sc.startup_state = (tc >= 512) + (tc >= 1024);
  }
  // Signal 0 is the one the Wiener stage filters, whose transform stays in
  // O_FR / O_FI: the near end, or the clean near end when there is one.
  // Signal 1 is the far end, signal 2 (clean input only) the noisy near end.
  constexpr int N = CLEAN ? 3 : 2;
  constexpr int T_NOISY = CLEAN ? 2 : 0;
  constexpr int O_D_WIENER = CLEAN ? O_D_BUF_CLEAN : O_D_BUF;
  constexpr int O_DFA_WIENER = CLEAN ? O_DFA_CLEAN : O_DFA;  // ptr_dfa_clean
  int xv[N][4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    xv[0][2 + j] = CLEAN ? x.clean[j] : x.near[j];
    xv[1][2 + j] = x.far[j];
    if (CLEAN) xv[T_NOISY][2 + j] = x.near[j];
  }
  // x_buf / d_buf_noisy / d_buf_clean: [previous block, this block]; both
  // halves are left holding this block, as the shift at the end of a block
  // leaves them
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = lane + 32 * j;
    xv[0][j] = S[O_D_WIENER + i];
    xv[1][j] = S[O_X_BUF + i];
    if (CLEAN) xv[T_NOISY][j] = S[O_D_BUF + i];
    S[O_D_WIENER + i] = xv[0][2 + j];
    S[O_D_WIENER + PART_LEN + i] = xv[0][2 + j];
    S[O_X_BUF + i] = xv[1][2 + j];
    S[O_X_BUF + PART_LEN + i] = xv[1][2 + j];
    if (CLEAN) {
      S[O_D_BUF + i] = xv[T_NOISY][2 + j];
      S[O_D_BUF + PART_LEN + i] = xv[T_NOISY][2 + j];
    }
  }
  int mag[N][3], scaling[N];
  uint32_t sums[N];
  _time_to_frequency_domain_f<N>(c, xv, mag, scaling, sums);
  const int zeros_d = scaling[T_NOISY], far_q = scaling[1];
  const uint32_t dfa_sum = sums[T_NOISY];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int i = lane + 32 * j;
    if (i < PART_LEN1) {
      S[O_DFA + i] = mag[T_NOISY][j];
      S[O_XFA + i] = mag[1][j];
      if (CLEAN) S[O_DFA_CLEAN + i] = mag[0][j];
    }
  }
  const int dfa_noisy_q_prev = sc.dfa_noisy_q;
  sc.dfa_noisy_q_old = dfa_noisy_q_prev;
  sc.dfa_noisy_q = zeros_d;
  if (CLEAN) {
    // the clean Q history is its own (fused.py:1070-1071)
    sc.dfa_clean_q_old = sc.dfa_clean_q;
    sc.dfa_clean_q = scaling[0];
  } else {
    sc.dfa_clean_q_old = dfa_noisy_q_prev;
    sc.dfa_clean_q = zeros_d;
  }

  _push_far_pending<GEN>(c, s, ring, far_q);   // also orders O_XFA / O_DFA
  // _add_far_spectrum_fix_f: the new row 0 of the far-end histories
  const uint32_t far_bits = _binary_spectrum_fix_f(
      c, S + O_XFA, S + O_FE_MEAN, sc.fe_spectrum_initialized, far_q);
  if (lane == 0) {
    S[c.g.fe_hist + base] = (int)far_bits;
    S[c.g.fe_bc + base] = __popc(far_bits);
  }
  const uint32_t near_bits = _binary_spectrum_fix_f(
      c, S + O_DFA, S + O_NE_MEAN, sc.ne_spectrum_initialized, zeros_d);
  __syncwarp();   // row 0 is visible to the search
  int delay = _process_binary_spectrum_f<GEN>(c, sc, near_bits, base);
  if (delay == -2) delay = 0;
  if (sc.fixed_delay >= 0) delay = sc.fixed_delay;

  int far_spec[3], echo_est[3], hnl[3];
  const int zeros_x_buf =
      _aligned_farend_deferred<CIRC, GEN>(c, s, delay, x, far_spec);
  const Energies e = _calc_energies_f(c, sc, far_spec, zeros_x_buf, dfa_sum,
                                      echo_est, base);
  const int mu = _calc_step_size_f(sc);
  sc.tot_count = sc.tot_count + 1;
  _update_channel_f(c, sc, far_spec, zeros_x_buf, S + O_DFA, mu, echo_est,
                    base);
  const int sup_gain = _calc_suppression_gain_f(sc, e);

  // --- Wiener filter hnl ---
  const int zeros16 = norm_w16(sup_gain) + 1;
  const int dfa_clean_q = sc.dfa_clean_q;
  const int dq_diff = dfa_clean_q - sc.dfa_clean_q_old;
  int num_pos_coef = 0;
#pragma unroll
  for (int jb = 0; jb < 3; ++jb) {
    const int i = lane + 32 * jb;
    hnl[jb] = 0;
    if (i >= PART_LEN1) continue;
    const int dfa_i = S[O_DFA_WIENER + i];
    const int ef_old = S[O_ECHO_FILT + i];
    const int echo_filt = wadd(
        ef_old, mul_i64_shift_right(wsub(echo_est[jb], ef_old), 50, 8));
    S[O_ECHO_FILT + i] = echo_filt;

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

    const int nf = S[O_NEAR_FILT + i];
    const int zeros16n = norm_w16(nf);
    const bool cramped = zeros16n < dq_diff && nf != 0;
    int t1, t2, q_domain_diff;
    if (cramped) {
      t1 = to_w16(shl_i32(nf, zeros16n));
      q_domain_diff = zeros16n - dq_diff;
      t2 = sar_i32(dfa_i, -q_domain_diff);
    } else {
      t1 = to_w16(dq_diff < 0 ? sar_i32(nf, -dq_diff) : shl_i32(nf, dq_diff));
      q_domain_diff = 0;
      t2 = to_w16(dfa_i);
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
    S[O_NEAR_FILT + i] = near_filt;

    const uint32_t rounded = gained + (uint32_t)sar_i32(near_filt, 1);
    const uint32_t ratio =
        div_u32_u16(rounded, (uint32_t)(near_filt & 0xFFFF));
    const int tmp32no1 = (int)shift_w32_u(ratio, resolution_diff);
    int h = tmp32no1 > ONE_Q14 ? 0
                               : (tmp32no1 < 0 ? ONE_Q14
                                               : max(ONE_Q14 - tmp32no1, 0));
    if (gained == 0) {
      h = ONE_Q14;
    } else if (near_filt == 0) {
      h = 0;
    }
    hnl[jb] = h;
    num_pos_coef += h != 0;
  }
  num_pos_coef = (int)warp_sum((uint32_t)num_pos_coef);

  if (c.in.mult == 2) {
    int avg = 0;
#pragma unroll
    for (int jb = 0; jb < 3; ++jb) {
      const int i = lane + 32 * jb;
      hnl[jb] = to_w16((hnl[jb] * hnl[jb]) >> 14);
      if (i >= 4 && i <= 24) avg += hnl[jb];
    }
    avg = (int)warp_sum((uint32_t)avg) / 21;
#pragma unroll
    for (int jb = 0; jb < 3; ++jb) {
      const int i = lane + 32 * jb;
      if (i >= 24 && hnl[jb] > avg) hnl[jb] = avg;
    }
  }
  if (sc.nlp_flag != 0) {
    const int nlp_gain = num_pos_coef < 3 ? 0 : ONE_Q14;
#pragma unroll
    for (int jb = 0; jb < 3; ++jb) {
      int h = hnl[jb];
      h = h < 3277 ? 0 : (h > ONE_Q14 ? ONE_Q14 : h);
      hnl[jb] = (h == ONE_Q14 && nlp_gain == ONE_Q14)
                    ? ONE_Q14
                    : to_w16((h * nlp_gain) >> 14);
    }
  }

  // efw = dfw * hnl (dfw is the near transform still in O_FR / O_FI),
  // comfort noise, IFFT
  int efw_re[3], efw_im[3];
  const bool cng = sc.cng_mode != 0;
  const int shift_noise = 15 - sc.dfa_clean_q;
  const bool fast = sc.noise_est_ctr < 100;
  if (cng && fast) sc.noise_est_ctr = sc.noise_est_ctr + 1;
  const int min_track_shift = fast ? 6 : 9;
#pragma unroll
  for (int jb = 0; jb < 3; ++jb) {
    const int i = lane + 32 * jb;
    efw_re[jb] = efw_im[jb] = 0;
    if (i >= PART_LEN1) continue;
    const int dfw_re = S[O_FR + i];
    const int dfw_im = (i == 0 || i == PART_LEN) ? 0 : to_w16(-S[O_FI + i]);
    efw_re[jb] = to_w16((dfw_re * hnl[jb] + 8192) >> 14);
    efw_im[jb] = to_w16((dfw_im * hnl[jb] + 8192) >> 14);
    if (cng) {
      _comfort_noise_f(c, i, S[O_DFA_WIENER + i], hnl[jb], x.phase[jb],
                       shift_noise, min_track_shift, efw_re[jb], efw_im[jb]);
    }
  }
  _inverse_fft_and_window_f(c, sc, efw_re, efw_im, ring);
}

// Sample i of slot `slot`'s 64 outputs (0 beyond the step's slots); the
// general instances keep the last N_SLOTS slots in a ring.
template <bool GEN>
__device__ __forceinline__ int slot_sample(const int* S, int slot,
                                           int n_slots, int i) {
  if (slot < 0 || slot >= n_slots) return 0;
  return S[O_OUTS + (GEN ? slot % N_SLOTS : slot) * PART_LEN + i];
}

// The slot after which frame f's output can be made: the last of the one
// or two blocks it takes.
__device__ __forceinline__ int frame_last_slot(int f, bool run_f, int fill0,
                                               int k, int n) {
  const int j_f = max(k - (n - f), 0);
  const bool two = (((fill0 + 16 * j_f) & 63) >= 48) && run_f;
  return ((fill0 + FRAME_LEN * j_f) >> 6) + (two ? 1 : 0);
}

// Frame f's output attribution and its 80-sample emit (fused.py
// _emit_frame_f): to the O_EMIT staging, or straight to `out` in the
// general instances.
template <bool GEN>
__device__ void _emit_frame_f(const Ctx& c, Scal& sc, int f, bool run_f,
                              int fill0, int k, int n, int n_slots) {
  int* S = c.S;
  const int lane = c.lane;
  const int j_f = max(k - (n - f), 0);
  const bool two = (((fill0 + 16 * j_f) & 63) >= 48) && run_f;
  const int b_f = (fill0 + FRAME_LEN * j_f) >> 6;
  const int o = sc.out_fill;
  const int osel = o >> 4;
  const int fo = 16 * osel;
  // sample i of the frame's 192-sample work window: the out-carry up to
  // its fill, then the frame's one or two blocks, zeros after
  auto wo = [&](int i) -> int {
    if (osel < 0 || osel > 3) return 0;
    if (i < fo) return S[O_OUT_CARRY + i];
    const int pi = i - fo;
    if (pi >= 2 * PART_LEN) return 0;
    if (pi < PART_LEN) return slot_sample<GEN>(S, b_f, n_slots, pi);
    return two ? slot_sample<GEN>(S, b_f + 1, n_slots, pi - PART_LEN) : 0;
  };
  const int avail = o + (1 + (two ? 1 : 0)) * PART_LEN;
  const int stuff = max(0, FRAME_LEN - avail);
  const bool stuffed = stuff > 0;
  int out_f[3], carry[2];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int i = lane + 32 * j;
    out_f[j] = 0;
    if (i < FRAME_LEN) {
      out_f[j] = stuffed ? (i < 16 ? S[O_OUT_TAIL + i] : wo(i - 16)) : wo(i);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = lane + 32 * j;
    carry[j] = stuffed ? wo(64 + i) : wo(FRAME_LEN + i);
  }
  __syncwarp();   // the old carry and tail have been read
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int i = lane + 32 * j;
    if (i < FRAME_LEN) {
      if (GEN) {
        c.in.out[(size_t)(f * FRAME_LEN + i) * c.in.B + c.b] = out_f[j];
      } else {
        S[O_EMIT + f * FRAME_LEN + i] = out_f[j];
      }
    }
  }
  if (run_f) {
    S[O_OUT_CARRY + lane] = carry[0];
    S[O_OUT_CARRY + 32 + lane] = carry[1];
    sc.out_fill = avail + stuff - FRAME_LEN;
    if (lane < 16) S[O_OUT_TAIL + lane] = out_f[2];   // out_f[64 + lane]
  }
  __syncwarp();
}

// The general instances' window change: the sliding histories have taken
// N_SLOTS new rows, their head room is used up, so each moves its rows
// back by N_SLOTS words, top down in chunks of 32 (a chunk's writes reach
// only words its own reads have passed).
__device__ void slide_reset(const Ctx& c) {
  const Geo& g = c.g;
  const int offs[6] = {g.fe_hist, g.fe_bc, O_NLE, O_EALE, O_ESLE, g.ne_bh};
  const int rows[6] = {g.H, g.H, PART_LEN, PART_LEN, PART_LEN, g.cap};
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    int* base = c.S + offs[q];
    for (int top = rows[q]; top > 0; top -= 32) {
      const int r = top - 32 + c.lane;
      const int v = r >= 0 ? base[r] : 0;
      __syncwarp();
      if (r >= 0) base[r + N_SLOTS] = v;
      __syncwarp();
    }
  }
}

// One stream's step, by one warp, on its staged state.  The main path's
// instances run at most N_SLOTS slots (4 frames) and emit at the end; the
// general ones run any number in windows of N_SLOTS, resetting the sliding
// histories' head room between windows, and emit each frame as soon as
// its slots are done.
template <bool CLEAN, bool CIRC, bool GEN>
__device__ void run_stream(const Ctx& c) {
  int* S = c.S;
  const int lane = c.lane, b = c.b;
  const Inputs& in = c.in;
  Scal sc;
#define AECM_LOAD(field, LEAF) sc.field = S[O_SCAL + LEAF];
  AECM_RW_SCALARS(AECM_LOAD)
  AECM_RO_SCALARS(AECM_LOAD)
#undef AECM_LOAD

  // the main path's circular schedule is the 4-frame step; its
  // newest-first one runs 1 to 4 frames
  const int n = (CIRC && !GEN) ? N_FRAMES : in.n_frames;
  const int n_slots =
      (CIRC && !GEN) ? N_SLOTS : (n * FRAME_LEN + 48) / PART_LEN;
  const int fill0 = sc.frame_fill;
  bool run[N_FRAMES];
  int k = 0;
  bool run_last = false;
  if (GEN) {
    for (int f = lane; f < n; f += 32) k += in.run_rows[(size_t)f * in.B + b];
    k = (int)warp_sum((uint32_t)k);
    run_last = in.run_rows[(size_t)(n - 1) * in.B + b];
  } else {
#pragma unroll
    for (int f = 0; f < N_FRAMES; ++f) {
      run[f] = f < n && in.run_rows[(size_t)f * in.B + b];
      k += run[f];
    }
#pragma unroll
    for (int f = 0; f < N_FRAMES; ++f) {
      if (f == n - 1) run_last = run[f];
    }
  }
  const int total = fill0 + FRAME_LEN * k;

  // slot-major block schedule; activity is monotone in s
  int n_act = 0, win0 = 0, next_f = 0;
  SlotIn x = fetch_slot<CLEAN, CIRC>(c, sc, 0, fill0, k, n);
  for (int s = 0; s < n_slots; ++s) {
    SlotIn next = x;
    if (s + 1 < n_slots) {
      next = fetch_slot<CLEAN, CIRC>(c, sc, s + 1, fill0, k, n);
    }
    const int ring = GEN ? s % N_SLOTS : s;
    if (total >= PART_LEN * (s + 1)) {
      if (GEN && s - win0 == N_SLOTS) {
        slide_reset(c);
        win0 = s;
      }
      _process_block_f<CLEAN, CIRC, GEN>(c, sc, s, ring,
                                         N_SLOTS - 1 - (s - win0), x);
      ++n_act;
    } else {
      _inactive_slot<CIRC, GEN>(c, s, ring, x);
    }
    x = next;
    if (GEN) {
      __syncwarp();   // this slot's outputs are in the ring
      for (; next_f < n; ++next_f) {
        const bool run_f = in.run_rows[(size_t)next_f * in.B + b];
        if (s + 1 < n_slots &&
            frame_last_slot(next_f, run_f, fill0, k, n) > s) {
          break;
        }
        _emit_frame_f<true>(c, sc, next_f, run_f, fill0, k, n, n_slots);
      }
    }
  }
  __syncwarp();   // O_OUTS is complete; the carries are free to change

  // in-carry: rows [64, 128) of the last active frame's window (stream
  // rows >= 64 never read the carry, so updating it in place is safe)
  if (run_last) {
    const int b_last_p1 = ((fill0 + FRAME_LEN * max(k - 1, 0)) >> 6) + 1;
    const bool ok = b_last_p1 >= 1 && b_last_p1 <= n_slots;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = lane + 32 * j;
      const int row = b_last_p1 * PART_LEN + i;
      S[O_CARRY_FAR + i] =
          ok ? stream_sample(c, O_CARRY_FAR, in.far, fill0, k, n, row) : 0;
      S[O_CARRY_NOISY + i] =
          ok ? stream_sample(c, O_CARRY_NOISY, in.noisy, fill0, k, n, row)
             : 0;
      if (CLEAN) {
        S[O_CARRY_CLEAN + i] =
            ok ? stream_sample(c, O_CARRY_CLEAN, in.clean, fill0, k, n, row)
               : 0;
      }
    }
  }
  sc.frame_fill = (fill0 + 16 * k) & 63;

  // the main path's per-frame output attribution and emit, in frame order
  if (!GEN) {
#pragma unroll
    for (int f = 0; f < N_FRAMES; ++f) {
      if (f >= n) break;
      _emit_frame_f<false>(c, sc, f, run[f], fill0, k, n, n_slots);
    }
  }

  if (lane == 0) {
#define AECM_STORE(field, LEAF) S[O_SCAL + LEAF] = sc.field;
    AECM_RW_SCALARS(AECM_STORE)
#undef AECM_STORE
    S[O_N_ACT] = n_act;
    S[O_N_SLIDE] = n_act - win0;
    // the seed advanced by the step's draws: 64 per active slot
    if (sc.cng_mode != 0 && n_act >= 1) {
      ((long long*)c.lv.p[SEED])[b] = cng_seed(c, n_act * PART_LEN - 1);
    }
  }
}

// Rows [row0, row0 + rows) of a (rows, B) array <-> word `off` on of each
// of the block's streams, by the whole block: G = 2^lg adjacent streams
// are 4 G contiguous bytes of a row.  `shift_off` is the stream's word
// holding the number of rows the staged window moved back (negative:
// none).  Loads are asynchronous copies (of an int64 leaf the low word):
// the caller commits and waits for them.
template <bool STORE, bool WIDE>
__device__ __forceinline__ void copy_rows(void* global, int row0, int rows,
                                          int off, int shift_off,
                                          int* streams, int b0, int B,
                                          int lg, int words) {
  const int G = 1 << lg, threads = 32 << lg;
  for (int e = threadIdx.x; e < rows * G; e += threads) {
    const int r = e >> lg, g = e & (G - 1);
    if (b0 + g >= B) continue;
    int* S = streams + g * words;
    const size_t at = (size_t)(row0 + r) * B + b0 + g;
    int* word = S + off + r - (STORE && shift_off >= 0 ? S[shift_off] : 0);
    if (STORE) {
      if (WIDE) {
        ((long long*)global)[at] = (long long)(uint32_t)*word;
      } else {
        ((int*)global)[at] = *word;
      }
    } else {
      // asynchronous, so that all of a thread's loads are in flight at once
      __pipeline_memcpy_async(
          word, (const int*)global + (WIDE ? 2 * at : at), 4);
    }
  }
}

// The newest-first far history merge (fused.py _far_merge_deferred) of a
// (blocks * rows, B) leaf, in place, by the whole block: stream g's new
// block d is its pending block n_act - 1 - d for d < n_act (staged at word
// `pend_off`; in the general instances from `pend`, (slots * rows, B) in
// global memory), else its old block d - n_act.  Row r takes row
// r - rows * n_act of the same stream, so the rows go in descending
// chunks: each thread reads its rows of the chunk, the block syncs, and
// the chunk is written.  A chunk's reads reach only rows below it, and no
// thread writes the next chunk before every thread has passed the next
// barrier, after its reads of this one.
template <bool GEN>
__device__ void merge_history(int* hist, int rows, int blocks, int pend_off,
                              const int* pend, int* streams, int b0, int B,
                              int lg, int words) {
  constexpr int K = 8;                 // values a thread a chunk
  constexpr int CHUNK = K * 32;        // rows a chunk
  const int G = 1 << lg, threads = 32 << lg;
  for (int hi = rows * blocks; hi > 0; hi -= CHUNK) {
    int v[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int e = threadIdx.x + j * threads;
      const int r = hi - 1 - (e >> lg), g = e & (G - 1);
      v[j] = 0;
      if (r >= 0 && b0 + g < B) {
        const int* S = streams + g * words;
        const int n_act = S[O_N_ACT];
        const int d = r / rows;
        if (n_act == 0) continue;
        if (d >= n_act) {
          v[j] = hist[(size_t)(r - rows * n_act) * B + b0 + g];
        } else if (GEN) {
          v[j] = pend[(size_t)((n_act - 1 - d) * rows + r % rows) * B + b0 +
                      g];
        } else {
          v[j] = S[pend_off + (n_act - 1 - d) * rows + r % rows];
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int e = threadIdx.x + j * threads;
      const int r = hi - 1 - (e >> lg), g = e & (G - 1);
      if (r >= 0 && b0 + g < B && streams[g * words + O_N_ACT] > 0) {
        hist[(size_t)r * B + b0 + g] = v[j];
      }
    }
  }
}

// The delay estimator's leaves with rows, as staged: (leaf, rows, word
// offset, sliding, int64).  The near binary history is a row leaf in the
// general instances only.
struct DeLeaf {
  int leaf, rows, off;
  bool slide, wide;
};
template <bool GEN>
__device__ __forceinline__ int de_leaves(const Geo& g, DeLeaf* out) {
  out[0] = DeLeaf{FE_BINARY_HISTORY, g.H, g.fe_hist, true, true};
  out[1] = DeLeaf{FE_BIT_COUNTS, g.H, g.fe_bc, true, false};
  out[2] = DeLeaf{NE_BIT_COUNTS, g.H, g.ne_bc, false, false};
  out[3] = DeLeaf{NE_MEAN_BIT_COUNTS, g.H + 1, g.ne_mbc, false, false};
  out[4] = DeLeaf{NE_HISTOGRAM, g.H + 1, g.ne_hist, false, false};
  out[5] = DeLeaf{NE_BINARY_HISTORY, g.cap, g.ne_bh, true, true};
  return GEN ? 6 : 5;
}

template <bool CLEAN, bool CIRC, bool GEN>
__global__ void __launch_bounds__(Layout<CLEAN>::THREADS,
                                  Layout<CLEAN>::MIN_BLOCKS)
frames_step_kernel(const __grid_constant__ Leaves lv,
                   const __grid_constant__ Inputs in) {
  using L = Layout<CLEAN>;
  extern __shared__ int smem[];
  const Geo geo = GEN ? in.geo : make_geo(CLEAN, false, MAX_DELAY, 1);
  const int lg = GEN ? in.lg : L::LG;
  const int words = geo.words, threads = 32 << lg;
  int* fwr = smem;
  int* fws = fwr + 7 * 128;
  int* win = fws + 7 * 128;
  int* streams = smem + TABLE_WORDS;
  const int b0 = blockIdx.x << lg;
  DeLeaf de[6];
  const int n_de = de_leaves<GEN>(geo, de);

  for (int e = threadIdx.x; e < 7 * 128; e += threads) {
    __pipeline_memcpy_async(fwr + e, in.fwr + e, 4);
    __pipeline_memcpy_async(fws + e, in.fws + e, 4);
  }
  for (int e = threadIdx.x; e < 128; e += threads) {
    __pipeline_memcpy_async(win + e, in.win128 + e, 4);
  }
  for (int n = 0; n < N_ROW_LEAVES - (CLEAN ? 0 : 2); ++n) {
    const RowLeaf R = kRowLeaves[n];
    const int off = R.off + (R.slide ? N_SLOTS : 0);
    copy_rows<false, false>(lv.p[R.leaf], R.row0, R.rows, off, -1, streams,
                            b0, in.B, lg, words);
  }
#pragma unroll
  for (int n = 0; n < n_de; ++n) {
    const int off = de[n].off + (de[n].slide ? N_SLOTS : 0);
    if (de[n].wide) {
      copy_rows<false, true>(lv.p[de[n].leaf], 0, de[n].rows, off, -1,
                             streams, b0, in.B, lg, words);
    } else {
      copy_rows<false, false>(lv.p[de[n].leaf], 0, de[n].rows, off, -1,
                              streams, b0, in.B, lg, words);
    }
  }
  for (int e = threadIdx.x; e < (N_SCALARS << lg); e += threads) {
    const int leaf = kScalarLeaves[e >> lg], g = e & ((1 << lg) - 1);
    if (b0 + g < in.B) {
      __pipeline_memcpy_async(
          streams + g * words + O_SCAL + leaf,
          (const int*)lv.p[leaf] +
              (leaf == NE_BINARY_HISTORY ? 2 * (b0 + g) : b0 + g),
          4);
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  if (b0 + warp < in.B) {   // the whole warp together
    const int b = b0 + warp;
    const Ctx c{streams + warp * words, fwr, fws, win, lv, in, b,
                (int)(threadIdx.x & 31), geo,
                GEN ? ((const int*)lv.p[NE_LOOKAHEAD])[b] : 0,
                // read from device memory, so that one CUDA graph of a
                // step serves every head; reduced into range so that no
                // head reads outside the history
                CIRC ? (*in.head % MAX_DELAY + MAX_DELAY) % MAX_DELAY : 0,
                (uint32_t)((const long long*)lv.p[SEED])[b]};
    run_stream<CLEAN, CIRC, GEN>(c);
  }
  __syncthreads();

  for (int n = 0; n < N_ROW_LEAVES - (CLEAN ? 0 : 2); ++n) {
    const RowLeaf R = kRowLeaves[n];
    const int off = R.off + (R.slide ? N_SLOTS : 0);
    copy_rows<true, false>(lv.p[R.leaf], R.row0, R.rows, off,
                           R.slide ? O_N_SLIDE : -1, streams, b0, in.B, lg,
                           words);
  }
#pragma unroll
  for (int n = 0; n < n_de; ++n) {
    const int off = de[n].off + (de[n].slide ? N_SLOTS : 0);
    const int shift_off = de[n].slide ? O_N_SLIDE : -1;
    if (de[n].wide) {
      copy_rows<true, true>(lv.p[de[n].leaf], 0, de[n].rows, off, shift_off,
                            streams, b0, in.B, lg, words);
    } else {
      copy_rows<true, false>(lv.p[de[n].leaf], 0, de[n].rows, off,
                             shift_off, streams, b0, in.B, lg, words);
    }
  }
  for (int e = threadIdx.x; e < (N_RW_SCALARS << lg); e += threads) {
    const int leaf = kScalarLeaves[e >> lg], g = e & ((1 << lg) - 1);
    if (b0 + g < in.B) {
      const int v = streams[g * words + O_SCAL + leaf];
      if (leaf == NE_BINARY_HISTORY) {
        // the general instances store it with the row leaves
        if (!GEN) ((long long*)lv.p[leaf])[b0 + g] = (long long)(uint32_t)v;
      } else {
        ((int*)lv.p[leaf])[b0 + g] = v;
      }
    }
  }
  if (!GEN) {
    const int n_frames = CIRC ? N_FRAMES : in.n_frames;
    copy_rows<true, false>(in.out, 0, n_frames * FRAME_LEN, O_EMIT, -1,
                           streams, b0, in.B, lg, words);
    if (CIRC) {
      copy_rows<true, false>(in.pend_hist, 0, N_SLOTS * FAR_HIST_ROWS,
                             O_PEND, -1, streams, b0, in.B, lg, words);
      copy_rows<true, false>(in.pend_q, 0, N_SLOTS, O_PEND_Q, -1, streams,
                             b0, in.B, lg, words);
    }
  }
  if (!CIRC) {
    merge_history<GEN>((int*)lv.p[FAR_HISTORY], FAR_HIST_ROWS, MAX_DELAY,
                       O_PEND, in.pend_hist, streams, b0, in.B, lg, words);
    merge_history<GEN>((int*)lv.p[FAR_Q_DOMAINS], 1, MAX_DELAY, O_PEND_Q,
                       in.pend_q, streams, b0, in.B, lg, words);
  }
}

// Shared bytes a block of 2^lg streams of `words` words takes.
__host__ __device__ constexpr int frames_smem(int lg, int words) {
  return (TABLE_WORDS + (words << lg)) * 4;
}

// The launch shape of an instance at history size H and lookahead capacity
// cap: in the general instances the number of streams a block (a power of
// two up to the main layout's G) that leaves the most warps resident, the
// larger on a tie.  Returns a CUDA error code, or -4 if one stream does not
// fit a block.
template <bool CLEAN, bool CIRC, bool GEN>
int frames_shape(int H, int cap, Geo* geo, int* lg, int* blocks_per_sm) {
  using L = Layout<CLEAN>;
  const auto kernel = frames_step_kernel<CLEAN, CIRC, GEN>;
  // more than 48 KB of shared memory is dynamic and asked for once a card
  static bool asked[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= 64 || !asked[device]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               GEN ? SMEM_LIMIT : L::SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    if (device < 64) asked[device] = true;
  }
  *geo = GEN ? make_geo(CLEAN, true, H, cap) : L::GEO;
  if (!GEN) {
    *lg = L::LG;
    if (blocks_per_sm == nullptr) return 0;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, L::THREADS, L::SMEM_BYTES);
  }
  // the general instances: the last shape asked for is kept
  static int last_H = -1, last_cap = -1, last_lg = 0, last_blocks = 0;
  if (H != last_H || cap != last_cap) {
    if (frames_smem(0, geo->words) > SMEM_LIMIT) return -4;
    int best_lg = 0, best_warps = -1, best_blocks = 0;
    for (int l = L::LG; l >= 0; --l) {
      const int smem = frames_smem(l, geo->words);
      if (smem > SMEM_LIMIT) continue;
      int blocks = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                          32 << l, smem);
      if (err != cudaSuccess) return (int)err;
      if ((blocks << l) > best_warps) {
        best_warps = blocks << l;
        best_lg = l;
        best_blocks = blocks;
      }
    }
    last_H = H;
    last_cap = cap;
    last_lg = best_lg;
    last_blocks = best_blocks;
  }
  *lg = last_lg;
  if (blocks_per_sm != nullptr) *blocks_per_sm = last_blocks;
  return 0;
}

// Launch one instance on `stream`; returns a CUDA error code (-4: the
// history does not fit a block).
template <bool CLEAN, bool CIRC, bool GEN>
int launch_frames(const Leaves& lv, Inputs in, cudaStream_t stream) {
  int err = frames_shape<CLEAN, CIRC, GEN>(in.geo.H, in.geo.cap, &in.geo,
                                           &in.lg, nullptr);
  if (err) return err;
  const int blocks = (in.B + (1 << in.lg) - 1) >> in.lg;
  frames_step_kernel<CLEAN, CIRC, GEN>
      <<<blocks, 32 << in.lg, frames_smem(in.lg, in.geo.words), stream>>>(
          lv, in);
  return (int)cudaGetLastError();
}

// Launch the instance a step takes (frames_instance_is_general).
template <bool CLEAN>
int launch_frames_of(bool circular, bool general, const Leaves& lv,
                     const Inputs& in, cudaStream_t stream) {
  if (general) {
    return circular ? launch_frames<CLEAN, true, true>(lv, in, stream)
                    : launch_frames<CLEAN, false, true>(lv, in, stream);
  }
  return circular ? launch_frames<CLEAN, true, false>(lv, in, stream)
                  : launch_frames<CLEAN, false, false>(lv, in, stream);
}

// An instance's launch shape, for reports: streams per block, shared bytes
// per block, and how many blocks of it an SM holds at once.
template <bool CLEAN>
int frames_layout_of(bool circular, bool general, int H, int cap,
                     int* streams_per_block, int* smem_bytes,
                     int* blocks_per_sm) {
  Geo geo;
  int lg = 0, err;
  if (general) {
    err = circular ? frames_shape<CLEAN, true, true>(H, cap, &geo, &lg,
                                                      blocks_per_sm)
                   : frames_shape<CLEAN, false, true>(H, cap, &geo, &lg,
                                                       blocks_per_sm);
  } else {
    err = circular ? frames_shape<CLEAN, true, false>(H, cap, &geo, &lg,
                                                       blocks_per_sm)
                   : frames_shape<CLEAN, false, false>(H, cap, &geo, &lg,
                                                        blocks_per_sm);
  }
  *streams_per_block = 1 << lg;
  *smem_bytes = frames_smem(lg, geo.words);
  return err;
}

}  // namespace

// Whether a step takes the general instances: any history size but 100,
// lookahead capacity above 1, more than N_SLOTS slots, or a circular step
// of other than 4 frames (fused_kernel.general_instance).
inline bool frames_instance_is_general(int H, int cap, int n_frames,
                                       bool circular) {
  const int n_slots = (n_frames * FRAME_LEN + 48) / PART_LEN;
  return !(H == MAX_DELAY && cap == 1 && n_slots <= N_SLOTS &&
           (n_frames == N_FRAMES || !circular));
}

}  // namespace aecm
