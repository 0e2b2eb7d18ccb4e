"""Compile-time algorithm constants of the AECM pipeline (PyTorch port).

A copy of webrtc_aecm_tpu/defines.py: the same names and values, plain
Python ints and floats, so the port reads its constants without importing
the JAX package (whose package import pulls in jax).  The constant registry
mirrors the reference implementation (aecm/aecm_defines.h:14-85) plus a few
constants the reference scatters across translation units.
"""

# --- Frame / block geometry (aecm_defines.h:17-26) ---
FRAME_LEN = 80          # one 10 ms frame at 8 kHz
PART_LEN = 64           # processing block length
PART_LEN_SHIFT = 7      # log2(PART_LEN * 2)
PART_LEN1 = PART_LEN + 1
PART_LEN2 = PART_LEN * 2
PART_LEN4 = PART_LEN * 4
FAR_BUF_LEN = PART_LEN4  # known-delay far sample ring
MAX_DELAY = 100          # delay-estimator history depth (blocks)

# --- Startup counters (aecm_defines.h:29-30) ---
CONV_LEN = 512
CONV_LEN2 = CONV_LEN * 2

# --- Energy / VAD (aecm_defines.h:33-40) ---
MAX_BUF_LEN = 64
FAR_ENERGY_MIN = 1025
FAR_ENERGY_DIFF = 929
ENERGY_DEV_OFFSET = 0
ENERGY_DEV_TOL = 400
FAR_ENERGY_VAD_REGION = 230

# --- NLMS step size (aecm_defines.h:43-47) ---
MU_MIN = 10
MU_MAX = 1
MU_DIFF = 9

# --- Channel estimation (aecm_defines.h:50-58) ---
MIN_MSE_COUNT = 20
MIN_MSE_DIFF = 29
MSE_RESOLUTION = 5
RESOLUTION_CHANNEL16 = 12
RESOLUTION_CHANNEL32 = 28
CHANNEL_VAD = 16

# --- Suppression gain (aecm_defines.h:61-69) ---
RESOLUTION_SUPGAIN = 8
SUPGAIN_DEFAULT = 1 << RESOLUTION_SUPGAIN
SUPGAIN_ERROR_PARAM_A = 3072
SUPGAIN_ERROR_PARAM_B = 1536
SUPGAIN_ERROR_PARAM_D = SUPGAIN_DEFAULT
SUPGAIN_EPC_DT = 200

ONE_Q14 = 1 << 14

# --- NLP (aecm_defines.h:84-85) ---
NLP_COMP_LOW = 3277
NLP_COMP_HIGH = ONE_Q14

# --- Word limits (signal_processing_library.h:94-97) ---
WORD16_MAX = 32767
WORD16_MIN = -32768
WORD32_MAX = 0x7FFFFFFF
WORD32_MIN = -0x80000000

# --- Comfort-noise estimator (aecm_core_c.cc:49-50) ---
NOISE_EST_Q_DOMAIN = 15
NOISE_EST_INC_COUNT = 5

# --- Delay-estimator core (delay_estimator.cc:23-40) ---
SHIFTS_AT_ZERO = 13
SHIFTS_LINEAR_SLOPE = 3
PROBABILITY_OFFSET = 1024       # 2 in Q9
PROBABILITY_LOWER_LIMIT = 8704  # 17 in Q9
PROBABILITY_MIN_SPREAD = 2816   # 5.5 in Q9
MAX_BITCOUNTS_Q9 = 32 << 9      # delay_estimator.h:20

HISTOGRAM_MAX = 3000.0
LAST_HISTOGRAM_MAX = 250.0
MIN_HISTOGRAM_THRESHOLD = 1.5
MIN_REQUIRED_HITS = 10
MAX_HITS_WHEN_POSSIBLY_NON_CAUSAL = 10
MAX_HITS_WHEN_POSSIBLY_CAUSAL = 1000
Q14_SCALING = 1.0 / (1 << 14)
FRACTION_SLOPE = 0.05
MIN_FRACTION_WHEN_POSSIBLY_CAUSAL = 0.5
MIN_FRACTION_WHEN_POSSIBLY_NON_CAUSAL = 0.25

# --- Delay-estimator wrapper band selection (delay_estimator_wrapper.cc:50-55) ---
BAND_FIRST = 12
BAND_LAST = 43

# --- Control layer (echo_control_mobile.cc:29-40) ---
BUF_SIZE_FRAMES = 50
BUF_SIZE_SAMP = BUF_SIZE_FRAMES * FRAME_LEN  # 4000-sample far jitter ring
SAMP_MS_NB = 8
INIT_CHECK = 42

# Error codes (echo_control_mobile.h:23-30)
AECM_UNSPECIFIED_ERROR = 12000
AECM_UNSUPPORTED_FUNCTION_ERROR = 12001
AECM_UNINITIALIZED_ERROR = 12002
AECM_NULL_POINTER_ERROR = 12003
AECM_BAD_PARAMETER_ERROR = 12004
AECM_BAD_PARAMETER_WARNING = 12100

# --- FFT rounding constants (complex_fft.c:20-25) ---
CFFTSFT = 14
CFFTRND = 1
CFFTRND2 = 16384
CIFFTSFT = 14
CIFFTRND = 1
