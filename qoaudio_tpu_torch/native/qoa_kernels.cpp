// Native host-runtime kernels for the qoaudio_tpu framework.
//
// Role in the architecture (SURVEY.md §1, layer L2): the TPU device path
// (ops/decode.py, ops/encode.py) owns the batched HBM-resident deployment
// shape; THIS module owns the host/IO path — streaming decoders, one-shot
// single-file transcode — where per-call host<->device transfer latency
// would dominate.  It mirrors the device kernels' *design*, not the
// reference's scalar Rust (src/lib.rs):
//
//  * decode vectorizes across CHAINS (frames x channels): every QOA frame
//    header carries a full LMS snapshot (src/lib.rs:271-281), so all
//    frames decode in parallel — dense int32 lane loops the compiler maps
//    onto AVX2/AVX-512.
//  * encode vectorizes across the 16 SCALEFACTOR candidates of one chain
//    (one 512-bit int32 vector, GCC vector extensions — the same
//    lanes-explicit style as the Pallas/JAX device kernel) for the first
//    sample, then continues only the top-8 candidates with rare scalar
//    stragglers; the winner is the lexicographic
//    (total_rank, first_rank, sf) argmin proven equivalent to the
//    reference's sequential early-exit search (SURVEY.md §3.3).
//
// All arithmetic wraps in two's complement (unsigned internally), matching
// the reference's wrapping ops (src/lib.rs:606-617, 797-828).
//
// Build: g++ -O3 -march=native -shared -fPIC (see native/__init__.py).

#include <immintrin.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kSliceLen = 20;
constexpr int kNumSf = 16;

// scalefactor table: round(pow(sf+1, 2.75)) for sf in 0..15
constexpr int32_t kSfTab[kNumSf] = {
    1, 7, 21, 45, 84, 138, 211, 304, 421, 562, 731, 928, 1157, 1419, 1715, 2048};

// fixed-point reciprocals: (1<<16 + v - 1) / v over kSfTab
constexpr int32_t kRecipTab[kNumSf] = {
    65536, 9363, 3121, 1457, 781, 475, 311, 216, 156, 117, 90, 71, 57, 47, 39, 32};

inline int32_t clamp_i16(int32_t v) {
  return v < -32768 ? -32768 : (v > 32767 ? 32767 : v);
}

// dequant magnitudes: round-ties-away of sfv * {0.75, 2.5, 4.5, 7}
inline constexpr int32_t mag0(int32_t v) { return (3 * v + 2) >> 2; }
inline constexpr int32_t mag1(int32_t v) { return (5 * v + 1) >> 1; }
inline constexpr int32_t mag2(int32_t v) { return (9 * v + 1) >> 1; }
inline constexpr int32_t mag3(int32_t v) { return 7 * v; }

inline uint64_t bswap64(uint64_t v) { return __builtin_bswap64(v); }

// ---------------------------------------------------------------------------
// 16-lane int32 vectors (GCC vector extensions): one lane per scalefactor.
// ---------------------------------------------------------------------------
typedef int32_t v16i __attribute__((vector_size(64)));
typedef uint32_t v16u __attribute__((vector_size(64)));

inline v16i vbroadcast(int32_t s) { return v16i{} + s; }

#define V16_FROM_TABLE(expr)                                                  \
  v16i{expr(kSfTab[0]),  expr(kSfTab[1]),  expr(kSfTab[2]),  expr(kSfTab[3]), \
       expr(kSfTab[4]),  expr(kSfTab[5]),  expr(kSfTab[6]),  expr(kSfTab[7]), \
       expr(kSfTab[8]),  expr(kSfTab[9]),  expr(kSfTab[10]), expr(kSfTab[11]),\
       expr(kSfTab[12]), expr(kSfTab[13]), expr(kSfTab[14]), expr(kSfTab[15])}

// 3-bit quantizer as a 17-entry LUT over clamped+8 (one vpermi2d):
// negative residuals -> odd codes (magnitude capped 7), else even capped 6
const v16i kQuantLo = {7, 7, 7, 5, 5, 3, 3, 1, 0, 0, 2, 2, 4, 4, 6, 6};
const v16i kQuantHi = {6, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

const v16i kMag0V = V16_FROM_TABLE(mag0);
const v16i kMag1V = V16_FROM_TABLE(mag1);
const v16i kMag2V = V16_FROM_TABLE(mag2);
const v16i kMag3V = V16_FROM_TABLE(mag3);
const v16i kRecipV = {65536, 9363, 3121, 1457, 781, 475, 311, 216,
                      156,   117,  90,   71,   57,  47,  39,  32};
const v16u kSfBitsV = {0u << 28,  1u << 28,  2u << 28,  3u << 28,
                       4u << 28,  5u << 28,  6u << 28,  7u << 28,
                       8u << 28,  9u << 28,  10u << 28, 11u << 28,
                       12u << 28, 13u << 28, 14u << 28, 15u << 28};

// Dense int32/u32 lane loop of the decoder, isolated so __restrict__ params
// are honored and the compiler vectorizes without alias versioning.  The
// 3-bit code extracts IN the loop from u32 slice-word halves (planes of the
// u64 word; pure 32-bit ops keep the auto-vectorizer happy where mixed
// u64 loads defeated it) — no staging code planes, no extra memory pass.
// K is the compile-time sample index: the shift amounts and which half
// holds the code are selected at instantiation.
template <int K>
void decode_lane_step(int64_t N, const uint32_t* __restrict__ whi,
                      const uint32_t* __restrict__ wlo,
                      const int32_t* __restrict__ m0,
                      const int32_t* __restrict__ m1,
                      const int32_t* __restrict__ m2,
                      const int32_t* __restrict__ m3,
                      int32_t* __restrict__ H0, int32_t* __restrict__ H1,
                      int32_t* __restrict__ H2, int32_t* __restrict__ H3,
                      int32_t* __restrict__ W0, int32_t* __restrict__ W1,
                      int32_t* __restrict__ W2, int32_t* __restrict__ W3,
                      int16_t* __restrict__ o) {
#pragma GCC ivdep
  for (int64_t n = 0; n < N; ++n) {
    int32_t p = (int32_t)((uint32_t)W0[n] * (uint32_t)H0[n] +
                          (uint32_t)W1[n] * (uint32_t)H1[n] +
                          (uint32_t)W2[n] * (uint32_t)H2[n] +
                          (uint32_t)W3[n] * (uint32_t)H3[n]) >> 13;
    // code K at u64 bits [57-3K, 59-3K]: hi half for K<=8, straddling at 9
    int32_t code;
    if constexpr (K <= 8) {
      code = (int32_t)((whi[n] >> (25 - 3 * K)) & 7u);
    } else if constexpr (K == 9) {
      code = (int32_t)(((whi[n] & 1u) << 2) | (wlo[n] >> 30));
    } else {
      code = (int32_t)((wlo[n] >> (57 - 3 * K)) & 7u);
    }
    int32_t idx = code >> 1;
    int32_t m01 = idx == 0 ? m0[n] : m1[n];
    int32_t m23 = idx == 2 ? m2[n] : m3[n];
    int32_t m = idx < 2 ? m01 : m23;
    int32_t dq = (code & 1) ? -m : m;
    int32_t r = clamp_i16(p + dq);
    o[n] = static_cast<int16_t>(r);
    int32_t d = dq >> 4;
    W0[n] = (int32_t)((uint32_t)W0[n] + (uint32_t)(H0[n] < 0 ? -d : d));
    W1[n] = (int32_t)((uint32_t)W1[n] + (uint32_t)(H1[n] < 0 ? -d : d));
    W2[n] = (int32_t)((uint32_t)W2[n] + (uint32_t)(H2[n] < 0 ? -d : d));
    W3[n] = (int32_t)((uint32_t)W3[n] + (uint32_t)(H3[n] < 0 ? -d : d));
    H0[n] = H1[n];
    H1[n] = H2[n];
    H2[n] = H3[n];
    H3[n] = r;
  }
}

// ---------------------------------------------------------------------------
// Register-resident window-fused decode (AVX-512 path).
//
// The plane path above streams all 14 state/word planes through memory for
// EVERY sample step (~14 loads + 9 stores per sample; measured memory-op
// bound, not ALU bound — see experiments/cpp_decode_fused.py).  This path
// applies the encoder's fix to the decoder: per 16-chain group the LMS
// state lives in 8 zmm registers across ALL windows; each window loads two
// 512-bit word vectors, byte-swaps in-register, unpacks hi/lo planes and
// per-sf magnitudes with permutes, runs the 20-step recurrence entirely in
// registers (~34 ops/step), and stores only the int16 samples.  Two
// independent 16-chain groups interleave per 32-chain block to cover the
// serial latency of the prediction multiply chain.  State stays FULL int32
// (adversarial streams wrap the weights; no 16-bit packing) — all
// arithmetic wraps exactly like the reference (src/lib.rs:291-330).
// Measured 1.7-2.2x the plane path at the fixture shape, bit-exact on
// fixture + random-word wrap regimes.
// ---------------------------------------------------------------------------
#if defined(__AVX512F__) && defined(__AVX512BW__) && defined(__AVX512DQ__)
#define QOA_FUSED_DECODE 1

typedef char v64c __attribute__((vector_size(64)));

inline __m512i bswap64x8(__m512i v) {
  const v64c kRev8 = {
      7, 6, 5, 4, 3, 2, 1, 0, 15, 14, 13, 12, 11, 10, 9, 8,
      7, 6, 5, 4, 3, 2, 1, 0, 15, 14, 13, 12, 11, 10, 9, 8,
      7, 6, 5, 4, 3, 2, 1, 0, 15, 14, 13, 12, 11, 10, 9, 8,
      7, 6, 5, 4, 3, 2, 1, 0, 15, 14, 13, 12, 11, 10, 9, 8};
  return _mm512_shuffle_epi8(v, (__m512i)kRev8);
}

// One 16-chain group: LMS state + the current window's word planes and
// dequant magnitudes, all register-resident.
struct DecGroup {
  __m512i H0, H1, H2, H3, W0, W1, W2, W3;
  __m512i whi, wlo, m0, m1, m2, m3;
};

__attribute__((always_inline)) inline void dec_load_state(
    DecGroup& G, const int32_t* st, int64_t N, int64_t g) {
  G.H0 = _mm512_loadu_si512((const void*)(st + 0 * N + g));
  G.H1 = _mm512_loadu_si512((const void*)(st + 1 * N + g));
  G.H2 = _mm512_loadu_si512((const void*)(st + 2 * N + g));
  G.H3 = _mm512_loadu_si512((const void*)(st + 3 * N + g));
  G.W0 = _mm512_loadu_si512((const void*)(st + 4 * N + g));
  G.W1 = _mm512_loadu_si512((const void*)(st + 5 * N + g));
  G.W2 = _mm512_loadu_si512((const void*)(st + 6 * N + g));
  G.W3 = _mm512_loadu_si512((const void*)(st + 7 * N + g));
}

// Load 16 big-endian u64 slice words, split into u32 half planes, and
// gather the four dequant magnitudes for each lane's scalefactor.
__attribute__((always_inline)) inline void dec_load_window(
    DecGroup& G, const uint64_t* row) {
  const __m512i a = bswap64x8(_mm512_loadu_si512((const void*)row));
  const __m512i b = bswap64x8(_mm512_loadu_si512((const void*)(row + 8)));
  const __m512i kLo = _mm512_set_epi32(30, 28, 26, 24, 22, 20, 18, 16,
                                       14, 12, 10, 8, 6, 4, 2, 0);
  const __m512i kHi = _mm512_set_epi32(31, 29, 27, 25, 23, 21, 19, 17,
                                       15, 13, 11, 9, 7, 5, 3, 1);
  G.wlo = _mm512_permutex2var_epi32(a, kLo, b);
  G.whi = _mm512_permutex2var_epi32(a, kHi, b);
  const __m512i sf = _mm512_srli_epi32(G.whi, 28);
  G.m0 = _mm512_permutexvar_epi32(sf, (__m512i)kMag0V);
  G.m1 = _mm512_permutexvar_epi32(sf, (__m512i)kMag1V);
  G.m2 = _mm512_permutexvar_epi32(sf, (__m512i)kMag2V);
  G.m3 = _mm512_permutexvar_epi32(sf, (__m512i)kMag3V);
}

// One sample step (compile-time index K selects the code bit position),
// entirely in registers except the final 16 int16 sample store.
template <int K>
__attribute__((always_inline)) inline void dec_step(DecGroup& G, int16_t* o) {
  const __m512i z = _mm512_setzero_si512();
  __m512i code;
  if constexpr (K <= 8) {
    code = _mm512_and_si512(_mm512_srli_epi32(G.whi, 25 - 3 * K),
                            _mm512_set1_epi32(7));
  } else if constexpr (K == 9) {
    code = _mm512_or_si512(
        _mm512_slli_epi32(_mm512_and_si512(G.whi, _mm512_set1_epi32(1)), 2),
        _mm512_srli_epi32(G.wlo, 30));
  } else {
    code = _mm512_and_si512(_mm512_srli_epi32(G.wlo, 57 - 3 * K),
                            _mm512_set1_epi32(7));
  }
  __m512i p = _mm512_srai_epi32(
      _mm512_add_epi32(
          _mm512_add_epi32(_mm512_mullo_epi32(G.W0, G.H0),
                           _mm512_mullo_epi32(G.W1, G.H1)),
          _mm512_add_epi32(_mm512_mullo_epi32(G.W2, G.H2),
                           _mm512_mullo_epi32(G.W3, G.H3))),
      13);
  const __mmask16 b0 = _mm512_test_epi32_mask(code, _mm512_set1_epi32(2));
  const __mmask16 b1 = _mm512_test_epi32_mask(code, _mm512_set1_epi32(4));
  const __mmask16 bneg = _mm512_test_epi32_mask(code, _mm512_set1_epi32(1));
  __m512i m = _mm512_mask_blend_epi32(
      b1, _mm512_mask_blend_epi32(b0, G.m0, G.m1),
      _mm512_mask_blend_epi32(b0, G.m2, G.m3));
  const __m512i dq = _mm512_mask_sub_epi32(m, bneg, z, m);
  const __m512i r = _mm512_max_epi32(
      _mm512_min_epi32(_mm512_add_epi32(p, dq), _mm512_set1_epi32(32767)),
      _mm512_set1_epi32(-32768));
  _mm256_storeu_si256((__m256i*)o, _mm512_cvtepi32_epi16(r));
  const __m512i d = _mm512_srai_epi32(dq, 4);
  const __m512i dn = _mm512_sub_epi32(z, d);
  G.W0 = _mm512_add_epi32(
      G.W0, _mm512_mask_blend_epi32(_mm512_movepi32_mask(G.H0), d, dn));
  G.W1 = _mm512_add_epi32(
      G.W1, _mm512_mask_blend_epi32(_mm512_movepi32_mask(G.H1), d, dn));
  G.W2 = _mm512_add_epi32(
      G.W2, _mm512_mask_blend_epi32(_mm512_movepi32_mask(G.H2), d, dn));
  G.W3 = _mm512_add_epi32(
      G.W3, _mm512_mask_blend_epi32(_mm512_movepi32_mask(G.H3), d, dn));
  G.H0 = G.H1;
  G.H1 = G.H2;
  G.H2 = G.H3;
  G.H3 = r;
}

// One 32-chain block (columns g..g+31 of the stride-N arrays) across all
// W windows: two interleaved 16-chain groups.
static void decode_fused_block32(const uint64_t* words_be, const int32_t* st,
                                 int64_t W, int64_t N, int64_t g,
                                 int16_t* out) {
  DecGroup A, B;
  dec_load_state(A, st, N, g);
  dec_load_state(B, st, N, g + 16);
  for (int64_t w = 0; w < W; ++w) {
    const uint64_t* row = words_be + w * N + g;
    dec_load_window(A, row);
    dec_load_window(B, row + 16);
    int16_t* o = out + w * kSliceLen * N + g;
#define QOA_DSTEP(K)                  \
  dec_step<K>(A, o + (int64_t)K * N); \
  dec_step<K>(B, o + (int64_t)K * N + 16)
    QOA_DSTEP(0); QOA_DSTEP(1); QOA_DSTEP(2); QOA_DSTEP(3); QOA_DSTEP(4);
    QOA_DSTEP(5); QOA_DSTEP(6); QOA_DSTEP(7); QOA_DSTEP(8); QOA_DSTEP(9);
    QOA_DSTEP(10); QOA_DSTEP(11); QOA_DSTEP(12); QOA_DSTEP(13);
    QOA_DSTEP(14); QOA_DSTEP(15); QOA_DSTEP(16); QOA_DSTEP(17);
    QOA_DSTEP(18); QOA_DSTEP(19);
#undef QOA_DSTEP
  }
}

// ---------------------------------------------------------------------------
// Fused decode -> interleaved stereo PCM.
//
// The two-pass pair (decode_chains into a (W, 20, N) intermediate, then
// transpose_trim) writes + re-reads ~2x the PCM purely to relayout
// chain-major samples into frame-major interleaved PCM; at typical file
// sizes that round trip is DRAM-bound and costs about as much as the
// decode itself.  Here each 32-chain block instead stores its 20 per-step
// int16 vectors to a 20x32 L1 stack tile; after each window an in-register
// 16-lane u32 transpose (one STEREO sample pair = one u32 column) turns
// the tile into 16 frame rows of 40 int16 stored straight to their final
// interleaved positions.  Measured 1.9-2.2x the pair at the fixture shape
// (experiments/cpp_decode_interleaved.py), bit-exact vs the pair on
// fixture + adversarial random-word streams.
// ---------------------------------------------------------------------------

// Transpose a 20x16 u32 tile (20 sample steps x 16 stereo frame columns)
// to 16 frame rows of 20 u32, each stored at dst[col].  Rows 0..15 go
// through a 16x16 unpack/permute network (the unpack32/unpack64/
// shuffle128 stage order lands lanes in IDENTITY column order —
// pattern-verified); rows 16..19 transpose as a 4x16 block appended per
// frame row.
__attribute__((always_inline)) inline void tile_store_stereo(
    const uint32_t* tile /* [20][16] */, int16_t* const* dst /* [16] */) {
  __m512i r[16];
  for (int i = 0; i < 16; ++i)
    r[i] = _mm512_loadu_si512((const void*)(tile + i * 16));
  __m512i a[16];
  for (int i = 0; i < 8; ++i) {
    a[2 * i] = _mm512_unpacklo_epi32(r[2 * i], r[2 * i + 1]);
    a[2 * i + 1] = _mm512_unpackhi_epi32(r[2 * i], r[2 * i + 1]);
  }
  for (int i = 0; i < 4; ++i) {
    r[4 * i + 0] = _mm512_unpacklo_epi64(a[4 * i + 0], a[4 * i + 2]);
    r[4 * i + 1] = _mm512_unpackhi_epi64(a[4 * i + 0], a[4 * i + 2]);
    r[4 * i + 2] = _mm512_unpacklo_epi64(a[4 * i + 1], a[4 * i + 3]);
    r[4 * i + 3] = _mm512_unpackhi_epi64(a[4 * i + 1], a[4 * i + 3]);
  }
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 4; ++j) {
      a[8 * i + j] = _mm512_shuffle_i32x4(r[8 * i + j], r[8 * i + j + 4],
                                          0x88);
      a[8 * i + j + 4] = _mm512_shuffle_i32x4(r[8 * i + j],
                                              r[8 * i + j + 4], 0xdd);
    }
  for (int j = 0; j < 8; ++j) {
    r[j] = _mm512_shuffle_i32x4(a[j], a[j + 8], 0x88);
    r[j + 8] = _mm512_shuffle_i32x4(a[j], a[j + 8], 0xdd);
  }
  // rows 16..19: gather each column's tail 4 u32 into segs[col & 3] at
  // offset (col >> 2) * 4 via two unpack stages
  const __m512i t16 = _mm512_loadu_si512((const void*)(tile + 16 * 16));
  const __m512i t17 = _mm512_loadu_si512((const void*)(tile + 17 * 16));
  const __m512i t18 = _mm512_loadu_si512((const void*)(tile + 18 * 16));
  const __m512i t19 = _mm512_loadu_si512((const void*)(tile + 19 * 16));
  const __m512i u0 = _mm512_unpacklo_epi32(t16, t17);
  const __m512i u1 = _mm512_unpackhi_epi32(t16, t17);
  const __m512i v0 = _mm512_unpacklo_epi32(t18, t19);
  const __m512i v1 = _mm512_unpackhi_epi32(t18, t19);
  alignas(64) uint32_t segs[4][16];
  _mm512_store_si512((void*)segs[0], _mm512_unpacklo_epi64(u0, v0));
  _mm512_store_si512((void*)segs[1], _mm512_unpackhi_epi64(u0, v0));
  _mm512_store_si512((void*)segs[2], _mm512_unpacklo_epi64(u1, v1));
  _mm512_store_si512((void*)segs[3], _mm512_unpackhi_epi64(u1, v1));
  for (int col = 0; col < 16; ++col) {
    int16_t* o = dst[col];
    _mm512_storeu_si512((void*)o, r[col]);
    _mm_storeu_si128((__m128i*)(o + 32),
                     _mm_loadu_si128((const __m128i*)(
                         segs[col & 3] + (col >> 2) * 4)));
  }
}

// Mono variant of tile_store_stereo: the same 16-lane u32 transpose
// (one u32 column = a PAIR of mono frames), then two vpermi2w per pair
// de-interleave the even/odd int16 lanes (+ the 8-int16 tail segment)
// into the two 20-sample frame rows, stored with 20-lane masked stores.
// Measured 2.04x the decode+interleave pair at the mono fixture shape
// (experiments/cpp_decode_mono_fused.py), bit-exact on fixture-mono +
// adversarial random-word streams.
__attribute__((always_inline)) inline void tile_store_mono(
    const uint32_t* tile /* [20][16] */, int16_t* const* dst /* [32] */) {
  __m512i r[16];
  for (int i = 0; i < 16; ++i)
    r[i] = _mm512_loadu_si512((const void*)(tile + i * 16));
  __m512i a[16];
  for (int i = 0; i < 8; ++i) {
    a[2 * i] = _mm512_unpacklo_epi32(r[2 * i], r[2 * i + 1]);
    a[2 * i + 1] = _mm512_unpackhi_epi32(r[2 * i], r[2 * i + 1]);
  }
  for (int i = 0; i < 4; ++i) {
    r[4 * i + 0] = _mm512_unpacklo_epi64(a[4 * i + 0], a[4 * i + 2]);
    r[4 * i + 1] = _mm512_unpackhi_epi64(a[4 * i + 0], a[4 * i + 2]);
    r[4 * i + 2] = _mm512_unpacklo_epi64(a[4 * i + 1], a[4 * i + 3]);
    r[4 * i + 3] = _mm512_unpackhi_epi64(a[4 * i + 1], a[4 * i + 3]);
  }
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 4; ++j) {
      a[8 * i + j] = _mm512_shuffle_i32x4(r[8 * i + j], r[8 * i + j + 4],
                                          0x88);
      a[8 * i + j + 4] = _mm512_shuffle_i32x4(r[8 * i + j],
                                              r[8 * i + j + 4], 0xdd);
    }
  for (int j = 0; j < 8; ++j) {
    r[j] = _mm512_shuffle_i32x4(a[j], a[j + 8], 0x88);
    r[j + 8] = _mm512_shuffle_i32x4(a[j], a[j + 8], 0xdd);
  }
  const __m512i t16 = _mm512_loadu_si512((const void*)(tile + 16 * 16));
  const __m512i t17 = _mm512_loadu_si512((const void*)(tile + 17 * 16));
  const __m512i t18 = _mm512_loadu_si512((const void*)(tile + 18 * 16));
  const __m512i t19 = _mm512_loadu_si512((const void*)(tile + 19 * 16));
  const __m512i u0 = _mm512_unpacklo_epi32(t16, t17);
  const __m512i u1 = _mm512_unpackhi_epi32(t16, t17);
  const __m512i v0 = _mm512_unpacklo_epi32(t18, t19);
  const __m512i v1 = _mm512_unpackhi_epi32(t18, t19);
  alignas(64) uint32_t segs[4][16];
  _mm512_store_si512((void*)segs[0], _mm512_unpacklo_epi64(u0, v0));
  _mm512_store_si512((void*)segs[1], _mm512_unpackhi_epi64(u0, v0));
  _mm512_store_si512((void*)segs[2], _mm512_unpacklo_epi64(u1, v1));
  _mm512_store_si512((void*)segs[3], _mm512_unpackhi_epi64(u1, v1));
  // de-interleave each frame pair: even int16 lanes of r[k] (+ even tail
  // lanes) = frame 2k, odd = frame 2k+1
  const __m512i kEven = _mm512_set_epi16(
      0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
      32 + 6, 32 + 4, 32 + 2, 32 + 0,
      30, 28, 26, 24, 22, 20, 18, 16, 14, 12, 10, 8, 6, 4, 2, 0);
  const __m512i kOdd = _mm512_set_epi16(
      0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
      32 + 7, 32 + 5, 32 + 3, 32 + 1,
      31, 29, 27, 25, 23, 21, 19, 17, 15, 13, 11, 9, 7, 5, 3, 1);
  const __mmask32 k20 = (1u << 20) - 1;
  for (int k = 0; k < 16; ++k) {
    // column k's 128-bit tail (steps 16..19 of the frame pair) sits at
    // offset (k >> 2) * 4 u32 inside segs[k & 3]
    const __m512i tl = _mm512_castsi128_si512(
        _mm_load_si128((const __m128i*)(segs[k & 3] + (k >> 2) * 4)));
    _mm512_mask_storeu_epi16(
        (void*)dst[2 * k], k20, _mm512_permutex2var_epi16(r[k], kEven, tl));
    _mm512_mask_storeu_epi16(
        (void*)dst[2 * k + 1], k20,
        _mm512_permutex2var_epi16(r[k], kOdd, tl));
  }
}

// One 32-chain block (columns g..g+31, i.e. stereo frames f_base..+15)
// across all W windows, stored interleaved: frame f's window w lands at
// out + f * frame_stride + w * 40 (frame_stride in int16 elements).
static void decode_interleaved_block32_stereo(
    const uint64_t* words_be, const int32_t* st, int64_t W, int64_t N,
    int64_t g, int64_t frame_stride, int64_t f_base, int16_t* out) {
  alignas(64) int16_t tile[20 * 32];
  DecGroup A, B;
  dec_load_state(A, st, N, g);
  dec_load_state(B, st, N, g + 16);
  for (int64_t w = 0; w < W; ++w) {
    const uint64_t* row = words_be + w * N + g;
    dec_load_window(A, row);
    dec_load_window(B, row + 16);
#define QOA_DSTEP(K)                      \
  dec_step<K>(A, tile + (int64_t)K * 32); \
  dec_step<K>(B, tile + (int64_t)K * 32 + 16)
    QOA_DSTEP(0); QOA_DSTEP(1); QOA_DSTEP(2); QOA_DSTEP(3); QOA_DSTEP(4);
    QOA_DSTEP(5); QOA_DSTEP(6); QOA_DSTEP(7); QOA_DSTEP(8); QOA_DSTEP(9);
    QOA_DSTEP(10); QOA_DSTEP(11); QOA_DSTEP(12); QOA_DSTEP(13);
    QOA_DSTEP(14); QOA_DSTEP(15); QOA_DSTEP(16); QOA_DSTEP(17);
    QOA_DSTEP(18); QOA_DSTEP(19);
#undef QOA_DSTEP
    int16_t* dst[16];
    for (int j = 0; j < 16; ++j)
      dst[j] = out + (f_base + j) * frame_stride + w * (2 * kSliceLen);
    tile_store_stereo(reinterpret_cast<const uint32_t*>(tile), dst);
  }
}

// ---------------------------------------------------------------------------
// Raw-bytes fused stereo decode: read slice words AND LMS straight from
// the frame-major FILE bytes — no chain-cube staging at all.
//
// In the frame layout the two channels of window w are ADJACENT u64s
// (one slice per channel per window, reference src/lib.rs:468-491), so a
// 16-chain group (8 stereo frames) assembles its two word vectors with
// 8x128-bit loads + 6 inserts (~12 ops against ~680 compute ops per
// window-group); LMS state loads once per 16-frame block with a scalar
// gather.  This deletes the host parse gather (~0.7 ms at the fixture =
// ~25% of decode_all e2e) plus the word cube's DRAM round trip.
// Measured 1.44-1.54x the parse+array-kernel pipeline
// (experiments/cpp_decode_raw.py), bit-exact on fixture + adversarial
// wrap-regime streams.
// ---------------------------------------------------------------------------
#ifdef QOA_FUSED_DECODE
namespace {

// Finish a raw window load: two 8-u64 raw big-endian word vectors
// (chains 0-7 / 8-15 of the group) -> DecGroup word planes exactly like
// dec_load_window (bswap + half-plane split + magnitude gather).
__attribute__((always_inline)) inline void dec_finish_window_bytes(
    DecGroup& G, __m512i a, __m512i b) {
  a = bswap64x8(a);
  b = bswap64x8(b);
  const __m512i kLo = _mm512_set_epi32(30, 28, 26, 24, 22, 20, 18, 16,
                                       14, 12, 10, 8, 6, 4, 2, 0);
  const __m512i kHi = _mm512_set_epi32(31, 29, 27, 25, 23, 21, 19, 17,
                                       15, 13, 11, 9, 7, 5, 3, 1);
  G.wlo = _mm512_permutex2var_epi32(a, kLo, b);
  G.whi = _mm512_permutex2var_epi32(a, kHi, b);
  const __m512i sf = _mm512_srli_epi32(G.whi, 28);
  G.m0 = _mm512_permutexvar_epi32(sf, (__m512i)kMag0V);
  G.m1 = _mm512_permutexvar_epi32(sf, (__m512i)kMag1V);
  G.m2 = _mm512_permutexvar_epi32(sf, (__m512i)kMag2V);
  G.m3 = _mm512_permutexvar_epi32(sf, (__m512i)kMag3V);
}

// Gather 8 frames' 16 contiguous bytes at base + j*fstride into one vector.
__attribute__((always_inline)) inline void raw_load_8x128(
    __m512i& a, __m512i& b, const uint8_t* base, int64_t fstride) {
  a = _mm512_castsi128_si512(_mm_loadu_si128((const __m128i*)base));
  a = _mm512_inserti32x4(
      a, _mm_loadu_si128((const __m128i*)(base + fstride)), 1);
  a = _mm512_inserti32x4(
      a, _mm_loadu_si128((const __m128i*)(base + 2 * fstride)), 2);
  a = _mm512_inserti32x4(
      a, _mm_loadu_si128((const __m128i*)(base + 3 * fstride)), 3);
  b = _mm512_castsi128_si512(
      _mm_loadu_si128((const __m128i*)(base + 4 * fstride)));
  b = _mm512_inserti32x4(
      b, _mm_loadu_si128((const __m128i*)(base + 5 * fstride)), 1);
  b = _mm512_inserti32x4(
      b, _mm_loadu_si128((const __m128i*)(base + 6 * fstride)), 2);
  b = _mm512_inserti32x4(
      b, _mm_loadu_si128((const __m128i*)(base + 7 * fstride)), 3);
}

// Merge 8 stereo frames' (window-w, both-channels) u64 pairs straight
// into the group's word planes.
__attribute__((always_inline)) inline void dec_load_window_raw(
    DecGroup& G, const uint8_t* base, int64_t fstride) {
  __m512i a, b;
  raw_load_8x128(a, b, base, fstride);
  dec_finish_window_bytes(G, a, b);
}

// Mono sibling: 16 frames x (window w, window w+1) u64 pairs -> the
// even/odd window word vectors for one 16-chain group (two windows per
// load round; mono windows of one frame are ADJACENT u64s, so the
// 128-bit loads cover two sequential windows instead of two channels).
__attribute__((always_inline)) inline void dec_load_wpair_raw_mono(
    __m512i& e_lo, __m512i& e_hi, __m512i& o_lo, __m512i& o_hi,
    const uint8_t* base, int64_t fstride) {
  __m512i a, b, c, d;
  raw_load_8x128(a, b, base, fstride);
  raw_load_8x128(c, d, base + 8 * fstride, fstride);
  const __m512i kE = _mm512_set_epi64(14, 12, 10, 8, 6, 4, 2, 0);
  const __m512i kO = _mm512_set_epi64(15, 13, 11, 9, 7, 5, 3, 1);
  e_lo = _mm512_permutex2var_epi64(a, kE, b);
  o_lo = _mm512_permutex2var_epi64(a, kO, b);
  e_hi = _mm512_permutex2var_epi64(c, kE, d);
  o_hi = _mm512_permutex2var_epi64(c, kO, d);
}

// One 16-frame block straight from frame bytes: scalar LMS gather once
// (256 ops per ~164k decoded samples — noise), then the fused per-window
// decode + in-register transpose store.
static void decode_raw_block16f_stereo(const uint8_t* frames,
                                       int64_t fstride, int64_t W,
                                       int64_t out_stride, int16_t* out) {
  alignas(64) int32_t st[8 * 32];
  for (int j = 0; j < 16; ++j) {
    const uint8_t* p = frames + j * fstride + 8;
    for (int c = 0; c < 2; ++c)
      for (int r = 0; r < 4; ++r) {
        const uint8_t* h = p + c * 16 + 2 * r;
        const uint8_t* wt = p + c * 16 + 8 + 2 * r;
        st[r * 32 + 2 * j + c] =
            (int32_t)(int16_t)((uint16_t(h[0]) << 8) | h[1]);
        st[(4 + r) * 32 + 2 * j + c] =
            (int32_t)(int16_t)((uint16_t(wt[0]) << 8) | wt[1]);
      }
  }
  DecGroup A, B;
  dec_load_state(A, st, 32, 0);
  dec_load_state(B, st, 32, 16);
  alignas(64) int16_t tile[20 * 32];
  const uint8_t* wbase = frames + 8 + 32;  // frame header u64 + 2x16B LMS
  for (int64_t w = 0; w < W; ++w) {
    const uint8_t* rowp = wbase + w * 16;
    dec_load_window_raw(A, rowp, fstride);
    dec_load_window_raw(B, rowp + 8 * fstride, fstride);
#define QOA_DSTEP(K)                      \
  dec_step<K>(A, tile + (int64_t)K * 32); \
  dec_step<K>(B, tile + (int64_t)K * 32 + 16)
    QOA_DSTEP(0); QOA_DSTEP(1); QOA_DSTEP(2); QOA_DSTEP(3); QOA_DSTEP(4);
    QOA_DSTEP(5); QOA_DSTEP(6); QOA_DSTEP(7); QOA_DSTEP(8); QOA_DSTEP(9);
    QOA_DSTEP(10); QOA_DSTEP(11); QOA_DSTEP(12); QOA_DSTEP(13);
    QOA_DSTEP(14); QOA_DSTEP(15); QOA_DSTEP(16); QOA_DSTEP(17);
    QOA_DSTEP(18); QOA_DSTEP(19);
#undef QOA_DSTEP
    int16_t* dst[16];
    for (int j = 0; j < 16; ++j)
      dst[j] = out + j * out_stride + w * 40;
    tile_store_stereo(reinterpret_cast<const uint32_t*>(tile), dst);
  }
}

// Mono raw block: 32 mono frames straight from frame bytes.  Windows
// decode two per load round (see dec_load_wpair_raw_mono); an odd final
// window re-loads the last pair and uses its odd half, so the caller
// must guarantee W >= 2 (the entry routes W < 2 through the gather
// path).  Loads never touch bytes outside the 32 frames.
static void decode_raw_block32f_mono(const uint8_t* frames, int64_t fstride,
                                     int64_t W, int64_t out_stride,
                                     int16_t* out) {
  alignas(64) int32_t st[8 * 32];
  for (int j = 0; j < 32; ++j) {
    const uint8_t* p = frames + j * fstride + 8;
    for (int r = 0; r < 4; ++r) {
      const uint8_t* h = p + 2 * r;
      const uint8_t* wt = p + 8 + 2 * r;
      st[r * 32 + j] = (int32_t)(int16_t)((uint16_t(h[0]) << 8) | h[1]);
      st[(4 + r) * 32 + j] =
          (int32_t)(int16_t)((uint16_t(wt[0]) << 8) | wt[1]);
    }
  }
  DecGroup A, B;
  dec_load_state(A, st, 32, 0);
  dec_load_state(B, st, 32, 16);
  alignas(64) int16_t tile[20 * 32];
  const uint8_t* wbase = frames + 8 + 16;  // frame header u64 + 1x16B LMS

#define QOA_DSTEP(K)                      \
  dec_step<K>(A, tile + (int64_t)K * 32); \
  dec_step<K>(B, tile + (int64_t)K * 32 + 16)
#define QOA_MONO_WINDOW(WIN)                                        \
  do {                                                              \
    QOA_DSTEP(0); QOA_DSTEP(1); QOA_DSTEP(2); QOA_DSTEP(3);         \
    QOA_DSTEP(4); QOA_DSTEP(5); QOA_DSTEP(6); QOA_DSTEP(7);         \
    QOA_DSTEP(8); QOA_DSTEP(9); QOA_DSTEP(10); QOA_DSTEP(11);       \
    QOA_DSTEP(12); QOA_DSTEP(13); QOA_DSTEP(14); QOA_DSTEP(15);     \
    QOA_DSTEP(16); QOA_DSTEP(17); QOA_DSTEP(18); QOA_DSTEP(19);     \
    int16_t* dst[32];                                               \
    for (int j = 0; j < 32; ++j)                                    \
      dst[j] = out + j * out_stride + (WIN)*kSliceLen;              \
    tile_store_mono(reinterpret_cast<const uint32_t*>(tile), dst);  \
  } while (0)

  int64_t w = 0;
  __m512i ael, aeh, aol, aoh, bel, beh, bol, boh;
  for (; w + 1 < W; w += 2) {
    const uint8_t* rowp = wbase + w * 8;
    dec_load_wpair_raw_mono(ael, aeh, aol, aoh, rowp, fstride);
    dec_load_wpair_raw_mono(bel, beh, bol, boh, rowp + 16 * fstride,
                            fstride);
    dec_finish_window_bytes(A, ael, aeh);
    dec_finish_window_bytes(B, bel, beh);
    QOA_MONO_WINDOW(w);
    dec_finish_window_bytes(A, aol, aoh);
    dec_finish_window_bytes(B, bol, boh);
    QOA_MONO_WINDOW(w + 1);
  }
  if (w < W) {  // odd W: reuse the (W-2, W-1) pair's odd half
    const uint8_t* rowp = wbase + (w - 1) * 8;
    dec_load_wpair_raw_mono(ael, aeh, aol, aoh, rowp, fstride);
    dec_load_wpair_raw_mono(bel, beh, bol, boh, rowp + 16 * fstride,
                            fstride);
    dec_finish_window_bytes(A, aol, aoh);
    dec_finish_window_bytes(B, bol, boh);
    QOA_MONO_WINDOW(w);
  }
#undef QOA_MONO_WINDOW
#undef QOA_DSTEP
}

}  // namespace
#endif  // QOA_FUSED_DECODE

// Mono sibling: one 32-chain block = mono frames g..g+31; frame f's
// window w lands at out + f * frame_stride + w * 20.
static void decode_interleaved_block32_mono(
    const uint64_t* words_be, const int32_t* st, int64_t W, int64_t N,
    int64_t g, int64_t frame_stride, int64_t f_base, int16_t* out) {
  alignas(64) int16_t tile[20 * 32];
  DecGroup A, B;
  dec_load_state(A, st, N, g);
  dec_load_state(B, st, N, g + 16);
  for (int64_t w = 0; w < W; ++w) {
    const uint64_t* row = words_be + w * N + g;
    dec_load_window(A, row);
    dec_load_window(B, row + 16);
#define QOA_DSTEP(K)                      \
  dec_step<K>(A, tile + (int64_t)K * 32); \
  dec_step<K>(B, tile + (int64_t)K * 32 + 16)
    QOA_DSTEP(0); QOA_DSTEP(1); QOA_DSTEP(2); QOA_DSTEP(3); QOA_DSTEP(4);
    QOA_DSTEP(5); QOA_DSTEP(6); QOA_DSTEP(7); QOA_DSTEP(8); QOA_DSTEP(9);
    QOA_DSTEP(10); QOA_DSTEP(11); QOA_DSTEP(12); QOA_DSTEP(13);
    QOA_DSTEP(14); QOA_DSTEP(15); QOA_DSTEP(16); QOA_DSTEP(17);
    QOA_DSTEP(18); QOA_DSTEP(19);
#undef QOA_DSTEP
    int16_t* dst[32];
    for (int j = 0; j < 32; ++j)
      dst[j] = out + (f_base + j) * frame_stride + w * kSliceLen;
    tile_store_mono(reinterpret_cast<const uint32_t*>(tile), dst);
  }
}
#endif  // QOA_FUSED_DECODE

// ---------------------------------------------------------------------------
// Cache-blocked transpose with tail trim: chains (t, f) -> frames (f, t).
// One "element" is a whole C-channel sample group (2C bytes), so E is
// uint16/uint32/uint64/16-byte for C = 1/2/4/8.
// ---------------------------------------------------------------------------
struct alignas(4) E16 {
  uint64_t a, b;
};

template <typename E>
static void transpose_trim(const E* __restrict__ in, int64_t rows, int64_t F,
                           int64_t total, E* __restrict__ out) {
  constexpr int64_t B = 64;
  for (int64_t t0 = 0; t0 < rows; t0 += B) {
    const int64_t t1 = t0 + B < rows ? t0 + B : rows;
    for (int64_t f = 0; f < F; ++f) {
      const int64_t left = total - f * rows;  // valid samples this frame
      if (left <= t0) continue;
      const int64_t te = t1 < left ? t1 : left;
      E* __restrict__ dst = out + f * rows;
      const E* __restrict__ src = in + f;
      for (int64_t t = t0; t < te; ++t) dst[t] = src[t * F];
    }
  }
}

// scalar fallback for C not in {1, 2, 4, 8}
static void transpose_trim_generic(const int16_t* in, int64_t rows, int64_t F,
                                   int64_t C, int64_t total, int16_t* out) {
  for (int64_t f = 0; f < F; ++f) {
    const int64_t left = total - f * rows;
    const int64_t te = rows < left ? rows : left;
    int16_t* dst = out + f * rows * C;
    const int16_t* src = in + f * C;
    for (int64_t t = 0; t < te; ++t)
      for (int64_t c = 0; c < C; ++c) dst[t * C + c] = src[t * F * C + c];
  }
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Gather a uniform fixed-mode stream's frames into chain-vector arrays.
//
//   data+offset: first frame; F_full uniform frames of frame_bytes each,
//   every one W0 windows x C channels (validated by the caller's
//   arithmetic parse).  Fills words_be (W, N) raw big-endian (columns
//   beyond F_full*C and rows beyond W0 left untouched — caller zeroes)
//   and state (8, N) int32 (sign-extended i16 history/weights).
// ---------------------------------------------------------------------------
void qoa_gather_frames(const uint8_t* data, int64_t offset, int64_t F_full,
                       int64_t frame_bytes, int64_t C, int64_t W0, int64_t W,
                       int64_t N, uint64_t* words_be, int32_t* state) {
  for (int64_t f = 0; f < F_full; ++f) {
    const uint8_t* p = data + offset + f * frame_bytes + 8;
    // LMS: per channel one u64 of history + one u64 of weights (big-endian
    // groups of 4 x i16)
    for (int64_t c = 0; c < C; ++c) {
      const int64_t n = f * C + c;
      for (int r = 0; r < 4; ++r) {
        const uint8_t* h = p + c * 16 + 2 * r;
        const uint8_t* wt = p + c * 16 + 8 + 2 * r;
        state[(0 + r) * N + n] =
            (int32_t)(int16_t)((uint16_t(h[0]) << 8) | h[1]);
        state[(4 + r) * N + n] =
            (int32_t)(int16_t)((uint16_t(wt[0]) << 8) | wt[1]);
      }
    }
    // slice words: frame layout (W0, C) -> chain layout (W, N)
    const uint64_t* sw = reinterpret_cast<const uint64_t*>(p + 16 * C);
    for (int64_t w = 0; w < W0; ++w)
      for (int64_t c = 0; c < C; ++c)
        words_be[w * N + f * C + c] = sw[w * C + c];
  }
}

// ---------------------------------------------------------------------------
// Decode: N independent chains, vectorized ACROSS the chain axis.
//
//   words_be: (W, N) big-endian u64 slice words (word of chain n, window w
//             at words_be[w*N + n]); padded windows must be 0.
//   state:    (8, N) int32 — rows 0-3 history, rows 4-7 weights (frame-
//             start LMS snapshots, one per chain).
//   out:      (W, 20, N) int16 — all 20 samples of every window (callers
//             trim short tails, like the reference src/lib.rs:320-328).
//
// Dispatch: the register-resident fused AVX-512 path when compiled in and
// N is wide enough to fill 32-chain blocks (ragged tails pad into a
// 32-column scratch); otherwise the plane path below — which is also the
// portable fallback for non-AVX-512 builds (-O2 build tier) and cheaper
// for the narrow-N streaming groups.
// ---------------------------------------------------------------------------
static void decode_chains_planes(const uint64_t* words_be,
                                 const int32_t* state, int64_t W, int64_t N,
                                 int16_t* out) {
  int32_t* buf = new int32_t[14 * N];
  int32_t* H0 = buf + 0 * N;
  int32_t* H1 = buf + 1 * N;
  int32_t* H2 = buf + 2 * N;
  int32_t* H3 = buf + 3 * N;
  int32_t* W0 = buf + 4 * N;
  int32_t* W1 = buf + 5 * N;
  int32_t* W2 = buf + 6 * N;
  int32_t* W3 = buf + 7 * N;
  int32_t* m0 = buf + 8 * N;
  int32_t* m1 = buf + 9 * N;
  int32_t* m2 = buf + 10 * N;
  int32_t* m3 = buf + 11 * N;
  uint32_t* whi = reinterpret_cast<uint32_t*>(buf + 12 * N);
  uint32_t* wlo = reinterpret_cast<uint32_t*>(buf + 13 * N);
  std::memcpy(buf, state, sizeof(int32_t) * 8 * N);

  for (int64_t w = 0; w < W; ++w) {
    const uint64_t* row = words_be + w * N;
    // u64 word -> u32 half planes + the per-window dequant magnitudes
    for (int64_t n = 0; n < N; ++n) {
      uint64_t v = bswap64(row[n]);
      whi[n] = static_cast<uint32_t>(v >> 32);
      wlo[n] = static_cast<uint32_t>(v);
      int32_t sfv = kSfTab[v >> 60];
      m0[n] = mag0(sfv);
      m1[n] = mag1(sfv);
      m2[n] = mag2(sfv);
      m3[n] = mag3(sfv);
    }
#define QOA_STEP(K)                                                         \
  decode_lane_step<K>(N, whi, wlo, m0, m1, m2, m3, H0, H1, H2, H3, W0, W1, \
                      W2, W3, out + (w * kSliceLen + K) * N)
    QOA_STEP(0); QOA_STEP(1); QOA_STEP(2); QOA_STEP(3); QOA_STEP(4);
    QOA_STEP(5); QOA_STEP(6); QOA_STEP(7); QOA_STEP(8); QOA_STEP(9);
    QOA_STEP(10); QOA_STEP(11); QOA_STEP(12); QOA_STEP(13); QOA_STEP(14);
    QOA_STEP(15); QOA_STEP(16); QOA_STEP(17); QOA_STEP(18); QOA_STEP(19);
#undef QOA_STEP
  }
  delete[] buf;
}

void qoa_decode_chains(const uint64_t* words_be, const int32_t* state,
                       int64_t W, int64_t N, int16_t* out) {
#ifdef QOA_FUSED_DECODE
  if (N >= 32) {
    const int64_t Nb = N & ~int64_t{31};
    for (int64_t g = 0; g < Nb; g += 32)
      decode_fused_block32(words_be, state, W, N, g, out);
    const int64_t t = N - Nb;
    if (t) {
      // Ragged tail: pad to one 32-column block in a scratch.  Padded
      // columns decode zero words from zero state — ordinary (wrapping)
      // arithmetic, results discarded.
      uint64_t* wtail = new uint64_t[W * 32]();
      int16_t* otail = new int16_t[W * kSliceLen * 32];
      int32_t sttail[8 * 32] = {};
      for (int64_t w = 0; w < W; ++w)
        std::memcpy(wtail + w * 32, words_be + w * N + Nb,
                    sizeof(uint64_t) * t);
      for (int r = 0; r < 8; ++r)
        std::memcpy(sttail + r * 32, state + r * N + Nb, sizeof(int32_t) * t);
      decode_fused_block32(wtail, sttail, W, 32, 0, otail);
      for (int64_t i = 0; i < W * kSliceLen; ++i)
        std::memcpy(out + i * N + Nb, otail + i * 32, sizeof(int16_t) * t);
      delete[] wtail;
      delete[] otail;
    }
    return;
  }
#endif
  decode_chains_planes(words_be, state, W, N, out);
}

// ---------------------------------------------------------------------------
// Transpose decoded chains to interleaved, TRIMMED PCM.
//
//   in:    (W, 20, N) int16 with N = F*C (chain n = frame f, channel c)
//   total: total valid samples per channel (every frame is full except
//          possibly the last — the fixed-mode layout)
//   out:   (total, C) int16 interleaved PCM
//
// Cache-blocked: the naive frame-major walk strides F*C*2 bytes per read
// (a fresh cache line per sample); blocking on the time axis reuses lines.
// ---------------------------------------------------------------------------
void qoa_interleave(const int16_t* in, int64_t W, int64_t F, int64_t C,
                    int64_t total, int16_t* out) {
  const int64_t rows = W * kSliceLen;  // samples per (full) frame
  switch (C) {
    case 1:
      transpose_trim(reinterpret_cast<const uint16_t*>(in), rows, F, total,
                     reinterpret_cast<uint16_t*>(out));
      break;
    case 2:
      transpose_trim(reinterpret_cast<const uint32_t*>(in), rows, F, total,
                     reinterpret_cast<uint32_t*>(out));
      break;
    case 4:
      transpose_trim(reinterpret_cast<const uint64_t*>(in), rows, F, total,
                     reinterpret_cast<uint64_t*>(out));
      break;
    case 8:
      transpose_trim(reinterpret_cast<const E16*>(in), rows, F, total,
                     reinterpret_cast<E16*>(out));
      break;
    default:
      transpose_trim_generic(in, rows, F, C, total, out);
  }
}

// ---------------------------------------------------------------------------
// Fused decode + interleave for stereo streams (C == 2, N = 2F chains).
//
//   out: (F * W * 20, 2) int16 — frame f's FULL untrimmed samples at rows
//        f*W*20 .. (f+1)*W*20; identical layout/content to
//        qoa_interleave(qoa_decode_chains(...), W, F, 2, F*W*20, out).
//        Callers slice each frame's valid sample count (short tail frame,
//        non-window-aligned uniform spc) exactly as with the pair.
//
// AVX-512 builds run the register-resident fused path (1.9-2.2x the
// pair — see decode_interleaved_block32_stereo above); ragged tails
// (N % 32) pad into a scratch block whose valid frame rows memcpy out
// contiguously.  Non-AVX-512 build tiers and narrow N compose the pair
// internally so the symbol contract is uniform (the Python wrapper
// prefers the pair path there — qoa_has_fused_interleaved gates it).
// ---------------------------------------------------------------------------
void qoa_decode_interleaved_stereo(const uint64_t* words_be,
                                   const int32_t* state, int64_t W, int64_t N,
                                   int16_t* out) {
  const int64_t stride = W * kSliceLen * 2;  // int16 elements per frame
#ifdef QOA_FUSED_DECODE
  if (N >= 32) {
    const int64_t Nb = N & ~int64_t{31};
    for (int64_t g = 0; g < Nb; g += 32)
      decode_interleaved_block32_stereo(words_be, state, W, N, g, stride,
                                        g / 2, out);
    const int64_t t = N - Nb;  // even: N = 2F
    if (t) {
      uint64_t* wtail = new uint64_t[W * 32]();
      int32_t sttail[8 * 32] = {};
      int16_t* otail = new int16_t[16 * stride];
      for (int64_t w = 0; w < W; ++w)
        std::memcpy(wtail + w * 32, words_be + w * N + Nb,
                    sizeof(uint64_t) * t);
      for (int r = 0; r < 8; ++r)
        std::memcpy(sttail + r * 32, state + r * N + Nb, sizeof(int32_t) * t);
      decode_interleaved_block32_stereo(wtail, sttail, W, 32, 0, stride, 0,
                                        otail);
      std::memcpy(out + (Nb / 2) * stride, otail,
                  sizeof(int16_t) * (t / 2) * stride);
      delete[] wtail;
      delete[] otail;
    }
    return;
  }
#endif
  int16_t* tmp = new int16_t[W * kSliceLen * N];
  qoa_decode_chains(words_be, state, W, N, tmp);
  qoa_interleave(tmp, W, N / 2, 2, (N / 2) * W * kSliceLen, out);
  delete[] tmp;
}

// Mono sibling of qoa_decode_interleaved_stereo: N chains = N frames,
// out = (N * W * 20) int16 — frame f's FULL untrimmed samples at
// f*W*20..(f+1)*W*20.  Same tail/fallback structure.
void qoa_decode_interleaved_mono(const uint64_t* words_be,
                                 const int32_t* state, int64_t W, int64_t N,
                                 int16_t* out) {
  const int64_t stride = W * kSliceLen;  // int16 elements per frame
#ifdef QOA_FUSED_DECODE
  if (N >= 32) {
    const int64_t Nb = N & ~int64_t{31};
    for (int64_t g = 0; g < Nb; g += 32)
      decode_interleaved_block32_mono(words_be, state, W, N, g, stride, g,
                                      out);
    const int64_t t = N - Nb;
    if (t) {
      uint64_t* wtail = new uint64_t[W * 32]();
      int32_t sttail[8 * 32] = {};
      int16_t* otail = new int16_t[32 * stride];
      for (int64_t w = 0; w < W; ++w)
        std::memcpy(wtail + w * 32, words_be + w * N + Nb,
                    sizeof(uint64_t) * t);
      for (int r = 0; r < 8; ++r)
        std::memcpy(sttail + r * 32, state + r * N + Nb, sizeof(int32_t) * t);
      decode_interleaved_block32_mono(wtail, sttail, W, 32, 0, stride, 0,
                                      otail);
      std::memcpy(out + Nb * stride, otail, sizeof(int16_t) * t * stride);
      delete[] wtail;
      delete[] otail;
    }
    return;
  }
#endif
  int16_t* tmp = new int16_t[W * kSliceLen * N];
  qoa_decode_chains(words_be, state, W, N, tmp);
  qoa_interleave(tmp, W, N, 1, N * W * kSliceLen, out);
  delete[] tmp;
}

// ---------------------------------------------------------------------------
// Raw-bytes fused stereo decode entry.
//
//   data+offset: F_full UNIFORM full stereo frames of frame_bytes each,
//                W windows per frame (validated by the caller's header
//                scan; frame_bytes == 8 + 32 + W*16).
//   out: (F_full * W * 20, 2) int16 — full untrimmed frames, identical
//        to gathering the chains and running
//        qoa_decode_interleaved_stereo.  The short tail frame (if any)
//        is NOT covered here — callers decode it via the array kernel.
//
// AVX-512 builds read words + LMS straight from the file bytes (see
// decode_raw_block16f_stereo); the <16-frame remainder gathers into
// padded arrays and reuses the array kernel.  Non-AVX-512 tiers compose
// gather + array kernel for the whole range (uniform symbol contract;
// the Python wrapper prefers the staged pipeline there).
// ---------------------------------------------------------------------------
void qoa_decode_interleaved_stereo_raw(const uint8_t* data, int64_t offset,
                                       int64_t F_full, int64_t frame_bytes,
                                       int64_t W, int16_t* out) {
  const int64_t stride = W * kSliceLen * 2;
#ifdef QOA_FUSED_DECODE
  int64_t f = 0;
  for (; f + 16 <= F_full; f += 16)
    decode_raw_block16f_stereo(data + offset + f * frame_bytes, frame_bytes,
                               W, stride, out + f * stride);
  const int64_t rem = F_full - f;
  if (rem) {
    const int64_t n = rem * 2;
    uint64_t* wrem = new uint64_t[W * n];
    int32_t* strem = new int32_t[8 * n];
    qoa_gather_frames(data, offset + f * frame_bytes, rem, frame_bytes, 2, W,
                      W, n, wrem, strem);
    qoa_decode_interleaved_stereo(wrem, strem, W, n, out + f * stride);
    delete[] wrem;
    delete[] strem;
  }
#else
  const int64_t n = F_full * 2;
  uint64_t* wall = new uint64_t[W * n];
  int32_t* stall = new int32_t[8 * n];
  qoa_gather_frames(data, offset, F_full, frame_bytes, 2, W, W, n, wall,
                    stall);
  qoa_decode_interleaved_stereo(wall, stall, W, n, out);
  delete[] wall;
  delete[] stall;
#endif
}

// Mono sibling of qoa_decode_interleaved_stereo_raw: F_full uniform
// mono frames of frame_bytes == 8 + 16 + W*8 each; out is
// (F_full * W * 20,) int16.  W < 2 (single-window frames) and the
// <32-frame remainder route through the gather + array kernel; non-
// AVX-512 tiers compose gather + array kernel for the whole range.
void qoa_decode_interleaved_mono_raw(const uint8_t* data, int64_t offset,
                                     int64_t F_full, int64_t frame_bytes,
                                     int64_t W, int16_t* out) {
  const int64_t stride = W * kSliceLen;
#ifdef QOA_FUSED_DECODE
  int64_t f = 0;
  if (W >= 2)
    for (; f + 32 <= F_full; f += 32)
      decode_raw_block32f_mono(data + offset + f * frame_bytes, frame_bytes,
                               W, stride, out + f * stride);
  const int64_t rem = F_full - f;
  if (rem) {
    uint64_t* wrem = new uint64_t[W * rem];
    int32_t* strem = new int32_t[8 * rem];
    qoa_gather_frames(data, offset + f * frame_bytes, rem, frame_bytes, 1, W,
                      W, rem, wrem, strem);
    qoa_decode_interleaved_mono(wrem, strem, W, rem, out + f * stride);
    delete[] wrem;
    delete[] strem;
  }
#else
  uint64_t* wall = new uint64_t[W * F_full];
  int32_t* stall = new int32_t[8 * F_full];
  qoa_gather_frames(data, offset, F_full, frame_bytes, 1, W, W, F_full, wall,
                    stall);
  qoa_decode_interleaved_mono(wall, stall, W, F_full, out);
  delete[] wall;
  delete[] stall;
#endif
}

int64_t qoa_has_fused_interleaved(void) {
#ifdef QOA_FUSED_DECODE
  return 1;
#else
  return 0;
#endif
}

// ---------------------------------------------------------------------------
// Encode: all 16 scalefactor candidates evaluate as vector lanes, with a
// first-sample pruned continuation.  Bit-identical to the reference's
// sequential sorted-order early-exit search (SURVEY.md §3.3 proof):
// winner = lexicographic argmin (total_rank, first_rank, sf).
//
// Search structure (the vector analog of the reference's pruning):
//  1. sample 0 evaluates on all 16 lanes (one 512-bit step, exact
//     reciprocal quantizer);
//  2. PAIRWISE selection: of each (sf j, sf j+8) pair, the better
//     (first_rank, sf) survives — pure vector blends, no sorting.  The
//     eight survivors of a channel pair pack into one 512-bit vector and
//     continue through samples 1..len-1 on the THRESHOLD quantizer
//     (precomputed residual boundaries instead of the 10-cycle-latency
//     reciprocal multiply; lanes whose residual could wrap the reference
//     multiply flag the window for an exact full-16 re-evaluation);
//  3. a discarded lane s can only win if first_s <= best8_total (rank
//     accumulation is monotone); the qualifying few (~0.3/window on real
//     audio) evaluate SCALAR with early abandon against the exact bound.
//     Either way the result is exact.
// ---------------------------------------------------------------------------
}  // extern "C"

namespace {

int64_t g_fallback_count = 0;

// full-width (16 sf lanes) state for one channel
struct Full16 {
  v16i H0, H1, H2, H3, W0, W1, W2, W3;
  v16u rank_lo, rank_hi, word_hi, word_lo;
};

// One sample step on all 16 sf lanes.  k is the sample index within the
// window (word bit positions depend on it).
__attribute__((always_inline)) inline void step16(Full16& S, int32_t sample_s, int k) {
  const v16i kZero = vbroadcast(0);
  const v16i kOne = vbroadcast(1);
  const v16i sample = vbroadcast(sample_s);
  v16i p = (v16i)((v16u)S.W0 * (v16u)S.H0 + (v16u)S.W1 * (v16u)S.H1 +
                  (v16u)S.W2 * (v16u)S.H2 + (v16u)S.W3 * (v16u)S.H3) >> 13;
  v16i ssum = (v16i)((v16u)S.W0 * (v16u)S.W0 + (v16u)S.W1 * (v16u)S.W1 +
                     (v16u)S.W2 * (v16u)S.W2 + (v16u)S.W3 * (v16u)S.W3);
  v16i pen = (ssum >> 18) - 0x8FF;
  pen = pen < kZero ? kZero : pen;
  v16i residual = (v16i)((v16u)sample - (v16u)p);
  v16i nr = (v16i)((v16u)residual * (v16u)kRecipV + (1u << 15)) >> 16;
  // sign via arithmetic shifts: sign(v) = (v>>31) - ((-v)>>31).  Exact
  // here: residual is bounded by |sample| + |prediction| < 2^19 and nr by
  // 2^15, so neither can be INT_MIN (the only value the identity
  // mishandles).  Cheaper than comparison masks (no k-register round trip).
  v16i sgn_r = (residual >> 31) - ((kZero - residual) >> 31);
  v16i sgn_n = (nr >> 31) - ((kZero - nr) >> 31);
  v16i scaled = nr + sgn_r - sgn_n;
  scaled = (v16i)_mm512_max_epi32(
      _mm512_min_epi32((__m512i)scaled, (__m512i)vbroadcast(8)),
      (__m512i)vbroadcast(-8));
  v16i q = __builtin_shuffle(kQuantLo, kQuantHi, scaled + vbroadcast(8));
  v16i idx = q >> 1;
  v16i m01 = idx == kZero ? kMag0V : kMag1V;
  v16i m23 = idx == vbroadcast(2) ? kMag2V : kMag3V;
  v16i m = idx < vbroadcast(2) ? m01 : m23;
  v16i dq = (q & kOne) == kOne ? kZero - m : m;
  v16i r = (v16i)_mm512_max_epi32(
      _mm512_min_epi32((__m512i)(v16i)((v16u)p + (v16u)dq),
                       (__m512i)vbroadcast(32767)),
      (__m512i)vbroadcast(-32768));
  v16u err = (v16u)sample - (v16u)r;
  v16u err_sq = err * err;
  v16u pen_sq = (v16u)pen * (v16u)pen;
  v16u lo1 = S.rank_lo + err_sq;
  S.rank_hi -= (v16u)(lo1 < S.rank_lo);
  v16u lo2 = lo1 + pen_sq;
  S.rank_hi -= (v16u)(lo2 < lo1);
  S.rank_lo = lo2;
  v16u qa = (v16u)q;
  if (k <= 8) {
    S.word_hi |= qa << (25 - 3 * k);
  } else if (k == 9) {
    S.word_hi |= qa >> 2;
    S.word_lo |= (qa & 3) << 30;
  } else {
    S.word_lo |= qa << (57 - 3 * k);
  }
  v16i d = dq >> 4;
  v16i nd = kZero - d;
  S.W0 = (v16i)((v16u)S.W0 + (v16u)(S.H0 < kZero ? nd : d));
  S.W1 = (v16i)((v16u)S.W1 + (v16u)(S.H1 < kZero ? nd : d));
  S.W2 = (v16i)((v16u)S.W2 + (v16u)(S.H2 < kZero ? nd : d));
  S.W3 = (v16i)((v16u)S.W3 + (v16u)(S.H3 < kZero ? nd : d));
  S.H0 = S.H1;
  S.H1 = S.H2;
  S.H2 = S.H3;
  S.H3 = r;
}

// Continuation state: the top-8 surviving scalefactor candidates of TWO
// channels packed into ONE full-width vector (lanes 0-7 = channel a,
// lanes 8-15 = channel b), with per-lane gathered constants.  Full-width
// fused packing measured FASTER than one 256-bit chain per channel: two
// independent 17-vector register chains exceed the 32-register file and
// the spill traffic costs more than the exposed ILP buys.
//
// The quantizer here is the THRESHOLD form: the reference's
// reciprocal-multiply (a second 10-cycle vpmulld on the step's critical
// path) is replaced by comparing the residual against per-scalefactor
// precomputed level boundaries — exact wherever the reference's wrapping
// multiply does not wrap (|residual| <= kWrapLim[sf]).  Wrap-risk lanes
// (~0.6% of windows on real music) set a flag and the whole window
// re-evaluates on the exact full-16 path.
// History/weights live PACKED as 16-bit pairs per 32-bit lane —
// HA = (H0, H1), HB = (H2, H3), likewise WA/WB — so the prediction dot and
// the weight-penalty sum are two vpmaddwd each (latency 5) instead of four
// 10-cycle vpmulld on the step's critical path.  History is always i16
// (reconstructions are clamped); weights are i16 on all real audio
// (measured: zero overflows across the fixture) and a saturating-add
// comparison flags any lane whose weight leaves i16 for the exact
// full-16 fallback (adversarial wrap regimes).
//
// The step is bound by instruction throughput, not by latency: its serial recurrence
// is ~24 cycles but GCC's vector-extension codegen emitted ~93
// instructions/step (~40+ cycles at two 512-bit ALU ports), materializing
// every compare as a -1/0 vector and every select as xor/sub chains.  The
// body therefore uses AVX-512 MASK-REGISTER forms directly — masked
// add/sub fuses each (materialize, combine) pair, the r clamp is forced
// to vpminsd/vpmaxsd (GCC compiled the ?: idiom here, unlike the decoder's
// identical source, to a 9-cycle compare+blend chain), and the wrap flags
// accumulate in k-registers folded once per window — measured +16% encode
// throughput, bit-exact (experiments/cpp_step_opcount.py).

struct Cont16 {
  v16i HA, HB, WA, WB;          // packed (H0,H1) (H2,H3) (W0,W1) (W2,W3)
  v16i M0, D1, D2, D3;          // mag0 and successive mag deltas
  v16i T2P, T4P, T6P;           // residual >= Tk  => scaled >= k  (r > 0)
  v16i T2N, T4N, T6N;           // residual <= Tk  => scaled <= -k (r < 0)
  v16i WLIM;                    // |residual| > WLIM => wrap risk
  v16u rank_lo, rank_hi, word_hi, word_lo;
};

typedef char v64b __attribute__((vector_size(64)));

__attribute__((always_inline)) inline void step16g(Cont16& S, v16i sample,
                                                   int k, __mmask16& wlim,
                                                   __mmask32& wovfA,
                                                   __mmask32& wovfB) {
  const __m512i z = _mm512_setzero_si512();
  const __m512i HA = (__m512i)S.HA, HB = (__m512i)S.HB;
  const __m512i WA = (__m512i)S.WA, WB = (__m512i)S.WB;
  __m512i p = _mm512_srai_epi32(
      _mm512_add_epi32(_mm512_madd_epi16(WA, HA), _mm512_madd_epi16(WB, HB)),
      13);
  __m512i pen = _mm512_max_epi32(
      _mm512_sub_epi32(
          _mm512_srai_epi32(_mm512_add_epi32(_mm512_madd_epi16(WA, WA),
                                             _mm512_madd_epi16(WB, WB)),
                            18),
          _mm512_set1_epi32(0x8FF)),
      z);
  __m512i residual = _mm512_sub_epi32((__m512i)sample, p);
  __mmask16 kneg = _mm512_cmplt_epi32_mask(residual, z);
  __mmask16 c2 = _mm512_cmple_epi32_mask((__m512i)S.T2P, residual) |
                 _mm512_cmple_epi32_mask(residual, (__m512i)S.T2N);
  __mmask16 c4 = _mm512_cmple_epi32_mask((__m512i)S.T4P, residual) |
                 _mm512_cmple_epi32_mask(residual, (__m512i)S.T4N);
  __mmask16 c6 = _mm512_cmple_epi32_mask((__m512i)S.T6P, residual) |
                 _mm512_cmple_epi32_mask(residual, (__m512i)S.T6N);
  wlim |= _mm512_cmp_epi32_mask(_mm512_abs_epi32(residual),
                                (__m512i)S.WLIM, _MM_CMPINT_NLE);
  __m512i m = _mm512_mask_add_epi32((__m512i)S.M0, c2, (__m512i)S.M0,
                                    (__m512i)S.D1);
  m = _mm512_mask_add_epi32(m, c4, m, (__m512i)S.D2);
  m = _mm512_mask_add_epi32(m, c6, m, (__m512i)S.D3);
  const __m512i kTwo = _mm512_set1_epi32(2);
  __m512i q = _mm512_maskz_mov_epi32(kneg, _mm512_set1_epi32(1));
  q = _mm512_mask_add_epi32(q, c2, q, kTwo);
  q = _mm512_mask_add_epi32(q, c4, q, kTwo);
  q = _mm512_mask_add_epi32(q, c6, q, kTwo);
  __m512i dq = _mm512_mask_sub_epi32(m, kneg, z, m);
  __m512i r = _mm512_max_epi32(
      _mm512_min_epi32(_mm512_add_epi32(p, dq), _mm512_set1_epi32(32767)),
      _mm512_set1_epi32(-32768));
  __m512i err = _mm512_sub_epi32((__m512i)sample, r);
  __m512i err_sq = _mm512_mullo_epi32(err, err);
  __m512i pen_sq = _mm512_mullo_epi32(pen, pen);
  const __m512i lo0 = (__m512i)S.rank_lo;
  __m512i lo1 = _mm512_add_epi32(lo0, err_sq);
  __mmask16 ca = _mm512_cmplt_epu32_mask(lo1, lo0);
  __m512i lo2 = _mm512_add_epi32(lo1, pen_sq);
  __mmask16 cb = _mm512_cmplt_epu32_mask(lo2, lo1);
  const __m512i kOneV = _mm512_set1_epi32(1);
  __m512i hi = (__m512i)S.rank_hi;
  hi = _mm512_mask_add_epi32(hi, ca, hi, kOneV);
  hi = _mm512_mask_add_epi32(hi, cb, hi, kOneV);
  S.rank_lo = (v16u)lo2;
  S.rank_hi = (v16u)hi;
  v16u qa = (v16u)(v16i)q;
  if (k <= 8) {
    S.word_hi |= qa << (25 - 3 * k);
  } else if (k == 9) {
    S.word_hi |= qa >> 2;
    S.word_lo |= (qa & 3) << 30;
  } else {
    S.word_lo |= qa << (57 - 3 * k);
  }
  __m512i d = _mm512_srai_epi32(dq, 4);
  const v64b kDupLo16 = {
      0, 1, 0, 1, 4, 5, 4, 5, 8, 9, 8, 9, 12, 13, 12, 13,
      0, 1, 0, 1, 4, 5, 4, 5, 8, 9, 8, 9, 12, 13, 12, 13,
      0, 1, 0, 1, 4, 5, 4, 5, 8, 9, 8, 9, 12, 13, 12, 13,
      0, 1, 0, 1, 4, 5, 4, 5, 8, 9, 8, 9, 12, 13, 12, 13};
  __m512i d16 = _mm512_shuffle_epi8(d, (__m512i)kDupLo16);
  __mmask32 mA = _mm512_cmplt_epi16_mask(HA, z);
  __mmask32 mB = _mm512_cmplt_epi16_mask(HB, z);
  __m512i sdA = _mm512_mask_sub_epi16(d16, mA, z, d16);
  __m512i sdB = _mm512_mask_sub_epi16(d16, mB, z, d16);
  __m512i wa2 = _mm512_add_epi16(WA, sdA);
  __m512i wb2 = _mm512_add_epi16(WB, sdB);
  wovfA |= _mm512_cmpneq_epi16_mask(wa2, _mm512_adds_epi16(WA, sdA));
  wovfB |= _mm512_cmpneq_epi16_mask(wb2, _mm512_adds_epi16(WB, sdB));
  S.WA = (v16i)wa2;
  S.WB = (v16i)wb2;
  S.HA = (v16i)(((v16u)S.HA >> 16) | ((v16u)S.HB << 16));
  S.HB = (v16i)(((v16u)S.HB >> 16) | ((v16u)(v16i)r << 16));
}

// Exact threshold tables (host-derived integer boundaries of the
// reference's qoa_div, valid while it does not wrap):
//   n >= k  (r > 0)  iff  r >= ceil((k*2^16 - 2^15) / recip)
//   n <= -k (r < 0)  iff  r <= -(((k-1)*2^16 + 2^15) / recip) - 1
// and for |r| <= kWrapLim[sf] = (2^31 - 1 - 2^15) / recip the multiply
// r*recip + 2^15 cannot wrap, so the boundaries reproduce qoa_div exactly.
inline constexpr int32_t thr_pos(int32_t recip, int32_t k) {
  return (int32_t)(((int64_t)k * 65536 - 32768 + recip - 1) / recip);
}
inline constexpr int32_t thr_neg(int32_t recip, int32_t k) {
  return (int32_t)(-((((int64_t)(k - 1) * 65536 + 32768) / recip) + 1));
}
#define V16_FROM_RECIP(expr)                                             \
  v16i{expr(kRecipTab[0]),  expr(kRecipTab[1]),  expr(kRecipTab[2]),     \
       expr(kRecipTab[3]),  expr(kRecipTab[4]),  expr(kRecipTab[5]),     \
       expr(kRecipTab[6]),  expr(kRecipTab[7]),  expr(kRecipTab[8]),     \
       expr(kRecipTab[9]),  expr(kRecipTab[10]), expr(kRecipTab[11]),    \
       expr(kRecipTab[12]), expr(kRecipTab[13]), expr(kRecipTab[14]),    \
       expr(kRecipTab[15])}
#define QOA_T2P(v) thr_pos(v, 2)
#define QOA_T4P(v) thr_pos(v, 4)
#define QOA_T6P(v) thr_pos(v, 6)
#define QOA_T2N(v) thr_neg(v, 2)
#define QOA_T4N(v) thr_neg(v, 4)
#define QOA_T6N(v) thr_neg(v, 6)
#define QOA_WLIM(v) ((int32_t)((0x7FFFFFFFLL - 32768) / (v)))
const v16i kT2PV = V16_FROM_RECIP(QOA_T2P);
const v16i kT4PV = V16_FROM_RECIP(QOA_T4P);
const v16i kT6PV = V16_FROM_RECIP(QOA_T6P);
const v16i kT2NV = V16_FROM_RECIP(QOA_T2N);
const v16i kT4NV = V16_FROM_RECIP(QOA_T4N);
const v16i kT6NV = V16_FROM_RECIP(QOA_T6N);
const v16i kWLimV = V16_FROM_RECIP(QOA_WLIM);
const v16i kD1V = kMag1V - kMag0V;
const v16i kD2V = kMag2V - kMag1V;
const v16i kD3V = kMag3V - kMag2V;

// lane permutation helpers for the pairwise selection
const v16i kIota07 = {0, 1, 2, 3, 4, 5, 6, 7, 0, 1, 2, 3, 4, 5, 6, 7};
inline v16i swap8(v16i v) {  // swap 256-bit halves (one vshufi32x4)
  const v16i kSwap = {8, 9, 10, 11, 12, 13, 14, 15, 0, 1, 2, 3, 4, 5, 6, 7};
  return __builtin_shuffle(v, kSwap);
}
inline v16i combine_lo(v16i a, v16i b) {  // lanes 0-7 of a ++ lanes 0-7 of b
  const v16i kComb = {0, 1, 2, 3, 4, 5, 6, 7,
                      16, 17, 18, 19, 20, 21, 22, 23};
  return __builtin_shuffle(a, b, kComb);
}

// min-reduce WITHIN each 256-bit half: every lane of a half ends up holding
// that half's minimum (log2(8) rotate+min rounds)
inline v16i halfmin(v16i v) {
  const v16i r4 = {4, 5, 6, 7, 0, 1, 2, 3, 12, 13, 14, 15, 8, 9, 10, 11};
  const v16i r2 = {2, 3, 0, 1, 6, 7, 4, 5, 10, 11, 8, 9, 14, 15, 12, 13};
  const v16i r1 = {1, 0, 3, 2, 5, 4, 7, 6, 9, 8, 11, 10, 13, 12, 15, 14};
  v16i t = __builtin_shuffle(v, r4);
  v = v < t ? v : t;
  t = __builtin_shuffle(v, r2);
  v = v < t ? v : t;
  t = __builtin_shuffle(v, r1);
  v = v < t ? v : t;
  return v;
}

// Winner per 256-bit half by the lexicographic key
// (rank_hi, rank_lo, first_hi, first_lo, sf) with unsigned lo limbs —
// staged masked min-reductions (the same shape as the TPU kernel's argmin),
// both channels of a pair vector at once.  Writes the winning lane index
// (0-15) and key scalars per half.
struct HalfWin {
  int lane[2];
  uint64_t total[2], first[2];
  int sf[2];
};

inline HalfWin argmin_halves(v16u rank_hi, v16u rank_lo, v16u first_hi,
                             v16u first_lo, v16i sf) {
  const v16i kBias = vbroadcast((int32_t)0x80000000);
  const v16i kMax = vbroadcast(0x7FFFFFFF);
  v16i rh = (v16i)rank_hi;  // small counts: signed order == unsigned
  v16i rlb = (v16i)rank_lo ^ kBias;
  v16i fh = (v16i)first_hi;
  v16i flb = (v16i)first_lo ^ kBias;

  v16i m = halfmin(rh);
  v16i ok = rh == m;
  v16i mh_r = m;
  m = halfmin(ok ? rlb : kMax);
  ok &= rlb == m;
  v16i ml_r = m;
  m = halfmin(ok ? fh : kMax);
  ok &= fh == m;
  v16i mh_f = m;
  m = halfmin(ok ? flb : kMax);
  ok &= flb == m;
  v16i ml_f = m;
  v16i msf = halfmin(ok ? sf : vbroadcast(16));
  ok &= sf == msf;
  const v16i kIota = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
  v16i mlane = halfmin(ok ? kIota : vbroadcast(16));

  int32_t d[16 * 6];
  std::memcpy(d + 0, &mlane, 64);
  std::memcpy(d + 16, &mh_r, 64);
  std::memcpy(d + 32, &ml_r, 64);
  std::memcpy(d + 48, &mh_f, 64);
  std::memcpy(d + 64, &ml_f, 64);
  std::memcpy(d + 80, &msf, 64);
  HalfWin out;
  for (int h = 0; h < 2; ++h) {
    const int b = h * 8;
    out.lane[h] = d[b];
    out.total[h] = (uint64_t(uint32_t(d[16 + b])) << 32) |
                   uint32_t(d[32 + b] ^ (int32_t)0x80000000);
    out.first[h] = (uint64_t(uint32_t(d[48 + b])) << 32) |
                   uint32_t(d[64 + b] ^ (int32_t)0x80000000);
    out.sf[h] = d[80 + b];
  }
  return out;
}

// one straggler scalefactor lane, scalar, with early abandon vs the bound
struct ScalarLane {
  int32_t h0, h1, h2, h3, w0, w1, w2, w3;
  uint64_t rank;
  uint64_t word;
};

inline int32_t wrap_mul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}

// continue lane `sf` from its post-sample-0 state through samples 1..len-1;
// returns false if abandoned (rank strictly exceeded the bound — it can no
// longer win, rank accumulation being monotone)
inline bool eval_lane_tail(const int16_t* xw, int C, int c, int len, int sf,
                           ScalarLane& L, uint64_t bound) {
  const int32_t recip = kRecipTab[sf];
  const int32_t sv = kSfTab[sf];
  const int32_t M[4] = {mag0(sv), mag1(sv), mag2(sv), mag3(sv)};
  for (int k = 1; k < len; ++k) {
    const int32_t sample = xw[k * C + c];
    int32_t p = (int32_t)((uint32_t)L.w0 * (uint32_t)L.h0 +
                          (uint32_t)L.w1 * (uint32_t)L.h1 +
                          (uint32_t)L.w2 * (uint32_t)L.h2 +
                          (uint32_t)L.w3 * (uint32_t)L.h3) >> 13;
    int32_t ssum = (int32_t)((uint32_t)L.w0 * (uint32_t)L.w0 +
                             (uint32_t)L.w1 * (uint32_t)L.w1 +
                             (uint32_t)L.w2 * (uint32_t)L.w2 +
                             (uint32_t)L.w3 * (uint32_t)L.w3);
    int32_t pen = (ssum >> 18) - 0x8FF;
    pen = pen < 0 ? 0 : pen;
    int32_t residual = (int32_t)((uint32_t)sample - (uint32_t)p);
    int32_t nr = (int32_t)((uint32_t)wrap_mul(residual, recip) + (1u << 15)) >> 16;
    int32_t scaled = nr + ((residual > 0) - (residual < 0)) - ((nr > 0) - (nr < 0));
    scaled = scaled < -8 ? -8 : (scaled > 8 ? 8 : scaled);
    int32_t qneg = (((-scaled) >> 1) << 1) + 1;
    qneg = qneg > 7 ? 7 : qneg;
    int32_t qpos = (scaled >> 1) << 1;
    qpos = qpos > 6 ? 6 : qpos;
    int32_t q = scaled < 0 ? qneg : qpos;
    int32_t idx = q >> 1;
    int32_t dq = (q & 1) ? -M[idx] : M[idx];
    int32_t r = clamp_i16(p + dq);
    int64_t err = (int64_t)sample - r;
    L.rank += (uint64_t)(err * err) + (uint64_t)((int64_t)pen * pen);
    if (L.rank > bound) return false;
    L.word |= (uint64_t)q << (57 - 3 * k);
    int32_t d = dq >> 4;
    L.w0 = (int32_t)((uint32_t)L.w0 + (uint32_t)(L.h0 < 0 ? -d : d));
    L.w1 = (int32_t)((uint32_t)L.w1 + (uint32_t)(L.h1 < 0 ? -d : d));
    L.w2 = (int32_t)((uint32_t)L.w2 + (uint32_t)(L.h2 < 0 ? -d : d));
    L.w3 = (int32_t)((uint32_t)L.w3 + (uint32_t)(L.h3 < 0 ? -d : d));
    L.h0 = L.h1;
    L.h1 = L.h2;
    L.h2 = L.h3;
    L.h3 = r;
  }
  return true;
}

// Exact whole-window fallback: all 16 candidates over samples 0..len-1
// with the reference's wrapping reciprocal quantizer (step16), winner by
// lexicographic (total, first, sf).  Runs when the threshold quantizer
// flags wrap risk in any surviving lane (~0.6% of windows on real music;
// adversarial weight regimes).  Reads the channel's window-start state
// (unmodified until the winner writes back) and emits word + new state.
static void exact_window_channel(const int16_t* xw, int C, int c, int len,
                                 int32_t* state, uint64_t* word_out) {
  Full16 S;
  S.H0 = vbroadcast(state[0 * C + c]);
  S.H1 = vbroadcast(state[1 * C + c]);
  S.H2 = vbroadcast(state[2 * C + c]);
  S.H3 = vbroadcast(state[3 * C + c]);
  S.W0 = vbroadcast(state[4 * C + c]);
  S.W1 = vbroadcast(state[5 * C + c]);
  S.W2 = vbroadcast(state[6 * C + c]);
  S.W3 = vbroadcast(state[7 * C + c]);
  S.rank_lo = v16u{};
  S.rank_hi = v16u{};
  S.word_hi = kSfBitsV;
  S.word_lo = v16u{};
  uint64_t firsts_l[kNumSf];
  for (int k = 0; k < len; ++k) {
    step16(S, xw[k * C + c], k);
    if (k == 0)
      for (int s = 0; s < kNumSf; ++s)
        firsts_l[s] = (uint64_t(S.rank_hi[s]) << 32) | S.rank_lo[s];
  }
  int bs = 0;
  uint64_t bt = ~0ull, bf = ~0ull;
  for (int s = 0; s < kNumSf; ++s) {
    const uint64_t total = (uint64_t(S.rank_hi[s]) << 32) | S.rank_lo[s];
    const uint64_t first = firsts_l[s];
    // ascending s with strict compares keeps the lowest sf on full ties
    if (total < bt || (total == bt && first < bf)) {
      bs = s;
      bt = total;
      bf = first;
    }
  }
  *word_out =
      (uint64_t((uint32_t)S.word_hi[bs]) << 32) | (uint32_t)S.word_lo[bs];
  state[0 * C + c] = S.H0[bs];
  state[1 * C + c] = S.H1[bs];
  state[2 * C + c] = S.H2[bs];
  state[3 * C + c] = S.H3[bs];
  state[4 * C + c] = S.W0[bs];
  state[5 * C + c] = S.W1[bs];
  state[6 * C + c] = S.W2[bs];
  state[7 * C + c] = S.W3[bs];
}

// Fast full-16 window for ONE channel: all 16 scalefactors continue on
// the threshold-quantizer step16g with the identity-sf constant vectors
// (no gathers), then the argmin over all 16 lanes — which IS the spec
// winner, lexicographic in (total, first, sf) — writes the word and the
// carried state.  Returns false without touching state/word on wrap
// risk (initial weights beyond i16, a |residual| past the threshold
// validity bound, or an i16 weight overflow mid-window): the caller
// re-runs on the exact full-16 path.  Used by the mono dispatch (the
// pairwise layout wastes half the vector on C == 1) and as the
// straggler-heavy window resolver (experiments/cpp_straggler_hybrid.py).
static bool fast16_window_channel(const int16_t* xw, int C, int c, int len,
                                  int32_t* state, uint64_t* word_out) {
  const int32_t h0 = state[0 * C + c], h1 = state[1 * C + c],
                h2 = state[2 * C + c], h3 = state[3 * C + c];
  const int32_t w0 = state[4 * C + c], w1 = state[5 * C + c],
                w2 = state[6 * C + c], w3 = state[7 * C + c];
  // weights beyond i16 cannot pack for vpmaddwd (history is always i16:
  // clamped reconstructions)
  if (((w0 + 32768) | (w1 + 32768) | (w2 + 32768) | (w3 + 32768)) >> 16)
    return false;
  Cont16 S;
  S.HA = vbroadcast((int32_t)((h0 & 0xFFFF) | ((uint32_t)h1 << 16)));
  S.HB = vbroadcast((int32_t)((h2 & 0xFFFF) | ((uint32_t)h3 << 16)));
  S.WA = vbroadcast((int32_t)((w0 & 0xFFFF) | ((uint32_t)w1 << 16)));
  S.WB = vbroadcast((int32_t)((w2 & 0xFFFF) | ((uint32_t)w3 << 16)));
  S.M0 = kMag0V;
  S.D1 = kD1V;
  S.D2 = kD2V;
  S.D3 = kD3V;
  S.T2P = kT2PV;
  S.T4P = kT4PV;
  S.T6P = kT6PV;
  S.T2N = kT2NV;
  S.T4N = kT4NV;
  S.T6N = kT6NV;
  S.WLIM = kWLimV;
  S.rank_lo = v16u{};
  S.rank_hi = v16u{};
  S.word_hi = kSfBitsV;
  S.word_lo = v16u{};
  __mmask16 wlim = 0;
  __mmask32 wovfA = 0, wovfB = 0;
  v16u first_lo{}, first_hi{};
  for (int k = 0; k < len; ++k) {
    step16g(S, vbroadcast((int32_t)xw[k * C + c]), k, wlim, wovfA, wovfB);
    if (k == 0) {
      first_lo = S.rank_lo;
      first_hi = S.rank_hi;
    }
  }
  if (wlim | _mm512_test_epi32_mask(_mm512_movm_epi16(wovfA | wovfB),
                                    _mm512_set1_epi32(-1)))
    return false;
  const v16i kIota16 = {0, 1, 2,  3,  4,  5,  6,  7,
                        8, 9, 10, 11, 12, 13, 14, 15};
  const HalfWin hw = argmin_halves(S.rank_hi, S.rank_lo, first_hi,
                                   first_lo, kIota16);
  // global winner = the lexicographically better half; equal keys keep
  // half 0 (its sfs 0-7 are all lower than half 1's)
  const int h =
      (hw.total[1] < hw.total[0] ||
       (hw.total[1] == hw.total[0] &&
        (hw.first[1] < hw.first[0] ||
         (hw.first[1] == hw.first[0] && hw.sf[1] < hw.sf[0]))))
          ? 1
          : 0;
  const __m512i li = _mm512_set1_epi32(hw.lane[h]);
  auto lane32 = [&](v16i v) {
    return _mm_cvtsi128_si32(_mm512_castsi512_si128(
        _mm512_permutexvar_epi32(li, (__m512i)v)));
  };
  const int32_t ha = lane32(S.HA), hb = lane32(S.HB);
  const int32_t wa = lane32(S.WA), wb = lane32(S.WB);
  state[0 * C + c] = (int32_t)(int16_t)(ha & 0xFFFF);
  state[1 * C + c] = ha >> 16;
  state[2 * C + c] = (int32_t)(int16_t)(hb & 0xFFFF);
  state[3 * C + c] = hb >> 16;
  state[4 * C + c] = (int32_t)(int16_t)(wa & 0xFFFF);
  state[5 * C + c] = wa >> 16;
  state[6 * C + c] = (int32_t)(int16_t)(wb & 0xFFFF);
  state[7 * C + c] = wb >> 16;
  *word_out = (uint64_t((uint32_t)lane32((v16i)S.word_hi)) << 32) |
              (uint32_t)lane32((v16i)S.word_lo);
  return true;
}

template <int C>
void encode_windows_c(const int16_t* __restrict__ x,
                      const int32_t* __restrict__ lens, int64_t W,
                      int32_t* __restrict__ state,
                      uint64_t* __restrict__ words) {
  constexpr int NV = (C + 1) / 2;  // continuation vectors: 2 channels each
  Full16 F[C];
  v16i msel[C];        // pairwise keep masks: lane j -1 => keep sf j+8
  v16u dfirst_lo[C];   // discarded (pair loser) first ranks, lanes 0-7
  v16u dfirst_hi[C];
  v16i sfkept[C];      // kept sf ids, lanes 0-7
  v16u kfirst_lo[NV];  // kept first ranks (pair-vector layout)
  v16u kfirst_hi[NV];
  v16i sfpair[NV];     // kept sf ids (pair-vector layout)

  for (int64_t w = 0; w < W; ++w) {
    const int len = lens[w];
    if (len <= 0) continue;
    const int16_t* xw = x + w * kSliceLen * C;

    // ---- sample 0 on all 16 lanes, every channel, then the PAIRWISE
    //      selection: of each (sf j, sf j+8) pair the better first-sample
    //      rank continues (ties keep the lower sf).  Any eight survivors
    //      are EXACT here — every discarded candidate is re-checked
    //      against the final bound in the straggler pass — and pairing 8
    //      scales apart keeps near-optimal candidates in separate pairs.
    //      All selection runs as vector blends: no sorting network, no
    //      16-lane scalar key extraction (those cost ~1/6 of the whole
    //      encode at the previous revision).
    for (int c = 0; c < C; ++c) {
      Full16& S = F[c];
      S.H0 = vbroadcast(state[0 * C + c]);
      S.H1 = vbroadcast(state[1 * C + c]);
      S.H2 = vbroadcast(state[2 * C + c]);
      S.H3 = vbroadcast(state[3 * C + c]);
      S.W0 = vbroadcast(state[4 * C + c]);
      S.W1 = vbroadcast(state[5 * C + c]);
      S.W2 = vbroadcast(state[6 * C + c]);
      S.W3 = vbroadcast(state[7 * C + c]);
      S.rank_lo = v16u{};
      S.rank_hi = v16u{};
      S.word_hi = kSfBitsV;
      S.word_lo = v16u{};
      step16(S, xw[c], 0);
      const v16u rlo = (v16u)swap8((v16i)S.rank_lo);
      const v16u rhi = (v16u)swap8((v16i)S.rank_hi);
      // strict 2-limb unsigned (rot < cur): equal firsts keep the lower sf
      const v16i lt = (v16i)((rhi < S.rank_hi) |
                             ((rhi == S.rank_hi) & (rlo < S.rank_lo)));
      msel[c] = lt;
      dfirst_lo[c] = lt ? S.rank_lo : rlo;
      dfirst_hi[c] = lt ? S.rank_hi : rhi;
      sfkept[c] = kIota07 + (lt & vbroadcast(8));
    }

    // ---- blend the survivors of channel pairs into full vectors (the
    //      threshold-quantizer constants gather from the global per-sf
    //      tables by the kept sf ids) ----
    Cont16 K[NV];
    // wrap-risk flags as k-register masks end to end (one bit per 32-bit
    // lane; lanes 0-7 = channel a, 8-15 = channel b): the fold and the
    // per-channel test are scalar mask ops instead of 64-byte stack
    // round-trips
    __mmask16 wrapflag[NV];
    __mmask16 wlim[NV];
    __mmask32 wovfA[NV], wovfB[NV];
    for (int v = 0; v < NV; ++v) {
      Cont16& S = K[v];
      wlim[v] = 0;
      wovfA[v] = 0;
      wovfB[v] = 0;
      const int ca = 2 * v;
      const int cb = (2 * v + 1 < C) ? 2 * v + 1 : ca;
      const Full16& A = F[ca];
      const Full16& B = F[cb];
      const v16i la = msel[ca];
      const v16i lb = msel[cb];
      auto pick = [&](v16i av, v16i bv) {
        return combine_lo(la ? swap8(av) : av, lb ? swap8(bv) : bv);
      };
      const v16i h0 = pick(A.H0, B.H0);
      const v16i h1 = pick(A.H1, B.H1);
      const v16i h2 = pick(A.H2, B.H2);
      const v16i h3 = pick(A.H3, B.H3);
      const v16i w0 = pick(A.W0, B.W0);
      const v16i w1 = pick(A.W1, B.W1);
      const v16i w2 = pick(A.W2, B.W2);
      const v16i w3 = pick(A.W3, B.W3);
      // pack as 16-bit pairs for the vpmaddwd continuation; weights beyond
      // i16 cannot pack — flag those lanes for the exact fallback (only
      // adversarial wrap regimes reach them; zero on real audio)
      const v16i kLo16 = vbroadcast(0xFFFF);
      S.HA = (h0 & kLo16) | (h1 << 16);
      S.HB = (h2 & kLo16) | (h3 << 16);
      S.WA = (w0 & kLo16) | (w1 << 16);
      S.WB = (w2 & kLo16) | (w3 << 16);
      const __m512i kPMax = _mm512_set1_epi32(32767);
      const __m512i kPMin = _mm512_set1_epi32(-32768);
      wrapflag[v] =
          _mm512_cmp_epi32_mask((__m512i)w0, kPMax, _MM_CMPINT_NLE) |
          _mm512_cmp_epi32_mask((__m512i)w0, kPMin, _MM_CMPINT_LT) |
          _mm512_cmp_epi32_mask((__m512i)w1, kPMax, _MM_CMPINT_NLE) |
          _mm512_cmp_epi32_mask((__m512i)w1, kPMin, _MM_CMPINT_LT) |
          _mm512_cmp_epi32_mask((__m512i)w2, kPMax, _MM_CMPINT_NLE) |
          _mm512_cmp_epi32_mask((__m512i)w2, kPMin, _MM_CMPINT_LT) |
          _mm512_cmp_epi32_mask((__m512i)w3, kPMax, _MM_CMPINT_NLE) |
          _mm512_cmp_epi32_mask((__m512i)w3, kPMin, _MM_CMPINT_LT);
      S.rank_lo = (v16u)pick((v16i)A.rank_lo, (v16i)B.rank_lo);
      S.rank_hi = (v16u)pick((v16i)A.rank_hi, (v16i)B.rank_hi);
      S.word_hi = (v16u)pick((v16i)A.word_hi, (v16i)B.word_hi);
      S.word_lo = (v16u)pick((v16i)A.word_lo, (v16i)B.word_lo);
      const v16i sfv = combine_lo(sfkept[ca], sfkept[cb]);
      S.M0 = __builtin_shuffle(kMag0V, sfv);
      S.D1 = __builtin_shuffle(kD1V, sfv);
      S.D2 = __builtin_shuffle(kD2V, sfv);
      S.D3 = __builtin_shuffle(kD3V, sfv);
      S.T2P = __builtin_shuffle(kT2PV, sfv);
      S.T4P = __builtin_shuffle(kT4PV, sfv);
      S.T6P = __builtin_shuffle(kT6PV, sfv);
      S.T2N = __builtin_shuffle(kT2NV, sfv);
      S.T4N = __builtin_shuffle(kT4NV, sfv);
      S.T6N = __builtin_shuffle(kT6NV, sfv);
      S.WLIM = __builtin_shuffle(kWLimV, sfv);
      kfirst_lo[v] = S.rank_lo;  // at this point rank == first-sample rank
      kfirst_hi[v] = S.rank_hi;
      sfpair[v] = sfv;
    }

    // ---- continuation: samples 1..len-1, top-8 lanes per channel ----
    for (int k = 1; k < len; ++k) {
      const int16_t* xp = xw + k * C;
      for (int v = 0; v < NV; ++v) {
        const int32_t sa = xp[2 * v];
        const int32_t sb = xp[2 * v + 1 < C ? 2 * v + 1 : 2 * v];
        v16i sample = {sa, sa, sa, sa, sa, sa, sa, sa,
                       sb, sb, sb, sb, sb, sb, sb, sb};
        step16g(K[v], sample, k, wlim[v], wovfA[v], wovfB[v]);
      }
    }
    for (int v = 0; v < NV; ++v)
      wrapflag[v] |= wlim[v] |
                     _mm512_test_epi32_mask(
                         _mm512_movm_epi16(wovfA[v] | wovfB[v]),
                         _mm512_set1_epi32(-1));

    // ---- winners: one vectorized lexicographic argmin per pair vector
    //      (both channels at once), then per-channel stragglers ----
    HalfWin hws[NV];
    for (int v = 0; v < NV; ++v)
      hws[v] = argmin_halves(K[v].rank_hi, K[v].rank_lo, kfirst_hi[v],
                             kfirst_lo[v], sfpair[v]);
    for (int c = 0; c < C; ++c) {
      const Cont16& S = K[c / 2];
      const int base = (c & 1) ? 8 : 0;

      // wrap risk in any surviving lane: the threshold quantizer may have
      // diverged from the wrapping reference multiply — re-evaluate the
      // whole window for this channel on the exact full-16 path
      if ((wrapflag[c / 2] >> base) & 0xFF) {
        ++g_fallback_count;
        exact_window_channel(xw, C, c, len, state, &words[w * C + c]);
        continue;
      }

      const HalfWin& hw = hws[c / 2];
      const int half = c & 1;
      uint64_t b_total = hw.total[half];
      uint64_t b_first = hw.first[half];
      int b_sf = hw.sf[half];
      // materialize the survivors' best as the running winner
      ScalarLane B;
      {
        const int l = hw.lane[half];
        // extract lane l via vpermd + vmovd (a variable vector subscript
        // compiles to a 64-byte stack spill + reload; the permute form has
        // no store-forward stall and the six extracts run in parallel)
        const __m512i li = _mm512_set1_epi32(l);
        auto lane32 = [&](v16i v) {
          return _mm_cvtsi128_si32(_mm512_castsi512_si128(
              _mm512_permutexvar_epi32(li, (__m512i)v)));
        };
        // unpack the 16-bit pairs (sign-extending; values are i16 by the
        // gather-time guard)
        const int32_t ha = lane32(S.HA), hb = lane32(S.HB);
        const int32_t wa = lane32(S.WA), wb = lane32(S.WB);
        B.h0 = (int16_t)(ha & 0xFFFF);
        B.h1 = ha >> 16;
        B.h2 = (int16_t)(hb & 0xFFFF);
        B.h3 = hb >> 16;
        B.w0 = (int16_t)(wa & 0xFFFF);
        B.w1 = wa >> 16;
        B.w2 = (int16_t)(wb & 0xFFFF);
        B.w3 = wb >> 16;
        B.rank = b_total;
        B.word = (uint64_t((uint32_t)lane32((v16i)S.word_hi)) << 32) |
                 (uint32_t)lane32((v16i)S.word_lo);
      }

      // Stragglers: a pruned lane can still win if its first-sample rank
      // does not exceed the winner's total (rank accumulation is
      // monotone); with the pairwise kept set the tie case fs == b_total
      // MUST evaluate, because the discarded lane may beat the kept
      // winner on the (first, sf) tie-break.  The few that qualify
      // evaluate SCALAR with early abandon against the exact bound, like
      // the reference's sorted search (src/lib.rs:544-593) but with a
      // near-optimal bound from the start.
      // vectorized qualification: one 2-limb compare of all 8 discarded
      // firsts against the bound; ~84% of windows skip the whole scan
      {
        const __m512i bt_lo =
            _mm512_set1_epi32((int32_t)(uint32_t)b_total);
        const __m512i bt_hi =
            _mm512_set1_epi32((int32_t)(uint32_t)(b_total >> 32));
        const __m512i dhi = (__m512i)dfirst_hi[c];
        const __m512i dlo = (__m512i)dfirst_lo[c];
        const __mmask16 qual =
            _mm512_cmplt_epu32_mask(dhi, bt_hi) |
            (_mm512_cmpeq_epi32_mask(dhi, bt_hi) &
             _mm512_cmple_epu32_mask(dlo, bt_lo));
        if (!(qual & 0xFF)) goto no_stragglers;
        // straggler-heavy window (hard/noisy signal; the scalar walks
        // below abort late there): one fast full-16 vector window
        // resolves ALL candidates from the original state instead.
        // Threshold 2 measured best — 1.3x noisy / 1.6-1.7x random
        // stereo, a wash on real music where ~84% of windows skip the
        // scan and the rest carry 1-2 stragglers
        // (experiments/cpp_straggler_hybrid.py)
        if (__builtin_popcount((unsigned)(qual & 0xFF)) > 2) {
          ++g_fallback_count;
          if (!fast16_window_channel(xw, C, c, len, state,
                                     &words[w * C + c]))
            exact_window_channel(xw, C, c, len, state, &words[w * C + c]);
          continue;
        }
      }
      for (int j = 0; j < 8; ++j) {
        const uint64_t fs =
            (uint64_t(dfirst_hi[c][j]) << 32) | dfirst_lo[c][j];
        if (fs > b_total) continue;
        const int s = sfkept[c][j] ^ 8;  // the pair's OTHER scalefactor
        ++g_fallback_count;
        const Full16& G = F[c];
        ScalarLane L;
        L.h0 = G.H0[s];
        L.h1 = G.H1[s];
        L.h2 = G.H2[s];
        L.h3 = G.H3[s];
        L.w0 = G.W0[s];
        L.w1 = G.W1[s];
        L.w2 = G.W2[s];
        L.w3 = G.W3[s];
        L.rank = fs;
        L.word = (uint64_t(G.word_hi[s]) << 32) | uint64_t(G.word_lo[s]);
        if (!eval_lane_tail(xw, C, c, len, s, L, b_total)) continue;
        if (L.rank < b_total ||
            (L.rank == b_total &&
             (fs < b_first || (fs == b_first && s < b_sf)))) {
          B = L;
          b_total = L.rank;
          b_first = fs;
          b_sf = s;
        }
      }

    no_stragglers:
      words[w * C + c] = B.word;
      state[0 * C + c] = B.h0;
      state[1 * C + c] = B.h1;
      state[2 * C + c] = B.h2;
      state[3 * C + c] = B.h3;
      state[4 * C + c] = B.w0;
      state[5 * C + c] = B.w1;
      state[6 * C + c] = B.w2;
      state[7 * C + c] = B.w3;
    }
  }
}

// Mono full-16 window: the pairwise layout wastes half the 512-bit
// vector on C == 1 (the second channel half just duplicates the first),
// so mono instead continues ALL 16 scalefactors in the one chain via
// fast16_window_channel — there is no pairwise selection and there are
// NO stragglers: nothing is discarded, so the argmin over all 16 lanes
// IS the spec winner, lexicographic in (total, first, sf) like the
// reference's sorted-order search with early exits (src/lib.rs:495-596).
// Besides the flat win this makes mono encode signal-robust — the
// pairwise path's scalar straggler evaluations scale with signal
// hardness (noisy mono measured ~2x slower than a sine;
// experiments/cpp_encode_mono16.py).
static void encode_windows_mono16(const int16_t* __restrict__ x,
                                  const int32_t* __restrict__ lens,
                                  int64_t W, int32_t* __restrict__ state,
                                  uint64_t* __restrict__ words) {
  for (int64_t w = 0; w < W; ++w) {
    const int len = lens[w];
    if (len <= 0) continue;
    const int16_t* xw = x + w * kSliceLen;
    if (!fast16_window_channel(xw, 1, 0, len, state, &words[w])) {
      ++g_fallback_count;
      exact_window_channel(xw, 1, 0, len, state, &words[w]);
    }
  }
}

}  // namespace

extern "C" {

int64_t qoa_encode_fallbacks(void) { return g_fallback_count; }

// x: (W, 20, C) int16 zero-padded; lens: (W,) int32 valid samples/window;
// state: (8, C) int32 in/out carried LMS; words: (W, C) u64 out.
void qoa_encode_windows(const int16_t* x, const int32_t* lens, int64_t W,
                        int64_t C, int32_t* state, uint64_t* words) {
  switch (C) {
    case 1: encode_windows_mono16(x, lens, W, state, words); break;
    case 2: encode_windows_c<2>(x, lens, W, state, words); break;
    case 3: encode_windows_c<3>(x, lens, W, state, words); break;
    case 4: encode_windows_c<4>(x, lens, W, state, words); break;
    case 5: encode_windows_c<5>(x, lens, W, state, words); break;
    case 6: encode_windows_c<6>(x, lens, W, state, words); break;
    case 7: encode_windows_c<7>(x, lens, W, state, words); break;
    case 8: encode_windows_c<8>(x, lens, W, state, words); break;
    default: break;  // QOA_MAX_CHANNELS == 8
  }
}

// Whole-file variant: one call over all frames' windows, recording the
// carried LMS into snaps (n_snaps, 8, C) every `interval` windows — the
// per-frame state snapshots each QOA frame header serializes
// (src/lib.rs:455-466).  Zero-length (padding) windows
// pass state through, so a short final frame's unused window slots are
// simply lens == 0.
void qoa_encode_file(const int16_t* x, const int32_t* lens, int64_t W,
                     int64_t C, int64_t interval, int32_t* state,
                     uint64_t* words, int32_t* snaps) {
  for (int64_t w0 = 0; w0 < W; w0 += interval) {
    std::memcpy(snaps + (w0 / interval) * 8 * C, state,
                sizeof(int32_t) * 8 * C);
    const int64_t wn = (w0 + interval < W ? interval : W - w0);
    qoa_encode_windows(x + w0 * kSliceLen * C, lens + w0, wn, C, state,
                       words + w0 * C);
  }
}

}  // extern "C"
