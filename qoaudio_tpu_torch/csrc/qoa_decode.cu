// QOA batched LMS decoder for Hopper (sm_90a), with the store-shape probe.
//
// Replaces: qoaudio_tpu/ops/pallas_decode.py::decode_chains_pallas (the
// Pallas kernel `_make_kernel.kernel`) and
// experiments/pallas_decode_variants.py::run_variant (its five store shapes).
// Plain versions beside it: qoaudio_tpu_torch/ops/decode.py::
// decode_chains_words and ::decode_chains_variant.
//
// What it computes: for every chain (frame x channel of some file) and
// every slice window, unpack sf and the 20 3-bit codes from the slice word,
// dequantize, and run the LMS predict / reconstruct / update recurrence,
// storing all 20 reconstructed samples (untrimmed) as int16.
//
// One template on the store mode and the block size; the production decoder
// is mode kV0 at 64 threads:
// * kV0       per-sample int16 stores, (W, 20, N) — the production kernel;
// * kNoStore  the whole recurrence, no sample stores: only the final h[3]
//             of each chain, at out[0, 0, n] (the rest is not written) —
//             the compute ceiling;
// * kStoreOnly out[w, k, n] = code k of word (w, n), no LMS — the store
//             cost;
// * kStack    the 20 samples of a window held in registers and stored
//             after its last step;
// * kPack32   sample pairs packed into int32, (W, 10, N): element j is
//             (s[2j] & 0xFFFF) | (s[2j+1] << 16).
//
// What bounds it on the H100: one warp's issue rate.  The recurrence is
// serial, W x 20 dependent steps per chain (5,120 for a full frame), and
// the chain count is the only parallelism: a 33-file corpus has ~7,900
// chains, 248 warps for the card's 528 schedulers, so each warp sits alone
// on its scheduler.  Bytes (8 B in, 40 B out per chain-window) are far
// from binding.  Counted in the SASS of the kV0 kernel at 64 threads
// (chip_smoke.py phase 2), the loop-carried path of a step was already
// short before this design, 4.70 dependent instructions (the compiler had
// put the newest tap last in the dot and fused >> 13 with + dq); what the
// step cost was its 32 issued instructions, at about 3 clocks each for a
// lone warp (48-49 ns a step at the card's 1,980 MHz maximum clock): the
// select tree and negate of the dequantizer, a predicate and a select per
// weight update, a 64-bit k * N per store, and a load and unpack that sat
// between two windows' steps.  This design issues 26 a step (519 a
// window against 642) with a path of 4.10, and a lone warp spends about 2
// clocks on each (28-29 ns a step).  The stores are what is left to take:
// the same kernel without them (kNoStore) runs a tenth faster.
//
// What the design does about it:
// * one thread per chain, the LMS held in registers across ALL W windows
//   (on the TPU the carry lived in VMEM scratch across window blocks of a
//   sequential grid; CUDA blocks run in no order, so nothing is carried
//   between blocks, and the loop over windows runs inside the thread);
// * the prediction is carried from step to step (all of it mod 2^32, so
//   the rearrangement is exact): with s_i = (h_i < 0 ? -1 : 1) kept beside
//   the history (each sample's sign is taken once, when it is
//   reconstructed) and delta = dq >> 4 known from the word before the
//   step, the weights after the step are w_i' = w_i + s_i * delta, one
//   multiply-add each, and
//       pred' = (w0' * h1 + w1' * h2 + w2' * h3 + w3' * recon) >> 13;
//   the three older taps are summed beside the step, so from one recon to
//   the next there are one multiply-add, the >> 13 fused with + dq, and
//   the clamp.  Only the kernel's start takes a 4-tap dot;
// * a window's 20 dequantized values are made one window ahead, from the
//   word loaded two windows ahead (a load the compiler may not sink to its
//   use), so their instructions fill the chain's waits instead of standing
//   between two windows: the codes come from constant shifts of the word's
//   two 32-bit halves (code 9 by a funnel shift across them), the
//   magnitude from one PRMT over the scalefactor's four magnitudes packed
//   16 bits each (max 7 * 2048 = 14,336 < 2^15), the sign from a multiply
//   by 1 - 2 * (code & 1);
// * the store address is a pointer advanced by N per sample, and the
//   store is a streaming one (st.global.cs): at the main path's shape the
//   kernel with plain stores took 10-13% longer;
// * tried and dropped, each built beside this design and timed in turns
//   on one card (experiments/decode_builds.py; times in PERF.md): the
//   next prediction as A + delta * B + w3' * recon (A and B from the state
//   at step start, as the encoder takes it: four more multiply-adds a
//   step, slower); the clamp moved off the path by clamping pred between
//   -32768 - dq and 32767 - dq (a shorter path, more instructions,
//   slower); the dequantized value selected from a positive or a negative
//   pair of registers by the code's low bit, tested directly or rotated
//   into the sign bit (more ALU instructions, no faster); the 16 x 8
//   dequantized values in a table in shared memory (fewest instructions
//   and the fastest with no stores, but slower with them: its 20 loads a
//   window share the memory pipe with the 20 stores; the same with 10
//   loads of two codes' values from a 1,024-entry table); 32 threads a block
//   (no faster: the warps already sit alone); no look-ahead (half as slow
//   again);
// * small blocks (64 threads, the production launch; the probe takes 64,
//   128 or 256, the counterpart of the Pallas tile) to spread the few
//   warps over many SMs.  The block size is a template parameter and the
//   kernel's launch bound, so each block size is compiled for itself;
// * the thread reads its raw big-endian u64 word (coalesced: neighbouring
//   threads on neighbouring chains) and byteswaps its halves in registers,
//   so no host or device pass makes logical halves;
// * stores are (W, 20, N) int16 with neighbouring threads on neighbouring
//   chains; the ragged edge is masked here (no 128-lane padding).
//
// Integer semantics: the reference wraps int32 adds and multiplies; signed
// overflow is undefined in C++, so those run in uint32 and cast back, and
// every >> stays on a signed int (arithmetic shift).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__constant__ int32_t kScalefactorTab[16] = {
    1, 7, 21, 45, 84, 138, 211, 304, 421, 562, 731, 928, 1157, 1419, 1715, 2048};

constexpr int kSliceLen = 20;
constexpr int kThreads = 64;  // the production launch

enum StoreMode : int { kV0 = 0, kNoStore = 1, kStoreOnly = 2, kStack = 3, kPack32 = 4 };

__device__ __forceinline__ uint32_t u32(int32_t v) { return static_cast<uint32_t>(v); }

__device__ __forceinline__ int32_t wrap_dot4(const uint32_t* w, const int32_t* h) {
  uint32_t s = w[0] * u32(h[0]);
  s += w[1] * u32(h[1]);
  s += w[2] * u32(h[2]);
  s += w[3] * u32(h[3]);
  return static_cast<int32_t>(s);
}

// a * b + c mod 2^32, as written: the compiler may not regroup the taps
// of the carried prediction (it would put the newest sample's behind the
// others)
__device__ __forceinline__ uint32_t mad(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// Bytes of {hi:lo} picked by the four selector nibbles; a nibble's bit 3
// replicates the sign of its byte (PTX prmt's default mode, which
// __byte_perm does not offer).
__device__ __forceinline__ int32_t prmt(uint32_t lo, uint32_t hi, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(lo), "r"(hi), "r"(sel));
  return static_cast<int32_t>(d);
}

// A read-only load that stays where it is written: volatile asm is not sunk
// towards its first use, so a prefetch stays a prefetch.
__device__ __forceinline__ uint64_t load_word(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.global.nc.u64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

// The output is written once and not read here: a streaming store
// (st.global.cs, evict-first in L2) in every mode, so that the modes differ
// in their store shape alone.
__device__ __forceinline__ void store16(int16_t* p, int32_t v) {
  __stcs(p, static_cast<int16_t>(v));
}

__device__ __forceinline__ uint32_t pack16(int32_t a, int32_t b) {
  return (u32(a) & 0xFFFFu) | (u32(b) << 16);
}

// Code k of the logical word {hi:lo} in the low 3 bits of the result (the
// bits above are whatever the word holds there): code k sits at bit
// 57 - 3k, the high half for k < 9, across the halves for k == 9.
template <int K>
__device__ __forceinline__ uint32_t code_bits(uint32_t hi, uint32_t lo) {
  if constexpr (K < 9) return hi >> (25 - 3 * K);
  else if constexpr (K == 9) return __funnelshift_l(lo, hi, 2);
  else return lo >> (57 - 3 * K);
}

// dq[K..19] of the word: the selector takes bytes 2*idx and 2*idx+1 of the
// packed magnitudes and fills the high half with the sign of byte 2*idx+1
// (0: a magnitude is under 2^15); an odd code is the negative value.
template <int K>
__device__ __forceinline__ void dequant_from(int32_t (&dq)[kSliceLen], uint32_t hi,
                                             uint32_t lo, uint32_t m01, uint32_t m23) {
  if constexpr (K < kSliceLen) {
    const uint32_t c = code_bits<K>(hi, lo);
    const int32_t mag = prmt(m01, m23, (c & 6u) * 0x1111u + 0x9910u);
    dq[K] = static_cast<int32_t>(u32(mag) * mad(c & 1u, 0xFFFFFFFEu, 1u));
    dequant_from<K + 1>(dq, hi, lo, m01, m23);
  }
}

// The 20 dequantized residuals of one raw big-endian slice word
// (QOA_DEQUANT_TAB's row of the word's scalefactor in closed form).
__device__ __forceinline__ void dequant(int32_t (&dq)[kSliceLen], uint64_t raw) {
  const uint32_t hi = __byte_perm(static_cast<uint32_t>(raw), 0, 0x0123);
  const uint32_t lo = __byte_perm(static_cast<uint32_t>(raw >> 32), 0, 0x0123);
  const int32_t v = kScalefactorTab[hi >> 28];
  const int32_t m0 = (3 * v + 2) >> 2, m1 = (5 * v + 1) >> 1, m2 = (9 * v + 1) >> 1;
  const int32_t m3 = 7 * v;
  dequant_from<0>(dq, hi, lo, pack16(m0, m1), pack16(m2, m3));
}

// out: int16 (W, 20, N), or int32 (W, 10, N) for kPack32; launched with
// THREADS threads per block.
template <int MODE, int THREADS>
__global__ void __launch_bounds__(THREADS)
qoa_decode_kernel(const uint64_t* __restrict__ words_be,
                  const int32_t* __restrict__ state, int n_windows,
                  int n_chains, int16_t* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_chains) return;
  const size_t N = static_cast<size_t>(n_chains);

  if constexpr (MODE == kStoreOnly) {
    for (int win = 0; win < n_windows; ++win) {
      const uint64_t raw = words_be[win * N + n];
      const uint64_t word =
          (static_cast<uint64_t>(__byte_perm(static_cast<uint32_t>(raw), 0, 0x0123)) << 32) |
          __byte_perm(static_cast<uint32_t>(raw >> 32), 0, 0x0123);
      int16_t* dst = out + static_cast<size_t>(win) * kSliceLen * N + n;
#pragma unroll
      for (int k = 0; k < kSliceLen; ++k)
        store16(dst + k * N, static_cast<int32_t>((word >> (57 - 3 * k)) & 7u));
    }
    return;
  }

  // the LMS: history (h[0] only for its sign), each sample's sign as +-1,
  // the weights, and the prediction of the next sample
  int32_t h[4];
  uint32_t w[4], s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = state[i * N + n];
    w[i] = u32(state[(4 + i) * N + n]);
    s[i] = u32(h[i] >> 31) | 1u;
  }
  int32_t pred = wrap_dot4(w, h) >> 13;

  // window win + 1's dequantized values and window win + 2's word, while
  // window win's chain runs; past the last window the last word again
  const uint64_t* wp = words_be + n;
  int32_t nxt[kSliceLen];
  dequant(nxt, load_word(wp));
  uint64_t raw = load_word(wp + (n_windows > 1 ? N : 0));
  int16_t* dst = out + n;  // the next sample's place; advances by N

  for (int win = 0; win < n_windows; ++win) {
    int32_t dq[kSliceLen];
#pragma unroll
    for (int k = 0; k < kSliceLen; ++k) dq[k] = nxt[k];
    const uint64_t ahead = raw;
    raw = load_word(wp + static_cast<size_t>(min(win + 2, n_windows - 1)) * N);
    dequant(nxt, ahead);

    int32_t held[kSliceLen];  // kStack / kPack32: the window's samples
#pragma unroll
    for (int k = 0; k < kSliceLen; ++k) {
      // beside the path: the weights after this step and the older taps
      const uint32_t delta = u32(dq[k] >> 4);
      uint32_t wn[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) wn[i] = mad(s[i], delta, w[i]);
      uint32_t older = wn[0] * u32(h[1]);
      older = mad(wn[1], u32(h[2]), older);
      older = mad(wn[2], u32(h[3]), older);

      // the path: |pred| <= 2^18 after >> 13 whatever the weights, and
      // |dq| < 2^14, so the add cannot overflow
      const int32_t r = min(max(pred + dq[k], -32768), 32767);
      pred = static_cast<int32_t>(mad(wn[3], u32(r), older)) >> 13;

      if constexpr (MODE == kV0) {
        store16(dst, r);
        dst += n_chains;
      }
      if constexpr (MODE == kStack || MODE == kPack32) held[k] = r;
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = wn[i];
      h[1] = h[2];
      h[2] = h[3];
      h[3] = r;
      s[0] = s[1];
      s[1] = s[2];
      s[2] = s[3];
      s[3] = u32(r >> 31) | 1u;
    }
    if constexpr (MODE == kStack) {
#pragma unroll
      for (int k = 0; k < kSliceLen; ++k) {
        store16(dst, held[k]);
        dst += n_chains;
      }
    }
    if constexpr (MODE == kPack32) {
      int32_t* dst32 =
          reinterpret_cast<int32_t*>(out) + static_cast<size_t>(win) * (kSliceLen / 2) * N + n;
#pragma unroll
      for (int j = 0; j < kSliceLen / 2; ++j)
        __stcs(dst32 + j * N, static_cast<int32_t>(pack16(held[2 * j], held[2 * j + 1])));
    }
  }
  if constexpr (MODE == kNoStore) {
    if (n_windows > 0) out[n] = static_cast<int16_t>(h[3]);
  }
}

template <int MODE, int THREADS>
int launch(const void* words_be, const void* state, int n_windows, int n_chains,
           void* out, void* stream) {
  if (n_windows > 0 && n_chains > 0) {
    const int blocks = (n_chains + THREADS - 1) / THREADS;
    qoa_decode_kernel<MODE, THREADS><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(words_be), static_cast<const int32_t*>(state),
        n_windows, n_chains, static_cast<int16_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_mode(const void* words_be, const void* state, int n_windows, int n_chains,
                void* out, int threads, void* stream) {
  switch (threads) {
    case 64: return launch<MODE, 64>(words_be, state, n_windows, n_chains, out, stream);
    case 128: return launch<MODE, 128>(words_be, state, n_windows, n_chains, out, stream);
    case 256: return launch<MODE, 256>(words_be, state, n_windows, n_chains, out, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// words_be: (W, N) raw big-endian u64; state: (8, N) int32;
// out: (W, 20, N) int16.  Launches the kV0 kernel on `stream` with the
// production block of 64 threads (the probe's v0 at 64 threads is this
// same kernel), does not synchronise.  Returns
// cudaGetLastError() as an int (0 on success).
extern "C" int qoa_decode_chains_cuda(const void* words_be, const void* state,
                                      int n_windows, int n_chains, void* out,
                                      void* stream) {
  return launch<kV0, kThreads>(words_be, state, n_windows, n_chains, out, stream);
}

// The store-shape probe: the same decode with store mode `mode` (0 v0,
// 1 nostore, 2 storeonly, 3 stack, 4 pack32) and `threads` per block (64,
// 128 or 256).  out: int16 (W, 20, N), or int32 (W, 10, N) for pack32.
// Returns cudaErrorInvalidValue for another mode or block size, else
// cudaGetLastError().
extern "C" int qoa_decode_variant_cuda(const void* words_be, const void* state,
                                       int n_windows, int n_chains, void* out,
                                       int mode, int threads, void* stream) {
  switch (mode) {
    case kV0: return launch_mode<kV0>(words_be, state, n_windows, n_chains, out, threads, stream);
    case kNoStore:
      return launch_mode<kNoStore>(words_be, state, n_windows, n_chains, out, threads, stream);
    case kStoreOnly:
      return launch_mode<kStoreOnly>(words_be, state, n_windows, n_chains, out, threads, stream);
    case kStack: return launch_mode<kStack>(words_be, state, n_windows, n_chains, out, threads, stream);
    case kPack32:
      return launch_mode<kPack32>(words_be, state, n_windows, n_chains, out, threads, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The CUDA runtime's message for an error code returned above.
extern "C" const char* qoa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
