// pacmann_native — host-tier compute kernels (C ABI, loaded via ctypes).
//
// The GPU build keeps the server scans and hint generation on the device
// (XLA); this library covers the *host* tier the same way the
// reference covers it with hand assembly:
//   * AES-128-MMO PRF     (reference: pianopir/aes_amd64.s:19-126 AES-NI)
//   * XOR parity scan     (reference: pianopir/aes_amd64.s:133-157 AVX2)
//   * batched L2 distance (reference: graphann/l2_distance_amd64.s:4-36)
// Framing matches pianopir/util.go:157-165: PRF(tag, x) = low-8-bytes-LE of
// AES128-MMO(key, LE64((tag<<35)+x) || 0^8), MMO(k,m) = E_k(m) ^ m.
//
// Build: make -C native   (g++ -O3 -maes -mavx2)

#include <cstdint>
#include <cstring>
#include <immintrin.h>
#include <wmmintrin.h>

extern "C" {

// ---------------------------------------------------------------------------
// Runtime CPU-feature probe: the library is built with -maes -mavx2 -mfma, so
// every kernel assumes those ISAs. Callers must check this before any other
// entry point and fall back to NumPy when it returns 0 (instead of SIGILL).

int pacmann_cpu_supported(void) {
  return __builtin_cpu_supports("aes") && __builtin_cpu_supports("avx2") &&
         __builtin_cpu_supports("fma");
}

// ---------------------------------------------------------------------------
// AES-128 key schedule (AESKEYGENASSIST). round_keys: 11 x 16 bytes.

static inline __m128i aes_expand_step(__m128i key, __m128i keygened) {
  keygened = _mm_shuffle_epi32(keygened, _MM_SHUFFLE(3, 3, 3, 3));
  key = _mm_xor_si128(key, _mm_slli_si128(key, 4));
  key = _mm_xor_si128(key, _mm_slli_si128(key, 4));
  key = _mm_xor_si128(key, _mm_slli_si128(key, 4));
  return _mm_xor_si128(key, keygened);
}

void pacmann_expand_key(const uint8_t key[16], uint8_t round_keys[176]) {
  __m128i k = _mm_loadu_si128(reinterpret_cast<const __m128i*>(key));
  _mm_storeu_si128(reinterpret_cast<__m128i*>(round_keys), k);
#define EXPAND(i, rcon)                                                     \
  k = aes_expand_step(k, _mm_aeskeygenassist_si128(k, rcon));               \
  _mm_storeu_si128(reinterpret_cast<__m128i*>(round_keys + 16 * (i)), k);
  EXPAND(1, 0x01) EXPAND(2, 0x02) EXPAND(3, 0x04) EXPAND(4, 0x08)
  EXPAND(5, 0x10) EXPAND(6, 0x20) EXPAND(7, 0x40) EXPAND(8, 0x80)
  EXPAND(9, 0x1b) EXPAND(10, 0x36)
#undef EXPAND
}

// ---------------------------------------------------------------------------
// AES-128-MMO PRF, 8 blocks in flight to fill the AES pipeline.

static inline __m128i aes_encrypt_block(const __m128i rk[11], __m128i m) {
  m = _mm_xor_si128(m, rk[0]);
  for (int r = 1; r < 10; ++r) m = _mm_aesenc_si128(m, rk[r]);
  return _mm_aesenclast_si128(m, rk[10]);
}

// out[i] = PRF(tags[i], xs[i]) as full u64 (caller masks).
void pacmann_prf_eval_u64(const uint8_t round_keys[176], const uint64_t* tags,
                          const uint64_t* xs, uint64_t* out, int64_t n) {
  __m128i rk[11];
  for (int r = 0; r < 11; ++r)
    rk[r] = _mm_loadu_si128(reinterpret_cast<const __m128i*>(round_keys + 16 * r));

  int64_t i = 0;
  for (; i + 8 <= n; i += 8) {
    __m128i m[8];
    for (int j = 0; j < 8; ++j)
      m[j] = _mm_set_epi64x(0, (int64_t)((tags[i + j] << 35) + xs[i + j]));
    __m128i c[8];
    for (int j = 0; j < 8; ++j) c[j] = _mm_xor_si128(m[j], rk[0]);
    for (int r = 1; r < 10; ++r)
      for (int j = 0; j < 8; ++j) c[j] = _mm_aesenc_si128(c[j], rk[r]);
    for (int j = 0; j < 8; ++j) {
      c[j] = _mm_aesenclast_si128(c[j], rk[10]);
      c[j] = _mm_xor_si128(c[j], m[j]);  // MMO feed-forward
      out[i + j] = (uint64_t)_mm_cvtsi128_si64(c[j]);
    }
  }
  for (; i < n; ++i) {
    __m128i m = _mm_set_epi64x(0, (int64_t)((tags[i] << 35) + xs[i]));
    __m128i c = _mm_xor_si128(aes_encrypt_block(rk, m), m);
    out[i] = (uint64_t)_mm_cvtsi128_si64(c);
  }
}

// Offset table: out[t*S + s] = PRF(tag0 + t, s) & mask  (hint-gen layout).
void pacmann_prf_offset_table(const uint8_t round_keys[176], uint64_t tag0,
                              int64_t T, int64_t S, uint32_t mask,
                              uint32_t* out) {
  __m128i rk[11];
  for (int r = 0; r < 11; ++r)
    rk[r] = _mm_loadu_si128(reinterpret_cast<const __m128i*>(round_keys + 16 * r));
  for (int64_t t = 0; t < T; ++t) {
    uint64_t base = (tag0 + (uint64_t)t) << 35;
    int64_t s = 0;
    for (; s + 8 <= S; s += 8) {
      __m128i m[8], c[8];
      for (int j = 0; j < 8; ++j)
        m[j] = _mm_set_epi64x(0, (int64_t)(base + (uint64_t)(s + j)));
      for (int j = 0; j < 8; ++j) c[j] = _mm_xor_si128(m[j], rk[0]);
      for (int r = 1; r < 10; ++r)
        for (int j = 0; j < 8; ++j) c[j] = _mm_aesenc_si128(c[j], rk[r]);
      for (int j = 0; j < 8; ++j) {
        c[j] = _mm_xor_si128(_mm_aesenclast_si128(c[j], rk[10]), m[j]);
        out[t * S + s + j] =
            (uint32_t)((uint64_t)_mm_cvtsi128_si64(c[j]) & mask);
      }
    }
    for (; s < S; ++s) {
      __m128i m = _mm_set_epi64x(0, (int64_t)(base + (uint64_t)s));
      __m128i c = _mm_xor_si128(aes_encrypt_block(rk, m), m);
      out[t * S + s] = (uint32_t)((uint64_t)_mm_cvtsi128_si64(c) & mask);
    }
  }
}

// ---------------------------------------------------------------------------
// XOR parity scan over a chunk-major DB (layout of pir/layout.py):
//   db:      (S, CK, 128) u32, CK = chunk_size * k
//   offsets: (B, S) u32 row blocks (already globalized by the caller)
//   skip:    (B, S) u8 (1 = skip)
//   out:     (B, k*128) u32
// Chunk-major outer loop streams each chunk once while all B parities are
// updated — the cache-friendly order (reference pir.go:281-300).

void pacmann_xor_scan(const uint32_t* db, const uint32_t* offsets,
                      const uint8_t* skip, uint32_t* out, int64_t B,
                      int64_t S, int64_t CK, int64_t k) {
  const int64_t row_u32 = (int64_t)k * 128;
  std::memset(out, 0, (size_t)(B * row_u32) * sizeof(uint32_t));
  for (int64_t s = 0; s < S; ++s) {
    const uint32_t* chunk = db + s * CK * 128;
    for (int64_t b = 0; b < B; ++b) {
      if (skip[b * S + s]) continue;
      const uint32_t* src = chunk + (int64_t)offsets[b * S + s] * 128 * k;
      uint32_t* dst = out + b * row_u32;
      int64_t w = 0;
      for (; w + 8 <= row_u32; w += 8) {
        __m256i a = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(dst + w));
        __m256i x = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(src + w));
        _mm256_storeu_si256(reinterpret_cast<__m256i*>(dst + w),
                            _mm256_xor_si256(a, x));
      }
      for (; w < row_u32; ++w) dst[w] ^= src[w];
    }
  }
}

// ---------------------------------------------------------------------------
// Batched squared-L2: out[q*B + b] = ||Q[q] - P[b]||^2 (f32, AVX2 FMA).

void pacmann_l2_batch(const float* Q, const float* P, float* out, int64_t nq,
                      int64_t nb, int64_t d) {
  for (int64_t q = 0; q < nq; ++q) {
    const float* qv = Q + q * d;
    for (int64_t b = 0; b < nb; ++b) {
      const float* pv = P + b * d;
      __m256 acc = _mm256_setzero_ps();
      int64_t j = 0;
      for (; j + 8 <= d; j += 8) {
        __m256 diff = _mm256_sub_ps(_mm256_loadu_ps(qv + j),
                                    _mm256_loadu_ps(pv + j));
        acc = _mm256_fmadd_ps(diff, diff, acc);
      }
      float buf[8];
      _mm256_storeu_ps(buf, acc);
      float s = buf[0] + buf[1] + buf[2] + buf[3] + buf[4] + buf[5] + buf[6] +
                buf[7];
      for (; j < d; ++j) {
        float diff = qv[j] - pv[j];
        s += diff * diff;
      }
      out[q * nb + b] = s;
    }
  }
}

// Inner product baseline (u32 wrap-around accumulate, as the reference's
// AVX-512 InnerProduct: l2_distance_amd64.s:39-68).
void pacmann_inner_product_u32(const uint32_t* A, const uint32_t* Bm,
                               uint32_t* out, int64_t nq, int64_t nb,
                               int64_t d) {
  for (int64_t q = 0; q < nq; ++q)
    for (int64_t b = 0; b < nb; ++b) {
      const uint32_t* av = A + q * d;
      const uint32_t* bv = Bm + b * d;
      uint32_t s = 0;
      for (int64_t j = 0; j < d; ++j) s += av[j] * bv[j];
      out[q * nb + b] = s;
    }
}

}  // extern "C"
