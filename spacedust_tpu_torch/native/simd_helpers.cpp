// Hardware-exact helpers for numeric parity with the reference's SIMD
// paths. The position-specific MSA weight contributions use the x86
// approximate reciprocal plus one Newton-Raphson step
// (PSSMCalculator.cpp:505-517); vrcpps results are hardware lookups, so
// the only way to match them bit-for-bit is to execute the instruction.

#include <cstdint>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

extern "C" {

// n: (ncol, 24) int32 row-major amino-acid counts per column,
// naa: (ncol,) int32 distinct-aa counts. out: (ncol, 24) float32 with
// out[j][a] = approx 1/(n[j][a] * naa[j]) (garbage where n==0, matching
// the reference; entries 20..23 are zeroed).
void w_contrib_rcp(const int32_t* n, const int32_t* naa, int ncol,
                   float* out) {
#if defined(__AVX2__)
    for (int j = 0; j < ncol; ++j) {
        __m256 naa_j = _mm256_cvtepi32_ps(_mm256_set1_epi32(naa[j]));
        for (int blk = 0; blk < 3; ++blk) {
            __m256 nja = _mm256_cvtepi32_ps(
                _mm256_loadu_si256((const __m256i*)(n + j * 24 + blk * 8)));
            __m256 res = _mm256_mul_ps(nja, naa_j);
            __m256 rcp = _mm256_rcp_ps(res);
            __m256 mul = _mm256_mul_ps(res, _mm256_mul_ps(rcp, rcp));
            __m256 w = _mm256_sub_ps(_mm256_add_ps(rcp, rcp), mul);
            _mm256_storeu_ps(out + j * 24 + blk * 8, w);
        }
        for (int a = 20; a < 24; ++a) out[j * 24 + a] = 0.0f;
    }
#else
    for (int j = 0; j < ncol; ++j) {
        for (int a = 0; a < 20; ++a) {
            float res = (float)n[j * 24 + a] * (float)naa[j];
            out[j * 24 + a] = res > 0 ? 1.0f / res : 0.0f;
        }
        for (int a = 20; a < 24; ++a) out[j * 24 + a] = 0.0f;
    }
#endif
}

}  // extern "C"
