// Tandem-repeat / low-complexity masking (tantan-compatible, no-gap path).
//
// Re-implements the probabilistic repeat HMM used by the reference's
// Masker (lib/mmseqs/src/commons/Masker.cpp:20-31 invoking
// lib/mmseqs/lib/tantan/tantan.cpp with maxRepeatOffset=50,
// repeatProb=0.005, repeatEndProb=0.05, decay=0.9, no gaps): a
// forward/backward pass over repeat-offset states with per-16-position
// rescaling; letters whose posterior repeat probability reaches
// minMaskProb are replaced by X.
//
// Floating-point summation order matters for bit-parity of borderline
// posteriors: the reference sums foreground probabilities with 4-lane
// AVX2 accumulators combined as (l0+l2)+(l1+l3) plus a sequential
// remainder (tantan.cpp:316-341, mcf_simd.h:175-179). We replicate that
// order exactly.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

const int SCALE_STEP = 16;
const int LANES = 4;

inline double lane_sum(const double *acc) {
    return (acc[0] + acc[2]) + (acc[1] + acc[3]);
}

}  // namespace

extern "C" {

// ratio: alpha x alpha row-major likelihood-ratio matrix
// probs_out: length n, receives posterior repeat probability (float)
// Returns number of masked positions; seq is masked in place (to mask_to).
int tantan_mask(uint8_t *seq, int n, const double *ratio, int alpha,
                int max_offset, double repeat_prob, double repeat_end_prob,
                double decay, double min_mask_prob, uint8_t mask_to,
                float *probs_out) {
    if (n <= 0) return 0;
    const double b2b = 1.0 - repeat_prob;
    const double f2b = repeat_end_prob;
    const double f2f0 = 1.0 - repeat_end_prob;
    const double b2f_decay = decay;
    // firstRepeatOffsetProb(decay, maxOffset)
    double first = (decay < 1.0 || decay > 1.0)
        ? (1.0 - decay) / (1.0 - std::pow(decay, max_offset))
        : 1.0 / max_offset;
    const double b2f_first = repeat_prob * first;

    std::vector<double> b2f(max_offset);
    {
        double p = b2f_first;
        for (int i = 0; i < max_offset; ++i) {
            b2f[i] = p;
            p *= b2f_decay;
        }
    }

    std::vector<double> fg(max_offset, 0.0);
    std::vector<double> scale_factors(n / SCALE_STEP, 0.0);
    std::vector<float> letter_probs(n);

    double background = 1.0;

    // ---- forward ----
    for (int p = 0; p < n; ++p) {
        const double *lr_row = ratio + (size_t)seq[p] * alpha;
        const int m = (p < max_offset) ? p : max_offset;
        const double b = background;

        double acc[LANES] = {0, 0, 0, 0};
        int i = 0;
        for (; i <= m - LANES; i += LANES) {
            for (int l = 0; l < LANES; ++l) {
                const double f = fg[i + l];
                acc[l] += f;
                fg[i + l] = (b * b2f[i + l] + f * f2f0) * lr_row[seq[p - (i + l) - 1]];
            }
        }
        double from_fg = lane_sum(acc);
        for (; i < m; ++i) {
            const double f = fg[i];
            from_fg += f;
            fg[i] = (b * b2f[i] + f * f2f0) * lr_row[seq[p - i - 1]];
        }
        background = b * b2b + from_fg * f2b;

        if (p % SCALE_STEP == SCALE_STEP - 1) {
            const double scale = 1.0 / background;
            scale_factors[p / SCALE_STEP] = scale;
            background *= scale;
            for (int k = 0; k < max_offset; ++k) fg[k] *= scale;
        }
        letter_probs[p] = static_cast<float>(background);
    }

    // forwardTotal: sequential accumulate (tantan.cpp:141-147)
    double from_fg_total = 0.0;
    for (int k = 0; k < max_offset; ++k) from_fg_total += fg[k];
    const double z = background * b2b + from_fg_total * f2b;

    // ---- backward ----
    background = b2b;
    for (int k = 0; k < max_offset; ++k) fg[k] = f2b;

    for (int p = n - 1; p >= 0; --p) {
        const double non_repeat = (double)letter_probs[p] * background / z;
        letter_probs[p] = 1.0 - static_cast<float>(non_repeat);

        if (p % SCALE_STEP == SCALE_STEP - 1) {
            const double scale = scale_factors[p / SCALE_STEP];
            background *= scale;
            for (int k = 0; k < max_offset; ++k) fg[k] *= scale;
        }

        const double *lr_row = ratio + (size_t)seq[p] * alpha;
        const int m = (p < max_offset) ? p : max_offset;
        const double to_bg = f2b * background;

        double acc[LANES] = {0, 0, 0, 0};
        int i = 0;
        for (; i <= m - LANES; i += LANES) {
            for (int l = 0; l < LANES; ++l) {
                const double fe = fg[i + l] * lr_row[seq[p - (i + l) - 1]];
                acc[l] += b2f[i + l] * fe;
                fg[i + l] = to_bg + f2f0 * fe;
            }
        }
        double to_fg = lane_sum(acc);
        for (; i < m; ++i) {
            const double fe = fg[i] * lr_row[seq[p - i - 1]];
            to_fg += b2f[i] * fe;
            fg[i] = to_bg + f2f0 * fe;
        }
        background = b2b * background + to_fg;
    }

    // ---- mask ----
    int masked = 0;
    for (int p = 0; p < n; ++p) {
        if (probs_out) probs_out[p] = letter_probs[p];
        if ((double)letter_probs[p] >= min_mask_prob) {
            seq[p] = mask_to;
            ++masked;
        }
    }
    return masked;
}

// Masked copy of a whole DB: sequence i is src[offs[i], offs[i+1]),
// written to dst at offs[i] - offs[0] and masked there as tantan_mask
// masks it (masking keeps lengths, so every output offset is known up
// front).  The calling thread's OpenMP team takes blocks of whole
// sequences of about equal residue counts, dynamically.
void tantan_mask_batch(const uint8_t *src, uint8_t *dst, const int64_t *offs,
                       int n, const double *ratio, int alpha, int max_offset,
                       double repeat_prob, double repeat_end_prob,
                       double decay, double min_mask_prob, uint8_t mask_to) {
    if (n <= 0) return;
    const int64_t base = offs[0];
    int teams = 1;
#if defined(_OPENMP)
    teams = omp_get_max_threads();
#endif
    // ~32 blocks a thread; a sequence longer than a block is one alone
    const int64_t want = std::max<int64_t>(
        1, (offs[n] - base) / (static_cast<int64_t>(teams) * 32));
    std::vector<int> cut(1, 0);
    for (int i = 0; i < n; ++i)
        if (offs[i + 1] - offs[cut.back()] >= want) cut.push_back(i + 1);
    if (cut.back() != n) cut.push_back(n);
    const int nblocks = static_cast<int>(cut.size()) - 1;
#pragma omp parallel for schedule(dynamic, 1)
    for (int b = 0; b < nblocks; ++b) {
        const int lo = cut[b], hi = cut[b + 1];
        std::memcpy(dst + (offs[lo] - base), src + offs[lo],
                    static_cast<size_t>(offs[hi] - offs[lo]));
        for (int i = lo; i < hi; ++i)
            tantan_mask(dst + (offs[i] - base),
                        static_cast<int>(offs[i + 1] - offs[i]), ratio,
                        alpha, max_offset, repeat_prob, repeat_end_prob,
                        decay, min_mask_prob, mask_to, nullptr);
    }
}

}  // extern "C"
