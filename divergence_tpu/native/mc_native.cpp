// Native threaded adaptive permutation Monte-Carlo for CSS significance.
//
// The device path (kernels/perm.py:mc_significance) evaluates fixed-shape
// permutation chunks for a whole window batch until the slowest window
// finishes — the right trade on an accelerator (one dispatch, fused
// batched arithmetic).  On a CPU host the right trade is the opposite:
// scalar per-window loops with EXACT early exit (a window stops at its
// threshold-th hit, wasting zero draws) and a dynamically scheduled
// thread pool over windows — the shape of the reference's pthread pool
// (reference statistics/css/threadcss.c:52-109) rebuilt for this
// framework's deterministic stream contract.
//
// Stream identity: the permutation stream is the SAME
// fold_in(seed, chrom, slot, chunk)-pinned stream the XLA backend
// draws, replayed exactly:
//   * per-chunk keys come from Threefry-2x32 fold_in (JAX's
//     jax.random.fold_in semantics: threefry2x32(key, (0, chunk_idx)),
//     jax/_src/prng.py threefry_fold_in / threefry_seed) applied to the
//     per-window base key passed in from window_keys();
//   * intra-chunk draws are the counter mix
//     mix32(mix32(state0 ^ ctr) + state1) of kernels/perm.py:_mix_bits;
//   * the permutation is the stable ascending argsort of the m draws
//     with index tie-break — identical to _ranks().
// The estimator is the reference's p = (hits+1)/(n+1), stop at the
// threshold-th hit or the runs cap (reference statistics/css/css.c:727-752).
// Scores are accumulated in double (the XLA backend reduces in f32, in
// an unspecified order); a permutation whose CSS ties the observed
// score to within f32 rounding may therefore resolve >= differently —
// measure-zero for continuous distance matrices, documented in
// docs/PARITY.md.
//
// CSS of a permutation (reference statistics/css/css.c:608-647): with
// ord[r] = individual at rank r, a = |A|, b = |B|, m = a + b,
//   score = (sum_{r<a<=s} D[ord[r]][ord[s]]) / (a b)
//         - m * ( wa * sum_{r=0..a-2}  D[ord[r]][ord[r+1]]
//               + wb * sum_{r=a..m-2} D[ord[r]][ord[r+1]] )
// with wa = 1/(a^2 (a-1)), wb = 1/(b^2 (b-1)) — the order-dependent
// adjacent-chain within sums.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <map>
#include <mutex>
#include <thread>
#include <utility>
#include <vector>

#ifdef __AVX512F__
#include <immintrin.h>
#endif

namespace {

inline uint32_t rotl32(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}

// Batcher odd-even mergesort comparator network for arbitrary n
// (~107 compare-exchanges at n=21).  Branchless min/max on packed
// (draw << 5 | index) keys beats insertion sort here: random draws make
// every insertion-sort branch a coin flip (~100 mispredicts/permutation).
std::vector<std::pair<int, int>> make_network(int n) {
    std::vector<std::pair<int, int>> net;
    for (int p = 1; p < n; p <<= 1)
        for (int k = p; k >= 1; k >>= 1)
            for (int j = k % p; j <= n - 1 - k; j += 2 * k)
                for (int i = 0;
                     i <= std::min(k - 1, n - j - k - 1); ++i)
                    if ((j + i) / (2 * p) == (j + i + k) / (2 * p))
                        net.emplace_back(j + i, j + i + k);
    return net;
}

const std::vector<std::pair<int, int>>& network_for(int n) {
    static std::mutex mu;
    // node-based map: references stay valid across insertions (a
    // concurrent mc_native call with a different n must not dangle them)
    static std::map<int, std::vector<std::pair<int, int>>> cache;
    std::lock_guard<std::mutex> g(mu);
    auto& net = cache[n];
    if (net.empty() && n > 1) net = make_network(n);
    return net;
}

// Threefry-2x32, 20 rounds — bit-identical to jax/_src/prng.py
// threefry2x32 (rotation schedule [13,15,26,6] / [17,29,16,24], key
// injection every 4 rounds with the round constant).
inline void threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0,
                         uint32_t x1, uint32_t out[2]) {
    const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
    static const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
    x0 += ks[0];
    x1 += ks[1];
    for (int g = 0; g < 5; ++g) {
        const int* r = rot[g & 1];
        for (int i = 0; i < 4; ++i) {
            x0 += x1;
            x1 = rotl32(x1, r[i]);
            x1 ^= x0;
        }
        x0 += ks[(g + 1) % 3];
        x1 += ks[(g + 2) % 3] + (uint32_t)(g + 1);
    }
    out[0] = x0;
    out[1] = x1;
}

// kernels/perm.py:_mix32 — murmur3-style finalizer, Prospector constants.
inline uint32_t mix32(uint32_t x) {
    x = (x ^ (x >> 16)) * 0x7FEB352Du;
    x = (x ^ (x >> 15)) * 0x846CA68Bu;
    return x ^ (x >> 16);
}

}  // namespace

extern "C" {

// jax.random.fold_in(key, data) for a typed threefry key given as two
// uint32 words — exposed for the parity test against JAX.
void tf2x32_fold(uint32_t k0, uint32_t k1, uint32_t data, uint32_t* out2) {
    threefry2x32(k0, k1, 0u, data, out2);
}

// Adaptive MC over B windows.  dist: [B, m, m] f32 row-major; scores:
// [B] observed CSS (f32, as the XLA backend compares); wkeys: [B, 2]
// uint32 per-window base key words (jax.random.key_data of
// window_keys()).  Outputs: pvals [B] f64, nscores [B] i64 (permutations
// consumed, 1-based index of the threshold-th hit or runs), hits [B] i64.
void mc_native(const float* dist, const float* scores,
               const uint32_t* wkeys, int64_t B, int32_t m, int32_t asize,
               int32_t chunk, int64_t runs, int32_t threshold,
               int32_t n_threads, double* pvals, int64_t* nscores,
               int64_t* hits_out) {
    const int32_t bsize = m - asize;
    const double wa =
        asize > 1 ? 1.0 / ((double)asize * asize * (asize - 1)) : 0.0;
    const double wb =
        bsize > 1 ? 1.0 / ((double)bsize * bsize * (bsize - 1)) : 0.0;
    const double inv_ab = 1.0 / ((double)asize * bsize);
    if (n_threads <= 0) {
        // 2x logical cores: mild oversubscription hides the gather
        // latency of the vectorized scoring (measured +5% at m=21)
        unsigned hc = std::thread::hardware_concurrency();
        n_threads = hc ? (int32_t)(2 * hc) : 1;
    }
    if ((int64_t)n_threads > B) n_threads = (int32_t)(B > 0 ? B : 1);

    const auto& net = network_for(m);
    // between-group sum via row totals over the SMALLER group G:
    //   between = sum_{j in G} rowtot[j] - 2 * within_G
    // (D symmetric, zero diagonal) — min(a,b) rowtot gathers plus
    // C(min(a,b), 2) pair terms instead of a*b direct terms.
    const bool use_b = bsize <= asize;
    const int32_t g_lo = use_b ? asize : 0;
    const int32_t g_hi = use_b ? m : asize;

    constexpr int32_t LANES = 8;
    std::atomic<int64_t> next(0);
    auto worker = [&]() {
        std::vector<uint32_t> draws((size_t)chunk * m);
        std::vector<uint64_t> kt((size_t)m * LANES);
        std::vector<int32_t> ord(m);
        std::vector<int32_t> ord_t((size_t)m * LANES);  // transposed ranks
        std::vector<double> rowtot(m);
        (void)ord;
        (void)ord_t;
        int64_t w;
        while ((w = next.fetch_add(1, std::memory_order_relaxed)) < B) {
            const float* D = dist + (size_t)w * m * m;
            const double obs = (double)scores[w];
            const uint32_t wk0 = wkeys[2 * w], wk1 = wkeys[2 * w + 1];
            for (int32_t j = 0; j < m; ++j) {
                double acc = 0.0;
                const float* row = D + (size_t)j * m;
                for (int32_t l = 0; l < m; ++l) acc += (double)row[l];
                rowtot[j] = acc;
            }
            int64_t hits = 0, n = runs;
            bool stopped = false;
            for (int64_t k = 0; !stopped && k * chunk < runs; ++k) {
                uint32_t ck[2];
                threefry2x32(wk0, wk1, 0u, (uint32_t)k, ck);
                // counter expansion of the whole chunk's draw block
                // (vectorizable; wasted tail on early exit is < 1 chunk)
                const int64_t lo = k * chunk;
                const int64_t hi = std::min<int64_t>(lo + chunk, runs);
                const int32_t nperm = (int32_t)(hi - lo);
                const int32_t nwords = nperm * m;
                for (int32_t c = 0; c < nwords; ++c)
                    draws[c] = mix32(mix32(ck[0] ^ (uint32_t)c) + ck[1]);
                for (int32_t p0 = 0; p0 < nperm && !stopped; p0 += LANES) {
                    const int32_t nl = std::min(LANES, nperm - p0);
                    // stable ascending order via the branchless network on
                    // (draw << 32 | index) keys — index tie-break == _ranks.
                    // LANES permutations ride each pass in a transposed
                    // [m][LANES] layout: the network is data-independent,
                    // so the per-lane compare-exchange vectorizes
                    // (vpminuq/vpmaxuq under -march=native AVX-512).
                    for (int32_t j = 0; j < m; ++j) {
                        uint64_t* row = kt.data() + (size_t)j * LANES;
                        for (int32_t l = 0; l < LANES; ++l) {
                            const int32_t pl = p0 + (l < nl ? l : 0);
                            row[l] =
                                ((uint64_t)draws[(size_t)pl * m + j] << 32) |
                                (uint32_t)j;
                        }
                    }
                    for (const auto& ce : net) {
                        uint64_t* a = kt.data() + (size_t)ce.first * LANES;
                        uint64_t* b = kt.data() + (size_t)ce.second * LANES;
                        for (int32_t l = 0; l < LANES; ++l) {
                            const uint64_t x = a[l], y = b[l];
                            a[l] = x < y ? x : y;
                            b[l] = x < y ? y : x;
                        }
                    }
#ifdef __AVX512F__
                    // Vectorized scoring: all LANES permutations at once
                    // (AVX2 float gathers + AVX-512 double accumulation).
                    // Per lane the accumulation order is identical to the
                    // scalar path below — bit-identical scores.
                    const __m256i m_v = _mm256_set1_epi32(m);
                    for (int32_t r = 0; r < m; ++r)
                        _mm256_storeu_si256(
                            (__m256i*)(ord_t.data() + (size_t)r * LANES),
                            _mm512_cvtepi64_epi32(_mm512_loadu_si512(
                                kt.data() + (size_t)r * LANES)));
                    __m512d rt = _mm512_setzero_pd();
                    __m512d within = _mm512_setzero_pd();
                    for (int32_t r = g_lo; r < g_hi; ++r) {
                        const __m256i oj = _mm256_loadu_si256(
                            (const __m256i*)(ord_t.data() +
                                             (size_t)r * LANES));
                        rt = _mm512_add_pd(
                            rt, _mm512_i32gather_pd(oj, rowtot.data(), 8));
                        const __m256i base = _mm256_mullo_epi32(oj, m_v);
                        __m512d acc = _mm512_setzero_pd();
                        for (int32_t s = r + 1; s < g_hi; ++s) {
                            const __m256i os = _mm256_loadu_si256(
                                (const __m256i*)(ord_t.data() +
                                                 (size_t)s * LANES));
                            const __m256i idx = _mm256_add_epi32(base, os);
                            acc = _mm512_add_pd(
                                acc, _mm512_cvtps_pd(
                                         _mm256_i32gather_ps(D, idx, 4)));
                        }
                        within = _mm512_add_pd(within, acc);
                    }
                    const __m512d between = _mm512_sub_pd(
                        rt, _mm512_mul_pd(_mm512_set1_pd(2.0), within));
                    __m512d chain_a = _mm512_setzero_pd();
                    __m512d chain_b = _mm512_setzero_pd();
                    for (int32_t r = 0; r + 1 < m; ++r) {
                        if (r + 1 == asize) continue;
                        const __m256i oj = _mm256_loadu_si256(
                            (const __m256i*)(ord_t.data() +
                                             (size_t)r * LANES));
                        const __m256i os = _mm256_loadu_si256(
                            (const __m256i*)(ord_t.data() +
                                             (size_t)(r + 1) * LANES));
                        const __m256i idx = _mm256_add_epi32(
                            _mm256_mullo_epi32(oj, m_v), os);
                        const __m512d dv = _mm512_cvtps_pd(
                            _mm256_i32gather_ps(D, idx, 4));
                        if (r < asize)
                            chain_a = _mm512_add_pd(chain_a, dv);
                        else
                            chain_b = _mm512_add_pd(chain_b, dv);
                    }
                    const __m512d sc = _mm512_sub_pd(
                        _mm512_mul_pd(between, _mm512_set1_pd(inv_ab)),
                        _mm512_mul_pd(
                            _mm512_set1_pd((double)m),
                            _mm512_add_pd(
                                _mm512_mul_pd(_mm512_set1_pd(wa), chain_a),
                                _mm512_mul_pd(_mm512_set1_pd(wb),
                                              chain_b))));
                    const __mmask8 hitm = _mm512_cmp_pd_mask(
                        sc, _mm512_set1_pd(obs), _CMP_GE_OQ);
                    if (hitm)
                        for (int32_t l = 0; l < nl; ++l)
                            if (((hitm >> l) & 1) && ++hits >= threshold) {
                                n = lo + p0 + l + 1;  // 1-based hit index
                                stopped = true;
                                break;
                            }
#else
                    for (int32_t l = 0; l < nl; ++l) {
                        for (int32_t r = 0; r < m; ++r)
                            ord[r] = (int32_t)(uint32_t)
                                kt[(size_t)r * LANES + l];
                        double rt = 0.0, within = 0.0;
                        for (int32_t r = g_lo; r < g_hi; ++r) {
                            const int32_t j = ord[r];
                            rt += rowtot[j];
                            const float* row = D + (size_t)j * m;
                            double acc = 0.0;
                            for (int32_t s = r + 1; s < g_hi; ++s)
                                acc += (double)row[ord[s]];
                            within += acc;
                        }
                        const double between = rt - 2.0 * within;
                        double chain_a = 0.0, chain_b = 0.0;
                        for (int32_t r = 0; r + 1 < asize; ++r)
                            chain_a +=
                                (double)D[(size_t)ord[r] * m + ord[r + 1]];
                        for (int32_t r = asize; r + 1 < m; ++r)
                            chain_b +=
                                (double)D[(size_t)ord[r] * m + ord[r + 1]];
                        const double s = between * inv_ab -
                                         m * (wa * chain_a + wb * chain_b);
                        if (s >= obs && ++hits >= threshold) {
                            n = lo + p0 + l + 1;  // 1-based hit index
                            stopped = true;
                            break;
                        }
                    }
#endif
                }
            }
            pvals[w] = (double)(hits + 1) / (double)(n + 1);
            nscores[w] = n;
            hits_out[w] = hits;
        }
    };

    if (n_threads <= 1) {
        worker();
        return;
    }
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int32_t t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
}

}  // extern "C"
