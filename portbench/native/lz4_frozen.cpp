// The benchmark's frozen LZ4 block compressor: the greedy (strict) parse of
// the reference compressor (lz4 r88/r93 as shipped in lz4net), a copy of
// compress_core from lz4net_tpu_torch/native/lz4_oracle.cpp as it stood when
// the benchmark was written.  It makes the compressed inputs of the read
// cells from the seed's corpus, so those inputs never come from the program
// under test and do not move when the program's own copy does.
//
// Exported C ABI (ctypes, portbench/frozen.py):
//   pb_compress        one block: bytes written, or 0 when it does not fit
//   pb_compress_batch  independent blocks over a pool of threads

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int MINMATCH = 4;
constexpr int COPYLENGTH = 8;
constexpr int LASTLITERALS = 5;
constexpr int MFLIMIT = COPYLENGTH + MINMATCH;
constexpr int MINLENGTH = MFLIMIT + 1;
constexpr int ML_BITS = 4;
constexpr int ML_MASK = (1 << ML_BITS) - 1;
constexpr int RUN_MASK = (1 << (8 - ML_BITS)) - 1;
constexpr int MAX_DISTANCE = (1 << 16) - 1;
constexpr int SKIPSTRENGTH = 6;
constexpr int LZ4_64KLIMIT = (1 << 16) + (MFLIMIT - 1);

constexpr int HASH_LOG = 12;
constexpr int HASH_ADJUST = 32 - HASH_LOG;
constexpr int HASH64K_LOG = 13;
constexpr int HASH64K_ADJUST = 32 - HASH64K_LOG;
constexpr uint32_t HASH_MULT = 2654435761u;

inline uint32_t load32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;  // little-endian hosts only
}

inline bool eq4(const uint8_t* a, const uint8_t* b) {
    return load32(a) == load32(b);
}

// Common-run length of src[p..] vs src[ref..] capped at `cap` (absolute
// index bound for p); equivalent to the reference's 8/4/2/1 ladder.
inline int match_extension(const uint8_t* src, int p, int ref, int cap) {
    int n = 0;
    const int limit = cap - p;
    while (n + 8 <= limit) {
        uint64_t a, b;
        std::memcpy(&a, src + p + n, 8);
        std::memcpy(&b, src + ref + n, 8);
        uint64_t diff = a ^ b;
        if (diff) return n + (__builtin_ctzll(diff) >> 3);
        n += 8;
    }
    while (n < limit && src[p + n] == src[ref + n]) n++;
    return n;
}

// --- sequence emission helpers (shared by fast + HC) -----------------------

inline void emit_literal_run(uint8_t* dst, int& dp, int token_pos, int length,
                             const uint8_t* src, int anchor) {
    if (length >= RUN_MASK) {
        dst[token_pos] = (uint8_t)(RUN_MASK << ML_BITS);
        int rem = length - RUN_MASK;
        while (rem > 254) { dst[dp++] = 255; rem -= 255; }
        dst[dp++] = (uint8_t)rem;
    } else {
        dst[token_pos] = (uint8_t)(length << ML_BITS);
    }
    std::memcpy(dst + dp, src + anchor, (size_t)length);
    dp += length;
}

inline void emit_match_length(uint8_t* dst, int& dp, int token_pos, int len) {
    if (len >= ML_MASK) {
        dst[token_pos] = (uint8_t)(dst[token_pos] + ML_MASK);
        int rem = len - ML_MASK;
        while (rem > 254) { dst[dp++] = 255; rem -= 255; }
        dst[dp++] = (uint8_t)rem;
    } else {
        dst[token_pos] = (uint8_t)(dst[token_pos] + len);
    }
}

inline void emit_last_literals_unchecked(uint8_t* dst, int& dp,
                                         const uint8_t* src, int anchor,
                                         int src_end) {
    int run = src_end - anchor;
    if (run >= RUN_MASK) {
        dst[dp++] = (uint8_t)(RUN_MASK << ML_BITS);
        int rem = run - RUN_MASK;
        while (rem > 254) { dst[dp++] = 255; rem -= 255; }
        dst[dp++] = (uint8_t)rem;
    } else {
        dst[dp++] = (uint8_t)(run << ML_BITS);
    }
    std::memcpy(dst + dp, src + anchor, (size_t)run);
    dp += run;
}

// --- greedy (fast) compressor ---------------------------------------------

template <bool K64>
int compress_core(const uint8_t* src, int src_len, uint8_t* dst,
                  int dst_maxlen) {
    const int adjust = K64 ? HASH64K_ADJUST : HASH_ADJUST;
    std::vector<int32_t> table((size_t)1 << (K64 ? HASH64K_LOG : HASH_LOG), 0);

    const int src_end = src_len;
    const int mflimit = src_end - MFLIMIT;
    const int cap = src_end - LASTLITERALS;
    const int dst_last1 = dst_maxlen - (1 + LASTLITERALS);
    const int dst_last3 = dst_maxlen - (2 + 1 + LASTLITERALS);

    auto hash_at = [&](int i) -> uint32_t {
        return (load32(src + i) * HASH_MULT) >> adjust;
    };

    int anchor = 0;
    int dp = 0;

    if (src_len >= MINLENGTH) {
        if (!K64) table[hash_at(0)] = 0;
        int p = 1;
        uint32_t h_fwd = hash_at(p);
        bool scanning = true;

        while (scanning) {
            // find a match (skip-accelerated; inserts every probed position)
            int attempts = (1 << SKIPSTRENGTH) + 3;
            int p_fwd = p;
            int ref;
            for (;;) {
                uint32_t h = h_fwd;
                int step = attempts++ >> SKIPSTRENGTH;
                p = p_fwd;
                p_fwd = p + step;
                if (p_fwd > mflimit) { scanning = false; break; }
                h_fwd = hash_at(p_fwd);
                ref = table[h];
                table[h] = p;
                if (K64) {
                    if (eq4(src + ref, src + p)) break;
                } else {
                    if (ref >= p - MAX_DISTANCE && eq4(src + ref, src + p)) break;
                }
            }
            if (!scanning) break;

            // catch up
            while (p > anchor && ref > 0 && src[p - 1] == src[ref - 1]) {
                p--; ref--;
            }

            // literal run
            int lit_len = p - anchor;
            int token_pos = dp++;
            if (dp + lit_len + (lit_len >> 8) > dst_last3) return 0;
            emit_literal_run(dst, dp, token_pos, lit_len, src, anchor);

            for (;;) {
                // offset
                int offset = p - ref;
                dst[dp++] = (uint8_t)offset;
                dst[dp++] = (uint8_t)(offset >> 8);

                // extend
                p += MINMATCH;
                ref += MINMATCH;
                anchor = p;
                p += match_extension(src, p, ref, cap);

                int mlen = p - anchor;
                if (dp + (mlen >> 8) > dst_last1) return 0;
                emit_match_length(dst, dp, token_pos, mlen);

                if (p > mflimit) { anchor = p; scanning = false; break; }

                table[hash_at(p - 2)] = p - 2;

                // immediate re-match test (token=0 path)
                uint32_t h = hash_at(p);
                int r2 = table[h];
                table[h] = p;
                bool rematch = K64 ? eq4(src + r2, src + p)
                                   : (r2 > p - (MAX_DISTANCE + 1) &&
                                      eq4(src + r2, src + p));
                if (rematch) {
                    token_pos = dp++;
                    dst[token_pos] = 0;
                    ref = r2;
                    continue;
                }
                anchor = p++;
                h_fwd = hash_at(p);
                break;
            }
        }
    }

    // last literals
    {
        int run = src_end - anchor;
        if (dp + run + 1 + (run + 255 - RUN_MASK) / 255 > dst_maxlen) return 0;
        emit_last_literals_unchecked(dst, dp, src, anchor, src_end);
    }
    return dp;
}

}  // namespace

extern "C" {

int pb_compress(const uint8_t* src, int src_len, uint8_t* dst,
                int dst_maxlen) {
    if (src_len <= 0) return 0;
    return src_len < LZ4_64KLIMIT
               ? compress_core<true>(src, src_len, dst, dst_maxlen)
               : compress_core<false>(src, src_len, dst, dst_maxlen);
}

void pb_compress_batch(const uint8_t* src, const int64_t* src_offsets,
                       const int32_t* src_lens, uint8_t* dst,
                       const int64_t* dst_offsets, const int32_t* dst_maxlens,
                       int32_t* results, int32_t n_blocks) {
    int32_t hw = (int32_t)std::thread::hardware_concurrency();
    int32_t n_threads = std::max(1, std::min<int32_t>(hw, n_blocks));
    std::vector<std::thread> pool;
    std::atomic<int32_t> counter(0);
    auto work = [&]() {
        for (;;) {
            int32_t i = counter.fetch_add(1);
            if (i >= n_blocks) return;
            results[i] = pb_compress(src + src_offsets[i], src_lens[i],
                                     dst + dst_offsets[i], dst_maxlens[i]);
        }
    };
    for (int t = 0; t < n_threads; t++) pool.emplace_back(work);
    for (auto& th : pool) th.join();
}

}  // extern "C"
