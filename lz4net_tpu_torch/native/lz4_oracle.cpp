// The CUDA port's native host engine: a C++ LZ4 block codec with the parse
// semantics of the reference engines (lz4 r88/r93 as shipped in lz4net),
// the port's own copy of lz4net_tpu/native/lz4_oracle.cpp.  It is the
// port's host oracle (the role lz4net's mixed-mode native engine plays):
// strict HC and strict dictionary encode, the host re-decodes and
// re-encodes of the card's paths and the header walks of big-block decode.
//
// Exported C ABI (used via ctypes from lz4net_tpu_torch.models.native; the
// lz4h_ prefix keeps its symbols apart from the JAX package's library):
//   lz4h_compress              greedy parse, returns bytes written or 0
//   lz4h_compress_hc           HC lazy parse, attempt budget = level knob
//   lz4h_decompress            known-output-length, returns bytes read or
//                              a negated Fault
//   lz4h_decompress_unknown    hardened, returns bytes written or a
//                              negated Fault
//   lz4h_unknown_output_length the hardened decoder's header walk
//   lz4h_scan                  the big-block header walk (ops/bigblock.py)
//   ..._batch variants         pthread fan-out over independent blocks
//
// The decoders keep the rules, and the order of the checks, of the port's
// Python decoders (models/reference.py), and report which rule a block
// broke as a Fault so the bindings raise the same errors.  Lengths read
// from the input are summed in 64 bits: a long run of 255 extension bytes
// cannot wrap.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <vector>
#include <thread>
#include <algorithm>

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
constexpr int HASHHC_LOG = 15;
constexpr int HASHHC_ADJUST = 32 - HASHHC_LOG;
constexpr uint32_t HASH_MULT = 2654435761u;

constexpr int HC_MAXD = 1 << 16;
constexpr int HC_MAXD_MASK = HC_MAXD - 1;
constexpr int OPTIMAL_ML = (ML_MASK - 1) + MINMATCH;

// The rule a malformed block breaks, returned negated by the decoders.
enum Fault : int {
    TRUNCATED = 1,         // the input ends inside a sequence
    LIT_PAST_END = 2,      // a literal run past the block's end (or cap)
    LIT_PAST_INPUT = 3,    // the final literal run does not end the input
    BAD_OFFSET = 4,        // offset 0, or before the output (or window)
    MATCH_IN_LAST5 = 5,    // a match into the last 5 bytes
    EMPTY_INPUT = 6,       // no input (unknown-length decode)
    TRUNC_LIT_LEN = 7,     // fragment: the literal length is cut
    TRUNC_OFFSET = 8,      // fragment: the match offset is cut
    TRUNC_MATCH_LEN = 9,   // fragment: the match length is cut
    FRAG_LIT = 10,         // fragment: a literal run past input or output
    FRAG_MATCH = 11,       // fragment: a match past the output
};

inline uint32_t load32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;  // little-endian hosts only (x86/ARM LE), matches Peek4
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

// --- decoders --------------------------------------------------------------

// byte-accurate overlapping-aware forward copy
inline void secure_copy(uint8_t* dst, int dp, int ref, int mlen) {
    int offset = dp - ref;
    if (offset >= mlen) {
        std::memcpy(dst + dp, dst + ref, (size_t)mlen);
    } else if (offset >= 16) {
        int done = 0;
        while (done + offset <= mlen) {
            std::memcpy(dst + dp + done, dst + ref + done, (size_t)offset);
            done += offset;
        }
        for (; done < mlen; done++) dst[dp + done] = dst[ref + done];
    } else {
        for (int i = 0; i < mlen; i++) dst[dp + i] = dst[ref + i];
    }
}

// Known-length decode of dst_len bytes (reference.decompress_block): dst
// holds dict_len window bytes first (0 without a dictionary) and receives
// dst_len decoded bytes after them.  Returns the bytes read, or a negated
// Fault.
int decompress_known(const uint8_t* src, int src_len, uint8_t* dst,
                     int dict_len, int dst_len) {
    int64_t sp = 0, dp = dict_len;
    const int64_t dst_end = (int64_t)dict_len + dst_len;
    const int64_t dst_copylen = dst_end - COPYLENGTH;
    const int64_t dst_lastlits = dst_end - LASTLITERALS;

    for (;;) {
        if (sp >= src_len) return -TRUNCATED;
        uint32_t token = src[sp++];

        int64_t length = token >> ML_BITS;
        if (length == RUN_MASK) {
            int b;
            do {
                if (sp >= src_len) return -TRUNCATED;
                b = src[sp++];
                length += b;
            } while (b == 255);
        }

        int64_t lit_end = dp + length;
        if (lit_end > dst_copylen) {
            if (lit_end != dst_end) return -LIT_PAST_END;
            if (sp + length > src_len) return -LIT_PAST_INPUT;
            std::memcpy(dst + dp, src + sp, (size_t)length);
            sp += length;
            break;
        }
        if (sp + length > src_len) return -TRUNCATED;
        std::memcpy(dst + dp, src + sp, (size_t)length);
        sp += length;
        dp = lit_end;

        if (sp + 2 > src_len) return -TRUNCATED;
        int offset = src[sp] | (src[sp + 1] << 8);
        sp += 2;
        int64_t ref = dp - offset;
        if (ref < 0 || offset == 0) return -BAD_OFFSET;

        int64_t mlen = token & ML_MASK;
        if (mlen == ML_MASK) {
            int b;
            do {
                if (sp >= src_len) return -TRUNCATED;
                b = src[sp++];
                mlen += b;
            } while (b == 255);
        }
        mlen += MINMATCH;

        if (dp + mlen > dst_lastlits) return -MATCH_IN_LAST5;
        secure_copy(dst, (int)dp, (int)ref, (int)mlen);
        dp += mlen;
    }
    return (int)sp;
}

// The hardened unknown-output-length decoder under a cap of dst_cap bytes
// (reference._unknown_sequences).  COPY writes the output to dst, which
// holds dst_size bytes: the length this walk gives without COPY.  Returns
// the decoded length, or a negated Fault.
template <bool COPY>
int64_t unknown_core(const uint8_t* src, int src_len, uint8_t* dst,
                     int64_t dst_cap, int64_t dst_size) {
    if (src_len <= 0) return -EMPTY_INPUT;
    int64_t sp = 0, dp = 0;
    const int64_t dst_end = dst_cap;
    const int64_t dst_mflimit = dst_end - MFLIMIT;
    const int64_t dst_lastlits = dst_end - LASTLITERALS;
    const int64_t src_last3 = (int64_t)src_len - (2 + 1 + LASTLITERALS);
    const int64_t src_last1 = (int64_t)src_len - (LASTLITERALS + 1);

    for (;;) {
        if (sp >= src_len) return -TRUNCATED;
        uint32_t token = src[sp++];

        int64_t length = token >> ML_BITS;
        if (length == RUN_MASK) {
            int b = 255;
            while (sp < src_len && b == 255) {
                b = src[sp++];
                length += b;
            }
        }

        int64_t lit_end = dp + length;
        if (lit_end > dst_mflimit || sp + length > src_last3) {
            if (lit_end > dst_end) return -LIT_PAST_END;
            if (sp + length != src_len) return -LIT_PAST_INPUT;
            if (COPY) {
                if (lit_end > dst_size) return -LIT_PAST_END;
                std::memcpy(dst + dp, src + sp, (size_t)length);
            }
            dp = lit_end;
            break;
        }
        if (COPY) {
            if (lit_end > dst_size) return -LIT_PAST_END;
            std::memcpy(dst + dp, src + sp, (size_t)length);
        }
        sp += length;
        dp = lit_end;

        if (sp + 2 > src_len) return -TRUNCATED;
        int offset = src[sp] | (src[sp + 1] << 8);
        sp += 2;
        int64_t ref = dp - offset;
        if (ref < 0 || offset == 0) return -BAD_OFFSET;

        int64_t mlen = token & ML_MASK;
        if (mlen == ML_MASK) {
            while (sp < src_last1) {
                int b = src[sp++];
                mlen += b;
                if (b != 255) break;
            }
        }
        mlen += MINMATCH;

        if (dp + mlen > dst_lastlits) return -MATCH_IN_LAST5;
        if (COPY) {
            if (dp + mlen > dst_size) return -MATCH_IN_LAST5;
            secure_copy(dst, (int)dp, (int)ref, (int)mlen);
        }
        dp += mlen;
    }
    return dp;
}

// --- HC (lazy two-ahead) compressor ----------------------------------------

struct HcCtx {
    const uint8_t* src;
    int src_end;
    int cap;               // src_end - LASTLITERALS
    int attempts;
    std::vector<int32_t> heads;
    std::vector<uint16_t> chain;
    int next_to_update;

    HcCtx(const uint8_t* s, int n, int att)
        : src(s), src_end(n), cap(n - LASTLITERALS), attempts(att),
          heads((size_t)1 << HASHHC_LOG, 0),
          chain((size_t)HC_MAXD, 0xFFFF),
          next_to_update(1) {}

    inline uint32_t hash_at(int i) const {
        return (load32(src + i) * HASH_MULT) >> HASHHC_ADJUST;
    }

    void insert_upto(int p) {
        while (next_to_update < p) {
            int q = next_to_update;
            uint32_t h = hash_at(q);
            int delta = q - heads[h];
            if (delta > MAX_DISTANCE) delta = MAX_DISTANCE;
            chain[q & HC_MAXD_MASK] = (uint16_t)delta;
            heads[h] = q;
            next_to_update++;
        }
    }

    inline int common_length(int p, int ref) const {
        return match_extension(src, p, ref, cap);
    }

    int find_best_match(int p, int& match_pos) {
        insert_upto(p);
        int ref = heads[hash_at(p)];
        int nb = attempts;
        int ml = 0, repl = 0;
        uint16_t delta = 0;

        if (ref >= p - 4) {
            if (eq4(src + ref, src + p)) {
                delta = (uint16_t)(p - ref);
                repl = ml = common_length(p + MINMATCH, ref + MINMATCH) + MINMATCH;
                match_pos = ref;
            }
            ref -= chain[ref & HC_MAXD_MASK];
        }

        while (ref >= p - MAX_DISTANCE && nb != 0) {
            nb--;
            if (src[ref + ml] == src[p + ml] && eq4(src + ref, src + p)) {
                int mlt = common_length(p + MINMATCH, ref + MINMATCH) + MINMATCH;
                if (mlt > ml) { ml = mlt; match_pos = ref; }
            }
            ref -= chain[ref & HC_MAXD_MASK];
        }

        if (repl != 0) {  // pre-fill chain across the repetitive region
            int ptr = p;
            int end = p + repl - (MINMATCH - 1);
            while (ptr < end - delta) {
                chain[ptr & HC_MAXD_MASK] = delta;
                ptr++;
            }
            do {
                chain[ptr & HC_MAXD_MASK] = delta;
                heads[hash_at(ptr)] = ptr;
                ptr++;
            } while (ptr < end);
            next_to_update = end;
        }
        return ml;
    }

    int find_wider_match(int p, int start_limit, int longest,
                         int& match_pos, int& start_pos) {
        insert_upto(p);
        int ref = heads[hash_at(p)];
        int nb = attempts;
        const int delta = p - start_limit;

        while (ref >= p - MAX_DISTANCE && nb != 0) {
            nb--;
            if (src[start_limit + longest] == src[ref - delta + longest] &&
                eq4(src + ref, src + p)) {
                int fwd = common_length(p + MINMATCH, ref + MINMATCH) + MINMATCH;
                int back = 0;
                while (p - back > start_limit && ref - back > 0 &&
                       src[p - back - 1] == src[ref - back - 1]) {
                    back++;
                }
                if (fwd + back > longest) {
                    longest = fwd + back;
                    match_pos = ref - back;
                    start_pos = p - back;
                }
            }
            ref -= chain[ref & HC_MAXD_MASK];
        }
        return longest;
    }
};

// emit one HC sequence; returns false on output overflow
inline bool hc_emit(uint8_t* dst, int& dp, const uint8_t* src, int& anchor,
                    int& p, int mlen, int ref, int dst_maxlen) {
    int lit_len = p - anchor;
    int token_pos = dp++;
    if (dp + lit_len + (2 + 1 + LASTLITERALS) + (lit_len >> 8) > dst_maxlen)
        return false;
    emit_literal_run(dst, dp, token_pos, lit_len, src, anchor);

    int offset = p - ref;
    dst[dp++] = (uint8_t)offset;
    dst[dp++] = (uint8_t)(offset >> 8);

    if (dp + (1 + LASTLITERALS) + (lit_len >> 8) > dst_maxlen) return false;
    emit_match_length(dst, dp, token_pos, mlen - MINMATCH);

    p += mlen;
    anchor = p;
    return true;
}

int compress_hc_core(const uint8_t* src, int src_len, uint8_t* dst,
                     int dst_maxlen, int attempts) {
    HcCtx ctx(src, src_len, attempts);
    const int mflimit = src_len - MFLIMIT;
    int anchor = 0;
    int dp = 0;
    int p = 1;
    int ref = 0;
    int start2 = 0, ref2 = 0, ml2 = 0;
    int start3 = 0, ref3 = 0, ml3 = 0;

    while (p < mflimit) {
        int ml = ctx.find_best_match(p, ref);
        if (ml == 0) { p++; continue; }

        int start0 = p, ref0 = ref, ml0 = ml;

    search2:
        if (p + ml < mflimit)
            ml2 = ctx.find_wider_match(p + ml - 2, p + 1, ml, ref2, start2);
        else
            ml2 = ml;

        if (ml2 == ml) {  // no better second match
            if (!hc_emit(dst, dp, src, anchor, p, ml, ref, dst_maxlen)) return 0;
            continue;
        }

        if (start0 < p && start2 < p + ml0) {  // rolled forward too far
            p = start0; ref = ref0; ml = ml0;
        }

        if (start2 - p < 3) {  // first match too small
            ml = ml2; p = start2; ref = ref2;
            goto search2;
        }

    search3:
        if (start2 - p < OPTIMAL_ML) {
            int new_ml = std::min(ml, OPTIMAL_ML);
            if (p + new_ml > start2 + ml2 - MINMATCH)
                new_ml = start2 - p + ml2 - MINMATCH;
            int corr = new_ml - (start2 - p);
            if (corr > 0) { start2 += corr; ref2 += corr; ml2 -= corr; }
        }

        if (start2 + ml2 < mflimit)
            ml3 = ctx.find_wider_match(start2 + ml2 - 3, start2, ml2, ref3,
                                       start3);
        else
            ml3 = ml2;

        if (ml3 == ml2) {  // no third match: emit both sequences
            if (start2 < p + ml) ml = start2 - p;
            if (!hc_emit(dst, dp, src, anchor, p, ml, ref, dst_maxlen)) return 0;
            p = start2;
            if (!hc_emit(dst, dp, src, anchor, p, ml2, ref2, dst_maxlen)) return 0;
            continue;
        }

        if (start3 < p + ml + 3) {  // not enough room for match2
            if (start3 >= p + ml) {  // drop match2; match3 becomes first
                if (start2 < p + ml) {
                    int corr = p + ml - start2;
                    start2 += corr; ref2 += corr; ml2 -= corr;
                    if (ml2 < MINMATCH) { start2 = start3; ref2 = ref3; ml2 = ml3; }
                }
                if (!hc_emit(dst, dp, src, anchor, p, ml, ref, dst_maxlen))
                    return 0;
                p = start3; ref = ref3; ml = ml3;
                start0 = start2; ref0 = ref2; ml0 = ml2;
                goto search2;
            }
            start2 = start3; ref2 = ref3; ml2 = ml3;
            goto search3;
        }

        // three ascending matches: emit the first, shift the window
        if (start2 < p + ml) {
            if (start2 - p < ML_MASK) {
                if (ml > OPTIMAL_ML) ml = OPTIMAL_ML;
                if (p + ml > start2 + ml2 - MINMATCH)
                    ml = start2 - p + ml2 - MINMATCH;
                int corr = ml - (start2 - p);
                if (corr > 0) { start2 += corr; ref2 += corr; ml2 -= corr; }
            } else {
                ml = start2 - p;
            }
        }
        if (!hc_emit(dst, dp, src, anchor, p, ml, ref, dst_maxlen)) return 0;
        p = start2; ref = ref2; ml = ml2;
        start2 = start3; ref2 = ref3; ml2 = ml3;
        goto search3;
    }

    // last literals
    {
        int run = src_len - anchor;
        if (dp + run + 1 + (run + 255 - RUN_MASK) / 255 > dst_maxlen) return 0;
        emit_last_literals_unchecked(dst, dp, src, anchor, src_len);
    }
    return dp;
}

// --- preset-dictionary variants --------------------------------------------
// Our extension over the reference vintage (r88/r93 has no dictionary API):
// the dictionary bytes logically precede the block, matches may reach back
// across the boundary (still within the 64 KB window), and the compressed
// output covers only the data region.  Any format-valid parse decodes on
// any LZ4 decoder that prepends the same dictionary.

int compress_dict_core(const uint8_t* src, int data_start, int total_len,
                       uint8_t* dst, int dst_maxlen) {
    std::vector<int32_t> table((size_t)1 << HASH_LOG, 0);
    const int src_end = total_len;
    const int mflimit = src_end - MFLIMIT;
    const int cap = src_end - LASTLITERALS;
    const int dst_last1 = dst_maxlen - (1 + LASTLITERALS);
    const int dst_last3 = dst_maxlen - (2 + 1 + LASTLITERALS);

    auto hash_at = [&](int i) -> uint32_t {
        return (load32(src + i) * HASH_MULT) >> HASH_ADJUST;
    };

    // seed the table with every dictionary position
    for (int i = 0; i + 4 <= data_start; i++) table[hash_at(i)] = i;

    int anchor = data_start;
    int dp = 0;

    if (total_len - data_start >= MINLENGTH) {
        int p = data_start;
        uint32_t h_fwd = hash_at(p);
        bool scanning = true;

        while (scanning) {
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
                if (ref >= p - MAX_DISTANCE && eq4(src + ref, src + p) &&
                    ref < p) break;
            }
            if (!scanning) break;

            while (p > anchor && ref > 0 && src[p - 1] == src[ref - 1]) {
                p--; ref--;
            }

            int lit_len = p - anchor;
            int token_pos = dp++;
            if (dp + lit_len + (lit_len >> 8) > dst_last3) return 0;
            emit_literal_run(dst, dp, token_pos, lit_len, src, anchor);

            for (;;) {
                int offset = p - ref;
                dst[dp++] = (uint8_t)offset;
                dst[dp++] = (uint8_t)(offset >> 8);

                p += MINMATCH;
                ref += MINMATCH;
                anchor = p;
                p += match_extension(src, p, ref, cap);

                int mlen = p - anchor;
                if (dp + (mlen >> 8) > dst_last1) return 0;
                emit_match_length(dst, dp, token_pos, mlen);

                if (p > mflimit) { anchor = p; scanning = false; break; }

                table[hash_at(p - 2)] = p - 2;
                uint32_t h = hash_at(p);
                int r2 = table[h];
                table[h] = p;
                if (r2 > p - (MAX_DISTANCE + 1) && r2 < p &&
                    eq4(src + r2, src + p)) {
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

    {
        int run = src_end - anchor;
        if (dp + run + 1 + (run + 255 - RUN_MASK) / 255 > dst_maxlen) return 0;
        emit_last_literals_unchecked(dst, dp, src, anchor, src_end);
    }
    return dp;
}

int compress_hc_dict_core(const uint8_t* src, int data_start, int total_len,
                          uint8_t* dst, int dst_maxlen, int attempts) {
    HcCtx ctx(src, total_len, attempts);
    const int mflimit = total_len - MFLIMIT;
    int anchor = data_start;
    int dp = 0;
    int p = data_start;            // find_best_match inserts the dictionary
    int ref = 0;
    int start2 = 0, ref2 = 0, ml2 = 0;
    int start3 = 0, ref3 = 0, ml3 = 0;

    if (p == 0) p = 1;             // position 0 can never self-match

    while (p < mflimit) {
        int ml = ctx.find_best_match(p, ref);
        if (ml == 0) { p++; continue; }
        int start0 = p, ref0 = ref, ml0 = ml;

    search2:
        if (p + ml < mflimit)
            ml2 = ctx.find_wider_match(p + ml - 2, p + 1, ml, ref2, start2);
        else
            ml2 = ml;
        if (ml2 == ml) {
            if (!hc_emit(dst, dp, src, anchor, p, ml, ref, dst_maxlen)) return 0;
            continue;
        }
        if (start0 < p && start2 < p + ml0) { p = start0; ref = ref0; ml = ml0; }
        if (start2 - p < 3) { ml = ml2; p = start2; ref = ref2; goto search2; }

    search3:
        if (start2 - p < OPTIMAL_ML) {
            int new_ml = std::min(ml, OPTIMAL_ML);
            if (p + new_ml > start2 + ml2 - MINMATCH)
                new_ml = start2 - p + ml2 - MINMATCH;
            int corr = new_ml - (start2 - p);
            if (corr > 0) { start2 += corr; ref2 += corr; ml2 -= corr; }
        }
        if (start2 + ml2 < mflimit)
            ml3 = ctx.find_wider_match(start2 + ml2 - 3, start2, ml2, ref3,
                                       start3);
        else
            ml3 = ml2;
        if (ml3 == ml2) {
            if (start2 < p + ml) ml = start2 - p;
            if (!hc_emit(dst, dp, src, anchor, p, ml, ref, dst_maxlen)) return 0;
            p = start2;
            if (!hc_emit(dst, dp, src, anchor, p, ml2, ref2, dst_maxlen)) return 0;
            continue;
        }
        if (start3 < p + ml + 3) {
            if (start3 >= p + ml) {
                if (start2 < p + ml) {
                    int corr = p + ml - start2;
                    start2 += corr; ref2 += corr; ml2 -= corr;
                    if (ml2 < MINMATCH) { start2 = start3; ref2 = ref3; ml2 = ml3; }
                }
                if (!hc_emit(dst, dp, src, anchor, p, ml, ref, dst_maxlen))
                    return 0;
                p = start3; ref = ref3; ml = ml3;
                start0 = start2; ref0 = ref2; ml0 = ml2;
                goto search2;
            }
            start2 = start3; ref2 = ref3; ml2 = ml3;
            goto search3;
        }
        if (start2 < p + ml) {
            if (start2 - p < ML_MASK) {
                if (ml > OPTIMAL_ML) ml = OPTIMAL_ML;
                if (p + ml > start2 + ml2 - MINMATCH)
                    ml = start2 - p + ml2 - MINMATCH;
                int corr = ml - (start2 - p);
                if (corr > 0) { start2 += corr; ref2 += corr; ml2 -= corr; }
            } else {
                ml = start2 - p;
            }
        }
        if (!hc_emit(dst, dp, src, anchor, p, ml, ref, dst_maxlen)) return 0;
        p = start2; ref = ref2; ml = ml2;
        start2 = start3; ref2 = ref3; ml2 = ml3;
        goto search3;
    }

    {
        int run = total_len - anchor;
        if (dp + run + 1 + (run + 255 - RUN_MASK) / 255 > dst_maxlen) return 0;
        emit_last_literals_unchecked(dst, dp, src, anchor, total_len);
    }
    return dp;
}

// Fragment decode: a mid-block segment produced by the host fragmenter
// (ops/bigblock.py) — sequences are complete and a 0x00 terminator may
// follow, but the block-level END restrictions (final literal run,
// matches clear of the last 5 bytes, `lz4_format_description.txt:93`)
// do NOT apply: those exist so the reference's decoder can skip bounds
// checks at the tail, and fragments are decoded fully bounds-checked.
// dst holds dict_len window bytes first; returns bytes written or a
// negated Fault (reference.decompress_fragment).
int64_t decompress_fragment_core(const uint8_t* src, int src_len,
                                 uint8_t* dst, int dict_len, int out_len) {
    int64_t sp = 0;
    int64_t dp = dict_len;
    const int64_t dst_end = (int64_t)dict_len + out_len;

    while (sp < src_len) {
        uint32_t token = src[sp++];

        int64_t length = token >> ML_BITS;
        if (length == RUN_MASK) {
            int b;
            do {
                if (sp >= src_len) return -TRUNC_LIT_LEN;
                b = src[sp++];
                length += b;
            } while (b == 255);
        }
        if (sp + length > src_len || dp + length > dst_end) return -FRAG_LIT;
        std::memcpy(dst + dp, src + sp, (size_t)length);
        sp += length;
        dp += length;
        if (sp == src_len) break;       // final literal run (may be empty)

        if (sp + 2 > src_len) return -TRUNC_OFFSET;
        int offset = src[sp] | (src[sp + 1] << 8);
        sp += 2;
        int64_t ref = dp - offset;
        if (ref < 0 || offset == 0) return -BAD_OFFSET;

        int64_t mlen = token & ML_MASK;
        if (mlen == ML_MASK) {
            int b;
            do {
                if (sp >= src_len) return -TRUNC_MATCH_LEN;
                b = src[sp++];
                mlen += b;
            } while (b == 255);
        }
        mlen += MINMATCH;
        if (dp + mlen > dst_end) return -FRAG_MATCH;
        secure_copy(dst, (int)dp, (int)ref, (int)mlen);
        dp += mlen;
    }
    return dp - dict_len;
}

// One sequence header at src[p]: the literal length, the literal bytes'
// start, the match offset and length (0 and 0 for the final literal run)
// and the compressed end, as the walks of ops/bigblock.py read them
// (bigblock.scan_reference).  Returns false where the input ends inside
// a length.
struct Seq {
    int64_t ll, lsrc, off, ml, end;
};

inline bool read_seq(const uint8_t* src, int64_t n, int64_t p, Seq& s) {
    int token = src[p++];
    int64_t ll = token >> 4;
    if (ll == 15) {
        while (p < n && src[p] == 255) { ll += 255; p++; }
        if (p >= n) return false;
        ll += src[p++];
    }
    s.ll = ll;
    s.lsrc = p;
    p += ll;
    s.off = s.ml = 0;
    if (p < n) {                                 // else the final run
        s.off = src[p] | (p + 1 < n ? (int64_t)src[p + 1] << 8 : 0);
        p += 2;
        int64_t ml = token & 15;
        if (ml == 15) {
            while (p < n && src[p] == 255) { ml += 255; p++; }
            if (p >= n) return false;
            ml += src[p++];
        }
        s.ml = ml + 4;
    }
    s.end = p;
    return true;
}

}  // namespace

// --- C ABI -----------------------------------------------------------------

extern "C" {

int lz4h_compress(const uint8_t* src, int src_len, uint8_t* dst,
                  int dst_maxlen) {
    if (src_len <= 0) return 0;
    return src_len < LZ4_64KLIMIT
               ? compress_core<true>(src, src_len, dst, dst_maxlen)
               : compress_core<false>(src, src_len, dst, dst_maxlen);
}

int lz4h_compress_hc(const uint8_t* src, int src_len, uint8_t* dst,
                     int dst_maxlen, int attempts) {
    if (src_len <= 0) return 0;
    if (attempts <= 0) attempts = 256;
    return compress_hc_core(src, src_len, dst, dst_maxlen, attempts);
}

// Known-length decode.  An output length of 0 is decoded too: the
// reference decoder takes only a first token with no literals there.
int lz4h_decompress(const uint8_t* src, int src_len, uint8_t* dst,
                    int dst_len) {
    return decompress_known(src, src_len, dst, 0, dst_len);
}

// Unknown-length decode under a cap of dst_cap bytes into dst, which holds
// dst_size bytes: lz4h_unknown_output_length's result for this block.
int64_t lz4h_decompress_unknown(const uint8_t* src, int src_len,
                                uint8_t* dst, int64_t dst_cap,
                                int64_t dst_size) {
    return unknown_core<true>(src, src_len, dst, dst_cap, dst_size);
}

// The hardened decoder's walk over the sequence headers alone (literal
// bytes are skipped, nothing is copied): the length lz4h_decompress_unknown
// decodes the block to under dst_cap, or its negated Fault.
int64_t lz4h_unknown_output_length(const uint8_t* src, int src_len,
                                   int64_t dst_cap) {
    return unknown_core<false>(src, src_len, nullptr, dst_cap, 0);
}

// Preset-dictionary entry points.  For compression, src holds dict||data
// and data begins at dict_len; for decompression, dst holds the dictionary
// in its first dict_len bytes and receives out_len decoded bytes after it.
int lz4h_compress_dict(const uint8_t* src, int dict_len, int total_len,
                       uint8_t* dst, int dst_maxlen) {
    if (total_len - dict_len <= 0) return 0;
    if (dict_len <= 0)
        return lz4h_compress(src, total_len, dst, dst_maxlen);
    return compress_dict_core(src, dict_len, total_len, dst, dst_maxlen);
}

int lz4h_compress_hc_dict(const uint8_t* src, int dict_len, int total_len,
                          uint8_t* dst, int dst_maxlen, int attempts) {
    if (total_len - dict_len <= 0) return 0;
    if (attempts <= 0) attempts = 256;
    if (dict_len <= 0)
        return lz4h_compress_hc(src, total_len, dst, dst_maxlen, attempts);
    return compress_hc_dict_core(src, dict_len, total_len, dst, dst_maxlen,
                                 attempts);
}

int lz4h_decompress_dict(const uint8_t* src, int src_len, uint8_t* dst,
                         int dict_len, int out_len) {
    return decompress_known(src, src_len, dst, dict_len > 0 ? dict_len : 0,
                            out_len);
}

int64_t lz4h_decompress_fragment(const uint8_t* src, int src_len,
                                 uint8_t* dst, int dict_len, int out_len) {
    if (out_len == 0) return 0;
    return decompress_fragment_core(src, src_len, dst, dict_len, out_len);
}

// The port's one header walk (ops/bigblock.scan, whose plain version is
// bigblock.scan_reference).  It reads the sequence HEADERS only (literal
// payloads are skipped by length, never read) and in one pass gives:
// (comp_offset, out_offset) at the first sequence whose output start
// reaches each ~out_target boundary, the first always (0, 0), so a block
// of any size decodes as waves of segments whose matches reach into the
// previous segment through the decoder's prefix window (at most
// max_segs); the GIANT sequences, whose output span passes out_target
// and which the host fragmenter splits into pure-literal and pure-match
// pieces, as rows of 6 in giants (comp offset, out offset, literal
// length, literal-bytes start, match offset, match length; at most
// max_g); the decoded length; and the output ends of the last sequence
// with a match, where the known-length decoders' block-end rules bind.  res receives: [0]
// the decoded length, [1] the boundaries, [2] the giants or -1 past
// max_g (the walk goes on), [3] 1 if a sequence had a match, [4] and
// [5] its literal end and match end.  Returns 0, or -1 on malformed
// input or overflow of max_segs.
int lz4h_scan(const uint8_t* src, int64_t n, int64_t out_target,
              int64_t* comp_offs, int64_t* out_offs, int64_t max_segs,
              int64_t* giants, int64_t max_g, int64_t* res) {
    if (n <= 0) return -1;
    int64_t n_segs = 0, n_g = 0, p = 0, o = 0, next_mark = 0;
    int64_t has_last = 0, last_lit = 0, last_end = 0;
    while (p < n) {
        if (o >= next_mark) {
            if (n_segs >= max_segs) return -1;
            comp_offs[n_segs] = p;
            out_offs[n_segs] = o;
            n_segs++;
            next_mark = o + out_target;
        }
        Seq s;
        if (!read_seq(src, n, p, s)) return -1;
        if (s.lsrc + s.ll > n) return -1;
        if (s.ll + s.ml > out_target && n_g >= 0) {
            if (n_g >= max_g) {
                n_g = -1;
            } else {
                int64_t* g = giants + 6 * n_g++;
                g[0] = p; g[1] = o; g[2] = s.ll;
                g[3] = s.lsrc; g[4] = s.off; g[5] = s.ml;
            }
        }
        o += s.ll + s.ml;
        p = s.end;
        if (!s.ml) break;
        has_last = 1;
        last_lit = o - s.ml;
        last_end = o;
    }
    if (p != n) return -1;
    res[0] = o; res[1] = n_segs; res[2] = n_g;
    res[3] = has_last; res[4] = last_lit; res[5] = last_end;
    return 0;
}

// Batched, multithreaded fan-out over independent blocks: the CPU analogue
// of the card engine's grid-over-blocks layout.  Offsets/lengths are
// caller-provided views into one contiguous src buffer; results land at
// fixed per-block dst slots.
// One thread for each hardware thread, at most one for each block.
static int32_t pool_size(int32_t n_blocks) {
    int32_t hw = (int32_t)std::thread::hardware_concurrency();
    return std::max(1, std::min<int32_t>(hw, n_blocks));
}

void lz4h_compress_batch(const uint8_t* src, const int64_t* src_offsets,
                         const int32_t* src_lens, uint8_t* dst,
                         const int64_t* dst_offsets, int32_t dst_maxlen,
                         int32_t* results, int32_t n_blocks,
                         int32_t hc_attempts) {
    int32_t n_threads = pool_size(n_blocks);
    std::vector<std::thread> pool;
    std::atomic<int32_t> counter(0);
    auto work = [&]() {
        for (;;) {
            int32_t i = counter.fetch_add(1);
            if (i >= n_blocks) return;
            const uint8_t* s = src + src_offsets[i];
            uint8_t* d = dst + dst_offsets[i];
            results[i] = hc_attempts > 0
                ? lz4h_compress_hc(s, src_lens[i], d, dst_maxlen, hc_attempts)
                : lz4h_compress(s, src_lens[i], d, dst_maxlen);
        }
    };
    for (int t = 0; t < n_threads; t++) pool.emplace_back(work);
    for (auto& th : pool) th.join();
}

void lz4h_decompress_batch(const uint8_t* src, const int64_t* src_offsets,
                           const int32_t* src_lens, uint8_t* dst,
                           const int64_t* dst_offsets,
                           const int32_t* dst_lens, int32_t* results,
                           int32_t n_blocks) {
    int32_t n_threads = pool_size(n_blocks);
    std::vector<std::thread> pool;
    std::atomic<int32_t> counter(0);
    auto work = [&]() {
        for (;;) {
            int32_t i = counter.fetch_add(1);
            if (i >= n_blocks) return;
            results[i] = lz4h_decompress(src + src_offsets[i], src_lens[i],
                                         dst + dst_offsets[i], dst_lens[i]);
        }
    };
    for (int t = 0; t < n_threads; t++) pool.emplace_back(work);
    for (auto& th : pool) th.join();
}

}  // extern "C"
