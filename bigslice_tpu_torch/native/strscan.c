/* strscan.c — native host-tier string ingestion.
 *
 * The host parse is the wordcount/urls pipeline's Amdahl term
 * (BASELINE.md config #2): everything downstream of it runs on the
 * device tier, so its per-row cost bounds end-to-end throughput. The
 * reference keeps this cost down with compiled Go string ops spread
 * over one goroutine per shard (cmd/urls/urls.go:24-37); a Python host
 * tier needs a native kernel instead — this file is that kernel, the
 * ingestion-side analog of the reference's unsafe native tier
 * (typeslice/unsafe.go, SURVEY.md §2.3).
 *
 * bs_domains_encode: ONE pass over a "\n"-joined line buffer that
 * fuses what the vectorized-numpy + Arrow fallback (frame/strparse.py)
 * does in five: row framing, first-"//" search, tail-until-"/" span
 * extraction, ASCII lowercasing, and open-addressed dictionary
 * encoding. Per row it emits a global code; only the UNIQUE lowered
 * domains are materialized (into uniq_buf) for the Python-side
 * vocabulary merge.
 *
 * Exactness contract (pinned by tests/test_native.py against the
 * Python oracle `_domain`): byte-level "//" and "/" scanning is
 * UTF-8-safe — 0x2F never occurs inside a multibyte sequence, so byte
 * positions of the delimiters equal character positions. Only the
 * lowercasing is ASCII-only; a row whose DOMAIN SPAN contains a byte
 * >= 128 gets code -1 and the caller re-parses it through the exact
 * Python path (str.lower is unicode-aware).
 *
 * Returns nuniq >= 0 on success; -1 on framing mismatch (a line
 * contained '\n' — caller falls back, same contract as the Arrow
 * path's newline-count check); -2 on capacity overflow (cannot happen
 * with the caller's max_uniq = nrows, uniq_cap = buflen sizing);
 * -3 on allocation failure.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static inline uint8_t lower8(uint8_t c) {
    return (c >= 'A' && c <= 'Z') ? (uint8_t)(c + 32) : c;
}

int64_t bs_domains_encode(const uint8_t *buf, int64_t buflen,
                          int64_t nrows, int32_t *codes,
                          uint8_t *uniq_buf, int64_t uniq_cap,
                          int64_t *uniq_off, int64_t max_uniq) {
    int64_t tsize = 64;
    while (tsize < 4 * max_uniq) tsize <<= 1;
    int32_t *table = (int32_t *)malloc((size_t)tsize * sizeof(int32_t));
    if (!table) return -3;
    memset(table, 0xff, (size_t)tsize * sizeof(int32_t));
    const int64_t mask = tsize - 1;

    int64_t nuniq = 0, ubytes = 0, pos = 0;
    uniq_off[0] = 0;
    for (int64_t r = 0; r < nrows; r++) {
        const uint8_t *nlp =
            (const uint8_t *)memchr(buf + pos, '\n', (size_t)(buflen - pos));
        if (!nlp) { free(table); return -1; }
        const int64_t end = nlp - buf;

        /* Tail after the first "//" (whole row when absent), then the
         * span up to the next '/' — url.split("//",1)[-1]
         * .split("/",1)[0], byte-for-byte. */
        int64_t ts = pos;
        for (int64_t i = pos; i + 1 < end; i++)
            if (buf[i] == '/' && buf[i + 1] == '/') { ts = i + 2; break; }
        int64_t te = ts;
        while (te < end && buf[te] != '/') te++;
        const int64_t len = te - ts;

        /* Lower + hash in one sweep; non-ASCII quarantines the row. */
        uint64_t h = 1469598103934665603ULL; /* FNV-1a */
        int ascii = 1;
        for (int64_t i = ts; i < te; i++) {
            uint8_t c = buf[i];
            if (c >= 128) { ascii = 0; break; }
            h = (h ^ lower8(c)) * 1099511628211ULL;
        }
        if (!ascii) { codes[r] = -1; pos = end + 1; continue; }

        int64_t slot = (int64_t)(h & (uint64_t)mask);
        for (;;) {
            const int32_t e = table[slot];
            if (e < 0) {
                if (nuniq >= max_uniq || ubytes + len > uniq_cap) {
                    free(table);
                    return -2;
                }
                for (int64_t i = 0; i < len; i++)
                    uniq_buf[ubytes + i] = lower8(buf[ts + i]);
                ubytes += len;
                table[slot] = (int32_t)nuniq;
                codes[r] = (int32_t)nuniq;
                uniq_off[++nuniq] = ubytes;
                break;
            }
            const int64_t eo = uniq_off[e];
            if (uniq_off[e + 1] - eo == len) {
                int64_t i = 0;
                while (i < len && uniq_buf[eo + i] == lower8(buf[ts + i]))
                    i++;
                if (i == len) { codes[r] = e; break; }
            }
            slot = (slot + 1) & mask;
        }
        pos = end + 1;
    }
    free(table);
    if (pos != buflen) return -1; /* extra bytes: framing drifted */
    return nuniq;
}
