/* Native data-loader hot path: numeric CSV -> double array.
 *
 * Reference parity note: the reference's ingestion layer (DataVec) runs on
 * the JVM with native-backed parsing underneath; this is the TPU build's
 * equivalent native component for the same role (see
 * deeplearning4j_tpu/native/__init__.py for the build/fallback contract).
 *
 * Two-pass API so the caller allocates exactly once:
 *   pass 1 (out == NULL): validate + count values/rows/cols
 *   pass 2 (out != NULL): fill
 * Returns 0 on success, -1 on anything the fast path cannot represent
 * exactly like the Python csv+float() path would — non-numeric field,
 * ragged rows, empty field, whitespace-only line, any numeric spelling
 * Python float() rejects (hex floats, locale decimal commas). The caller
 * then falls back to the general-purpose Python reader: output must NEVER
 * depend on whether the native library is available.
 */

#include <stdlib.h>

/* characters that may appear in a float() -accepted decimal literal */
static int num_char(char ch) {
    return (ch >= '0' && ch <= '9') || ch == '+' || ch == '-' ||
           ch == '.' || ch == 'e' || ch == 'E';
}

static int soft_space(char ch, char delim) {
    return (ch == ' ' || ch == '\t' || ch == '\r') && ch != delim;
}

long parse_numeric_csv(const char *buf, long len, char delim, long skip,
                       double *out, long *rows, long *cols) {
    const char *p = buf, *end = buf + len;
    long r = 0, c0 = -1, n = 0;
    while (skip > 0 && p < end) {
        while (p < end && *p != '\n') p++;
        if (p < end) p++;
        skip--;
    }
    while (p < end) {
        /* classify the line: truly empty (only \r) is skipped — the
         * Python csv reader yields [] for it and the reader drops empty
         * rows; a line of spaces/tabs is a ONE-FIELD STRING record on the
         * Python path, so the fast path must decline, not skip */
        const char *q = p;
        int empty = 1, spacey = 1;
        while (q < end && *q != '\n') {
            if (*q != '\r') {
                empty = 0;
                if (*q != ' ' && *q != '\t') spacey = 0;
            }
            q++;
        }
        if (empty) { p = q < end ? q + 1 : end; continue; }
        if (spacey) return -1;
        long c = 0;
        for (;;) {
            while (p < end && soft_space(*p, delim)) p++;
            /* empty field: at delimiter, end of line, or end of buffer.
             * Checked BEFORE strtod because strtod itself skips newlines
             * and (for delim=' ') delimiter spaces as plain whitespace. */
            if (p >= end || *p == '\n' || *p == delim) return -1;
            char *fend;
            double v = strtod(p, &fend);
            if (fend == p) return -1;            /* non-numeric field */
            /* reject spellings Python float() would not accept the same
             * way (0x10, locale '3,14', ...): every consumed character
             * must come from the plain decimal alphabet */
            for (const char *t = p; t < fend; t++)
                if (!num_char(*t)) return -1;
            while (fend < (char *)end && soft_space(*fend, delim)) fend++;
            if (out) out[n] = v;
            n++; c++;
            if (fend >= (char *)end || *fend == '\n') {
                p = fend < (char *)end ? fend + 1 : end;
                break;
            }
            if (*fend != delim) return -1;
            p = fend + 1;
            if (p >= end) return -1;             /* trailing delimiter */
        }
        if (c0 < 0) c0 = c;
        else if (c != c0) return -1;             /* ragged rows */
        r++;
    }
    if (r == 0) return -1;
    *rows = r;
    *cols = c0;
    return 0;
}
