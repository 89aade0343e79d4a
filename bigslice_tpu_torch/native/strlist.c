/* strlist.c — CPython-extension ingestion kernel: parse a Python list
 * of URL strings directly.
 *
 * The ctypes kernel (strscan.c) needs the host tier to materialize one
 * "\n"-joined buffer per batch — a full copy of the corpus plus a
 * framing restriction (embedded newlines force a fallback). This
 * module reads each line's UTF-8 bytes in place via
 * PyUnicode_AsUTF8AndSize (cached on the unicode object), so the parse
 * is one pass over the strings the user already holds: no join, no
 * copy, no framing caveat. It is the preferred native path; strscan.c
 * remains the toolchain-minimal fallback beneath it.
 *
 * domains_encode(list[str]) -> (codes: bytes of int32[n], uniques:
 * list[str]) | None. Per row, codes[i] indexes `uniques` (the lowered
 * ASCII domain — url.split("//",1)[-1].split("/",1)[0].lower(),
 * byte-exact per the UTF-8-safety argument in strscan.c), or -1 when
 * the domain span contains non-ASCII bytes (caller re-parses that row
 * through the Python oracle). Returns None (never raises) when any
 * element is not str — the caller's fallback ladder handles it.
 *
 * Reference role: the compiled string path of cmd/urls/urls.go:24-37
 * and the native tier of SURVEY.md §2.3, on the ingestion side.
 */

#define PY_SSIZE_T_CLEAN
#define _GNU_SOURCE /* memmem */
#include <Python.h>

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* Domains longer than this use the byte-wise probe compare instead of
 * the lowered stack buffer + memcmp (they are pathological inputs). */
#define LOW_BUF 1024

static inline uint8_t lower8(uint8_t c) {
    return (c >= 'A' && c <= 'Z') ? (uint8_t)(c + 32) : c;
}

/* Byte-wise lowered compare for spans longer than the stack buffer. */
static int eq_lowered(const uint8_t *stored, const uint8_t *raw,
                      int64_t len) {
    for (int64_t i = 0; i < len; i++)
        if (stored[i] != lower8(raw[i])) return 0;
    return 1;
}

static PyObject *domains_encode(PyObject *self, PyObject *args) {
    PyObject *list;
    if (!PyArg_ParseTuple(args, "O!", &PyList_Type, &list)) return NULL;
    const Py_ssize_t n = PyList_GET_SIZE(list);

    int64_t tsize = 64;
    while (tsize < 4 * (int64_t)(n ? n : 1)) tsize <<= 1;
    const int64_t mask = tsize - 1;

    int32_t *codes = (int32_t *)malloc((size_t)(n ? n : 1) * 4);
    int32_t *table = (int32_t *)malloc((size_t)tsize * 4);
    int64_t *uoff = (int64_t *)malloc((size_t)(n + 1) * 8);
    int64_t ucap = 4096;
    uint8_t *arena = (uint8_t *)malloc((size_t)ucap);
    if (!codes || !table || !uoff || !arena) {
        free(codes); free(table); free(uoff); free(arena);
        return PyErr_NoMemory();
    }
    memset(table, 0xff, (size_t)tsize * 4);
    int64_t nuniq = 0, ubytes = 0;
    uoff[0] = 0;

    for (Py_ssize_t r = 0; r < n; r++) {
        PyObject *item = PyList_GET_ITEM(list, r);
        Py_ssize_t blen;
        const char *bytes = PyUnicode_AsUTF8AndSize(item, &blen);
        if (!bytes) { /* not a str (or encode failure): fall back */
            PyErr_Clear();
            free(codes); free(table); free(uoff); free(arena);
            Py_RETURN_NONE;
        }
        const uint8_t *row = (const uint8_t *)bytes;

        /* SIMD-backed libc scans for both delimiters. */
        const uint8_t *dd =
            (const uint8_t *)memmem(row, (size_t)blen, "//", 2);
        const int64_t ts = dd ? (dd - row) + 2 : 0;
        const uint8_t *sl =
            (const uint8_t *)memchr(row + ts, '/', (size_t)(blen - ts));
        const int64_t te = sl ? sl - row : blen;
        const int64_t len = te - ts;

        /* Lower + hash in one sweep, keeping the lowered bytes so the
         * probe below compares with memcmp instead of re-lowering. */
        uint8_t low[LOW_BUF];
        uint64_t h = 1469598103934665603ULL; /* FNV-1a */
        int ascii = 1;
        for (int64_t i = ts; i < te; i++) {
            uint8_t c = row[i];
            if (c >= 128) { ascii = 0; break; }
            c = lower8(c);
            if (i - ts < LOW_BUF) low[i - ts] = c;
            h = (h ^ c) * 1099511628211ULL;
        }
        if (!ascii) { codes[r] = -1; continue; }

        int64_t slot = (int64_t)(h & (uint64_t)mask);
        for (;;) {
            const int32_t e = table[slot];
            if (e < 0) {
                if (ubytes + len > ucap) {
                    while (ubytes + len > ucap) ucap <<= 1;
                    uint8_t *na = (uint8_t *)realloc(arena, (size_t)ucap);
                    if (!na) {
                        free(codes); free(table); free(uoff); free(arena);
                        return PyErr_NoMemory();
                    }
                    arena = na;
                }
                if (len <= LOW_BUF) {
                    memcpy(arena + ubytes, low, (size_t)len);
                } else {
                    for (int64_t i = 0; i < len; i++)
                        arena[ubytes + i] = lower8(row[ts + i]);
                }
                ubytes += len;
                table[slot] = (int32_t)nuniq;
                codes[r] = (int32_t)nuniq;
                uoff[++nuniq] = ubytes;
                break;
            }
            const int64_t eo = uoff[e];
            if (uoff[e + 1] - eo == len) {
                if (len <= LOW_BUF
                        ? memcmp(arena + eo, low, (size_t)len) == 0
                        : eq_lowered(arena + eo, row + ts, len)) {
                    codes[r] = e;
                    break;
                }
            }
            slot = (slot + 1) & mask;
        }
    }
    free(table);

    PyObject *codes_b =
        PyBytes_FromStringAndSize((const char *)codes, (Py_ssize_t)n * 4);
    free(codes);
    PyObject *uniques = codes_b ? PyList_New((Py_ssize_t)nuniq) : NULL;
    if (uniques) {
        for (int64_t u = 0; u < nuniq; u++) {
            PyObject *s = PyUnicode_DecodeASCII(
                (const char *)arena + uoff[u],
                (Py_ssize_t)(uoff[u + 1] - uoff[u]), NULL);
            if (!s) { Py_CLEAR(uniques); break; }
            PyList_SET_ITEM(uniques, (Py_ssize_t)u, s);
        }
    }
    free(uoff); free(arena);
    if (!codes_b || !uniques) {
        Py_XDECREF(codes_b); Py_XDECREF(uniques);
        return NULL;
    }
    PyObject *out = PyTuple_Pack(2, codes_b, uniques);
    Py_DECREF(codes_b); Py_DECREF(uniques);
    return out;
}

/* CRC-32 (IEEE, zlib-compatible) over each string's UTF-8 bytes —
 * the native lowering of the host tier's _stable_obj_hash for str
 * columns (frame/ops.py): bit-identical to zlib.crc32(s.encode()).
 * Returns bytes(uint32[n]) or None when any element is not str. */
static uint32_t crc_table[256];
static int crc_table_ready = 0;

static void crc_init(void) {
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        crc_table[i] = c;
    }
    crc_table_ready = 1;
}

static PyObject *crc32_strings(PyObject *self, PyObject *args) {
    PyObject *list;
    if (!PyArg_ParseTuple(args, "O!", &PyList_Type, &list)) return NULL;
    if (!crc_table_ready) crc_init();
    const Py_ssize_t n = PyList_GET_SIZE(list);
    PyObject *out = PyBytes_FromStringAndSize(NULL, n * 4);
    if (!out) return NULL;
    uint32_t *h = (uint32_t *)PyBytes_AS_STRING(out);
    for (Py_ssize_t r = 0; r < n; r++) {
        Py_ssize_t blen;
        const char *bytes =
            PyUnicode_AsUTF8AndSize(PyList_GET_ITEM(list, r), &blen);
        if (!bytes) {
            PyErr_Clear();
            Py_DECREF(out);
            Py_RETURN_NONE;
        }
        uint32_t c = 0xFFFFFFFFu;
        for (Py_ssize_t i = 0; i < blen; i++)
            c = crc_table[(c ^ (uint8_t)bytes[i]) & 0xFF] ^ (c >> 8);
        h[r] = c ^ 0xFFFFFFFFu;
    }
    return out;
}

static PyMethodDef methods[] = {
    {"domains_encode", domains_encode, METH_VARARGS,
     "domains_encode(list[str]) -> (int32 codes bytes, uniques) | None"},
    {"crc32_strings", crc32_strings, METH_VARARGS,
     "crc32_strings(list[str]) -> bytes(uint32[n]) | None"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_strlist",
    "Native list-of-strings ingestion kernels.", -1, methods,
};

PyMODINIT_FUNC PyInit__strlist(void) {
    return PyModule_Create(&moduledef);
}
