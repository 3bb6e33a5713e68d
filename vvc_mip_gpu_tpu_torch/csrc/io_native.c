/* Host I/O of the PyTorch/CUDA port: the frame CSV reader and writer and
 * the decisions-CSV writer, in plain C with a C ABI (no Python headers).
 *
 * io/native.py builds this file with the host C compiler into a shared
 * library and binds it with ctypes, which releases the interpreter lock
 * for the length of each call: the CLI's writer thread formats one chunk's
 * CSVs while the calling thread searches the next chunk.  Every function
 * returns 0, or -1 with errno set (open, map, write or allocation failed).
 *
 * The outputs are byte for byte those of the numpy versions in io/frames.py
 * and io/export.py, which the tests and chip_smoke.py hold them against.
 */
#define _DEFAULT_SOURCE
#include <errno.h>
#include <fcntl.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

/* ------------------------------------------------------------------ */
/* Decimal formatting: two digits per step from a table.               */
/* ------------------------------------------------------------------ */
static const char DIGITS2[201] =
    "0001020304050607080910111213141516171819"
    "2021222324252627282930313233343536373839"
    "4041424344454647484950515253545556575859"
    "6061626364656667686970717273747576777879"
    "8081828384858687888990919293949596979899";

/* Write the decimal text of v at p ('-' first if negative); returns the
 * end.  At most 20 bytes. */
static inline char *put_i64(char *p, int64_t v)
{
    char tmp[24];
    char *t = tmp + sizeof tmp;
    uint64_t u = v < 0 ? 0 - (uint64_t)v : (uint64_t)v;
    while (u >= 100) {
        unsigned r = (unsigned)(u % 100);
        u /= 100;
        t -= 2;
        memcpy(t, DIGITS2 + 2 * r, 2);
    }
    if (u >= 10) {
        t -= 2;
        memcpy(t, DIGITS2 + 2 * u, 2);
    } else {
        *--t = (char)('0' + u);
    }
    if (v < 0)
        *p++ = '-';
    size_t n = (size_t)(tmp + sizeof tmp - t);
    memcpy(p, t, n);
    return p + n;
}

/* ------------------------------------------------------------------ */
/* Buffered output file: fwrite of whole blocks, every error kept.     */
/* ------------------------------------------------------------------ */
enum { OUT_CAP = 1 << 22, ROW_MAX = 512 };

typedef struct {
    FILE *f;
    char *buf;
    char *w;
    int err; /* errno of the first failure, 0 if none */
} Out;

static int out_open(Out *o, const char *path)
{
    o->buf = malloc(OUT_CAP);
    o->w = o->buf;
    o->err = 0;
    o->f = o->buf ? fopen(path, "wb") : NULL;
    if (!o->f) {
        int e = o->buf ? errno : ENOMEM;
        free(o->buf);
        errno = e;
        return -1;
    }
    return 0;
}

static void out_flush(Out *o)
{
    size_t n = (size_t)(o->w - o->buf);
    if (n && !o->err && fwrite(o->buf, 1, n, o->f) != n)
        o->err = errno ? errno : EIO;
    o->w = o->buf;
}

/* Room for one more row of at most ROW_MAX bytes. */
static inline void out_reserve(Out *o)
{
    if ((size_t)(o->w - o->buf) > OUT_CAP - ROW_MAX)
        out_flush(o);
}

static int out_close(Out *o)
{
    out_flush(o);
    if (fclose(o->f) != 0 && !o->err)
        o->err = errno ? errno : EIO;
    free(o->buf);
    if (o->err) {
        errno = o->err;
        return -1;
    }
    return 0;
}

/* ------------------------------------------------------------------ *
 * io_write_samples_csv: `rows` lines of `width` comma-separated       *
 * decimals (np.savetxt(path, samples, fmt="%d", delimiter=",")).      *
 * ------------------------------------------------------------------ */
int io_write_samples_csv(const char *path, const int64_t *samples,
                         int64_t rows, int64_t width)
{
    Out o;
    if (out_open(&o, path))
        return -1;
    for (int64_t r = 0; r < rows; r++) {
        const int64_t *row = samples + r * width;
        for (int64_t c = 0; c < width; c++) {
            out_reserve(&o);
            o.w = put_i64(o.w, row[c]);
            *o.w++ = c + 1 < width ? ',' : '\n';
        }
    }
    return out_close(&o);
}

/* ------------------------------------------------------------------ *
 * io_write_decisions_csv: the decisions log of `n_slabs` slabs of     *
 * `slab_len` rows,                                                    *
 *     [POC,]CTU,<head>,X,Y,Mode,SAD,SATD,minSadHad                    *
 * after the header line.                                              *
 *                                                                     *
 * pocs [n_slabs]: the POC column, or NULL for none.  ctus [n_slabs]:  *
 * each slab's CTU, on a grid of ctu_cols columns of ctu_size samples; *
 * X and Y are the CTU's origin plus x_in / y_in [slab_len].  heads:   *
 * slab_len strings "cuSizeName,W,H,CU", each at most HEAD_STRIDE - 1 *
 * bytes, at a stride of HEAD_STRIDE; head_len their lengths.  mode    *
 * [slab_len].  sad, satd, msh [n_slabs * slab_len]; sad or satd NULL  *
 * writes a 0 column.                                                  *
 *                                                                     *
 * What is constant per row of the slab is formatted once: the "<X>,"  *
 * strings per (grid column, slab row) and "<Y>," strings per (grid    *
 * row, slab row) on the first slab that needs them, "<Mode>," per     *
 * slab row, "[POC,]<CTU>," per slab.  A row is then fixed-size copies *
 * and one or three numbers.                                           *
 * ------------------------------------------------------------------ */
enum { HEAD_STRIDE = 32, NUM_STRIDE = 8 };

/* "<v>," at p, within NUM_STRIDE bytes: v has at most 6 digits. */
static uint8_t put_num_comma(char *p, int64_t v)
{
    char *e = put_i64(p, v);
    *e++ = ',';
    return (uint8_t)(e - p);
}

/* The "<origin + offs[i]>," strings of one grid column or row, formatted
 * when first needed: pool[k * slab_len + i] at NUM_STRIDE. */
static void fill_pool(char *pool, uint8_t *len, uint8_t *ready, int64_t k,
                      int64_t origin, const int64_t *offs, int64_t slab_len)
{
    if (ready[k])
        return;
    for (int64_t i = 0; i < slab_len; i++)
        len[k * slab_len + i] = put_num_comma(
            pool + (k * slab_len + i) * NUM_STRIDE, origin + offs[i]);
    ready[k] = 1;
}

int io_write_decisions_csv(const char *path, const char *header,
                           int64_t n_slabs, int64_t slab_len,
                           const int64_t *pocs, const int64_t *ctus,
                           int64_t ctu_cols, int64_t ctu_size,
                           const char *heads, const uint8_t *head_len,
                           const int64_t *x_in, const int64_t *y_in,
                           const int64_t *mode, const int64_t *sad,
                           const int64_t *satd, const int64_t *msh)
{
    int64_t grid_rows = 1;
    for (int64_t s = 0; s < n_slabs; s++)
        if (ctus[s] / ctu_cols + 1 > grid_rows)
            grid_rows = ctus[s] / ctu_cols + 1;
    size_t nx = (size_t)(ctu_cols * slab_len);
    size_t ny = (size_t)(grid_rows * slab_len);
    char *xpool = malloc(nx * NUM_STRIDE + 1);
    char *ypool = malloc(ny * NUM_STRIDE + 1);
    char *mpool = malloc((size_t)slab_len * NUM_STRIDE + 1);
    uint8_t *xlen = malloc(nx + 1), *ylen = malloc(ny + 1);
    uint8_t *mlen = malloc((size_t)slab_len + 1);
    uint8_t *xready = calloc((size_t)ctu_cols + 1, 1);
    uint8_t *yready = calloc((size_t)grid_rows + 1, 1);
    int rc = -1;
    Out o;
    if (!xpool || !ypool || !mpool || !xlen || !ylen || !mlen || !xready
        || !yready) {
        errno = ENOMEM;
        goto done;
    }
    if (out_open(&o, path))
        goto done;
    for (int64_t i = 0; i < slab_len; i++)
        mlen[i] = put_num_comma(mpool + i * NUM_STRIDE, mode[i]);
    size_t header_n = strlen(header);
    memcpy(o.w, header, header_n);
    o.w += header_n;
    for (int64_t s = 0; s < n_slabs; s++) {
        int64_t gc = ctus[s] % ctu_cols, gr = ctus[s] / ctu_cols;
        fill_pool(xpool, xlen, xready, gc, gc * ctu_size, x_in, slab_len);
        fill_pool(ypool, ylen, yready, gr, gr * ctu_size, y_in, slab_len);
        const char *xp = xpool + (size_t)(gc * slab_len) * NUM_STRIDE;
        const char *yp = ypool + (size_t)(gr * slab_len) * NUM_STRIDE;
        const uint8_t *xl = xlen + gc * slab_len, *yl = ylen + gr * slab_len;
        char lead[48];
        char *le = lead;
        if (pocs) {
            le = put_i64(le, pocs[s]);
            *le++ = ',';
        }
        le = put_i64(le, ctus[s]);
        *le++ = ',';
        size_t lead_n = (size_t)(le - lead);
        int64_t base = s * slab_len;
        for (int64_t i = 0; i < slab_len; i++) {
            out_reserve(&o);
            char *w = o.w;
            memcpy(w, lead, sizeof lead);
            w += lead_n;
            memcpy(w, heads + i * HEAD_STRIDE, HEAD_STRIDE);
            w += head_len[i];
            *w++ = ',';
            memcpy(w, xp + i * NUM_STRIDE, NUM_STRIDE);
            w += xl[i];
            memcpy(w, yp + i * NUM_STRIDE, NUM_STRIDE);
            w += yl[i];
            memcpy(w, mpool + i * NUM_STRIDE, NUM_STRIDE);
            w += mlen[i];
            if (sad)
                w = put_i64(w, sad[base + i]);
            else
                *w++ = '0';
            *w++ = ',';
            if (satd)
                w = put_i64(w, satd[base + i]);
            else
                *w++ = '0';
            *w++ = ',';
            w = put_i64(w, msh[base + i]);
            *w++ = '\n';
            o.w = w;
        }
    }
    rc = out_close(&o);
done:
    free(xpool);
    free(ypool);
    free(mpool);
    free(xlen);
    free(ylen);
    free(mlen);
    free(xready);
    free(yready);
    return rc;
}

/* ------------------------------------------------------------------ *
 * io_read_samples_csv: the samples of `rows` lines after the first    *
 * `skip_rows` lines of a frame CSV, exactly as the numpy reader       *
 * (io/frames.py read_frames_csv_plain) parses them: it strips each    *
 * line's trailing "\r\n" characters, joins the lines with ',' and     *
 * reads the text with np.fromstring(text, np.int64, sep=","), which   *
 * parses each element like CPython's PyOS_strtol (leading space, a    *
 * sign, space again, digits; a sign or space alone reads as 0;        *
 * overflow reads as INT64_MAX) and stops at the first element or      *
 * separator that does not parse.                                      *
 *                                                                     *
 * Writes the first rows * width samples to out (as uint16) and        *
 * stats[4] = {lines read, samples parsed, every line has width - 1    *
 * commas, every parsed sample is in 0..65535}; the caller raises the  *
 * numpy reader's errors from these.                                   *
 * ------------------------------------------------------------------ */
static inline int is_space(char c)
{
    return c == ' ' || (c >= '\t' && c <= '\r');
}

typedef struct {
    uint16_t *out;
    int64_t cap;      /* samples that fit in out */
    int64_t count;    /* samples parsed */
    int in_range;     /* every parsed sample in 0..65535 */
    int stopped;      /* the parse met the end or unmatched text */
} Parse;

/* Parse one stripped line s[0..n) of the joined text; `more` is 1 when a
 * ',' joins it to the next line.  Elements never span that ','. */
static void parse_line(Parse *st, const char *s, int64_t n, int more)
{
    const int64_t len = n + more;
#define CH(i) ((i) < n ? s[(i)] : ',')
    int64_t pos = 0;
    while (!st->stopped) {
        if (pos == len) {
            if (!more)
                st->stopped = 1;   /* end of the text */
            return;
        }
        /* one element, as PyOS_strtol(text + pos, &end, 10) */
        int64_t p = pos;
        while (p < len && is_space(CH(p)))
            p++;
        int neg = 0;
        if (p < len && (CH(p) == '+' || CH(p) == '-')) {
            neg = CH(p) == '-';
            p++;
        }
        while (p < len && is_space(CH(p)))
            p++;
        uint64_t u = 0;
        int overflow = 0;
        while (p < len && CH(p) >= '0' && CH(p) <= '9') {
            unsigned d = (unsigned)(CH(p) - '0');
            if (u > (UINT64_MAX - d) / 10)
                overflow = 1;
            else
                u = u * 10 + d;
            p++;
        }
        if (p == pos) {
            st->stopped = 1;       /* nothing read */
            return;
        }
        /* in 0..65535 exactly when no overflow, and 0 if negative */
        int ok = !overflow && u <= 65535 && !(neg && u);
        if (!ok)
            st->in_range = 0;
        if (st->count < st->cap)
            st->out[st->count] = (uint16_t)(ok ? u : 0);
        st->count++;
        /* the separator: spaces, then ',' */
        pos = p;
        while (pos < len && is_space(CH(pos)))
            pos++;
        if (pos == len || CH(pos) != ',') {
            st->stopped = 1;       /* end, or unmatched text */
            return;
        }
        pos++;
    }
#undef CH
}

int io_read_samples_csv(const char *path, int64_t width, int64_t rows,
                        int64_t skip_rows, uint16_t *out, int64_t *stats)
{
    int fd = open(path, O_RDONLY);
    if (fd < 0)
        return -1;
    struct stat sb;
    if (fstat(fd, &sb) != 0) {
        int e = errno;
        close(fd);
        errno = e;
        return -1;
    }
    size_t size = (size_t)sb.st_size;
    const char *data = NULL;
    if (size) {
        void *m = mmap(NULL, size, PROT_READ, MAP_PRIVATE, fd, 0);
        if (m == MAP_FAILED) {
            int e = errno;
            close(fd);
            errno = e;
            return -1;
        }
        data = m;
        madvise(m, size, MADV_SEQUENTIAL);
    }
    close(fd);

    const char *p = data, *end = data + size;
    for (int64_t r = 0; r < skip_rows && p < end; r++) {
        const char *nl = memchr(p, '\n', (size_t)(end - p));
        p = nl ? nl + 1 : end;
    }
    Parse st = {out, rows * width, 0, 1, 0};
    int64_t lines = 0;
    int commas_ok = 1;
    while (lines < rows && p < end) {
        const char *nl = memchr(p, '\n', (size_t)(end - p));
        const char *stop = nl ? nl : end;
        const char *next = nl ? nl + 1 : end;
        while (stop > p && stop[-1] == '\r')
            stop--;
        int64_t commas = 0;
        for (const char *c = p; (c = memchr(c, ',', (size_t)(stop - c)));
             c++)
            commas++;
        if (commas != width - 1)
            commas_ok = 0;
        lines++;
        /* a ',' joins this line to the next one the reader takes */
        int more = lines < rows && next < end;
        parse_line(&st, p, stop - p, more);
        p = next;
    }
    if (size)
        munmap((void *)data, size);
    stats[0] = lines;
    stats[1] = st.count;
    stats[2] = commas_ok;
    stats[3] = st.in_range;
    return 0;
}
