/* The port's native host-I/O library: the shared parser source, unchanged,
 * plus the entries only the port calls.
 *
 * ``fastqdedup_tpu/native/_fastq_io.c`` is included as it is, so every
 * entry of the JAX package's library exists here with the same code; the
 * functions below only add to it.  Built by native/build.py.
 *
 * Split ingest (pipeline._plan_split_ranges): one BGZF file is cut at
 * compressed member boundaries b_0 = 0 < b_1 < ... found without
 * inflating anything (fq_scan_boundary), and reader p parses the
 * decompressed bytes [T_p, T_{p+1}), where T_p is the first record start
 * after member b_p's first newline (fq_record_start).  A record start is
 * told apart by two lines: a line that starts with '@' and whose
 * next-but-one line starts with '+' is a header (two lines after a
 * header comes the separator; two lines after a quality line that starts
 * with '@' comes the next sequence line, which starts with neither).  A
 * reader's stream ends exactly at the next reader's start, so a wrong
 * seam, possible only on malformed input, leaves a cut record at the end
 * of the reader before it, which the parser refuses. */

#include "../../fastqdedup_tpu/native/_fastq_io.c"

#define FQ_START_EOF (-1)
#define FQ_START_IO (-2)
#define FQ_START_BAD_GZIP (-3)
#define FQ_START_NOT_FOUND (-4)
#define FQ_START_NOMEM (-5)
#define FQ_START_LINES 6  /* line starts read after the first newline */

/* Decompressed bytes of the members from a file offset on, inflated one
 * member at a time on the calling thread, as far as a caller asks. */
typedef struct {
    int fd;
    int64_t fsize;
    int64_t pos;             /* next member's file offset */
    unsigned char *comp;     /* one member's compressed bytes */
    unsigned char *data;     /* decompressed bytes so far */
    size_t len, cap;
    int eof;
    void *ldd;
    z_stream zs;
    int zs_ok;
} MemberStream;

/* Inflate members until byte `want` exists or the file ends.  Returns 0,
 * or an FQ_START_* error code. */
static int ms_need(MemberStream *m, size_t want) {
    while (m->len <= want && !m->eof) {
        if (m->pos >= m->fsize) {
            m->eof = 1;
            break;
        }
        ssize_t got = pread(m->fd, m->comp, BGZF_MAX_BLOCK, m->pos);
        if (got < 0) return FQ_START_IO;
        size_t msize, poff, plen, isize;
        if (bg_parse_member(m->comp, (size_t)got, &msize, &poff, &plen,
                            &isize) != 1)
            return FQ_START_BAD_GZIP;
        if (isize > SLOT_PAYLOAD) return FQ_START_BAD_GZIP;
        if (m->len + isize > m->cap) {
            size_t nc = m->cap ? m->cap : (1 << 16);
            while (nc < m->len + isize) nc *= 2;
            unsigned char *nb = (unsigned char *)realloc(m->data, nc);
            if (!nb) return FQ_START_NOMEM;
            m->data = nb;
            m->cap = nc;
        }
        if (isize && inflate_block(m->ldd, &m->zs, m->comp + poff, plen,
                                   m->data + m->len, isize))
            return FQ_START_BAD_GZIP;
        m->len += isize;
        m->pos += (int64_t)msize;
    }
    return 0;
}

/* Offset just past the first newline at or after `from`, in *out; -1
 * when the data ends first.  Returns 0 or an FQ_START_* error code. */
static int ms_next_line(MemberStream *m, size_t from, int64_t *out) {
    for (;;) {
        if (from < m->len) {
            const unsigned char *nl = (const unsigned char *)memchr(
                m->data + from, '\n', m->len - from);
            if (nl) {
                *out = (int64_t)(nl - m->data) + 1;
                return 0;
            }
            from = m->len;
        }
        if (m->eof) {
            *out = -1;
            return 0;
        }
        int rc = ms_need(m, m->len);
        if (rc) return rc;
    }
}

/* Does a line start at `at` (a byte exists there)? */
static int ms_has(MemberStream *m, int64_t at, int *rc) {
    if (at < 0) return 0;
    *rc = ms_need(m, (size_t)at);
    return !*rc && (size_t)at < m->len;
}

/* First record start after the first newline of the decompressed bytes
 * that begin at the BGZF member at file offset `member`.
 *
 * Of the four line starts after that newline one is a header in a
 * well-formed file; the first of them that starts with '@' and whose
 * next-but-one line starts with '+' is taken.  Returns its decompressed
 * offset t from the member's first byte, and copies the first min(t,
 * cap) bytes into `out` (the bytes the reader before this seam parses
 * last).  FQ_START_EOF: no record starts after that newline (the data
 * ends first).  FQ_START_NOT_FOUND: none of the four lines qualifies,
 * which only malformed input gives.  Other negative values: read error,
 * not a BGZF member, out of memory. */
int64_t fq_record_start(const char *path, int64_t member,
                        unsigned char *out, int64_t cap) {
    MemberStream m;
    memset(&m, 0, sizeof(m));
    m.fd = open(path, O_RDONLY);
    if (m.fd < 0) return FQ_START_IO;
    m.fsize = (int64_t)lseek(m.fd, 0, SEEK_END);
    m.pos = member;
    m.comp = (unsigned char *)malloc(BGZF_MAX_BLOCK);
    pthread_once(&ld_once, ld_init);
    m.ldd = ld_alloc ? ld_alloc() : NULL;
    if (!m.ldd) m.zs_ok = inflateInit2(&m.zs, -15) == Z_OK;
    int64_t result = FQ_START_NOT_FOUND;
    int rc = 0;
    if (m.fsize < 0) {
        result = FQ_START_IO;
        goto done;
    }
    if (!m.comp || (!m.ldd && !m.zs_ok)) {
        result = FQ_START_NOMEM;
        goto done;
    }
    /* starts[k]: offset of line k after the first newline, -1 if the
     * data ends before it. */
    int64_t starts[FQ_START_LINES];
    int64_t at = 0;
    for (int k = 0; k < FQ_START_LINES; k++) {
        if (at >= 0) {
            rc = ms_next_line(&m, (size_t)at, &at);
            if (rc) break;
        }
        starts[k] = at;
    }
    if (rc) {
        result = rc;
        goto done;
    }
    for (int k = 0; k < 4; k++) {
        int has = ms_has(&m, starts[k], &rc);
        if (rc) { result = rc; goto done; }
        if (!has) {
            result = FQ_START_EOF;
            goto done;
        }
        if (m.data[starts[k]] != '@') continue;
        has = ms_has(&m, starts[k + 2], &rc);
        if (rc) { result = rc; goto done; }
        if (!has) {
            /* Fewer than three lines left: no whole record starts here
             * or after. */
            result = FQ_START_EOF;
            goto done;
        }
        if (m.data[starts[k + 2]] == '+') {
            result = starts[k];
            break;
        }
    }
    if (result >= 0 && cap > 0)
        memcpy(out, m.data, (size_t)(result < cap ? result : cap));
done:
    if (m.ldd) ld_free(m.ldd);
    if (m.zs_ok) inflateEnd(&m.zs);
    free(m.comp);
    free(m.data);
    close(m.fd);
    return result;
}

/* A split reader: the parser's FqReader first, so the handle is also an
 * FqReader for fq_next_chunk / fq_error.  Its ring is filled by a relay
 * thread instead of bga_producer: the relay takes the slots of an inner
 * range reader over the members [lo, hi), drops the first `skip` bytes,
 * and appends `tail`, the bytes of the members from hi to the next
 * reader's start.  Slots change hands by swapping buffers; no payload is
 * copied except the tail. */
typedef struct {
    FqReader r;
    FqReader *inner;
    unsigned char *tail;
    size_t tail_len;
    int64_t skip;
    int64_t tail_end;        /* raw_end reported for the tail's slots */
    int stop;                /* set by fq_close_split under the inner mu */
    pthread_t relay;
    int relay_started;
} FqSplit;

/* Take a FREE slot of the split reader's ring; -1 on shutdown. */
static int split_free_slot(BgzfAsync *a) {
    int idx = -1;
    pthread_mutex_lock(&a->mu);
    while (!a->shutdown) {
        for (int i = 0; i < BGZF_SLOTS; i++)
            if (a->state[i] == SLOT_FREE) { idx = i; break; }
        if (idx >= 0) {
            a->state[idx] = SLOT_FILLING;
            break;
        }
        pthread_cond_wait(&a->cv_prod, &a->mu);
    }
    pthread_mutex_unlock(&a->mu);
    return idx;
}

static void split_publish(BgzfAsync *a, int idx) {
    pthread_mutex_lock(&a->mu);
    a->state[idx] = SLOT_READY;
    a->ready_q[(a->rq_head + a->rq_len) % BGZF_SLOTS] = idx;
    a->rq_len++;
    pthread_cond_broadcast(&a->cv_cons);
    pthread_mutex_unlock(&a->mu);
}

static void *split_relay(void *arg) {
    FqSplit *s = (FqSplit *)arg;
    BgzfAsync *out = s->r.async;
    int err = 0;
    int64_t skip = s->skip;
    if (s->inner) {
        BgzfAsync *in = s->inner->async;
        for (;;) {
            pthread_mutex_lock(&in->mu);
            while (in->rq_len == 0 && !in->eof && !in->err && !s->stop)
                pthread_cond_wait(&in->cv_cons, &in->mu);
            if (s->stop || in->rq_len == 0) {
                if (!s->stop && in->err) {
                    err = in->err;
                    memcpy(s->r.error, s->inner->error, sizeof(s->r.error));
                }
                pthread_mutex_unlock(&in->mu);
                break;
            }
            int idx = in->ready_q[in->rq_head];
            in->rq_head = (in->rq_head + 1) % BGZF_SLOTS;
            in->rq_len--;
            in->state[idx] = SLOT_HELD;
            pthread_mutex_unlock(&in->mu);

            BgzfSlot *is = &in->slots[idx];
            size_t drop = (int64_t)is->len < skip ? is->len : (size_t)skip;
            skip -= (int64_t)drop;
            int o = -1;
            if (is->len > drop) {
                o = split_free_slot(out);
                if (o >= 0) {
                    unsigned char *payload = is->data + SLOT_HEADROOM;
                    if (drop)
                        memmove(payload, payload + drop, is->len - drop);
                    BgzfSlot *os = &out->slots[o];
                    unsigned char *swap = os->data;
                    os->data = is->data;
                    is->data = swap;
                    os->len = is->len - drop;
                    os->raw_end = is->raw_end;
                }
            }
            pthread_mutex_lock(&in->mu);
            in->state[idx] = SLOT_FREE;
            pthread_cond_broadcast(&in->cv_prod);
            pthread_mutex_unlock(&in->mu);
            if (o >= 0)
                split_publish(out, o);
            else if (is->len > drop)
                break;  /* shut down while waiting for a slot */
        }
    }
    size_t from = skip < (int64_t)s->tail_len ? (size_t)skip : s->tail_len;
    while (!err && from < s->tail_len) {
        int o = split_free_slot(out);
        if (o < 0) break;
        BgzfSlot *os = &out->slots[o];
        size_t n = s->tail_len - from;
        if (n > os->cap) n = os->cap;
        memcpy(os->data + SLOT_HEADROOM, s->tail + from, n);
        os->len = n;
        os->raw_end = s->tail_end;
        from += n;
        split_publish(out, o);
    }
    pthread_mutex_lock(&out->mu);
    if (err) out->err = err;
    else out->eof = 1;
    pthread_cond_broadcast(&out->cv_cons);
    pthread_mutex_unlock(&out->mu);
    return NULL;
}

void fq_close_split(FqReader *r);

/* Open a split reader over the decompressed bytes of the members [lo, hi)
 * (hi < 0: to EOF) followed by `tail`, less their first `skip` bytes.
 * `lo` must be a member boundary.  NULL when the file cannot be opened as
 * BGZF or memory runs out. */
FqReader *fq_open_split(const char *path, int64_t lo, int64_t hi,
                        int64_t skip, const unsigned char *tail,
                        int64_t tail_len) {
    FqSplit *s = (FqSplit *)calloc(1, sizeof(FqSplit));
    if (!s) return NULL;
    FqReader *r = &s->r;
    r->error_line = -1;
    r->range_hi = -1;
    r->bgzf = 1;
    r->fd = -1;
    r->held_slot = -1;
    r->range_mode = 1;
    r->buf_cap = 64;
    r->buf = (unsigned char *)malloc(r->buf_cap);
    r->buf0 = r->buf;
    s->skip = skip;
    s->tail_end = hi;
    BgzfAsync *a = (BgzfAsync *)calloc(1, sizeof(BgzfAsync));
    if (!r->buf || !a) {
        free(a);
        fq_close_split(r);
        return NULL;
    }
    a->r = r;
    pthread_mutex_init(&a->mu, NULL);
    pthread_cond_init(&a->cv_prod, NULL);
    pthread_cond_init(&a->cv_cons, NULL);
    pthread_cond_init(&a->cv_help, NULL);
    pthread_cond_init(&a->cv_hdone, NULL);
    r->async = a;
    for (int i = 0; i < BGZF_SLOTS; i++) {
        a->slots[i].cap = SLOT_PAYLOAD;
        a->slots[i].data =
            (unsigned char *)malloc(SLOT_HEADROOM + SLOT_PAYLOAD);
        a->state[i] = SLOT_FREE;
        if (!a->slots[i].data) {
            fq_close_split(r);
            return NULL;
        }
    }
    if (tail_len > 0) {
        s->tail = (unsigned char *)malloc((size_t)tail_len);
        if (!s->tail) {
            fq_close_split(r);
            return NULL;
        }
        memcpy(s->tail, tail, (size_t)tail_len);
        s->tail_len = (size_t)tail_len;
    }
    s->inner = fq_open_range(path, lo, hi);
    if (!s->inner || bga_start(s->inner) != FQ_OK) {
        fq_close_split(r);
        return NULL;
    }
    if (pthread_create(&s->relay, NULL, split_relay, s) != 0) {
        fq_close_split(r);
        return NULL;
    }
    s->relay_started = 1;
    return r;
}

void fq_close_split(FqReader *r) {
    if (!r) return;
    FqSplit *s = (FqSplit *)r;
    BgzfAsync *a = r->async;
    if (s->relay_started) {
        BgzfAsync *in = s->inner->async;
        pthread_mutex_lock(&in->mu);
        s->stop = 1;
        pthread_cond_broadcast(&in->cv_cons);
        pthread_mutex_unlock(&in->mu);
        pthread_mutex_lock(&a->mu);
        a->shutdown = 1;
        pthread_cond_broadcast(&a->cv_prod);
        pthread_mutex_unlock(&a->mu);
        pthread_join(s->relay, NULL);
    }
    if (s->inner) fq_close(s->inner);
    if (a) {
        for (int i = 0; i < BGZF_SLOTS; i++) free(a->slots[i].data);
        pthread_mutex_destroy(&a->mu);
        pthread_cond_destroy(&a->cv_prod);
        pthread_cond_destroy(&a->cv_cons);
        pthread_cond_destroy(&a->cv_help);
        pthread_cond_destroy(&a->cv_hdone);
        free(a);
    }
    free(r->buf0);
    free(r->big_buf);
    free(r->pend_head);
    free(r->pend_qual);
    free(r->pend_seq);
    free(s->tail);
    free(s);
}

/* Key-table export (native/loader.py: KeyAccumulator.export and
 * ShardedKeyAccumulator.export), in place of the shared acc_export.
 * That one copies through par_memcpy, whose 8 pieces of
 * round_up(n / 8, 4096) bytes end short of n where n / 8 is itself a
 * multiple of 4096 (n >= 8 MiB, n mod 32768 in 1..7): the last n mod 8
 * key bytes are never copied and keep whatever the destination held, a
 * recycled buffer's stale bytes included.  The pieces always reach
 * 8 * (n / 8) = n - n mod 8, so copying the last n mod 8 bytes again
 * completes the arena.  The count, position and offset arrays are
 * multiples of 8 bytes and are never cut. */
void acc_export_port(const KeyAcc *a, unsigned char *key_out,
                     int64_t *offsets_out, int64_t *counts_out,
                     int64_t *firstpos_out) {
    acc_export(a, key_out, offsets_out, counts_out, firstpos_out);
    size_t tail = a->arena_len & 7;
    memcpy(key_out + a->arena_len - tail, a->arena + a->arena_len - tail,
           tail);
}
