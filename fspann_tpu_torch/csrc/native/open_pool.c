/* A batch's whole candidate read in one native pass, on a persistent pool
 * of host threads: the metadata lookup, the arena bounds guard and the
 * AES-256-GCM record open (fused with the norm and query dot, or writing
 * f32 staging rows).  PointStore.load_score_batch and load_decrypt_batch
 * are this pass (through store/parallel_read.py).
 *
 * The record open itself is aes_gcm.c's, included below, so this library
 * computes exactly what the JAX package's store computes with one
 * aes_gcm.c call per key version: per candidate slot s, with its
 * output row r = rows[s] (r = s where rows is NULL),
 *   kv  = meta_kv[ids[s]]   (0 absent, < 0 tombstoned: a miss, ok = 0)
 *   off = meta_off[ids[s]]  (outside [0, arena size - record) : a miss)
 *   open the record at bases[kv] + off under ctxs[kv], AAD from
 *   (ids[s], kv, dim), into staging row r or into norms[r] / dots[r]
 *   against qvecs[r / rows_per_query]; its ok lands at ok[s].
 * In score mode (pt == NULL) a miss zeroes norms[r] and dots[r]; in
 * staging mode it leaves row r and norms[r] untouched, as the JAX
 * package's reader does.  A failed tag zeroes the row and its norm and dot.
 *
 * The pool: one process-wide set of detached worker threads, started at
 * first use and grown to the widest call seen.  A call cuts its slots into
 * contiguous chunks that the caller and up to width - 1 workers take in
 * turn from a shared counter; chunk outputs are disjoint.  Idle workers
 * sleep on a condition variable.  A call that finds the pool serving
 * another caller runs on its own thread alone.  A forked child starts with
 * no pool (pthread_atfork) and builds its own at its first wide call.
 *
 * Build: gcc -O3 -maes -mpclmul -mssse3 -msse4.1 -mf16c -pthread -shared
 *        -fPIC (the flags of aes_gcm.c; the expanded key contexts that
 *        libfspann_crypto.so makes are passed in and read as gcm_ctx)
 */

#include "aes_gcm.c"

#include <signal.h>
#include <stdatomic.h>

#define POOL_MAX 256        /* workers, the caller not counted */
#define CHUNK_MIN 64        /* slots a chunk: the least worth a hand-off */
#define CHUNK_MAX 1024      /* and the most, so that chunks balance */
#define CHUNKS_PER_WIDTH 8

/* arena record: 20-byte header, then the 12-byte IV, the body, the tag */
#define REC_IV 20u
#define REC_CT 32u
#define REC_TAG 16u

typedef struct {
    size_t n;
    const int64_t *ids;
    const int64_t *rows;           /* output row per slot, or NULL: s */
    const int32_t *meta_kv;
    const int64_t *meta_off;
    uint64_t meta_cap;
    uint32_t n_versions;           /* table rows: key versions 0 .. n - 1 */
    const uint64_t *ctxs;          /* gcm_ctx address per version, or 0 */
    const uint64_t *bases;         /* arena base address per version */
    const uint64_t *sizes;         /* arena bytes per version */
    uint32_t body, dim;
    int payload_kind;
    uint8_t *pt;                   /* f32 staging rows, or NULL: score */
    float *norms, *dots;
    const float *qvecs;
    uint64_t rows_per_query;
    uint8_t *ok;
    size_t chunk, n_chunks;
    int width;                     /* the caller and width - 1 workers */
    int joined;                    /* workers in this call (pool mutex) */
    atomic_size_t next;            /* the next chunk to take */
    atomic_int took;               /* threads that took at least a chunk */
    atomic_int failures;           /* failed tags */
} pool_job;

/* The chunk's records of key version v, opened through aes_gcm.c's record
 * loop; each one's ok lands in its slot. */
static int open_version(const pool_job *j, uint32_t v, size_t m,
                        const uint64_t *rec_off, const uint64_t *pt_off,
                        const int64_t *cid, const size_t *slot) {
    uint8_t cok[CHUNK_MAX];
    int failures = open_batch_rec_id_range(
        (const void *)(uintptr_t)j->ctxs[v], 0, m,
        (const uint8_t *)(uintptr_t)j->bases[v], rec_off, REC_IV, REC_CT,
        REC_CT + j->body, j->body, cid, v, j->dim, j->pt, pt_off, cok,
        j->norms, j->payload_kind, j->qvecs, j->rows_per_query, j->dots);
    for (size_t i = 0; i < m; i++)
        j->ok[slot[i]] = cok[i];
    return failures;
}

/* One chunk: look up its slots, then open the present ones, one key
 * version at a time. */
static int open_chunk(const pool_job *j, size_t lo, size_t hi) {
    uint64_t rec_off[CHUNK_MAX], pt_off[CHUNK_MAX];
    int64_t cid[CHUNK_MAX];
    size_t slot[CHUNK_MAX];
    uint32_t ver[CHUNK_MAX];
    const uint64_t row_bytes = 4ull * j->dim;
    const uint64_t rec_end = REC_CT + (uint64_t)j->body + REC_TAG;
    const int score = (j->pt == NULL);
    size_t m = 0;
    int mixed = 0;
    for (size_t s = lo; s < hi; s++) {
        const int64_t id = j->ids[s];
        const uint64_t row = j->rows ? (uint64_t)j->rows[s] : s;
        int32_t kv = 0;
        int64_t off = -1;
        if (id >= 0 && (uint64_t)id < j->meta_cap) {
            kv = j->meta_kv[id];
            off = j->meta_off[id];
        }
        if (kv <= 0 || (uint32_t)kv >= j->n_versions || !j->ctxs[kv]
                || off < 0 || (uint64_t)off + rec_end > j->sizes[kv]) {
            j->ok[s] = 0;
            if (score) {
                j->norms[row] = 0.f;
                j->dots[row] = 0.f;
            }
            continue;
        }
        rec_off[m] = (uint64_t)off;
        pt_off[m] = row * row_bytes;
        cid[m] = id;
        slot[m] = s;
        ver[m] = (uint32_t)kv;
        mixed |= (ver[m] != ver[0]);
        m++;
    }
    if (!mixed)
        return m ? open_version(j, ver[0], m, rec_off, pt_off, cid, slot)
                 : 0;
    /* several versions (a rotation under way): each version's records in
     * their order, gathered apart */
    uint64_t v_rec[CHUNK_MAX], v_pt[CHUNK_MAX];
    int64_t v_id[CHUNK_MAX];
    size_t v_slot[CHUNK_MAX];
    int failures = 0;
    for (size_t first = 0; first < m; first++) {
        const uint32_t v = ver[first];
        if (v == 0)
            continue;                     /* opened with an earlier one */
        size_t k = 0;
        for (size_t i = first; i < m; i++) {
            if (ver[i] != v)
                continue;
            v_rec[k] = rec_off[i]; v_pt[k] = pt_off[i];
            v_id[k] = cid[i]; v_slot[k] = slot[i];
            ver[i] = 0;
            k++;
        }
        failures += open_version(j, v, k, v_rec, v_pt, v_id, v_slot);
    }
    return failures;
}

static void run_job(pool_job *j) {
    int took = 0, failures = 0;
    for (;;) {
        size_t c = atomic_fetch_add(&j->next, 1);
        if (c >= j->n_chunks)
            break;
        size_t lo = c * j->chunk;
        size_t hi = lo + j->chunk < j->n ? lo + j->chunk : j->n;
        failures += open_chunk(j, lo, hi);
        took = 1;
    }
    if (took)
        atomic_fetch_add(&j->took, 1);
    atomic_fetch_add(&j->failures, failures);
}

/* ------------------------------------------------------------------ */
/* The pool                                                            */
/* ------------------------------------------------------------------ */

static pthread_mutex_t pool_mu = PTHREAD_MUTEX_INITIALIZER;
static pthread_cond_t pool_work = PTHREAD_COND_INITIALIZER;
static pthread_cond_t pool_done = PTHREAD_COND_INITIALIZER;
static int pool_threads;            /* workers started */
static int pool_busy;               /* a caller owns the pool */
static int pool_active;             /* workers inside the posted job */
static unsigned long pool_gen;      /* bumped at each posted job */
static pool_job *pool_job_now;      /* the posted job, or NULL */
static pthread_once_t pool_atfork_once = PTHREAD_ONCE_INIT;

static void *pool_worker(void *arg) {
    unsigned long seen = (unsigned long)(uintptr_t)arg;
    pthread_mutex_lock(&pool_mu);
    for (;;) {
        while (pool_gen == seen)
            pthread_cond_wait(&pool_work, &pool_mu);
        seen = pool_gen;
        pool_job *j = pool_job_now;
        if (j == NULL || j->joined >= j->width - 1)
            continue;
        j->joined++;
        pool_active++;
        pthread_mutex_unlock(&pool_mu);
        run_job(j);
        pthread_mutex_lock(&pool_mu);
        if (--pool_active == 0)
            pthread_cond_signal(&pool_done);
    }
    return NULL;
}

/* fork: hold the mutex across it, so that the child's copy is consistent;
 * the child has none of the parent's threads, so it starts with no pool */
static void pool_prepare(void) { pthread_mutex_lock(&pool_mu); }
static void pool_parent(void) { pthread_mutex_unlock(&pool_mu); }
static void pool_child(void) {
    pthread_mutex_init(&pool_mu, NULL);
    pthread_cond_init(&pool_work, NULL);
    pthread_cond_init(&pool_done, NULL);
    pool_threads = 0;
    pool_busy = 0;
    pool_active = 0;
    pool_job_now = NULL;
}
static void pool_register_atfork(void) {
    pthread_atfork(pool_prepare, pool_parent, pool_child);
}

/* Start workers up to `want` (pool mutex held).  They take no signals,
 * and are detached: nothing joins them, and the process exits past them. */
static void pool_grow(int want) {
    if (want > POOL_MAX)
        want = POOL_MAX;
    if (pool_threads >= want)
        return;
    pthread_once(&pool_atfork_once, pool_register_atfork);
    pthread_attr_t attr;
    sigset_t all, old;
    pthread_attr_init(&attr);
    pthread_attr_setdetachstate(&attr, PTHREAD_CREATE_DETACHED);
    sigfillset(&all);
    pthread_sigmask(SIG_SETMASK, &all, &old);
    while (pool_threads < want) {
        pthread_t t;
        if (pthread_create(&t, &attr, pool_worker,
                           (void *)(uintptr_t)pool_gen) != 0)
            break;       /* fewer workers; the callers take their chunks */
        pool_threads++;
    }
    pthread_sigmask(SIG_SETMASK, &old, NULL);
    pthread_attr_destroy(&attr);
}

int fspann_open_pool_threads(void) {
    pthread_mutex_lock(&pool_mu);
    int n = pool_threads;
    pthread_mutex_unlock(&pool_mu);
    return n;
}

/* The batch's read: see the head of this file.  `width` is the caller and
 * the workers that may take chunks; 1 runs on the caller alone.  Writes
 * the threads that took a chunk to *workers; returns the failed tags. */
int fspann_open_pool_run(size_t n, const int64_t *ids,
                         const int64_t *rows, const int32_t *meta_kv,
                         const int64_t *meta_off, uint64_t meta_cap,
                         uint32_t n_versions,
                         const uint64_t *ctxs, const uint64_t *bases,
                         const uint64_t *sizes, uint32_t body, uint32_t dim,
                         int payload_kind, uint8_t *pt, float *norms,
                         float *dots, const float *qvecs,
                         uint64_t rows_per_query, uint8_t *ok, int width,
                         int *workers) {
    pool_job j;
    memset(&j, 0, sizeof j);
    j.n = n; j.ids = ids; j.rows = rows; j.meta_kv = meta_kv;
    j.meta_off = meta_off; j.meta_cap = meta_cap; j.n_versions = n_versions;
    j.ctxs = ctxs;
    j.bases = bases; j.sizes = sizes; j.body = body; j.dim = dim;
    j.payload_kind = payload_kind; j.pt = pt; j.norms = norms;
    j.dots = dots; j.qvecs = qvecs;
    j.rows_per_query = rows_per_query ? rows_per_query : 1;
    j.ok = ok;
    if (width < 1)
        width = 1;
    if (width > POOL_MAX + 1)
        width = POOL_MAX + 1;
    size_t chunk = (n + (size_t)width * CHUNKS_PER_WIDTH - 1)
                   / ((size_t)width * CHUNKS_PER_WIDTH);
    if (chunk < CHUNK_MIN) chunk = CHUNK_MIN;
    if (chunk > CHUNK_MAX) chunk = CHUNK_MAX;
    j.chunk = chunk;
    j.n_chunks = (n + chunk - 1) / chunk;
    j.width = width;
    atomic_init(&j.next, 0);
    atomic_init(&j.took, 0);
    atomic_init(&j.failures, 0);

    int pooled = 0;
    if (width > 1 && j.n_chunks > 1) {
        pthread_mutex_lock(&pool_mu);
        if (!pool_busy) {
            pool_grow(width - 1);
            pool_busy = 1;
            pool_job_now = &j;
            pool_gen++;
            /* one wake for all: a signal per worker (a futex call each)
             * made reads of 512-4,096 candidates 12-44% slower on the
             * H100 host */
            pthread_cond_broadcast(&pool_work);
            pooled = 1;
        }
        pthread_mutex_unlock(&pool_mu);
    }
    run_job(&j);
    if (pooled) {
        /* every chunk is taken; wait for the workers still opening, then
         * withdraw the job before it leaves this stack frame */
        pthread_mutex_lock(&pool_mu);
        while (pool_active > 0)
            pthread_cond_wait(&pool_done, &pool_mu);
        pool_job_now = NULL;
        pool_busy = 0;
        pthread_mutex_unlock(&pool_mu);
    }
    *workers = atomic_load(&j.took);
    return atomic_load(&j.failures);
}
