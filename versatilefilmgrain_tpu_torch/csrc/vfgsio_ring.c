/* vfgsio_ring -- the frame loop's pipelined frame I/O, over the caller's
 * memory.
 *
 * A reader with a background pthread reads whole frames ahead into a ring
 * (read-ahead hides disk and pipe latency), and a writer with a background
 * pthread drains a ring, so the frame loop never blocks on read(2) or
 * write(2).  A ring is nbuf frames of frame_bytes back to back, in memory
 * the caller gives: the port passes pinned host memory, which its
 * host-to-device and device-to-host copies use directly, so the frame
 * loop copies no frame bytes on the host.  Frames are lent by reference:
 *
 *   reader: vfgsio_ring_reader_acquire returns the index of the next
 *           filled frame (-1 at the end of the stream);
 *           vfgsio_ring_reader_release(n) gives the n oldest acquired
 *           frames back to the reader thread;
 *   writer: vfgsio_ring_writer_acquire returns the index of a free frame;
 *           vfgsio_ring_writer_commit(slot, len) hands an acquired frame,
 *           len bytes of it, to the writer thread (len 0 gives it back
 *           unwritten).  Frames are written in the order they were
 *           acquired, whatever the order of their commits.
 *
 * Both acquires return -2 where waiting could never end: the reader's when
 * the caller holds every frame of the ring, the writer's when the ring is
 * full and its oldest frame is still the caller's.
 *
 * Plain C99 + pthreads; bound through ctypes (utils/native_io.py), with a
 * Python fallback in the frame loop when the library cannot be built.
 */

#define _GNU_SOURCE
#include <errno.h>
#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <unistd.h>
#include <fcntl.h>
#include <sys/types.h>

typedef struct {
    int      fd;
    size_t   frame_bytes;
    int      nbuf;
    uint8_t *base;       /* nbuf frames of frame_bytes, the caller's */
    size_t  *len;        /* writer: bytes to write of each committed frame */
    char    *ready;      /* writer: committed (or given back) */
    /* Stream positions; frame k of the stream sits at slot k % nbuf.
     * reader: [tail, mid) held by the caller, [mid, head) filled;
     * writer: [tail, head) acquired, each held by the caller until it is
     * committed (ready), then the thread's. */
    long long tail, mid, head;
    int      eof;        /* reader: end of stream; writer: a write failed */
    int      stop;
    pthread_t thread;
    pthread_mutex_t mu;
    pthread_cond_t  can_put, can_get;
} ring;

static uint8_t *frame_at(ring *r, long long k)
{
    return r->base + (size_t)(k % r->nbuf) * r->frame_bytes;
}

static void *reader_main(void *arg)
{
    ring *r = arg;
    for (;;) {
        pthread_mutex_lock(&r->mu);
        while (r->head - r->tail == r->nbuf && !r->stop)
            pthread_cond_wait(&r->can_put, &r->mu);
        if (r->stop) { pthread_mutex_unlock(&r->mu); return NULL; }
        uint8_t *dst = frame_at(r, r->head);
        pthread_mutex_unlock(&r->mu);

        size_t got = 0;
        while (got < r->frame_bytes) {
            ssize_t n = read(r->fd, dst + got, r->frame_bytes - got);
            if (n < 0 && errno == EINTR) continue;
            if (n <= 0) break;
            got += (size_t)n;
        }

        pthread_mutex_lock(&r->mu);
        if (got == r->frame_bytes)
            r->head++;
        else
            r->eof = 1;   /* a partial last frame is the end */
        pthread_cond_signal(&r->can_get);
        int done = r->eof;
        pthread_mutex_unlock(&r->mu);
        if (done) return NULL;
    }
}

static void *writer_main(void *arg)
{
    ring *r = arg;
    for (;;) {
        pthread_mutex_lock(&r->mu);
        while ((r->tail == r->head || !r->ready[r->tail % r->nbuf])
               && !r->stop)
            pthread_cond_wait(&r->can_get, &r->mu);
        if (r->tail == r->head || !r->ready[r->tail % r->nbuf]) {
            pthread_mutex_unlock(&r->mu);
            return NULL;
        }
        const uint8_t *src = frame_at(r, r->tail);
        size_t len = r->len[r->tail % r->nbuf];
        pthread_mutex_unlock(&r->mu);

        size_t put = 0;
        int failed = 0;
        while (put < len) {
            ssize_t n = write(r->fd, src + put, len - put);
            if (n < 0 && errno == EINTR) continue;
            if (n <= 0) { failed = 1; break; }
            put += (size_t)n;
        }

        pthread_mutex_lock(&r->mu);
        r->eof |= failed;
        r->ready[r->tail % r->nbuf] = 0;
        r->tail++;
        pthread_cond_signal(&r->can_put);
        pthread_mutex_unlock(&r->mu);
    }
}

static void *ring_open(int fd, size_t frame_bytes, int nbuf, uint8_t *base,
                       void *(*main)(void *))
{
    if (fd < 0) return NULL;
    ring *r = nbuf > 0 && base ? calloc(1, sizeof(*r)) : NULL;
    if (r) {
        r->len = calloc(nbuf, sizeof(size_t));
        r->ready = calloc(nbuf, 1);
    }
    if (!r || !r->len || !r->ready) {
        if (r) { free(r->len); free(r->ready); }
        free(r);
        close(fd);
        return NULL;
    }
    r->fd = fd;
    r->frame_bytes = frame_bytes;
    r->nbuf = nbuf;
    r->base = base;
    pthread_mutex_init(&r->mu, NULL);
    pthread_cond_init(&r->can_put, NULL);
    pthread_cond_init(&r->can_get, NULL);
    pthread_create(&r->thread, NULL, main, r);
    return r;
}

static void ring_free(ring *r)
{
    pthread_join(r->thread, NULL);
    close(r->fd);
    free(r->len);
    free(r->ready);
    free(r);
}

/* ---- reader API ---- */

void *vfgsio_ring_reader_open(const char *path, size_t frame_bytes, int nbuf,
                              long seek_frames, uint8_t *base)
{
    int fd = open(path, O_RDONLY);
    if (fd >= 0 && seek_frames > 0)
        lseek(fd, (off_t)frame_bytes * seek_frames, SEEK_SET);
    return ring_open(fd, frame_bytes, nbuf, base, reader_main);
}

/* The ring index of the next frame, held until released; -1 at the end of
 * the stream, -2 if the caller holds every frame. */
int vfgsio_ring_reader_acquire(void *h)
{
    ring *r = h;
    int slot = -2;
    pthread_mutex_lock(&r->mu);
    if (r->mid - r->tail < r->nbuf) {
        while (r->mid == r->head && !r->eof)
            pthread_cond_wait(&r->can_get, &r->mu);
        slot = r->mid == r->head ? -1 : (int)(r->mid++ % r->nbuf);
    }
    pthread_mutex_unlock(&r->mu);
    return slot;
}

/* Give the n oldest held frames back to the reader thread. */
void vfgsio_ring_reader_release(void *h, int n)
{
    ring *r = h;
    pthread_mutex_lock(&r->mu);
    if (n > r->mid - r->tail) n = (int)(r->mid - r->tail);
    if (n > 0) r->tail += n;
    pthread_cond_signal(&r->can_put);
    pthread_mutex_unlock(&r->mu);
}

void vfgsio_ring_reader_close(void *h)
{
    ring *r = h;
    pthread_mutex_lock(&r->mu);
    r->stop = 1;
    pthread_cond_broadcast(&r->can_put);
    pthread_mutex_unlock(&r->mu);
    ring_free(r);
}

/* ---- writer API ---- */

void *vfgsio_ring_writer_open(const char *path, size_t frame_bytes, int nbuf,
                              uint8_t *base)
{
    int fd = open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
    return ring_open(fd, frame_bytes, nbuf, base, writer_main);
}

/* The ring index of a free frame, held until committed; waits while the
 * writer thread has none.  -2 if the ring is full and its oldest frame is
 * held. */
int vfgsio_ring_writer_acquire(void *h)
{
    ring *r = h;
    int slot = -2;
    pthread_mutex_lock(&r->mu);
    while (r->head - r->tail == r->nbuf && r->ready[r->tail % r->nbuf])
        pthread_cond_wait(&r->can_put, &r->mu);
    if (r->head - r->tail < r->nbuf) {
        slot = (int)(r->head++ % r->nbuf);
        r->ready[slot] = 0;
    }
    pthread_mutex_unlock(&r->mu);
    return slot;
}

/* Hand the held frame at ring index slot, len bytes of it, to the writer
 * thread (len 0: give it back unwritten).  Returns 1, or 0 after a write
 * error. */
int vfgsio_ring_writer_commit(void *h, int slot, size_t len)
{
    ring *r = h;
    pthread_mutex_lock(&r->mu);
    r->len[slot] = len;
    r->ready[slot] = 1;
    pthread_cond_signal(&r->can_get);
    int ok = !r->eof;
    pthread_mutex_unlock(&r->mu);
    return ok;
}

/* Give back the frames still held, unwritten, write what was committed,
 * and close. */
void vfgsio_ring_writer_close(void *h)
{
    ring *r = h;
    pthread_mutex_lock(&r->mu);
    for (long long k = r->tail; k < r->head; k++)
        if (!r->ready[k % r->nbuf]) {
            r->len[k % r->nbuf] = 0;
            r->ready[k % r->nbuf] = 1;
        }
    r->stop = 1;
    pthread_cond_broadcast(&r->can_get);
    pthread_mutex_unlock(&r->mu);
    ring_free(r);
}
