// Native shared-memory communication windows for multi-process cylinders.
//
// The reference's cylinders exchange bounds/weights through MPI one-sided
// RMA windows with a write-id freshness protocol (ref. mpisppy/cylinders/
// spcommunicator.py:97-124: each buffer is length+1 doubles, the last slot
// a monotonically increasing write-id; -1 is the kill signal, hub.py:356).
// This is the same protocol over POSIX shared memory with a SEQLOCK in
// place of MPI passive-target locks: the single writer bumps an atomic
// sequence to odd, writes the payload and the write-id, and bumps back to
// even; readers retry while the sequence is odd or changed mid-copy.
// One writer, many readers, no locks held across processes, no reader can
// block the writer — the same progress guarantees the reference leans on
// MPI RMA for (README.rst:41-56 async-progress warnings).
//
// Python binding: ctypes (see __init__.py); exposed to the framework as
// Window.shared(...) in cylinders/spcommunicator.py.

#include <atomic>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <unistd.h>

namespace {

struct Header {
    std::atomic<int64_t> seq;        // seqlock: odd while a write is in flight
    std::atomic<int64_t> write_id;   // monotone counter; -1 == kill
    int64_t length;                  // payload doubles
};

struct Handle {
    Header *h;
    double *data;
    size_t bytes;
    char name[256];
};

Handle *map_window(const char *name, int64_t length, bool create) {
    size_t bytes = sizeof(Header) + static_cast<size_t>(length) * sizeof(double);
    int flags = create ? (O_CREAT | O_RDWR) : O_RDWR;
    int fd = shm_open(name, flags, 0600);
    if (fd < 0) return nullptr;
    if (create && ftruncate(fd, static_cast<off_t>(bytes)) != 0) {
        close(fd);
        shm_unlink(name);
        return nullptr;
    }
    void *mem = mmap(nullptr, bytes, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
    close(fd);
    if (mem == MAP_FAILED) return nullptr;
    Handle *hd = new Handle;
    hd->h = static_cast<Header *>(mem);
    hd->data = reinterpret_cast<double *>(static_cast<char *>(mem) + sizeof(Header));
    hd->bytes = bytes;
    strncpy(hd->name, name, sizeof(hd->name) - 1);
    hd->name[sizeof(hd->name) - 1] = '\0';
    if (create) {
        hd->h->seq.store(0, std::memory_order_relaxed);
        hd->h->write_id.store(0, std::memory_order_relaxed);
        hd->h->length = length;
        memset(hd->data, 0, static_cast<size_t>(length) * sizeof(double));
    }
    return hd;
}

}  // namespace

extern "C" {

void *spw_create(const char *name, int64_t length) {
    return map_window(name, length, true);
}

void *spw_open(const char *name, int64_t length) {
    return map_window(name, length, false);
}

// owner side (ref. hub.py:310-331 hub_to_spoke / spoke.py:59-80)
void spw_put(void *p, const double *vals, int64_t n) {
    Handle *hd = static_cast<Handle *>(p);
    hd->h->seq.fetch_add(1, std::memory_order_acq_rel);       // -> odd
    memcpy(hd->data, vals, static_cast<size_t>(n) * sizeof(double));
    int64_t id = hd->h->write_id.load(std::memory_order_relaxed);
    if (id >= 0)
        hd->h->write_id.store(id + 1, std::memory_order_relaxed);
    hd->h->seq.fetch_add(1, std::memory_order_release);       // -> even
}

void spw_kill(void *p) {
    static_cast<Handle *>(p)->h->write_id.store(-1, std::memory_order_release);
}

// reader side (ref. hub.py:333-354 hub_from_spoke / spoke.py:82-99).
// The retry loop is BOUNDED: if the writer died mid-put (seq left odd)
// the reader must not spin forever — after ~1e8 retries it returns
// INT64_MIN, which every caller treats as "not fresh" and skips.
int64_t spw_read(void *p, double *out, int64_t n) {
    Handle *hd = static_cast<Handle *>(p);
    for (int64_t tries = 0; tries < 100000000LL; ++tries) {
        int64_t s0 = hd->h->seq.load(std::memory_order_acquire);
        if (s0 & 1) continue;                                 // write in flight
        memcpy(out, hd->data, static_cast<size_t>(n) * sizeof(double));
        int64_t id = hd->h->write_id.load(std::memory_order_acquire);
        int64_t s1 = hd->h->seq.load(std::memory_order_acquire);
        if (s0 == s1) return id;                              // consistent copy
    }
    return INT64_MIN;                                         // dead writer
}

int64_t spw_read_id(void *p) {
    return static_cast<Handle *>(p)->h->write_id.load(std::memory_order_acquire);
}

void spw_close(void *p, int unlink_it) {
    Handle *hd = static_cast<Handle *>(p);
    munmap(static_cast<void *>(hd->h), hd->bytes);
    if (unlink_it) shm_unlink(hd->name);
    delete hd;
}

}  // extern "C"
