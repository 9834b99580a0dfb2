// Persistent shared-memory KV store for embedding rows.
//
// Role parity with TWO reference components (SURVEY.md §2.1/§2.2):
//   - ShmHashTable (util/shm_hashtable.h): parameters in a SysV shared-memory
//     segment, multi-process visible, CAS float updates;
//   - PersistentBuffer (common/persistent_buffer.h): file-backed mmap buffer
//     (O_CREAT + ftruncate + mmap) — durable across restarts.
//
// Design: one file-backed mmap holding a header + open-addressing hash table
// of (uint64 key -> float[dim]) slots.  Linear probing, 64-bit FNV-1a hashing
// (the reference uses murmur, hash.h:16-58 — same role).  Multiple processes
// may map the same file; value updates use GCC atomic builtins on floats
// (the reference's float-CAS, lock.h:19-23).
//
// C ABI for ctypes.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t MAGIC = 0x4c43544b56303031ULL;  // "LCTKV001"
constexpr uint64_t EMPTY = ~0ULL;

struct Header {
    uint64_t magic;
    uint64_t capacity;
    uint64_t dim;
    uint64_t used;
};

struct Store {
    int fd;
    size_t bytes;
    Header* hdr;
    uint64_t* keys;   // [capacity]
    float* values;    // [capacity * dim]
};

inline uint64_t fnv1a(uint64_t key) {
    uint64_t h = 1469598103934665603ULL;
    for (int i = 0; i < 8; ++i) {
        h ^= (key >> (i * 8)) & 0xff;
        h *= 1099511628211ULL;
    }
    return h;
}

inline size_t table_bytes(uint64_t capacity, uint64_t dim) {
    return sizeof(Header) + capacity * sizeof(uint64_t) +
           capacity * dim * sizeof(float);
}

inline void layout(Store* s) {
    char* base = reinterpret_cast<char*>(s->hdr);
    s->keys = reinterpret_cast<uint64_t*>(base + sizeof(Header));
    s->values = reinterpret_cast<float*>(
        base + sizeof(Header) + s->hdr->capacity * sizeof(uint64_t));
}

// Find slot for key; returns slot index, -1 when table full (and key
// absent), or -3 for the reserved sentinel key. If insert, claims an empty
// slot atomically.
long find_slot(Store* s, uint64_t key, bool insert) {
    if (key == EMPTY) return -3;  // 2^64-1 is the empty-slot sentinel
    const uint64_t cap = s->hdr->capacity;
    uint64_t idx = fnv1a(key) % cap;
    for (uint64_t probe = 0; probe < cap; ++probe, idx = (idx + 1) % cap) {
        uint64_t cur = __atomic_load_n(&s->keys[idx], __ATOMIC_ACQUIRE);
        if (cur == key) return (long)idx;
        if (cur == EMPTY) {
            if (!insert) return -1;
            uint64_t expected = EMPTY;
            if (__atomic_compare_exchange_n(&s->keys[idx], &expected, key, false,
                                            __ATOMIC_ACQ_REL, __ATOMIC_ACQUIRE)) {
                __atomic_add_fetch(&s->hdr->used, 1, __ATOMIC_RELAXED);
                return (long)idx;
            }
            if (expected == key) return (long)idx;  // racer inserted same key
            // else another key claimed it; keep probing
        }
    }
    return -1;
}

}  // namespace

extern "C" {

// Create a store file. Builds the table in a private temp file and renames
// it over `path` atomically: a process that still has an old store at the
// same path mapped keeps its mapping of the old inode alive (no SIGBUS from
// truncating a file someone else is using).
void* shmkv_create(const char* path, uint64_t capacity, uint64_t dim) {
    static std::atomic<unsigned long> create_seq{0};
    char tmp[4096];
    // pid + per-process sequence: unique across processes AND across threads
    // of one process, so the unlink below can only ever clear a stale
    // leftover of a crashed earlier incarnation (never a live sibling's file)
    if (snprintf(tmp, sizeof(tmp), "%s.tmp.%ld.%lu", path, (long)getpid(),
                 create_seq.fetch_add(1, std::memory_order_relaxed))
        >= (int)sizeof(tmp)) return nullptr;
    unlink(tmp);
    int fd = open(tmp, O_RDWR | O_CREAT | O_EXCL, 0644);
    if (fd < 0) return nullptr;
    size_t bytes = table_bytes(capacity, dim);
    if (ftruncate(fd, (off_t)bytes) != 0) { close(fd); unlink(tmp); return nullptr; }
    void* mem = mmap(nullptr, bytes, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
    if (mem == MAP_FAILED) { close(fd); unlink(tmp); return nullptr; }
    Store* s = new Store{fd, bytes, reinterpret_cast<Header*>(mem), nullptr, nullptr};
    s->hdr->capacity = capacity;
    s->hdr->dim = dim;
    s->hdr->used = 0;
    layout(s);
    for (uint64_t i = 0; i < capacity; ++i) s->keys[i] = EMPTY;
    memset(s->values, 0, capacity * dim * sizeof(float));
    // publish the magic LAST (release order): a concurrent shmkv_open must
    // never validate a store whose key table is still uninitialized
    __atomic_store_n(&s->hdr->magic, MAGIC, __ATOMIC_RELEASE);
    if (rename(tmp, path) != 0) {
        munmap(mem, bytes); close(fd); unlink(tmp); delete s; return nullptr;
    }
    return s;
}

// Open an existing store. Returns handle or null.
void* shmkv_open(const char* path) {
    int fd = open(path, O_RDWR);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
    void* mem = mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE,
                     MAP_SHARED, fd, 0);
    if (mem == MAP_FAILED) { close(fd); return nullptr; }
    Store* s = new Store{fd, (size_t)st.st_size, reinterpret_cast<Header*>(mem),
                         nullptr, nullptr};
    if (s->hdr->magic != MAGIC ||
        table_bytes(s->hdr->capacity, s->hdr->dim) != (size_t)st.st_size) {
        munmap(mem, s->bytes);
        close(fd);
        delete s;
        return nullptr;
    }
    layout(s);
    return s;
}

uint64_t shmkv_capacity(void* h) { return static_cast<Store*>(h)->hdr->capacity; }
uint64_t shmkv_dim(void* h) { return static_cast<Store*>(h)->hdr->dim; }
uint64_t shmkv_used(void* h) { return static_cast<Store*>(h)->hdr->used; }

// Read value into out[dim]. Returns 0 ok, -1 missing.
int shmkv_get(void* h, uint64_t key, float* out) {
    Store* s = static_cast<Store*>(h);
    long idx = find_slot(s, key, false);
    if (idx < 0) return -1;
    memcpy(out, s->values + (uint64_t)idx * s->hdr->dim,
           s->hdr->dim * sizeof(float));
    return 0;
}

// Set value (insert if absent). Returns 0 ok, -2 table full.
int shmkv_set(void* h, uint64_t key, const float* val) {
    Store* s = static_cast<Store*>(h);
    long idx = find_slot(s, key, true);
    if (idx < 0) return -2;
    memcpy(s->values + (uint64_t)idx * s->hdr->dim, val,
           s->hdr->dim * sizeof(float));
    return 0;
}

// Atomic add into value (insert zero row if absent) — the float-CAS update
// of shm_hashtable.h:91-128. Returns 0 ok, -2 full.
int shmkv_add(void* h, uint64_t key, const float* delta) {
    Store* s = static_cast<Store*>(h);
    long idx = find_slot(s, key, true);
    if (idx < 0) return -2;
    float* row = s->values + (uint64_t)idx * s->hdr->dim;
    for (uint64_t d = 0; d < s->hdr->dim; ++d) {
        // float-CAS on the 32-bit pattern (lock.h:19-23 equivalent)
        uint32_t* slot = reinterpret_cast<uint32_t*>(&row[d]);
        uint32_t expected = __atomic_load_n(slot, __ATOMIC_RELAXED);
        while (true) {
            float curf;
            memcpy(&curf, &expected, 4);
            const float want = curf + delta[d];
            uint32_t desired;
            memcpy(&desired, &want, 4);
            if (__atomic_compare_exchange_n(slot, &expected, desired, false,
                                            __ATOMIC_ACQ_REL, __ATOMIC_RELAXED))
                break;
        }
    }
    return 0;
}

// Bulk read of n keys into out[n, dim]; missing rows zero-filled, found[i]
// set 0/1.
int shmkv_get_batch(void* h, const uint64_t* ks, long n, float* out,
                    uint8_t* found) {
    Store* s = static_cast<Store*>(h);
    const uint64_t dim = s->hdr->dim;
    for (long i = 0; i < n; ++i) {
        long idx = find_slot(s, ks[i], false);
        if (idx < 0) {
            memset(out + (uint64_t)i * dim, 0, dim * sizeof(float));
            found[i] = 0;
        } else {
            memcpy(out + (uint64_t)i * dim, s->values + (uint64_t)idx * dim,
                   dim * sizeof(float));
            found[i] = 1;
        }
    }
    return 0;
}

// Bulk set of n rows (insert if absent) — vectorized preload/shadow path.
// Returns 0 ok, -2 if any key found the table full.
int shmkv_set_batch(void* h, const uint64_t* ks, long n, const float* vals) {
    Store* s = static_cast<Store*>(h);
    const uint64_t dim = s->hdr->dim;
    int rc = 0;
    for (long i = 0; i < n; ++i) {
        long idx = find_slot(s, ks[i], true);
        if (idx < 0) { rc = -2; continue; }
        memcpy(s->values + (uint64_t)idx * dim, vals + (uint64_t)i * dim,
               dim * sizeof(float));
    }
    return rc;
}

// Bulk atomic add of n delta rows (insert zero row if absent): one library
// call carries a whole push batch through the float-CAS discipline — the
// vectorization of the per-key shmkv_add walk that made the shm transport
// 5x slower end-to-end than TCP.  Returns 0 ok, -2 if any key hit a full
// table.
int shmkv_add_batch(void* h, const uint64_t* ks, long n, const float* deltas) {
    Store* s = static_cast<Store*>(h);
    const uint64_t dim = s->hdr->dim;
    int rc = 0;
    for (long i = 0; i < n; ++i) {
        long idx = find_slot(s, ks[i], true);
        if (idx < 0) { rc = -2; continue; }
        float* row = s->values + (uint64_t)idx * dim;
        const float* delta = deltas + (uint64_t)i * dim;
        for (uint64_t d = 0; d < dim; ++d) {
            uint32_t* slot = reinterpret_cast<uint32_t*>(&row[d]);
            uint32_t expected = __atomic_load_n(slot, __ATOMIC_RELAXED);
            while (true) {
                float curf;
                memcpy(&curf, &expected, 4);
                const float want = curf + delta[d];
                uint32_t desired;
                memcpy(&desired, &want, 4);
                if (__atomic_compare_exchange_n(slot, &expected, desired,
                                                false, __ATOMIC_ACQ_REL,
                                                __ATOMIC_RELAXED))
                    break;
            }
        }
    }
    return rc;
}

// Fused sparse-Adagrad push over two stores (data + accum), one call per
// batch: accum[k] += g^2 (CAS), then data[k] -= lr * g / sqrt(accum + eps)
// (CAS) — the gradientUpdater.h:138-150 update with shm_hashtable.h's
// atomicity, minus four Python->C crossings per KEY.  The accumulator read
// may observe a concurrent racer's increment (slightly smaller step), the
// same arrival-order tolerance the scalar path documents.
int shmkv_adagrad_batch(void* data_h, void* accum_h, const uint64_t* ks,
                        long n, const float* grads, float lr, float eps) {
    Store* sd = static_cast<Store*>(data_h);
    Store* sa = static_cast<Store*>(accum_h);
    const uint64_t dim = sd->hdr->dim;
    if (sa->hdr->dim != dim) return -4;
    int rc = 0;
    for (long i = 0; i < n; ++i) {
        long aidx = find_slot(sa, ks[i], true);
        long didx = find_slot(sd, ks[i], true);
        if (aidx < 0 || didx < 0) { rc = -2; continue; }
        float* arow = sa->values + (uint64_t)aidx * dim;
        float* drow = sd->values + (uint64_t)didx * dim;
        const float* g = grads + (uint64_t)i * dim;
        for (uint64_t d = 0; d < dim; ++d) {
            const float g2 = g[d] * g[d];
            uint32_t* aslot = reinterpret_cast<uint32_t*>(&arow[d]);
            uint32_t expected = __atomic_load_n(aslot, __ATOMIC_RELAXED);
            float acc;
            while (true) {
                float curf;
                memcpy(&curf, &expected, 4);
                acc = curf + g2;
                uint32_t desired;
                memcpy(&desired, &acc, 4);
                if (__atomic_compare_exchange_n(aslot, &expected, desired,
                                                false, __ATOMIC_ACQ_REL,
                                                __ATOMIC_RELAXED))
                    break;
            }
            const float step = -lr * g[d] / __builtin_sqrtf(acc + eps);
            uint32_t* dslot = reinterpret_cast<uint32_t*>(&drow[d]);
            expected = __atomic_load_n(dslot, __ATOMIC_RELAXED);
            while (true) {
                float curf;
                memcpy(&curf, &expected, 4);
                const float want = curf + step;
                uint32_t desired;
                memcpy(&desired, &want, 4);
                if (__atomic_compare_exchange_n(dslot, &expected, desired,
                                                false, __ATOMIC_ACQ_REL,
                                                __ATOMIC_RELAXED))
                    break;
            }
        }
    }
    return rc;
}

// Flush to disk (PersistentBuffer durability).
int shmkv_sync(void* h) {
    Store* s = static_cast<Store*>(h);
    return msync(s->hdr, s->bytes, MS_SYNC);
}

void shmkv_close(void* h) {
    Store* s = static_cast<Store*>(h);
    munmap(s->hdr, s->bytes);
    close(s->fd);
    delete s;
}

}  // extern "C"
