// pagestore — mmap'd 4 KB page file + bucket KV store (C ABI for ctypes).
//
// Native counterpart of the reference's hashdb64 page layer
// (src/hashdb64/page/page_manager.hpp:20-73: 4 KB pages mmapped from page
// files, header page, free-page bookkeeping; key-value pages with overflow
// chaining play the KeyValuePage role). The SMT node store of the TPU
// framework's 64-bit backend sits on this store: key = 32-byte hash,
// value = up to 120 bytes (12 field elements + tag).
//
// Layout:
//   page 0           header: magic, version, page count, free-list head,
//                    record count, bucket count B
//   pages 1..B       bucket pages (B fixed at creation, power of two)
//   pages B+1..      overflow / data pages from the free list
//
// Bucket page: [u32 nRecords][records...][u64 nextOverflowPage at end].
// Record: [u8 keyLen=32][u8 valLen][key 32B][val valLen B], packed.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t PAGE_SIZE = 4096;
constexpr uint64_t MAGIC = 0x5A4B50414745ULL;  // "ZKPAGE"
constexpr uint32_t VERSION = 1;
constexpr uint32_t KEY_LEN = 32;
constexpr uint32_t MAX_VAL = 160;

struct Header {
    uint64_t magic;
    uint32_t version;
    uint32_t bucketCount;
    uint64_t pageCount;
    uint64_t freeListHead;   // 0 = empty
    uint64_t recordCount;
};

struct Store {
    int fd = -1;
    uint8_t *map = nullptr;
    uint64_t mappedPages = 0;
};

Header *header(Store *s) { return reinterpret_cast<Header *>(s->map); }
uint8_t *page(Store *s, uint64_t idx) { return s->map + idx * PAGE_SIZE; }

// page payload accessors
uint32_t *pRecCount(uint8_t *p) { return reinterpret_cast<uint32_t *>(p); }
uint64_t *pNext(uint8_t *p) {
    return reinterpret_cast<uint64_t *>(p + PAGE_SIZE - sizeof(uint64_t));
}
uint8_t *pData(uint8_t *p) { return p + sizeof(uint32_t); }
constexpr uint64_t DATA_BYTES = PAGE_SIZE - sizeof(uint32_t) - sizeof(uint64_t);

bool remapToSize(Store *s, uint64_t pages) {
    if (s->map && pages <= s->mappedPages) return true;
    if (s->map) munmap(s->map, s->mappedPages * PAGE_SIZE);
    if (ftruncate(s->fd, pages * PAGE_SIZE) != 0) return false;
    void *m = mmap(nullptr, pages * PAGE_SIZE, PROT_READ | PROT_WRITE,
                   MAP_SHARED, s->fd, 0);
    if (m == MAP_FAILED) { s->map = nullptr; return false; }
    s->map = static_cast<uint8_t *>(m);
    s->mappedPages = pages;
    return true;
}

uint64_t allocPage(Store *s) {
    Header *h = header(s);
    if (h->freeListHead != 0) {
        uint64_t idx = h->freeListHead;
        h->freeListHead = *pNext(page(s, idx));
        memset(page(s, idx), 0, PAGE_SIZE);
        return idx;
    }
    uint64_t idx = h->pageCount;
    uint64_t newCount = idx + 1;
    // grow with 25% slack to amortize remaps
    if (newCount > s->mappedPages) {
        if (!remapToSize(s, newCount + newCount / 4 + 16)) return 0;
    }
    header(s)->pageCount = newCount;
    memset(page(s, idx), 0, PAGE_SIZE);
    return idx;
}

// FNV-1a over the key -> bucket index
uint64_t bucketOf(Store *s, const uint8_t *key) {
    uint64_t hsh = 1469598103934665603ULL;
    for (uint32_t i = 0; i < KEY_LEN; i++) {
        hsh ^= key[i];
        hsh *= 1099511628211ULL;
    }
    return 1 + (hsh & (header(s)->bucketCount - 1));
}

// find record in page; returns offset of record or -1
int64_t findInPage(uint8_t *p, const uint8_t *key, uint32_t *valLen) {
    uint32_t n = *pRecCount(p);
    uint8_t *d = pData(p);
    uint64_t off = 0;
    for (uint32_t i = 0; i < n; i++) {
        if (off + 2 > DATA_BYTES) break;  // corrupt page: record count past data
        uint8_t kl = d[off];
        uint8_t vl = d[off + 1];
        if (off + 2 + kl + vl > DATA_BYTES) break;  // corrupt record length
        if (kl == KEY_LEN && memcmp(d + off + 2, key, KEY_LEN) == 0) {
            if (valLen) *valLen = vl;
            return static_cast<int64_t>(off);
        }
        off += 2 + kl + vl;
    }
    if (valLen) *valLen = static_cast<uint32_t>(off);  // bytes used
    return -1;
}

}  // namespace

extern "C" {

void *pagestore_open(const char *path, uint32_t bucketCountLog2) {
    Store *s = new Store();
    s->fd = open(path, O_RDWR | O_CREAT, 0644);
    if (s->fd < 0) { delete s; return nullptr; }
    struct stat st;
    fstat(s->fd, &st);
    if (st.st_size == 0) {
        uint32_t buckets = 1u << bucketCountLog2;
        if (!remapToSize(s, 1 + buckets + 16)) { close(s->fd); delete s; return nullptr; }
        Header *h = header(s);
        h->magic = MAGIC;
        h->version = VERSION;
        h->bucketCount = buckets;
        h->pageCount = 1 + buckets;
        h->freeListHead = 0;
        h->recordCount = 0;
    } else {
        uint64_t pages = (st.st_size + PAGE_SIZE - 1) / PAGE_SIZE;
        if (!remapToSize(s, pages)) { close(s->fd); delete s; return nullptr; }
        if (header(s)->magic != MAGIC || header(s)->version != VERSION) {
            munmap(s->map, s->mappedPages * PAGE_SIZE);
            close(s->fd);
            delete s;
            return nullptr;
        }
    }
    return s;
}

void pagestore_close(void *ptr) {
    Store *s = static_cast<Store *>(ptr);
    if (s->map) {
        msync(s->map, s->mappedPages * PAGE_SIZE, MS_SYNC);
        munmap(s->map, s->mappedPages * PAGE_SIZE);
    }
    if (s->fd >= 0) close(s->fd);
    delete s;
}

void pagestore_flush(void *ptr) {
    Store *s = static_cast<Store *>(ptr);
    if (s->map) msync(s->map, s->mappedPages * PAGE_SIZE, MS_ASYNC);
}

uint64_t pagestore_record_count(void *ptr) {
    return header(static_cast<Store *>(ptr))->recordCount;
}

uint64_t pagestore_page_count(void *ptr) {
    return header(static_cast<Store *>(ptr))->pageCount;
}

// set: insert or update. returns 0 ok, -1 error.
int pagestore_set(void *ptr, const uint8_t *key, const uint8_t *val,
                  uint32_t valLen) {
    Store *s = static_cast<Store *>(ptr);
    if (valLen > MAX_VAL) return -1;
    uint64_t pidx = bucketOf(s, key);
    for (;;) {
        uint8_t *p = page(s, pidx);
        uint32_t info = 0;
        int64_t off = findInPage(p, key, &info);
        if (off >= 0) {
            uint8_t *d = pData(p);
            uint8_t oldVl = d[off + 1];
            if (oldVl == valLen) {
                memcpy(d + off + 2 + KEY_LEN, val, valLen);
                return 0;
            }
            // size changed: remove (compact) then fall through to insert
            uint32_t n = *pRecCount(p);
            uint64_t recLen = 2 + KEY_LEN + oldVl;
            uint64_t used = 0;
            {  // compute used bytes
                uint8_t *dd = pData(p);
                uint64_t o = 0;
                for (uint32_t i = 0; i < n; i++) o += 2 + dd[o] + dd[o + 1];
                used = o;
            }
            memmove(d + off, d + off + recLen, used - off - recLen);
            *pRecCount(p) = n - 1;
            header(s)->recordCount--;
            pidx = bucketOf(s, key);
            continue;
        }
        uint64_t used = info;
        uint64_t need = 2 + KEY_LEN + valLen;
        if (used + need <= DATA_BYTES) {
            uint8_t *d = pData(p);
            d[used] = KEY_LEN;
            d[used + 1] = static_cast<uint8_t>(valLen);
            memcpy(d + used + 2, key, KEY_LEN);
            memcpy(d + used + 2 + KEY_LEN, val, valLen);
            (*pRecCount(p))++;
            header(s)->recordCount++;
            return 0;
        }
        uint64_t next = *pNext(p);
        if (next == 0) {
            next = allocPage(s);
            if (next == 0) return -1;
            // page(s, pidx) may have moved after remap
            *pNext(page(s, pidx)) = next;
        }
        pidx = next;
    }
}

// get: returns value length >= 0, or -1 if absent.
int pagestore_get(void *ptr, const uint8_t *key, uint8_t *out) {
    Store *s = static_cast<Store *>(ptr);
    uint64_t pidx = bucketOf(s, key);
    for (;;) {
        uint8_t *p = page(s, pidx);
        uint32_t vl = 0;
        int64_t off = findInPage(p, key, &vl);
        if (off >= 0) {
            uint8_t *d = pData(p);
            uint8_t len = d[off + 1];
            if (len > MAX_VAL) return -1;  // corrupt store: caller buffer is MAX_VAL
            if (out) memcpy(out, d + off + 2 + KEY_LEN, len);
            return len;
        }
        uint64_t next = *pNext(p);
        if (next == 0) return -1;
        pidx = next;
    }
}

}  // extern "C"
