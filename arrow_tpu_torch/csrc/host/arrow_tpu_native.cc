// arrow_tpu_torch native host runtime: a host-side memory pool, the ATB
// columnar file format (spill runs and the dataset's engine-internal
// files), and a threaded morsel prefetch loader. Loaded with ctypes by
// arrow_tpu_torch/native.py, which builds it with g++ at first use.
//
// Role in the stack: the reference's performance-critical *runtime* is
// C++ -- MemoryPool (cpp/src/arrow/memory_pool.cc), the IO thread pool +
// readahead generators (util/thread_pool.h, dataset/scan_node.cc:86-123),
// and the IPC file reader (ipc/reader.h). The port keeps compute in torch
// and its CUDA kernels; host-side staging (morsels copied into pinned
// buffers and on to the card) is CPU work and gets the same treatment
// here: 64-byte-aligned allocations with stats/poisoning, a dead-simple
// columnar file format (ATB) readable with one mmap, and a background
// thread pool that reads + slices morsels ahead of the device. The file
// format is the JAX package's (native/arrow_tpu_native.cc) byte for byte:
// a file either package writes, the other reads.
//
// Exposed as a C ABI for ctypes (no pybind11 in the image).
//
// ATB v1 layout (little-endian):
//   [0]  magic "ATB1"            (4 bytes)
//   [4]  u32 ncols
//   [8]  u64 nrows
//   [16] per column: u32 name_len, name bytes, u8 dtype_code,
//        u8 has_validity, u8 is_varlen, u8 pad, u64 data_bytes
//        -> then: (varlen) u64 offsets_bytes
//   data section (64-byte aligned per buffer, in column order):
//        [validity bytes (nrows)]? [offsets ((nrows+1)*4)]? [data]

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#if defined(_WIN32)
#error "posix only"
#endif
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// memory pool (memory_pool.cc analog: 64-byte aligned, stats, poisoning)
// ---------------------------------------------------------------------------

struct AtpPool {
  std::atomic<int64_t> bytes_allocated{0};
  std::atomic<int64_t> max_memory{0};
  std::atomic<int64_t> num_allocations{0};
  int poison;  // ARROW_DEBUG_MEMORY_POOL analog: fill 0xDE on alloc/free
};

void* atp_pool_create(int poison) {
  auto* p = new AtpPool();
  p->poison = poison;
  return p;
}

void atp_pool_destroy(void* pool) { delete static_cast<AtpPool*>(pool); }

void* atp_pool_alloc(void* pool, int64_t size) {
  auto* p = static_cast<AtpPool*>(pool);
  void* ptr = nullptr;
  if (posix_memalign(&ptr, 64, size < 64 ? 64 : (size_t)size) != 0)
    return nullptr;
  if (p->poison) memset(ptr, 0xDE, (size_t)size);
  int64_t cur = p->bytes_allocated.fetch_add(size) + size;
  int64_t mx = p->max_memory.load();
  while (cur > mx && !p->max_memory.compare_exchange_weak(mx, cur)) {
  }
  p->num_allocations.fetch_add(1);
  return ptr;
}

void atp_pool_free(void* pool, void* ptr, int64_t size) {
  auto* p = static_cast<AtpPool*>(pool);
  if (p->poison && ptr) memset(ptr, 0xDF, (size_t)size);
  free(ptr);
  p->bytes_allocated.fetch_sub(size);
}

int64_t atp_pool_bytes_allocated(void* pool) {
  return static_cast<AtpPool*>(pool)->bytes_allocated.load();
}
int64_t atp_pool_max_memory(void* pool) {
  return static_cast<AtpPool*>(pool)->max_memory.load();
}
int64_t atp_pool_num_allocations(void* pool) {
  return static_cast<AtpPool*>(pool)->num_allocations.load();
}

// ---------------------------------------------------------------------------
// ATB columnar file format
// ---------------------------------------------------------------------------

struct AtbColDesc {        // mirrors the python ctypes struct
  const char* name;        // in: column name (write) / out: into header buf
  uint8_t dtype_code;      // numpy-ish code agreed with the python side
  uint8_t has_validity;
  uint8_t is_varlen;
  const uint8_t* validity; // nrows bytes (0/1) or null
  const uint8_t* offsets;  // (nrows+1)*int32 or null
  const uint8_t* data;     // fixed: nrows*itemsize; varlen: byte pool
  int64_t data_bytes;
};

static size_t align64(size_t x) { return (x + 63) & ~size_t(63); }

int atb_write(const char* path, int64_t nrows, int ncols,
              const AtbColDesc* cols) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  fwrite("ATB1", 1, 4, f);
  uint32_t nc = (uint32_t)ncols;
  fwrite(&nc, 4, 1, f);
  uint64_t nr = (uint64_t)nrows;
  fwrite(&nr, 8, 1, f);
  for (int c = 0; c < ncols; ++c) {
    const AtbColDesc& col = cols[c];
    uint32_t nl = (uint32_t)strlen(col.name);
    fwrite(&nl, 4, 1, f);
    fwrite(col.name, 1, nl, f);
    fwrite(&col.dtype_code, 1, 1, f);
    fwrite(&col.has_validity, 1, 1, f);
    fwrite(&col.is_varlen, 1, 1, f);
    uint8_t pad = 0;
    fwrite(&pad, 1, 1, f);
    uint64_t db = (uint64_t)col.data_bytes;
    fwrite(&db, 8, 1, f);
  }
  // data section: pad each buffer start to 64
  auto pad_to = [&](size_t a) {
    long pos = ftell(f);
    static const char zeros[64] = {0};
    size_t want = align64((size_t)pos);
    if (want > (size_t)pos) fwrite(zeros, 1, want - (size_t)pos, f);
  };
  for (int c = 0; c < ncols; ++c) {
    const AtbColDesc& col = cols[c];
    if (col.has_validity) {
      pad_to(64);
      fwrite(col.validity, 1, (size_t)nrows, f);
    }
    if (col.is_varlen) {
      pad_to(64);
      fwrite(col.offsets, 1, (size_t)(nrows + 1) * 4, f);
    }
    pad_to(64);
    fwrite(col.data, 1, (size_t)col.data_bytes, f);
  }
  // a short write (a full disk) must not leave a run that reads back
  // truncated: report it
  int bad = ferror(f);
  if (fclose(f) != 0 || bad) return -2;
  return 0;
}

void atb_close(void* h);   // defined below; used by atb_open's bail-out

struct AtbFile {
  int fd = -1;
  uint8_t* map = nullptr;
  size_t map_len = 0;
  uint64_t nrows = 0;
  struct Col {
    std::string name;
    uint8_t dtype_code, has_validity, is_varlen;
    size_t validity_off, offsets_off, data_off, data_bytes;
  };
  std::vector<Col> cols;
};

void* atb_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  auto* af = new AtbFile();
  af->fd = fd;
  af->map_len = (size_t)st.st_size;
  af->map = (uint8_t*)mmap(nullptr, af->map_len, PROT_READ, MAP_PRIVATE,
                           fd, 0);
  if (af->map == MAP_FAILED) {
    af->map = nullptr;
    delete af;
    close(fd);
    return nullptr;
  }
  // Every header field is UNTRUSTED external bytes (the same threat
  // model the reference fuzzes via ipc/stream_fuzz.cc): bounds-check
  // each read against the mapped length and reject any layout whose
  // buffers would fall outside the file — a corrupted header used to
  // drive mmap reads past EOF (SIGBUS, found by
  // tests/test_fuzz_readers.py).
  auto fail = [&]() {
    atb_close(af);
    return (void*)nullptr;
  };
  const size_t len = af->map_len;
  if (len < 16 || memcmp(af->map, "ATB1", 4) != 0) return fail();
  size_t off = 4;
  auto can_read = [&](size_t n) { return n <= len && off <= len - n; };
  uint32_t ncols;
  memcpy(&ncols, af->map + off, 4);
  off += 4;
  memcpy(&af->nrows, af->map + off, 8);
  off += 8;
  // a column header is >= 20 bytes; nrows buffers must fit the file
  if (ncols > len / 20 || af->nrows > (uint64_t)len) return fail();
  af->cols.resize(ncols);
  for (uint32_t c = 0; c < ncols; ++c) {
    auto& col = af->cols[c];
    if (!can_read(4)) return fail();
    uint32_t nl;
    memcpy(&nl, af->map + off, 4);
    off += 4;
    if (!can_read(nl) || nl > 4096) return fail();
    col.name.assign((const char*)(af->map + off), nl);
    off += nl;
    if (!can_read(12)) return fail();
    col.dtype_code = af->map[off++];
    col.has_validity = af->map[off++];
    col.is_varlen = af->map[off++];
    ++off;  // pad
    uint64_t db;
    memcpy(&db, af->map + off, 8);
    off += 8;
    if (db > (uint64_t)len) return fail();
    col.data_bytes = (size_t)db;
  }
  size_t pos = off;
  auto advance = [&](size_t n) {
    pos = align64(pos);
    if (n > len || pos > len - n) return false;
    return true;
  };
  for (auto& col : af->cols) {
    if (col.has_validity) {
      if (!advance((size_t)af->nrows)) return fail();
      col.validity_off = pos;
      pos += (size_t)af->nrows;
    }
    if (col.is_varlen) {
      if (!advance(((size_t)af->nrows + 1) * 4)) return fail();
      col.offsets_off = pos;
      pos += ((size_t)af->nrows + 1) * 4;
    }
    if (!advance(col.data_bytes)) return fail();
    col.data_off = pos;
    pos += col.data_bytes;
  }
  return af;
}

void atb_close(void* h) {
  auto* af = static_cast<AtbFile*>(h);
  if (af->map) munmap(af->map, af->map_len);
  if (af->fd >= 0) close(af->fd);
  delete af;
}

int64_t atb_nrows(void* h) { return (int64_t)((AtbFile*)h)->nrows; }
int atb_ncols(void* h) { return (int)((AtbFile*)h)->cols.size(); }
const char* atb_col_name(void* h, int c) {
  return ((AtbFile*)h)->cols[c].name.c_str();
}
int atb_col_dtype(void* h, int c) {
  return ((AtbFile*)h)->cols[c].dtype_code;
}
int atb_col_flags(void* h, int c) {
  auto& col = ((AtbFile*)h)->cols[c];
  return col.has_validity | (col.is_varlen << 1);
}
// zero-copy pointers into the mmap
const uint8_t* atb_col_data(void* h, int c, int64_t* nbytes) {
  auto& col = ((AtbFile*)h)->cols[c];
  *nbytes = (int64_t)col.data_bytes;
  return ((AtbFile*)h)->map + col.data_off;
}
const uint8_t* atb_col_validity(void* h, int c) {
  auto& col = ((AtbFile*)h)->cols[c];
  return col.has_validity ? ((AtbFile*)h)->map + col.validity_off : nullptr;
}
const uint8_t* atb_col_offsets(void* h, int c) {
  auto& col = ((AtbFile*)h)->cols[c];
  return col.is_varlen ? ((AtbFile*)h)->map + col.offsets_off : nullptr;
}

// ---------------------------------------------------------------------------
// threaded morsel prefetch loader
// ---------------------------------------------------------------------------
// Background threads open ATB files and enqueue (file, row-range) morsels;
// the consumer (python) drains a bounded queue — the fragment/batch
// readahead design of dataset/scan_node.cc:86-123 with the thread pool of
// util/thread_pool.h, minus the futures (a bounded MPMC queue suffices
// because morsels are symmetric tasks).

struct Morsel {
  void* file;       // AtbFile*, shared
  int64_t row_begin;
  int64_t row_count;
  int file_index;
};

struct AtpLoader {
  std::vector<std::string> paths;
  std::vector<void*> files;
  std::deque<Morsel> queue;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  size_t queue_cap;
  bool done = false;
  bool abort = false;
  std::vector<std::thread> workers;
  std::atomic<size_t> next_file{0};
  std::atomic<int> failed{0};
  int64_t morsel_rows;

  void worker() {
    for (;;) {
      size_t fi = next_file.fetch_add(1);
      if (fi >= paths.size()) break;
      void* f = atb_open(paths[fi].c_str());
      if (!f) {  // unreadable file: counted, the consumer raises at the end
        failed.fetch_add(1);
        continue;
      }
      {
        std::lock_guard<std::mutex> g(mu);
        files[fi] = f;
      }
      int64_t n = atb_nrows(f);
      for (int64_t r = 0; r < n; r += morsel_rows) {
        Morsel m{f, r, std::min(morsel_rows, n - r), (int)fi};
        std::unique_lock<std::mutex> lk(mu);
        cv_push.wait(lk,
                     [&] { return queue.size() < queue_cap || abort; });
        if (abort) return;
        queue.push_back(m);
        cv_pop.notify_one();
      }
    }
    std::lock_guard<std::mutex> g(mu);
    if (--active_workers == 0) {
      done = true;
      cv_pop.notify_all();
    }
  }
  int active_workers = 0;
};

void* atp_loader_create(const char** paths, int nfiles, int64_t morsel_rows,
                        int nthreads, int queue_depth) {
  auto* L = new AtpLoader();
  for (int i = 0; i < nfiles; ++i) L->paths.emplace_back(paths[i]);
  L->files.assign(nfiles, nullptr);
  L->queue_cap = queue_depth > 0 ? queue_depth : 4;
  L->morsel_rows = morsel_rows > 0 ? morsel_rows : 1 << 15;
  int nt = nthreads > 0 ? nthreads : 2;
  L->active_workers = nt;
  for (int t = 0; t < nt; ++t)
    L->workers.emplace_back([L] { L->worker(); });
  return L;
}

// returns 1 and fills out params while morsels remain; 0 at end of stream
int atp_loader_next(void* loader, void** file, int64_t* row_begin,
                    int64_t* row_count, int* file_index) {
  auto* L = static_cast<AtpLoader*>(loader);
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_pop.wait(lk, [&] { return !L->queue.empty() || L->done; });
  if (L->queue.empty()) return 0;
  Morsel m = L->queue.front();
  L->queue.pop_front();
  L->cv_push.notify_one();
  *file = m.file;
  *row_begin = m.row_begin;
  *row_count = m.row_count;
  *file_index = m.file_index;
  return 1;
}

// files the loader's threads could not open (valid once next returned 0)
int atp_loader_failed(void* loader) {
  return static_cast<AtpLoader*>(loader)->failed.load();
}

void atp_loader_destroy(void* loader) {
  auto* L = static_cast<AtpLoader*>(loader);
  {
    std::lock_guard<std::mutex> g(L->mu);
    L->abort = true;
    L->cv_push.notify_all();
  }
  for (auto& t : L->workers) t.join();
  for (void* f : L->files)
    if (f) atb_close(f);
  delete L;
}

}  // extern "C"
