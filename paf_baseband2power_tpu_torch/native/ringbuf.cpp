/* Implementation of the pafb2p shared-memory ring buffer (see ringbuf.h). */

#include "ringbuf.h"

#include <atomic>
#include <cerrno>
#include <initializer_list>
#include <new>
#include <cstdio>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x50414642325042ULL; /* "PAFB2PB" */
constexpr uint32_t kVersion = 5;
/* reader-slot claim states: a released slot keeps its cursor (resume
 * semantics for a restarted reader) but a NEW reader must prefer a
 * never-claimed slot — otherwise a late-attaching second reader can
 * inherit a finished slot's end-of-stream cursor and silently see an
 * empty stream (found by the launcher's dual-reader topology test) */
constexpr uint32_t kSlotFresh = 0;
constexpr uint32_t kSlotLocked = 1;
constexpr uint32_t kSlotReleased = 2;
constexpr uint64_t kPollUs = 200; /* wait poll interval */
constexpr uint64_t kNoEod = ~0ULL;
constexpr uint64_t kNoSod = ~0ULL;

/* Control page at the start of the segment. Cursors are monotonically
 * increasing block counts (never wrapped), so full/empty tests are simple
 * subtractions and ABA cannot occur.
 *
 * Multi-reader protocol (the `dada_db -r NREADER` analogue,
 * paf-baseband2power.py:114 / paf-baseband2power.conf:13): each of the
 * `nreaders` reader slots keeps its own open/close cursors; a block is
 * recyclable only once the *slowest* reader has released it, so the writer
 * waits on min(r_closed). Readers claim a slot with a CAS at lock time. */
struct Control {
  uint64_t magic;
  uint32_t version;
  uint32_t hdrsz;
  uint64_t bufsz;
  uint32_t nbufs;
  uint32_t nreaders; /* reader slots every block must pass through */
  uint32_t flags;    /* PAFB2P_RB_FLAG_* set at creation */
  uint32_t pad_;

  std::atomic<uint64_t> w_opened;  /* blocks opened for write  */
  std::atomic<uint64_t> w_closed;  /* blocks committed         */
  std::atomic<uint64_t> eod_block; /* first block index past end, or kNoEod */
  std::atomic<uint64_t> sod_block; /* first observation block, or kNoSod */
  std::atomic<uint32_t> hdr_filled;
  std::atomic<uint32_t> w_locked; /* writer registration */
  std::atomic<uint64_t> r_opened[PAFB2P_RB_MAX_READERS];
  std::atomic<uint64_t> r_closed[PAFB2P_RB_MAX_READERS];
  std::atomic<uint32_t> r_locked[PAFB2P_RB_MAX_READERS];
  /* per-block payload sizes follow, then the header area, then data */
};

/* Slowest reader's release cursor — the writer's reuse horizon. */
uint64_t min_r_closed(const Control *c) {
  uint64_t m = ~0ULL;
  for (uint32_t i = 0; i < c->nreaders; ++i) {
    uint64_t v = c->r_closed[i].load(std::memory_order_acquire);
    if (v < m)
      m = v;
  }
  return m;
}

size_t control_bytes(uint32_t nbufs) {
  return (sizeof(Control) + nbufs * sizeof(uint64_t) + 63) & ~size_t(63);
}

size_t segment_bytes(uint64_t bufsz, uint32_t nbufs, uint32_t hdrsz) {
  return control_bytes(nbufs) + hdrsz + bufsz * nbufs;
}

void shm_name(const char *key, char *out, size_t n) {
  snprintf(out, n, "/pafb2p-%s", key);
}

void sleep_us(uint64_t us) {
  struct timespec ts;
  ts.tv_sec = static_cast<time_t>(us / 1000000);
  ts.tv_nsec = static_cast<long>((us % 1000000) * 1000);
  nanosleep(&ts, nullptr);
}

} // namespace

struct pafb2p_rb {
  Control *ctl = nullptr;
  uint64_t *block_bytes = nullptr;
  uint8_t *hdr = nullptr;
  uint8_t *data = nullptr;
  size_t map_len = 0;
  bool is_writer = false;
  bool pages_locked = false; /* this mapping is mlocked */
  int reader_slot = -1;      /* >= 0 once locked for read */
};

extern "C" {

int pafb2p_rb_create(const char *key, uint64_t bufsz, uint32_t nbufs,
                     uint32_t hdrsz, uint32_t nreaders) {
  return pafb2p_rb_create_ex(key, bufsz, nbufs, hdrsz, nreaders, 0);
}

int pafb2p_rb_create_ex(const char *key, uint64_t bufsz, uint32_t nbufs,
                        uint32_t hdrsz, uint32_t nreaders, uint32_t flags) {
  if (bufsz == 0 || nbufs == 0 || nreaders == 0 ||
      nreaders > PAFB2P_RB_MAX_READERS)
    return -EINVAL;
  char name[256];
  shm_name(key, name, sizeof(name));
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0)
    return -errno;
  size_t len = segment_bytes(bufsz, nbufs, hdrsz);
  if (ftruncate(fd, static_cast<off_t>(len)) != 0) {
    int e = errno;
    close(fd);
    shm_unlink(name);
    return -e;
  }
  void *p = mmap(nullptr, len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (p == MAP_FAILED) {
    shm_unlink(name);
    return -errno;
  }
  auto *ctl = new (p) Control();
  ctl->magic = kMagic;
  ctl->version = kVersion;
  ctl->hdrsz = hdrsz;
  ctl->bufsz = bufsz;
  ctl->nbufs = nbufs;
  ctl->nreaders = nreaders;
  ctl->flags = flags;
  ctl->w_opened.store(0);
  ctl->w_closed.store(0);
  ctl->eod_block.store(kNoEod);
  ctl->sod_block.store(kNoSod);
  ctl->hdr_filled.store(0);
  ctl->w_locked.store(0);
  for (uint32_t i = 0; i < PAFB2P_RB_MAX_READERS; ++i) {
    ctl->r_opened[i].store(0);
    ctl->r_closed[i].store(0);
    ctl->r_locked[i].store(0);
  }
  munmap(p, len);
  return 0;
}

int pafb2p_rb_destroy(const char *key) {
  char name[256];
  shm_name(key, name, sizeof(name));
  return shm_unlink(name) == 0 ? 0 : -errno;
}

pafb2p_rb *pafb2p_rb_connect(const char *key) {
  char name[256];
  shm_name(key, name, sizeof(name));
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0)
    return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void *p = mmap(nullptr, static_cast<size_t>(st.st_size),
                 PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (p == MAP_FAILED)
    return nullptr;
  auto *ctl = static_cast<Control *>(p);
  if (ctl->magic != kMagic || ctl->version != kVersion ||
      segment_bytes(ctl->bufsz, ctl->nbufs, ctl->hdrsz) !=
          static_cast<size_t>(st.st_size)) {
    munmap(p, static_cast<size_t>(st.st_size));
    return nullptr;
  }
  auto *h = new pafb2p_rb();
  h->ctl = ctl;
  h->map_len = static_cast<size_t>(st.st_size);
  if (ctl->flags & PAFB2P_RB_FLAG_LOCK_PAGES) {
    /* best effort per-mapping: an RLIMIT_MEMLOCK denial must not make the
     * ring unusable, only unlocked (caller can check pages_locked) */
    h->pages_locked = mlock(p, h->map_len) == 0;
  }
  h->block_bytes =
      reinterpret_cast<uint64_t *>(reinterpret_cast<uint8_t *>(p) + sizeof(Control));
  h->hdr = reinterpret_cast<uint8_t *>(p) + control_bytes(ctl->nbufs);
  h->data = h->hdr + ctl->hdrsz;
  return h;
}

void pafb2p_rb_disconnect(pafb2p_rb *h) {
  if (!h)
    return;
  if (h->is_writer)
    pafb2p_rb_unlock_write(h);
  if (h->reader_slot >= 0)
    pafb2p_rb_unlock_read(h);
  munmap(h->ctl, h->map_len);
  delete h;
}

int pafb2p_rb_pages_locked(const pafb2p_rb *h) {
  return h && h->pages_locked ? 1 : 0;
}

uint64_t pafb2p_rb_bufsz(const pafb2p_rb *h) { return h ? h->ctl->bufsz : 0; }
uint32_t pafb2p_rb_nbufs(const pafb2p_rb *h) { return h ? h->ctl->nbufs : 0; }
uint32_t pafb2p_rb_hdrsz(const pafb2p_rb *h) { return h ? h->ctl->hdrsz : 0; }
uint32_t pafb2p_rb_nreaders(const pafb2p_rb *h) {
  return h ? h->ctl->nreaders : 0;
}

int pafb2p_rb_write_header(pafb2p_rb *h, const char *buf, size_t n) {
  if (n > h->ctl->hdrsz)
    return -EMSGSIZE;
  memcpy(h->hdr, buf, n);
  if (n < h->ctl->hdrsz)
    memset(h->hdr + n, 0, h->ctl->hdrsz - n);
  h->ctl->hdr_filled.store(1, std::memory_order_release);
  return 0;
}

int pafb2p_rb_read_header(pafb2p_rb *h, char *buf, size_t n,
                          uint64_t timeout_us) {
  uint64_t waited = 0;
  while (!h->ctl->hdr_filled.load(std::memory_order_acquire)) {
    if (waited >= timeout_us)
      return -ETIMEDOUT;
    sleep_us(kPollUs);
    waited += kPollUs;
  }
  size_t c = n < h->ctl->hdrsz ? n : h->ctl->hdrsz;
  memcpy(buf, h->hdr, c);
  return static_cast<int>(c);
}

int pafb2p_rb_lock_write(pafb2p_rb *h) {
  uint32_t expect = 0;
  if (!h->ctl->w_locked.compare_exchange_strong(expect, 1))
    return -EBUSY; /* single-writer protocol */
  h->is_writer = true;
  return 0;
}

int pafb2p_rb_unlock_write(pafb2p_rb *h) {
  if (!h->is_writer)
    return -EPERM;
  /* an exiting writer that never signalled EOD leaves the stream open-ended;
   * mark EOD so readers terminate (reference always signals EOD on exit
   * paths, sync.c:184,196) */
  if (h->ctl->eod_block.load() == kNoEod)
    pafb2p_rb_set_eod(h);
  h->is_writer = false;
  h->ctl->w_locked.store(0);
  return 0;
}

uint8_t *pafb2p_rb_open_block_write(pafb2p_rb *h, uint64_t timeout_us) {
  if (!h->is_writer)
    return nullptr;
  Control *c = h->ctl;
  uint64_t w = c->w_opened.load(std::memory_order_relaxed);
  if (w != c->w_closed.load(std::memory_order_relaxed))
    return nullptr; /* a block is already open */
  uint64_t waited = 0;
  while (w - min_r_closed(c) >= c->nbufs) {
    if (waited >= timeout_us)
      return nullptr; /* ring full (slowest reader holds the horizon) */
    sleep_us(kPollUs);
    waited += kPollUs;
  }
  c->w_opened.store(w + 1, std::memory_order_relaxed);
  return h->data + (w % c->nbufs) * c->bufsz;
}

int pafb2p_rb_close_block_write(pafb2p_rb *h, uint64_t nbytes) {
  Control *c = h->ctl;
  uint64_t w = c->w_closed.load(std::memory_order_relaxed);
  if (c->w_opened.load(std::memory_order_relaxed) != w + 1)
    return -EPERM; /* no block open */
  if (nbytes > c->bufsz)
    return -EMSGSIZE;
  h->block_bytes[w % c->nbufs] = nbytes;
  c->w_closed.store(w + 1, std::memory_order_release);
  return 0;
}

int pafb2p_rb_set_eod(pafb2p_rb *h) {
  uint64_t end = h->ctl->w_closed.load(std::memory_order_relaxed);
  h->ctl->eod_block.store(end, std::memory_order_release);
  return 0;
}

int pafb2p_rb_set_sod(pafb2p_rb *h) {
  /* Marked at the committed cursor BEFORE the first observation block is
   * written; when the marking process is the writer (paf_capture /
   * paf_diskdb), the release ordering of close_block_write guarantees any
   * reader that sees a post-SOD block committed also sees the mark, so
   * wait_sod can never discard observation data. Marking from a THIRD
   * process (paf_db --sod) has no such happens-before with the writer's
   * commits — seq_cst here plus wait_sod's re-check before each discard
   * shrinks that window to memory-propagation scale, but out-of-band
   * marking remains advisory within the block being committed at that
   * instant (block cadence ~1 s; the window is ~us). Not restricted to
   * the lock-holding handle: capture registers its header from a sibling
   * connection in the same process (cli/paf_capture.py), like PSRDADA's
   * unpoliced ipcbuf_enable_sod. */
  uint64_t start = h->ctl->w_closed.load(std::memory_order_relaxed);
  h->ctl->sod_block.store(start, std::memory_order_seq_cst);
  return 0;
}

int64_t pafb2p_rb_sod_block(const pafb2p_rb *h) {
  uint64_t sod = h->ctl->sod_block.load(std::memory_order_acquire);
  return sod == kNoSod ? -1 : static_cast<int64_t>(sod);
}

int pafb2p_rb_lock_read(pafb2p_rb *h) {
  if (h->reader_slot >= 0)
    return -EPERM; /* already a reader */
  /* two passes: never-claimed slots first (a fresh reader starts at
   * block 0), then released slots (a restarted reader resumes its
   * predecessor's cursor) */
  for (uint32_t want : {kSlotFresh, kSlotReleased}) {
    for (uint32_t i = 0; i < h->ctl->nreaders; ++i) {
      uint32_t expect = want;
      if (h->ctl->r_locked[i].compare_exchange_strong(expect, kSlotLocked)) {
        h->reader_slot = static_cast<int>(i);
        return 0;
      }
    }
  }
  return -EBUSY; /* all nreaders slots taken */
}

int pafb2p_rb_unlock_read(pafb2p_rb *h) {
  if (h->reader_slot < 0)
    return -EPERM;
  h->ctl->r_locked[h->reader_slot].store(kSlotReleased);
  h->reader_slot = -1;
  return 0;
}

const uint8_t *pafb2p_rb_open_block_read(pafb2p_rb *h, uint64_t *nbytes,
                                         uint64_t timeout_us) {
  if (h->reader_slot < 0)
    return nullptr;
  Control *c = h->ctl;
  int s = h->reader_slot;
  uint64_t r = c->r_opened[s].load(std::memory_order_relaxed);
  if (r != c->r_closed[s].load(std::memory_order_relaxed))
    return nullptr; /* a block is already open */
  uint64_t waited = 0;
  while (c->w_closed.load(std::memory_order_acquire) == r) {
    if (c->eod_block.load(std::memory_order_acquire) <= r)
      return nullptr; /* end of data */
    if (waited >= timeout_us)
      return nullptr;
    sleep_us(kPollUs);
    waited += kPollUs;
  }
  c->r_opened[s].store(r + 1, std::memory_order_relaxed);
  if (nbytes)
    *nbytes = h->block_bytes[r % c->nbufs];
  return h->data + (r % c->nbufs) * c->bufsz;
}

int pafb2p_rb_close_block_read(pafb2p_rb *h) {
  if (h->reader_slot < 0)
    return -EPERM;
  Control *c = h->ctl;
  int s = h->reader_slot;
  uint64_t r = c->r_closed[s].load(std::memory_order_relaxed);
  if (c->r_opened[s].load(std::memory_order_relaxed) != r + 1)
    return -EPERM;
  c->r_closed[s].store(r + 1, std::memory_order_release);
  return 0;
}

int64_t pafb2p_rb_wait_sod(pafb2p_rb *h, uint64_t timeout_us) {
  if (h->reader_slot < 0)
    return -EPERM;
  Control *c = h->ctl;
  int s = h->reader_slot;
  uint64_t waited = 0;
  for (;;) {
    uint64_t r = c->r_closed[s].load(std::memory_order_relaxed);
    if (c->r_opened[s].load(std::memory_order_relaxed) != r)
      return -EPERM; /* a block is open */
    /* Load order matters: w (acquire) BEFORE sod. A post-SOD block's
     * commit release-orders the earlier sod store, so a block observed
     * committed while sod still reads unset is provably pre-SOD and safe
     * to discard. */
    uint64_t w = c->w_closed.load(std::memory_order_acquire);
    uint64_t sod = c->sod_block.load(std::memory_order_acquire);
    if (sod != kNoSod) {
      /* return where this reader actually starts: a RESUMED slot may
       * already stand past the mark, and start_block's contract is
       * "first block this source will yield" */
      if (r >= sod)
        return static_cast<int64_t>(r);
      /* fast-forward over committed pre-SOD blocks (never past w: the
       * cursor invariant r <= w must hold) */
      uint64_t target = sod < w ? sod : w;
      if (target > r) {
        c->r_opened[s].store(target, std::memory_order_relaxed);
        c->r_closed[s].store(target, std::memory_order_release);
        continue;
      }
      /* r == w < sod: the pre-SOD blocks aren't all committed yet */
    } else if (w > r) {
      /* discard one pre-SOD block so the writer is never stalled by a
       * SOD-waiting reader, however much transient data flows. Re-check
       * the mark right before the bump (seq_cst pairs with set_sod):
       * narrows the out-of-band paf_db --sod race to propagation scale */
      if (c->sod_block.load(std::memory_order_seq_cst) != kNoSod)
        continue;
      c->r_opened[s].store(r + 1, std::memory_order_relaxed);
      c->r_closed[s].store(r + 1, std::memory_order_release);
      continue;
    } else {
      uint64_t eod = c->eod_block.load(std::memory_order_acquire);
      if (eod != kNoEod && r >= eod)
        return -ENODATA; /* stream ended without a SOD mark */
    }
    if (waited >= timeout_us)
      return -ETIMEDOUT;
    sleep_us(kPollUs);
    waited += kPollUs;
  }
}

int pafb2p_rb_at_eod(const pafb2p_rb *h) {
  Control *c = h->ctl;
  uint64_t eod = c->eod_block.load(std::memory_order_acquire);
  if (eod == kNoEod)
    return 0;
  uint64_t r = h->reader_slot >= 0
                   ? c->r_closed[h->reader_slot].load(std::memory_order_relaxed)
                   : min_r_closed(c);
  return r >= eod ? 1 : 0;
}

uint64_t pafb2p_rb_blocks_written(const pafb2p_rb *h) {
  return h->ctl->w_closed.load(std::memory_order_relaxed);
}
uint64_t pafb2p_rb_blocks_read(const pafb2p_rb *h) {
  /* the slowest reader's progress — the writer's view of consumption */
  return min_r_closed(h->ctl);
}
uint64_t pafb2p_rb_blocks_full(const pafb2p_rb *h) {
  return h->ctl->w_closed.load(std::memory_order_relaxed) -
         min_r_closed(h->ctl);
}

} /* extern "C" */
