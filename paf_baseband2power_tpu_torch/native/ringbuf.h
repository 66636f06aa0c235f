/* pafb2p native shared-memory ring buffer.
 *
 * A ground-up C++ replacement for the PSRDADA ipcbuf/ipcio fabric the
 * reference pipeline is built on (SURVEY.md L2: keyed shm segments holding a
 * header block plus N data blocks, with writer/reader block locking and
 * SOD/EOD stream framing — behavioral contract from capture.c:586-642,
 * sync.c:101-110, diskdb.cu:24-67). Differences by design:
 *
 *   - POSIX shm (shm_open/mmap) instead of SysV, one segment per ring.
 *   - Lock-free single-writer/multi-reader protocol: monotonically
 *     increasing block cursors in std::atomic<uint64_t>, waits are
 *     microsleep polls (block cadence is ~1 Hz at 2.8 GB blocks; no
 *     cross-process robust-mutex complexity).
 *   - N reader slots (the `dada_db -r NREADER` analogue,
 *     paf-baseband2power.py:114): every block must be released by all
 *     nreaders before the writer may reuse it.
 *   - Explicit per-block byte counts so a final partial block is legal.
 *
 * C ABI for ctypes binding; returns 0 on success, negative errno-style
 * codes on failure.
 */

#ifndef PAFB2P_RINGBUF_H
#define PAFB2P_RINGBUF_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct pafb2p_rb pafb2p_rb; /* opaque handle */

#define PAFB2P_RB_MAX_READERS 8

/* creation flags */
#define PAFB2P_RB_FLAG_LOCK_PAGES 0x1u /* mlock the segment in every
                                        * connecting process (the `dada_db
                                        * -l` analogue, paf-baseband2power.
                                        * py:114): a 22.5 GB ring paging
                                        * mid-stream is data loss. Best
                                        * effort — an RLIMIT_MEMLOCK denial
                                        * degrades to unlocked, queryable
                                        * via pafb2p_rb_pages_locked. */

/* lifecycle; nreaders = reader slots every block must pass through
 * (1..PAFB2P_RB_MAX_READERS) */
int pafb2p_rb_create(const char *key, uint64_t bufsz, uint32_t nbufs,
                     uint32_t hdrsz, uint32_t nreaders);
int pafb2p_rb_create_ex(const char *key, uint64_t bufsz, uint32_t nbufs,
                        uint32_t hdrsz, uint32_t nreaders, uint32_t flags);
int pafb2p_rb_destroy(const char *key);
pafb2p_rb *pafb2p_rb_connect(const char *key);
void pafb2p_rb_disconnect(pafb2p_rb *h);
/* 1 if this process's mapping is mlocked (ring created with LOCK_PAGES and
 * the mlock succeeded here) */
int pafb2p_rb_pages_locked(const pafb2p_rb *h);

/* geometry */
uint64_t pafb2p_rb_bufsz(const pafb2p_rb *h);
uint32_t pafb2p_rb_nbufs(const pafb2p_rb *h);
uint32_t pafb2p_rb_hdrsz(const pafb2p_rb *h);
uint32_t pafb2p_rb_nreaders(const pafb2p_rb *h);

/* header channel (stream metadata, DADA ASCII by convention) */
int pafb2p_rb_write_header(pafb2p_rb *h, const char *buf, size_t n);
int pafb2p_rb_read_header(pafb2p_rb *h, char *buf, size_t n,
                          uint64_t timeout_us);

/* writer side */
int pafb2p_rb_lock_write(pafb2p_rb *h);
int pafb2p_rb_unlock_write(pafb2p_rb *h);
uint8_t *pafb2p_rb_open_block_write(pafb2p_rb *h, uint64_t timeout_us);
int pafb2p_rb_close_block_write(pafb2p_rb *h, uint64_t nbytes);
int pafb2p_rb_set_eod(pafb2p_rb *h); /* mark end-of-data at current cursor */
/* Mark start-of-data at the current write cursor: the next block committed
 * is the first block of the observation (the ipcbuf_enable_sod analogue,
 * capture.c:622-639 / diskdb.cu:36-67). Blocks committed before SOD are
 * pre-observation transient data; readers using pafb2p_rb_wait_sod discard
 * them. Call from the writing process before committing the first
 * observation block. */
int pafb2p_rb_set_sod(pafb2p_rb *h);
/* SOD block index, or -1 while unset. */
int64_t pafb2p_rb_sod_block(const pafb2p_rb *h);

/* reader side */
int pafb2p_rb_lock_read(pafb2p_rb *h);
int pafb2p_rb_unlock_read(pafb2p_rb *h);
const uint8_t *pafb2p_rb_open_block_read(pafb2p_rb *h, uint64_t *nbytes,
                                         uint64_t timeout_us);
int pafb2p_rb_close_block_read(pafb2p_rb *h);
int pafb2p_rb_at_eod(const pafb2p_rb *h); /* 1 once all written data consumed */
/* Wait for the observation start and fast-forward to it: committed blocks
 * before the SOD mark are discarded (released back to the writer as they
 * arrive, so a SOD-waiting reader never stalls the writer no matter how
 * much pre-observation data flows). Returns the index of the first block
 * this reader will yield — the SOD block, or the resumed slot's cursor if
 * that already stands past the mark; -ETIMEDOUT after timeout_us;
 * -ENODATA if the stream ended without a SOD mark. Requires a locked
 * reader with no block open. Enables mid-stream attach: a reader joining
 * a running ring starts at the marked observation boundary (PSRDADA SOD
 * semantics). */
int64_t pafb2p_rb_wait_sod(pafb2p_rb *h, uint64_t timeout_us);

/* observability */
uint64_t pafb2p_rb_blocks_written(const pafb2p_rb *h);
uint64_t pafb2p_rb_blocks_read(const pafb2p_rb *h);
uint64_t pafb2p_rb_blocks_full(const pafb2p_rb *h); /* written-not-yet-read */

#ifdef __cplusplus
}
#endif

#endif /* PAFB2P_RINGBUF_H */
