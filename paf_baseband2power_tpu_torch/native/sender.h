/* pafb2p native software BMF sender.
 *
 * Streams wire-format BMF frames (64-byte big-endian header + 7168-byte
 * int16 payload; layout contract hdr.c:10-28) over UDP at up to the real
 * beamformer cadence — 48 chunks / 108 us = 444,444 frames/s ~ 3.19 GB/s
 * per node (capture.h:27,30). The reference has no software sender at all:
 * its capture path is testable only against the live instrument. This one
 * exists so the capture engine can be driven at production rate on
 * loopback (soak tests, ingest benchmarks).
 *
 * Design: one thread per port, each batching `burst` frame-times of its
 * chunk subset into a single sendmmsg(2) call with two iovecs per frame
 * (header scratch + a precomputed payload-table entry, zero per-frame
 * payload construction). Pacing is absolute-deadline clock_nanosleep so
 * bursts never drift.
 *
 * Payloads follow the deterministic ramp the Python sender uses
 * (io/sender.py): value[j] = (j % 199) + (idf*131 + ichk*17) % 251, so
 * capture placement tests can verify bytes bit-exactly against either
 * sender.
 */

#ifndef PAFB2P_SENDER_H
#define PAFB2P_SENDER_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct pafb2p_sender_conf {
  char host[64];      /* destination address, e.g. "127.0.0.1" */
  int port_base;      /* first UDP port */
  int nports;         /* ports; chunks are spread in contiguous groups */
  uint32_t nchk;      /* frequency chunks per frame-time */
  uint64_t nframes;   /* frame-times to send */
  uint64_t idf0;      /* starting frame index (pre-wrap) */
  uint64_t sec0;      /* starting period seconds */
  uint32_t epoch;     /* half-years since 2000 (hdr word 1) */
  uint32_t beam;      /* beam id (hdr word 2) */
  double freq_base;   /* FREQ of chunk 0, integer MHz */
  double chunk_bw;    /* FREQ spacing (7.0) */
  double rate;        /* stream pace as a multiple of real time; <=0 = max */
  uint32_t burst;     /* frame-times per sendmmsg batch (0 -> 16) */
} pafb2p_sender_conf;

/* Blocking; returns total frames sent or a negative errno. */
int64_t pafb2p_sender_run(const pafb2p_sender_conf *conf);

#ifdef __cplusplus
}
#endif

#endif /* PAFB2P_SENDER_H */
