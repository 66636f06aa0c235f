/* Implementation of the pafb2p native software BMF sender (see sender.h). */

#include "sender.h"

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <cerrno>
#include <cstring>
#include <ctime>
#include <thread>
#include <vector>

namespace {

constexpr size_t kHdrBytes = 64;
constexpr size_t kPayloadBytes = 7168;
constexpr size_t kPayloadInt16 = kPayloadBytes / 2;
constexpr uint64_t kNdfPrd = 250000;
constexpr uint64_t kPrdSec = 27;
constexpr double kTdfSec = 1.08e-4; /* frame interval (capture.h:30) */
constexpr int kPayloadBases = 251;  /* ramp base period (io/sender.py) */

/* 64-byte header, big-endian words (wire contract hdr.c:10-28). */
void encode_hdr(uint8_t *out, uint64_t idf, uint64_t sec, uint32_t epoch,
                double freq, uint32_t beam) {
  uint64_t w0 = (1ULL << 63) | ((sec & 0x3fffffffULL) << 32) |
                (idf & 0xffffffffULL);
  uint64_t w1 = static_cast<uint64_t>(epoch & 0x3f) << 26;
  uint64_t w2 = (static_cast<uint64_t>(static_cast<uint16_t>(freq)) << 16) |
                (beam & 0xffff);
  w0 = __builtin_bswap64(w0);
  w1 = __builtin_bswap64(w1);
  w2 = __builtin_bswap64(w2);
  memset(out, 0, kHdrBytes);
  memcpy(out, &w0, 8);
  memcpy(out + 8, &w1, 8);
  memcpy(out + 16, &w2, 8);
}

struct timespec deadline_for(const struct timespec &t0, double sec) {
  struct timespec ts = t0;
  long nsec = static_cast<long>(sec * 1e9);
  ts.tv_nsec += nsec % 1000000000L;
  ts.tv_sec += nsec / 1000000000L;
  if (ts.tv_nsec >= 1000000000L) {
    ts.tv_nsec -= 1000000000L;
    ts.tv_sec += 1;
  }
  return ts;
}

/* One thread per port: stream this port's chunk subset, paced on absolute
 * deadlines shared across all ports (all start from the same t0). */
int64_t port_sender(const pafb2p_sender_conf *conf, int port_index,
                    uint32_t chk_lo, uint32_t chk_hi,
                    const int16_t *payload_table,
                    const struct timespec *t0) {
  int sock = socket(AF_INET, SOCK_DGRAM, 0);
  if (sock < 0)
    return -errno;
  int sndbuf = 16 * 1024 * 1024;
  setsockopt(sock, SOL_SOCKET, SO_SNDBUF, &sndbuf, sizeof(sndbuf));
  struct sockaddr_in dst;
  memset(&dst, 0, sizeof(dst));
  dst.sin_family = AF_INET;
  dst.sin_port = htons(static_cast<uint16_t>(conf->port_base + port_index));
  dst.sin_addr.s_addr = inet_addr(conf->host);
  if (connect(sock, reinterpret_cast<struct sockaddr *>(&dst),
              sizeof(dst)) != 0) {
    int e = errno;
    close(sock);
    return -e;
  }

  uint32_t burst = conf->burst ? conf->burst : 16;
  uint32_t nchk_port = chk_hi - chk_lo;
  size_t max_msgs = static_cast<size_t>(burst) * nchk_port;
  std::vector<uint8_t> hdrs(max_msgs * kHdrBytes);
  std::vector<struct iovec> iovs(max_msgs * 2);
  std::vector<struct mmsghdr> msgs(max_msgs);

  int64_t sent = 0;
  uint64_t k = 0;
  while (k < conf->nframes) {
    uint32_t n_ft = static_cast<uint32_t>(
        conf->nframes - k < burst ? conf->nframes - k : burst);
    size_t nmsg = 0;
    for (uint32_t b = 0; b < n_ft; ++b) {
      uint64_t kk = k + b;
      uint64_t idf = conf->idf0 + kk;
      uint64_t sec = conf->sec0 + (idf / kNdfPrd) * kPrdSec;
      idf %= kNdfPrd;
      /* payload key is the pre-wrap frame count (io/sender.py contract) */
      int base = static_cast<int>((conf->idf0 + kk) * 131 % kPayloadBases);
      for (uint32_t c = chk_lo; c < chk_hi; ++c) {
        uint8_t *hp = hdrs.data() + nmsg * kHdrBytes;
        encode_hdr(hp, idf, sec, conf->epoch,
                   conf->freq_base + c * conf->chunk_bw, conf->beam);
        int pbase = static_cast<int>((base + c * 17) % kPayloadBases);
        iovs[nmsg * 2].iov_base = hp;
        iovs[nmsg * 2].iov_len = kHdrBytes;
        iovs[nmsg * 2 + 1].iov_base = const_cast<int16_t *>(
            payload_table + static_cast<size_t>(pbase) * kPayloadInt16);
        iovs[nmsg * 2 + 1].iov_len = kPayloadBytes;
        memset(&msgs[nmsg], 0, sizeof(msgs[nmsg]));
        msgs[nmsg].msg_hdr.msg_iov = &iovs[nmsg * 2];
        msgs[nmsg].msg_hdr.msg_iovlen = 2;
        ++nmsg;
      }
    }
    size_t off = 0;
    while (off < nmsg) {
      int rc = sendmmsg(sock, msgs.data() + off,
                        static_cast<unsigned>(nmsg - off), 0);
      if (rc < 0) {
        if (errno == EINTR)
          continue;
        if (errno == ENOBUFS || errno == EAGAIN) {
          struct timespec ts = {0, 50000};
          nanosleep(&ts, nullptr);
          continue;
        }
        close(sock);
        return -errno;
      }
      off += static_cast<size_t>(rc);
      sent += rc;
    }
    k += n_ft;
    if (conf->rate > 0) {
      struct timespec dl =
          deadline_for(*t0, static_cast<double>(k) * kTdfSec / conf->rate);
      while (clock_nanosleep(CLOCK_MONOTONIC, TIMER_ABSTIME, &dl, nullptr) ==
             EINTR) {
      }
    }
  }
  close(sock);
  return sent;
}

} // namespace

extern "C" {

int64_t pafb2p_sender_run(const pafb2p_sender_conf *conf) {
  if (!conf || conf->nports <= 0 || conf->nchk == 0)
    return -EINVAL;

  /* payload table: all 251 ramp variants, built once (1.8 MB) */
  std::vector<int16_t> table(static_cast<size_t>(kPayloadBases) *
                             kPayloadInt16);
  for (int base = 0; base < kPayloadBases; ++base)
    for (size_t j = 0; j < kPayloadInt16; ++j)
      table[static_cast<size_t>(base) * kPayloadInt16 + j] =
          static_cast<int16_t>(j % 199 + base);

  uint32_t per_port =
      (conf->nchk + static_cast<uint32_t>(conf->nports) - 1) /
      static_cast<uint32_t>(conf->nports);
  struct timespec t0;
  clock_gettime(CLOCK_MONOTONIC, &t0);

  std::vector<std::thread> threads;
  std::vector<int64_t> results(conf->nports, 0);
  for (int p = 0; p < conf->nports; ++p) {
    uint32_t lo = static_cast<uint32_t>(p) * per_port;
    uint32_t hi = lo + per_port < conf->nchk ? lo + per_port : conf->nchk;
    if (lo >= hi)
      continue;
    threads.emplace_back([&, p, lo, hi]() {
      results[p] = port_sender(conf, p, lo, hi, table.data(), &t0);
    });
  }
  int64_t total = 0;
  for (auto &t : threads)
    t.join();
  for (int p = 0; p < conf->nports; ++p) {
    if (results[p] < 0)
      return results[p];
    total += results[p];
  }
  return total;
}

} /* extern "C" */
