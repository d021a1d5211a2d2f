// hkdcomm — native UDP-multicast pub/sub transport speaking the LCM wire
// protocol, wire-compatible with the reference's LCM 1.4 runtime
// (the reference publishes/subscribes over udpm://239.255.76.67:7667,
// common/utilities.h:303-306). Re-implemented from the public LCM UDP
// protocol description: single-datagram messages carry magic "LC02",
// a 32-bit sequence number, the NUL-terminated channel name, then the
// payload; messages larger than one datagram use the "LC03" fragment
// header. Exposed through a C ABI for Python ctypes.
//
// This is the framework's robot-facing edge: the device-side batched solver
// stays in JAX; this native runtime handles the low-latency host I/O the
// reference delegates to liblcm + pthreads.

#include <arpa/inet.h>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <condition_variable>
#include <deque>
#include <map>
#include <mutex>
#include <netinet/in.h>
#include <string>
#include <sys/socket.h>
#include <sys/types.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr uint32_t MAGIC_SHORT = 0x4c433032;  // "LC02"
constexpr uint32_t MAGIC_FRAG = 0x4c433033;   // "LC03"
constexpr size_t MAX_DGRAM = 65499;
constexpr size_t FRAG_PAYLOAD = 60000;

struct Message {
    std::string channel;
    std::vector<uint8_t> data;
};

struct FragBuf {
    std::vector<uint8_t> data;
    std::string channel;
    uint32_t msg_size = 0;
    uint16_t frags_seen = 0;
    uint16_t frags_total = 0;
};

class UdpmTransport {
  public:
    UdpmTransport(const char *addr, int port, int ttl) {
        send_fd_ = socket(AF_INET, SOCK_DGRAM, 0);
        recv_fd_ = socket(AF_INET, SOCK_DGRAM, 0);
        int one = 1;
        setsockopt(recv_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
        // a few 64 KB fragments back to back overflow the default receive
        // buffer (about 208 KB) and UDP drops the rest; ask for 2 MB as LCM
        // does (the kernel caps it at net.core.rmem_max)
        int rcvbuf = 2 * 1024 * 1024;
        setsockopt(recv_fd_, SOL_SOCKET, SO_RCVBUF, &rcvbuf, sizeof(rcvbuf));
        setsockopt(send_fd_, IPPROTO_IP, IP_MULTICAST_TTL, &ttl, sizeof(ttl));
        unsigned char loop = 1;
        setsockopt(send_fd_, IPPROTO_IP, IP_MULTICAST_LOOP, &loop, sizeof(loop));

        memset(&dest_, 0, sizeof(dest_));
        dest_.sin_family = AF_INET;
        dest_.sin_port = htons(port);
        inet_pton(AF_INET, addr, &dest_.sin_addr);

        sockaddr_in bind_addr{};
        bind_addr.sin_family = AF_INET;
        bind_addr.sin_port = htons(port);
        bind_addr.sin_addr.s_addr = htonl(INADDR_ANY);
        bind_ok_ = (bind(recv_fd_, (sockaddr *)&bind_addr, sizeof(bind_addr)) == 0);

        ip_mreq mreq{};
        mreq.imr_multiaddr = dest_.sin_addr;
        mreq.imr_interface.s_addr = htonl(INADDR_ANY);
        setsockopt(recv_fd_, IPPROTO_IP, IP_ADD_MEMBERSHIP, &mreq, sizeof(mreq));

        running_ = true;
        rx_thread_ = std::thread(&UdpmTransport::rx_loop, this);
    }

    ~UdpmTransport() {
        running_ = false;
        shutdown(recv_fd_, SHUT_RDWR);
        close(recv_fd_);
        if (rx_thread_.joinable()) rx_thread_.join();
        close(send_fd_);
    }

    int publish(const char *channel, const uint8_t *data, size_t len) {
        size_t chan_len = strlen(channel);
        if (8 + chan_len + 1 + len <= MAX_DGRAM) {
            std::vector<uint8_t> pkt(8 + chan_len + 1 + len);
            uint32_t magic = htonl(MAGIC_SHORT);
            uint32_t seq = htonl(msg_seq_);
            memcpy(pkt.data(), &magic, 4);
            memcpy(pkt.data() + 4, &seq, 4);
            memcpy(pkt.data() + 8, channel, chan_len + 1);
            memcpy(pkt.data() + 9 + chan_len, data, len);
            ++msg_seq_;
            ssize_t n = sendto(send_fd_, pkt.data(), pkt.size(), 0,
                               (sockaddr *)&dest_, sizeof(dest_));
            return n == (ssize_t)pkt.size() ? 0 : -1;
        }
        // fragmented path (LC03)
        uint16_t nfrags = (uint16_t)((len + FRAG_PAYLOAD - 1) / FRAG_PAYLOAD);
        uint32_t offset = 0;
        for (uint16_t f = 0; f < nfrags; ++f) {
            size_t chunk = std::min(FRAG_PAYLOAD, len - offset);
            std::vector<uint8_t> pkt;
            pkt.reserve(20 + chan_len + 1 + chunk);
            auto push32 = [&](uint32_t v) {
                uint32_t nv = htonl(v);
                const uint8_t *p = (const uint8_t *)&nv;
                pkt.insert(pkt.end(), p, p + 4);
            };
            auto push16 = [&](uint16_t v) {
                uint16_t nv = htons(v);
                const uint8_t *p = (const uint8_t *)&nv;
                pkt.insert(pkt.end(), p, p + 2);
            };
            push32(MAGIC_FRAG);
            push32(msg_seq_);
            push32((uint32_t)len);
            push32(offset);
            push16(f);
            push16(nfrags);
            if (f == 0)
                pkt.insert(pkt.end(), (const uint8_t *)channel,
                           (const uint8_t *)channel + chan_len + 1);
            pkt.insert(pkt.end(), data + offset, data + offset + chunk);
            if (sendto(send_fd_, pkt.data(), pkt.size(), 0, (sockaddr *)&dest_,
                       sizeof(dest_)) != (ssize_t)pkt.size())
                return -1;
            offset += (uint32_t)chunk;
        }
        ++msg_seq_;
        return 0;
    }

    void subscribe(const char *channel) {
        std::lock_guard<std::mutex> lk(mu_);
        subs_.insert({channel, {}});
    }

    // returns message length (>=0) or -1 on timeout; writes channel + data
    int receive(char *chan_out, int chan_cap, uint8_t *data_out, int data_cap,
                int timeout_ms) {
        std::unique_lock<std::mutex> lk(mu_);
        if (!cv_.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                          [&] { return !queue_.empty() || !running_; }))
            return -1;
        if (queue_.empty()) return -1;
        Message m = std::move(queue_.front());
        queue_.pop_front();
        snprintf(chan_out, chan_cap, "%s", m.channel.c_str());
        int n = std::min<int>((int)m.data.size(), data_cap);
        memcpy(data_out, m.data.data(), n);
        return n;
    }

    bool bind_ok() const { return bind_ok_; }

    uint64_t queue_drops() const {
        return queue_drops_.load(std::memory_order_relaxed);
    }
    uint64_t frag_evictions() const {
        return frag_evictions_.load(std::memory_order_relaxed);
    }

  private:
    void rx_loop() {
        std::vector<uint8_t> buf(65536);
        while (running_) {
            sockaddr_in src{};
            socklen_t slen = sizeof(src);
            ssize_t n = recvfrom(recv_fd_, buf.data(), buf.size(), 0,
                                 (sockaddr *)&src, &slen);
            if (n <= 8) continue;
            uint32_t magic;
            memcpy(&magic, buf.data(), 4);
            magic = ntohl(magic);
            if (magic == MAGIC_SHORT) {
                const char *chan = (const char *)buf.data() + 8;
                size_t chan_len = strnlen(chan, n - 8);
                size_t payload_off = 8 + chan_len + 1;
                if ((ssize_t)payload_off > n) continue;
                deliver(chan, buf.data() + payload_off, n - payload_off);
            } else if (magic == MAGIC_FRAG && n >= 20) {
                handle_frag(buf.data(), n, src);
            }
        }
    }

    void handle_frag(const uint8_t *p, ssize_t n, const sockaddr_in &src) {
        uint32_t seq, msg_size, offset;
        uint16_t fno, ftotal;
        memcpy(&seq, p + 4, 4); seq = ntohl(seq);
        memcpy(&msg_size, p + 8, 4); msg_size = ntohl(msg_size);
        memcpy(&offset, p + 12, 4); offset = ntohl(offset);
        memcpy(&fno, p + 16, 2); fno = ntohs(fno);
        memcpy(&ftotal, p + 18, 2); ftotal = ntohs(ftotal);
        size_t data_off = 20;
        // reassembly keyed by (sender, seq): two senders colliding on seq
        // must not corrupt each other (liblcm keys by sender address too)
        char key[64];
        snprintf(key, sizeof(key), "%08x:%04x:%u", ntohl(src.sin_addr.s_addr),
                 ntohs(src.sin_port), seq);
        FragBuf &fb = frags_[key];
        if (fb.data.empty()) {
            fb.data.resize(msg_size);
            fb.msg_size = msg_size;
            fb.frags_total = ftotal;
        }
        if (fno == 0) {
            const char *chan = (const char *)p + 20;
            size_t chan_len = strnlen(chan, n - 20);
            fb.channel.assign(chan, chan_len);
            data_off = 20 + chan_len + 1;
        }
        size_t chunk = n - data_off;
        if (offset + chunk <= fb.data.size()) {
            memcpy(fb.data.data() + offset, p + data_off, chunk);
            fb.frags_seen++;
        }
        if (fb.frags_seen == fb.frags_total) {
            deliver(fb.channel.c_str(), fb.data.data(), fb.data.size());
            frags_.erase(key);
        }
        // bound stale partial reassemblies (dropped fragments) — counted:
        // a silent eviction here means an in-flight message was lost
        if (frags_.size() > 64) {
            frags_.erase(frags_.begin());
            frag_evictions_.fetch_add(1, std::memory_order_relaxed);
        }
    }

    void deliver(const char *chan, const uint8_t *data, size_t len) {
        std::lock_guard<std::mutex> lk(mu_);
        if (!subs_.empty() && subs_.find(chan) == subs_.end()) return;
        queue_.push_back({chan, {data, data + len}});
        // overflow drops the OLDEST queued message — counted so a flooded
        // robot loop is diagnosable (the reference's liblcm surfaces drops
        // only in debug builds; we always count)
        if (queue_.size() > 256) {
            queue_.pop_front();
            queue_drops_.fetch_add(1, std::memory_order_relaxed);
        }
        cv_.notify_all();
    }

    std::atomic<uint64_t> queue_drops_{0};
    std::atomic<uint64_t> frag_evictions_{0};
    int send_fd_ = -1, recv_fd_ = -1;
    sockaddr_in dest_{};
    bool bind_ok_ = false;
    uint32_t msg_seq_ = 0;
    std::thread rx_thread_;
    std::mutex mu_;
    std::condition_variable cv_;
    std::deque<Message> queue_;
    std::map<std::string, FragBuf> frags_;
    std::map<std::string, std::vector<uint8_t>> subs_;
    volatile bool running_ = false;
};

}  // namespace

extern "C" {

void *hkdcomm_create(const char *addr, int port, int ttl) {
    return new UdpmTransport(addr, port, ttl);
}

void hkdcomm_destroy(void *h) { delete (UdpmTransport *)h; }

int hkdcomm_publish(void *h, const char *channel, const uint8_t *data,
                    int len) {
    return ((UdpmTransport *)h)->publish(channel, data, len);
}

void hkdcomm_subscribe(void *h, const char *channel) {
    ((UdpmTransport *)h)->subscribe(channel);
}

int hkdcomm_receive(void *h, char *chan_out, int chan_cap, uint8_t *data_out,
                    int data_cap, int timeout_ms) {
    return ((UdpmTransport *)h)->receive(chan_out, chan_cap, data_out,
                                         data_cap, timeout_ms);
}

int hkdcomm_bind_ok(void *h) { return ((UdpmTransport *)h)->bind_ok() ? 1 : 0; }

// drop observability: out[0] = queued messages dropped (queue overflow),
// out[1] = partial fragment reassemblies evicted (lost in-flight messages)
void hkdcomm_stats(void *h, unsigned long long out[2]) {
    out[0] = ((UdpmTransport *)h)->queue_drops();
    out[1] = ((UdpmTransport *)h)->frag_evictions();
}

}  // extern "C"
