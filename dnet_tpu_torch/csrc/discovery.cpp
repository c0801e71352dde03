// dnet_tpu_torch LAN discovery: UDP-broadcast peer announcement + peer table.
//
// The port's own copy of native/discovery.cpp (the reference package's),
// behind dnet_tpu_torch/utils/p2p.py.  Each node periodically broadcasts a
// small JSON announcement {instance, cluster, http_port, grpc_port,
// is_manager, slice_id} and keeps a table of the peers it heard recently
// (TTL-evicted).  The C symbols carry their own prefix (dnet_torch_disc_),
// so one process can load this library beside the reference's.
//
// One repair against the reference's copy: a process that exits without
// calling stop() no longer aborts.  There the two std::thread objects are
// still joinable when the statics are destroyed at exit, and a joinable
// std::thread's destructor calls std::terminate (SIGABRT, exit code 134).
// Here `g_exit_guard`, defined after every other static so that it is
// destroyed first, stops and joins both threads.
//
// Build (dnet_tpu_torch/utils/p2p.py does it at first use):
//   g++ -O2 -shared -fPIC -std=c++17 -o discovery.so discovery.cpp -lpthread

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <cstring>
#include <map>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>

namespace {

struct Peer {
  std::string json;  // last announcement payload
  std::string addr;  // sender IP
  double last_seen;  // monotonic seconds
};

std::atomic<bool> g_running{false};
std::thread g_announce_thread;
std::thread g_listen_thread;
std::mutex g_mutex;
std::map<std::string, Peer> g_peers;  // instance -> peer
std::string g_self_json;
std::string g_self_instance;
std::string g_target = "255.255.255.255";
int g_port = 58899;
int g_interval_ms = 1000;
double g_ttl_s = 5.0;
int g_listen_fd = -1;

double now_s() {
  return std::chrono::duration<double>(std::chrono::steady_clock::now().time_since_epoch()).count();
}

std::string extract_field(const std::string& json, const std::string& key) {
  // minimal JSON string-field extraction: "key" : "value" (ws-tolerant)
  std::string pat = "\"" + key + "\"";
  auto i = json.find(pat);
  if (i == std::string::npos) return "";
  i += pat.size();
  while (i < json.size() && (json[i] == ' ' || json[i] == ':')) ++i;
  if (i >= json.size() || json[i] != '"') return "";
  ++i;  // past the opening quote of the value
  auto j = json.find('"', i);
  if (j == std::string::npos) return "";
  return json.substr(i, j - i);
}

void announce_loop() {
  int fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (fd < 0) return;
  int yes = 1;
  setsockopt(fd, SOL_SOCKET, SO_BROADCAST, &yes, sizeof(yes));
  sockaddr_in dst{};
  dst.sin_family = AF_INET;
  dst.sin_port = htons(g_port);
  inet_pton(AF_INET, g_target.c_str(), &dst.sin_addr);
  while (g_running.load()) {
    std::string payload;
    {
      std::lock_guard<std::mutex> lock(g_mutex);
      payload = g_self_json;
    }
    sendto(fd, payload.data(), payload.size(), 0, reinterpret_cast<sockaddr*>(&dst), sizeof(dst));
    std::this_thread::sleep_for(std::chrono::milliseconds(g_interval_ms));
  }
  close(fd);
}

// Create + bind the listen socket synchronously so start() can report
// failures; the thread only consumes it.
int open_listen_socket() {
  int fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (fd < 0) return -1;
  int yes = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &yes, sizeof(yes));
#ifdef SO_REUSEPORT
  setsockopt(fd, SOL_SOCKET, SO_REUSEPORT, &yes, sizeof(yes));
#endif
  timeval tv{0, 200000};  // 200ms poll so stop() is prompt
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(g_port);
  addr.sin_addr.s_addr = INADDR_ANY;
  if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    close(fd);
    return -1;
  }
  return fd;
}

void listen_loop() {
  int fd = g_listen_fd;
  if (fd < 0) return;
  char buf[2048];
  while (g_running.load()) {
    sockaddr_in src{};
    socklen_t slen = sizeof(src);
    ssize_t n = recvfrom(fd, buf, sizeof(buf) - 1, 0, reinterpret_cast<sockaddr*>(&src), &slen);
    double t = now_s();
    if (n > 0) {
      buf[n] = '\0';
      std::string json(buf, static_cast<size_t>(n));
      std::string inst = extract_field(json, "instance");
      if (!inst.empty() && inst != g_self_instance) {
        char ip[INET_ADDRSTRLEN];
        inet_ntop(AF_INET, &src.sin_addr, ip, sizeof(ip));
        std::lock_guard<std::mutex> lock(g_mutex);
        g_peers[inst] = Peer{json, ip, t};
      }
    }
    // TTL eviction
    std::lock_guard<std::mutex> lock(g_mutex);
    for (auto it = g_peers.begin(); it != g_peers.end();) {
      if (t - it->second.last_seen > g_ttl_s)
        it = g_peers.erase(it);
      else
        ++it;
    }
  }
  close(fd);
  g_listen_fd = -1;
}

void stop_threads() {
  if (!g_running.exchange(false)) return;
  if (g_announce_thread.joinable()) g_announce_thread.join();
  if (g_listen_thread.joinable()) g_listen_thread.join();
  std::lock_guard<std::mutex> lock(g_mutex);
  g_peers.clear();
}

// Destroyed before every static above (reverse order of definition): a
// process that never called stop() joins the threads here instead of
// terminating in a joinable std::thread's destructor.
struct ExitGuard {
  ~ExitGuard() { stop_threads(); }
} g_exit_guard;

}  // namespace

extern "C" {

// Start announcing + listening. announcement_json must contain
// "instance":"...". Returns 0 on success, 1 when already running, -1 when
// the UDP port cannot be bound.
int dnet_torch_disc_start(const char* announcement_json, const char* target_addr, int udp_port,
                          int interval_ms, double ttl_s) {
  if (g_running.load()) return 1;
  {
    std::lock_guard<std::mutex> lock(g_mutex);
    g_self_json = announcement_json ? announcement_json : "";
    g_self_instance = extract_field(g_self_json, "instance");
    if (target_addr && target_addr[0]) g_target = target_addr;
    g_port = udp_port > 0 ? udp_port : 58899;
    g_interval_ms = interval_ms > 0 ? interval_ms : 1000;
    g_ttl_s = ttl_s > 0 ? ttl_s : 5.0;
    g_peers.clear();
  }
  g_listen_fd = open_listen_socket();
  if (g_listen_fd < 0) return -1;  // bind failed: report, don't run half-blind
  g_running.store(true);
  g_listen_thread = std::thread(listen_loop);
  g_announce_thread = std::thread(announce_loop);
  return 0;
}

// Update our announcement payload.
void dnet_torch_disc_update(const char* announcement_json) {
  std::lock_guard<std::mutex> lock(g_mutex);
  g_self_json = announcement_json ? announcement_json : g_self_json;
}

// Write the peer table as a JSON array into buf; returns bytes needed
// (call with buf=nullptr to size, like snprintf).
int dnet_torch_disc_peers(char* buf, int buflen) {
  std::ostringstream os;
  {
    std::lock_guard<std::mutex> lock(g_mutex);
    os << "[";
    bool first = true;
    for (auto& kv : g_peers) {
      if (!first) os << ",";
      first = false;
      // splice the sender address into the payload object
      const std::string& j = kv.second.json;
      if (!j.empty() && j.back() == '}') {
        os << j.substr(0, j.size() - 1) << ",\"addr\":\"" << kv.second.addr << "\"}";
      } else {
        os << j;
      }
    }
    os << "]";
  }
  std::string out = os.str();
  int needed = static_cast<int>(out.size()) + 1;
  if (buf && buflen >= needed) std::memcpy(buf, out.c_str(), needed);
  return needed;
}

void dnet_torch_disc_stop() { stop_threads(); }

}  // extern "C"
