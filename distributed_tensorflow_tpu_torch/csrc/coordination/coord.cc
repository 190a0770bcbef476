// dtf-tpu coordination service — C++ control plane (N1 replacement).
//
// The reference's distributed runtime is TensorFlow's C++ gRPC server
// (reference distributed.py:54: tf.train.Server starts MasterService +
// WorkerService).  On TPU the data plane (parameter pull / gradient push)
// is gone — XLA collectives over ICI carry tensors — so the native runtime
// that remains is a control plane over DCN:
//
//   - task registration with incarnation numbers (restart detection)
//   - named barriers across all live tasks (sync-mode step gating / init)
//   - heartbeat-based health tracking with optional step progress
//     (straggler & failure detection: a slow-but-alive task that falls more
//     than a caller-chosen lag behind the front-runner is excluded from the
//     live set — the reference SyncReplicasOptimizer's R-of-N
//     stale-gradient-drop semantics, distributed.py:92-100 — and rejoins
//     automatically once it catches up; feeds the R<N replica mask of
//     parallel/sync.py)
//   - a key-value store (variable-initialized flags, checkpoint locations,
//     async-published parameters, chief election state — what the
//     reference's Supervisor asked its master for, distributed.py:125),
//     optionally journaled to disk so a restarted coordination service
//     restores it (the durability role the reference's PS held implicitly)
//   - elastic membership: a monotonically increasing *membership epoch*
//     over the active task set.  Every task starts presumed-active (so
//     bring-up still gates on num_tasks); a lease expiry or an explicit
//     LEAVE shrinks the set and bumps the epoch, a re-REGISTER grows it
//     and bumps again.  Barriers release on the ACTIVE set, not on
//     num_tasks, so survivors stop stalling behind the dead — the
//     reference's async PS mode degraded this gracefully by construction
//     (surviving workers kept pushing gradients, distributed.py:102);
//     here the same property holds for the sync path via the R<N mask.
//     MEMBERS reads (epoch, active ids); RECONFIGURE forces a lease scan
//     (and can explicitly evict/admit a task — chief-driven resizes).
//   - observability plumbing: TIME exposes the server's epoch clock so
//     workers can estimate their clock offset (NTP-style midpoint) and
//     the exported cross-worker trace aligns; STATPUT/STATDUMP keep a
//     bounded per-task ring of opaque live-stats lines so a watcher
//     (tools/watch_run.py) can see a running cluster without touching
//     its files (docs/observability.md).
//   - coordinator HA (docs/fault_tolerance.md, "Coordinator HA"): a
//     control shard runs as *primary* or *standby*.  The primary appends
//     every state transition (KV sets, membership epochs, barrier
//     releases and their per-call nonces, registration, leadership-lease
//     renewals) to an in-memory replication log; standbys pull it over
//     the REPLJOIN (snapshot bootstrap) / REPLSTREAM (sequence-numbered,
//     checksummed batches) command pair and apply the records into the
//     same in-memory state machine.  A standby refuses mutating commands
//     with "NOTPRIMARY <leader>", and on losing contact with the primary
//     past the leadership lease the most-caught-up standby promotes
//     itself: coordinator *generation* bumps (persisted, and echoed in
//     every reply's 0x1f trailer so clients fence stale primaries),
//     barriers re-arm conservatively (replicated nonces re-answer
//     in-flight calls, never double-release), and every registered task
//     is presumed active until the first heartbeat round re-establishes
//     leases — the same presumed-active rule bring-up uses.
//
// Wire protocol: one TCP connection per request, single request line,
// single "OK ..." / "ERR ..." / "NONE" response line, plus a 0x1f-
// separated "gen=<g> role=<r>" trailer on every reply (the stale-primary
// fence).  Python binds via ctypes to the C ABI at the bottom (no
// pybind11 in the image).

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <fstream>
#include <map>
#include <mutex>
#include <set>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace dtf {

using Clock = std::chrono::steady_clock;

static double NowSeconds() {
  return std::chrono::duration<double>(Clock::now().time_since_epoch()).count();
}

// Checksum for the replication wire format (FNV-1a 32-bit, hex): cheap,
// dependency-free, and mirrored by the Python client's verifier.  It
// guards against torn/corrupted records on the stream, not adversaries.
static std::string Fnv1a(const std::string& s) {
  unsigned long h = 2166136261ul;
  for (unsigned char c : s) {
    h ^= c;
    h = (h * 16777619ul) & 0xFFFFFFFFul;
  }
  char buf[9];
  std::snprintf(buf, sizeof(buf), "%08lx", h);
  return std::string(buf);
}

// One replicated state transition (the journal-streamed record a standby
// applies).  Body grammar (single line, space-separated head):
//   K <key> <value>            KV set
//   R <task> <inc> <restarts> <registered>   registration transition
//   M <epoch> <id,id,...|->    membership epoch + active set
//   B <name> <generation>      barrier release (generation bump)
//   N <name> <task> <nonce>    per-call done-nonce (retry idempotency)
//   L 1                        leadership-lease renewal (liveness marker)
//   G <generation>             coordinator-generation bump (promotion)
struct ReplRecord {
  long seq = 0;
  std::string body;
};

// 0x1e frames replication/STATDUMP records and 0x1f the reply trailer:
// any CLIENT-supplied string that reaches a replicated record or a reply
// (KV keys and values, barrier names, stat payloads, advertised standby
// addresses) must exclude both, or one hostile/buggy caller corrupts
// every standby's stream and every reader's trailer parse — not just its
// own entry.
static bool HasReservedByte(const std::string& s) {
  return s.find('\x1e') != std::string::npos ||
         s.find('\x1f') != std::string::npos;
}

struct TaskInfo {
  long incarnation = 0;
  double last_heartbeat = 0.0;
  long last_step = -1;  // progress carried in heartbeats; -1 = never reported
  int restarts = 0;
  bool registered = false;
  bool evicted = false;  // lease expired (heartbeat silence) since last seen
};

// One live-stats ring entry (the STATPUT/STATDUMP protocol pair): an
// opaque payload line a worker published (compact JSON from the training
// loop), stamped with the server's receipt time so readers see staleness
// without trusting worker clocks.
struct StatEntry {
  double recv_time = 0.0;  // server steady-clock receipt time
  long seq = 0;            // server-global publish sequence number
  std::string payload;
};

struct BarrierState {
  std::set<int> arrived;
  long generation = 0;  // bumped when a barrier releases, so reuse works
  // Nonce each arrival presented, captured at arrival time so the
  // RELEASE path can mark every arrived call done in one place (and
  // stream the transitions to standbys) instead of each waiter marking
  // itself as it wakes — a primary dying mid-release then leaves no
  // waiter un-re-answerable on the promoted standby.
  std::map<int, long> arrival_nonce;
  // Last successfully-released call nonce per task: a transport-level
  // RETRY of an arrival whose barrier already released (response lost on
  // the wire) must return OK instead of entering the next generation.
  std::map<int, long> done_nonce;
};

// --- Client: connection-per-request (poll semantics match the reference's
// recovery_wait_secs=1 poll loop, distributed.py:111,125).  Defined ahead
// of the server because a standby's replication pull loop IS a client of
// its primary. ---

class CoordClient {
 public:
  CoordClient(std::string host, int port, int task_id)
      : host_(std::move(host)), port_(port), task_id_(task_id) {}

  int task_id() const { return task_id_; }

  bool Request(const std::string& line, std::string* response,
               double timeout_sec) {
    int fd = Connect(timeout_sec);
    if (fd < 0) return false;
    std::string msg = line + "\n";
    size_t off = 0;
    while (off < msg.size()) {
      ssize_t n = ::send(fd, msg.data() + off, msg.size() - off, MSG_NOSIGNAL);
      if (n <= 0) {
        ::close(fd);
        return false;
      }
      off += static_cast<size_t>(n);
    }
    response->clear();
    // Buffered response read (one response line per connection): the
    // byte-at-a-time version made large KVGET responses pay a syscall per
    // byte and time out at chunk scale.
    char buf[65536];
    bool done = false;
    while (!done) {
      ssize_t n = ::recv(fd, buf, sizeof(buf), 0);
      if (n <= 0) break;
      for (ssize_t i = 0; i < n; ++i) {
        if (buf[i] == '\n') {
          done = true;
          break;
        }
        response->push_back(buf[i]);
      }
    }
    ::close(fd);
    return !response->empty();
  }

 private:
  int Connect(double timeout_sec) {
    addrinfo hints{};
    hints.ai_family = AF_INET;
    hints.ai_socktype = SOCK_STREAM;
    addrinfo* res = nullptr;
    std::string port_str = std::to_string(port_);
    if (::getaddrinfo(host_.c_str(), port_str.c_str(), &hints, &res) != 0)
      return -1;
    int fd = ::socket(res->ai_family, res->ai_socktype, res->ai_protocol);
    if (fd >= 0) {
      timeval tv;
      tv.tv_sec = static_cast<long>(timeout_sec);
      tv.tv_usec = static_cast<long>((timeout_sec - tv.tv_sec) * 1e6);
      ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
      ::setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
      if (::connect(fd, res->ai_addr, res->ai_addrlen) != 0) {
        ::close(fd);
        fd = -1;
      }
    }
    ::freeaddrinfo(res);
    return fd;
  }

  std::string host_;
  int port_;
  int task_id_;
};

class CoordServer {
 public:
  CoordServer(int port, int num_tasks, double heartbeat_timeout,
              const std::string& persist_path = "", int shard = 0,
              int nshards = 1, const std::string& primary_addr = "",
              double lease_timeout = 2.0,
              const std::string& advertise_addr = "")
      : num_tasks_(num_tasks), heartbeat_timeout_(heartbeat_timeout),
        persist_path_(persist_path), shard_(shard),
        nshards_(nshards < 1 ? 1 : nshards), primary_addr_(primary_addr),
        lease_timeout_(lease_timeout > 0 ? lease_timeout : 2.0),
        advertise_addr_(advertise_addr) {
    // Shard identity is fixed BEFORE the accept thread below spawns, so
    // no client — not even one racing bring-up on a fixed port — can
    // ever read the default identity from a sharded instance.  Role and
    // generation likewise: a standby must never answer its first request
    // as a primary, and a restarted instance must come back with its
    // persisted generation (the split-brain fence), not generation 1.
    if (!persist_path_.empty()) LoadJournal();
    LoadMeta();
    is_primary_.store(primary_addr_.empty());
    gen_atomic_.store(generation_);
    listen_fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
    if (listen_fd_ < 0) return;
    int one = 1;
    ::setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (::bind(listen_fd_, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
        ::listen(listen_fd_, 128) < 0) {
      ::close(listen_fd_);
      listen_fd_ = -1;
      return;
    }
    socklen_t len = sizeof(addr);
    ::getsockname(listen_fd_, reinterpret_cast<sockaddr*>(&addr), &len);
    port_ = ntohs(addr.sin_port);
    running_.store(true);
    accept_thread_ = std::thread([this] { AcceptLoop(); });
    if (!primary_addr_.empty()) {
      // Standby: the replication pull loop starts immediately (snapshot
      // bootstrap, then sequential stream).  A primary starts its lease
      // ticker lazily, on the first REPLJOIN.
      std::lock_guard<std::mutex> lock(mu_);
      StartReplThreadLocked();
    }
  }

  ~CoordServer() { Stop(); }

  bool ok() const { return listen_fd_ >= 0; }
  int port() const { return port_; }

  // Shard identity of a sharded coordination plane (SHARDINFO).  Prefer
  // the constructor parameters (identity fixed before the accept thread
  // exists); this setter remains for callers holding an already-running
  // server.
  void SetShard(int shard, int nshards) {
    std::lock_guard<std::mutex> lock(mu_);
    shard_ = shard;
    nshards_ = nshards < 1 ? 1 : nshards;
  }

  void Stop() {
    bool expected = true;
    if (!running_.compare_exchange_strong(expected, false)) return;
    ::shutdown(listen_fd_, SHUT_RDWR);
    ::close(listen_fd_);
    {
      std::lock_guard<std::mutex> lock(mu_);
      shutting_down_ = true;
    }
    barrier_cv_.notify_all();
    if (accept_thread_.joinable()) accept_thread_.join();
    // Wait for detached handler threads (barrier waiters are woken above).
    {
      std::unique_lock<std::mutex> lock(workers_mu_);
      workers_done_cv_.wait(lock, [this] { return active_handlers_ == 0; });
    }
    // The replication thread applies records into the journal, so it must
    // be gone before the journal handle closes below.
    if (repl_thread_.joinable()) repl_thread_.join();
    std::lock_guard<std::mutex> lock(mu_);
    if (journal_ != nullptr) {
      std::fclose(journal_);
      journal_ = nullptr;
    }
  }

  void Join() {
    if (accept_thread_.joinable()) accept_thread_.join();
  }

 private:
  void AcceptLoop() {
    while (running_.load()) {
      int fd = ::accept(listen_fd_, nullptr, nullptr);
      if (fd < 0) {
        if (!running_.load()) break;
        continue;
      }
      {
        std::lock_guard<std::mutex> lock(workers_mu_);
        ++active_handlers_;
      }
      std::thread([this, fd] {
        Handle(fd);
        std::lock_guard<std::mutex> lock(workers_mu_);
        if (--active_handlers_ == 0) workers_done_cv_.notify_all();
      }).detach();
    }
  }

  static bool ReadLine(int fd, std::string* out) {
    // Buffered reads: the protocol is one request line per connection, so
    // bulk recv() is safe (no bytes follow the newline) and necessary —
    // byte-at-a-time recv costs a syscall per byte, which pushed
    // chunk-scale KV values (512 KiB parameter chunks from param_sync.py)
    // past the client's request timeout.
    out->clear();
    char buf[65536];
    while (true) {
      ssize_t n = ::recv(fd, buf, sizeof(buf), 0);
      if (n <= 0) return false;
      for (ssize_t i = 0; i < n; ++i) {
        if (buf[i] == '\n') return true;
        out->push_back(buf[i]);
      }
      // Request-line cap: KV values (async-published parameters arrive as
      // chunked entries from param_sync.py) stay well under this; the cap
      // only bounds a runaway/hostile client.
      if (out->size() > (8u << 20)) return false;
    }
  }

  static void WriteLine(int fd, const std::string& line) {
    std::string msg = line + "\n";
    size_t off = 0;
    while (off < msg.size()) {
      ssize_t n = ::send(fd, msg.data() + off, msg.size() - off, MSG_NOSIGNAL);
      if (n <= 0) return;
      off += static_cast<size_t>(n);
    }
  }

  // Every reply carries a 0x1f-separated generation/role trailer: the
  // stale-primary fence.  A client that has seen generation G treats any
  // reply stamped < G as coming from a dead generation's ghost and walks
  // its endpoint list instead of accepting the answer.  Reads atomics
  // only — callers hold mu_ at some call sites and not at others.
  void Reply(int fd, const std::string& line) {
    std::ostringstream os;
    os << line << '\x1f' << "gen=" << gen_atomic_.load() << " role="
       << (is_primary_.load() ? "primary" : "standby");
    WriteLine(fd, os.str());
  }

  void Handle(int fd) {
    // Bound the initial read so a client that connects and dies without
    // sending a request line can't pin this handler (and hang Stop()) forever.
    timeval tv{};
    tv.tv_sec = 30;
    ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    std::string line;
    if (ReadLine(fd, &line)) {
      std::istringstream iss(line);
      std::string cmd;
      iss >> cmd;
      // Optional generation guard: clients prefix requests with
      // "gen=<highest generation seen>" (lowercase: not a command).
      // A server BEHIND that generation is a stale ghost — a restarted
      // pre-promotion primary — and must refuse WITHOUT executing, or a
      // fenced reply would still leave a split-brain write applied.
      long client_gen = -1;
      if (cmd.rfind("gen=", 0) == 0) {
        client_gen = std::atol(cmd.c_str() + 4);
        cmd.clear();
        iss >> cmd;
      }
      // Fault injection (the CHAOS command below arms it): drop = close the
      // connection without a response (the client sees a transport failure
      // and exercises its retry/backoff path), delay = respond late.  CHAOS
      // itself is exempt so the harness can always disarm; the replication
      // pair is exempt too — CHAOS models the client-facing network, and a
      // drop window must not masquerade as a dead leader and trigger a
      // promotion mid-test.
      if (cmd != "CHAOS" && cmd != "REPLJOIN" && cmd != "REPLSTREAM") {
        bool drop = false;
        double delay = 0.0;
        {
          std::lock_guard<std::mutex> lock(mu_);
          if (chaos_drop_ > 0) {
            chaos_drop_--;
            drop = true;
          } else if (chaos_drop_until_ > NowSeconds()) {
            drop = true;
          } else if (chaos_delay_ > 0 && chaos_delay_secs_ > 0) {
            chaos_delay_--;
            delay = chaos_delay_secs_;
          }
        }
        if (drop) {
          ::close(fd);
          return;
        }
        if (delay > 0)
          std::this_thread::sleep_for(
              std::chrono::duration<double>(delay));
      }
      // Refusal gates.  (1) Generation fence: the caller has seen a
      // NEWER coordinator generation than this server holds — this
      // server is a dead generation's ghost and must not execute the
      // request (the no-split-brain-writes rule).  (2) Standby refusal:
      // a warm standby applies the primary's stream but serves no state
      // of its own — a mutating command accepted here would fork the
      // state machine, and even reads could hand out a stale membership
      // view.  In both cases identity/clock probes (INFO, SHARDINFO,
      // TIME) and the chaos harness stay answerable so an operator can
      // probe role, generation, and replication lag; everything else
      // redirects to the leader ("-" when this server cannot name one).
      bool diagnostic = cmd == "INFO" || cmd == "SHARDINFO" ||
                        cmd == "TIME" || cmd == "CHAOS";
      bool fenced = client_gen > gen_atomic_.load();
      if ((fenced || !is_primary_.load()) && !diagnostic) {
        std::string leader;
        {
          std::lock_guard<std::mutex> lock(mu_);
          leader = primary_addr_.empty() ? "-" : primary_addr_;
        }
        Reply(fd, "NOTPRIMARY " + leader);
        ::close(fd);
        return;
      }
      if (cmd == "REGISTER") {
        int task;
        long inc;
        iss >> task >> inc;
        Reply(fd, Register(task, inc));
      } else if (cmd == "HEARTBEAT") {
        int task;
        long step = -1;
        iss >> task;
        // Step is optional (liveness-only heartbeat); a failed extraction
        // writes 0 since C++11, so restore the "no report" sentinel.
        if (!(iss >> step)) step = -1;
        Heartbeat(task, step);
        Reply(fd, "OK");
      } else if (cmd == "BARRIER") {
        std::string name;
        int task;
        double timeout;
        long nonce = 0;  // optional per-call id (retry idempotency)
        iss >> name >> task >> timeout;
        if (!(iss >> nonce)) nonce = 0;
        if (HasReservedByte(name)) {
          // Barrier names land in replicated "B <name>"/"N <name>"
          // records — same framing-corruption blast radius as KV below.
          Reply(fd, "ERR barrier name contains a reserved framing byte");
        } else {
          Reply(fd, Barrier(name, task, timeout, nonce));
        }
      } else if (cmd == "KVSET") {
        std::string key, value;
        iss >> key;
        std::getline(iss, value);
        if (!value.empty() && value[0] == ' ') value.erase(0, 1);
        if (HasReservedByte(key) || HasReservedByte(value)) {
          // Key AND value both reach the replicated record and the
          // KVGET reply: either carrying a framing byte would corrupt
          // every standby's view (or every client's trailer parse), not
          // just this caller's entry.  KV publishers (param_sync) are
          // base64/ASCII by construction, so this only bounds a hostile
          // client.
          Reply(fd, "ERR kvset key/value contains a reserved framing "
                    "byte");
        } else {
          {
            std::lock_guard<std::mutex> lock(mu_);
            kv_[key] = value;
            AppendJournal(key, value);
            AppendReplLocked("K " + key + " " + value);
          }
          Reply(fd, "OK");
        }
      } else if (cmd == "KVGET") {
        std::string key;
        iss >> key;
        std::lock_guard<std::mutex> lock(mu_);
        auto it = kv_.find(key);
        Reply(fd, it == kv_.end() ? "NONE" : "OK " + it->second);
      } else if (cmd == "HEALTH") {
        long lag = 0;
        iss >> lag;  // optional: >0 also excludes slow-but-alive stragglers
        Reply(fd, Health(lag));
      } else if (cmd == "PROGRESS") {
        Reply(fd, Progress());
      } else if (cmd == "AGES") {
        Reply(fd, Ages());
      } else if (cmd == "TIME") {
        // Clock reference for NTP-style offset estimation: the server's
        // system (epoch) clock, high precision.  Workers bracket this
        // request with their own time.time() reads and take the midpoint;
        // the resulting offset aligns every worker's span timestamps onto
        // the server's timeline (tools/export_trace.py).
        std::ostringstream os;
        os.setf(std::ios::fixed);
        os.precision(6);
        os << "OK "
           << std::chrono::duration<double>(
                  std::chrono::system_clock::now().time_since_epoch())
                  .count();
        Reply(fd, os.str());
      } else if (cmd == "STATPUT") {
        // "STATPUT <task> <payload>": append an opaque stats line (the
        // rest of the line — compact JSON from the training loop) to the
        // task's bounded ring.  The ring is the live-watching data plane:
        // tools/watch_run.py polls STATDUMP against a running job without
        // touching its files.
        int task = -1;
        if (!(iss >> task)) task = -1;  // guarded: C++11 writes 0 on failure
        std::string payload;
        std::getline(iss, payload);
        if (!payload.empty() && payload[0] == ' ') payload.erase(0, 1);
        std::lock_guard<std::mutex> lock(mu_);
        if (task < 0 || task >= num_tasks_) {
          Reply(fd, "ERR statput needs a task id in range");
        } else if (HasReservedByte(payload)) {
          // The STATDUMP framing byte must be enforced HERE: a payload
          // carrying 0x1e would split into bogus entries for every
          // reader (and 0x1f would truncate their trailer parse), not
          // just the misbehaving publisher.
          Reply(fd, "ERR statput payload contains a reserved framing "
                    "byte");
        } else {
          auto& ring = stats_[task];
          StatEntry entry;
          entry.recv_time = NowSeconds();
          entry.seq = ++stat_seq_;
          entry.payload = payload;
          ring.push_back(std::move(entry));
          while (ring.size() > kStatRingCapacity) ring.pop_front();
          Reply(fd, "OK");
        }
      } else if (cmd == "STATDUMP") {
        // "STATDUMP [k]": the newest k entries (default 1) per task, one
        // response line.  Entries are separated by the ASCII record
        // separator (0x1e) — payloads are arbitrary single-line text, so
        // a printable delimiter could collide.  Each entry:
        // "<task> <age_seconds> <seq> <payload>".
        long k = 1;
        if (!(iss >> k)) k = 1;
        if (k < 1) k = 1;
        std::lock_guard<std::mutex> lock(mu_);
        double now = NowSeconds();
        std::ostringstream os;
        os.setf(std::ios::fixed);
        os.precision(3);
        os << "OK " << num_tasks_;
        for (const auto& kv : stats_) {
          const auto& ring = kv.second;
          size_t start =
              ring.size() > static_cast<size_t>(k) ? ring.size() - k : 0;
          for (size_t i = start; i < ring.size(); ++i) {
            os << '\x1e' << kv.first << ' ' << (now - ring[i].recv_time)
               << ' ' << ring[i].seq << ' ' << ring[i].payload;
          }
        }
        Reply(fd, os.str());
      } else if (cmd == "SHARDINFO") {
        // Sharded coordination plane (docs/param_exchange.md,
        // "Hierarchical exchange"): each instance of a multi-coordinator
        // deployment carries its shard identity so a router client (or an
        // operator's probe) can verify it is talking to the instance it
        // hashed a key to.  Identity is set at launch via the C ABI
        // (dtf_coord_server_set_shard, tools/coord_shard.py); a standalone
        // single-instance server reports shard=0 nshards=1.
        std::ostringstream os;
        std::lock_guard<std::mutex> lock(mu_);
        os << "OK shard=" << shard_ << " nshards=" << nshards_ << " role="
           << (is_primary_.load() ? "primary" : "standby");
        Reply(fd, os.str());
      } else if (cmd == "MEMBERS") {
        Reply(fd, Members());
      } else if (cmd == "RECONFIGURE") {
        // "RECONFIGURE" alone forces a lease scan and returns the
        // authoritative (epoch, active ids); "RECONFIGURE <task> <0|1>"
        // additionally evicts (0) or admits (1) the task explicitly — the
        // chief-driven resize path.  Guarded extraction: a failed read
        // must restore the "no argument" sentinel (C++11 writes 0 on
        // failure — which would silently evict task 0).
        int task = -1, want = -1;
        if (!(iss >> task)) task = -1;
        if (!(iss >> want)) want = -1;
        Reply(fd, Reconfigure(task, want));
      } else if (cmd == "LEAVE") {
        // Guarded extraction + bounds check: a malformed LEAVE must not
        // value-initialize task to 0 (C++11) and evict the chief, nor
        // create spurious task entries past num_tasks.
        int task = -1;
        if (!(iss >> task)) task = -1;
        std::lock_guard<std::mutex> lock(mu_);
        if (task < 0 || task >= num_tasks_) {
          Reply(fd, "ERR leave needs a task id in range");
        } else {
          TaskInfo& info = tasks_[task];
          info.registered = false;
          AppendReplLocked("R " + std::to_string(task) + " " +
                           std::to_string(info.incarnation) + " " +
                           std::to_string(info.restarts) + " 0");
          // A voluntary departure shrinks the active set immediately — no
          // lease wait — so surviving barriers/masks resize within one
          // membership poll instead of one heartbeat timeout.
          DeactivateLocked(task);
          Reply(fd, "OK");
        }
      } else if (cmd == "INFO") {
        std::ostringstream os;
        std::lock_guard<std::mutex> lock(mu_);
        UpdateMembershipLocked(NowSeconds());
        int reg = 0;
        for (auto& kv : tasks_)
          if (kv.second.registered) ++reg;
        os << "OK num_tasks=" << num_tasks_ << " registered=" << reg
           << " evictions=" << evictions_ << " epoch=" << membership_epoch_
           << " active=" << (num_tasks_ - static_cast<int>(inactive_.size()));
        // Coordinator-HA view (docs/fault_tolerance.md, "Coordinator
        // HA"): role, generation, standby count, and replication lag in
        // RECORDS — on a standby, how far behind the primary's last
        // known sequence it is; on a primary, how far behind the most
        // caught-up standby is (-1 = standby-less, the degraded state
        // tools/coord_shard.py --status and watch_run surface).
        long lag = -1;
        if (is_primary_.load()) {
          PruneStandbysLocked(NowSeconds());
          long best = -1;
          for (const auto& ack : standby_acks_)
            if (ack.second.acked > best) best = ack.second.acked;
          if (best >= 0) lag = repl_seq_ - best < 0 ? 0 : repl_seq_ - best;
        } else {
          lag = primary_latest_known_ - applied_seq_;
          if (lag < 0) lag = 0;
        }
        os << " role=" << (is_primary_.load() ? "primary" : "standby")
           << " generation=" << generation_
           << " standbys=" << standby_acks_.size() << " repl_lag=" << lag
           << " repl_applied="
           << (is_primary_.load() ? repl_seq_ : applied_seq_)
           << " repl_checksum_errors=" << repl_checksum_errors_;
        os.setf(std::ios::fixed);
        os.precision(3);
        os << " last_promotion_age_s="
           << (promoted_at_ < 0 ? -1.0 : NowSeconds() - promoted_at_);
        Reply(fd, os.str());
      } else if (cmd == "REPLJOIN") {
        // "REPLJOIN <addr>": a standby attaches (or re-attaches after
        // falling off the bounded log) and receives the snapshot
        // bootstrap — the whole state machine serialized as replication
        // records, checksummed like the stream, stamped with the current
        // sequence/generation and this standby's assigned id.  <addr> is
        // the standby's advertised endpoint ("-" = unadvertised), echoed
        // in REPLSTREAM acks so peers can size each other up at
        // promotion time.
        std::string addr;
        if (!(iss >> addr)) addr = "-";
        if (HasReservedByte(addr) || addr.find(',') != std::string::npos) {
          // The addr is echoed inside every acks= token (comma-joined,
          // 0x1e/0x1f-framed replies): a hostile one would corrupt every
          // peer's ack-table parse.
          Reply(fd, "ERR repljoin addr contains a reserved byte");
          ::close(fd);
          return;
        }
        std::lock_guard<std::mutex> lock(mu_);
        StartReplThreadLocked();  // the leadership-lease ticker
        PruneStandbysLocked(NowSeconds());
        int sid = next_standby_id_++;
        standby_acks_[sid] = {repl_seq_, addr, NowSeconds()};
        std::ostringstream os;
        os << "OK " << repl_seq_ << " " << generation_ << " "
           << lease_timeout_ << " " << sid << " " << AcksTokenLocked();
        for (const auto& body : SnapshotBodiesLocked())
          os << '\x1e' << Fnv1a(body) << ' ' << body;
        Reply(fd, os.str());
      } else if (cmd == "REPLSTREAM") {
        // "REPLSTREAM <standby_id> <from_seq>": the pull half of journal
        // streaming.  Returns every retained record in [from_seq, head]
        // (capped per batch; the standby loops until caught up), each as
        // "<seq> <fnv1a> <body>" behind an "OK <head_seq> <generation>
        // acks=<id>:<acked>:<addr>,..." header.  The from_seq doubles as
        // the standby's ack (everything below it was applied), which is
        // what "most-caught-up standby promotes" is decided on.
        int sid = -1;
        long from = 0;
        if (!(iss >> sid)) sid = -1;
        if (!(iss >> from)) from = 0;
        std::lock_guard<std::mutex> lock(mu_);
        auto it = standby_acks_.find(sid);
        if (sid < 0 || from < 1 || it == standby_acks_.end()) {
          // Unknown id (a primary restart forgot its standbys): the
          // standby must REPLJOIN again and re-bootstrap.
          Reply(fd, "ERR rejoin");
        } else if (!repl_log_.empty() && from < repl_log_.front().seq &&
                   from <= repl_seq_) {
          // Fell off the bounded log: a resync (snapshot) is cheaper
          // than replaying history we no longer hold.
          Reply(fd, "ERR resync");
        } else {
          it->second.acked = from - 1;
          it->second.last_seen = NowSeconds();
          PruneStandbysLocked(NowSeconds());
          std::ostringstream os;
          os << "OK " << repl_seq_ << " " << generation_ << " "
             << AcksTokenLocked();
          long sent = 0;
          for (const auto& rec : repl_log_) {
            if (rec.seq < from) continue;
            if (++sent > kReplBatch) break;
            os << '\x1e' << rec.seq << ' ' << Fnv1a(rec.body) << ' '
               << rec.body;
          }
          Reply(fd, os.str());
        }
      } else if (cmd == "CHAOS") {
        // Server-side fault injection (tests/ops): "CHAOS drop N" drops the
        // next N requests, "CHAOS dropfor SECS" drops everything in a time
        // window, "CHAOS delay SECS N" delays the next N responses,
        // "CHAOS off" disarms.
        std::string sub;
        iss >> sub;
        std::lock_guard<std::mutex> lock(mu_);
        if (sub == "drop") {
          long n = 0;
          iss >> n;
          chaos_drop_ = n;
          Reply(fd, "OK");
        } else if (sub == "dropfor") {
          double secs = 0;
          iss >> secs;
          chaos_drop_until_ = NowSeconds() + secs;
          Reply(fd, "OK");
        } else if (sub == "delay") {
          double secs = 0;
          long n = 0;
          iss >> secs >> n;
          chaos_delay_secs_ = secs;
          chaos_delay_ = n;
          Reply(fd, "OK");
        } else if (sub == "off") {
          chaos_drop_ = 0;
          chaos_drop_until_ = 0.0;
          chaos_delay_ = 0;
          chaos_delay_secs_ = 0.0;
          Reply(fd, "OK");
        } else {
          Reply(fd, "ERR unknown chaos directive");
        }
      } else {
        Reply(fd, "ERR unknown command");
      }
    }
    ::close(fd);
  }

  // --- Elastic membership (all callers hold mu_) -----------------------
  //
  // Active set = [0, num_tasks) minus inactive_.  Tasks start
  // presumed-active so bring-up still waits for the full cluster; only an
  // observed departure (lease expiry, LEAVE, explicit RECONFIGURE evict)
  // shrinks the set, and only REGISTER / RECONFIGURE admit grows it back.

  // Remove a task from the active set; bumps the epoch and wakes barrier
  // waiters (the departed member may have been the last arrival missing).
  void DeactivateLocked(int task) {
    if (task < 0 || task >= num_tasks_) return;
    if (inactive_.insert(task).second) {
      membership_epoch_++;
      AppendReplLocked(MembershipBodyLocked());
      barrier_cv_.notify_all();
    }
  }

  void ActivateLocked(int task) {
    if (task < 0 || task >= num_tasks_) return;
    if (inactive_.erase(task) > 0) {
      membership_epoch_++;
      AppendReplLocked(MembershipBodyLocked());
      barrier_cv_.notify_all();
    }
  }

  // The replicated membership transition: epoch + the full active set
  // ("-" when everyone is out) — small, and self-contained enough that a
  // standby can apply it without having seen the shrink/grow history.
  std::string MembershipBodyLocked() const {
    std::ostringstream os;
    os << "M " << membership_epoch_ << " ";
    bool any = false;
    for (int t = 0; t < num_tasks_; ++t) {
      if (inactive_.count(t)) continue;
      if (any) os << ',';
      os << t;
      any = true;
    }
    if (!any) os << '-';
    return os.str();
  }

  // Lease scan: any registered task silent past heartbeat_timeout_ loses
  // its lease — counted as an eviction (once per silence episode, the
  // INFO/telemetry signal) and removed from the active set (the epoch
  // signal).  Run lazily from every membership-sensitive entry point
  // (HEALTH, MEMBERS, RECONFIGURE, INFO, barrier arrivals and the sliced
  // barrier wait), so expiry is noticed within a barrier wait slice.
  void UpdateMembershipLocked(double now) {
    if (heartbeat_timeout_ <= 0) return;
    // A standby observes no heartbeats (workers talk to the primary), so
    // a local lease scan would evict everyone off stale timestamps and
    // fork the replicated membership: the stream is its only authority.
    if (!is_primary_.load()) return;
    for (auto& kv : tasks_) {
      TaskInfo& info = kv.second;
      if (!info.registered) continue;
      if ((now - info.last_heartbeat) < heartbeat_timeout_) continue;
      if (!info.evicted) {
        info.evicted = true;
        evictions_++;
      }
      DeactivateLocked(kv.first);
    }
  }

  // True when every active task has arrived (arrivals from inactive tasks
  // ride along; an empty active set releases trivially — the degenerate
  // everyone-evicted case must not deadlock the last caller).
  bool BarrierCompleteLocked(const BarrierState& b) const {
    for (int t = 0; t < num_tasks_; ++t) {
      if (inactive_.count(t)) continue;
      if (!b.arrived.count(t)) return false;
    }
    return true;
  }

  std::string Members() {
    std::lock_guard<std::mutex> lock(mu_);
    UpdateMembershipLocked(NowSeconds());
    return MembersLocked();
  }

  std::string MembersLocked() const {
    std::ostringstream os;
    os << "OK " << membership_epoch_;
    for (int t = 0; t < num_tasks_; ++t)
      if (!inactive_.count(t)) os << " " << t;
    return os.str();
  }

  std::string Reconfigure(int task, int want) {
    std::lock_guard<std::mutex> lock(mu_);
    UpdateMembershipLocked(NowSeconds());
    if (task >= 0) {
      if (task >= num_tasks_) return "ERR task out of range";
      if (want == 0)
        DeactivateLocked(task);
      else if (want == 1)
        ActivateLocked(task);
      else
        return "ERR reconfigure wants 0 (evict) or 1 (admit)";
    }
    return MembersLocked();
  }

  std::string Register(int task, long incarnation) {
    std::lock_guard<std::mutex> lock(mu_);
    TaskInfo& info = tasks_[task];
    double now = NowSeconds();
    // Lease expiry: a registered task that went a full heartbeat_timeout
    // without beating has lost its lease.  Re-registration after expiry is
    // a REJOIN even with the same incarnation (a frozen process thawing
    // out), so the caller learns it must restore-and-re-enter rather than
    // assume continuity.
    bool lease_expired = info.registered && heartbeat_timeout_ > 0 &&
                         (now - info.last_heartbeat) >= heartbeat_timeout_;
    if (info.registered && (info.incarnation != incarnation || lease_expired)) {
      // Same task id, new incarnation (a restarted worker re-joining — the
      // reference's Supervisor re-entry path, distributed.py:125, §3.4) or
      // the same incarnation returning past its lease.
      info.restarts++;
    }
    if (info.incarnation != incarnation || lease_expired) {
      // Forget the old life's progress so the rejoiner isn't instantly
      // classed a straggler before its first report.
      info.last_step = -1;
    }
    info.incarnation = incarnation;
    info.registered = true;
    info.evicted = false;
    info.last_heartbeat = now;
    AppendReplLocked("R " + std::to_string(task) + " " +
                     std::to_string(incarnation) + " " +
                     std::to_string(info.restarts) + " 1");
    // Registration is the (only) grow path: a rejoining incarnation —
    // restart, thawed freeze, or a worker returning from LEAVE — re-enters
    // the active set and bumps the membership epoch.
    ActivateLocked(task);
    std::ostringstream os;
    os << "OK " << num_tasks_ << " restarts=" << info.restarts
       << " epoch=" << membership_epoch_;
    return os.str();
  }

  void Heartbeat(int task, long step) {
    std::lock_guard<std::mutex> lock(mu_);
    TaskInfo& info = tasks_[task];
    info.last_heartbeat = NowSeconds();
    info.evicted = false;  // a live beat restores the lease
    if (step >= 0 && step > info.last_step) info.last_step = step;
  }

  // Release a complete barrier (caller holds mu_): every arrived call's
  // nonce is marked done — and streamed to standbys — BEFORE the
  // generation bumps, so a promoted standby re-answers any in-flight
  // arrival whose OK died with the old primary instead of entering it
  // into the next generation (the never-double-release rule).
  void ReleaseBarrierLocked(const std::string& name, BarrierState& b) {
    for (int t : b.arrived) {
      auto it = b.arrival_nonce.find(t);
      if (it != b.arrival_nonce.end() && it->second != 0) {
        b.done_nonce[t] = it->second;
        AppendReplLocked("N " + name + " " + std::to_string(t) + " " +
                         std::to_string(it->second));
      }
    }
    b.arrived.clear();
    b.arrival_nonce.clear();
    b.generation++;
    AppendReplLocked("B " + name + " " + std::to_string(b.generation));
    barrier_cv_.notify_all();
  }

  std::string Barrier(const std::string& name, int task, double timeout,
                      long nonce) {
    std::unique_lock<std::mutex> lock(mu_);
    BarrierState& b = barriers_[name];
    if (nonce != 0) {
      auto it = b.done_nonce.find(task);
      if (it != b.done_nonce.end() && it->second == nonce) {
        // This exact call already crossed the barrier; its OK was lost on
        // the wire and the client retried.  Re-answer, don't re-arrive.
        return "OK";
      }
    }
    long my_generation = b.generation;
    b.arrived.insert(task);
    if (nonce != 0) b.arrival_nonce[task] = nonce;
    tasks_[task].last_heartbeat = NowSeconds();
    // Elastic release: the barrier gates on the ACTIVE set, not num_tasks —
    // run the lease scan first so an arrival right after a worker died
    // releases the survivors immediately instead of stalling to timeout.
    UpdateMembershipLocked(NowSeconds());
    if (BarrierCompleteLocked(b)) {
      ReleaseBarrierLocked(name, b);
      return "OK";
    }
    auto deadline = Clock::now() + std::chrono::duration<double>(timeout);
    // Sliced waits: wake every fraction of the heartbeat timeout to re-run
    // the lease scan, so a member dying MID-wait releases the survivors
    // within one slice (the elastic no-stall property) rather than only
    // when its lease expiry happens to coincide with an arrival.
    double slice = heartbeat_timeout_ > 0 ? heartbeat_timeout_ / 4.0 : 0.25;
    if (slice > 1.0) slice = 1.0;
    if (slice < 0.02) slice = 0.02;
    while (true) {
      // Re-look-up: rehashing is impossible (std::map), but the barrier may
      // have been released and re-armed while we waited.
      BarrierState& cur = barriers_[name];
      if (cur.generation != my_generation) {
        cur.done_nonce[task] = nonce;
        return "OK";
      }
      if (shutting_down_) return "ERR shutdown";
      UpdateMembershipLocked(NowSeconds());
      if (BarrierCompleteLocked(cur)) {
        // A departure completed the barrier for the survivors; this waiter
        // performs the release on everyone's behalf.
        ReleaseBarrierLocked(name, cur);
        return "OK";
      }
      auto wake = Clock::now() + std::chrono::duration<double>(slice);
      bool final_slice = wake >= deadline;
      if (final_slice) wake = deadline;
#ifdef DTF_SANITIZER_TIMEDWAIT
      // Sanitizer-build compat (set by the Makefile tsan/asan targets,
      // docs/static_analysis.md): libstdc++ maps steady-clock waits
      // onto pthread_cond_clockwait, which gcc-10's libtsan does not
      // intercept — the checked build then reports phantom double-
      // locks/races because it never sees the unlock inside the wait.
      // The system-clock overload maps onto the intercepted
      // pthread_cond_timedwait.  Checked builds only: a wall-clock
      // step during a wait can mis-size that one slice by the step
      // size, so production keeps the steady-clock wait below.
      auto wake_point =
          std::chrono::system_clock::now() +
          std::chrono::duration_cast<std::chrono::microseconds>(
              wake - Clock::now());
#else
      auto wake_point = wake;
#endif
      if (barrier_cv_.wait_until(lock, wake_point) ==
              std::cv_status::timeout &&
          final_slice) {
        BarrierState& cur2 = barriers_[name];
        if (cur2.generation != my_generation) {
          cur2.done_nonce[task] = nonce;
          return "OK";
        }
        UpdateMembershipLocked(NowSeconds());
        if (BarrierCompleteLocked(cur2)) {
          ReleaseBarrierLocked(name, cur2);
          return "OK";
        }
        cur2.arrived.erase(task);
        cur2.arrival_nonce.erase(task);
        return "ERR barrier_timeout";
      }
    }
  }

  std::string Health(long lag) {
    std::lock_guard<std::mutex> lock(mu_);
    double now = NowSeconds();
    // Lease scan first: eviction counting (and the membership-epoch shrink)
    // lives in UpdateMembershipLocked — one detection path for HEALTH,
    // MEMBERS, barriers, and INFO alike.
    UpdateMembershipLocked(now);
    // Front-runner step among live, progress-reporting tasks: the straggler
    // criterion ("more than `lag` steps behind") is relative to it, so the
    // fastest live task is never excluded and the set can't go empty.
    long max_step = -1;
    for (int t = 0; t < num_tasks_; ++t) {
      auto it = tasks_.find(t);
      if (it == tasks_.end() || !it->second.registered) continue;
      if ((now - it->second.last_heartbeat) >= heartbeat_timeout_) continue;
      if (it->second.last_step > max_step) max_step = it->second.last_step;
    }
    std::ostringstream os;
    os << "OK";
    for (int t = 0; t < num_tasks_; ++t) {
      auto it = tasks_.find(t);
      bool alive = it != tasks_.end() && it->second.registered &&
                   (now - it->second.last_heartbeat) < heartbeat_timeout_;
      if (alive && lag > 0 && it->second.last_step >= 0 &&
          max_step - it->second.last_step > lag) {
        // Slow-but-heartbeating straggler: excluded from the live set until
        // it catches back up (reference R-of-N drop, distributed.py:97-100).
        alive = false;
      }
      os << " " << (alive ? 1 : 0);
    }
    return os.str();
  }

  std::string Progress() {
    std::lock_guard<std::mutex> lock(mu_);
    std::ostringstream os;
    os << "OK";
    for (int t = 0; t < num_tasks_; ++t) {
      auto it = tasks_.find(t);
      os << " " << (it == tasks_.end() ? -1 : it->second.last_step);
    }
    return os.str();
  }

  // Seconds since each task's last heartbeat (-1 = never heartbeated /
  // not registered) — the raw signal behind Health()'s boolean, exported
  // so the telemetry stream can show a straggler *approaching* the
  // timeout instead of only the eventual liveness flip.
  std::string Ages() {
    std::lock_guard<std::mutex> lock(mu_);
    double now = NowSeconds();
    std::ostringstream os;
    os << "OK";
    os.setf(std::ios::fixed);
    os.precision(3);
    for (int t = 0; t < num_tasks_; ++t) {
      auto it = tasks_.find(t);
      bool seen = it != tasks_.end() && it->second.registered &&
                  it->second.last_heartbeat > 0.0;
      if (seen)
        os << " " << (now - it->second.last_heartbeat);
      else
        os << " -1";
    }
    return os.str();
  }

  // --- Coordinator HA: replication log, standby pull loop, promotion ---

  // Append one state transition to the bounded in-memory replication log
  // (caller holds mu_).  The log is the standby's journal stream; a
  // standby that falls off the retained window re-bootstraps via
  // REPLJOIN, so the cap bounds memory, not correctness.
  void AppendReplLocked(const std::string& body) {
    ReplRecord rec;
    rec.seq = ++repl_seq_;
    rec.body = body;
    repl_log_.push_back(std::move(rec));
    while (repl_log_.size() > kReplLogCapacity) repl_log_.pop_front();
  }

  // The whole state machine as replication-record bodies (caller holds
  // mu_): the REPLJOIN snapshot bootstrap.  Applying these onto an empty
  // standby reproduces exactly the state an incremental stream would
  // have built.
  std::vector<std::string> SnapshotBodiesLocked() const {
    std::vector<std::string> out;
    for (const auto& e : kv_) out.push_back("K " + e.first + " " + e.second);
    for (const auto& t : tasks_)
      out.push_back("R " + std::to_string(t.first) + " " +
                    std::to_string(t.second.incarnation) + " " +
                    std::to_string(t.second.restarts) + " " +
                    (t.second.registered ? "1" : "0"));
    out.push_back(MembershipBodyLocked());
    for (const auto& b : barriers_) {
      out.push_back("B " + b.first + " " +
                    std::to_string(b.second.generation));
      for (const auto& n : b.second.done_nonce)
        out.push_back("N " + b.first + " " + std::to_string(n.first) +
                      " " + std::to_string(n.second));
    }
    out.push_back("G " + std::to_string(generation_));
    return out;
  }

  void StartReplThreadLocked() {
    if (repl_thread_started_) return;
    repl_thread_started_ = true;
    repl_thread_ = std::thread([this] { ReplLoop(); });
  }

  // The ack table as the "acks=<id>:<acked>:<addr>,..." wire token
  // (caller holds mu_), shared by the REPLJOIN and REPLSTREAM reply
  // heads: a standby that only ever bootstrapped (its primary died
  // before its first incremental poll) must STILL know its peers, or
  // at promotion time it has nobody to defer to / adopt and races its
  // sibling into a same-generation split brain.
  std::string AcksTokenLocked() const {
    std::ostringstream os;
    os << "acks=";
    bool first = true;
    for (const auto& ack : standby_acks_) {
      if (!first) os << ',';
      first = false;
      os << ack.first << ':' << ack.second.acked << ':'
         << (ack.second.addr.empty() ? "-" : ack.second.addr);
    }
    return os.str();
  }

  // Drop standbys that stopped polling (caller holds mu_): 2x the lease
  // is several poll intervals past dead.  Keeps INFO's standby count —
  // and the DEGRADED(no standby) operator signal derived from it —
  // honest across standby churn, and bounds the ack table against a
  // flapping standby re-bootstrapping under fresh ids.
  void PruneStandbysLocked(double now) {
    for (auto it = standby_acks_.begin(); it != standby_acks_.end();) {
      if (now - it->second.last_seen > 2.0 * lease_timeout_)
        it = standby_acks_.erase(it);
      else
        ++it;
    }
  }

  double ReplIntervalSeconds() const {
    double interval = lease_timeout_ / 4.0;
    if (interval > 0.5) interval = 0.5;
    if (interval < 0.02) interval = 0.02;
    return interval;
  }

  static bool ParseAddr(const std::string& addr, std::string* host,
                        int* port) {
    auto pos = addr.rfind(':');
    if (pos == std::string::npos) return false;
    *host = addr.substr(0, pos);
    *port = std::atoi(addr.c_str() + pos + 1);
    return !host->empty() && *port > 0;
  }

  // One thread serves both roles: a primary ticks its leadership lease
  // into the stream (standbys read fresh records as proof of leadership)
  // and prunes dead standbys off its ack table; a standby pulls,
  // applies, and watches the lease — switching to the primary behavior
  // the moment it promotes.  The pull target is re-read every iteration:
  // adopting an already-promoted peer re-points primary_addr_ mid-loop.
  void ReplLoop() {
    {
      // Peers reach this standby at its advertised address (echoed in
      // REPLSTREAM ack tables; what a deferring peer probes at
      // promotion time).  Default: loopback + our bound port — right
      // whenever the standby set shares a host; cross-host operators
      // pass an explicit advertise address.
      std::lock_guard<std::mutex> lock(mu_);
      if (advertise_addr_.empty())
        advertise_addr_ = "127.0.0.1:" + std::to_string(port_);
    }
    while (running_.load()) {
      if (is_primary_.load()) {
        std::lock_guard<std::mutex> lock(mu_);
        AppendReplLocked("L 1");
        PruneStandbysLocked(NowSeconds());
      } else {
        PullOnce();
        MaybePromote();
      }
      auto until = Clock::now() +
                   std::chrono::duration<double>(ReplIntervalSeconds());
      while (running_.load() && Clock::now() < until)
        std::this_thread::sleep_for(std::chrono::milliseconds(10));
    }
  }

  // Strip the generation/role reply trailer off a raw wire response.
  static std::string StripTrailer(const std::string& resp) {
    auto cut = resp.rfind('\x1f');
    if (cut == std::string::npos) return resp;
    return resp.substr(0, cut);
  }

  double ReplRequestTimeout() const {
    double t = lease_timeout_ / 2.0;
    if (t > 1.0) t = 1.0;
    if (t < 0.2) t = 0.2;
    return t;
  }

  void PullOnce() {
    double req_timeout = ReplRequestTimeout();
    int my_id;
    long from;
    std::string target, advertise;
    {
      std::lock_guard<std::mutex> lock(mu_);
      my_id = standby_id_;
      from = applied_seq_ + 1;
      target = primary_addr_;
      advertise = advertise_addr_;
    }
    std::string host;
    int pport = 0;
    if (!ParseAddr(target, &host, &pport)) return;
    dtf::CoordClient client(host, pport, /*task_id=*/-1);
    std::string resp;
    if (my_id < 0) {
      if (!client.Request("REPLJOIN " + advertise, &resp, req_timeout))
        return;
      ApplySnapshot(StripTrailer(resp));
      return;
    }
    std::ostringstream req;
    req << "REPLSTREAM " << my_id << " " << from;
    if (!client.Request(req.str(), &resp, req_timeout)) return;
    resp = StripTrailer(resp);
    if (resp.rfind("ERR", 0) == 0) {
      // "ERR rejoin" (primary restarted, forgot us) or "ERR resync" (we
      // fell off the bounded log): re-bootstrap next poll.  The primary
      // answered, so its lease stands.
      std::lock_guard<std::mutex> lock(mu_);
      standby_id_ = -1;
      last_primary_contact_ = NowSeconds();
      return;
    }
    if (resp.rfind("OK", 0) != 0) return;
    ApplyStream(resp);
  }

  // Parse the remaining "acks=..." token(s) off a reply head stream.
  static std::map<int, std::pair<long, std::string>> ParseAcks(
      std::istringstream& head) {
    std::map<int, std::pair<long, std::string>> peers;
    std::string tok;
    while (head >> tok) {
      if (tok.rfind("acks=", 0) != 0) continue;
      std::istringstream acks(tok.substr(5));
      std::string ent;
      while (std::getline(acks, ent, ',')) {
        // "<id>:<acked>:<addr>" — the addr is what MaybePromote probes
        // to adopt an already-promoted peer.
        auto c1 = ent.find(':');
        if (c1 == std::string::npos) continue;
        auto c2 = ent.find(':', c1 + 1);
        std::string addr =
            c2 == std::string::npos ? "-" : ent.substr(c2 + 1);
        peers[std::atoi(ent.substr(0, c1).c_str())] = {
            std::atol(ent.c_str() + c1 + 1), addr};
      }
    }
    return peers;
  }

  void ApplySnapshot(const std::string& resp) {
    if (resp.rfind("OK", 0) != 0) return;
    std::vector<std::string> chunks = SplitRecords(resp);
    std::istringstream head(chunks[0]);
    std::string ok;
    long snap_seq = 0, gen = 0;
    double lease = 0.0;
    int sid = -1;
    if (!(head >> ok >> snap_seq >> gen >> lease >> sid)) return;
    std::map<int, std::pair<long, std::string>> peers = ParseAcks(head);
    peers.erase(sid);
    std::lock_guard<std::mutex> lock(mu_);
    kv_.clear();
    tasks_.clear();
    barriers_.clear();
    inactive_.clear();
    for (size_t i = 1; i < chunks.size(); ++i) {
      auto sp = chunks[i].find(' ');
      if (sp == std::string::npos) continue;
      std::string checksum = chunks[i].substr(0, sp);
      std::string body = chunks[i].substr(sp + 1);
      if (Fnv1a(body) != checksum) {
        // A torn snapshot must not half-apply: reset to a blank,
        // provably-unbootstrapped state (applied_seq_ 0 + standby_id_
        // -1 keep MaybePromote from ever serving the partial copy) and
        // re-REPLJOIN next poll.  The primary DID answer, so its lease
        // stands — without the contact refresh, a primary death inside
        // this window would promote a standby missing registrations and
        // barrier done-nonces.
        repl_checksum_errors_++;
        kv_.clear();
        tasks_.clear();
        barriers_.clear();
        inactive_.clear();
        applied_seq_ = 0;
        primary_latest_known_ = 0;
        standby_id_ = -1;
        last_primary_contact_ = NowSeconds();
        return;
      }
      ApplyRecordLocked(body);
    }
    standby_id_ = sid;
    applied_seq_ = snap_seq;
    primary_latest_known_ = snap_seq;
    generation_ = gen > generation_ ? gen : generation_;
    gen_atomic_.store(generation_);
    peer_acks_ = std::move(peers);
    promote_defers_ = 0;
    last_primary_contact_ = NowSeconds();
  }

  void ApplyStream(const std::string& resp) {
    std::vector<std::string> chunks = SplitRecords(resp);
    std::istringstream head(chunks[0]);
    std::string ok;
    long latest = 0, gen = 0;
    if (!(head >> ok >> latest >> gen)) return;
    std::map<int, std::pair<long, std::string>> peers = ParseAcks(head);
    std::lock_guard<std::mutex> lock(mu_);
    peers.erase(standby_id_);
    for (size_t i = 1; i < chunks.size(); ++i) {
      std::istringstream rec(chunks[i]);
      long seq = 0;
      std::string checksum;
      if (!(rec >> seq >> checksum)) continue;
      std::string body;
      std::getline(rec, body);
      if (!body.empty() && body[0] == ' ') body.erase(0, 1);
      if (Fnv1a(body) != checksum) {
        // Corrupt record: stop the batch here; the next poll re-requests
        // from applied_seq_ + 1 (sequence numbering makes this safe).
        repl_checksum_errors_++;
        break;
      }
      if (seq != applied_seq_ + 1) {
        // A gap means the log was trimmed between header and read — the
        // resync path will catch us up from a snapshot.
        if (seq > applied_seq_ + 1) standby_id_ = -1;
        continue;
      }
      ApplyRecordLocked(body);
      applied_seq_ = seq;
    }
    primary_latest_known_ = latest > applied_seq_ ? latest : applied_seq_;
    if (gen > generation_) {
      generation_ = gen;
      gen_atomic_.store(generation_);
    }
    peer_acks_ = std::move(peers);
    promote_defers_ = 0;
    last_primary_contact_ = NowSeconds();
  }

  static std::vector<std::string> SplitRecords(const std::string& resp) {
    std::vector<std::string> out;
    size_t start = 0;
    while (true) {
      size_t sep = resp.find('\x1e', start);
      out.push_back(resp.substr(start, sep == std::string::npos
                                           ? std::string::npos
                                           : sep - start));
      if (sep == std::string::npos) break;
      start = sep + 1;
    }
    return out;
  }

  // Apply one replicated state transition (caller holds mu_) — the same
  // state machine the primary's handlers mutate, driven from the stream.
  void ApplyRecordLocked(const std::string& body) {
    std::istringstream is(body);
    std::string type;
    if (!(is >> type)) return;
    if (type == "K") {
      std::string key, value;
      is >> key;
      std::getline(is, value);
      if (!value.empty() && value[0] == ' ') value.erase(0, 1);
      kv_[key] = value;
      AppendJournal(key, value);
    } else if (type == "R") {
      int task = -1, reg = 0;
      long inc = 0;
      int restarts = 0;
      if (!(is >> task >> inc >> restarts >> reg)) return;
      if (task < 0) return;
      TaskInfo& info = tasks_[task];
      info.incarnation = inc;
      info.restarts = restarts;
      info.registered = reg != 0;
      info.last_step = -1;
      info.evicted = false;
    } else if (type == "M") {
      long epoch = 0;
      std::string ids;
      if (!(is >> epoch >> ids)) return;
      membership_epoch_ = epoch;
      inactive_.clear();
      std::set<int> active;
      if (ids != "-") {
        std::istringstream ids_in(ids);
        std::string one;
        while (std::getline(ids_in, one, ','))
          active.insert(std::atoi(one.c_str()));
      }
      for (int t = 0; t < num_tasks_; ++t)
        if (!active.count(t)) inactive_.insert(t);
    } else if (type == "B") {
      std::string name;
      long gen = 0;
      if (!(is >> name >> gen)) return;
      BarrierState& b = barriers_[name];
      b.generation = gen;
      b.arrived.clear();
      b.arrival_nonce.clear();
    } else if (type == "N") {
      std::string name;
      int task = -1;
      long nonce = 0;
      if (!(is >> name >> task >> nonce)) return;
      barriers_[name].done_nonce[task] = nonce;
    } else if (type == "G") {
      long gen = 0;
      if (!(is >> gen)) return;
      if (gen > generation_) {
        generation_ = gen;
        gen_atomic_.store(generation_);
      }
    }
    // "L" (lease renewal) carries no state — receiving it IS the signal.
  }

  void MaybePromote() {
    double now = NowSeconds();
    std::vector<std::pair<int, std::pair<long, std::string>>> peers;
    long my_gen;
    {
      std::lock_guard<std::mutex> lock(mu_);
      if (is_primary_.load()) return;
      // Never promote before a successful bootstrap: a standby that
      // never reached its primary has no state to serve ("the primary
      // was never there" is a config error, not a failover), and one
      // mid-resync (torn snapshot, trimmed log, forgotten id) holds an
      // INCOMPLETE copy it must never serve either.
      if (last_primary_contact_ <= 0.0) return;
      if (now - last_primary_contact_ < lease_timeout_) return;
      if (standby_id_ < 0) return;
      my_gen = generation_;
      for (const auto& p : peer_acks_)
        if (p.first != standby_id_) peers.push_back(p);
    }
    // Probe peers' advertised endpoints (outside mu_: this is network
    // I/O) for one that ALREADY promoted: adopting it as the new
    // primary — re-pointing the pull loop and re-bootstrapping — is the
    // only split-brain-free outcome with multiple standbys.  Without
    // this, a surviving standby keeps polling the dead address forever
    // and eventually promotes a SECOND primary at the SAME generation,
    // which no fence can tell apart.  Peers still answering as standbys
    // go into the alive set the deferral below consults.
    std::set<int> alive;
    for (const auto& p : peers) {
      if (!running_.load()) return;
      const std::string& addr = p.second.second;
      if (addr.empty() || addr == "-") continue;
      std::string host;
      int pport = 0;
      if (!ParseAddr(addr, &host, &pport)) continue;
      dtf::CoordClient probe(host, pport, /*task_id=*/-1);
      std::string resp;
      if (!probe.Request("INFO", &resp, ReplRequestTimeout())) continue;
      if (resp.find(" role=primary") == std::string::npos) {
        alive.insert(p.first);
        continue;
      }
      long peer_gen = 0;
      auto gen_at = resp.find(" generation=");
      if (gen_at != std::string::npos)
        peer_gen = std::atol(resp.c_str() + gen_at + 12);
      if (peer_gen < my_gen) continue;  // a stale ghost, not a leader
      std::lock_guard<std::mutex> lock(mu_);
      if (is_primary_.load()) return;
      primary_addr_ = addr;
      standby_id_ = -1;  // REPLJOIN the new leader next poll
      promote_defers_ = 0;
      last_primary_contact_ = NowSeconds();
      std::fprintf(stderr,
                   "coord: standby re-attached to promoted peer %s "
                   "(generation %ld)\n",
                   addr.c_str(), peer_gen);
      return;
    }
    std::lock_guard<std::mutex> lock(mu_);
    if (is_primary_.load() || standby_id_ < 0) return;
    if (now - last_primary_contact_ < lease_timeout_) return;
    // Deferral rules, in takeover-priority order:
    // - a peer AHEAD of us should take the promotion (most-caught-up
    //   rule) — deferred to a BOUNDED number of windows, because that
    //   peer may have died with the primary;
    // - a LIVE peer with a lower standby id wins ties — deferred to
    //   WITHOUT a bound, because "live" was just probed above: either
    //   it promotes within its own bounded windows (we adopt it next
    //   probe) or it dies (drops out of the alive set and we stop
    //   deferring).  The asymmetry is what keeps two survivors from
    //   exhausting identical bounds in the same window and promoting
    //   side by side.
    for (const auto& p : peer_acks_) {
      if (p.first == standby_id_) continue;
      if (p.second.first > applied_seq_ && promote_defers_ < 3) {
        promote_defers_++;
        last_primary_contact_ = now;
        return;
      }
      if (p.first < standby_id_ && alive.count(p.first)) {
        last_primary_contact_ = now;
        return;
      }
    }
    PromoteLocked(now);
  }

  // Lease expired: this standby takes over (caller holds mu_).  The
  // coordinator generation bumps and persists (the split-brain fence: a
  // restarted old primary keeps its dead generation and every reply it
  // sends is fenced client-side); barriers keep their replicated
  // generations and done-nonces (in-flight arrivals are re-answered,
  // never double-released); every registered task is PRESUMED ACTIVE
  // with a fresh lease, exactly like bring-up, until the first heartbeat
  // round re-establishes real leases.
  void PromoteLocked(double now) {
    is_primary_.store(true);
    generation_++;
    gen_atomic_.store(generation_);
    promoted_at_ = now;
    PersistMetaLocked();
    AppendReplLocked("G " + std::to_string(generation_));
    for (auto& t : tasks_) {
      if (!t.second.registered) continue;
      t.second.last_heartbeat = now;
      t.second.evicted = false;
    }
    if (!inactive_.empty()) {
      inactive_.clear();
      membership_epoch_++;
      AppendReplLocked(MembershipBodyLocked());
    }
    standby_acks_.clear();
    next_standby_id_ = 0;
    barrier_cv_.notify_all();
    std::fprintf(stderr,
                 "coord: standby promoted to primary (generation %ld, "
                 "%ld records applied)\n",
                 generation_, applied_seq_);
  }

  // Generation persistence (<persist_path>.meta, atomic rename): the
  // half of the leadership lease that must survive a restart so a
  // revived process can never serve an older generation than it already
  // held.  In-memory only when no persist path is configured.
  void LoadMeta() {
    if (persist_path_.empty()) return;
    std::ifstream in(persist_path_ + ".meta");
    std::string key;
    long value = 0;
    while (in >> key >> value)
      if (key == "generation" && value > generation_) generation_ = value;
  }

  void PersistMetaLocked() {
    if (persist_path_.empty()) return;
    std::string tmp = persist_path_ + ".meta.tmp";
    std::FILE* f = std::fopen(tmp.c_str(), "w");
    if (f == nullptr) return;
    std::fprintf(f, "generation %ld\n", generation_);
    std::fflush(f);
    std::fclose(f);
    std::rename(tmp.c_str(), (persist_path_ + ".meta").c_str());
  }

  // --- KV persistence: "key value" lines, last-wins replay, compacted on
  // load.  Only the KV store persists (tasks/barriers are ephemeral by
  // design: incarnations re-register, barriers re-form).
  void LoadJournal() {
    std::ifstream in(persist_path_);
    if (in) {
      std::string line;
      while (std::getline(in, line)) {
        if (line.empty()) continue;
        auto sp = line.find(' ');
        if (sp == std::string::npos)
          kv_[line] = "";
        else
          kv_[line.substr(0, sp)] = line.substr(sp + 1);
      }
      in.close();
    }
    // Compact: rewrite current state, then append from there.
    std::string tmp = persist_path_ + ".tmp";
    std::FILE* f = std::fopen(tmp.c_str(), "w");
    if (f == nullptr) return;
    for (const auto& e : kv_)
      std::fprintf(f, "%s %s\n", e.first.c_str(), e.second.c_str());
    std::fflush(f);
    std::fclose(f);
    std::rename(tmp.c_str(), persist_path_.c_str());
    journal_ = std::fopen(persist_path_.c_str(), "a");
    journal_bytes_ = 0;
    for (const auto& e : kv_)
      journal_bytes_ += e.first.size() + e.second.size() + 2;
  }

  void AppendJournal(const std::string& key, const std::string& value) {
    // Caller holds mu_.
    if (journal_ == nullptr) return;
    std::fprintf(journal_, "%s %s\n", key.c_str(), value.c_str());
    std::fflush(journal_);
    journal_bytes_ += key.size() + value.size() + 2;
    // Steady-state compaction: async param publishes rewrite the same keys
    // every sync period, so the append-only journal dwarfs the live map.
    // Rewrite once appends exceed ~4x the live size (1 MiB floor so tiny
    // stores never compact) — the threshold scales with the store, so a
    // large live KV does not trigger a full rewrite on every set.
    size_t live = 0;
    for (const auto& e : kv_) live += e.first.size() + e.second.size() + 2;
    if (journal_bytes_ > (1u << 20) + 4 * live) {
      std::fclose(journal_);
      journal_ = nullptr;
      std::string tmp = persist_path_ + ".tmp";
      std::FILE* f = std::fopen(tmp.c_str(), "w");
      if (f != nullptr) {
        for (const auto& e : kv_)
          std::fprintf(f, "%s %s\n", e.first.c_str(), e.second.c_str());
        std::fflush(f);
        std::fclose(f);
        std::rename(tmp.c_str(), persist_path_.c_str());
      }
      journal_ = std::fopen(persist_path_.c_str(), "a");
      journal_bytes_ = live;
    }
  }

  int listen_fd_ = -1;
  int port_ = 0;
  int num_tasks_;
  double heartbeat_timeout_;
  std::string persist_path_;
  std::FILE* journal_ = nullptr;
  size_t journal_bytes_ = 0;
  std::atomic<bool> running_{false};
  bool shutting_down_ = false;
  std::thread accept_thread_;
  std::mutex workers_mu_;
  std::condition_variable workers_done_cv_;
  int active_handlers_ = 0;

  std::mutex mu_;
  std::condition_variable barrier_cv_;
  std::map<int, TaskInfo> tasks_;
  std::map<std::string, BarrierState> barriers_;
  std::map<std::string, std::string> kv_;
  // Live per-task stats rings (STATPUT/STATDUMP).  Bounded so a fast
  // publisher costs constant server memory; 128 entries at ~100 B each is
  // ~13 KiB/task — the watcher only ever wants the newest few.
  static constexpr size_t kStatRingCapacity = 128;
  std::map<int, std::deque<StatEntry>> stats_;
  long stat_seq_ = 0;
  long evictions_ = 0;  // expired leases observed (INFO evictions=N)
  // Elastic membership: active set = [0, num_tasks) minus inactive_; the
  // epoch increments on every shrink/grow (MEMBERS/RECONFIGURE expose it).
  std::set<int> inactive_;
  long membership_epoch_ = 1;
  // Shard identity (SHARDINFO): which instance of a sharded coordination
  // plane this server is.  Guarded by mu_ like the rest of the state.
  int shard_ = 0;
  int nshards_ = 1;
  // Armed fault injection (the CHAOS command); all guarded by mu_.
  long chaos_drop_ = 0;           // drop the next N requests
  double chaos_drop_until_ = 0.0; // drop everything until this time
  double chaos_delay_secs_ = 0.0; // delay the next chaos_delay_ responses
  long chaos_delay_ = 0;

  // --- Coordinator HA state (docs/fault_tolerance.md, "Coordinator HA").
  // primary_addr_/lease_timeout_ are fixed at construction; is_primary_
  // and gen_atomic_ are atomics because the reply trailer reads them
  // without mu_; everything else is guarded by mu_.
  std::string primary_addr_;      // standby: the leader we stream from
  double lease_timeout_ = 2.0;    // leadership lease (promotion trigger)
  std::atomic<bool> is_primary_{true};
  std::atomic<long> gen_atomic_{1};
  long generation_ = 1;           // coordinator generation (fences ghosts)
  static constexpr size_t kReplLogCapacity = 8192;
  static constexpr long kReplBatch = 512;  // records per REPLSTREAM reply
  std::deque<ReplRecord> repl_log_;
  long repl_seq_ = 0;             // head sequence number (primary side)
  // Primary side: per-standby replication bookkeeping.  last_seen drives
  // pruning: a standby that stops polling past 2x the lease is dead and
  // must stop counting toward INFO's standby count, or the operator's
  // DEGRADED(no standby) signal could never fire again after churn (and
  // a flapping standby's re-bootstraps would grow the map unboundedly).
  struct StandbyAck {
    long acked = 0;
    std::string addr;             // advertised endpoint ("-" = a tap)
    double last_seen = 0.0;
  };
  std::map<int, StandbyAck> standby_acks_;
  int next_standby_id_ = 0;
  // Standby side: stream cursor + the promotion evidence.
  int standby_id_ = -1;           // -1 = needs REPLJOIN (bootstrap/resync)
  long applied_seq_ = 0;
  long primary_latest_known_ = 0;
  double last_primary_contact_ = 0.0;  // 0 = never bootstrapped
  // Peer standbys as of the last REPLSTREAM ack table: id -> (acked
  // sequence, advertised addr).  The addrs are what a deferring standby
  // probes to ADOPT an already-promoted peer instead of promoting a
  // second primary beside it.
  std::map<int, std::pair<long, std::string>> peer_acks_;
  std::string advertise_addr_;    // how peers reach THIS standby
  int promote_defers_ = 0;
  double promoted_at_ = -1.0;     // NowSeconds() of promotion (-1 = never)
  long repl_checksum_errors_ = 0;
  std::thread repl_thread_;
  bool repl_thread_started_ = false;
};

}  // namespace dtf

// ---------------- C ABI for ctypes ----------------


extern "C" {

void* dtf_coord_server_start(int port, int num_tasks, double heartbeat_timeout,
                             const char* persist_path) {
  auto* s = new dtf::CoordServer(
      port, num_tasks, heartbeat_timeout,
      persist_path == nullptr ? std::string() : std::string(persist_path));
  if (!s->ok()) {
    delete s;
    return nullptr;
  }
  return s;
}

// Sharded-plane variant: shard identity is part of construction, so it is
// visible before the accept thread takes its first connection (a racing
// bring-up probe on a fixed port must never read the default identity).
// A separate symbol, not new parameters on dtf_coord_server_start, so a
// prebuilt DTF_COORD_BIN older than the sharded plane keeps loading.
void* dtf_coord_server_start2(int port, int num_tasks,
                              double heartbeat_timeout,
                              const char* persist_path, int shard,
                              int nshards) {
  auto* s = new dtf::CoordServer(
      port, num_tasks, heartbeat_timeout,
      persist_path == nullptr ? std::string() : std::string(persist_path),
      shard, nshards);
  if (!s->ok()) {
    delete s;
    return nullptr;
  }
  return s;
}

// Coordinator-HA variant (docs/fault_tolerance.md, "Coordinator HA"):
// a non-empty primary_addr ("host:port") starts this instance as a warm
// STANDBY of that control shard — it snapshot-bootstraps via REPLJOIN,
// applies the REPLSTREAM journal stream, refuses mutating commands with
// NOTPRIMARY, and self-promotes (generation bump) when the leadership
// lease (lease_timeout seconds without primary contact) expires.  A
// separate symbol so prebuilt DTF_COORD_BIN libraries older than the HA
// plane keep loading.
void* dtf_coord_server_start3(int port, int num_tasks,
                              double heartbeat_timeout,
                              const char* persist_path, int shard,
                              int nshards, const char* primary_addr,
                              double lease_timeout,
                              const char* advertise_addr) {
  auto* s = new dtf::CoordServer(
      port, num_tasks, heartbeat_timeout,
      persist_path == nullptr ? std::string() : std::string(persist_path),
      shard, nshards,
      primary_addr == nullptr ? std::string() : std::string(primary_addr),
      lease_timeout,
      advertise_addr == nullptr ? std::string()
                                : std::string(advertise_addr));
  if (!s->ok()) {
    delete s;
    return nullptr;
  }
  return s;
}

int dtf_coord_server_port(void* server) {
  return static_cast<dtf::CoordServer*>(server)->port();
}

void dtf_coord_server_stop(void* server) {
  auto* s = static_cast<dtf::CoordServer*>(server);
  s->Stop();
  delete s;
}

void dtf_coord_server_join(void* server) {
  static_cast<dtf::CoordServer*>(server)->Join();
}

// Shard identity for a sharded coordination plane (SHARDINFO replies
// "OK shard=<s> nshards=<n>").  Call right after start, before clients
// are pointed at the instance.
void dtf_coord_server_set_shard(void* server, int shard, int nshards) {
  static_cast<dtf::CoordServer*>(server)->SetShard(shard, nshards);
}

void* dtf_coord_client_create(const char* host, int port, int task_id) {
  return new dtf::CoordClient(host, port, task_id);
}

void dtf_coord_client_destroy(void* client) {
  delete static_cast<dtf::CoordClient*>(client);
}

// Returns response length (>=0) on success, -1 on transport failure.
// Response is NUL-terminated into out (truncated to outlen-1).
int dtf_coord_client_request(void* client, const char* line, char* out,
                             int outlen, double timeout_sec) {
  auto* c = static_cast<dtf::CoordClient*>(client);
  std::string resp;
  if (!c->Request(line, &resp, timeout_sec)) return -1;
  int n = static_cast<int>(resp.size());
  int copy = n < outlen - 1 ? n : outlen - 1;
  std::memcpy(out, resp.data(), static_cast<size_t>(copy));
  out[copy] = '\0';
  return n;
}

}  // extern "C"
