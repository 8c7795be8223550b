// Native ingestion event loop: packed wire votes -> dense device phases.
//
// The C++ twin of bridge/ingest.py's VoteBatcher — the "host driver
// concurrency" slot of SURVEY.md §2.7 ("C++ event loop feeding device
// batches; double-buffered host<->device queues").  The reference's
// analogue is the one-vote-at-a-time ConsensusExecutor::execute loop
// (reference consensus_executor.rs:24-49); here the loop is a batch
// pipeline over a packed 96-byte wire record:
//
//   off  0  u32 instance        off 20  u8  typ (0 prevote, 1 precommit)
//   off  4  u32 validator       off 21  u8  flags (bit0: has_value)
//   off  8  i64 height          off 22  u16 (pad)
//   off 16  i32 round           off 24  i64 value
//                               off 32  u8  signature[64]
//
// Tick protocol (mirrors VoteBatcher exactly; differential-tested in
// tests/test_torch_native_ingest.py against the JAX package's copy):
//   sync(base_round, heights)      adopt device window/heights; held
//                                  future-round votes re-enter
//   push(records, n)               parse + screen + window discipline
//   n = stage()                    snapshot pending for verification
//   fill_verify_inputs(...)        -> pub/sig/sha-block arrays for the
//                                  batched CUDA verify kernel
//   apply_verdicts(ok[n])          drop failed lanes (or pass ok=NULL
//                                  for the unsigned path)
//   emit()                         dedup + layer + intern + scatter
//                                  into the CURRENT emit buffer set
//   phase(k, ...)                  pointers into that set (valid until
//                                  the emit after next: double buffer)
//
// Past (rotated-out) rounds fall back to the host tally — the exact
// RoundVotes core (per-value buckets, dedup, equivocation evidence) —
// and late +2/3 precommit-value quorums surface through drain_events
// because commit-from-any-round (reference state_machine.rs:211) must
// fire no matter how late the quorum assembles.

#include <algorithm>
#include <array>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <tuple>
#include <unordered_map>
#include <vector>

#include "core.hpp"

namespace {

constexpr int64_t kNil = -1;          // value encoding of a nil vote
constexpr int32_t kVotedNil = -1;     // device slot encoding (tally.py)
constexpr int64_t kMaxValue = (int64_t{1} << 31);  // value ids are 31-bit
// rounds domain top (types.py MAX_ROUND / core.hpp kMaxRound): the
// screen must bound rounds exactly like the numpy bridge or the two
// ingest paths diverge on hostile wide rounds
constexpr int64_t kMaxRound = (int64_t{1} << 31) - 1;
constexpr int kRecSize = 96;

// reserve that preserves geometric growth (an exact-size reserve on
// every batch would force a full realloc+copy per call: O(n^2))
template <typename T>
inline void grow_reserve(std::vector<T>& v, size_t add) {
  size_t want = v.size() + add;
  if (v.capacity() < want)
    v.reserve(std::max(want, v.capacity() * 2));
}

struct Rec {
  int64_t instance, validator, height, round, typ, value;
  uint8_t sig[64];
  uint64_t arrival;                   // global order for stable layering
};

struct Phase {
  int32_t round, typ;
  int64_t n_votes;
  std::vector<int32_t> slots;        // [I*V]
  std::vector<uint8_t> mask;         // [I*V]
};

struct EmitSet {
  // phases are pooled: `used` counts the live prefix, buffers behind
  // it keep their capacity across emits (no realloc churn)
  std::vector<Phase> phases;
  size_t used = 0;

  Phase& acquire(int64_t cells) {
    if (used == phases.size()) phases.emplace_back();
    Phase& ph = phases[used++];
    ph.n_votes = 0;
    ph.slots.assign(static_cast<size_t>(cells), kVotedNil);
    ph.mask.assign(static_cast<size_t>(cells), 0);
    return ph;
  }
};

struct Loop {
  int64_t I, V, W, S;
  bool require_verify;
  std::vector<int64_t> heights, base_round;   // [I]
  std::vector<uint8_t> pubkeys;               // [V*32]
  std::vector<int64_t> powers;                // [V]
  int64_t total_power;

  using Block = std::shared_ptr<std::vector<Rec>>;

  std::vector<Rec> pending;      // parsed + malformed-screened; height
                                 // and window screens run at stage()
                                 // against the LAST-SYNCED state, the
                                 // same moment VoteBatcher screens in
                                 // build_phases — push-time screening
                                 // would drop early next-height votes
                                 // the numpy path keeps
  std::vector<Rec> staged;       // snapshot awaiting verdicts
  std::vector<Block> ready;      // verified (or unsigned), pre-emit —
                                 // BLOCKS shared with the log: the
                                 // verdict stage moves whole batches
                                 // instead of copying per record (the
                                 // per-rec copy was the pipeline's
                                 // bandwidth bottleneck)
  std::vector<Rec> held;         // future-round hold-back (capped:
                                 // filled before signature check, so
                                 // unbounded growth would be an
                                 // unauthenticated memory-exhaustion
                                 // vector)
  int64_t held_cap = 0;
  std::vector<Block> log;        // verified votes (slashable evidence)

  // per-instance value-id -> dense slot (bridge/value_table.py
  // SlotMap).  Flat [I*S] arrays, linear-scanned: S is tiny (4-8), so
  // 2-3 cached compares beat a hash lookup — this is the per-vote hot
  // path of the fast lane.  slot k of instance i = slot_vals[i*S + k].
  std::vector<int64_t> slot_vals;     // [I*S]
  std::vector<int32_t> slot_count;    // [I]

  // host fallback tallies for past/overflow votes, keyed
  // (instance, height, round) — never mixes heights into one quorum
  std::map<std::tuple<int64_t, int64_t, int64_t>, agnes::RoundVotes>
      host_tally;
  // (instance, height, round, value) late precommit-value quorums
  std::vector<std::array<int64_t, 4>> events;

  uint64_t arrivals = 0;
  int64_t rejected_malformed = 0;
  int64_t dropped_stale_height = 0;
  int64_t rejected_signature = 0;
  int64_t overflow_votes = 0;
  int64_t dropped_held_overflow = 0;

  EmitSet sets[2];
  int cur = 0;

  // epoch-stamped cell occupancy: fast-path detection without a
  // per-emit O(I*V) clear
  std::vector<uint64_t> cell_epoch;
  uint64_t epoch = 0;

  // --- async ingestion (the actual host-driver concurrency of
  // SURVEY.md §2.7: a worker thread parses + malformed-screens inbound
  // wire buffers while the tick thread drives verify/emit/device).
  // `mu` guards exactly the state both threads touch: inbox, pending,
  // arrivals, rejected_malformed, and the lifecycle flags.  Everything
  // else (staged/held/slots/log/emit sets) is tick-thread-only.
  std::mutex mu;
  std::condition_variable cv_in;    // worker: work available / stop
  std::condition_variable cv_idle;  // flush(): queue drained
  std::deque<std::vector<uint8_t>> inbox;
  int64_t inbox_recs = 0;           // records queued, not yet in pending
  bool worker_busy = false;
  bool stop_worker = false;
  std::thread worker;               // spawned lazily on first push_async

  ~Loop() {
    if (worker.joinable()) {
      {
        std::lock_guard<std::mutex> g(mu);
        stop_worker = true;
      }
      cv_in.notify_all();
      worker.join();
    }
  }
};

void parse_rec(const uint8_t* p, Rec* r);            // defined below
inline bool rec_malformed(const Loop* L, const Rec& r);

// worker thread: pop one wire buffer at a time, parse + screen OFF the
// lock, then append to pending in FIFO order (arrival stamps are
// assigned under the lock, so layering order == push_async order,
// matching the synchronous path exactly)
void ingest_worker_main(Loop* L) {
  std::unique_lock<std::mutex> lk(L->mu);
  for (;;) {
    L->cv_in.wait(lk, [&] { return L->stop_worker || !L->inbox.empty(); });
    if (L->inbox.empty()) return;    // stop requested and drained
    std::vector<uint8_t> buf = std::move(L->inbox.front());
    L->inbox.pop_front();
    L->worker_busy = true;
    lk.unlock();

    const int64_t n = static_cast<int64_t>(buf.size()) / kRecSize;
    std::vector<Rec> local;
    local.reserve(static_cast<size_t>(n));
    int64_t malformed = 0;
    for (int64_t k = 0; k < n; ++k) {
      Rec r;
      parse_rec(buf.data() + k * kRecSize, &r);
      if (rec_malformed(L, r))       // dims are immutable: lock-free read
        ++malformed;
      else
        local.push_back(r);
    }

    lk.lock();
    grow_reserve(L->pending, local.size());
    for (Rec& r : local) {
      r.arrival = L->arrivals++;
      L->pending.push_back(r);
    }
    L->rejected_malformed += malformed;
    L->inbox_recs -= n;
    L->worker_busy = false;
    if (L->inbox.empty()) L->cv_idle.notify_all();
  }
}

void host_tally_add(Loop* L, const Rec& r) {
  auto key = std::make_tuple(r.instance, r.height, r.round);
  auto it = L->host_tally.find(key);
  if (it == L->host_tally.end())
    it = L->host_tally
             .emplace(std::piecewise_construct,
                      std::forward_as_tuple(key),
                      std::forward_as_tuple(r.height, r.round,
                                            L->total_power))
             .first;
  int64_t tv = agnes::kNoValue;
  int64_t w = (r.validator >= 0 && r.validator < L->V)
                  ? L->powers[static_cast<size_t>(r.validator)]
                  : 1;
  auto typ = r.typ == 0 ? agnes::VoteType::Prevote
                        : agnes::VoteType::Precommit;
  auto kind = it->second.add_vote(typ, r.validator,
                                  r.value == kNil ? agnes::kNoValue
                                                  : r.value,
                                  w, &tv);
  if (r.typ == 1 && kind == agnes::ThreshKind::Value)
    L->events.push_back({r.instance, r.height, r.round, tv});
}

// slot interning in ascending (instance, value) order — the same order
// VoteBatcher._intern_slots assigns, so slot numbering matches exactly
inline int32_t slot_lookup(const Loop* L, int64_t inst, int64_t value) {
  const int64_t* base = L->slot_vals.data() + inst * L->S;
  int32_t n = L->slot_count[static_cast<size_t>(inst)];
  for (int32_t k = 0; k < n; ++k)
    if (base[k] == value) return k;
  return kVotedNil;                    // not interned
}

inline int32_t slot_for(Loop* L, int64_t inst, int64_t value) {
  int32_t s = slot_lookup(L, inst, value);
  if (s != kVotedNil) return s;
  int32_t& n = L->slot_count[static_cast<size_t>(inst)];
  if (n >= L->S) return kVotedNil - 1;
  L->slot_vals[static_cast<size_t>(inst * L->S + n)] = value;
  return n++;
}

// wire-record layout (the module-top comment) in ONE place: push,
// evidence, and the snapshot export/import all share these
void pack_rec(const Rec& r, uint8_t* p) {
  std::memset(p, 0, kRecSize);
  uint32_t u32 = static_cast<uint32_t>(r.instance);
  std::memcpy(p + 0, &u32, 4);
  u32 = static_cast<uint32_t>(r.validator);
  std::memcpy(p + 4, &u32, 4);
  std::memcpy(p + 8, &r.height, 8);
  int32_t i32 = static_cast<int32_t>(r.round);
  std::memcpy(p + 16, &i32, 4);
  p[20] = static_cast<uint8_t>(r.typ);
  p[21] = r.value == kNil ? 0 : 1;
  int64_t v = r.value == kNil ? 0 : r.value;
  std::memcpy(p + 24, &v, 8);
  std::memcpy(p + 32, r.sig, 64);
}

void parse_rec(const uint8_t* p, Rec* r) {
  uint32_t u32;
  std::memcpy(&u32, p + 0, 4);  r->instance = u32;
  std::memcpy(&u32, p + 4, 4);  r->validator = u32;
  std::memcpy(&r->height, p + 8, 8);
  int32_t i32;
  std::memcpy(&i32, p + 16, 4); r->round = i32;
  r->typ = p[20];
  bool has_value = (p[21] & 1) != 0;
  std::memcpy(&r->value, p + 24, 8);
  if (!has_value || r->value < 0) r->value = kNil;
  std::memcpy(r->sig, p + 32, 64);
}

// the malformed screen every ingress shares (push AND snapshot import
// — a corrupted snapshot must not inject records push would reject)
inline bool rec_malformed(const Loop* L, const Rec& r) {
  return r.instance >= L->I || r.validator >= L->V || r.round < 0 ||
         r.round > kMaxRound || r.typ > 1 || r.value >= kMaxValue;
}

}  // namespace

extern "C" {

void* ag_ing_new(int64_t I, int64_t V, int64_t W, int64_t S,
                 const uint8_t* pubkeys /* V*32 or NULL */,
                 const int64_t* powers /* V or NULL */) {
  // hostile-dimension screen: this is a raw C ABI, so negative or huge
  // dims must fail closed (NULL) instead of throwing bad_alloc across
  // the extern-C boundary or overflowing the int64 cell math below
  constexpr int64_t kDimMax = int64_t{1} << 31;
  constexpr int64_t kCellMax = int64_t{1} << 40;
  if (I <= 0 || V <= 0 || W <= 0 || S <= 0 || I > kDimMax ||
      V > kDimMax || W > (int64_t{1} << 20) || S > (int64_t{1} << 20) ||
      I > kCellMax / V || I > kCellMax / S)
    return nullptr;
  try {
    auto L = std::make_unique<Loop>();
    L->I = I; L->V = V; L->W = W; L->S = S;
    L->require_verify = pubkeys != nullptr;
    // cap the pre-verification hold-back queue at a couple of full
    // [I, V] ticks (the legitimate future-round working set), floor
    // 64k — see ag_ing_set_held_cap
    L->held_cap = std::max<int64_t>(65536, 2 * I * V);
    L->heights.assign(static_cast<size_t>(I), 0);
    L->base_round.assign(static_cast<size_t>(I), 0);
    if (pubkeys)
      L->pubkeys.assign(pubkeys, pubkeys + V * 32);
    if (powers)
      L->powers.assign(powers, powers + V);
    else
      L->powers.assign(static_cast<size_t>(V), 1);
    L->total_power = 0;
    for (int64_t p : L->powers)
      L->total_power = agnes::sat_add(L->total_power, p);
    L->slot_vals.assign(static_cast<size_t>(I * S), agnes::kNoValue);
    L->slot_count.assign(static_cast<size_t>(I), 0);
    return L.release();
  } catch (...) {
    return nullptr;
  }
}

// bound on the pre-verify future-round hold-back queue (records);
// cap <= 0 resets to the construction default
void ag_ing_set_held_cap(void* h, int64_t cap) {
  auto* L = static_cast<Loop*>(h);
  L->held_cap = cap > 0 ? cap : std::max<int64_t>(65536, 2 * L->I * L->V);
}

// the enforced cap (single source of truth: wrappers/snapshots read
// it back instead of re-deriving the default formula)
int64_t ag_ing_get_held_cap(void* h) {
  return static_cast<Loop*>(h)->held_cap;
}

// validator-set epoch (reference validators.rs:38-46 intent, SURVEY
// §2.6 "re-uploaded on set changes"): swap the pubkey table and/or
// voting powers AT A HEIGHT BOUNDARY — call right after the sync that
// advanced heights (which already dropped the old heights' host
// tallies), from the tick thread, with no staged lanes in flight.
// NULL leaves a table unchanged; a power of 0 models removal (the
// device shape is static).  Returns 0, or -1 for a pubkey upload on a
// loop constructed unsigned (verification policy is construction-time).
int64_t ag_ing_set_validators(void* h, const uint8_t* pubkeys,
                              const int64_t* powers) {
  auto* L = static_cast<Loop*>(h);
  if (pubkeys) {
    if (!L->require_verify) return -1;
    L->pubkeys.assign(pubkeys, pubkeys + L->V * 32);
  }
  if (powers) {
    L->powers.assign(powers, powers + L->V);
    L->total_power = 0;
    for (int64_t p : L->powers)
      L->total_power = agnes::sat_add(L->total_power, p);
  }
  return 0;
}

void ag_ing_free(void* h) { delete static_cast<Loop*>(h); }

// adopt device window bases + heights; held votes re-enter pending
// unconditionally (the next stage() re-screens them against the new
// state — exactly when VoteBatcher.sync_device + build_phases do)
void ag_ing_sync(void* h, const int64_t* base_round,
                 const int64_t* heights) {
  auto* L = static_cast<Loop*>(h);
  for (int64_t i = 0; i < L->I; ++i) {
    if (heights[i] > L->heights[static_cast<size_t>(i)]) {
      L->slot_count[static_cast<size_t>(i)] = 0;
      // clear the values too: the snapshot export derives counts from
      // the kNoValue sentinel, so stale entries would resurrect
      // pre-advance slots on restore
      std::fill_n(L->slot_vals.begin() + i * L->S,
                  static_cast<size_t>(L->S), agnes::kNoValue);
      // decided heights can never commit again: drop their host tallies
      for (auto it = L->host_tally.begin(); it != L->host_tally.end();) {
        if (std::get<0>(it->first) == i &&
            std::get<1>(it->first) < heights[i])
          it = L->host_tally.erase(it);
        else
          ++it;
      }
    }
    L->heights[static_cast<size_t>(i)] = heights[i];
    // the device reports window bases >= 0; clamp hostile values so
    // round-window arithmetic downstream cannot overflow int64
    L->base_round[static_cast<size_t>(i)] =
        base_round[i] < 0 ? 0 : base_round[i];
  }
  if (!L->held.empty()) {
    // pending is shared with the async worker; held is tick-only
    std::lock_guard<std::mutex> g(L->mu);
    grow_reserve(L->pending, L->held.size());
    for (auto& r : L->held) L->pending.push_back(r);
    L->held.clear();
  }
}

// parse + malformed screen; returns count accepted into pending
// (height/window screens run at stage(); rejects are counted on the
// handle).  Takes the async mutex: pending/arrivals/rejected_malformed
// are shared with the worker thread when push_async is in use — and
// DRAINS the inbox first, so a push() after push_async() stamps its
// arrivals after the queued buffers' (first-vote-wins dedup and
// evidence order must match the all-synchronous sequence exactly).
int64_t ag_ing_push(void* h, const uint8_t* buf, int64_t n) {
  auto* L = static_cast<Loop*>(h);
  int64_t accepted = 0;
  std::unique_lock<std::mutex> g(L->mu);
  L->cv_idle.wait(g, [&] { return L->inbox.empty() && !L->worker_busy; });
  grow_reserve(L->pending, static_cast<size_t>(n));
  for (int64_t k = 0; k < n; ++k) {
    Rec r;
    parse_rec(buf + k * kRecSize, &r);
    r.arrival = L->arrivals++;
    // malformed screen (VoteBatcher.build_phases' `ok` mask); height
    // and window screens run at stage() against last-synced state
    if (rec_malformed(L, r)) {
      ++L->rejected_malformed;
      continue;
    }
    L->pending.push_back(r);
    ++accepted;
  }
  return accepted;
}

// queue one wire buffer for the worker thread (copies the bytes: the
// caller's buffer is free the moment this returns).  The worker
// parses/screens while the tick thread drives verify/emit/device —
// the overlap that makes densify(k+1) concurrent with step(k).
int64_t ag_ing_push_async(void* h, const uint8_t* buf, int64_t n) {
  auto* L = static_cast<Loop*>(h);
  std::vector<uint8_t> copy(buf, buf + n * kRecSize);
  {
    std::lock_guard<std::mutex> g(L->mu);
    if (!L->worker.joinable())
      L->worker = std::thread(ingest_worker_main, L);
    L->inbox.push_back(std::move(copy));
    L->inbox_recs += n;
  }
  L->cv_in.notify_one();
  return n;
}

// wait until every queued async buffer has landed in pending — after
// this, stage() sees exactly the records a synchronous push would have
void ag_ing_flush(void* h) {
  auto* L = static_cast<Loop*>(h);
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_idle.wait(lk, [&] { return L->inbox.empty() && !L->worker_busy; });
}

// records queued/in-flight on the worker (observability + tests);
// counts a buffer until its records have landed in pending
int64_t ag_ing_async_depth(void* h) {
  auto* L = static_cast<Loop*>(h);
  std::lock_guard<std::mutex> g(L->mu);
  return L->inbox_recs;
}

// screen pending against the last-synced heights/window and snapshot
// the in-window lanes for verification; returns lane count.  Implies
// flush(): a stage must never run ahead of queued async pushes.
int64_t ag_ing_stage(void* h) {
  auto* L = static_cast<Loop*>(h);
  std::vector<Rec> work;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_idle.wait(lk,
                    [&] { return L->inbox.empty() && !L->worker_busy; });
    work.swap(L->pending);
  }
  grow_reserve(L->staged, work.size());
  for (const auto& r : work) {
    size_t i = static_cast<size_t>(r.instance);
    if (r.height != L->heights[i]) {
      ++L->dropped_stale_height;
    } else if (r.round >= agnes::sat_add(L->base_round[i], L->W)) {
      if (static_cast<int64_t>(L->held.size()) < L->held_cap)
        L->held.push_back(r);           // future: hold for rotation
      else
        ++L->dropped_held_overflow;     // cap: fail closed, count
    } else {
      L->staged.push_back(r);
    }
  }
  // hand pending's buffer back (hot per-tick path: keep steady-state
  // ticks allocation-free) unless the worker already refilled it
  work.clear();
  {
    std::lock_guard<std::mutex> g(L->mu);
    if (L->pending.empty() && work.capacity() > L->pending.capacity())
      L->pending.swap(work);
  }
  return static_cast<int64_t>(L->staged.size());
}

// verify inputs for the staged lanes: pub/sig bytes widened to i32 and
// the single padded SHA-512 block per lane (the exact layout
// bridge/ingest.py's _sha_blocks_np + vote_messages_np produce)
void ag_ing_fill_verify_inputs(void* h, int32_t* out_pub /* n*32 */,
                               int32_t* out_sig /* n*64 */,
                               uint32_t* out_blocks /* n*32 */) {
  auto* L = static_cast<Loop*>(h);
  uint8_t msg[45];
  uint8_t blk[128];
  for (size_t k = 0; k < L->staged.size(); ++k) {
    const Rec& r = L->staged[k];
    std::memset(msg, 0, sizeof(msg));
    msg[0] = static_cast<uint8_t>(r.typ);
    uint64_t hgt = static_cast<uint64_t>(r.height);
    for (int i = 0; i < 8; ++i) msg[1 + i] = (hgt >> (8 * i)) & 0xFF;
    uint32_t rnd = static_cast<uint32_t>(r.round);
    for (int i = 0; i < 4; ++i) msg[9 + i] = (rnd >> (8 * i)) & 0xFF;
    if (r.value == kNil) {
      std::memset(msg + 13, 0xFF, 32);  // NIL_WIRE = 2^256 - 1
    } else {
      uint64_t v = static_cast<uint64_t>(r.value);
      for (int i = 0; i < 8; ++i) msg[13 + i] = (v >> (8 * i)) & 0xFF;
    }
    const uint8_t* pk =
        L->pubkeys.empty() ? nullptr
                           : L->pubkeys.data() + r.validator * 32;
    std::memset(blk, 0, sizeof(blk));
    std::memcpy(blk, r.sig, 32);                    // R
    if (pk) std::memcpy(blk + 32, pk, 32);          // A
    std::memcpy(blk + 64, msg, 45);                 // M
    blk[109] = 0x80;
    blk[126] = (109 * 8) >> 8;
    blk[127] = (109 * 8) & 0xFF;
    for (int j = 0; j < 32; ++j) {
      out_blocks[k * 32 + j] =
          (uint32_t(blk[4 * j]) << 24) | (uint32_t(blk[4 * j + 1]) << 16) |
          (uint32_t(blk[4 * j + 2]) << 8) | uint32_t(blk[4 * j + 3]);
      if (pk) out_pub[k * 32 + j] = pk[j];
    }
    for (int j = 0; j < 64; ++j) out_sig[k * 64 + j] = r.sig[j];
  }
}

// ok = NULL means the unsigned path (only legal when the loop was
// created without pubkeys); verified lanes are retained for evidence
// and past-round lanes fall to the host tally
int64_t ag_ing_apply_verdicts(void* h, const uint8_t* ok) {
  auto* L = static_cast<Loop*>(h);
  if (ok == nullptr && L->require_verify) return -1;
  if (L->staged.empty()) return 0;

  // compact rejected lanes out IN PLACE, then move the whole block —
  // the log and the ready queue share it (no per-record copies)
  auto blk = std::make_shared<std::vector<Rec>>(std::move(L->staged));
  L->staged.clear();
  std::vector<Rec>& b = *blk;
  if (ok) {
    size_t w = 0;
    for (size_t k = 0; k < b.size(); ++k) {
      if (!ok[k]) {
        ++L->rejected_signature;
        continue;
      }
      if (w != k) b[w] = b[k];
      ++w;
    }
    b.resize(w);
  }

  // rotated-out rounds fall to the host tally; when none exist (the
  // common case) the block rides to emit untouched
  bool any_past = false;
  for (const Rec& r : b)
    if (r.round < L->base_round[static_cast<size_t>(r.instance)]) {
      any_past = true;
      break;
    }
  int64_t kept;
  if (!any_past) {
    kept = static_cast<int64_t>(b.size());
    L->log.push_back(blk);
    if (!b.empty()) L->ready.push_back(blk);
  } else {
    auto cur = std::make_shared<std::vector<Rec>>();
    cur->reserve(b.size());
    for (const Rec& r : b) {
      if (r.round < L->base_round[static_cast<size_t>(r.instance)])
        host_tally_add(L, r);
      else
        cur->push_back(r);
    }
    kept = static_cast<int64_t>(cur->size());
    L->log.push_back(blk);              // evidence keeps ALL verified
    if (!cur->empty()) L->ready.push_back(std::move(cur));
  }
  return kept;
}

namespace {

// scatter one vote into a phase; routes slot-overflow to the host tally
inline void scatter_vote(Loop* L, Phase& ph, const Rec& r) {
  int32_t s = kVotedNil;
  if (r.value != kNil) {
    s = slot_for(L, r.instance, r.value);
    if (s == kVotedNil - 1) {           // slot budget overflow ->
      ++L->overflow_votes;              // host tally keeps the vote
      host_tally_add(L, r);
      return;
    }
  }
  size_t cell = static_cast<size_t>(r.instance * L->V + r.validator);
  ph.slots[cell] = s;
  ph.mask[cell] = 1;
  ++ph.n_votes;
}

// intern every new (instance, value) pair in ascending order — the
// exact allocation order VoteBatcher._intern_slots uses, so slot
// numbering matches the numpy path bit-for-bit
void intern_ascending(Loop* L, std::vector<std::pair<int64_t, int64_t>>& pairs) {
  std::sort(pairs.begin(), pairs.end());
  pairs.erase(std::unique(pairs.begin(), pairs.end()), pairs.end());
  for (auto& pv : pairs) slot_for(L, pv.first, pv.second);
}

}  // namespace

// dedup + layer + intern + scatter the ready lanes into the NEXT emit
// buffer set (double buffer: pointers from the previous emit stay
// valid while the device consumes them).  Returns the phase count.
int64_t ag_ing_emit(void* h) {
  auto* L = static_cast<Loop*>(h);
  L->cur ^= 1;
  EmitSet& set = L->sets[L->cur];
  set.used = 0;
  if (L->ready.empty()) return 0;

  std::vector<Loop::Block> blocks;
  blocks.swap(L->ready);

  // --- fast path: one round, each class's cells occupied at most
  // once — the honest gossip ticks (one phase, or both classes of a
  // round pushed into one build for a single 2n-lane verify; mirrors
  // VoteBatcher.build_phases).  Epoch-stamped scans, no sort; the
  // stamp array is per (class, cell) so the classes don't collide.
  if (L->cell_epoch.size() <
      static_cast<size_t>(2 * L->I * L->V))
    L->cell_epoch.assign(static_cast<size_t>(2 * L->I * L->V), 0);
  ++L->epoch;
  bool fast = true;
  bool have_typ[2] = {false, false};
  const Rec& first = (*blocks[0])[0];
  std::vector<std::pair<int64_t, int64_t>> pairs;
  for (const auto& blk : blocks) {
    for (const Rec& r : *blk) {
      if (r.round != first.round || r.typ < 0 || r.typ > 1) {
        fast = false;
        break;
      }
      size_t cell = static_cast<size_t>(
          (r.typ * L->I + r.instance) * L->V + r.validator);
      if (L->cell_epoch[cell] == L->epoch) { fast = false; break; }
      L->cell_epoch[cell] = L->epoch;
      have_typ[r.typ] = true;
      if (r.value != kNil &&
          slot_lookup(L, r.instance, r.value) == kVotedNil)
        pairs.emplace_back(r.instance, r.value);
    }
    if (!fast) break;
  }
  if (fast) {
    intern_ascending(L, pairs);
    // classes emit in (prevote, precommit) order — the general path's
    // sort order, and the order consensus expects to make progress
    for (int t = 0; t <= 1; ++t) {
      if (!have_typ[t]) continue;
      Phase& ph = set.acquire(L->I * L->V);
      ph.round = static_cast<int32_t>(first.round);
      ph.typ = static_cast<int32_t>(t);
      for (const auto& blk : blocks)
        for (const Rec& r : *blk)
          if (r.typ == t) scatter_vote(L, ph, r);
      if (ph.n_votes == 0) --set.used;   // all lanes spilled: drop it
    }
    return static_cast<int64_t>(set.used);
  }

  // --- general path: flatten to pointers, then ONE index sort orders
  // everything (VoteBatcher's lexsort): phase groups, duplicates and
  // layers fall out of adjacency.  Pointers avoid shuffling the
  // ~120-byte records.
  std::vector<const Rec*> b;
  for (const auto& blk : blocks)
    for (const Rec& r : *blk) b.push_back(&r);
  std::vector<uint32_t> idx(b.size());
  for (size_t k = 0; k < b.size(); ++k) idx[k] = static_cast<uint32_t>(k);
  std::sort(idx.begin(), idx.end(), [&b](uint32_t x, uint32_t y) {
    const Rec& a = *b[x];
    const Rec& c = *b[y];
    if (a.round != c.round) return a.round < c.round;
    if (a.typ != c.typ) return a.typ < c.typ;
    if (a.instance != c.instance) return a.instance < c.instance;
    if (a.validator != c.validator) return a.validator < c.validator;
    if (a.value != c.value) return a.value < c.value;
    return a.arrival < c.arrival;
  });

  // drop exact duplicates (same cell, same value)
  std::vector<uint32_t> keep;
  keep.reserve(idx.size());
  for (uint32_t k : idx) {
    if (!keep.empty()) {
      const Rec& q = *b[keep.back()];
      const Rec& r = *b[k];
      if (q.round == r.round && q.typ == r.typ &&
          q.instance == r.instance && q.validator == r.validator &&
          q.value == r.value)
        continue;
    }
    keep.push_back(k);
  }

  // layer = rank within the (round, typ, instance, validator) run
  std::vector<int32_t> layer(keep.size(), 0);
  for (size_t k = 1; k < keep.size(); ++k) {
    const Rec& q = *b[keep[k - 1]];
    const Rec& r = *b[keep[k]];
    if (q.round == r.round && q.typ == r.typ &&
        q.instance == r.instance && q.validator == r.validator)
      layer[k] = layer[k - 1] + 1;
  }

  // intern slots in ascending (instance, value) order (SlotMap parity)
  pairs.clear();
  for (uint32_t k : keep)
    if (b[k]->value != kNil)
      pairs.emplace_back(b[k]->instance, b[k]->value);
  intern_ascending(L, pairs);

  // group by (round, typ, layer) ascending — already the sort order
  // except layer, so bucket by key into an ordered map
  std::map<std::tuple<int64_t, int64_t, int32_t>, size_t> groups;
  std::vector<std::vector<uint32_t>> members;
  for (size_t k = 0; k < keep.size(); ++k) {
    auto key = std::make_tuple(b[keep[k]]->round, b[keep[k]]->typ,
                               layer[k]);
    auto it = groups.find(key);
    if (it == groups.end()) {
      it = groups.emplace(key, members.size()).first;
      members.emplace_back();
    }
    members[it->second].push_back(keep[k]);
  }

  for (auto& kv : groups) {
    Phase& ph = set.acquire(L->I * L->V);
    ph.round = static_cast<int32_t>(std::get<0>(kv.first));
    ph.typ = static_cast<int32_t>(std::get<1>(kv.first));
    for (uint32_t k : members[kv.second]) scatter_vote(L, ph, *b[k]);
    if (ph.n_votes == 0) --set.used;    // all lanes overflowed to host
  }
  return static_cast<int64_t>(set.used);
}

// pointers into the current emit set; valid until the emit after next
int64_t ag_ing_phase(void* h, int64_t k, int32_t* out_round,
                     int32_t* out_typ, int64_t* out_n,
                     const int32_t** out_slots,
                     const uint8_t** out_mask) {
  auto* L = static_cast<Loop*>(h);
  EmitSet& set = L->sets[L->cur];
  if (k < 0 || k >= static_cast<int64_t>(set.used)) return -1;
  const Phase& ph = set.phases[static_cast<size_t>(k)];
  *out_round = ph.round;
  *out_typ = ph.typ;
  *out_n = ph.n_votes;
  *out_slots = ph.slots.data();
  *out_mask = ph.mask.data();
  return 0;
}

// [(instance, height, round, value)] late precommit-value quorums
int64_t ag_ing_drain_events(void* h, int64_t* out, int64_t cap) {
  auto* L = static_cast<Loop*>(h);
  int64_t n = 0;
  for (auto& e : L->events) {
    if (n >= cap) break;
    for (int j = 0; j < 4; ++j) out[4 * n + j] = e[static_cast<size_t>(j)];
    ++n;
  }
  L->events.erase(L->events.begin(), L->events.begin() + n);
  return n;
}

int64_t ag_ing_decode_slot(void* h, int64_t instance, int32_t slot) {
  auto* L = static_cast<Loop*>(h);
  if (instance < 0 || instance >= L->I || slot < 0 ||
      slot >= L->slot_count[static_cast<size_t>(instance)])
    return agnes::kNoValue;
  return L->slot_vals[static_cast<size_t>(instance * L->S + slot)];
}

// two conflicting signed votes by `validator` in `instance` with the
// same (height, round, typ) and different values -> 2 wire records
int64_t ag_ing_evidence(void* h, int64_t instance, int64_t validator,
                        uint8_t* out /* 2 * 96 bytes */) {
  auto* L = static_cast<Loop*>(h);
  // the log is block-shared with the verdict stage; flatten the
  // candidate votes first (one validator's votes: a short list)
  std::vector<const Rec*> cand;
  for (const auto& blk : L->log)
    for (const Rec& r : *blk)
      if (r.instance == instance && r.validator == validator)
        cand.push_back(&r);
  for (size_t a = 0; a < cand.size(); ++a) {
    const Rec& x = *cand[a];
    for (size_t bidx = a + 1; bidx < cand.size(); ++bidx) {
      const Rec& y = *cand[bidx];
      if (x.height == y.height && x.round == y.round && x.typ == y.typ &&
          x.value != y.value) {
        pack_rec(x, out);
        pack_rec(y, out + kRecSize);
        return 1;
      }
    }
  }
  return 0;
}

void ag_ing_clear_log(void* h) { static_cast<Loop*>(h)->log.clear(); }

// --- snapshot surface (utils/checkpoint.py save/load_native_loop) ----------
// The durable state a crash must not lose: slot interning (decision
// decode), the verified-vote log (slashing evidence), counters, and
// the window (restored via ag_ing_sync by the caller).  In-flight
// votes (pending/staged/held) and host tallies are NOT exported —
// a restarted node re-receives them from peers (save_executor's
// crash-recovery story).

// dump slot values as [I*S] (kNoValue where unallocated)
void ag_ing_export_slots(void* h, int64_t* out) {
  auto* L = static_cast<Loop*>(h);
  std::memcpy(out, L->slot_vals.data(),
              sizeof(int64_t) * static_cast<size_t>(L->I * L->S));
}

// restore slot values (counts derived from the kNoValue sentinel);
// slots are allocated densely, so the first sentinel ends the row
void ag_ing_import_slots(void* h, const int64_t* vals) {
  auto* L = static_cast<Loop*>(h);
  L->slot_vals.assign(vals, vals + L->I * L->S);
  for (int64_t i = 0; i < L->I; ++i) {
    int32_t n = 0;
    while (n < L->S && vals[i * L->S + n] != agnes::kNoValue) ++n;
    L->slot_count[static_cast<size_t>(i)] = n;
  }
}

int64_t ag_ing_log_size(void* h) {
  auto* L = static_cast<Loop*>(h);
  int64_t n = 0;
  for (const auto& blk : L->log) n += static_cast<int64_t>(blk->size());
  return n;
}

// dump the verified-vote log as packed wire records (the same 96-byte
// layout ag_ing_push consumes)
void ag_ing_export_log(void* h, uint8_t* out) {
  auto* L = static_cast<Loop*>(h);
  for (const auto& blk : L->log)
    for (const Rec& r : *blk) {
      pack_rec(r, out);
      out += kRecSize;
    }
}

// restore the log from packed wire records.  These lanes were
// verified before the snapshot, but the snapshot itself is untrusted
// input to this raw ABI: the same malformed screen as push applies —
// a corrupted file must not inject records push would reject into
// the slashing-evidence log.  ALL-OR-NOTHING: records are screened
// while parsing into a LOCAL staging block, and a corrupt snapshot
// (nonzero return) commits nothing — a partial evidence log
// masquerading as a successful restore would be worse than failing.
// FRESH-ONLY: the import targets a freshly constructed loop; merging a
// snapshot's log into live evidence would duplicate records and skew
// every log counter, so a non-empty log is rejected outright (-1).
int64_t ag_ing_import_log(void* h, const uint8_t* buf, int64_t n) {
  auto* L = static_cast<Loop*>(h);
  if (!L->log.empty()) return -1;     // refuse to merge with live state
  auto blk = std::make_shared<std::vector<Rec>>();
  blk->reserve(static_cast<size_t>(n));
  int64_t dropped = 0;
  for (int64_t k = 0; k < n; ++k) {
    Rec r;
    parse_rec(buf + k * kRecSize, &r);
    if (rec_malformed(L, r))
      ++dropped;
    else
      blk->push_back(r);
  }
  if (dropped) return dropped;        // blk is local: nothing committed
  for (Rec& r : *blk) r.arrival = L->arrivals++;
  if (!blk->empty()) L->log.push_back(std::move(blk));
  return 0;
}

// restore counters: [malformed, stale_height, signature, overflow,
// held_overflow] (held size and log size are structural, not set)
void ag_ing_restore_counters(void* h, const int64_t* in) {
  auto* L = static_cast<Loop*>(h);
  L->rejected_malformed = in[0];
  L->dropped_stale_height = in[1];
  L->rejected_signature = in[2];
  L->overflow_votes = in[3];
  L->dropped_held_overflow = in[4];
}

// counters: [malformed, stale_height, signature, overflow, held, log,
//            held_overflow]
void ag_ing_counters(void* h, int64_t* out) {
  auto* L = static_cast<Loop*>(h);
  // rejected_malformed is worker-shared; the rest are tick-only (the
  // one lock covers the lot — this is a cold observability path)
  std::lock_guard<std::mutex> g(L->mu);
  out[0] = L->rejected_malformed;
  out[1] = L->dropped_stale_height;
  out[2] = L->rejected_signature;
  out[3] = L->overflow_votes;
  out[4] = static_cast<int64_t>(L->held.size());
  int64_t logged = 0;
  for (const auto& blk : L->log)
    logged += static_cast<int64_t>(blk->size());
  out[5] = logged;
  out[6] = L->dropped_held_overflow;
}

}  // extern "C"
