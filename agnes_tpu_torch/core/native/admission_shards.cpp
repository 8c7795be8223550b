// Sharded native ingest (the port's copy of the JAX package's
// core/native/admission_shards.cpp; the C ABI is the same): N
// admission shards per host — one AdmQ (and one mutex) per shard,
// instance-range partitioned (shard s owns instances [s*L, (s+1)*L),
// L = I / n_shards) — behind ONE submit fan-in that routes each
// 96-byte record by its instance id.  Two producer threads landing on
// different shards never touch the same mutex; a single queue funnels
// the whole host through one.
//
// Correctness anchors:
//
//   - Fairness caps and overload policies are PER-SHARD-CORRECT
//     because the partition key IS the fairness key: an instance's
//     occupancy and rank-within-submit live entirely in its owning
//     shard, so per-instance caps are exact at any shard count.
//     Capacity is split evenly (capacity / n_shards per shard), so
//     *aggregate* overflow behavior near the capacity ceiling differs
//     from a single queue when the instance mix is skewed — the
//     wrapper documents this and the conformance grid keeps its
//     byte-identity schedules below the per-shard ceiling.
//
//   - The drain is a deterministic K-WAY MERGE: all shard mutexes are
//     taken in ascending shard order (a fixed hierarchy), then the
//     globally-oldest record by
//     (seq, sub_idx) is popped repeatedly.  Every shard deque is
//     sorted by (seq, sub_idx) (see admission.hpp), so the merged
//     stream replays the single-queue admission order byte-for-byte
//     whenever the accept decisions agree.
//
//   - Digests come back in GLOBAL admission order: submit_records
//     reports a per-position kept mask, and the fan-in walks the
//     original record order gathering each shard's compact digests.
//     The (seq -> per-admitted-record shard) route is remembered so
//     mark_verified can split the cache's global hit mask back into
//     per-shard masks; routes are stored only when digests are on
//     (the wrapper always marks when a cache is attached) and are
//     dropped once consumed.
//
// The C ABI mirrors ag_adm_* one-for-one under the ag_adms_ prefix so
// the audited ctypes wrapper stays a thin twin.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <mutex>
#include <unordered_map>
#include <vector>

#include "admission.hpp"

namespace {

using namespace agnes_adm;

struct AdmShards {
  int64_t n_shards, I, L;
  bool digests;
  std::vector<AdmQ*> shards;
  std::atomic<int64_t> next_seq{0};
  // seq -> shard id per ADMITTED record (global admission order);
  // consumed by mark_verified.  Bounded defensively: a wrapper that
  // breaks the always-mark contract must not leak the host.
  std::mutex route_mu;
  std::unordered_map<int64_t, std::vector<int32_t>> routes;
};

constexpr size_t kRouteCapSafety = 65536;

inline int64_t shard_of(const AdmShards* G, int64_t inst) {
  // out-of-range instances ride to shard 0, whose range screen counts
  // them malformed — the single queue's taxonomy, one home
  if (inst < 0 || inst >= G->I) return 0;
  return inst / G->L;
}

// pop the globally-oldest n records across all shards by (seq,
// sub_idx); all shard mutexes held in ascending order for the whole
// merge so the stream is a consistent snapshot.  Each shard's drained
// counter is charged its own popped count.
void merge_pop(AdmShards* G, int64_t& n, std::vector<NRec>& rows) {
  std::vector<std::unique_lock<std::mutex>> locks;
  locks.reserve(static_cast<size_t>(G->n_shards));
  for (AdmQ* A : G->shards) locks.emplace_back(A->mu);
  int64_t total = 0;
  for (AdmQ* A : G->shards)
    total += static_cast<int64_t>(A->q.size());
  if (n < 0) n = 0;
  if (n > total) n = total;
  rows.reserve(static_cast<size_t>(n));
  for (int64_t k = 0; k < n; ++k) {
    AdmQ* best = nullptr;
    for (AdmQ* A : G->shards) {
      if (A->q.empty()) continue;
      const NRec& f = A->q.front();
      if (!best || f.seq < best->q.front().seq ||
          (f.seq == best->q.front().seq &&
           f.sub_idx < best->q.front().sub_idx))
        best = A;
    }
    rows.push_back(best->q.front());
    pop_front(best, 1);
    best->counters[6]++;
  }
}

}  // namespace

extern "C" {

void* ag_adms_new(int64_t n_shards, int64_t I, int64_t capacity,
                  int64_t instance_cap, int32_t policy,
                  int32_t with_digests) {
  // shard-count and divisibility screens fail closed like ag_adm_new;
  // I % n_shards == 0 keeps the instance ranges equal, capacity % n_shards == 0 keeps the per-shard ceiling an
  // integer the wrapper can report exactly
  if (n_shards <= 0 || n_shards > 256 || I <= 0 ||
      I % n_shards != 0 || capacity <= 0 ||
      capacity % n_shards != 0 || capacity / n_shards <= 0 ||
      instance_cap <= 0 || (policy != 0 && policy != 1))
    return nullptr;
  try {
    auto* G = new AdmShards();
    G->n_shards = n_shards;
    G->I = I;
    G->L = I / n_shards;
    G->digests = with_digests != 0;
    G->shards.reserve(static_cast<size_t>(n_shards));
    for (int64_t s = 0; s < n_shards; ++s) {
      auto* A = new AdmQ();
      A->I = I;   // global instance ids; routing enforces the range
      A->capacity = capacity / n_shards;
      A->instance_cap = instance_cap;
      A->policy = policy;
      A->digests = with_digests != 0;
      A->inst_counts.assign(static_cast<size_t>(I), 0);
      A->seen.assign(static_cast<size_t>(I), 0);
      A->seen_epoch.assign(static_cast<size_t>(I), 0);
      G->shards.push_back(A);
    }
    return G;
  } catch (...) {
    return nullptr;
  }
}

void ag_adms_free(void* h) {
  auto* G = static_cast<AdmShards*>(h);
  if (!G) return;
  for (AdmQ* A : G->shards) delete A;
  delete G;
}

int64_t ag_adms_n_shards(void* h) {
  return static_cast<AdmShards*>(h)->n_shards;
}

// the submit fan-in: route each whole record to its owning shard,
// run the exact per-shard screens (no mutex shared between shards —
// producers on disjoint ranges never contend), then gather digests
// back into global admission order.  out_counts/out_digests have the
// ag_adm_submit layout.  Returns the group seq.
int64_t ag_adms_submit(void* h, const uint8_t* buf, int64_t nbytes,
                       int64_t* out_counts, uint8_t* out_digests) {
  auto* G = static_cast<AdmShards*>(h);
  const int64_t n_whole = nbytes / kRecSize;
  const int64_t tail = (nbytes % kRecSize) ? 1 : 0;
  const int64_t seq = G->next_seq.fetch_add(1) + 1;

  // partition by owning shard, preserving original record order
  std::vector<std::vector<int64_t>> ridx(
      static_cast<size_t>(G->n_shards));
  std::vector<int32_t> home(static_cast<size_t>(n_whole));
  for (int64_t k = 0; k < n_whole; ++k) {
    const int64_t s = shard_of(G, rec_instance(buf + k * kRecSize));
    home[static_cast<size_t>(k)] = static_cast<int32_t>(s);
    ridx[static_cast<size_t>(s)].push_back(k);
  }

  int64_t counts[5] = {0, 0, 0, 0, 0};
  std::vector<std::vector<uint8_t>> digs(
      static_cast<size_t>(G->n_shards));
  std::vector<std::vector<uint8_t>> kept(
      static_cast<size_t>(G->n_shards));
  for (int64_t s = 0; s < G->n_shards; ++s) {
    auto& idx = ridx[static_cast<size_t>(s)];
    const int64_t tail_s = (s == 0) ? tail : 0;
    if (idx.empty() && tail_s == 0) continue;
    int64_t c5[5];
    auto& dg = digs[static_cast<size_t>(s)];
    auto& kp = kept[static_cast<size_t>(s)];
    if (G->digests && out_digests) dg.resize(idx.size() * 32);
    kp.resize(idx.size());
    submit_records(G->shards[static_cast<size_t>(s)], buf, idx.data(),
                   static_cast<int64_t>(idx.size()), tail_s, seq, c5,
                   dg.empty() ? nullptr : dg.data(),
                   kp.empty() ? nullptr : kp.data());
    for (int j = 0; j < 5; ++j) counts[j] += c5[j];
  }
  for (int j = 0; j < 5; ++j) out_counts[j] = counts[j];

  // gather digests into GLOBAL admission order + remember the route
  if (G->digests && counts[0] > 0) {
    std::vector<int32_t> route;
    route.reserve(static_cast<size_t>(counts[0]));
    std::vector<int64_t> cur(static_cast<size_t>(G->n_shards), 0);
    std::vector<int64_t> adm(static_cast<size_t>(G->n_shards), 0);
    int64_t out = 0;
    for (int64_t k = 0; k < n_whole; ++k) {
      const size_t s = static_cast<size_t>(home[static_cast<size_t>(k)]);
      const int64_t pos = cur[s]++;
      if (!kept[s][static_cast<size_t>(pos)]) continue;
      if (out_digests)
        std::memcpy(out_digests + 32 * out,
                    digs[s].data() + 32 * adm[s], 32);
      adm[s]++;
      ++out;
      route.push_back(static_cast<int32_t>(s));
    }
    std::lock_guard<std::mutex> g(G->route_mu);
    if (G->routes.size() >= kRouteCapSafety) G->routes.clear();
    G->routes[seq] = std::move(route);
  }
  return seq;
}

void ag_adms_set_chunk_ts(void* h, int64_t seq, double ts) {
  auto* G = static_cast<AdmShards*>(h);
  for (AdmQ* A : G->shards) set_chunk_ts_core(A, seq, ts);
}

// split the cache's global hit mask back per shard using the remembered
// route, then run each shard's exact back-walk.  The wrapper calls this
// for EVERY accepted digest-bearing submit (hits or not) so the route
// entry is always consumed.
void ag_adms_mark_verified(void* h, int64_t seq, const uint8_t* ver,
                           int64_t n) {
  auto* G = static_cast<AdmShards*>(h);
  std::vector<int32_t> route;
  {
    std::lock_guard<std::mutex> g(G->route_mu);
    auto it = G->routes.find(seq);
    if (it == G->routes.end()) return;
    route = std::move(it->second);
    G->routes.erase(it);
  }
  if (n > static_cast<int64_t>(route.size()))
    n = static_cast<int64_t>(route.size());
  std::vector<std::vector<uint8_t>> per(
      static_cast<size_t>(G->n_shards));
  for (int64_t j = 0; j < n; ++j)
    per[static_cast<size_t>(route[static_cast<size_t>(j)])].push_back(
        ver[j]);
  for (int64_t s = 0; s < G->n_shards; ++s) {
    auto& m = per[static_cast<size_t>(s)];
    if (!m.empty())
      mark_verified_core(G->shards[static_cast<size_t>(s)], seq,
                         m.data(), static_cast<int64_t>(m.size()));
  }
}

int64_t ag_adms_depth(void* h) {
  auto* G = static_cast<AdmShards*>(h);
  int64_t d = 0;
  for (AdmQ* A : G->shards) {
    std::lock_guard<std::mutex> g(A->mu);
    d += static_cast<int64_t>(A->q.size());
  }
  return d;
}

int64_t ag_adms_shard_depth(void* h, int64_t s) {
  auto* G = static_cast<AdmShards*>(h);
  if (s < 0 || s >= G->n_shards) return 0;
  AdmQ* A = G->shards[static_cast<size_t>(s)];
  std::lock_guard<std::mutex> g(A->mu);
  return static_cast<int64_t>(A->q.size());
}

int64_t ag_adms_instance_depth(void* h, int64_t i) {
  auto* G = static_cast<AdmShards*>(h);
  if (i < 0 || i >= G->I) return 0;
  AdmQ* A = G->shards[static_cast<size_t>(shard_of(G, i))];
  std::lock_guard<std::mutex> g(A->mu);
  return A->inst_counts[static_cast<size_t>(i)];
}

// guarded min over every shard's stamped heads (ag_adm_oldest_ts,
// grouped): NaN only when nothing stamped anywhere
double ag_adms_oldest_ts(void* h) {
  auto* G = static_cast<AdmShards*>(h);
  double best = std::numeric_limits<double>::quiet_NaN();
  for (AdmQ* A : G->shards) {
    const double t = min_stamped_ts(A);
    if (!std::isnan(t) && (std::isnan(best) || t < best)) best = t;
  }
  return best;
}

void ag_adms_counters(void* h, int64_t* out7) {
  auto* G = static_cast<AdmShards*>(h);
  for (int j = 0; j < 7; ++j) out7[j] = 0;
  for (AdmQ* A : G->shards) {
    std::lock_guard<std::mutex> g(A->mu);
    for (int j = 0; j < 7; ++j) out7[j] += A->counters[j];
  }
}

void ag_adms_shard_counters(void* h, int64_t s, int64_t* out7) {
  auto* G = static_cast<AdmShards*>(h);
  for (int j = 0; j < 7; ++j) out7[j] = 0;
  if (s < 0 || s >= G->n_shards) return;
  AdmQ* A = G->shards[static_cast<size_t>(s)];
  std::lock_guard<std::mutex> g(A->mu);
  for (int j = 0; j < 7; ++j) out7[j] = A->counters[j];
}

// foreign-outcome fold (the BLS class-table path) charges shard 0 —
// the aggregate taxonomy is what the drain report sums
void ag_adms_add_counters(void* h, const int64_t* deltas5) {
  auto* G = static_cast<AdmShards*>(h);
  AdmQ* A = G->shards[0];
  std::lock_guard<std::mutex> g(A->mu);
  for (int k = 0; k < 5; ++k) A->counters[k] += deltas5[k];
}

// k-way merged drain: the ag_adm_drain twin over the shard group
int64_t ag_adms_drain(void* h, int64_t n, int64_t* inst, int64_t* val,
                      int64_t* hts, int64_t* rnd, int64_t* typ,
                      int64_t* value, uint8_t* sigs, uint8_t* ver,
                      uint8_t* out_dig, double* ts) {
  auto* G = static_cast<AdmShards*>(h);
  std::vector<NRec> rows;
  merge_pop(G, n, rows);
  for (int64_t k = 0; k < n; ++k)
    parse_record(rows[static_cast<size_t>(k)], k, inst, val, hts, rnd,
                 typ, value, sigs, ver, out_dig, ts);
  return n;
}

// merged drain + zero-copy densify: merge-pop the rows, then run the
// same densify as the single queue's phase drain (same eligibility,
// same bail-to-Python contract).  Signature mirrors
// ag_adm_drain_phases.
int64_t ag_adms_drain_phases(
    void* h, int64_t n, int64_t* inst, int64_t* val, int64_t* hts,
    int64_t* rnd, int64_t* typ, int64_t* value, uint8_t* sigs,
    uint8_t* ver, uint8_t* out_dig, double* ts,
    const int64_t* win_heights, const int64_t* win_base, int64_t W,
    const int64_t* slot_lut, int64_t S, int64_t V,
    const uint8_t* pubkeys, int64_t lane_floor, int64_t max_votes,
    int64_t phase_offset, int64_t pad_cap, int32_t* ph_slots,
    uint8_t* ph_mask, int64_t* ph_typ, int64_t* ph_counts,
    int32_t* ln_pub, int32_t* ln_sig, uint32_t* ln_blocks,
    int32_t* ln_phase_idx, int32_t* ln_inst, int32_t* ln_val,
    uint8_t* ln_real, int64_t* ln_rows, int64_t* out_meta) {
  auto* G = static_cast<AdmShards*>(h);
  std::vector<NRec> rows;
  merge_pop(G, n, rows);
  for (int64_t k = 0; k < n; ++k)
    parse_record(rows[static_cast<size_t>(k)], k, inst, val, hts, rnd,
                 typ, value, sigs, ver, out_dig, ts);
  PhaseIn in;
  in.heights = win_heights;
  in.base_round = win_base;
  in.W = W;
  in.slot_lut = slot_lut;
  in.S = S;
  in.V = V;
  in.pubkeys = pubkeys;
  in.I = G->I;
  in.lane_floor = lane_floor;
  in.max_votes = max_votes;
  in.phase_offset = phase_offset;
  in.pad_cap = pad_cap;
  PhaseOut out;
  out.slots = ph_slots;
  out.mask = ph_mask;
  out.ph_typ = ph_typ;
  out.ph_counts = ph_counts;
  out.ln_pub = ln_pub;
  out.ln_sig = ln_sig;
  out.ln_blocks = ln_blocks;
  out.ln_phase_idx = ln_phase_idx;
  out.ln_inst = ln_inst;
  out.ln_val = ln_val;
  out.ln_real = ln_real;
  out.ln_rows = ln_rows;
  out.meta = out_meta;
  densify_phases(rows, inst, val, hts, rnd, typ, value, ver, in, out);
  return n;
}

// merged FIFO export for the model checker's canonical differential:
// a consistent snapshot (all shard locks held) of the would-be drain
// order, at most `cap` records
int64_t ag_adms_export(void* h, uint8_t* raw, uint8_t* ver,
                       int64_t cap) {
  auto* G = static_cast<AdmShards*>(h);
  std::vector<std::unique_lock<std::mutex>> locks;
  locks.reserve(static_cast<size_t>(G->n_shards));
  for (AdmQ* A : G->shards) locks.emplace_back(A->mu);
  std::vector<size_t> pos(static_cast<size_t>(G->n_shards), 0);
  int64_t k = 0;
  while (k < cap) {
    const AdmQ* best = nullptr;
    size_t bs = 0;
    for (int64_t s = 0; s < G->n_shards; ++s) {
      const AdmQ* A = G->shards[static_cast<size_t>(s)];
      const size_t p = pos[static_cast<size_t>(s)];
      if (p >= A->q.size()) continue;
      const NRec& f = A->q[p];
      if (!best) {
        best = A; bs = static_cast<size_t>(s);
      } else {
        const NRec& b = best->q[pos[bs]];
        if (f.seq < b.seq ||
            (f.seq == b.seq && f.sub_idx < b.sub_idx)) {
          best = A; bs = static_cast<size_t>(s);
        }
      }
    }
    if (!best) break;
    const NRec& r = best->q[pos[bs]++];
    std::memcpy(raw + k * kRecSize, r.raw, kRecSize);
    ver[k] = r.verified;
    ++k;
  }
  return k;
}

}  // extern "C"
