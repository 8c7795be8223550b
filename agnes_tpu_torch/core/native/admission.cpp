// Native admission front-end: the serve plane's per-record hot path
// in C++ (the port's copy of the JAX package's core/native/admission.cpp;
// the C ABI is the same).
//
// The Python AdmissionQueue (serve/queue.py) pays the GIL per record:
// wire parse, the malformed/fairness/capacity screens, and a Python
// SHA-256 loop for the dedup cache all run on the submit thread.  This
// module is its byte-compatible C++ twin, reached through the audited
// ctypes wrapper serve/native_admission.py — one GIL-releasing call
// per submit and per drain, everything per-record behind it native:
//
//   ag_adm_submit    parse + instance-range screen + per-instance
//                    fairness (occupancy + rank-within-submit < cap) +
//                    overload policy (reject-newest / drop-oldest) +
//                    SHA-256 digest of each ADMITTED record (the
//                    VerifiedCache key; sha512.cpp grew the SHA-256
//                    schedule), all under one internal mutex
//   ag_adm_drain     pop the n oldest records and densify them to the
//                    WireColumns arrays VoteBatcher.add_arrays takes —
//                    the Python side only plans the ladder rung and
//                    dispatches
//   ag_adm_bls_screen  the BLS class-bucket HEADER screens (range /
//                    PoP / quarantine) for BlsClassTable.fold; the
//                    on-curve share decode stays with the oracle
//
// The queue internals live in admission.hpp so the shard group
// (admission_shards.cpp) and the zero-copy densify drain
// (admission_phases.cpp) share the exact submit/drain arithmetic; the
// single-queue C ABI lives here.
//
// Semantics are a LEAF-FOR-LEAF port of AdmissionQueue.submit/drain
// (reject taxonomy, counter names and ordering, eviction math, digest
// bytes); tests/test_torch_native_admission.py holds it against the
// Python queue and the JAX package's copy.  Where this file and
// serve/queue.py could disagree, serve/queue.py is the specification.
//
// Thread safety: ONE mutex guards the whole handle.  submit and drain
// may race (the threaded host's submit vs dispatch threads) — this is
// what lets ThreadedVoteService drop the Python admission lock around
// a native queue, keeping the GIL-release span lock-free.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <limits>
#include <mutex>
#include <vector>

#include "admission.hpp"
#include "sha512.hpp"

namespace agnes_adm {

void pop_front(AdmQ* A, int64_t n) {
  for (int64_t k = 0; k < n; ++k) {
    A->inst_counts[static_cast<size_t>(rec_instance(A->q.front().raw))]--;
    A->q.pop_front();
  }
}

int64_t submit_records(AdmQ* A, const uint8_t* buf,
                       const int64_t* rec_idx, int64_t n_rec,
                       int64_t tail_malformed, int64_t seq,
                       int64_t* out_counts, uint8_t* out_digests,
                       uint8_t* out_kept) {
  std::lock_guard<std::mutex> g(A->mu);
  if (seq < 0) seq = ++A->next_seq;
  A->counters[0] += n_rec + tail_malformed;
  int64_t malformed = tail_malformed;
  if (out_kept) std::memset(out_kept, 0, static_cast<size_t>(n_rec));
  if (n_rec == 0) {
    A->counters[4] += malformed;
    out_counts[0] = 0; out_counts[1] = 0; out_counts[2] = 0;
    out_counts[3] = malformed; out_counts[4] = 0;
    return seq;
  }

  // instance-range screen + fairness: occupancy-so-far + rank within
  // this submit < cap (the rank counts every malformed-surviving
  // record of the instance, matching queue._cumcount over inst_k)
  ++A->epoch;
  std::vector<int64_t> keep;   // positions into rec_idx, ascending
  keep.reserve(static_cast<size_t>(n_rec));
  int64_t rejected_fairness = 0;
  for (int64_t j = 0; j < n_rec; ++j) {
    const int64_t k = rec_idx ? rec_idx[j] : j;
    const int64_t inst = rec_instance(buf + k * kRecSize);
    if (inst >= A->I) {
      ++malformed;
      continue;
    }
    const size_t i = static_cast<size_t>(inst);
    if (A->seen_epoch[i] != A->epoch) {
      A->seen_epoch[i] = A->epoch;
      A->seen[i] = 0;
    }
    const int64_t occ = A->inst_counts[i] + A->seen[i]++;
    if (occ >= A->instance_cap)
      ++rejected_fairness;
    else
      keep.push_back(j);
  }

  // capacity / overload policy (the exact queue.submit arithmetic)
  int64_t rejected_overflow = 0;
  int64_t evicted = 0;
  const int64_t depth = static_cast<int64_t>(A->q.size());
  const int64_t room = A->capacity - depth;
  if (static_cast<int64_t>(keep.size()) > room) {
    if (A->policy == 0) {                       // reject-newest
      const int64_t hold = room > 0 ? room : 0;
      rejected_overflow = static_cast<int64_t>(keep.size()) - hold;
      keep.resize(static_cast<size_t>(hold));
    } else {                                    // drop-oldest
      if (static_cast<int64_t>(keep.size()) > A->capacity) {
        rejected_overflow =
            static_cast<int64_t>(keep.size()) - A->capacity;
        keep.erase(keep.begin(),
                   keep.end() - static_cast<size_t>(A->capacity));
      }
      const int64_t over =
          static_cast<int64_t>(keep.size()) - (A->capacity - depth);
      evicted = depth < over ? depth : over;
      if (evicted > 0) {
        pop_front(A, evicted);                  // never counts drained
        A->counters[5] += evicted;
      }
    }
  }

  // enqueue at the sorted (seq, sub_idx) position: a plain push_back
  // in the single-queue / unraced case, a mid-deque splice only when
  // the shard group's atomic handed a racing submit a smaller seq
  // after a larger one already landed here (see admission.hpp)
  const int64_t accepted = static_cast<int64_t>(keep.size());
  auto ins = A->q.end();
  if (!A->q.empty() && A->q.back().seq > seq)
    ins = std::upper_bound(
        A->q.begin(), A->q.end(), seq,
        [](int64_t s, const NRec& r) { return s < r.seq; });
  for (size_t j = 0; j < keep.size(); ++j) {
    const int64_t k = rec_idx ? rec_idx[keep[j]] : keep[j];
    NRec r;
    std::memcpy(r.raw, buf + k * kRecSize, kRecSize);
    if (A->digests) {
      // digest of the RAW record bytes — the "these exact bytes were
      // device-verified" key (queue._record_digests)
      agnes::sha256(r.raw, kRecSize, r.digest);
      if (out_digests)
        std::memcpy(out_digests + 32 * j, r.digest, 32);
    } else {
      std::memset(r.digest, 0, 32);
    }
    // NaN until ag_adm_set_chunk_ts stamps it: a concurrent drain
    // popping the record in that gap must be able to TELL it is
    // unstamped (the wrapper substitutes its own clock) — a 0.0
    // sentinel would read as epoch-scale admission wait and pin the
    // latency histograms' p99 at hours
    r.ts = std::numeric_limits<double>::quiet_NaN();
    r.seq = seq;
    r.sub_idx = k;
    r.verified = 0;
    ins = A->q.insert(ins, r);
    ++ins;
    A->inst_counts[static_cast<size_t>(rec_instance(r.raw))]++;
    if (out_kept) out_kept[keep[j]] = 1;
  }

  A->counters[1] += accepted;
  A->counters[2] += rejected_overflow;
  A->counters[3] += rejected_fairness;
  A->counters[4] += malformed;
  out_counts[0] = accepted;
  out_counts[1] = rejected_overflow;
  out_counts[2] = rejected_fairness;
  out_counts[3] = malformed;
  out_counts[4] = evicted;
  return seq;
}

void set_chunk_ts_core(AdmQ* A, int64_t seq, double ts) {
  std::lock_guard<std::mutex> g(A->mu);
  for (auto it = A->q.rbegin(); it != A->q.rend(); ++it) {
    if (it->seq > seq) continue;
    if (it->seq < seq) break;
    it->ts = ts;
  }
}

void mark_verified_core(AdmQ* A, int64_t seq, const uint8_t* ver,
                        int64_t n) {
  std::lock_guard<std::mutex> g(A->mu);
  int64_t j = n - 1;
  for (auto it = A->q.rbegin(); it != A->q.rend() && j >= 0; ++it) {
    if (it->seq > seq) continue;      // a later submit's records
    if (it->seq < seq) break;         // past the target (FIFO order)
    it->verified = ver[j--] ? 1 : 0;
  }
}

double min_stamped_ts(AdmQ* A) {
  std::lock_guard<std::mutex> g(A->mu);
  double best = std::numeric_limits<double>::quiet_NaN();
  for (const NRec& r : A->q)
    if (!std::isnan(r.ts) && (std::isnan(best) || r.ts < best))
      best = r.ts;
  return best;
}

}  // namespace agnes_adm

using namespace agnes_adm;

extern "C" {

void* ag_adm_new(int64_t I, int64_t capacity, int64_t instance_cap,
                 int32_t policy, int32_t with_digests) {
  // raw C ABI: hostile dimensions fail closed (NULL), never throw
  // across the boundary (the ag_ing_new contract)
  if (I <= 0 || I > (int64_t{1} << 31) || capacity <= 0 ||
      instance_cap <= 0 || (policy != 0 && policy != 1))
    return nullptr;
  try {
    auto* A = new AdmQ();
    A->I = I;
    A->capacity = capacity;
    A->instance_cap = instance_cap;
    A->policy = policy;
    A->digests = with_digests != 0;
    A->inst_counts.assign(static_cast<size_t>(I), 0);
    A->seen.assign(static_cast<size_t>(I), 0);
    A->seen_epoch.assign(static_cast<size_t>(I), 0);
    return A;
  } catch (...) {
    return nullptr;
  }
}

void ag_adm_free(void* h) { delete static_cast<AdmQ*>(h); }

// The admission hot path: one call per submit, GIL released by ctypes
// for its whole span.  out_counts = [accepted, rejected_overflow,
// rejected_fairness, rejected_malformed, evicted]; out_digests (may be
// NULL, else sized n_whole*32) receives the SHA-256 of each ADMITTED
// record in admission order — the wrapper looks them up in the Python
// VerifiedCache and marks hits back via ag_adm_mark_verified.
// Returns the submit's seq id.
int64_t ag_adm_submit(void* h, const uint8_t* buf, int64_t nbytes,
                      int64_t* out_counts, uint8_t* out_digests) {
  auto* A = static_cast<AdmQ*>(h);
  const int64_t n_whole = nbytes / kRecSize;
  const int64_t tail = (nbytes % kRecSize) ? 1 : 0;
  return submit_records(A, buf, nullptr, n_whole, tail, -1, out_counts,
                        out_digests, nullptr);
}

// stamp submit `seq`'s accepted records with their admission instant.
// A separate call (not a submit argument) so the wrapper can keep the
// Python queue's EXACT clock discipline — AdmissionQueue reads its
// clock once per submit and only when records were accepted, and
// fake-clock differentials count invocations.  Same back-walk as
// mark_verified; a record drained before its stamp carries NaN, which
// the wrapper's drain replaces with its own clock (only reachable
// under a concurrent drain).
void ag_adm_set_chunk_ts(void* h, int64_t seq, double ts) {
  set_chunk_ts_core(static_cast<AdmQ*>(h), seq, ts);
}

// flag submit `seq`'s accepted records as dedup-cache hits.  `ver` is
// the cache's [n] hit mask in admission order; records of the submit
// already drained (a concurrent dispatch-thread drain between the
// submit and this call) are skipped — they dispatch signed, which is
// always the safe direction.  Walks from the back so partial front
// drains keep the alignment: the LAST record of the submit pairs with
// ver[n-1].
void ag_adm_mark_verified(void* h, int64_t seq, const uint8_t* ver,
                          int64_t n) {
  mark_verified_core(static_cast<AdmQ*>(h), seq, ver, n);
}

int64_t ag_adm_depth(void* h) {
  auto* A = static_cast<AdmQ*>(h);
  std::lock_guard<std::mutex> g(A->mu);
  return static_cast<int64_t>(A->q.size());
}

int64_t ag_adm_instance_depth(void* h, int64_t i) {
  auto* A = static_cast<AdmQ*>(h);
  std::lock_guard<std::mutex> g(A->mu);
  if (i < 0 || i >= A->I) return 0;
  return A->inst_counts[static_cast<size_t>(i)];
}

// admission instant of the oldest STAMPED record; NaN when empty or
// when nothing queued is stamped yet.  The front record can
// transiently carry the NaN sentinel while deeper records are stamped
// (submit enqueues, THEN stamps; a racing drain can observe the gap),
// so a front-only read could hand that NaN to MicroBatcher's deadline
// close.  A guarded min over the live records can never surface a
// transient NaN while stamped work is waiting.
double ag_adm_oldest_ts(void* h) {
  return min_stamped_ts(static_cast<AdmQ*>(h));
}

void ag_adm_counters(void* h, int64_t* out7) {
  auto* A = static_cast<AdmQ*>(h);
  std::lock_guard<std::mutex> g(A->mu);
  std::memcpy(out7, A->counters, sizeof(A->counters));
}

// fold a foreign admission outcome into the shared taxonomy —
// submit_bls maps the class-table's reject causes onto these counters
// exactly like the Python queue does.  deltas = [submitted, admitted,
// rejected_overflow, rejected_fairness, rejected_malformed].
void ag_adm_add_counters(void* h, const int64_t* deltas5) {
  auto* A = static_cast<AdmQ*>(h);
  std::lock_guard<std::mutex> g(A->mu);
  for (int k = 0; k < 5; ++k) A->counters[k] += deltas5[k];
}

// drain-and-densify: pop the n oldest records (n <= depth, caller
// sized) straight into the WireColumns arrays — parse semantics are
// unpack_wire_votes' exactly (value rides UNCLAMPED when the nil flag
// is clear; deeper screens stay with the batcher).  out_dig may be
// NULL (dedup off).  Counts `drained`; returns n.
int64_t ag_adm_drain(void* h, int64_t n, int64_t* inst, int64_t* val,
                     int64_t* hts, int64_t* rnd, int64_t* typ,
                     int64_t* value, uint8_t* sigs, uint8_t* ver,
                     uint8_t* out_dig, double* ts) {
  auto* A = static_cast<AdmQ*>(h);
  std::lock_guard<std::mutex> g(A->mu);
  if (n < 0) n = 0;   // hostile caller: never count drained backwards
  if (n > static_cast<int64_t>(A->q.size()))
    n = static_cast<int64_t>(A->q.size());
  for (int64_t k = 0; k < n; ++k) {
    const NRec& r = A->q.front();
    parse_record(r, k, inst, val, hts, rnd, typ, value, sigs, ver,
                 out_dig, ts);
    A->inst_counts[static_cast<size_t>(rec_instance(r.raw))]--;
    A->q.pop_front();
  }
  A->counters[6] += n;
  return n;
}

// FIFO dump of the queued records (raw bytes + verified flags) for the
// model checker's canonical-form differential; writes at most `cap`
// records (the caller sized its buffers from a depth read made OUTSIDE
// this mutex — a concurrent submit may have grown the queue since, and
// an unbounded write would run off the end of those buffers).  Returns
// the count written.
int64_t ag_adm_export(void* h, uint8_t* raw, uint8_t* ver,
                      int64_t cap) {
  auto* A = static_cast<AdmQ*>(h);
  std::lock_guard<std::mutex> g(A->mu);
  int64_t k = 0;
  for (const NRec& r : A->q) {
    if (k >= cap) break;
    std::memcpy(raw + k * kRecSize, r.raw, kRecSize);
    ver[k] = r.verified;
    ++k;
  }
  return k;
}

// BLS class-bucket HEADER screens (BlsClassTable.fold pass 1, minus
// the on-curve decode): per record the FIRST failing screen wins, in
// the fold's order — range (instance/typ) -> unknown validator -> PoP
// missing -> quarantined.  pop_ok/quarantined are the registry's [V]
// masks.  Stateless; codes: 0 ok, 1 malformed, 2 unknown_validator,
// 3 pop_missing, 4 quarantined.  Returns the whole-record count.
int64_t ag_adm_bls_screen(const uint8_t* buf, int64_t nbytes, int64_t I,
                          int64_t V, const uint8_t* pop_ok,
                          const uint8_t* quarantined,
                          uint8_t* out_code) {
  const int64_t n = nbytes / kBlsRecSize;
  for (int64_t k = 0; k < n; ++k) {
    const uint8_t* p = buf + k * kBlsRecSize;
    uint32_t u32;
    std::memcpy(&u32, p + 0, 4);
    const int64_t inst = u32;
    std::memcpy(&u32, p + 4, 4);
    const int64_t v = u32;
    const uint8_t typ = p[20];
    if (inst >= I || typ > 1)
      out_code[k] = 1;
    else if (v >= V)
      out_code[k] = 2;
    else if (!pop_ok[v])
      out_code[k] = 3;
    else if (quarantined[v])
      out_code[k] = 4;
    else
      out_code[k] = 0;
  }
  return n;
}

}  // extern "C"
