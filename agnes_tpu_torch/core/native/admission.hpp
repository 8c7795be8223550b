// Shared internals of the native admission plane (the port's copy of
// the JAX package's core/native/admission.hpp).
//
// The single queue (admission.cpp), the sharded front end
// (admission_shards.cpp) and the zero-copy densify drain
// (admission_phases.cpp) share the record/queue structures and the
// exact submit/drain arithmetic declared here.  admission.cpp holds the
// single-queue C ABI; this header is internal to core/native and is
// NOT part of the C ABI surface.
//
// Ordering contract (new with sharding): every AdmQ deque is sorted by
// (seq, sub_idx).  A single queue gets this for free — seq allocation
// and push share the handle mutex — but the shard group allocates seq
// from a group-level atomic OUTSIDE any shard mutex, so two racing
// submits can reach the same shard out of seq order.  submit_records
// therefore inserts at the sorted position (a no-op push_back in the
// common monotone case).  The sorted deque is what makes the group's
// k-way merge drain a faithful replay of the single-queue stream, and
// is what the back-walking set_chunk_ts / mark_verified cores rely on
// to stop early.

#pragma once

#include <cstdint>
#include <cstring>
#include <deque>
#include <limits>
#include <mutex>
#include <vector>

namespace agnes_adm {

constexpr int kRecSize = 96;       // the packed Ed25519 wire record
constexpr int kBlsRecSize = 224;   // 32B header + 192B G2 share

struct NRec {
  uint8_t raw[kRecSize];
  uint8_t digest[32];
  double ts;                       // admission instant (caller clock)
  int64_t seq;                     // submit id (mark_verified target)
  int64_t sub_idx;                 // record index within its submit —
                                   // (seq, sub_idx) is the global
                                   // arrival order across shards
  uint8_t verified;                // dedup-cache pre-verified flag
};

struct AdmQ {
  int64_t I, capacity, instance_cap;
  int32_t policy;                  // 0 reject_newest, 1 drop_oldest
  bool digests;                    // hash admitted records (cache on)

  std::mutex mu;
  std::deque<NRec> q;              // sorted by (seq, sub_idx)
  std::vector<int64_t> inst_counts;   // [I] queue occupancy
  // per-submit rank scratch, epoch-stamped so a submit never pays an
  // O(I) clear (the ingest.cpp cell_epoch idiom)
  std::vector<int64_t> seen;
  std::vector<uint64_t> seen_epoch;
  uint64_t epoch = 0;
  int64_t next_seq = 0;

  // counters, AdmissionQueue.counters order:
  // [submitted, admitted, rejected_overflow, rejected_fairness,
  //  rejected_malformed, evicted, drained]
  int64_t counters[7] = {0, 0, 0, 0, 0, 0, 0};
};

inline int64_t rec_instance(const uint8_t* p) {
  uint32_t u32;
  std::memcpy(&u32, p, 4);
  return static_cast<int64_t>(u32);
}

// pop the n oldest records (n <= q.size()), updating occupancy; the
// Python _pop's count_drained flag is the caller's job.  Caller holds
// A->mu.
void pop_front(AdmQ* A, int64_t n);

// The admission screens + enqueue over a SELECTION of a wire buffer:
// rec_idx[n_rec] are the whole-record indices this queue owns (NULL
// means the identity 0..n_rec-1 — the single-queue path).  Locks
// A->mu for its whole span.  `tail_malformed` seeds the malformed
// count (the buffer's trailing partial record, charged to the routing
// shard).  `seq` < 0 allocates ++A->next_seq under the mutex (single
// queue); >= 0 uses the caller's id (the shard group's atomic).
//
// out_counts = [accepted, rejected_overflow, rejected_fairness,
// rejected_malformed, evicted].  out_digests (may be NULL) receives
// the SHA-256 of each ADMITTED record, compact in THIS queue's
// admission order.  out_kept (may be NULL, else sized n_rec) gets a
// 0/1 admitted flag per rec_idx position so a fan-in caller can
// gather digests back into global admission order.  Returns seq.
int64_t submit_records(AdmQ* A, const uint8_t* buf,
                       const int64_t* rec_idx, int64_t n_rec,
                       int64_t tail_malformed, int64_t seq,
                       int64_t* out_counts, uint8_t* out_digests,
                       uint8_t* out_kept);

// back-walking cores of ag_adm_set_chunk_ts / ag_adm_mark_verified;
// each locks A->mu.  `ver` is the verified mask over THIS queue's
// records of submit `seq`, in its admission order.
void set_chunk_ts_core(AdmQ* A, int64_t seq, double ts);
void mark_verified_core(AdmQ* A, int64_t seq, const uint8_t* ver,
                        int64_t n);

// guarded oldest-timestamp scan: the front record can still carry the
// NaN "unstamped" sentinel while deeper records are stamped (submit
// stamps AFTER enqueue, and a racing drain may interleave), so the
// deadline closer needs the min over the STAMPED records, not the
// front.  Returns NaN only when no queued record is stamped.  Locks
// A->mu.
double min_stamped_ts(AdmQ* A);

// parse one queued record into the WireColumns scalars — semantics
// are unpack_wire_votes' exactly (value rides UNCLAMPED when the nil
// flag is clear; deeper screens stay with the batcher)
inline void parse_record(const NRec& r, int64_t k, int64_t* inst,
                         int64_t* val, int64_t* hts, int64_t* rnd,
                         int64_t* typ, int64_t* value, uint8_t* sigs,
                         uint8_t* ver, uint8_t* out_dig, double* ts) {
  const uint8_t* p = r.raw;
  uint32_t u32;
  std::memcpy(&u32, p + 0, 4);
  inst[k] = u32;
  std::memcpy(&u32, p + 4, 4);
  val[k] = u32;
  std::memcpy(&hts[k], p + 8, 8);
  int32_t i32;
  std::memcpy(&i32, p + 16, 4);
  rnd[k] = i32;
  typ[k] = p[20];
  // nil flag: ANY nonzero byte is non-nil (unpack_wire_votes'
  // `rec[:, 21] != 0` — not bit0; a hostile flag byte of 2 must
  // drain identically on both implementations)
  if (p[21])
    std::memcpy(&value[k], p + 24, 8);
  else
    value[k] = -1;
  std::memcpy(sigs + 64 * k, p + 32, 64);
  ver[k] = r.verified;
  if (out_dig) std::memcpy(out_dig + 32 * k, r.digest, 32);
  ts[k] = r.ts;
}

// Zero-copy densify over popped rows (admission_phases.cpp): fills the
// per-phase slot/mask planes and the SignedLanes arrays that
// VoteBatcher.build_phases_device would have produced, IFF the rows
// are device-verify eligible by the batcher's exact rules; bails
// (returns 0) to the Python path otherwise.  Plain columns must
// already be parsed (parse_record) — densify reads them, it never
// re-reads raw bytes except signatures/pubkeys for the lane blocks.
struct PhaseIn {
  const int64_t* heights;     // [I] batcher window heights
  const int64_t* base_round;  // [I]
  int64_t W;                  // window rounds
  const int64_t* slot_lut;    // [I*S] dense SlotMap export as the
                              // window will hold it, -1 empty
  int64_t S;                  // slots per instance
  int64_t V;                  // validators
  const uint8_t* pubkeys;     // [V*32]
  int64_t I;
  int64_t lane_floor;         // pad floor (the port's serve passes 0)
  int64_t max_votes;          // ladder.max_rung (defer threshold)
  int64_t phase_offset;
  int64_t pad_cap;            // allocated lane rows
};

struct PhaseOut {
  int32_t* slots;       // [2*I*V], plane-major; used planes filled
  uint8_t* mask;        // [2*I*V]
  int64_t* ph_typ;      // [2]
  int64_t* ph_counts;   // [2]
  int32_t* ln_pub;      // [pad_cap*32]
  int32_t* ln_sig;      // [pad_cap*64]
  uint32_t* ln_blocks;  // [pad_cap*32] big-endian SHA-512 words
  int32_t* ln_phase_idx;  // [pad_cap]
  int32_t* ln_inst;     // [pad_cap]
  int32_t* ln_val;      // [pad_cap]
  uint8_t* ln_real;     // [pad_cap]
  int64_t* ln_rows;     // [n] lane -> drained-row permutation (the
                        //     Python build's phase-grouped cat order;
                        //     the adopter's last_build_keys gather)
  int64_t* meta;        // [status, n_phases, n_lanes, n_pad, round]
};

int densify_phases(const std::vector<NRec>& rows, const int64_t* inst,
                   const int64_t* val, const int64_t* hts,
                   const int64_t* rnd, const int64_t* typ,
                   const int64_t* value, const uint8_t* ver,
                   const PhaseIn& in, const PhaseOut& out);

}  // namespace agnes_adm
