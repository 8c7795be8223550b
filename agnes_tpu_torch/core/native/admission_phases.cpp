// Zero-copy native densify (the port's copy of the JAX package's
// core/native/admission_phases.cpp; the C ABI is the same): drain the
// admission queue STRAIGHT into the per-phase arrays that
// VoteBatcher.build_phases_device would have produced — slot/mask
// planes per (round, typ) phase plus the SignedLanes columns (widened
// pubkeys/signatures, pre-packed SHA-512 message blocks, phase ids,
// the real-lane mask) — behind the same single GIL-releasing call as
// the plain drain.  The Python side then only uploads the buffers and
// dispatches: no per-record Python work between submit and dispatch.
//
// Conformance discipline: this is a CONSERVATIVE SUBSET of the Python
// build.  densify_phases fills the phase outputs only when the popped
// rows are provably device-verify eligible by the batcher's exact
// rules (_device_verify_eligible + the add_arrays screens reduced to
// the no-drop case):
//
//   - 0 < n <= max_votes            (no _defer_pending split)
//   - every row unverified          (split-rung stays a Python seam)
//   - validator/typ/value in range  (no malformed drops)
//   - height == window height       (no stale-height drops)
//   - 0 <= round - base < W         (no held/past splits)
//   - ONE round across the batch    (the device fast path)
//   - unique (typ, instance, validator) cells
//   - <= 1 distinct non-nil value per instance, and that value either
//     interned in the slot LUT or given the row's first free slot
//     (SlotMap.slot_for's allocation); a full row bails, because the
//     Python path spills such votes to the host tally
//
// Any violation returns status 0 with the plain columns still filled —
// the wrapper hands them to VoteBatcher.add_arrays and the Python path
// handles the screens/splits it owns.  Because the eligible set is
// exactly the set where the Python build drops nothing, splits
// nothing, spills nothing, and takes the single-round fast path, the
// native fill is leaf-for-leaf identical to what Python would emit
// (tests/test_torch_native_admission.py).
//
// Two departures from the JAX package's copy, both in densify_phases:
//   - lanes are not rounded up to a power of two: n_pad = max(n,
//     lane_floor), the port's build_phases_device rule (its serve
//     passes a floor of 0, so a padding lane never costs a verify);
//   - a value that is not yet in the LUT takes the row's first free
//     slot instead of bailing.  The caller hands the LUT as the window
//     will hold it (rows of instances whose height advances are
//     empty), and the adopter interns the same (instance, value) pairs
//     in its SlotMap, so a height's first batch fills too.
//
// Lock discipline: rows are popped under the queue mutex and densified
// OUTSIDE it — the [2,I,V] plane fills and per-lane block packing must
// not extend the submit thread's critical section.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <mutex>
#include <vector>

#include "admission.hpp"

namespace agnes_adm {

namespace {

constexpr int64_t kMaxRound = (int64_t{1} << 31) - 1;    // types.MAX_ROUND
constexpr int64_t kMaxValueId = (int64_t{1} << 31) - 1;  // value_table
constexpr int32_t kVotedNil = -1;                        // tally.VOTED_NIL
constexpr int64_t kMsgLen = 45;                          // VOTE_MSG_LEN

// pack one lane's 128-byte SHA-512 block — byte-for-byte the
// _sha_blocks_np layout: R || A || msg || 0x80 pad || bitlen(872)
void pack_block(const uint8_t* sig_r, const uint8_t* pubkey,
                int64_t typ, int64_t height, int64_t rnd, int64_t value,
                uint32_t* out32) {
  uint8_t buf[128];
  std::memset(buf, 0, sizeof(buf));
  std::memcpy(buf + 0, sig_r, 32);      // R (signature first half)
  std::memcpy(buf + 32, pubkey, 32);    // A (validator pubkey)
  uint8_t* msg = buf + 64;              // 45-byte vote message
  msg[0] = static_cast<uint8_t>(typ & 0xFF);
  const uint64_t h64 = static_cast<uint64_t>(height);
  for (int b = 0; b < 8; ++b)
    msg[1 + b] = static_cast<uint8_t>((h64 >> (8 * b)) & 0xFF);
  const uint32_t r32 = static_cast<uint32_t>(static_cast<int64_t>(rnd));
  for (int b = 0; b < 4; ++b)
    msg[9 + b] = static_cast<uint8_t>((r32 >> (8 * b)) & 0xFF);
  if (value < 0) {
    // nil vote: the value field AND the spare bytes carry 0xFF
    std::memset(msg + 13, 0xFF, kMsgLen - 13);
  } else {
    const uint64_t v64 = static_cast<uint64_t>(value);
    for (int b = 0; b < 8; ++b)
      msg[13 + b] = static_cast<uint8_t>((v64 >> (8 * b)) & 0xFF);
    // msg[21:45] stay zero
  }
  buf[64 + kMsgLen] = 0x80;             // SHA-512 pad start (byte 109)
  buf[126] = 0x03;                      // bit length 872 = 0x368,
  buf[127] = 0x68;                      // big-endian u64 tail
  for (int w = 0; w < 32; ++w)          // big-endian u32 words
    out32[w] = (static_cast<uint32_t>(buf[4 * w]) << 24) |
               (static_cast<uint32_t>(buf[4 * w + 1]) << 16) |
               (static_cast<uint32_t>(buf[4 * w + 2]) << 8) |
               static_cast<uint32_t>(buf[4 * w + 3]);
}

}  // namespace

int densify_phases(const std::vector<NRec>& rows, const int64_t* inst,
                   const int64_t* val, const int64_t* hts,
                   const int64_t* rnd, const int64_t* typ,
                   const int64_t* value, const uint8_t* ver,
                   const PhaseIn& in, const PhaseOut& out) {
  const int64_t n = static_cast<int64_t>(rows.size());
  out.meta[0] = 0;
  out.meta[1] = 0;
  out.meta[2] = 0;
  out.meta[3] = 0;
  out.meta[4] = -1;
  if (n <= 0 || n > in.max_votes) return 0;

  // eligibility pass: screens + the single-round / single-value /
  // known-slot device-verify conditions.  ival memoizes the one
  // non-nil value allowed per instance; islot its interned slot.
  const int64_t r0 = rnd[0];
  if (r0 < 0 || r0 > kMaxRound) return 0;
  std::vector<int64_t> ival(static_cast<size_t>(in.I),
                            std::numeric_limits<int64_t>::min());
  std::vector<int32_t> islot(static_cast<size_t>(in.I), -1);
  bool has_typ[2] = {false, false};
  for (int64_t k = 0; k < n; ++k) {
    if (ver[k]) return 0;                    // pre-verified: Python splits
    const int64_t i = inst[k];
    if (i < 0 || i >= in.I) return 0;        // (queue already screened)
    if (val[k] < 0 || val[k] >= in.V) return 0;
    if (typ[k] < 0 || typ[k] > 1) return 0;
    if (rnd[k] != r0) return 0;              // multi-round: Python path
    if (value[k] > kMaxValueId) return 0;
    if (hts[k] != in.heights[i]) return 0;   // stale: Python drops
    const int64_t w = r0 - in.base_round[i];
    if (w < 0 || w >= in.W) return 0;        // past/held: Python splits
    has_typ[static_cast<size_t>(typ[k])] = true;
    if (value[k] >= 0) {
      const size_t si = static_cast<size_t>(i);
      if (ival[si] == std::numeric_limits<int64_t>::min()) {
        ival[si] = value[k];
        // dense SlotMap lookup: the interned slot, else the row's
        // first free one (where SlotMap.slot_for would intern it)
        const int64_t* lut = in.slot_lut + i * in.S;
        int32_t s = -1;
        for (int64_t j = 0; j < in.S; ++j)
          if (lut[j] == value[k]) { s = static_cast<int32_t>(j); break; }
        for (int64_t j = 0; s < 0 && j < in.S; ++j)
          if (lut[j] == -1) s = static_cast<int32_t>(j);
        if (s < 0) return 0;                 // row full: the Python path
        islot[si] = s;                       // spills to the host tally
      } else if (ival[si] != value[k]) {
        return 0;                            // >1 value: device-ineligible
      }
    }
  }

  // phase planes in the Python class order: PREVOTE then PRECOMMIT
  int64_t p_of_typ[2] = {-1, -1};
  int64_t n_phases = 0;
  for (int t = 0; t < 2; ++t)
    if (has_typ[t]) p_of_typ[t] = n_phases++;
  const int64_t plane = in.I * in.V;
  for (int64_t p = 0; p < n_phases; ++p) {
    int32_t* s = out.slots + p * plane;
    for (int64_t c = 0; c < plane; ++c) s[c] = kVotedNil;
    std::memset(out.mask + p * plane, 0, static_cast<size_t>(plane));
    out.ph_counts[p] = 0;
  }
  out.ph_typ[0] = p_of_typ[0] == 0 ? 0 : 1;
  if (n_phases == 2) out.ph_typ[1] = 1;

  // scatter + duplicate-cell screen (the mask doubles as the dedup
  // bitmap — a set bit on arrival means the cell repeats, which is
  // device-ineligible, so bail to Python)
  const int64_t n_pad_floor = in.lane_floor;
  for (int64_t k = 0; k < n; ++k) {
    const int64_t p = p_of_typ[static_cast<size_t>(typ[k])];
    const int64_t cell = inst[k] * in.V + val[k];
    uint8_t* m = out.mask + p * plane + cell;
    if (*m) return 0;
    *m = 1;
    out.slots[p * plane + cell] =
        value[k] < 0 ? kVotedNil : islot[static_cast<size_t>(inst[k])];
    out.ph_counts[p]++;
  }

  // lane count: exact, floored at lane_floor (build_phases_device's
  // max(n, lane_floor); no power-of-two rounding)
  const int64_t n_pad = n < n_pad_floor ? n_pad_floor : n;
  if (n_pad > in.pad_cap) return 0;          // caller under-allocated

  // the Python build concatenates lanes PER PHASE GROUP (cat =
  // _concat(groups)): all PREVOTE rows in arrival order, then all
  // PRECOMMIT rows — phase_idx is contiguous ascending blocks.
  // ln_rows records that lane -> drained-row permutation so the
  // adopter can gather digest/instance/height cache keys in cat
  // order.  Pads are copies of LANE 0 (the first row of the first
  // phase group) pointed at the one-past-the-end phase id.
  {
    int64_t j = 0;
    for (int t = 0; t < 2; ++t) {
      if (!has_typ[t]) continue;
      for (int64_t k = 0; k < n; ++k)
        if (typ[k] == t) out.ln_rows[j++] = k;
    }
  }
  for (int64_t j = 0; j < n_pad; ++j) {
    const int64_t k = out.ln_rows[j < n ? j : 0];
    const NRec& r = rows[static_cast<size_t>(k)];
    const uint8_t* pk = in.pubkeys + val[k] * 32;
    for (int b = 0; b < 32; ++b)
      out.ln_pub[j * 32 + b] = static_cast<int32_t>(pk[b]);
    const uint8_t* sg = r.raw + 32;
    for (int b = 0; b < 64; ++b)
      out.ln_sig[j * 64 + b] = static_cast<int32_t>(sg[b]);
    pack_block(sg, pk, typ[k], hts[k], rnd[k], value[k],
               out.ln_blocks + j * 32);
    out.ln_inst[j] = static_cast<int32_t>(inst[k]);
    out.ln_val[j] = static_cast<int32_t>(val[k]);
    if (j < n) {
      out.ln_phase_idx[j] = static_cast<int32_t>(
          p_of_typ[static_cast<size_t>(typ[k])] + in.phase_offset);
      out.ln_real[j] = 1;
    } else {
      out.ln_phase_idx[j] =
          static_cast<int32_t>(in.phase_offset + n_phases);
      out.ln_real[j] = 0;
    }
  }

  out.meta[0] = 1;
  out.meta[1] = n_phases;
  out.meta[2] = n;
  out.meta[3] = n_pad;
  out.meta[4] = r0;
  return 1;
}

}  // namespace agnes_adm

using namespace agnes_adm;

extern "C" {

// drain-and-densify-to-phases: the plain ag_adm_drain columns are
// ALWAYS filled for the popped records (the Python fallback and the
// evidence log need them either way); when the rows are device-verify
// eligible the phase/lane buffers are filled too and out_meta[0] = 1.
// out_meta = [status, n_phases, n_lanes, n_pad, round].  Rows are
// popped under the queue mutex; parsing and densify run outside it.
// Returns the popped count.
int64_t ag_adm_drain_phases(
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
  auto* A = static_cast<AdmQ*>(h);
  std::vector<NRec> rows;
  {
    std::lock_guard<std::mutex> g(A->mu);
    if (n < 0) n = 0;
    if (n > static_cast<int64_t>(A->q.size()))
      n = static_cast<int64_t>(A->q.size());
    rows.reserve(static_cast<size_t>(n));
    for (int64_t k = 0; k < n; ++k) {
      rows.push_back(A->q.front());
      A->inst_counts[static_cast<size_t>(
          rec_instance(A->q.front().raw))]--;
      A->q.pop_front();
    }
    A->counters[6] += n;
  }
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
  in.I = A->I;
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

}  // extern "C"
