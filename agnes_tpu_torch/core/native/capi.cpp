// Flat C ABI over the native core for the ctypes bindings
// (agnes_tpu_torch/core/native.py).  POD structs mirror the Python dataclass
// encodings field-for-field; handles are opaque pointers.

#include <cstdint>
#include <cstring>
#include <vector>

#include "core.hpp"
#include "ed25519.hpp"
#include "sha512.hpp"

extern "C" {

struct AgState {
  int64_t height, round;
  int32_t step;
  int32_t has_locked, has_valid;
  int64_t locked_round, locked_value, valid_round, valid_value;
};

struct AgEvent {
  int32_t tag;
  int32_t has_value;
  int64_t value;
  int64_t pol_round;
};

struct AgMessage {
  int32_t tag;
  int64_t round;
  int64_t p_value, p_pol_round;
  int32_t v_typ, v_has_value;
  int64_t v_value;
  int32_t t_step;
  int64_t d_round, d_value;
};

static void to_cpp(const AgState& in, agnes::State* out) {
  out->height = in.height;
  out->round = in.round;
  out->step = static_cast<agnes::Step>(in.step);
  out->has_locked = in.has_locked != 0;
  out->has_valid = in.has_valid != 0;
  out->locked_round = in.locked_round;
  out->locked_value = in.locked_value;
  out->valid_round = in.valid_round;
  out->valid_value = in.valid_value;
}

static void from_cpp(const agnes::State& in, AgState* out) {
  out->height = in.height;
  out->round = in.round;
  out->step = static_cast<int32_t>(in.step);
  out->has_locked = in.has_locked ? 1 : 0;
  out->has_valid = in.has_valid ? 1 : 0;
  out->locked_round = in.locked_round;
  out->locked_value = in.locked_value;
  out->valid_round = in.valid_round;
  out->valid_value = in.valid_value;
}

void ag_apply(const AgState* s, int64_t round, const AgEvent* e,
              AgState* out_s, AgMessage* out_m) {
  agnes::State st;
  to_cpp(*s, &st);
  agnes::Event ev;
  ev.tag = static_cast<agnes::EventTag>(e->tag);
  ev.has_value = e->has_value != 0;
  ev.value = e->value;
  ev.pol_round = e->pol_round;
  agnes::State ns;
  agnes::Message msg;
  agnes::apply(st, round, ev, &ns, &msg);
  from_cpp(ns, out_s);
  std::memset(out_m, 0, sizeof(*out_m));
  out_m->tag = static_cast<int32_t>(msg.tag);
  out_m->round = msg.round;
  out_m->p_value = msg.p_value;
  out_m->p_pol_round = msg.p_pol_round;
  out_m->v_typ = static_cast<int32_t>(msg.v_typ);
  out_m->v_has_value = msg.v_has_value ? 1 : 0;
  out_m->v_value = msg.v_value;
  out_m->t_step = static_cast<int32_t>(msg.t_step);
  out_m->d_round = msg.d_round;
  out_m->d_value = msg.d_value;
}

// --- tally handle -----------------------------------------------------------

void* ag_tally_new(int64_t height, int64_t round, int64_t total) {
  // hostile negative totals would make is_quorum(0, total) true (an
  // empty tally reporting a quorum); clamp to the empty-set total here
  // so the core keeps exact Python-oracle parity for in-domain inputs
  if (total < 0) total = 0;
  return new agnes::RoundVotes(height, round, total);
}

void ag_tally_free(void* t) {
  delete static_cast<agnes::RoundVotes*>(t);
}

// returns ThreshKind; *thresh_value = value for kind Value, else -1.
// validator/value use -1 as None.
int32_t ag_tally_add(void* t, int32_t typ, int64_t validator, int64_t value,
                     int64_t weight, int64_t* thresh_value) {
  auto* rv = static_cast<agnes::RoundVotes*>(t);
  return static_cast<int32_t>(
      rv->add_vote(static_cast<agnes::VoteType>(typ), validator, value,
                   weight, thresh_value));
}

int64_t ag_tally_skip_weight(void* t) {
  return static_cast<agnes::RoundVotes*>(t)->skip_weight();
}

int64_t ag_tally_equiv_count(void* t) {
  return static_cast<int64_t>(
      static_cast<agnes::RoundVotes*>(t)->equivocations().size());
}

// each evidence row: [round, typ, validator, first_value, second_value];
// returns count written (<= cap)
int64_t ag_tally_equivocations(void* t, int64_t* out, int64_t cap) {
  const auto& eq = static_cast<agnes::RoundVotes*>(t)->equivocations();
  int64_t n = 0;
  for (const auto& e : eq) {
    if (n >= cap) break;
    out[5 * n + 0] = e.round;
    out[5 * n + 1] = static_cast<int64_t>(e.typ);
    out[5 * n + 2] = e.validator;
    out[5 * n + 3] = e.first_value;
    out[5 * n + 4] = e.second_value;
    ++n;
  }
  return n;
}

// --- validator set ----------------------------------------------------------

// vals: n rows of (32 pubkey bytes, int64 power) packed as 40-byte rows
void* ag_valset_new(const uint8_t* packed, int64_t n) {
  std::vector<agnes::Validator> vals(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(vals[i].public_key, packed + 40 * i, 32);
    int64_t p = 0;
    std::memcpy(&p, packed + 40 * i + 32, 8);
    vals[i].voting_power = p;
  }
  return new agnes::ValidatorSet(std::move(vals));
}

void ag_valset_free(void* v) {
  delete static_cast<agnes::ValidatorSet*>(v);
}

int64_t ag_valset_len(void* v) {
  return static_cast<int64_t>(
      static_cast<agnes::ValidatorSet*>(v)->validators().size());
}

int64_t ag_valset_total_power(void* v) {
  return static_cast<agnes::ValidatorSet*>(v)->total_power();
}

int64_t ag_valset_index_of(void* v, const uint8_t* pk) {
  return static_cast<agnes::ValidatorSet*>(v)->index_of(pk);
}

void* ag_rotation_new(void* valset) {
  return new agnes::ProposerRotation(
      static_cast<agnes::ValidatorSet*>(valset));
}

void ag_rotation_free(void* r) {
  delete static_cast<agnes::ProposerRotation*>(r);
}

int64_t ag_rotation_step(void* r) {
  return static_cast<agnes::ProposerRotation*>(r)->step();
}

void ag_valset_hash(void* v, uint8_t* out32) {
  static_cast<agnes::ValidatorSet*>(v)->hash(out32);
}

// row i of out: (pubkey 32B, power int64) — sorted order
void ag_valset_get(void* v, uint8_t* packed_out) {
  const auto& vals = static_cast<agnes::ValidatorSet*>(v)->validators();
  for (size_t i = 0; i < vals.size(); ++i) {
    std::memcpy(packed_out + 40 * i, vals[i].public_key, 32);
    std::memcpy(packed_out + 40 * i + 32, &vals[i].voting_power, 8);
  }
}

int32_t ag_valset_update(void* v, const uint8_t* pk, int64_t power) {
  agnes::Validator val;
  std::memcpy(val.public_key, pk, 32);
  val.voting_power = power;
  return static_cast<agnes::ValidatorSet*>(v)->update(val) ? 1 : 0;
}

void ag_valset_add(void* v, const uint8_t* pk, int64_t power) {
  agnes::Validator val;
  std::memcpy(val.public_key, pk, 32);
  val.voting_power = power;
  static_cast<agnes::ValidatorSet*>(v)->add(val);
}

int32_t ag_valset_remove(void* v, const uint8_t* pk) {
  return static_cast<agnes::ValidatorSet*>(v)->remove(pk) ? 1 : 0;
}

// --- crypto -----------------------------------------------------------------

void ag_sha512(const uint8_t* data, int64_t n, uint8_t* out64) {
  agnes::sha512(data, static_cast<size_t>(n), out64);
}

void ag_ed25519_pubkey(const uint8_t* seed, uint8_t* out_pk) {
  agnes::ed25519_pubkey(seed, out_pk);
}

void ag_ed25519_sign(const uint8_t* seed, const uint8_t* msg, int64_t n,
                     uint8_t* out_sig) {
  agnes::ed25519_sign(seed, msg, static_cast<uint64_t>(n), out_sig);
}

int32_t ag_ed25519_verify(const uint8_t* pk, const uint8_t* msg, int64_t n,
                          const uint8_t* sig) {
  return agnes::ed25519_verify(pk, msg, static_cast<uint64_t>(n), sig) ? 1
                                                                       : 0;
}

// batch verify: fixed-length messages, contiguous arrays
void ag_ed25519_verify_batch(const uint8_t* pks, const uint8_t* sigs,
                             const uint8_t* msgs, int64_t msg_len,
                             int64_t count, uint8_t* out_ok) {
  for (int64_t i = 0; i < count; ++i) {
    out_ok[i] = agnes::ed25519_verify(
                    pks + 32 * i, msgs + msg_len * i,
                    static_cast<uint64_t>(msg_len), sigs + 64 * i)
                    ? 1
                    : 0;
  }
}

}  // extern "C"
