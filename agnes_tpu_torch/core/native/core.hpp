// Native (C++) consensus core: domain types, the pure Tendermint state
// machine, and the per-round vote tally.
//
// Semantic parity contract: this is a third implementation of the same
// machine as agnes_tpu_torch/core/state_machine.py (the Python oracle)
// and agnes_tpu_torch/device/state_machine.py (the torch plane), all
// reproducing
// the reference's transition table (reference src/state_machine.rs:
// 183-214) with the documented subtleties (lock rule :239-244,
// commit-from-any-round :211, no-step-change timeouts :287-295).
// The tally applies the SURVEY.md §2.3 fixes (per-value buckets,
// per-validator dedup + equivocation evidence) on top of the
// reference's quorum semantics (round_votes.rs:31-33, :58-66).
// Differential tests: tests/test_torch_native_core.py sweeps this
// against the Python oracle over the full Step x Event x guard space.

#pragma once

#include <cstdint>
#include <map>
#include <set>
#include <vector>

namespace agnes {

// integer codes shared verbatim with core/state_machine.py and
// device/encoding.py
enum class Step : int32_t {
  NewRound = 0, Propose = 1, Prevote = 2, Precommit = 3, Commit = 4
};

enum class EventTag : int32_t {
  NewRound = 0, NewRoundProposer = 1, Proposal = 2, ProposalInvalid = 3,
  PolkaAny = 4, PolkaNil = 5, PolkaValue = 6, PrecommitAny = 7,
  PrecommitValue = 8, RoundSkip = 9, TimeoutPropose = 10,
  TimeoutPrevote = 11, TimeoutPrecommit = 12
};

enum class TimeoutStep : int32_t { Propose = 0, Prevote = 1, Precommit = 2 };

enum class MsgTag : int32_t {
  None = 0, NewRound = 1, Proposal = 2, Vote = 3, Timeout = 4, Decision = 5
};

enum class VoteType : int32_t { Prevote = 0, Precommit = 1 };

constexpr int64_t kNoValue = -1;  // Option::None for value/round fields

struct State {
  int64_t height = 0;
  int64_t round = 0;
  Step step = Step::NewRound;
  bool has_locked = false, has_valid = false;
  int64_t locked_round = kNoValue, locked_value = kNoValue;
  int64_t valid_round = kNoValue, valid_value = kNoValue;
};

struct Event {
  EventTag tag;
  bool has_value = false;
  int64_t value = kNoValue;
  int64_t pol_round = -1;
};

struct Message {
  MsgTag tag = MsgTag::None;
  int64_t round = 0;
  // proposal payload (round = .round)
  int64_t p_value = kNoValue;
  int64_t p_pol_round = -1;
  // vote payload
  VoteType v_typ = VoteType::Prevote;
  bool v_has_value = false;
  int64_t v_value = kNoValue;
  // timeout payload
  TimeoutStep t_step = TimeoutStep::Propose;
  // decision payload
  int64_t d_round = 0, d_value = kNoValue;
};

// the pure transition function (reference state_machine.rs:183-214)
void apply(const State& s, int64_t round, const Event& e,
           State* out_state, Message* out_msg);

// --- vote tally (reference round_votes.rs + SURVEY §2.3 fixes) -------------

enum class ThreshKind : int32_t { Init = 0, Any = 1, Nil = 2, Value = 3 };

// 128-bit products: the raw C ABI accepts arbitrary int64 weights, so
// 3*v / 2*total must not overflow (reference round_votes.rs:31-33 is
// safe only because Rust debug builds trap; here hostile callers reach
// this directly through capi.cpp)
inline bool is_quorum(int64_t v, int64_t total) {
  return static_cast<__int128>(3) * v > static_cast<__int128>(2) * total;
}
inline bool is_one_third(int64_t v, int64_t total) {
  return static_cast<__int128>(3) * v > static_cast<__int128>(total);
}

// framework rounds domain top (types.py MAX_ROUND): round arithmetic
// saturates here on every plane so the int64 host cores and the int32
// device plane stay bit-for-bit at the representable edge
constexpr int64_t kMaxRound = 2147483647;  // 2^31 - 1

// saturating accumulate for weight tallies: hostile extreme weights
// clamp instead of wrapping (wrap could un-cross a crossed quorum)
inline int64_t sat_add(int64_t a, int64_t b) {
  __int128 s = static_cast<__int128>(a) + b;
  if (s > INT64_MAX) return INT64_MAX;
  if (s < INT64_MIN) return INT64_MIN;
  return static_cast<int64_t>(s);
}
inline int64_t sat_sub(int64_t a, int64_t b) {
  __int128 s = static_cast<__int128>(a) - b;
  if (s > INT64_MAX) return INT64_MAX;
  if (s < INT64_MIN) return INT64_MIN;
  return static_cast<int64_t>(s);
}

struct Equivocation {
  int64_t height, round;
  VoteType typ;
  int64_t validator;
  int64_t first_value, second_value;  // kNoValue = nil
};

class VoteCount {
 public:
  explicit VoteCount(int64_t total) : total_(total) {}

  // add weight for value (kNoValue = nil); returns highest threshold,
  // priority Value > Nil > Any > Init (round_votes.rs:58-66)
  ThreshKind add(int64_t value, int64_t weight, int64_t* thresh_value);
  ThreshKind thresh(int64_t* thresh_value) const;

  int64_t seen_weight() const;

 private:
  int64_t total_;
  int64_t nil_ = 0;
  std::map<int64_t, int64_t> weights_;
};

class RoundVotes {
 public:
  RoundVotes(int64_t height, int64_t round, int64_t total)
      : height_(height), round_(round), total_(total),
        prevotes_(total), precommits_(total) {}

  // validator = kNoValue for identity-free votes (no dedup, reference
  // parity); value = kNoValue for nil
  ThreshKind add_vote(VoteType typ, int64_t validator, int64_t value,
                      int64_t weight, int64_t* thresh_value);

  int64_t skip_weight() const;
  const std::vector<Equivocation>& equivocations() const { return equiv_; }

 private:
  int64_t height_, round_, total_;
  VoteCount prevotes_, precommits_;
  // (validator, typ) -> (value, weight) of the first counted vote
  std::map<std::pair<int64_t, int32_t>, std::pair<int64_t, int64_t>> seen_;
  std::set<std::pair<int64_t, int32_t>> flagged_;
  int64_t anon_weight_[2] = {0, 0};
  std::vector<Equivocation> equiv_;
};

// --- validator set (reference validators.rs intent, §2.6) ------------------

struct Validator {
  uint8_t public_key[32];
  int64_t voting_power;
};

class ValidatorSet {
 public:
  // sorted by address (= public key, validators.rs:15-17), deduplicated
  explicit ValidatorSet(std::vector<Validator> vals);

  void add(const Validator& v);
  bool update(const Validator& v);   // by pubkey; true if found
  bool remove(const uint8_t pk[32]);

  int64_t total_power() const;
  const std::vector<Validator>& validators() const { return vals_; }
  // index of pubkey in sorted order, -1 if absent
  int64_t index_of(const uint8_t pk[32]) const;
  // 32-byte hash of the set (SHA-512/256 of the sorted entries)
  void hash(uint8_t out[32]) const;

 private:
  void sort_dedup();
  std::vector<Validator> vals_;
};

// Tendermint-style weighted round-robin proposer selection — the exact
// algorithm of core/validators.py ProposerRotation (one shared
// sequence feeds the host planes and the device proposer table, so the
// implementations MUST agree; tests/test_torch_native_core.py checks the
// sequences match step for step).  Stateful: call step() once per
// (height, round) in order.  Holds a non-owning pointer to the set.
class ProposerRotation {
 public:
  explicit ProposerRotation(const ValidatorSet* set) : set_(set) {}

  // advance one slot; returns the proposer's index in the current
  // address-sorted set
  int64_t step();

 private:
  const ValidatorSet* set_;
  std::map<std::vector<uint8_t>, int64_t> priorities_;  // by address
};

}  // namespace agnes
