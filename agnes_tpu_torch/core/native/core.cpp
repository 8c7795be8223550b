// Implementation of the native consensus core.  See core.hpp for the
// parity contract and reference citations.

#include "core.hpp"

#include <algorithm>
#include <cstring>

#include "sha512.hpp"

namespace agnes {

namespace {

Step next_step(Step s) {
  switch (s) {
    case Step::NewRound: return Step::Propose;
    case Step::Propose: return Step::Prevote;
    case Step::Prevote: return Step::Precommit;
    default: return s;  // saturates (state_machine.rs:58-66)
  }
}

Message msg_new_round(int64_t r) {
  Message m; m.tag = MsgTag::NewRound; m.round = r; return m;
}

Message msg_proposal(int64_t r, int64_t value, int64_t pol_round) {
  Message m; m.tag = MsgTag::Proposal; m.round = r;
  m.p_value = value; m.p_pol_round = pol_round; return m;
}

Message msg_vote(VoteType t, int64_t r, bool has_value, int64_t value) {
  Message m; m.tag = MsgTag::Vote; m.round = r;
  m.v_typ = t; m.v_has_value = has_value;
  m.v_value = has_value ? value : kNoValue; return m;
}

Message msg_timeout(int64_t r, TimeoutStep st) {
  Message m; m.tag = MsgTag::Timeout; m.round = r; m.t_step = st; return m;
}

Message msg_decision(int64_t r, int64_t value) {
  Message m; m.tag = MsgTag::Decision; m.round = r;
  m.d_round = r; m.d_value = value; return m;
}

}  // namespace

// the transition actions (reference state_machine.rs:216-322)

static void propose(State s, int64_t v, State* os, Message* om) {
  s.step = next_step(s.step);
  int64_t value = v, pol_round = -1;
  if (s.has_valid) { value = s.valid_value; pol_round = s.valid_round; }
  *os = s; *om = msg_proposal(s.round, value, pol_round);     // spec 11/14
}

static void prevote(State s, int64_t vr, int64_t proposed, State* os,
                    Message* om) {
  s.step = next_step(s.step);
  // lock rule (state_machine.rs:239-244, spec 22/28)
  bool vote_value;
  if (!s.has_locked) vote_value = true;                // not locked
  else if (s.locked_round <= vr) vote_value = true;    // unlock
  else if (s.locked_value == proposed) vote_value = true;  // same value
  else vote_value = false;                             // locked elsewhere: nil
  *os = s;
  *om = msg_vote(VoteType::Prevote, s.round, vote_value, proposed);
}

static void prevote_nil(State s, State* os, Message* om) {
  s.step = next_step(s.step);
  *os = s; *om = msg_vote(VoteType::Prevote, s.round, false, kNoValue);
}

static void precommit(State s, int64_t v, State* os, Message* om) {
  // sets BOTH locked and valid (state_machine.rs:261-264, spec 36)
  s.has_locked = true; s.locked_round = s.round; s.locked_value = v;
  s.has_valid = true; s.valid_round = s.round; s.valid_value = v;
  s.step = next_step(s.step);
  *os = s; *om = msg_vote(VoteType::Precommit, s.round, true, v);
}

static void precommit_nil(State s, State* os, Message* om) {
  s.step = next_step(s.step);
  *os = s; *om = msg_vote(VoteType::Precommit, s.round, false, kNoValue);
}

static void schedule_timeout_propose(State s, State* os, Message* om) {
  s.step = next_step(s.step);
  *os = s; *om = msg_timeout(s.round, TimeoutStep::Propose);
}

static void schedule_timeout_prevote(const State& s, State* os, Message* om) {
  // no step change (state_machine.rs:287-289)
  *os = s; *om = msg_timeout(s.round, TimeoutStep::Prevote);
}

static void schedule_timeout_precommit(const State& s, State* os,
                                       Message* om) {
  // no step change (state_machine.rs:293-295)
  *os = s; *om = msg_timeout(s.round, TimeoutStep::Precommit);
}

static void set_valid_value(State s, int64_t v, State* os, Message* om) {
  // only valid, no message (state_machine.rs:304-306, spec 36/42)
  s.has_valid = true; s.valid_round = s.round; s.valid_value = v;
  *os = s; om->tag = MsgTag::None;
}

static void round_skip(State s, int64_t r, State* os, Message* om) {
  s.round = r; s.step = Step::NewRound;   // set_round (state_machine.rs:46-52)
  *os = s; *om = msg_new_round(r);
}

static void commit(State s, int64_t r, int64_t v, State* os, Message* om) {
  // state round untouched; Decision carries the event round
  // (state_machine.rs:320-322, spec 49)
  s.step = Step::Commit;
  *os = s; *om = msg_decision(r, v);
}

void apply(const State& s, int64_t round, const Event& e, State* os,
           Message* om) {
  const bool eqr = s.round == round;
  const Step st = s.step;
  const EventTag tag = e.tag;
  om->tag = MsgTag::None;

  // arm order matches the reference match expression exactly
  // (state_machine.rs:185-213)
  if (st == Step::NewRound && tag == EventTag::NewRoundProposer && eqr)
    return propose(s, e.value, os, om);                          // 11/14
  if (st == Step::NewRound && tag == EventTag::NewRound && eqr)
    return schedule_timeout_propose(s, os, om);                  // 11/20
  if (st == Step::Propose && tag == EventTag::Proposal && eqr &&
      e.pol_round >= -1 && e.pol_round < s.round)
    return prevote(s, e.pol_round, e.value, os, om);             // 22, 28
  if (st == Step::Propose && tag == EventTag::ProposalInvalid && eqr)
    return prevote_nil(s, os, om);                               // 22/25
  if (st == Step::Propose && tag == EventTag::TimeoutPropose && eqr)
    return prevote_nil(s, os, om);                               // 57
  if (st == Step::Prevote && tag == EventTag::PolkaAny && eqr)
    return schedule_timeout_prevote(s, os, om);                  // 34
  if (st == Step::Prevote && tag == EventTag::PolkaNil && eqr)
    return precommit_nil(s, os, om);                             // 44
  if (st == Step::Prevote && tag == EventTag::PolkaValue && eqr)
    return precommit(s, e.value, os, om);                        // 36/37
  if (st == Step::Prevote && tag == EventTag::TimeoutPrevote && eqr)
    return precommit_nil(s, os, om);                             // 61
  if (st == Step::Precommit && tag == EventTag::PolkaValue && eqr)
    return set_valid_value(s, e.value, os, om);                  // 36/42
  if (st == Step::Commit) { *os = s; return; }                   // absorb
  if (tag == EventTag::PrecommitAny && eqr)
    return schedule_timeout_precommit(s, os, om);                // 47
  if (tag == EventTag::TimeoutPrecommit && eqr)
    return round_skip(s, std::min(sat_add(round, 1), kMaxRound),
                      os, om);                                   // 65
  if (tag == EventTag::RoundSkip && s.round < round)
    return round_skip(s, round, os, om);                         // 55
  if (tag == EventTag::PrecommitValue)                           // no guard!
    return commit(s, round, e.value, os, om);                    // 49

  *os = s;  // no-op
}

// --- tally -----------------------------------------------------------------

ThreshKind VoteCount::add(int64_t value, int64_t weight,
                          int64_t* thresh_value) {
  if (value == kNoValue) nil_ = sat_add(nil_, weight);
  else {
    int64_t& w = weights_[value];
    w = sat_add(w, weight);
  }
  return thresh(thresh_value);
}

int64_t VoteCount::seen_weight() const {
  int64_t w = nil_;
  for (const auto& kv : weights_) w = sat_add(w, kv.second);
  return w;
}

ThreshKind VoteCount::thresh(int64_t* thresh_value) const {
  // highest-weight value with a quorum (ties only possible in
  // adversarial identity-free streams)
  int64_t best = kNoValue, best_w = -1;
  for (const auto& kv : weights_)
    if (is_quorum(kv.second, total_) && kv.second > best_w) {
      best = kv.first; best_w = kv.second;
    }
  if (best != kNoValue) { *thresh_value = best; return ThreshKind::Value; }
  *thresh_value = kNoValue;
  if (is_quorum(nil_, total_)) return ThreshKind::Nil;
  if (is_quorum(seen_weight(), total_)) return ThreshKind::Any;
  return ThreshKind::Init;
}

ThreshKind RoundVotes::add_vote(VoteType typ, int64_t validator,
                                int64_t value, int64_t weight,
                                int64_t* thresh_value) {
  // normalize the tag to its CLASS before doing anything keyed by it:
  // every non-prevote tag routes to precommits_, so a hostile caller
  // replaying distinct raw tags must not get distinct seen_ keys (that
  // would double-count one validator's weight into a forged quorum)
  int32_t cls = (typ == VoteType::Prevote) ? 0 : 1;
  VoteCount& count = cls == 0 ? prevotes_ : precommits_;
  if (validator != kNoValue) {
    auto key = std::make_pair(validator, cls);
    auto it = seen_.find(key);
    if (it != seen_.end()) {
      // duplicate or conflict: not counted; conflict -> one evidence
      // record per (validator, type)
      if (it->second.first != value && !flagged_.count(key)) {
        flagged_.insert(key);
        equiv_.push_back({height_, round_,
                          static_cast<VoteType>(cls), validator,
                          it->second.first, value});
      }
      return count.thresh(thresh_value);
    }
    seen_[key] = {value, weight};
  } else {
    int64_t& aw = anon_weight_[cls];
    aw = sat_add(aw, weight);
  }
  return count.add(value, weight, thresh_value);
}

int64_t RoundVotes::skip_weight() const {
  // distinct voters count once whatever the type; identity-free weight
  // contributes max of the two classes (mirrors core/round_votes.py)
  std::map<int64_t, int64_t> by_validator;
  for (const auto& kv : seen_) {
    int64_t v = kv.first.first;
    int64_t w = kv.second.second;
    auto it = by_validator.find(v);
    if (it == by_validator.end() || it->second < w) by_validator[v] = w;
  }
  int64_t sum = std::max(anon_weight_[0], anon_weight_[1]);
  for (const auto& kv : by_validator) sum = sat_add(sum, kv.second);
  return sum;
}

// --- validator set ---------------------------------------------------------

ValidatorSet::ValidatorSet(std::vector<Validator> vals)
    : vals_(std::move(vals)) {
  sort_dedup();
}

void ValidatorSet::sort_dedup() {
  // sorted by address = public key (validators.rs:15-17, :49-55 intent).
  // stable sort + keep-first makes duplicate resolution deterministic:
  // the LAST pushed entry wins (push order is reversed first), matching
  // the Python ValidatorSet's replace-on-duplicate semantics.
  std::reverse(vals_.begin(), vals_.end());
  std::stable_sort(vals_.begin(), vals_.end(),
                   [](const Validator& a, const Validator& b) {
                     return std::memcmp(a.public_key, b.public_key, 32) < 0;
                   });
  vals_.erase(std::unique(vals_.begin(), vals_.end(),
                          [](const Validator& a, const Validator& b) {
                            return std::memcmp(a.public_key, b.public_key,
                                               32) == 0;
                          }),
              vals_.end());
}

void ValidatorSet::add(const Validator& v) {
  // latest wins on duplicate pubkey (mirrors the Python set's replace)
  int64_t i = index_of(v.public_key);
  if (i >= 0) {
    vals_[static_cast<size_t>(i)].voting_power = v.voting_power;
    return;
  }
  vals_.push_back(v);
  sort_dedup();
}

bool ValidatorSet::update(const Validator& v) {
  int64_t i = index_of(v.public_key);
  if (i < 0) return false;
  vals_[static_cast<size_t>(i)].voting_power = v.voting_power;
  return true;
}

bool ValidatorSet::remove(const uint8_t pk[32]) {
  int64_t i = index_of(pk);
  if (i < 0) return false;
  vals_.erase(vals_.begin() + static_cast<size_t>(i));
  return true;
}

int64_t ValidatorSet::total_power() const {
  int64_t t = 0;
  for (const auto& v : vals_) t = sat_add(t, v.voting_power);
  return t;
}

int64_t ValidatorSet::index_of(const uint8_t pk[32]) const {
  auto it = std::lower_bound(
      vals_.begin(), vals_.end(), pk,
      [](const Validator& a, const uint8_t* key) {
        return std::memcmp(a.public_key, key, 32) < 0;
      });
  if (it == vals_.end() || std::memcmp(it->public_key, pk, 32) != 0)
    return -1;
  return it - vals_.begin();
}

int64_t ProposerRotation::step() {
  // exact mirror of core/validators.py ProposerRotation.step():
  // prune removed validators, init newcomers at 0, add each validator's
  // power, pick the max priority (ties -> lower index), subtract total.
  const auto& vals = set_->validators();
  if (vals.empty()) return -1;
  std::map<std::vector<uint8_t>, int64_t> next;
  for (const auto& v : vals) {
    std::vector<uint8_t> addr(v.public_key, v.public_key + 32);
    auto it = priorities_.find(addr);
    next[std::move(addr)] = (it == priorities_.end()) ? 0 : it->second;
  }
  priorities_ = std::move(next);
  for (const auto& v : vals) {
    int64_t& p =
        priorities_[std::vector<uint8_t>(v.public_key, v.public_key + 32)];
    p = sat_add(p, v.voting_power);
  }
  int64_t best = 0;
  int64_t best_p = INT64_MIN;
  for (size_t i = 0; i < vals.size(); ++i) {
    int64_t p = priorities_[std::vector<uint8_t>(
        vals[i].public_key, vals[i].public_key + 32)];
    if (p > best_p) { best_p = p; best = static_cast<int64_t>(i); }
  }
  int64_t& bp = priorities_[std::vector<uint8_t>(
      vals[best].public_key, vals[best].public_key + 32)];
  bp = sat_sub(bp, set_->total_power());
  return best;
}

void ValidatorSet::hash(uint8_t out[32]) const {
  // SHA-512/256-style: SHA-512 over the sorted (pubkey || power_le)
  // entries, truncated to 32 bytes
  std::vector<uint8_t> buf;
  buf.reserve(vals_.size() * 40);
  for (const auto& v : vals_) {
    buf.insert(buf.end(), v.public_key, v.public_key + 32);
    uint64_t p = static_cast<uint64_t>(v.voting_power);
    for (int i = 0; i < 8; ++i) buf.push_back((p >> (8 * i)) & 0xFF);
  }
  uint8_t digest[64];
  sha512(buf.data(), buf.size(), digest);
  std::memcpy(out, digest, 32);
}

}  // namespace agnes
