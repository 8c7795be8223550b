"""The state-machine enums the device plane encodes.

A copy of the enum half of `agnes_tpu.core.state_machine` (the port
imports nothing of the JAX package).  The integer codes are THE
canonical encoding shared by every plane: the device state machine
(`device/state_machine.py`), the tally's event table
(`device/tally.py`) and the JAX and C++ twins.
"""

from __future__ import annotations

import enum


class Step(enum.IntEnum):
    """Step of consensus within a round (reference: state_machine.rs:14-21)."""

    NEW_ROUND = 0
    PROPOSE = 1
    PREVOTE = 2
    PRECOMMIT = 3
    COMMIT = 4


class EventTag(enum.IntEnum):
    """The 13 input events (reference: state_machine.rs:96-110)."""

    NEW_ROUND = 0            # start a new round, not as proposer
    NEW_ROUND_PROPOSER = 1   # start a new round and propose value
    PROPOSAL = 2             # complete proposal received (pol_round, value)
    PROPOSAL_INVALID = 3     # invalid proposal received
    POLKA_ANY = 4            # +2/3 prevotes for anything
    POLKA_NIL = 5            # +2/3 prevotes for nil
    POLKA_VALUE = 6          # +2/3 prevotes for value
    PRECOMMIT_ANY = 7        # +2/3 precommits for anything
    PRECOMMIT_VALUE = 8      # +2/3 precommits for value
    ROUND_SKIP = 9           # +1/3 votes from a higher round
    TIMEOUT_PROPOSE = 10     # timeout waiting for proposal
    TIMEOUT_PREVOTE = 11     # timeout waiting for prevotes
    TIMEOUT_PRECOMMIT = 12   # timeout waiting for precommits


class TimeoutStep(enum.IntEnum):
    """Which step a timeout is for (reference: state_machine.rs:158-163)."""

    PROPOSE = 0
    PREVOTE = 1
    PRECOMMIT = 2


class MsgTag(enum.IntEnum):
    """Output message kinds (reference: state_machine.rs:118-124).

    NONE is the device encoding for Rust's Option::None.
    """

    NONE = 0
    NEW_ROUND = 1
    PROPOSAL = 2
    VOTE = 3
    TIMEOUT = 4
    DECISION = 5
