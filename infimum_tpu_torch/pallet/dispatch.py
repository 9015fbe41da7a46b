# Copied from infimum_tpu/pallet/dispatch.py; the port keeps its own host layers.
"""Typed extrinsic dispatcher + event decoding.

Chain-free counterpart of the reference CLI's fully-typed extrinsic map
(reference cli/src/extrinsic.ts:13-203): each extrinsic name is bound to an
argument schema and to the deposit event it is expected to emit; `dispatch`
validates arguments, invokes the pallet method, decodes module errors into
(Error, reason) pairs, and returns the newly deposited events — the same
surface `extrinsic()` gives TS callers over @polkadot/api.

This is the seam a real chain binding would replace: swap `InfimumPallet`
for an RPC client and the typed layer stays identical.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Callable

from .chain import Event, InfimumPallet, PalletError


class Extrinsic(enum.Enum):
    """Names mirror the reference InfimumExtrinsic enum (extrinsic.ts:13-23)."""

    REGISTER_AS_COORDINATOR = "registerAsCoordinator"
    ROTATE_KEYS = "rotateKeys"
    CREATE_POLL = "createPoll"
    MERGE_POLL_STATE = "mergePollState"
    COMMIT_OUTCOME = "commitOutcome"
    NULLIFY_POLL = "nullifyPoll"
    REGISTER_AS_PARTICIPANT = "registerAsParticipant"
    INTERACT_WITH_POLL = "interactWithPoll"


@dataclass
class ExtrinsicSpec:
    method: str                       # InfimumPallet method name
    args: list[str]                   # positional argument names (after origin)
    deposits: list[str]               # event names this call may deposit
    optional: list[str] = field(default_factory=list)


# name -> (pallet method, arg schema, expected deposit events) — the typed
# table of extrinsic.ts:25-151
SPECS: dict[Extrinsic, ExtrinsicSpec] = {
    Extrinsic.REGISTER_AS_COORDINATOR: ExtrinsicSpec(
        "register_as_coordinator", ["public_key", "vkeys"],
        ["CoordinatorRegistered"]),
    Extrinsic.ROTATE_KEYS: ExtrinsicSpec(
        "rotate_keys", ["public_key", "vkeys"],
        ["CoordinatorKeysChanged"]),
    Extrinsic.CREATE_POLL: ExtrinsicSpec(
        "create_poll",
        ["signup_period", "voting_period", "registration_depth",
         "interaction_depth", "process_subtree_depth", "tally_subtree_depth",
         "vote_option_tree_depth", "vote_options"],
        ["PollCreated"]),
    Extrinsic.MERGE_POLL_STATE: ExtrinsicSpec(
        "merge_poll_state", [], ["PollStateMerged"]),
    Extrinsic.COMMIT_OUTCOME: ExtrinsicSpec(
        "commit_outcome", ["proof_batches"],
        ["PollCommitmentUpdated", "PollOutcome"], optional=["outcome"]),
    Extrinsic.NULLIFY_POLL: ExtrinsicSpec(
        "nullify_poll", [], ["PollNullified"]),
    Extrinsic.REGISTER_AS_PARTICIPANT: ExtrinsicSpec(
        "register_as_participant", ["poll_id", "public_key"],
        ["ParticipantRegistered"]),
    Extrinsic.INTERACT_WITH_POLL: ExtrinsicSpec(
        "interact_with_poll", ["poll_id", "public_key", "data"],
        ["PollInteraction"]),
}


@dataclass
class DispatchResult:
    """What the reference's extrinsic() resolves with: the deposit events
    (extrinsic.ts:193-197), or raises a decoded module error."""

    events: list[Event]

    def event(self, name: str) -> Event:
        for e in self.events:
            if e.name == name:
                return e
        raise KeyError(name)


def dispatch(pallet: InfimumPallet, origin: str, call: Extrinsic,
             **kwargs: Any) -> DispatchResult:
    """Validate args against the typed schema, invoke, decode events.

    Raises TypeError for schema violations (the TS layer's compile-time
    guarantee) and PalletError for decoded module errors."""
    spec = SPECS[call]
    allowed = set(spec.args) | set(spec.optional)
    unknown = set(kwargs) - allowed
    if unknown:
        raise TypeError(f"{call.value}: unexpected arguments {sorted(unknown)}")
    missing = [a for a in spec.args if a not in kwargs]
    if missing:
        raise TypeError(f"{call.value}: missing arguments {missing}")

    method: Callable = getattr(pallet, spec.method)
    n_before = len(pallet.events)
    method(origin, *[kwargs[a] for a in spec.args],
           **{k: kwargs[k] for k in spec.optional if k in kwargs})
    new_events = pallet.events[n_before:]
    for e in new_events:
        if e.name not in spec.deposits and e.name != "PollOutcome":
            # every deposit must be one this extrinsic is typed to emit
            raise AssertionError(
                f"{call.value} deposited undeclared event {e.name}")
    return DispatchResult(events=list(new_events))
