# Copied from infimum_tpu/pallet/chain.py; the port keeps its own host layers.
"""Chain-free equivalent of the reference Substrate pallet.

Mirrors pallet/src/lib.rs: the 8 extrinsics (lib.rs:263-782), 9 events
(lib.rs:72-163), 21 errors (lib.rs:165-230) and the three storage maps
(lib.rs:232-261), over the same poll state machine (maci/state.py) and the
same arkworks byte formats (io/arkworks.py). Groth16 verification runs our
pairing verifier (groth16/groth16.py), semantics of `verify_proof`
(lib.rs:815-827). This is the verifier harness SURVEY.md §4 calls for: every
on-chain behavior testable without a chain."""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from ..maci.state import Poll, PollConfig, PollOutcome
from ..io.arkworks import (
    deserialize_vkey, deserialize_proof, fr_from_hash_bytes,
    SerializationError,
)
from ..groth16.groth16 import verify as groth16_verify


class Error(enum.Enum):
    # reference: pallet/src/lib.rs:165-230
    CoordinatorAlreadyRegistered = enum.auto()
    CoordinatorNotRegistered = enum.auto()
    CoordinatorPollLimitReached = enum.auto()
    ParticipantRegistrationLimitReached = enum.auto()
    ParticipantInteractionLimitReached = enum.auto()
    PollConfigInvalid = enum.auto()
    PollRegistrationInProgress = enum.auto()
    PollRegistrationHasEnded = enum.auto()
    PollVotingInProgress = enum.auto()
    PollCurrentlyActive = enum.auto()
    PollVotingHasEnded = enum.auto()
    PollDoesNotExist = enum.auto()
    PollDataEmpty = enum.auto()
    PollOutcomeAlreadyDetermined = enum.auto()
    PollStateNotMerged = enum.auto()
    PollMergeFailed = enum.auto()
    PollRegistrationFailed = enum.auto()
    PollInteractionFailed = enum.auto()
    MalformedKeys = enum.auto()
    MalformedProof = enum.auto()
    MalformedInput = enum.auto()


class PalletError(Exception):
    def __init__(self, error: Error, reason: int | None = None):
        self.error = error
        self.reason = reason
        super().__init__(error.name if reason is None
                         else f"{error.name}(reason={reason})")


@dataclass
class Event:
    name: str
    data: dict

    # reference event names (lib.rs:72-163): CoordinatorRegistered,
    # CoordinatorKeysChanged, ParticipantRegistered, PollCreated,
    # PollInteraction, PollCommitmentUpdated, PollStateMerged, PollOutcome,
    # PollNullified


@dataclass
class Coordinator:
    public_key: tuple[int, int]
    vk_process: object
    vk_tally: object
    poll_ids: list = field(default_factory=list)


@dataclass
class RuntimeConfig:
    # reference prod bounds: .dev/runtime/src/lib.rs:271-277
    max_coordinator_polls: int = 1028
    max_vote_options: int = 32
    max_poll_registrations: int = 65536
    max_poll_interactions: int = 65536


class InfimumPallet:
    def __init__(self, config: RuntimeConfig | None = None):
        self.config = config or RuntimeConfig()
        self.block = 1
        self.coordinators: dict = {}
        self.polls: dict[int, Poll] = {}
        self.events: list[Event] = []

    def run_to_block(self, n: int):
        assert n >= self.block
        self.block = n

    def _emit(self, name: str, **data):
        self.events.append(Event(name, data))

    def _coordinator(self, origin) -> Coordinator:
        if origin not in self.coordinators:
            raise PalletError(Error.CoordinatorNotRegistered)
        return self.coordinators[origin]

    def _active_poll(self, origin) -> Poll | None:
        coord = self.coordinators.get(origin)
        if not coord or not coord.poll_ids:
            return None
        poll = self.polls[coord.poll_ids[-1]]
        return None if poll.is_fulfilled() else poll

    def _parse_vkeys(self, vkeys: dict):
        try:
            return (deserialize_vkey(vkeys["process"]),
                    deserialize_vkey(vkeys["tally"]))
        except (SerializationError, KeyError, TypeError, ValueError) as e:
            raise PalletError(Error.MalformedKeys) from e

    # -- extrinsics (reference: lib.rs:263-782) -------------------------------

    def register_as_coordinator(self, origin, public_key, vkeys: dict):
        """lib.rs:274-316."""
        if origin in self.coordinators:
            raise PalletError(Error.CoordinatorAlreadyRegistered)
        vk_p, vk_t = self._parse_vkeys(vkeys)
        self.coordinators[origin] = Coordinator(
            public_key=public_key, vk_process=vk_p, vk_tally=vk_t)
        self._emit("CoordinatorRegistered", who=origin,
                   public_key=public_key)

    def rotate_keys(self, origin, public_key, vkeys: dict):
        """lib.rs:319-370: disallowed while a poll is active/unfulfilled."""
        coord = self._coordinator(origin)
        if self._active_poll(origin) is not None:
            raise PalletError(Error.PollCurrentlyActive)
        vk_p, vk_t = self._parse_vkeys(vkeys)
        coord.public_key = public_key
        coord.vk_process, coord.vk_tally = vk_p, vk_t
        self._emit("CoordinatorKeysChanged", who=origin,
                   public_key=public_key)

    def create_poll(self, origin, signup_period, voting_period,
                    registration_depth, interaction_depth,
                    process_subtree_depth, tally_subtree_depth,
                    vote_option_tree_depth, vote_options):
        """lib.rs:373-475."""
        coord = self._coordinator(origin)
        if len(coord.poll_ids) >= self.config.max_coordinator_polls:
            raise PalletError(Error.CoordinatorPollLimitReached)
        if self._active_poll(origin) is not None:
            raise PalletError(Error.PollCurrentlyActive)
        # per-poll capacity is set by the tree depths (lib.rs:390-398:
        # max_registrations = 2^registration_depth, max_interactions =
        # 5^interaction_depth) and must fit the runtime bounds
        max_registrations = 2 ** registration_depth
        max_interactions = 5 ** interaction_depth
        if (len(vote_options) > self.config.max_vote_options
                or len(vote_options) != 5 ** vote_option_tree_depth
                or max_registrations > self.config.max_poll_registrations
                or max_interactions > self.config.max_poll_interactions
                or not (0 < registration_depth <= 32)
                or not (0 < interaction_depth <= 32)
                or not (0 < process_subtree_depth <= interaction_depth)
                or not (0 < tally_subtree_depth <= registration_depth)
                or vote_option_tree_depth <= 0):
            raise PalletError(Error.PollConfigInvalid)
        poll_id = len(self.polls)
        poll = Poll(index=poll_id, created_at=self.block, config=PollConfig(
            signup_period=signup_period, voting_period=voting_period,
            registration_depth=registration_depth,
            interaction_depth=interaction_depth,
            process_subtree_depth=process_subtree_depth,
            tally_subtree_depth=tally_subtree_depth,
            vote_option_tree_depth=vote_option_tree_depth,
            vote_options=list(vote_options),
            max_registrations=max_registrations,
            max_interactions=max_interactions,
        ))
        self.polls[poll_id] = poll
        coord.poll_ids.append(poll_id)
        self._emit("PollCreated", index=poll_id, coordinator=origin,
                   starts_at=self.block)
        return poll_id

    def register_as_participant(self, origin, poll_id, public_key):
        """lib.rs:679-736."""
        poll = self.polls.get(poll_id)
        if poll is None:
            raise PalletError(Error.PollDoesNotExist)
        if not poll.is_registration_period(self.block):
            raise PalletError(Error.PollRegistrationHasEnded)
        if poll.registration_limit_reached():
            raise PalletError(Error.ParticipantRegistrationLimitReached)
        try:
            count = poll.register_participant(public_key, self.block)
        except Exception as e:
            raise PalletError(Error.PollRegistrationFailed, reason=1) from e
        self._emit("ParticipantRegistered", poll=poll_id, who=origin,
                   count=count, public_key=public_key, block=self.block)
        return count

    def interact_with_poll(self, origin, poll_id, public_key, data):
        """lib.rs:739-782."""
        poll = self.polls.get(poll_id)
        if poll is None:
            raise PalletError(Error.PollDoesNotExist)
        if not poll.is_voting_period(self.block):
            raise PalletError(Error.PollVotingHasEnded)
        if poll.interaction_limit_reached():
            raise PalletError(Error.ParticipantInteractionLimitReached)
        if len(data) != 10:
            raise PalletError(Error.MalformedInput)
        try:
            count = poll.consume_interaction(public_key, list(data))
        except Exception as e:
            raise PalletError(Error.PollInteractionFailed, reason=1) from e
        self._emit("PollInteraction", poll=poll_id, public_key=public_key,
                   data=list(data), count=count)
        return count

    def merge_poll_state(self, origin):
        """lib.rs:478-564: first call merges registrations, second merges
        interactions (only once voting is over)."""
        coord = self._coordinator(origin)
        if not coord.poll_ids:
            raise PalletError(Error.PollDoesNotExist)
        poll = self.polls[coord.poll_ids[-1]]
        if poll.is_registration_period(self.block):
            raise PalletError(Error.PollRegistrationInProgress)
        if poll.registrations.root is None:
            poll.merge_registrations()
            self._emit("PollStateMerged", poll=poll.index,
                       registration_root=poll.registrations.root)
            return
        if poll.interactions.root is None:
            if not poll.is_over(self.block):
                raise PalletError(Error.PollVotingInProgress)
            poll.merge_interactions()
            self._emit("PollStateMerged", poll=poll.index,
                       interaction_root=poll.interactions.root)
            return
        raise PalletError(Error.PollDataEmpty)

    def commit_outcome(self, origin, proof_batches, outcome=None):
        """lib.rs:567-640: verify each proof against self-derived public
        inputs, chain commitments, then (optionally) verify the outcome."""
        coord = self._coordinator(origin)
        if not coord.poll_ids:
            raise PalletError(Error.PollDoesNotExist)
        poll = self.polls[coord.poll_ids[-1]]
        if poll.is_fulfilled():
            raise PalletError(Error.PollOutcomeAlreadyDetermined)
        if not poll.is_merged():
            raise PalletError(Error.PollStateNotMerged)
        # lib.rs:588: at least one of the inputs must be provided
        if not proof_batches and outcome is None:
            raise PalletError(Error.MalformedInput)
        for proof_data, commitment_bytes in proof_batches:
            try:
                proof = deserialize_proof(proof_data)
                new_commitment = (
                    commitment_bytes if isinstance(commitment_bytes, int)
                    else fr_from_hash_bytes(commitment_bytes))
            except SerializationError as e:
                raise PalletError(Error.MalformedProof) from e
            kind, inputs, new_c = poll.prepare_public_inputs(
                coord.public_key, new_commitment)
            vk = coord.vk_process if kind == "process" else coord.vk_tally
            if not groth16_verify(vk, proof, inputs):
                raise PalletError(Error.MalformedProof)
            poll.commit(new_c)
            self._emit("PollCommitmentUpdated", poll=poll.index, kind=kind,
                       commitment=new_commitment)
        # lib.rs:620-628: an outcome that fails verification (or a poll not
        # yet fully proven) does NOT error — the extrinsic succeeds with the
        # outcome left unset, so a coordinator can chain partial proof
        # batches carrying the outcome along (extrinsics.rs:907-958
        # commit_outcome_partial_success)
        if outcome is not None:
            index = poll.verify_outcome(outcome)
            if index is not None:
                poll.outcome = index
                self._emit("PollOutcome", poll=poll.index, outcome_index=index)
                return index

    def nullify_poll(self, origin):
        """lib.rs:643-676: tombstone a dead poll (proving window missed)."""
        coord = self._coordinator(origin)
        if not coord.poll_ids:
            raise PalletError(Error.PollDoesNotExist)
        poll = self.polls[coord.poll_ids[-1]]
        if poll.is_fulfilled():
            raise PalletError(Error.PollOutcomeAlreadyDetermined)
        if not poll.is_over(self.block):
            raise PalletError(Error.PollCurrentlyActive)
        poll.nullify()
        self._emit("PollNullified", poll=poll.index)
