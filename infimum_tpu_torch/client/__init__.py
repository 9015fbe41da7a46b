"""Offchain client: user roles, poll proving orchestration, the
reference-dims end-to-end run and the largest legal poll.

Counterpart of `infimum_tpu/client/`: the roles (`user.py`) drive the port's
chain-free pallet (`pallet/chain.py`), and proving runs this package's
Groth16 on the card.
"""

from .user import User, Coordinator, Participant
from .prover import PollProver, ProverKeys

__all__ = ["User", "Coordinator", "Participant", "PollProver", "ProverKeys"]
