"""The port's scale poll (infimum_tpu_torch.client.scale) against the
reference's, without proving, on the CPU.

A small poll (30 sign-ups, 60 messages, interaction depth 3) fills the
port's pallet and walks every batch's witness inputs: the record has the
reference's keys and the same batch counts. Polls beyond the reference's
bounds are refused."""

import pytest

from infimum_tpu.client.scale import run_scale_poll as ref_scale
from infimum_tpu_torch.client.scale import run_scale_poll

SMALL = dict(n_participants=30, n_messages=60, interaction_depth=3,
             prove=False)


def test_small_poll_batch_counts_match_reference():
    got = run_scale_poll(device="cpu", **SMALL)
    want = ref_scale(**SMALL)
    assert list(got) == list(want)
    counts = ("n_participants", "n_messages", "process_batches",
              "tally_batches")
    assert [got[k] for k in counts] == [want[k] for k in counts] == \
        [30, 60, 12, 16]


@pytest.mark.parametrize("over", [dict(n_participants=7,
                                       registration_depth=3),
                                  dict(n_messages=125, interaction_depth=3)])
def test_beyond_reference_bounds_refused(over):
    with pytest.raises(ValueError):
        run_scale_poll(device="cpu", **{**SMALL, **over})
