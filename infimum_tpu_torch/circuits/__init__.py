"""R1CS circuits of a poll: gadgets, ProcessMessages, TallyVotes (host)."""
