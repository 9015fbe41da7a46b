"""Merkle trees of a poll: zero tables, full trees, the amortized IMT (host)."""
