"""Byte-level (de)serialization of keys and proofs (arkworks layout)."""
