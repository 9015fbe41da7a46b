"""Witness inputs of the process and tally circuits (host)."""
