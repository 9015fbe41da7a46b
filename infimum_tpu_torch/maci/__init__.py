"""MACI keys, poll state and event replay (host)."""
