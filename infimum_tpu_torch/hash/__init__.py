"""Poseidon over BN254 Fr: parameters, host hash, cipher and the batched kernel."""
