"""Groth16 over BN254: setup, prover, verifier and key conversion."""
