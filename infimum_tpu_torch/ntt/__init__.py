"""Radix-2 NTT over BN254 Fr in plain PyTorch."""
