"""Complete projective BN254 G1/G2 arithmetic in plain PyTorch."""
