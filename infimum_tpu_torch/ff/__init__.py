"""Plain PyTorch prime-field arithmetic (Fr, Fq, Fq2)."""
