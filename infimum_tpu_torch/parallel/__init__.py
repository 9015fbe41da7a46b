"""Sharding over a process group (torch.distributed): the MSM, the NTT and
the Merkle build, one rank a card."""
