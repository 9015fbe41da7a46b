"""Tree building over the device (one card in this package)."""
