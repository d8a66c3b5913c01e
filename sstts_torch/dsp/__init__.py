"""DSP: dB ops, de-emphasis, DFT matrices, Griffin-Lim."""
