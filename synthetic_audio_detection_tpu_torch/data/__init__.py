"""The training data path: split-tree WAVs to batched waveforms."""
