"""Data- and head-parallel training and serving over ``torch.distributed``."""
