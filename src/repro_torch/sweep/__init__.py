"""repro_torch.sweep — shape padding and the batched sweep engine."""
