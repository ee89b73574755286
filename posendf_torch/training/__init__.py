"""Training: the trainer, its checkpoints, metrics and initialization aids."""
