"""Training: train state and optimizer, the train step, metrics,
checkpoints and the discrete VLA loop."""
