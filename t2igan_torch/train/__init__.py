"""The sampler, the adversarial train step, its state and the trainer."""
