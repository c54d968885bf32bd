"""Training: losses, density control and the train step."""
