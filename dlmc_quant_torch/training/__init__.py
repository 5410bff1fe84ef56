"""Training: the classification and QAT trainers, FSPTQ reconstruction,
PTQ, and what they share: losses, schedules, optimizers, metrics and
evaluation."""
