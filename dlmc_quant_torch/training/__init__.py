"""FSPTQ reconstruction and what it needs: losses, schedules, metrics and
evaluation."""
