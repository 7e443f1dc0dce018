"""Training of the port: schedules, optimizer, train step, checkpoints
(counterpart of gdm_tpu/train)."""
