"""Training-side helpers of the port (the distillation trainer itself is
not ported yet)."""
