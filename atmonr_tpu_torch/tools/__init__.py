"""Counterparts of the JAX repo's timing and diagnostic tools (``tools/``),
run as ``python -m atmonr_tpu_torch.tools.<name>``."""
