"""optim_ms.train (ms, lower; device trace; layer optimizer; moves
setup_s): device milliseconds a step of the global-norm clip and
the AdamW update: PyTorch's multi-tensor kernels (``_foreach_*`` and the
fused optimizer's), the norm's reductions."""

PATTERN = r"multi_tensor_apply|lpnorm|fused_adam|FusedAdam"


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    return 1e3 * run.trace.kernel_seconds(PATTERN) / run.traced["steps"]
