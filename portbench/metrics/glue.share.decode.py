"""Share of the traced ticks' device time spent outside the kernels of the
port's five wrappers (matmul, RMSNorm, flash attention, SSD, conv): the
PyTorch ops of the cache write, the stack, the plain attention, RoPE."""

WRAPPER_KERNELS = (
    # kernels/matmul/csrc/matmul.cu, kernels/include/hopper.cuh
    "matmul_wgmma", "matmul_tiled", "matmul_tf32x3", "matmul_stream", "splitk_reduce",
    "split_kernel",
    # kernels/rmsnorm/csrc/rmsnorm.cu
    "rmsnorm_rows",
    # kernels/flash_attention/csrc/flash_attention.cu
    "flash_attention", "flash_wgmma", "flash_tf32x3",
    # kernels/ssd/csrc/ssd.cu
    "ssd_chunk_scan", "ssd_states", "ssd_outputs", "ssd_states_tf32x3", "ssd_outputs_tf32x3",
    # kernels/conv2d/csrc/conv2d.cu
    "conv2d_direct", "conv2d_wgmma", "conv2d_tf32x3", "relayout_kernel",
)


def read(run):
    if run.devtrace is None or not run.traced_steps or "tick" not in run.traced_steps[0]:
        return None
    total = run.devtrace.device_total_s()
    if total <= 0:
        return None
    return 100.0 * (total - run.devtrace.sum_of(WRAPPER_KERNELS)) / total
