"""The least time of the traced prefills' products (each the larger of its
operations over the bf16 peak and its bytes over the HBM rate, shapes from
the configuration) over the device time of the matmul wrapper's kernels."""
from portbench.harness import work

# kernels/matmul/csrc/matmul.cu (splitk_reduce: the K-split sum;
# split_kernel, from kernels/include/hopper.cuh: the fp32 routes' TF32 split)
KERNELS = ("matmul_wgmma", "matmul_tiled", "matmul_tf32x3", "matmul_stream",
           "splitk_reduce", "split_kernel")


def read(run):
    if run.devtrace is None or not run.traced_steps or "s" not in run.traced_steps[0]:
        return None
    spent = run.devtrace.sum_of(KERNELS)
    if spent <= 0:
        return None
    least = sum(work.prefill_matmul_least_s(run.arch, s["b"], s["s"]) for s in run.traced_steps)
    return 100.0 * least / spent
